"""Sparse matrix formats + conversions — the RandBLAS ``sparse_data``
capability (SURVEY.md §2.9: COO/CSR/CSC matrices, ``coo_to_csr/csc``,
``*_to_dense``, ``dense_to_*``, ``left_spmm``/``right_spmm``).

Representation: BCOO is the XLA-lowerable workhorse (SparseLinOp);
BCSR covers the CSR side. This module provides the explicit format
conversions and dense round-trips as pure functions; CSC is represented as
the CSR of the transpose (the standard trick — every CSC operation maps to
a transposed CSR operation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import sparse as jsparse


def coo_sort(rows, cols, vals, shape):
    """Canonicalize COO: sort by (row, col) and sum duplicates (host)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # merge duplicates
    key = rows.astype(np.int64) * shape[1] + cols
    uniq, inv = np.unique(key, return_inverse=True)
    out = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(out, inv, vals)
    return (uniq // shape[1]).astype(np.int32), \
        (uniq % shape[1]).astype(np.int32), out


def coo_to_csr(rows, cols, vals, shape):
    """COO → CSR triple ``(indptr, indices, data)`` (host conversion)."""
    rows, cols, vals = coo_sort(rows, cols, vals, shape)
    indptr = np.zeros(shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, cols, vals


def coo_to_csc(rows, cols, vals, shape):
    """COO → CSC triple ``(indptr, indices, data)`` = CSR of the transpose."""
    indptr, idx, data = coo_to_csr(cols, rows, vals, (shape[1], shape[0]))
    return indptr, idx, data


def csr_to_coo(indptr, indices, data):
    indptr = np.asarray(indptr)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return rows, np.asarray(indices, dtype=np.int32), np.asarray(data)


def coo_to_dense(rows, cols, vals, shape, dtype=None):
    out = np.zeros(shape, dtype=dtype or np.asarray(vals).dtype)
    np.add.at(out, (np.asarray(rows), np.asarray(cols)), np.asarray(vals))
    return jnp.asarray(out)


def dense_to_coo(A, tol: float = 0.0):
    Ah = np.asarray(A)
    rows, cols = np.nonzero(np.abs(Ah) > tol)
    return rows.astype(np.int32), cols.astype(np.int32), Ah[rows, cols]


def to_bcoo(rows, cols, vals, shape) -> jsparse.BCOO:
    idx = jnp.stack([jnp.asarray(rows), jnp.asarray(cols)], axis=1)
    return jsparse.BCOO((jnp.asarray(vals), idx), shape=shape)


def to_bcsr(indptr, indices, data, shape) -> jsparse.BCSR:
    return jsparse.BCSR((jnp.asarray(data), jnp.asarray(indices),
                         jnp.asarray(indptr)), shape=shape)


def left_spmm(sp, B, precision=None):
    """sp @ B for any BCOO/BCSR (RandBLAS left_spmm)."""
    return sp @ B


def right_spmm(A, sp, precision=None):
    """A @ sp (RandBLAS right_spmm)."""
    return A @ sp


def spgemm(sp1, sp2):
    """Sparse × sparse (RandBLAS spgemm capability via BCOO)."""
    return sp1 @ sp2


def _pad_csr_rows(rows, cols, vals, n, dtype):
    """Host-side exact padded-CSR packing: (n, L) col/val arrays with
    L = max row occupancy (pad entries have val 0)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n)
    L = max(int(counts.max(initial=0)), 1)
    start = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(len(rows)) - start[rows]
    cols_pad = np.zeros((n, L), np.int32)
    vals_pad = np.zeros((n, L), dtype)
    cols_pad[rows, pos] = cols
    vals_pad[rows, pos] = vals
    return jnp.asarray(cols_pad), jnp.asarray(vals_pad), L


def sparse_trsm(rows, cols, vals, n: int, B: jax.Array,
                lower: bool = True, unit_diagonal: bool = False,
                block: int = 256, precision=None):
    """Device-side blocked sparse triangular solve — the RandBLAS
    ``sparse_data::trsm`` capability (SURVEY.md §2.9; the reference's
    solver linops run bulk multi-RHS solves through it,
    ext_cholsolver_linop.hh).

    Solves T·X = B for sparse triangular T given in COO form
    (host/numpy index arrays — packing happens once on the host, the
    substitution runs on device). Design: diagonal blocks are
    densified once and solved with the dense ``triangular_solve``;
    off-diagonal coupling is applied via padded-CSR *gather* FMA layers
    (no scatters), one block row/column at a time.

    Returns X (n, k).
    """
    if B.ndim == 1:
        return sparse_trsm(rows, cols, vals, n, B[:, None], lower,
                           unit_diagonal, block, precision)[:, 0]
    dtype = np.asarray(vals).dtype
    cols_pad, vals_pad, L = _pad_csr_rows(rows, cols, vals, n, dtype)
    bs = min(block, n)
    nb = -(-n // bs)
    npad = nb * bs
    if npad != n:
        cols_pad = jnp.pad(cols_pad, ((0, npad - n), (0, 0)))
        vals_pad = jnp.pad(vals_pad, ((0, npad - n), (0, 0)))
        B = jnp.pad(B, ((0, npad - n), (0, 0)))

    # densify the diagonal blocks (one scatter over the packed entries)
    ri = jnp.repeat(jnp.arange(npad), L).reshape(npad, L)
    in_diag = (cols_pad // bs) == (ri // bs)
    scatter_vals = jnp.where(in_diag, vals_pad, 0.0)
    if unit_diagonal:
        # LAPACK semantics: stored diagonal entries are ignored
        scatter_vals = jnp.where(cols_pad == ri, 0.0, scatter_vals)
    D = jnp.zeros((nb, bs, bs), dtype)
    bidx = ri // bs
    D = D.at[bidx, ri % bs, cols_pad % bs].add(scatter_vals)
    if unit_diagonal:
        D = D + jnp.eye(bs, dtype=dtype)[None]
    else:
        # pad rows beyond n get an identity diagonal
        if npad != n:
            pad_rows = jnp.arange(npad) >= n
            fix = jnp.where(pad_rows, 1.0, 0.0).reshape(nb, bs)
            D = D + fix[:, :, None] * jnp.eye(bs, dtype=dtype)[None]
    # off-diagonal entries only in the gather layers
    vals_off = jnp.where(in_diag, 0.0, vals_pad)

    X0 = jnp.zeros_like(B)
    order = range(nb) if lower else range(nb - 1, -1, -1)

    def step(i, X):
        c = i * bs
        cp = jax.lax.dynamic_slice(cols_pad, (c, 0), (bs, L))
        vp = jax.lax.dynamic_slice(vals_off, (c, 0), (bs, L))
        acc = jnp.einsum("rl,rln->rn", vp, X[cp, :],
                         precision=jax.lax.Precision.HIGHEST)
        rhs = jax.lax.dynamic_slice(B, (c, 0), (bs, B.shape[1])) - acc
        Xb = jax.lax.linalg.triangular_solve(
            D[i], rhs, left_side=True, lower=lower)
        return jax.lax.dynamic_update_slice(X, Xb, (c, 0))

    X = X0
    for i in order:
        X = step(i, X)
    return X[:n]
