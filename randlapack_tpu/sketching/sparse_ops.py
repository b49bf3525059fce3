"""Sparse sketching operators — SASO/SJLT (RandBLAS ``SparseDist``/``SparseSkOp``).

Reference usage: CQRRPT and the preconditioner constructors sketch with a
short-axis sparse operator, vec_nnz nonzeros per long-axis vector
(reference: RandLAPACK/drivers/rl_cqrrpt.hh:214-222,
RandLAPACK/comps/rl_preconditioners.hh:136-160, ``Axis::Short``).

Representation: structure-of-arrays — for a d×m operator with
d ≤ m (the common "sketch the tall axis" case), each of the m columns holds
``vec_nnz`` entries at distinct random rows with iid ±1 values:

    rows : (vec_nnz, m) int32   row index of each nonzero
    vals : (vec_nnz, m) dtype   ±1 (unscaled; isometry_scale = 1/√vec_nnz)

Apply S @ A is a sum of ``vec_nnz`` scatter-adds of sign-flipped copies of A
— O(vec_nnz·m·n) work, bandwidth bound, no matmul needed. A is streamed
once per nnz layer and never gathered into a (vec_nnz·m, n) temporary.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..rng import RNGState
from .sampling import sample_distinct_uniform


@dataclasses.dataclass(frozen=True)
class SparseDist:
    """Distribution over short-axis sparse sketching operators (SASO)."""

    n_rows: int
    n_cols: int
    vec_nnz: int = 2

    @property
    def short_axis(self) -> int:
        return min(self.n_rows, self.n_cols)

    @property
    def isometry_scale(self) -> float:
        return 1.0 / math.sqrt(self.vec_nnz)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseSkOp:
    dist: SparseDist = dataclasses.field(
        metadata=dict(static=True))        # static: shapes/scale config
    rows: jax.Array = None  # (vec_nnz, long_axis) short-axis indices
    vals: jax.Array = None  # (vec_nnz, long_axis) ±1

    @property
    def n_rows(self):
        return self.dist.n_rows

    @property
    def n_cols(self):
        return self.dist.n_cols


def fill_sparse(dist: SparseDist, state: RNGState, dtype=jnp.float32,
                distinct: bool = True):
    """Sample a SASO. Returns ``(SparseSkOp, next_state)``.

    ``distinct=True`` draws the vec_nnz positions per vector without
    replacement (exact SASO); ``False`` draws iid (tiny collision rate,
    faster to sample).
    """
    d = dist.short_axis
    long_axis = max(dist.n_rows, dist.n_cols)
    if distinct and dist.vec_nnz > 1:
        idx, state = sample_distinct_uniform(d, dist.vec_nnz, long_axis, state)
        rows = idx.T  # (vec_nnz, long_axis)
    else:
        key, state = state.spawn()
        rows = jax.random.randint(key, (dist.vec_nnz, long_axis), 0, d,
                                  dtype=jnp.int32)
    skey, state = state.spawn()
    vals = jax.random.rademacher(skey, (dist.vec_nnz, long_axis),
                                 dtype=dtype)
    return SparseSkOp(dist, rows, vals), state


def saso_left_apply(S: SparseSkOp, A: jax.Array, scale: bool = True,
                    method: str = "auto"):
    """Compute (isometry-scaled) S @ A for a wide d×m SASO and m×n dense A.

    Two implementations (``method``):

    * ``"scatter"`` — vec_nnz scatter-add layers: out[rows[j, c], :] +=
      vals[j, c]·A[c, :]. Each layer streams A once; scatter-add with
      duplicate indices may serialize on an accelerator.
    * ``"gather"`` — CSR-by-output-row re-packing (one device sort), then
      L padded gather-FMA layers: out[r, :] += val·A[col, :] with cols
      *gathered*, never scattered (SURVEY.md §7 "SASO").
      Exact unconditionally: the pad bound L covers the
      row-occupancy tail, a fixed overflow buffer (one tiny scatter,
      l_over=4096) catches the rest, and the statistically-impossible
      beyond-buffer case lax.cond-falls back to the exact scatter
      formulation instead of silently dropping entries.

    ``"auto"`` → scatter (not yet measured on a GPU against the gather
    path, which is kept for shapes where scatter degrades).
    """
    d = S.dist.n_rows
    m, n = A.shape
    assert S.dist.n_cols == m, (S.dist, A.shape)
    if method == "auto":
        method = "scatter"
    if method == "gather":
        out = _saso_left_gather(S, A, d, m, n)
    else:
        out = _saso_left_scatter(S, A, d, n)
    if scale:
        out = out * jnp.asarray(S.dist.isometry_scale, A.dtype)
    return out


def _saso_left_scatter(S: SparseSkOp, A: jax.Array, d: int, n: int):
    """Scatter-layer SASO apply — vec_nnz scatter-add passes over A.
    Exact for any row occupancy (duplicate indices accumulate)."""
    out = jnp.zeros((d, n), dtype=A.dtype)

    def layer(j, acc):
        r = jax.lax.dynamic_index_in_dim(S.rows, j, 0, keepdims=False)
        v = jax.lax.dynamic_index_in_dim(S.vals, j, 0, keepdims=False)
        return acc.at[r].add(v[:, None] * A)

    return jax.lax.fori_loop(0, S.dist.vec_nnz, layer, out)


def _saso_left_gather(S: SparseSkOp, A: jax.Array, d: int, m: int, n: int,
                      chunk: int = 8, l_over: int = 4096):
    """Gather-layer SASO apply (see :func:`saso_left_apply`)."""
    nnz = S.dist.vec_nnz
    N = nnz * m
    mean = N / d
    L = int(mean + 6.0 * math.sqrt(max(mean, 1.0)) + 8)
    L = min(L + (-L) % chunk, N)  # round up to the chunk size

    flat_r = S.rows.reshape(-1)
    flat_c = jnp.tile(jnp.arange(m, dtype=jnp.int32), nnz)
    flat_v = S.vals.reshape(-1)
    order = jnp.argsort(flat_r)
    sr = flat_r[order]
    sc = flat_c[order]
    sv = flat_v[order]
    start = jnp.searchsorted(sr, jnp.arange(d, dtype=sr.dtype))
    pos = jnp.arange(N) - start[sr]
    in_main = pos < L
    slot = jnp.where(in_main, sr * L + pos, d * L)  # OOB slots dropped
    cols_pad = jnp.zeros((d * L,), jnp.int32).at[slot].set(
        sc, mode="drop").reshape(d, L)
    vals_pad = jnp.zeros((d * L,), A.dtype).at[slot].set(
        sv, mode="drop").reshape(d, L)

    out = jnp.zeros((d, n), dtype=A.dtype)
    for lb in range(0, L, chunk):
        cp = cols_pad[:, lb:lb + chunk]              # (d, chunk)
        vp = vals_pad[:, lb:lb + chunk]
        gathered = A[cp, :]                          # (d, chunk, n) gather
        out = out + jnp.einsum("dl,dln->dn", vp, gathered,
                               precision=jax.lax.Precision.HIGHEST)

    # exact tail: route overflow entries through one tiny scatter
    oorder = jnp.argsort(in_main)[:l_over]           # overflow-first
    ov_is = ~in_main[oorder]
    ov_r = jnp.where(ov_is, sr[oorder], d)           # d = dropped
    ov_c = jnp.where(ov_is, sc[oorder], 0)
    ov_v = jnp.where(ov_is, sv[oorder], 0.0)
    out = out.at[ov_r].add(ov_v[:, None] * A[ov_c, :], mode="drop")

    # overflow beyond l_over is statistically impossible (6σ Binomial
    # tail + 4096 buffer) but must not be a SILENT wrong-sketch cliff:
    # if it ever happens, recompute exactly via the scatter formulation
    # (lax.cond executes only the taken branch, so the steady-state cost
    # is one scalar comparison)
    n_over = jnp.sum(~in_main)
    return jax.lax.cond(
        n_over <= l_over,
        lambda args: args[0],
        lambda args: _saso_left_scatter(S, args[1], d, n),
        (out, A))


def saso_right_apply(A: jax.Array, S: SparseSkOp, scale: bool = True):
    """Compute A @ S for an m×d tall SASO (sketching columns): (n×m)·(m×d)."""
    # A: (n, m), S: m×d with short axis d → per row of S (long axis m),
    # vec_nnz entries into [0, d). out[:, cols[j,r]] += vals[j,r] * A[:, r].
    n, m = A.shape
    assert S.dist.n_rows == m, (S.dist, A.shape)
    d = S.dist.n_cols
    out = jnp.zeros((n, d), dtype=A.dtype)

    def layer(j, acc):
        c = jax.lax.dynamic_index_in_dim(S.rows, j, 0, keepdims=False)
        v = jax.lax.dynamic_index_in_dim(S.vals, j, 0, keepdims=False)
        return acc.T.at[c].add((A * v[None, :]).T).T

    out = jax.lax.fori_loop(0, S.dist.vec_nnz, layer, out)
    if scale:
        out = out * jnp.asarray(S.dist.isometry_scale, A.dtype)
    return out


def saso_to_dense(S: SparseSkOp, dtype=None, scale: bool = True):
    """Materialize the SASO as a dense (n_rows, n_cols) array (tests/small d)."""
    dtype = dtype or S.vals.dtype
    d = S.dist.short_axis
    long_axis = max(S.dist.n_rows, S.dist.n_cols)
    dense = jnp.zeros((d, long_axis), dtype=dtype)
    cols = jnp.broadcast_to(jnp.arange(long_axis), S.rows.shape)
    dense = dense.at[S.rows.ravel(), cols.ravel()].add(
        S.vals.ravel().astype(dtype))
    if scale:
        dense = dense * jnp.asarray(S.dist.isometry_scale, dtype)
    if S.dist.n_rows > S.dist.n_cols:  # tall operator: short axis is cols
        dense = dense.T
    return dense
