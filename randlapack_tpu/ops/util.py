"""Matrix utilities — the reference's ``RandLAPACK::util`` surface
(reference: RandLAPACK/misc/rl_util.hh), redesigned for XLA: everything is a
pure, jit-traceable function on arrays; layout/lda plumbing disappears.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


def eye(m: int, n: int, dtype=jnp.float32) -> jax.Array:
    return jnp.eye(m, n, dtype=dtype)


def get_U(A: jax.Array, k: int = 0) -> jax.Array:
    """Upper triangle (rl_util.hh:120)."""
    return jnp.triu(A, k)


def get_L(A: jax.Array, unit_diag: bool = False) -> jax.Array:
    """Lower triangle, optionally with unit diagonal (rl_util.hh:102)."""
    L = jnp.tril(A)
    if unit_diag:
        n = min(A.shape)
        L = L - jnp.diag(jnp.diag(L)) + jnp.eye(A.shape[0], A.shape[1],
                                                dtype=A.dtype)
        L = jnp.tril(L)
    return L


def col_swap(A: jax.Array, J: jax.Array) -> jax.Array:
    """Column permutation A[:, J] — the reference's lapmt-backed col_swap
    (rl_util.hh:152) becomes a gather."""
    return jnp.take(A, J, axis=1)


def row_swap(A: jax.Array, J: jax.Array) -> jax.Array:
    return jnp.take(A, J, axis=0)


def compose_pivots(J_outer: jax.Array, J_inner: jax.Array) -> jax.Array:
    """Pivot composition: applying J_inner after J_outer equals J_outer[J_inner]."""
    return jnp.take(J_outer, J_inner)


def invert_pivots(J: jax.Array) -> jax.Array:
    """Inverse permutation."""
    n = J.shape[0]
    return jnp.zeros(n, J.dtype).at[J].set(jnp.arange(n, dtype=J.dtype))


def naive_rank_est(diag_R: jax.Array, tol) -> jax.Array:
    """Largest k such that |R[i,i]| > tol for all i < k
    (reference: rl_cqrrpt.hh:267-272, gpu kernel rl_cuda_kernels.cuh:68).
    jit-safe: returns an int32 scalar."""
    ok = (jnp.abs(diag_R) > tol).astype(jnp.int32)
    return jnp.sum(jnp.cumprod(ok))


def normc(A: jax.Array) -> jax.Array:
    """Column-normalized copy (rl_util.hh:254)."""
    nrm = jnp.linalg.norm(A, axis=0, keepdims=True)
    return A / jnp.where(nrm > 0, nrm, 1.0)


def orthogonality_check(Q: jax.Array, precision=STABLE_PRECISION) -> jax.Array:
    """‖QᵀQ − I‖_F (rl_util.hh:468)."""
    k = Q.shape[1]
    G = jnp.matmul(Q.T, Q, precision=precision)
    return jnp.linalg.norm(G - jnp.eye(k, dtype=Q.dtype))


def cond_num_check(A: jax.Array) -> jax.Array:
    """2-norm condition number via SVD (rl_util.hh:403)."""
    s = jnp.linalg.svd(A, compute_uv=False)
    return s[0] / s[-1]


def rank_check(A: jax.Array, rel_tol: float = 1e-12) -> jax.Array:
    """Numerical rank via singular values (rl_util.hh:427)."""
    s = jnp.linalg.svd(A, compute_uv=False)
    return jnp.sum(s > rel_tol * s[0]).astype(jnp.int32)


def fro_norm(A: jax.Array) -> jax.Array:
    return jnp.linalg.norm(A)


def diag_is_nonzero(A: jax.Array, tol=0.0) -> jax.Array:
    """True iff every diagonal entry exceeds tol in magnitude (rl_util.hh:138)."""
    return jnp.all(jnp.abs(jnp.diag(A)) > tol)


def rank_search_binary(singvals: jax.Array, tol) -> jax.Array:
    """Index of the smallest singular value above tol (rl_util.hh:223
    semantics, but vectorized — no binary search needed)."""
    return jnp.sum(singvals > tol).astype(jnp.int32)


# -- RandBLAS small-util parity (SURVEY §2.9: symmetrize, safe_scal,
#    omatcopy, dims_before_op) ------------------------------------------

def symmetrize(A: jax.Array, uplo: str = "upper") -> jax.Array:
    """Copy one triangle onto the other (RandBLAS ``symmetrize``):
    ``uplo`` names the triangle holding the data."""
    if uplo == "upper":
        U = jnp.triu(A)
        return U + jnp.triu(A, 1).T
    L = jnp.tril(A)
    return L + jnp.tril(A, -1).T


def safe_scal(alpha, x: jax.Array) -> jax.Array:
    """Overflow-guarded scaling (RandBLAS ``safe_scal``): splits α into
    √α·√α when |α| would overflow intermediate squares downstream."""
    dtype = x.dtype
    alpha = jnp.asarray(alpha, dtype)
    big = jnp.sqrt(jnp.asarray(jnp.finfo(dtype).max, dtype))
    r = jnp.sqrt(jnp.abs(alpha))
    s = jnp.sign(alpha)
    return jnp.where(jnp.abs(alpha) > big, (s * r) * (r * x), alpha * x)


def omatcopy(A: jax.Array, trans: bool = False, alpha=1.0) -> jax.Array:
    """Out-of-place scaled copy/transpose (RandBLAS ``omatcopy``)."""
    out = A.T if trans else A
    return jnp.asarray(alpha, A.dtype) * out


def dims_before_op(n_rows: int, n_cols: int, trans: bool):
    """Dimensions of X such that op(X) is n_rows × n_cols (RandBLAS
    ``dims_before_op``)."""
    return (n_cols, n_rows) if trans else (n_rows, n_cols)


def transpose_square(A: jax.Array) -> jax.Array:
    """Square-matrix transpose (rl_util.hh:279 ``transpose_square``).

    The reference transposes in place by swapping off-diagonal pairs of a
    column-major buffer; XLA arrays are immutable and layout-free, so the
    whole family of buffer-layout utilities collapses: this is
    ``A.T`` (and rl_util.hh:315 ``transposition`` is :func:`omatcopy`
    with ``trans=True``; rl_util.hh:295 ``eat_lda_slack`` has no analogue
    at all — there is no leading-dimension stride to strip)."""
    m, n = A.shape
    assert m == n, f"transpose_square needs square input, got {A.shape}"
    return A.T
