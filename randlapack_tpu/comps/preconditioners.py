"""Preconditioner constructors (reference:
RandLAPACK/comps/rl_preconditioners.hh: rpc_data_svd :30,
rpc_data_svd_saso :136, make_right_orthogonalizer :194, nystrom_pc_data
:283, rpchol_pc_data :348).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..sketching import SparseDist, fill_sparse, saso_left_apply
from .rpchol import RPCholConfig, rp_cholesky
from ..ops.svd import svd_econ


@partial(jax.jit, static_argnames=("d", "vec_nnz", "svd_method", "precision"))
def rpc_data_svd_saso(A: jax.Array, d: int, state: RNGState,
                      vec_nnz: int = 8, svd_method: str = "auto",
                      precision=STABLE_PRECISION):
    """Sketch A (m×n, m≫n) with a d×m SASO and SVD the sketch —
    the data for a right preconditioner of the normal equations
    (reference: rpc_data_svd_saso :136 → rpc_data_svd :30).

    Returns ``(V_sk, sigma_sk, next_state)``: right singular vectors (n,n)
    and singular values (n,) of the sketch.
    """
    m, n = A.shape
    if d >= m:
        A_sk = A          # near-square: exact sketch
    else:
        op, state = fill_sparse(SparseDist(d, m, vec_nnz), state,
                                dtype=A.dtype)
        A_sk = saso_left_apply(op, A)
    _, sigma, Vt = svd_econ(A_sk, svd_method, precision)
    return Vt.T, sigma, state


def make_right_orthogonalizer(V_sk: jax.Array, sigma_sk: jax.Array, mu,
                              rel_tol: float | None = None):
    """M = V diag(1/√(σ² + μ)) with rank thresholding (reference :194):
    the right preconditioner making (A M) nearly orthonormal (μ=0) or
    (AᵀA + μI) well-conditioned under M·Mᵀ.

    Returns ``(M, rank)``.
    """
    dtype = V_sk.dtype
    mu = jnp.asarray(mu, dtype)
    tol = rel_tol if rel_tol is not None else float(jnp.finfo(dtype).eps)
    keep = sigma_sk > sigma_sk[0] * tol
    denom = jnp.sqrt(sigma_sk * sigma_sk + mu)
    scale = jnp.where(keep, 1.0 / jnp.where(denom > 0, denom, 1.0), 0.0)
    M = V_sk * scale[None, :]
    return M, jnp.sum(keep).astype(jnp.int32)


@partial(jax.jit, static_argnames=("d", "vec_nnz", "svd_method",
                                   "refine", "precision"))
def right_precond_saso(A: jax.Array, d: int, mu, state: RNGState,
                       vec_nnz: int = 8, svd_method: str = "auto",
                       refine: bool = True, precision=STABLE_PRECISION):
    """Composed sketch-and-precondition builder:
    rpc_data_svd_saso → make_right_orthogonalizer, plus an optional
    one-pass CholQR *refinement* of M against the sketch Gram.

    Refinement rationale: when the sketch SVD runs through the Gram/eigh
    route (ops/svd.py), its singular vectors carry ~√eps subspace error
    in the trailing cluster — enough to lift κ(A·M) well above the
    subspace-embedding bound and slow PCG (measured 47 vs 19 iterations
    on the 100000×2000 BASELINE config). One Cholesky pass on
    Ĝ = Mᵀ(A_skᵀA_sk + μI)M and M ← M·L⁻ᵀ makes the *sketch-space*
    conditioning exactly 1, recovering the reference-grade preconditioner
    (rl_preconditioners.hh:30 semantics) at the cost of one d×n GEMM and
    one n×n Cholesky.

    Returns ``(M, rank, fail, next_state)``.
    """
    m, n = A.shape
    if d >= m:
        A_sk = A          # near-square: exact sketch
    else:
        op, state = fill_sparse(SparseDist(d, m, vec_nnz), state,
                                dtype=A.dtype)
        A_sk = saso_left_apply(op, A)
    _, sigma, Vt = svd_econ(A_sk, svd_method, precision)
    M, rank = make_right_orthogonalizer(Vt.T, sigma, mu)
    fail = jnp.asarray(False)
    if refine:
        mu_ = jnp.asarray(mu, A.dtype)
        AskM = jnp.matmul(A_sk, M, precision=precision)
        G = jnp.matmul(AskM.T, AskM, precision=precision)
        G = G + mu_ * jnp.matmul(M.T, M, precision=precision)
        # rank-deficient columns of M are zero -> unit diagonal keeps
        # Cholesky nonsingular without perturbing the live block
        keep = jnp.diag(G) > 0
        G = G + jnp.diag(jnp.where(keep, 0.0, 1.0).astype(A.dtype))
        L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
        bad = jnp.any(jnp.isnan(L))
        L_safe = jnp.where(bad, jnp.eye(n, dtype=A.dtype), L)
        M = jax.lax.linalg.triangular_solve(
            L_safe.T, M, left_side=False, lower=False)
        fail = bad
    return M, rank, fail, state


def nystrom_pc_data(A, k: int, state: RNGState, mus,
                    tol: float = 1e-6, precision=STABLE_PRECISION):
    """Adaptive Nyström preconditioner data for a PSD operator: REVD2
    eigenpairs (the reference composes SYPS→SYRF→REVD2, :293-317).

    Returns ``(V, lam, k_used, next_state)``.
    """
    from ..drivers.revd2 import REVD2Config, revd2
    V, lam, k_used, _, _, state = revd2(A, k, tol, REVD2Config(), state,
                                     precision=precision)
    return V, lam, k_used, state


def rpchol_pc_data(A, k: int, state: RNGState, block_size: int = 64,
                   svd_method: str = "auto", precision=STABLE_PRECISION):
    """RPCholesky-based preconditioner data (reference :348): rank-k
    pivoted-Cholesky factor F, then thin SVD so A ≈ V diag(λ) Vᵀ with
    λ = σ(F)².

    Returns ``(V, lam, pivots, next_state)``. ``A`` must expose the
    column/diagonal access used by :func:`rp_cholesky` and should evaluate
    the *unregularized* kernel (the reference toggles
    ``set_eval_includes_reg(false)`` first, rl_krill.hh:47).
    """
    F, piv, state = rp_cholesky(A, k, RPCholConfig(block_size=block_size),
                                state, precision)
    V, sig, _ = svd_econ(F, svd_method, precision)
    return V, sig * sig, piv, state
