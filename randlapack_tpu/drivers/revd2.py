"""REVD2 — rank-adaptive Nyström eigendecomposition of a PSD operator
(reference: RandLAPACK/drivers/rl_revd2.hh: REVD2::call :131/:152;
Algorithm E2 of arXiv:2110.02820): SYRF basis, shifted CholQR of QᵀY,
SVD, eigenvalue de-regularization; k doubles until the power-iteration
error estimate ≤ 5·max(tol, ν) (:238-244).

Design: the fixed-rank core ``revd2_fixed_rank`` is one jitted graph;
the adaptive driver doubles k in a host loop (few distinct shapes, each
jit-cached).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..comps.syrf import SYRFConfig, syrf
from ..comps.syps import _apply_sym
from ..ops.svd import svd_econ


@dataclasses.dataclass(frozen=True)
class REVD2Config:
    syrf: SYRFConfig = SYRFConfig()
    error_est_passes: int = 10    # power-iteration steps for the error est
    svd_method: str = "auto"      # see ops.svd.svd_econ


def _power_error_est(A, V, lam, passes, state: RNGState, precision):
    """‖A − V diag(λ) Vᵀ‖₂ estimate by power iteration (rl_revd2.hh:26)."""
    n = V.shape[0]
    key, state = state.spawn()
    v = jax.random.normal(key, (n, 1), dtype=V.dtype)
    v = v / jnp.linalg.norm(v)

    def resid_apply(x):
        return (_apply_sym(A, x, precision)
                - jnp.matmul(V, lam[:, None] * jnp.matmul(
                    V.T, x, precision=precision), precision=precision))

    def body(i, carry):
        v, est = carry
        w = resid_apply(v)
        nrm = jnp.linalg.norm(w)
        return w / jnp.maximum(nrm, jnp.finfo(V.dtype).tiny), nrm

    v, est = jax.lax.fori_loop(0, passes, body, (v, jnp.zeros((), V.dtype)))
    return est, state


@partial(jax.jit, static_argnames=("k", "cfg", "precision"))
def revd2_fixed_rank(A, k: int, cfg: REVD2Config, state: RNGState,
                     precision=STABLE_PRECISION):
    """Rank-k Nyström EVD of PSD A (dense or symmetric linop).

    Returns ``(V, lam, err_est, nu, fail, next_state)`` with
    A ≈ V diag(lam) Vᵀ, V (n,k) orthonormal, lam descending, ``err_est``
    the estimated 2-norm residual, ``nu`` the Nyström shift (the reference
    compares err ≤ 5·max(tol, ν), rl_revd2.hh:238-244), and ``fail`` True
    on Cholesky breakdown (NaNs would otherwise propagate silently).
    """
    Q, state = syrf(A, k, cfg.syrf, state, precision)
    Y = _apply_sym(A, Q, precision)
    dtype = Y.dtype
    eps = jnp.finfo(dtype).eps
    n = Q.shape[0]
    nu = jnp.sqrt(jnp.asarray(n, dtype)) * eps * jnp.linalg.norm(Y)
    Y = Y + nu * Q
    C = jax.lax.linalg.cholesky(
        0.5 * (jnp.matmul(Q.T, Y, precision=precision)
               + jnp.matmul(Y.T, Q, precision=precision)))
    fail = jnp.any(jnp.isnan(C))
    # B = Y·C⁻ᵀ (C lower): solve B Cᵀ = Y
    B = jax.lax.linalg.triangular_solve(C, Y, left_side=False, lower=True,
                                        transpose_a=True)
    V, S, _ = svd_econ(B, cfg.svd_method, precision)
    lam = jnp.maximum(S * S - nu, 0.0)
    err, state = _power_error_est(A, V, lam, cfg.error_est_passes, state,
                                  precision)
    return V, lam, err, nu, fail, state


def revd2(A, k: int, tol: float, cfg: REVD2Config, state: RNGState,
          k_max: int | None = None, precision=STABLE_PRECISION):
    """Adaptive REVD2: doubles k until err_est ≤ 5·max(tol, ν)
    (rl_revd2.hh:238-244).

    Returns ``(V, lam, k_used, err, fail, next_state)``. ``fail`` is True
    if the final fixed-rank call broke down (Cholesky NaN or NaN error
    estimate) — the loop stops doubling on breakdown rather than running
    to k_max on garbage.
    """
    n = A.dim if hasattr(A, "dim") else A.shape[0]
    k_max = k_max or n
    while True:
        V, lam, err, nu, fail, state = revd2_fixed_rank(A, k, cfg, state,
                                                        precision)
        err_h = float(err)
        failed = bool(fail) or math.isnan(err_h)
        if (failed or err_h <= 5 * max(tol, float(nu))
                or 2 * k > min(k_max, n)):
            return V, lam, k, err_h, failed, state
        k = 2 * k
