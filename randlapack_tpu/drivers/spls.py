"""Sketch-and-precondition least squares (the reference exposes the pieces
— rpc_data_svd_saso + pcg_saddle — and tests them end-to-end in
extras' test_pcgls; this driver is the composed convenience API):

    min_x ‖A x − b‖² + μ‖x‖²  via PCG on (AᵀA + μI) x = Aᵀb,
    right-preconditioned by M = V_sk diag(1/√(σ_sk² + μ)).
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..comps.determiter import PCGSaddleConfig, pcg_saddle
from ..comps.preconditioners import (make_right_orthogonalizer,
                                     rpc_data_svd_saso)


@dataclasses.dataclass(frozen=True)
class SPLSConfig:
    d_factor: float = 4.0         # sketch rows = d_factor * n
    vec_nnz: int = 8
    precond: str = "svd"          # "qr": M = R_sk⁻¹ (exact triangular; best
                                  # for μ≈0, costs a tall QR);
                                  # "svd": V/√(σ²+μ) (the
                                  # reference's rpc_data_svd path — handles
                                  # μ>0 and rank deficiency)
    solver: str = "auto"          # "auto": lsqr for single-rhs b, pcg for
                                  # multi-rhs (lsqr is single-rhs only).
                                  # "pcg" (normal equations, the
                                  # reference's path — x-accuracy limited
                                  # to κ²·eps) | "lsqr" (works on A
                                  # directly: attainable x-accuracy κ·eps
                                  # — hence the default)
    refine_precond: bool = True   # one CholQR pass of M against the sketch
                                  # Gram — repairs the Gram/eigh SVD's
                                  # trailing-vector error; no-op
                                  # effect when the SVD is exact
    pcg: PCGSaddleConfig = PCGSaddleConfig()


def spls(A: jax.Array, b: jax.Array, mu, cfg: SPLSConfig, state: RNGState,
         precision=STABLE_PRECISION):
    """Solve the regularized overdetermined least-squares problem.

    Returns ``(x, res_hist, iters, next_state)``.
    """
    m, n = A.shape
    d = min(int(cfg.d_factor * n), m)
    if cfg.precond == "qr":
        from ..sketching import SparseDist, fill_sparse, saso_left_apply
        op, state = fill_sparse(SparseDist(d, m, cfg.vec_nnz), state,
                                dtype=A.dtype)
        A_sk = saso_left_apply(op, A)
        _, R_sk = jax.lax.linalg.qr(A_sk, full_matrices=False)
        eps = jnp.finfo(A.dtype).eps
        dg = jnp.diag(R_sk)
        # relative floor only: an absolute +eps would swamp every diagonal
        # of a small-normed sketch (see bqrrp._safe_triu_diag)
        mxd = jnp.max(jnp.abs(dg))
        ref = jnp.where(mxd > 0.0, mxd * eps, jnp.asarray(1.0, A.dtype))
        R_sk = R_sk - jnp.diag(dg) + jnp.diag(
            jnp.where(jnp.abs(dg) > ref, dg, ref))
        M = jax.lax.linalg.triangular_solve(
            R_sk, jnp.eye(n, dtype=A.dtype), left_side=True, lower=False)
    else:
        if cfg.refine_precond:
            from ..comps.preconditioners import right_precond_saso
            M, _, _, state = right_precond_saso(A, d, mu, state,
                                                cfg.vec_nnz,
                                                precision=precision)
        else:
            V_sk, sigma_sk, state = rpc_data_svd_saso(
                A, d, state, cfg.vec_nnz, precision=precision)
            M, _ = make_right_orthogonalizer(V_sk, sigma_sk, mu)
    solver = cfg.solver
    if solver == "auto":
        solver = "lsqr" if (b.ndim == 1 or b.shape[1] == 1) else "pcg"
    if solver == "lsqr":
        from ..comps.lsqr import LSQRConfig, lsqr
        assert b.ndim == 1 or b.shape[1] == 1, "lsqr path is single-rhs"
        lcfg = LSQRConfig(tol=cfg.pcg.tol, max_iters=cfg.pcg.max_iters)
        mu_ = jnp.asarray(mu, A.dtype)
        if float(jnp.max(jnp.atleast_1d(mu_))) > 0.0:
            # damped least squares: min |Ax-b|^2 + mu|x|^2 as the
            # augmented system [A; sqrt(mu) I] x = [b; 0] (Paige-Saunders
            # damping) — plain LSQR on A would silently drop the
            # regularizer
            A_aug = jnp.concatenate(
                [A, jnp.sqrt(mu_) * jnp.eye(n, dtype=A.dtype)], axis=0)
            b_aug = jnp.concatenate(
                [b.reshape(-1), jnp.zeros((n,), A.dtype)])
            x, hist, iters = lsqr(A_aug, b_aug, M, lcfg, precision)
        else:
            x, hist, iters = lsqr(A, b, M, lcfg, precision)
        return x, hist, iters, state
    x0 = jnp.zeros((n,) + b.shape[1:], A.dtype)
    c = jnp.zeros_like(x0)
    if b.ndim == 1:
        b2, x02, c2 = b[:, None], x0[:, None], c[:, None]
    else:
        b2, x02, c2 = b, x0, c
    x, hist, iters = pcg_saddle(A, b2, c2, mu, M, x02, cfg.pcg, precision)
    if b.ndim == 1:
        x = x[:, 0]
    return x, hist, iters, state
