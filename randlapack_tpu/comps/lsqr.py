"""LSQR — Golub-Kahan bidiagonalization least squares, with right
preconditioning.

The reference solves sketch-preconditioned least squares through PCG on
the normal equations (rl_determiter.hh pcg_saddle), whose attainable
x-accuracy is κ(A)²·eps. LSQR works on A directly (one A-apply and one
Aᵀ-apply per iteration) so the attainable accuracy is κ(A)·eps — the
better default for ill-conditioned systems. With the sketch-derived right
preconditioner M (A·M near-orthonormal) convergence takes O(log 1/tol)
iterations, independent of κ(A).

Precision note: the advantage materializes in f64 (measured 1000× better
x-error than pcg_saddle at κ=1e8). In f32 the Givens recurrences and
the preconditioner quality dominate.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


@dataclasses.dataclass(frozen=True)
class LSQRConfig:
    tol: float = 1e-10            # relative residual-reduction target
    max_iters: int = 200
    stall_patience: int = 3       # consecutive no-progress iterations
                                  # before the plateau cutoff fires; the
                                  # threshold is dtype-aware (1 − 8·eps),
                                  # so a single rounded-to-zero decrease
                                  # (common in f32) doesn't abort a
                                  # genuine mid-convergence plateau


@partial(jax.jit, static_argnames=("cfg", "precision"))
def lsqr(A: jax.Array, b: jax.Array, M: jax.Array | None,
         cfg: LSQRConfig, precision=STABLE_PRECISION):
    """Solve min‖A x − b‖₂ via LSQR on the right-preconditioned system
    A·M·y = b (x = M·y). ``M=None`` runs plain LSQR.

    Returns ``(x, res_hist, iters)`` — res_hist holds ‖AᵀA-residual‖-proxy
    values (phibar, the estimated ‖Ax−b‖ per iteration).
    """
    dtype = A.dtype
    b = b if b.ndim == 1 else b[:, 0]

    def op(v):       # A M v
        w = v if M is None else jnp.matmul(M, v, precision=precision)
        return jnp.matmul(A, w, precision=precision)

    def op_t(u):     # (A M)ᵀ u
        w = jnp.matmul(A.T, u, precision=precision)
        return w if M is None else jnp.matmul(M.T, w, precision=precision)

    n_y = A.shape[1]
    tiny = jnp.finfo(dtype).tiny

    beta1 = jnp.linalg.norm(b)
    u = b / jnp.maximum(beta1, tiny)
    v_raw = op_t(u)
    alpha = jnp.linalg.norm(v_raw)
    v = v_raw / jnp.maximum(alpha, tiny)
    w = v
    y0 = jnp.zeros((n_y,), dtype)
    hist0 = jnp.zeros((cfg.max_iters + 1,), dtype).at[0].set(beta1)

    # plateau threshold: phibar is monotone nonincreasing; an iteration
    # whose decrease rounds below 8·eps relative counts as stalled, and
    # only ``stall_patience`` CONSECUTIVE stalls abort (a lone rounded
    # f32 step on a clustered spectrum must not end the solve early)
    stall_thresh = 1.0 - 8.0 * float(jnp.finfo(dtype).eps)

    def cond(carry):
        (y, u, v, w, alpha, beta, rhobar, phibar, phibar_prev, stall,
         hist, it) = carry
        return ((it < cfg.max_iters) & (phibar > cfg.tol * beta1)
                & (stall < cfg.stall_patience))

    def body(carry):
        (y, u, v, w, alpha, beta, rhobar, phibar, phibar_prev, stall,
         hist, it) = carry
        phibar_prev = phibar
        # bidiagonalization step
        u_raw = op(v) - alpha * u
        beta = jnp.linalg.norm(u_raw)
        u = u_raw / jnp.maximum(beta, tiny)
        v_raw = op_t(u) - beta * v
        alpha_new = jnp.linalg.norm(v_raw)
        v = v_raw / jnp.maximum(alpha_new, tiny)
        # Givens rotation
        rho = jnp.sqrt(rhobar * rhobar + beta * beta)
        c = rhobar / jnp.maximum(rho, tiny)
        s = beta / jnp.maximum(rho, tiny)
        theta = s * alpha_new
        rhobar = -c * alpha_new
        phi = c * phibar
        phibar = s * phibar
        # update
        y = y + (phi / jnp.maximum(rho, tiny)) * w
        w = v - (theta / jnp.maximum(rho, tiny)) * w
        hist = hist.at[it + 1].set(phibar)
        stall = jnp.where(phibar > stall_thresh * phibar_prev,
                          stall + 1, jnp.int32(0))
        return (y, u, v, w, alpha_new, beta, rhobar, phibar, phibar_prev,
                stall, hist, it + 1)

    carry = (y0, u, v, w, alpha, jnp.zeros((), dtype), alpha, beta1,
             2.0 * beta1 + 1.0, jnp.int32(0), hist0, jnp.int32(0))
    (y, u, v, w, alpha, beta, rhobar, phibar, phibar_prev, stall, hist,
     it) = jax.lax.while_loop(cond, body, carry)
    x = y if M is None else jnp.matmul(M, y, precision=precision)
    return x, hist, it
