"""Deterministic iterative solvers — preconditioned CG family
(reference: RandLAPACK/comps/rl_determiter.hh: pcg :372 with lockstep and
block modes, posm_square :232, psd_sqrt_pinv :181, pcg_saddle :19,
StatefulFrobeniusNorm :140).

Design: lax.while_loop with a convergence *mask* — converged columns
freeze (the reference's lockstep mode zeroing off-diagonal scalars,
:418-440, is exactly per-column masked CG); residual history is a
preallocated (max_iters, s) array. Everything jit-traceable.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


def _apply(op, X, precision):
    if op is None:
        return X
    if hasattr(op, "matmat"):
        return op.matmat(X, precision)
    if callable(op):
        return op(X)
    return jnp.matmul(op, X, precision=precision)


@dataclasses.dataclass(frozen=True)
class PCGConfig:
    tol: float = 1e-8             # relative residual target
    max_iters: int = 100
    mode: str = "lockstep"        # "lockstep" (per-column) | "block"
    verbose: bool = False         # per-iteration residual trace via
                                  # jax.debug.print (the reference's
                                  # ``verbose`` cout trace,
                                  # rl_determiter.hh:428,466)


def frobenius_seminorm(R: jax.Array):
    """The reference's ``StatefulFrobeniusNorm`` measure
    (rl_determiter.hh:140) minus the host-side history (pcg's returned
    hist array carries it): ‖R‖_F over the whole block residual."""
    return jnp.linalg.norm(R)


@partial(jax.jit, static_argnames=("cfg", "precision", "seminorm"))
def pcg(G, H: jax.Array, N, X0: jax.Array, cfg: PCGConfig,
        precision=STABLE_PRECISION, seminorm=None):
    """Preconditioned CG for G X = H (s columns).

    ``G``/``N`` are linops, callables, or dense arrays; ``N=None`` means no
    preconditioner. Lockstep mode solves the s systems independently with
    per-column scalars and a convergence mask; block mode couples them with
    b×b scalar solves (classical block CG, faster for one operator with
    multiple right-hand sides).

    ``seminorm`` (rl_determiter.hh:299-345): an optional jit-traceable
    callable ``val = seminorm(R)`` mapping the (n, s) block residual to a
    scalar — a problem seminorm (may be 0 on a fixed subspace). When given,
    the reference's stopping rule replaces the per-column one: iterate
    until ``seminorm(N·R) ≤ tol·(1 + seminorm(N·R₀))``, and the returned
    hist is (max_iters+1, 2) holding the even/odd seminorm calls — column
    0 the raw residual R, column 1 the preconditioned residual N·R (the
    reference calls seminorm twice per iteration in exactly this order).
    ``frobenius_seminorm`` reproduces StatefulFrobeniusNorm.

    Returns ``(X, res_hist, iters)``: res_hist (max_iters+1, s) of
    per-column residual norms (‖·‖₂; entries past convergence repeat the
    final value) — or the (max_iters+1, 2) seminorm trace above —
    and iters the iteration count actually performed.
    """
    n, s = H.shape
    dtype = H.dtype
    nrm_H = jnp.linalg.norm(H, axis=0)
    tol_abs = cfg.tol * jnp.maximum(nrm_H, jnp.finfo(dtype).tiny)

    R = H - _apply(G, X0, precision)
    Z = _apply(N, R, precision)
    P = Z
    if seminorm is None:
        hist0 = jnp.zeros((cfg.max_iters + 1, s), dtype)
        hist0 = hist0.at[0].set(jnp.linalg.norm(R, axis=0))
        sn_stop = None
    else:
        sn_z0 = seminorm(Z)
        sn_stop = jnp.asarray(cfg.tol, dtype) * (1.0 + sn_z0)
        hist0 = jnp.zeros((cfg.max_iters + 1, 2), dtype)
        hist0 = hist0.at[0, 0].set(seminorm(R)).at[0, 1].set(sn_z0)

    if cfg.mode == "lockstep":
        rho0 = jnp.sum(R * Z, axis=0)

        def cond(carry):
            X, R, Z, P, rho, hist, it = carry
            if seminorm is not None:
                return (it < cfg.max_iters) & (hist[it, 1] > sn_stop)
            return (it < cfg.max_iters) & jnp.any(
                jnp.linalg.norm(R, axis=0) > tol_abs)

        def body(carry):
            X, R, Z, P, rho, hist, it = carry
            if seminorm is None:
                active = (jnp.linalg.norm(R, axis=0)
                          > tol_abs).astype(dtype)
            else:
                active = jnp.ones((s,), dtype)   # global stop, no freeze
            W = _apply(G, P, precision)
            denom = jnp.sum(P * W, axis=0)
            alpha = jnp.where(denom != 0, rho / jnp.where(denom != 0, denom,
                                                          1.0), 0.0)
            alpha = alpha * active
            X = X + P * alpha[None, :]
            R = R - W * alpha[None, :]
            Z = _apply(N, R, precision)
            rho_new = jnp.sum(R * Z, axis=0)
            beta = jnp.where(rho != 0, rho_new / jnp.where(rho != 0, rho, 1.0),
                             0.0) * active
            P = Z + P * beta[None, :]
            if seminorm is None:
                res = jnp.linalg.norm(R, axis=0)
                hist = hist.at[it + 1].set(res)
            else:
                res = seminorm(Z)
                hist = hist.at[it + 1, 0].set(seminorm(R))
                hist = hist.at[it + 1, 1].set(res)
            if cfg.verbose:
                jax.debug.print("pcg iter {it}: max residual {r}",
                                it=it + 1, r=jnp.max(res))
            return X, R, Z, P, rho_new, hist, it + 1

        X, R, Z, P, rho, hist, it = jax.lax.while_loop(
            cond, body, (X0, R, Z, P, rho0, hist0, jnp.int32(0)))
        return X, hist, it

    # block mode: s coupled rhs of ONE operator; b×b scalar systems solved
    # with Cholesky, falling back to eigh pseudo-inverse (posm_square).
    def _psd_solve(M, B):
        L = jax.lax.linalg.cholesky(M)
        ok = ~jnp.any(jnp.isnan(L))

        def chol_solve(_):
            y = jax.lax.linalg.triangular_solve(L, B, left_side=True,
                                                lower=True)
            return jax.lax.linalg.triangular_solve(L, y, left_side=True,
                                                   lower=True,
                                                   transpose_a=True)

        def pinv_solve(_):
            w, U = jnp.linalg.eigh(0.5 * (M + M.T))
            tol = jnp.maximum(jnp.max(jnp.abs(w)), 0.0) * s * jnp.finfo(dtype).eps
            winv = jnp.where(jnp.abs(w) > tol, 1.0 / jnp.where(w != 0, w, 1.0),
                             0.0)
            hp = STABLE_PRECISION
            return jnp.matmul(U, winv[:, None] * jnp.matmul(
                U.T, B, precision=hp), precision=hp)

        return jax.lax.cond(ok, chol_solve, pinv_solve, None)

    rho0 = jnp.matmul(R.T, Z, precision=precision)   # (s, s)

    def cond_b(carry):
        X, R, Z, P, rho, hist, it = carry
        if seminorm is not None:
            return (it < cfg.max_iters) & (hist[it, 1] > sn_stop)
        return (it < cfg.max_iters) & jnp.any(
            jnp.linalg.norm(R, axis=0) > tol_abs)

    def body_b(carry):
        X, R, Z, P, rho, hist, it = carry
        W = _apply(G, P, precision)
        alpha = _psd_solve(jnp.matmul(P.T, W, precision=precision), rho)
        X = X + jnp.matmul(P, alpha, precision=precision)
        R = R - jnp.matmul(W, alpha, precision=precision)
        Z = _apply(N, R, precision)
        rho_new = jnp.matmul(R.T, Z, precision=precision)
        beta = _psd_solve(rho, rho_new)
        P = Z + jnp.matmul(P, beta, precision=precision)
        if seminorm is None:
            res = jnp.linalg.norm(R, axis=0)
            hist = hist.at[it + 1].set(res)
        else:
            res = seminorm(Z)
            hist = hist.at[it + 1, 0].set(seminorm(R))
            hist = hist.at[it + 1, 1].set(res)
        if cfg.verbose:
            jax.debug.print("pcg(block) iter {it}: max residual {r}",
                            it=it + 1, r=jnp.max(res))
        return X, R, Z, P, rho_new, hist, it + 1

    X, R, Z, P, rho, hist, it = jax.lax.while_loop(
        cond_b, body_b, (X0, R, Z, P, rho0, hist0, jnp.int32(0)))
    return X, hist, it


@partial(jax.jit, static_argnames=())
def psd_sqrt_pinv(A: jax.Array):
    """Square-root pseudo-inverse factor of a symmetric PSD matrix
    (reference: rl_determiter.hh:181 ``psd_sqrt_pinv``): B with
    pinv(A) = B·Bᵀ via eigendecomposition, kernel eigenvectors zeroed.

    Returns ``(B, ker_dim, code)`` — B (n, n) with the kernel
    eigenvectors' columns zeroed in place (static shapes; eigh orders
    eigenvalues ASCENDING, so the zeroed columns are the LEADING
    ``ker_dim`` columns of B, not the trailing ones),
    ker_dim = dim(ker A) as int32, and ``code`` the jit-safe analogue of
    the reference's return value: ker_dim when A is PSD, −(n+1) when A is
    not PSD (λ_min < −tol), −(n+2) when A ≈ 0 — a returned flag, never an
    exception, per the repo's failure convention.
    """
    n = A.shape[0]
    dtype = A.dtype
    w, U = jnp.linalg.eigh(0.5 * (A + A.T))
    rel_tol = 10.0 * jnp.finfo(dtype).eps
    abs_tol = rel_tol * jnp.maximum(jnp.asarray(1.0, dtype), w[-1])
    not_psd = w[0] < -abs_tol
    is_zero = w[-1] < abs_tol
    keep = w > abs_tol
    ker = jnp.asarray(n, jnp.int32) - jnp.sum(keep).astype(jnp.int32)
    scale = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, w, 1.0)), 0.0)
    B = U * scale[None, :]
    code = jnp.where(not_psd, jnp.int32(-(n + 1)),
                     jnp.where(is_zero, jnp.int32(-(n + 2)),
                               ker))
    return B, ker, code


@dataclasses.dataclass(frozen=True)
class PCGSaddleConfig:
    tol: float = 1e-10
    max_iters: int = 200
    refresh_every: int = 50       # exact-residual recompute period (:92)
    verbose: bool = False         # per-iteration residual trace
                                  # (rl_determiter.hh:428 analogue)


@partial(jax.jit, static_argnames=("cfg", "precision"))
def pcg_saddle(A: jax.Array, b: jax.Array, c: jax.Array, mu,
               M: jax.Array, x0: jax.Array, cfg: PCGSaddleConfig,
               precision=STABLE_PRECISION):
    """PCG for the regularized normal equations (AᵀA + μI) x = Aᵀb − c with
    right preconditioner M (so N = M Mᵀ) — the sketch-and-precondition
    least-squares core (reference: rl_determiter.hh:19; the preconditioner
    comes from ``preconditioners.rpc_data_svd``).

    Returns ``(x, res_hist, iters)``.
    """
    dtype = A.dtype
    mu = jnp.asarray(mu, dtype)

    def G(x):
        return jnp.matmul(A.T, jnp.matmul(A, x, precision=precision),
                          precision=precision) + mu * x

    def N(r):
        return jnp.matmul(M, jnp.matmul(M.T, r, precision=precision),
                          precision=precision)

    rhs = jnp.matmul(A.T, b, precision=precision) - c
    nrm_rhs = jnp.linalg.norm(rhs)
    tol_abs = cfg.tol * jnp.maximum(nrm_rhs, jnp.finfo(dtype).tiny)

    r = rhs - G(x0)
    z = N(r)
    p = z
    rho0 = jnp.sum(r * z)
    hist0 = jnp.zeros((cfg.max_iters + 1,), dtype).at[0].set(
        jnp.linalg.norm(r))

    def cond(carry):
        x, r, z, p, rho, hist, it = carry
        return (it < cfg.max_iters) & (jnp.linalg.norm(r) > tol_abs)

    def body(carry):
        x, r, z, p, rho, hist, it = carry
        w = G(p)
        alpha = rho / jnp.sum(p * w)
        x = x + alpha * p
        r_upd = r - alpha * w
        # periodic exact-residual refresh fights drift (:92)
        r = jax.lax.cond((it + 1) % cfg.refresh_every == 0,
                         lambda _: rhs - G(x), lambda _: r_upd, None)
        z = N(r)
        rho_new = jnp.sum(r * z)
        beta = rho_new / rho
        p = z + beta * p
        hist = hist.at[it + 1].set(jnp.linalg.norm(r))
        if cfg.verbose:
            jax.debug.print("pcg_saddle iter {it}: residual {r}",
                            it=it + 1, r=jnp.linalg.norm(r))
        return x, r, z, p, rho_new, hist, it + 1

    x, r, z, p, rho, hist, it = jax.lax.while_loop(
        cond, body, (x0, r, z, p, rho0, hist0, jnp.int32(0)))
    return x, hist, it
