"""CQRRT — unpivoted sketch-then-precondition CholeskyQR (reference:
RandLAPACK/drivers/rl_cqrrt.hh: CQRRTalg :21, CQRRT::call :123; algorithm
of arXiv:2111.11148): sketch A, QR the small sketch, use its R as a right
preconditioner so one CholQR pass orthogonalizes even ill-conditioned A.

Design: the sketch is SASO (scatter-add) or SRHT (GEMM-based); the Gram
matrix is one big matmul. Everything is one jitted graph; ``timing=True``
reproduces the reference's 10-slot timing vector (rl_cqrrt.hh:258-280:
saso / qr / precond / gram / potrf / q / finalize / total) as named
phases with device syncs in between.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..sketching import (SparseDist, fill_sparse, saso_left_apply,
                         srht_left_apply, srht_skop)
from ..ops.cholqr import preconditioned_cholqr
from ..ops.qr import qr_econ


class SketchKind(enum.Enum):
    saso = "saso"
    srht = "srht"
    gaussian = "gaussian"


@dataclasses.dataclass(frozen=True)
class CQRRTConfig:
    d_factor: float = 1.25        # sketch rows = d_factor * n
    sketch: SketchKind = SketchKind.saso
    vec_nnz: int = 2              # SASO nonzeros per column
    compute_q: bool = True
    orthogonalization: bool = False  # use CQRRT as a general-purpose
                                     # orthogonalizer (rl_cqrrt.hh:113-115,
                                     # :247): rank-deficient columns are
                                     # detected on the sketch-R diagonal,
                                     # completed with projected Gaussians
                                     # (the CQRRPT basis-completion path),
                                     # and the R finalize (undoing the
                                     # preconditioner) is skipped as in
                                     # the reference. Returns a 5-tuple
                                     # ``(Q, R_chol, rank, fail, state)``.
    eps_rank: float | None = None    # deficiency threshold relative to
                                     # max |diag R_sk| (None → machine eps)


def _sketch(A, d, cfg: CQRRTConfig, state: RNGState, precision):
    m = A.shape[0]
    if d >= m:
        return A, state   # near-square: exact sketch (see cqrrpt)
    if cfg.sketch == SketchKind.saso:
        op, state = fill_sparse(SparseDist(d, m, cfg.vec_nnz), state,
                                dtype=A.dtype)
        return saso_left_apply(op, A), state
    if cfg.sketch == SketchKind.srht:
        op, state = srht_skop(d, m, state, dtype=A.dtype)
        return srht_left_apply(op, A, precision=precision), state
    key, state = state.spawn()
    import math
    S = jax.random.normal(key, (d, m), dtype=A.dtype) / math.sqrt(d)
    return jnp.matmul(S, A, precision=precision), state


@partial(jax.jit, static_argnames=("cfg", "precision"))
def _sketch_jit(A, cfg, state, precision):
    d = int(cfg.d_factor * A.shape[1])
    return _sketch(A, d, cfg, state, precision)


@jax.jit
def _sketch_qr(A_sk):
    _, R_sk = qr_econ(A_sk)
    eps = jnp.finfo(A_sk.dtype).eps
    # relative floor only (an absolute eps term swamps small-normed
    # sketches — see bqrrp._safe_triu_diag); zero matrix falls back to 1
    mx = jnp.max(jnp.abs(jnp.diag(R_sk)))
    dref = jnp.where(mx > 0.0, mx * eps, jnp.asarray(1.0, A_sk.dtype))
    dsafe = jnp.where(jnp.abs(jnp.diag(R_sk)) > dref,
                      jnp.diag(R_sk), dref)
    return R_sk - jnp.diag(jnp.diag(R_sk)) + jnp.diag(dsafe)


def _cqrrt_timed(A, cfg, state, precision):
    """Phase-split execution mirroring rl_cqrrt.hh's 10 slots (precond /
    gram / potrf / q split out of the fused preconditioned CholQR)."""
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer()
    with timer.phase("saso"):
        A_sk, state = _sketch_jit(A, cfg, state, precision)
        device_sync(A_sk)
    with timer.phase("qr"):
        R_sk = _sketch_qr(A_sk)
        device_sync(R_sk)
    from ..ops.cholqr import _finite_scaled
    with timer.phase("precond"):
        A_pre = jax.jit(lambda r, a: jax.lax.linalg.triangular_solve(
            r, a, left_side=False, lower=False))(R_sk, A)
        A_pre, s, nonfin = jax.jit(_finite_scaled)(A_pre)
        device_sync(A_pre)
    with timer.phase("gram"):
        G = jax.jit(lambda x: jnp.matmul(x.T, x, precision=precision))(
            A_pre)
        device_sync(G)
    with timer.phase("potrf"):
        L = jax.jit(jax.lax.linalg.cholesky)(0.5 * (G + G.T))
        device_sync(L)
    fail = jnp.any(jnp.isnan(L)) | nonfin
    Q = None
    if cfg.compute_q:
        with timer.phase("q"):
            Q = jax.jit(lambda l, x: jax.lax.linalg.triangular_solve(
                l.T, x, left_side=False, lower=False))(L, A_pre)
            device_sync(Q)
    with timer.phase("finalize"):
        R = jax.jit(lambda l, r, ss: jnp.matmul(l.T * ss, r,
                                                precision=precision))(
            L, R_sk, s)
        device_sync(R)
    return Q, R, fail, state, timer.report()


def cqrrt(A: jax.Array, cfg: CQRRTConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False):
    """Unpivoted QR of tall A. Returns ``(Q, R, fail, next_state)``
    (+ the 10-slot phase dict when ``timing=True``).

    ``fail`` mirrors the reference's potrf-failure signal — True means the
    preconditioned CholQR broke down (A numerically rank-deficient beyond
    what preconditioning fixes).

    ``cfg.orthogonalization=True`` (rl_cqrrt.hh:113-115) instead returns
    ``(Q, R_chol, rank, fail, next_state)``: Q is a FULL (m, n)
    orthonormal basis even for rank-deficient A (deficient columns
    completed with projected Gaussians), ``rank`` counts the columns
    that came from A, and R is the un-finalized CholQR factor (the
    reference skips the preconditioner-undoing trmm in this mode,
    rl_cqrrt.hh:247).
    """
    from ..errors import require
    require(A.shape[0] >= A.shape[1],
            "cqrrt requires a tall input (m >= n, rl_cqrrt.hh contract) "
            f"— got {A.shape}")
    if cfg.orthogonalization:
        if timing:
            from ..utils.timing import PhaseTimer, device_sync
            timer = PhaseTimer()
            with timer.phase("total"):
                out = _cqrrt_orth_jit(A, cfg, state, precision)
                device_sync(out[0])
            return (*out, timer.report())
        return _cqrrt_orth_jit(A, cfg, state, precision)
    if timing:
        return _cqrrt_timed(A, cfg, state, precision)
    return _cqrrt_jit(A, cfg, state, precision)


@partial(jax.jit, static_argnames=("cfg", "precision"))
def _cqrrt_orth_jit(A: jax.Array, cfg: CQRRTConfig, state: RNGState,
                    precision=STABLE_PRECISION):
    """Orthogonalization mode (rl_cqrrt.hh:113-115): Q is ALWAYS a full
    (m, n) orthonormal basis — deficient columns (small unpivoted sketch-R
    diagonal, a column-wise mask since there is no pivoting to push them
    trailing) are zeroed through the preconditioned CholQR (identity
    padding in the Gram nests column-wise through Cholesky, exactly as
    CQRRPT's trailing-block argument) and completed with BCGS2-projected
    Gaussians. The R finalize (trmm undoing the preconditioner,
    rl_cqrrt.hh:247) is skipped as in the reference: the returned R is
    the CholQR factor of the preconditioned kept columns, meaningful only
    as a byproduct. Returns ``(Q, R_chol, rank, fail, next_state)``."""
    from ..ops.cholqr import _finite_scaled
    from .cqrrpt import _orth_phase
    m, n = A.shape
    dtype = A.dtype
    d = int(cfg.d_factor * n)
    A_sk, state = _sketch(A, d, cfg, state, precision)
    _, R_sk = qr_econ(A_sk)
    d_sk = jnp.diag(R_sk)
    mx = jnp.max(jnp.abs(d_sk))
    eps = cfg.eps_rank or float(jnp.finfo(dtype).eps)
    tol = jnp.where(mx > 0.0, mx * eps, jnp.asarray(1.0, dtype))
    keep = (jnp.abs(d_sk) > tol).astype(dtype)
    rank = jnp.sum(keep).astype(jnp.int32)
    dsafe = jnp.where(keep > 0, d_sk, 1.0)
    R_sk_safe = jnp.triu(R_sk) - jnp.diag(d_sk) + jnp.diag(dsafe)
    A_pre = jax.lax.linalg.triangular_solve(
        R_sk_safe, A, left_side=False, lower=False) * keep[None, :]
    A_pre, s, nonfin = _finite_scaled(A_pre)
    G = (jnp.matmul(A_pre.T, A_pre, precision=precision)
         + jnp.diag(1.0 - keep))
    L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
    fail = jnp.any(jnp.isnan(L)) | nonfin
    L_safe = jnp.where(jnp.isnan(L), jnp.eye(n, dtype=dtype), L)
    Q = jax.lax.linalg.triangular_solve(
        L_safe.T, A_pre, left_side=False, lower=False)
    # Second CholQR pass (CholQR2): kept columns whose sketch-R diagonal
    # sits just above the eps*max keep cutoff are preconditioned into
    # near-noise, and one pass leaves ||Q'Q-I|| ~ eps*kappa^2 (fuzz
    # seed 850001 t3: 6e-7 on a 30-decade column-scale spread). The
    # orthogonalization contract IS the orthonormal basis, so pay one
    # more Gram+trsm here (off the hot path) - orth lands at eps-level
    # whenever the first pass got kappa(Q) below ~1/sqrt(eps).
    G2 = (jnp.matmul(Q.T, Q, precision=precision)
          + jnp.diag(1.0 - keep))
    L2 = jax.lax.linalg.cholesky(0.5 * (G2 + G2.T))
    fail = fail | jnp.any(jnp.isnan(L2))
    L2_safe = jnp.where(jnp.isnan(L2), jnp.eye(n, dtype=dtype), L2)
    Q = jax.lax.linalg.triangular_solve(
        L2_safe.T, Q, left_side=False, lower=False)
    key, state = state.spawn()
    Q, fail = _orth_phase(Q, keep, key, fail, precision)
    R = jnp.matmul(L2_safe.T, L_safe.T, precision=precision) * s
    return Q, R, rank, fail, state


@partial(jax.jit, static_argnames=("cfg", "precision"))
def _cqrrt_jit(A: jax.Array, cfg: CQRRTConfig, state: RNGState,
               precision=STABLE_PRECISION):
    m, n = A.shape
    d = int(cfg.d_factor * n)
    A_sk, state = _sketch(A, d, cfg, state, precision)
    _, R_sk = qr_econ(A_sk)                       # d×n sketch QR, R n×n
    # guard exact zeros on the diagonal so triangular_solve stays finite
    # (relative floor only — see _sketch_qr)
    eps = jnp.finfo(A.dtype).eps
    mxd = jnp.max(jnp.abs(jnp.diag(R_sk)))
    dref = jnp.where(mxd > 0.0, mxd * eps, jnp.asarray(1.0, A.dtype))
    dsafe = jnp.where(jnp.abs(jnp.diag(R_sk)) > dref,
                      jnp.diag(R_sk), dref)
    R_sk = R_sk - jnp.diag(jnp.diag(R_sk)) + jnp.diag(dsafe)
    if not cfg.compute_q:
        # Q-less path (the reference's compute_Q=false, rl_cqrrt.hh:113):
        # Gram + Cholesky only — R from one pass over A, no trsm for Q.
        from ..ops.cholqr import _finite_scaled
        A_pre = jax.lax.linalg.triangular_solve(R_sk, A, left_side=False,
                                                lower=False)
        A_pre, s, nonfin = _finite_scaled(A_pre)
        G = jnp.matmul(A_pre.T, A_pre, precision=precision)
        L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
        fail = jnp.any(jnp.isnan(L)) | nonfin
        R = jnp.matmul(L.T * s, R_sk, precision=precision)
        return None, R, fail, state
    Q, R, fail = preconditioned_cholqr(A, R_sk, precision)
    return Q, R, fail, state
