"""Q-less CholQR family over abstract linear operators (reference:
RandLAPACK/drivers/rl_cholqr_linops.hh :124, rl_cqrrt_linops.hh,
rl_scholqr3_linops.hh :132/:444).

The reference computes the Gram matrix through operator calls, optionally
column-blocked to cap peak memory at O(m·b) (rl_cholqr_linops.hh:56-76,
loop :217-231), then factors without ever materializing Q. Additional
stabilization passes recompute the Gram of the implicitly preconditioned
operator A·R⁻¹ with FRESH operator applies — a pure Gram-space cleanup
(R⁻ᵀGR⁻¹ in floating point) cannot reduce the eps·κ² error, which is why
the reference also re-applies the operator per pass
(rl_scholqr3_linops.hh accumulated right factor M = R1⁻¹R2⁻¹…).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState


def _finite_gram(G):
    """Detection half of the Inf-kernel guard for operator-based Grams:
    the operand is a linop (no cheap global rescale), so a non-finite
    accumulated Gram is zeroed into the fail flag instead of reaching
    the Cholesky (see ops/cholqr.py::_finite_scaled)."""
    finite = jnp.isfinite(G)
    return jnp.where(finite, G, 0.0), ~jnp.all(finite)


def blocked_gram(A, block: int | None = None, precision=STABLE_PRECISION):
    """G = AᵀA with peak memory O(m·block) (None → one-shot)."""
    n = A.n_cols
    if block is None or block >= n:
        cols = A.cols(0, n, precision) if hasattr(A, "cols") else None
        if cols is not None:
            return jnp.matmul(cols.T, cols, precision=precision)
        from ..linops.base import materialize
        M = materialize(A)
        return jnp.matmul(M.T, M, precision=precision)
    b = block
    nb, rem = divmod(n, b)
    G = jnp.zeros((n, n), A.dtype)

    def outer(j, G):
        Aj = A.cols(j * b, b, precision)

        def inner(i, G):
            Ai = A.cols(i * b, b, precision)
            Gij = jnp.matmul(Ai.T, Aj, precision=precision)
            G2 = jax.lax.dynamic_update_slice(G, Gij, (i * b, j * b))
            return jax.lax.dynamic_update_slice(G2, Gij.T, (j * b, i * b))

        G = jax.lax.fori_loop(0, j, inner, G)
        Gjj = jnp.matmul(Aj.T, Aj, precision=precision)
        return jax.lax.dynamic_update_slice(G, Gjj, (j * b, j * b))

    G = jax.lax.fori_loop(0, nb, outer, G)
    if rem:
        # remainder column block (static shape r != b -> outside the loop)
        Ar = A.cols(nb * b, rem, precision)
        for i in range(nb):
            Ai = A.cols(i * b, b, precision)
            Gir = jnp.matmul(Ai.T, Ar, precision=precision)
            G = jax.lax.dynamic_update_slice(G, Gir, (i * b, nb * b))
            G = jax.lax.dynamic_update_slice(G, Gir.T, (nb * b, i * b))
        Grr = jnp.matmul(Ar.T, Ar, precision=precision)
        G = jax.lax.dynamic_update_slice(G, Grr, (nb * b, nb * b))
    return G


def blocked_gram_precond(A, R_chain, block: int | None = None,
                         precision=STABLE_PRECISION):
    """Gram of the implicitly preconditioned operator A·R₁⁻¹·R₂⁻¹·…, with
    fresh operator applies per column block (peak memory O(m·block)).

    ``R_chain`` is the tuple of per-pass triangular factors, applied as a
    CHAIN of solves (innermost last factor first) — solving with the
    accumulated product would reintroduce the full κ(A) conditioning and
    cap accuracy at eps·κ; each chain factor is individually
    well-conditioned (the reference's accumulated right factor M =
    R1⁻¹R2⁻¹…, rl_scholqr3_linops.hh:36-42, is the same structure)."""
    n = A.n_cols
    eye = jnp.eye(n, dtype=A.dtype)
    if not isinstance(R_chain, (tuple, list)):
        R_chain = (R_chain,)

    def pre_cols(start, size):
        X = jax.lax.dynamic_slice(eye, (0, start), (n, size))
        for Rk in reversed(R_chain):
            X = jax.lax.linalg.triangular_solve(Rk, X, left_side=True,
                                                lower=False)
        return A.matmat(X, precision)

    if block is None or block >= n:
        Y = pre_cols(0, n)
        return jnp.matmul(Y.T, Y, precision=precision)
    b = block
    nb, rem = divmod(n, b)
    G = jnp.zeros((n, n), A.dtype)

    def outer(j, G):
        Yj = pre_cols(j * b, b)

        def inner(i, G):
            Yi = pre_cols(i * b, b)
            Gij = jnp.matmul(Yi.T, Yj, precision=precision)
            G2 = jax.lax.dynamic_update_slice(G, Gij, (i * b, j * b))
            return jax.lax.dynamic_update_slice(G2, Gij.T, (j * b, i * b))

        G = jax.lax.fori_loop(0, j, inner, G)
        Gjj = jnp.matmul(Yj.T, Yj, precision=precision)
        return jax.lax.dynamic_update_slice(G, Gjj, (j * b, j * b))

    G = jax.lax.fori_loop(0, nb, outer, G)
    if rem:
        Yr = pre_cols(nb * b, rem)
        for i in range(nb):
            Yi = pre_cols(i * b, b)
            Gir = jnp.matmul(Yi.T, Yr, precision=precision)
            G = jax.lax.dynamic_update_slice(G, Gir, (i * b, nb * b))
            G = jax.lax.dynamic_update_slice(G, Gir.T, (nb * b, i * b))
        Grr = jnp.matmul(Yr.T, Yr, precision=precision)
        G = jax.lax.dynamic_update_slice(G, Grr, (nb * b, nb * b))
    return G


@dataclasses.dataclass(frozen=True)
class CholQRLinopsConfig:
    gram_block: int | None = None  # column-block size (None = one shot)
    passes: int = 1                # CholQR passes on the Gram matrix


def cholqr_linops(A, cfg: CholQRLinopsConfig = CholQRLinopsConfig(),
                  precision=STABLE_PRECISION, timing: bool = False):
    """Q-less CholQR of a LinearOperator — see ``_cholqr_linops_impl``
    for the algorithm; ``timing=True`` runs phase-synced (the 6-slot
    vector of rl_cholqr_linops.hh) and appends the phase dict."""
    if not timing:
        return _cholqr_linops_jit(A, cfg, precision)
    return _cholqr_linops_impl(A, cfg, precision, True)


@partial(jax.jit, static_argnames=("cfg", "precision"))
def _cholqr_linops_jit(A, cfg, precision):
    return _cholqr_linops_impl(A, cfg, precision, False)


def _cholqr_linops_impl(A, cfg, precision, timing):
    """Q-less CholQR of a LinearOperator. Returns ``(R, fail)`` with
    AᵀA = RᵀR; Q = A·R⁻¹ is implicit (use ``apply_qt``/materialize in
    test mode, mirroring rl_cholqr_linops.hh:259-286).

    ``timing=True`` appends the per-pass phase dict (the reference's
    6-slot timing vector, rl_cholqr_linops.hh) — gram_i / potrf_i per
    pass, with device syncs between phases."""
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()

    with _phase("gram_0"):
        G = blocked_gram(A, cfg.gram_block, precision)
        G, nf0 = _finite_gram(G)
        if timing:
            device_sync(G)
    with _phase("potrf_0"):
        L = jax.lax.linalg.cholesky(G)
        if timing:
            device_sync(L)
    fail = jnp.any(jnp.isnan(L)) | nf0
    chain = (L.T,)
    R = L.T
    for p_ in range(cfg.passes - 1):
        # extra pass: fresh Gram of the chain-preconditioned operator
        with _phase(f"gram_{p_ + 1}"):
            G2 = blocked_gram_precond(A, chain, cfg.gram_block, precision)
            G2, nf2 = _finite_gram(G2)
            if timing:
                device_sync(G2)
        with _phase(f"potrf_{p_ + 1}"):
            L2 = jax.lax.linalg.cholesky(0.5 * (G2 + G2.T))
            if timing:
                device_sync(L2)
        fail = fail | jnp.any(jnp.isnan(L2)) | nf2
        chain = chain + (L2.T,)
        R = jnp.matmul(L2.T, R, precision=precision)
    if timing:
        return R, fail, chain, timer.report()
    return R, fail, chain


@partial(jax.jit, static_argnames=("cfg", "precision"))
def scholqr3_linops(A, cfg: CholQRLinopsConfig = CholQRLinopsConfig(),
                    precision=STABLE_PRECISION):
    """Shifted CholQR3 through operator calls only (rl_scholqr3_linops.hh):
    one pass over A, shift s = 11·eps·n·‖A‖_F², two cleanup passes in Gram
    space. Returns ``(R, fail)``."""
    n = A.n_cols
    G = blocked_gram(A, cfg.gram_block, precision)
    G, nfg = _finite_gram(G)
    eps = jnp.finfo(G.dtype).eps
    s = 11.0 * eps * n * jnp.trace(G)     # trace(G) = ‖A‖_F²
    L1 = jax.lax.linalg.cholesky(G + s * jnp.eye(n, dtype=G.dtype))
    fail = jnp.any(jnp.isnan(L1)) | nfg
    chain = (L1.T,)
    R = L1.T
    for _ in range(2):
        # fresh Gram of the chain-preconditioned operator per cleanup pass.
        # Every pass is shifted: at large m the Gram's accumulation error
        # (~√m·eps) can exceed the preconditioned min-eigenvalue and turn
        # G2 numerically indefinite (observed at m=65536 in f32) —
        # the trace-relative shift keeps Cholesky alive at the cost of a
        # per-pass O(eps·n) orthogonality floor.
        G2 = blocked_gram_precond(A, chain, cfg.gram_block, precision)
        G2, nfg2 = _finite_gram(G2)
        fail = fail | nfg2
        G2 = 0.5 * (G2 + G2.T)
        # try unshifted first (no orthogonality pollution); if the
        # preconditioned Gram is numerically indefinite (κ(A)²·eps ≳ 1 —
        # beyond this method's precision regime) rescue with a shift and
        # raise the breakdown flag.
        L2u = jax.lax.linalg.cholesky(G2)
        bad = jnp.any(jnp.isnan(L2u))
        s2 = 11.0 * eps * jnp.trace(G2)
        L2s = jax.lax.linalg.cholesky(G2 + s2 * jnp.eye(n, dtype=G2.dtype))
        L2 = jnp.where(bad, L2s, L2u)
        fail = fail | bad
        chain = chain + (L2.T,)
        R = jnp.matmul(L2.T, R, precision=precision)
    return R, fail, chain


@dataclasses.dataclass(frozen=True)
class CQRRTLinopsConfig:
    d_factor: float = 1.25
    gram_block: int | None = None


def cqrrt_linops(A, cfg: CQRRTLinopsConfig, state: RNGState,
                 precision=STABLE_PRECISION, timing: bool = False):
    """Q-less CQRRT over an operator — see ``_cqrrt_linops_impl``;
    ``timing=True`` appends the phase dict (11-slot vector analogue,
    rl_cqrrt_linops.hh:45-49)."""
    if not timing:
        return _cqrrt_linops_jit(A, cfg, state, precision)
    return _cqrrt_linops_impl(A, cfg, state, precision, True)


@partial(jax.jit, static_argnames=("cfg", "precision"))
def _cqrrt_linops_jit(A, cfg, state, precision):
    return _cqrrt_linops_impl(A, cfg, state, precision, False)


def _cqrrt_linops_impl(A, cfg, state, precision, timing):
    """Q-less CQRRT over an operator (rl_cqrrt_linops.hh): dense-sketch the
    operator through tmatmat, QR the sketch → R_sk, then a single Gram pass
    preconditioned in Gram space. Returns ``(R, fail, next_state)``
    (+ the phase dict mirroring the reference's 11-slot timing vector,
    rl_cqrrt_linops.hh:45-49, when ``timing=True``)."""
    import math
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()

    m, n = A.n_rows, A.n_cols
    d = int(cfg.d_factor * n)
    key, state = state.spawn()
    with _phase("sketch"):
        S_t = jax.random.normal(key, (m, d), dtype=A.dtype) / math.sqrt(d)
        A_sk = A.tmatmat(S_t, precision).T          # (d, n) = S·A
        if timing:
            device_sync(A_sk)
    with _phase("qr"):
        _, R_sk = jax.lax.linalg.qr(A_sk, full_matrices=False)
        eps = jnp.finfo(A_sk.dtype).eps
        dg = jnp.diag(R_sk)
        # relative floor only (see bqrrp._safe_triu_diag)
        mxd = jnp.max(jnp.abs(dg))
        ref = jnp.where(mxd > 0.0, mxd * eps,
                        jnp.asarray(1.0, A_sk.dtype))
        R_sk = R_sk - jnp.diag(dg) + jnp.diag(
            jnp.where(jnp.abs(dg) > ref, dg, ref))
        if timing:
            device_sync(R_sk)
    # Gram of the preconditioned operator with FRESH applies (a Gram-space
    # solve R⁻ᵀGR⁻¹ would cap accuracy at eps·κ(A))
    with _phase("gram"):
        Gp = blocked_gram_precond(A, (R_sk,), cfg.gram_block, precision)
        if timing:
            device_sync(Gp)
    with _phase("potrf"):
        L = jax.lax.linalg.cholesky(0.5 * (Gp + Gp.T))
        if timing:
            device_sync(L)
    fail = jnp.any(jnp.isnan(L))
    chain = (R_sk, L.T)
    with _phase("recombine"):
        R = jnp.matmul(L.T, R_sk, precision=precision)
        if timing:
            device_sync(R)
    if timing:
        return R, fail, chain, state, timer.report()
    return R, fail, chain, state


@partial(jax.jit, static_argnames=("precision",))
def scholqr3_linops_basic(A, precision=STABLE_PRECISION):
    """Shifted CholQR3 that materializes the working factor after the first
    (shifted) pass — the reference's ``sCholQR3_linops_basic``
    (rl_scholqr3_linops.hh:444). O(m·n) memory but eps-grade orthogonality
    at any cond(A): the Q-less blocked variant is limited to ~eps·κ(R₁)
    because re-deriving A·R₁⁻¹R₂⁻¹ from A re-amplifies rounding error.

    Returns ``(Q, R, fail)`` with Q explicit.
    """
    from ..linops.base import materialize
    from ..ops.cholqr import shifted_cholqr3
    M = materialize(A)
    return shifted_cholqr3(M, precision)


def materialize_q(A, R_or_chain, precision=STABLE_PRECISION):
    """Test-mode Q = A·R₁⁻¹·R₂⁻¹·… (rl_cholqr_linops.hh:259-286).

    Pass the per-pass factor CHAIN (returned by the drivers) rather than
    the accumulated R: a single solve against the accumulated product has
    κ(A) conditioning and caps the materialized Q's orthogonality at
    eps·κ even when the implicit factorization is eps-accurate."""
    from ..linops.base import materialize
    M = materialize(A)
    chain = (R_or_chain if isinstance(R_or_chain, (tuple, list))
             else (R_or_chain,))
    for Rk in chain:
        M = jax.lax.linalg.triangular_solve(Rk, M, left_side=False,
                                            lower=False)
    return M
