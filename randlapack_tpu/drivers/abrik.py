"""ABRIK — block-Krylov truncated SVD (reference:
RandLAPACK/drivers/rl_abrik.hh: ABRIK::call :122/:146/:165; algorithm
A.1 variant of arXiv:2306.12418): alternating A·V / Aᵀ·U block Lanczos
bidiagonalization with full two-pass re-orthogonalization, band matrix of
QR coefficients, final small SVD of the band factor.

Design (SURVEY.md §7): the reference's realloc-grown bases become
preallocated (m, q·b) buffers filled through a lax.fori_loop —
re-orthogonalizing against not-yet-filled zero columns is a no-op, so the
whole factorization is one static jitted graph. Termination diagnostics
(Frobenius capture per iteration) are returned for host-side truncation
instead of breaking the loop (the reference's ‖R‖_F > √(1−ε²)‖A‖_F test,
:454/:595).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..ops.qr import qr_econ
from ..ops.svd import svd_econ


def _matmat(A, X, precision):
    if hasattr(A, "matmat"):
        return A.matmat(X, precision)
    return jnp.matmul(A, X, precision=precision)


def _tmatmat(A, X, precision):
    if hasattr(A, "tmatmat"):
        return A.tmatmat(X, precision)
    return jnp.matmul(A.T, X, precision=precision)


@dataclasses.dataclass(frozen=True)
class ABRIKConfig:
    block_size: int = 32          # Krylov block width b
    max_iters: int = 10           # q: Krylov space dimension = q·b
    reorth_passes: int = 2        # full re-orthogonalization passes
    svd_method: str = "auto"      # band-factor SVD (see ops.svd.svd_econ)
    qr_explicit: str = "geqrf"    # inner tall-QR subroutine
                                  # (rl_abrik.hh:38-40 QR_explicit):
                                  # "geqrf" = Householder qr_econ;
                                  # "cqrrt" = Gaussian-sketch
                                  # preconditioned CholQR (the
                                  # CQRRT->call route, :311-348) — one
                                  # Gram GEMM instead of a Householder
                                  # chain, with qr_econ rescue on
                                  # Cholesky breakdown
    d_factor: float = 1.25        # cqrrt sketch rows = d_factor·b
    shard_axis: str | None = None # mesh axis to row-shard the m-sided
                                  # factors over (set by dist_abrik):
                                  # A·V stays local, Aᵀ·U and the inner
                                  # Grams psum. Requires
                                  # qr_explicit="cqrrt" so the m-sided
                                  # QRs are Gram-based (Householder QR
                                  # of a sharded operand would gather)


def _qr_explicit(W, key, cfg: ABRIKConfig, precision):
    """Inner tall-QR dispatch (rl_abrik.hh:311-348): geqrf → qr_econ;
    cqrrt → Gaussian-sketch preconditioned CholQR with a qr_econ rescue
    when the Cholesky breaks (deficient/frozen blocks)."""
    if cfg.qr_explicit == "geqrf":
        return qr_econ(W)
    import math as _math
    mloc, bloc = W.shape
    dtype = W.dtype
    d = min(mloc, int(_math.ceil(cfg.d_factor * bloc)))
    S = jax.random.normal(key, (d, mloc), dtype) / jnp.sqrt(
        jnp.asarray(float(d), dtype))
    Wsk = jnp.matmul(S, W, precision=precision)
    _, R_sk = qr_econ(Wsk)
    eps = jnp.finfo(dtype).eps
    dg = jnp.diag(R_sk)
    # relative floor only (see bqrrp._safe_triu_diag)
    mxd = jnp.max(jnp.abs(dg))
    ref = jnp.where(mxd > 0.0, mxd * eps, jnp.asarray(1.0, dtype))
    R_sk = R_sk - jnp.diag(dg) + jnp.diag(jnp.where(jnp.abs(dg) > ref,
                                                    dg, ref))
    from ..ops.cholqr import preconditioned_cholqr
    Q, R, failq = preconditioned_cholqr(W, R_sk, precision)
    return jax.lax.cond(failq, lambda w, q, r: qr_econ(w),
                        lambda w, q, r: (q, r), W, Q, R)


@partial(jax.jit, static_argnames=("cfg", "precision", "tol"))
def abrik_factor(A, state: RNGState, cfg: ABRIKConfig,
                 precision=STABLE_PRECISION, tol: float = 0.0):
    """Block Golub-Kahan bidiagonalization of A (array or linop).

    Returns ``(U, V, B, capture, iters, state)``: U (m, qb), V (n, qb)
    orthonormal bases, B (qb, qb) upper block-bidiagonal with A·V ≈ U·B,
    ``capture`` (q,) the per-iteration Frobenius capture ‖B_{:jb}‖_F,
    and ``iters`` (int32 scalar) the number of Krylov iterations actually
    executed.

    The block loop is a ``lax.while_loop`` (static max-size buffers, data-
    dependent trip count): it stops early on (a) Krylov exhaustion (the
    roundoff-residual freeze below) and (b), when ``tol > 0``, the
    reference's Frobenius capture test ‖B‖_F ≥ √(1−tol²)·‖A‖_F
    (rl_abrik.hh:454,595 early termination) — easy/fast-decay spectra skip
    the dead trailing iterations instead of writing zero blocks through
    them. Outputs are IDENTICAL to the full-budget run: a stopped
    iteration would have zero-masked its writes anyway.
    """
    m = A.shape[0] if hasattr(A, "shape") else A.n_rows
    n = A.shape[1] if hasattr(A, "shape") else A.n_cols
    b, q = cfg.block_size, cfg.max_iters
    K = q * b
    key, state = state.spawn()
    dtype = (A.dtype if hasattr(A, "dtype") else jnp.float32)

    # V_1 from a Gaussian block (rl_abrik.hh:272-299)
    V1raw = jax.random.normal(key, (n, b), dtype=dtype)
    V1, _ = qr_econ(V1raw)
    Z1 = _matmat(A, V1, precision)
    if cfg.qr_explicit == "geqrf":
        qr_keys = None
        U1, R1 = qr_econ(Z1)
    else:
        kq, state = state.spawn()
        qr_keys = jax.random.split(kq, 2 * q)
        U1, R1 = _qr_explicit(Z1, qr_keys[0], cfg, precision)

    U = jnp.zeros((m, K), dtype).at[:, :b].set(U1)
    V = jnp.zeros((n, K), dtype).at[:, :b].set(V1)
    B = jnp.zeros((K, K), dtype).at[:b, :b].set(R1)
    capture = jnp.zeros((q,), dtype).at[0].set(jnp.linalg.norm(R1))
    # Krylov-exhaustion guard (the reference's tiny-diagonal /
    # capture-threshold early stops, rl_abrik.hh:454,:595,:660): once a
    # residual block reaches roundoff relative to the leading block, QR of
    # noise would inject directions NOT orthogonal to the basis and poison
    # every later triplet — freeze instead (zero blocks are harmless in
    # the final band SVD). Triggers when q·b exceeds the numerical rank.
    eps = jnp.finfo(dtype).eps
    tol_bd = 100.0 * eps * jnp.linalg.norm(R1)
    # Frobenius capture threshold (reference early termination,
    # rl_abrik.hh:454,595: stop once ‖B‖_F ≥ √(1−tol²)·‖A‖_F). Tested in
    # GAP form — ‖A‖² − ‖B‖² ≤ eff_tol²·‖A‖² — because the direct form
    # rounds to cap ≥ ‖A‖_F for any tol < √ulp(1) (f32: tol=1e-5 gives
    # √(1−1e-10) = 1.0 exactly, so an f32 run never certifiably crossed it
    # and easy spectra ran all max_iters). The gap itself is only
    # resolvable down to a few ulps of ‖A‖², so eff_tol² gets an eps
    # floor: requesting tol < √(32·eps) means "stop when the capture is
    # roundoff-complete for this dtype". tol=0 disables (thresh = −inf;
    # the gap can round slightly negative, so −inf, not 0).
    if tol and tol > 0.0:
        if hasattr(A, "fro_nrm"):
            norm_A = A.fro_nrm()
        else:
            norm_A = jnp.linalg.norm(A)
        norm_A2 = norm_A * norm_A
        eff_tol2 = jnp.maximum(jnp.asarray(tol, dtype) ** 2, 32.0 * eps)
        gap_thresh = eff_tol2 * norm_A2
    else:
        norm_A2 = jnp.asarray(0.0, dtype)
        gap_thresh = jnp.asarray(-jnp.inf, dtype)

    def reorth(W, Basis):
        for _ in range(cfg.reorth_passes):
            W = W - jnp.matmul(Basis,
                               jnp.matmul(Basis.T, W, precision=precision),
                               precision=precision)
        return W

    def _row_sh(X):
        if cfg.shard_axis is None:
            return X
        from jax.sharding import PartitionSpec as _P
        return jax.lax.with_sharding_constraint(X, _P(cfg.shard_axis,
                                                      None))

    def cond(carry):
        U, V, B, capture, stopped, j = carry
        return (j < q) & ~stopped

    def body(carry):
        U, V, B, capture, stopped, j = carry
        U = _row_sh(U)
        c = j * b
        # current blocks U_j, V_j live at columns [(j-1)b, jb)
        Uj = jax.lax.dynamic_slice(U, (0, (j - 1) * b), (m, b))
        Vj = jax.lax.dynamic_slice(V, (0, (j - 1) * b), (n, b))
        Rj = jax.lax.dynamic_slice(B, ((j - 1) * b, (j - 1) * b), (b, b))

        # odd half-step: W = AᵀU_j − V_j R_jᵀ, reorth, QR → V_{j+1}, L
        W = _tmatmat(A, Uj, precision) - jnp.matmul(Vj, Rj.T,
                                                    precision=precision)
        W = reorth(W, V)
        stopped = stopped | (jnp.linalg.norm(W) < tol_bd)
        if qr_keys is None:
            Vn, L = qr_econ(W)
        else:
            Vn, L = _qr_explicit(
                W, jax.lax.dynamic_index_in_dim(qr_keys, 2 * j, 0,
                                                keepdims=False),
                cfg, precision)

        # even half-step: Z = A V_{j+1} − U_j Lᵀ, reorth, QR → U_{j+1}, R
        Z = _row_sh(_matmat(A, Vn, precision)
                    - jnp.matmul(Uj, L.T, precision=precision))
        Z = reorth(Z, U)
        stopped = stopped | (jnp.linalg.norm(Z) < tol_bd)
        if qr_keys is None:
            Un, Rn = qr_econ(Z)
        else:
            Un, Rn = _qr_explicit(
                Z, jax.lax.dynamic_index_in_dim(qr_keys, 2 * j + 1, 0,
                                                keepdims=False),
                cfg, precision)

        keep = jnp.where(stopped, 0.0, 1.0).astype(dtype)
        U = jax.lax.dynamic_update_slice(U, Un * keep, (0, c))
        V = jax.lax.dynamic_update_slice(V, Vn * keep, (0, c))
        # B[j-1, j] block = Lᵀ ; B[j, j] = R
        B = jax.lax.dynamic_update_slice(B, L.T * keep, ((j - 1) * b, c))
        B = jax.lax.dynamic_update_slice(B, Rn * keep, (c, c))
        cap_j = jnp.linalg.norm(B)
        capture = capture.at[j].set(cap_j)
        # Frobenius capture early stop (no-op when tol=0: thresh = -inf)
        stopped = stopped | (norm_A2 - cap_j * cap_j <= gap_thresh)
        return U, V, B, capture, stopped, j + 1

    # platform default int (int64 under x64, int32 without) so the
    # dynamic_slice index arithmetic stays one type
    U, V, B, capture, _, j_end = jax.lax.while_loop(
        cond, body,
        (U, V, B, capture, jnp.asarray(False), jnp.asarray(1)))
    return U, V, B, capture, j_end.astype(jnp.int32), state


def _abrik_factor_timed(A, state, cfg, precision, timer):
    """Iteration-split Golub-Kahan run accumulating the reference's
    per-phase slots (rl_abrik.hh:734: allocation / sketching / gemm_A /
    reorth / qr / r_cpy / s_cpy / norm / main_loop / get_factors /
    total). Sub-phases are separately jitted + synced — measurement mode
    only (the production path is the single fused abrik_factor graph)."""
    from ..utils.timing import device_sync
    m = A.shape[0] if hasattr(A, "shape") else A.n_rows
    n = A.shape[1] if hasattr(A, "shape") else A.n_cols
    b, q = cfg.block_size, cfg.max_iters
    K = q * b
    dtype = (A.dtype if hasattr(A, "dtype") else jnp.float32)

    with timer.phase("allocation"):
        key, state = state.spawn()
        U = jnp.zeros((m, K), dtype)
        V = jnp.zeros((n, K), dtype)
        B = jnp.zeros((K, K), dtype)
        capture = jnp.zeros((q,), dtype)
        device_sync(B)
    with timer.phase("sketching"):
        V1raw = jax.random.normal(key, (n, b), dtype=dtype)
        V1, _ = qr_econ(V1raw)
        device_sync(V1)
    with timer.phase("gemm_A"):
        Z1 = _matmat(A, V1, precision)
        device_sync(Z1)
    if cfg.qr_explicit == "geqrf":
        qr_keys = [None] * (2 * q)
    else:
        kq, state = state.spawn()
        qr_keys = list(jax.random.split(kq, 2 * q))

    def _qr(X, key):
        return (qr_econ(X) if key is None
                else _qr_explicit(X, key, cfg, precision))

    with timer.phase("qr"):
        U1, R1 = _qr(Z1, qr_keys[0])
        device_sync(U1)
    with timer.phase("r_cpy"):
        U = U.at[:, :b].set(U1)
        V = V.at[:, :b].set(V1)
        B = B.at[:b, :b].set(R1)
        device_sync(B)
    with timer.phase("norm"):
        capture = capture.at[0].set(jnp.linalg.norm(R1))
        device_sync(capture)

    def reorth(W, Basis):
        for _ in range(cfg.reorth_passes):
            W = W - jnp.matmul(Basis,
                               jnp.matmul(Basis.T, W, precision=precision),
                               precision=precision)
        return W

    eps = jnp.finfo(dtype).eps
    tol_bd = 100.0 * eps * jnp.linalg.norm(B[:b, :b])
    stopped = jnp.asarray(False)
    t_loop0 = __import__("time").perf_counter()
    for j in range(1, q):
        c = j * b
        Uj = U[:, (j - 1) * b:j * b]
        Vj = V[:, (j - 1) * b:j * b]
        Rj = B[(j - 1) * b:j * b, (j - 1) * b:j * b]
        with timer.phase("gemm_A"):
            W = _tmatmat(A, Uj, precision) - jnp.matmul(
                Vj, Rj.T, precision=precision)
            device_sync(W)
        with timer.phase("reorth"):
            W = reorth(W, V)
            device_sync(W)
        with timer.phase("qr"):
            stopped = stopped | (jnp.linalg.norm(W) < tol_bd)
            Vn, L = _qr(W, qr_keys[2 * j])
            device_sync(Vn)
        with timer.phase("gemm_A"):
            Z = _matmat(A, Vn, precision) - jnp.matmul(
                Uj, L.T, precision=precision)
            device_sync(Z)
        with timer.phase("reorth"):
            Z = reorth(Z, U)
            device_sync(Z)
        with timer.phase("qr"):
            stopped = stopped | (jnp.linalg.norm(Z) < tol_bd)
            Un, Rn = _qr(Z, qr_keys[2 * j + 1])
            device_sync(Un)
        with timer.phase("s_cpy"):
            keep = jnp.where(stopped, 0.0, 1.0).astype(dtype)
            U = U.at[:, c:c + b].set(Un * keep)
            V = V.at[:, c:c + b].set(Vn * keep)
            B = B.at[(j - 1) * b:j * b, c:c + b].set(L.T * keep)
            B = B.at[c:c + b, c:c + b].set(Rn * keep)
            device_sync(B)
        with timer.phase("norm"):
            capture = capture.at[j].set(jnp.linalg.norm(B))
            device_sync(capture)
    timer.times["main_loop"] = (__import__("time").perf_counter()
                                - t_loop0)
    return U, V, B, capture, state


def abrik(A, k: int, cfg: ABRIKConfig, state: RNGState, tol: float = 0.0,
          precision=STABLE_PRECISION, timing: bool = False):
    """Truncated SVD via block-Krylov bidiagonalization.

    Returns ``(U, S, Vt, info, next_state)`` with the leading k singular
    triplets; ``info`` holds ``num_krylov_iters`` (the count actually
    executed — with ``tol > 0`` the Krylov loop early-stops on the
    reference's Frobenius capture test ‖B‖_F ≥ √(1−tol²)·‖A‖_F,
    rl_abrik.hh:454,595, so easy spectra use fewer than ``cfg.max_iters``)
    and the capture history (the reference's ``num_krylov_iters``/
    ``singular_triplets_found`` diagnostics, rl_abrik.hh fields).

    ``timing=True`` appends the 13-slot phase dict (rl_abrik.hh:734) —
    iteration-split synced execution, measurement mode only.
    """
    b, q = cfg.block_size, cfg.max_iters
    assert k <= q * b, f"need max_iters*block_size >= k ({q*b} < {k})"
    timer = None
    if timing:
        from ..utils.timing import PhaseTimer, device_sync
        timer = PhaseTimer()
        import time as _time
        t0 = _time.perf_counter()
        Ub, Vb, B, capture, state = _abrik_factor_timed(
            A, state, cfg, precision, timer)
        with timer.phase("get_factors"):
            Us, S, Vst = svd_econ(B, cfg.svd_method, precision)
            U = jnp.matmul(Ub, Us[:, :k], precision=precision)
            V = jnp.matmul(Vb, Vst.T[:, :k], precision=precision)
            device_sync(U)
        timer.times["total"] = _time.perf_counter() - t0
        info = {"num_krylov_iters": q, "capture": capture}
        return U, S[:k], V.T, info, state, timer.report()
    Ub, Vb, B, capture, iters, state = abrik_factor(
        A, state, cfg, precision, tol=float(tol))
    # small dense SVD of the band factor (rl_abrik.hh:690-701)
    Us, S, Vst = svd_econ(B, cfg.svd_method, precision)
    U = jnp.matmul(Ub, Us[:, :k], precision=precision)
    V = jnp.matmul(Vb, Vst.T[:, :k], precision=precision)
    info = {"num_krylov_iters": iters, "capture": capture}
    return U, S[:k], V.T, info, state
