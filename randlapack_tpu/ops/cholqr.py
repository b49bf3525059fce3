"""CholeskyQR family — the orthogonalization workhorse.

The reference uses CholQR (syrk→potrf→trsm) as its fastest stabilizer
(reference: RandLAPACK/comps/rl_orth.hh:69-98) and shifted CholQR3 for
operators (rl_scholqr3_linops.hh:45,132). On an accelerator this family
is ideal: the Gram matrix is one big matmul, Cholesky and triangular solves are
native XLA ops, and no column-sequential Householder pass is needed.

All functions are jit-traceable and return an explicit failure flag instead
of throwing (potrf failure → NaNs in XLA's cholesky; we detect and report,
mirroring the reference's ``chol_fail`` handling, rl_orth.hh:81-84).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


def _gram(A, precision):
    return jnp.matmul(A.T, A, precision=precision)


def gram_syrk(A, precision, block: int = 512):
    """Symmetric Gram AᵀA computing only the upper-triangular column
    blocks — the SYRK flop saving the reference gets from BLAS
    (rl_orth.hh:74 uses ``syrk``; XLA has no syrk primitive, so a full
    ``AᵀA`` GEMM pays 2·m·n² where syrk pays half).

    Block i contributes G[i·b:(i+1)·b, i·b:] = A_iᵀ·A[:, i·b:] — one
    shrinking-width GEMM per block, Σ flops = m·n·b·(nb+1)/2 vs m·n²
    full (5/8 at nb = 4). The mirror is assembled with static masks, so
    the output is EXACTLY symmetric (the full GEMM's G is only
    symmetric to rounding). Falls back to the full GEMM when n doesn't
    block evenly or has < 2 blocks (no saving to get).
    """
    m, n = A.shape
    nb = n // block
    if n % block or nb < 2:
        return _gram(A, precision)
    rows = []
    for i in range(nb):
        Gi = jnp.matmul(A[:, i * block:(i + 1) * block].T,
                        A[:, i * block:], precision=precision)
        rows.append(jnp.pad(Gi, ((0, 0), (i * block, 0))))
    W = jnp.concatenate(rows, axis=0)
    # W holds the block-upper triangle (diagonal blocks fully computed,
    # symmetric up to rounding); mirror the strictly-above-diagonal
    # BLOCKS and symmetrize the diagonal blocks explicitly
    bidx = jnp.arange(n) // block
    above = (bidx[None, :] > bidx[:, None])
    on_diag = (bidx[None, :] == bidx[:, None])
    W_up = jnp.where(above, W, 0.0)
    D = jnp.where(on_diag, W, 0.0)
    return W_up + W_up.T + 0.5 * (D + D.T)


def _solve_rt(A, R, precision=None):
    """A @ R^{-1} for upper-triangular R via triangular_solve."""
    return jax.lax.linalg.triangular_solve(
        R, A, left_side=False, lower=False, transpose_a=False)


def _pow2(k, dtype):
    """EXACT 2^k by exponent-bit construction. Neither jnp.exp2 nor
    jnp.ldexp is safe here: exp2 is an approximate transcendental, and
    ldexp can lower through ``2 ** e`` = lax.pow → exp(e·log2) —
    both can return a value 1 ulp off a true power of two, which breaks
    the bitwise scale-equivariance this guard promises."""
    k = jnp.asarray(k, jnp.int32)
    if dtype == jnp.float64:
        bits = ((jnp.clip(k, -1022, 1023) + 1023).astype(jnp.uint64)
                << jnp.uint64(52))
        return jax.lax.bitcast_convert_type(bits, jnp.float64)
    if dtype == jnp.float32:
        bits = ((jnp.clip(k, -126, 127) + 127).astype(jnp.uint32)
                << jnp.uint32(23))
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return jnp.ldexp(jnp.asarray(1.0, dtype), k)   # other dtypes


def _finite_scaled(A):
    """Sanitize + scale-guard an orthogonalization input: non-finite
    entries → 0 (reported), and a GLOBAL rescale so the Gram matrix
    cannot overflow (max|A|² · m must stay below dtype max — preconditioned
    panels can carry huge-but-finite entries when the preconditioner's
    clamped diagonal hides a deficient column, and an Inf reaching a
    dense-linalg kernel poisons its output; see
    drivers/bqrrp.py::_sanitize_sketch). Healthy inputs pass through
    bitwise (scale == 1.0). Returns ``(A_scaled, scale, nonfinite)``."""
    m, n = A.shape
    finite = jnp.isfinite(A)
    nonfin = ~jnp.all(finite)
    A = jnp.where(finite, A, 0.0)
    fi = jnp.finfo(A.dtype)
    # safe band: above `big`, trace(AᵀA) = ‖A‖_F² (the shifted variant's
    # shift) overflows; below `small`, the Gram underflows toward the
    # denormal floor and Cholesky loses the column geometry (observed:
    # f32 inputs at 1e-18 flip pivot decisions). Outside the band,
    # normalize to max|A| = 1 — Q is invariant, R carries the scale.
    big = jnp.sqrt(fi.max / (8.0 * m * n))
    small = jnp.asarray(fi.eps, A.dtype) ** 2
    mx = jnp.max(jnp.abs(A))
    in_band = ((mx <= big) & (mx >= small)) | (mx == 0.0)
    # power-of-2 normalization: an exponent-only shift commutes bitwise
    # with every f32 op (no mantissa rounding), so out-of-band inputs
    # factor to EXACTLY the in-band run's Q and pivots
    k = jnp.round(jnp.log2(jnp.where(mx > 0, mx, 1.0))).astype(jnp.int32)
    s = jnp.where(in_band, jnp.asarray(1.0, A.dtype), _pow2(k, A.dtype))
    return A / s, s, nonfin


def cholqr(A: jax.Array, precision=STABLE_PRECISION):
    """One-pass CholeskyQR. Returns ``(Q, R, fail)``.

    fail is a bool scalar: True iff the Cholesky broke down (Gram matrix
    numerically indefinite) or the input carried non-finite entries — the
    caller decides the fallback, like the reference's CholQRQ
    ``chol_fail`` flag.
    """
    A, s, nonfin = _finite_scaled(A)
    G = _gram(A, precision)
    L = jax.lax.linalg.cholesky(G)  # lower; NaN on failure
    fail = jnp.any(jnp.isnan(L)) | jnp.any(jnp.diag(L) <= 0) | nonfin
    R = L.T * s          # Q is scale-invariant; R carries the scale back
    Q = _solve_rt(A, L.T)
    return Q, R, fail


def cholqr2(A: jax.Array, precision=STABLE_PRECISION):
    """CholeskyQR2 — two passes; orthogonality ~ machine eps when
    cond(A) ≲ 1/sqrt(eps). Returns ``(Q, R, fail)``."""
    Q1, R1, f1 = cholqr(A, precision)
    Q, R2, f2 = cholqr(Q1, precision)
    R = jnp.matmul(R2, R1, precision=precision)
    return Q, R, f1 | f2


def shifted_cholqr3(A: jax.Array, precision=STABLE_PRECISION):
    """Shifted CholeskyQR3 (Fukaya et al.) — unconditionally stable for
    cond(A) up to ~1/eps. Mirrors rl_scholqr3_linops.hh:45: the first pass
    shifts the Gram matrix by s = 11·eps·n·‖A‖_F² to force positive
    definiteness, then two plain CholQR passes clean up.

    Returns ``(Q, R, fail)``.
    """
    m, n = A.shape
    eps = jnp.finfo(A.dtype).eps
    A, sc, nonfin = _finite_scaled(A)   # rescue-path entry: guard first
    G = _gram(A, precision)
    s = 11.0 * eps * n * jnp.trace(G)  # trace(AᵀA) = ‖A‖_F²
    L1 = jax.lax.linalg.cholesky(G + s * jnp.eye(n, dtype=A.dtype))
    f1 = jnp.any(jnp.isnan(L1)) | nonfin
    Q1 = _solve_rt(A, L1.T)
    Q2, R2, f2 = cholqr(Q1, precision)
    Q, R3, f3 = cholqr(Q2, precision)
    R = jnp.matmul(R3, jnp.matmul(R2, L1.T, precision=precision),
                   precision=precision) * sc
    return Q, R, f1 | f2 | f3


def _clamp_triu_diag(R):
    """Relative floor on a triangular factor's diagonal so the solve in
    preconditioned_cholqr stays finite on deficient inputs (mirrors
    drivers/bqrrp.py::_safe_triu_diag; local copy — ops must not import
    drivers)."""
    dtype = R.dtype
    d = jnp.diag(R)
    mx = jnp.max(jnp.abs(d))
    ref = jnp.where(mx > 0.0, mx * jnp.finfo(dtype).eps,
                    jnp.asarray(1.0, dtype))
    dsafe = jnp.where(jnp.abs(d) > ref, d, ref)
    return jnp.triu(R) - jnp.diag(d) + jnp.diag(dsafe)


def cholqr_auto(A: jax.Array, precision=STABLE_PRECISION):
    """Condition-aware self-routing CholQR (the reference's self-correcting
    a-posteriori logic, rl_cqrrpt.hh:311-332, recast as a jit-safe rescue
    ladder). The first Gram Cholesky gives a FREE condition estimate —
    diag(R) ratios track the singular-value range — which picks the rung:

      κ_est ≲ 0.1/√eps, finite   → CholeskyQR2 (the fast 2-GEMM path)
      else                        → shifted CholQR3 (GEMM-form, measured
                                    good to κ ≈ 3e5 f32, fails LOUDLY above)
      scholqr3 fail / κ_est ≳ 0.03/eps → Householder-R preconditioned
                                    CholQR (backward-stable R makes the
                                    perfect preconditioner; measured
                                    eps-level orthogonality to κ = 3e7 f32)

    Every rescue rung is ``lax.cond``-lazy: well-conditioned inputs pay
    CholeskyQR2 plus one diagonal reduction. Returns ``(Q, R, fail)``
    where ``fail`` now means genuinely rank-deficient input (even the
    backward-stable rung broke down) — the κ=1e4-class f32 cases that
    plain cholqr/cholqr2 fail-flag come back at reference tolerance.
    """
    dtype = A.dtype
    eps = jnp.finfo(dtype).eps
    tiny = jnp.finfo(dtype).tiny
    Q1, R1, f1 = cholqr(A, precision)
    d1 = jnp.abs(jnp.diag(R1))
    kappa = jnp.max(d1) / jnp.maximum(jnp.min(d1), tiny)
    tau_fast = 0.1 / jnp.sqrt(eps)      # CholQR2 validity ceiling
    tau_shift = 0.03 / eps              # shifted-CholQR3 ceiling (safety
                                        # margin under the measured 3e5)
    need_rescue = f1 | ~jnp.isfinite(kappa) | (kappa > tau_fast)

    def _hqr_rung(_):
        R_h = _clamp_triu_diag(jnp.linalg.qr(A, mode="r")[:A.shape[1], :])
        Q, R, f = preconditioned_cholqr(A, R_h, precision)
        return Q, R, f | jnp.any(~jnp.isfinite(Q))

    def _shift_rung(_):
        Qs, Rs, fs = shifted_cholqr3(A, precision)
        ds = jnp.abs(jnp.diag(Rs))
        ks = jnp.max(ds) / jnp.maximum(jnp.min(ds), tiny)
        bad = fs | ~jnp.isfinite(ks) | (ks > tau_shift)
        return jax.lax.cond(bad, _hqr_rung, lambda _: (Qs, Rs, fs), None)

    def _fast_rung(_):
        Q, R2, f2 = cholqr(Q1, precision)
        return Q, jnp.matmul(R2, R1, precision=precision), f2

    return jax.lax.cond(need_rescue, _shift_rung, _fast_rung, None)


def preconditioned_cholqr(A: jax.Array, R_pre: jax.Array,
                          precision=STABLE_PRECISION):
    """CholQR of A·R_pre⁻¹ — the sketch-precondition pattern of CQRRT/CQRRPT
    (rl_cqrrt.hh, rl_cqrrpt.hh:287-332): a well-conditioned preconditioned
    matrix makes a single CholQR pass safe.

    Returns ``(Q, R, fail)`` with R = R_chol · R_pre (the factor of A).
    """
    A_pre = _solve_rt(A, R_pre)
    Q, R_chol, fail = cholqr(A_pre, precision)
    R = jnp.matmul(R_chol, R_pre, precision=precision)
    return Q, R, fail
