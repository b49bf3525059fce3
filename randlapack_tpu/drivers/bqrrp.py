"""BQRRP — blocked randomized QR with column pivoting, the flagship
performance driver (reference: RandLAPACK/drivers/rl_bqrrp.hh: BQRRPalg
:20, BQRRP::call :155; framework of arXiv:1509.06820 Alg 4).

Reference skeleton per block (SURVEY.md §3.3): QRCP on a one-time sketch
via LU pivots (``luqr``), pivot the trailing matrix, tall QR of the panel
(CholQR with sketch-R preconditioning), apply Qᵀ to the trailing matrix,
and *downdate* the sketch instead of re-sketching (:630-650).

Design:
  * Explicit-Q accumulation — the panel bases are orthogonalized against
    the running Q by the trailing update (+ optional BCGS2 pass), so
    Q = [Q₁ | Q₂ | …] directly; no Householder tau/orhr_col machinery
    (SURVEY.md §7 recommends explicit-Q primary). A cheap final CholQR
    pass on the finished Q restores machine-grade orthogonality.
  * Static shapes: one jitted lax.fori_loop over blocks. Column
    retirement is MASK-based — chosen pivots stay in place behind a
    retired mask (two full-width column-permutation gathers per block
    would move as many bytes as the trailing GEMMs); a single permutation
    per stage restores the positional layout for the next window and the
    outputs.
  * ``stages > 1`` splits the column space into S statically-shrinking
    windows (a host loop of S jitted stage graphs): trailing updates and
    sketch downdates then run at the window width instead of full n,
    recovering most of the ≤2× full-width FLOP overhead at the cost of S
    compilations.
  * Sketch downdate uses S·Q_panel ≈ A_sk_panel·R₁₁⁻¹ (exact in exact
    arithmetic *without* block_reorth, since then Q_panel = A_panel·R₁₁⁻¹):
    one triangular solve + one rank-b GEMM — the same math as the
    reference's trsm+gemm downdate. With ``block_reorth=True`` the panel
    is first BCGS2-corrected (panel −= Qp·proj), so the identity drops a
    (S·Qp)·proj·R₁₁⁻¹ term — but proj = Qpᵀ·A_work is itself the GS drift
    of the already-deflated trailing matrix, O(ε·‖A‖), so the omitted term
    is O(ε·‖A‖·κ(R₁₁)): below pivot-selection resolution, and the
    factorization itself is unaffected (the exact panel block of R is
    written from R₁₁, not the sketch). Tracking it exactly would cost a
    d×K GEMM per block.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import typing
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..ops.cholqr import cholqr, preconditioned_cholqr, shifted_cholqr3
from ..ops.qr import qr_econ
from ..ops import util


class QRTall(enum.Enum):
    cholqr = "cholqr"     # sketch-preconditioned CholQR (default, GEMM)
    hqr = "hqr"           # Householder panel QR (more robust, slower)


@dataclasses.dataclass(frozen=True)
class BQRRPConfig:
    block_size: int = 256
    d_factor: float = 1.25        # sketch rows d = d_factor * block_size
    qr_tall: QRTall = QRTall.cholqr
    panel_reorth: bool = True     # second CholQR pass on each panel
    block_reorth: bool = True     # BCGS2: re-project panel against Q
                                  # (controls GS drift; ~+50% FLOPs)
    final_orth: int = 1           # CholQR passes on the finished Q (each
                                  # ~2·m·K² FLOPs): QR = A[:,J] is exact
                                  # under GS drift, so one pass on the
                                  # near-orthonormal Q recovers machine-
                                  # grade orthogonality cheaply
    stages: int = 1               # shrinking-width stages (tall/square
                                  # only; 1 = single full-width graph)
    shard_axis: str | None = None # mesh axis name to shard the tall (row)
                                  # dimension over — set by dist_bqrrp;
                                  # inserts sharding constraints so GSPMD
                                  # keeps A/Q row-sharded through the loop
    pivot_candidates: int | None = None
                                  # preselect this many × block_size top-norm
                                  # sketch columns before the LU pivot pass
                                  # (the LU then runs on pc·b columns
                                  # instead of all active ones, with near-
                                  # identical pivot quality). None = faithful
                                  # full-width LU (the reference's luqr).
    sketch_r: str = "auto"        # factored form: how the panel
                                  # preconditioner R_sk is computed from
                                  # the sketch panel Ysk_p. "gram" =
                                  # Cholesky of Ysk_pᵀYsk_p (one GEMM,
                                  # fast, but squares the panel condition
                                  # number — f32 breaks past b≈512 on
                                  # decaying spectra); "qr" = Householder
                                  # qr_econ of the (d, b) sketch (no
                                  # squaring — the explicit driver's
                                  # route, enables b ≥ 1024); "auto" =
                                  # gram for b ≤ 512, qr above
    trailing_precision: str = "highest"
                                  # BOTH forms: precision of the trailing
                                  # -update GEMMs — factored: W = Vᵀ·A
                                  # and the group-end A −= V·Z; explicit:
                                  # the A_work −= Q·T GEMM only (T = QᵀA
                                  # becomes R rows and stays at driver
                                  # precision). "highest" = the driver
                                  # precision; "high" = lax.Precision.HIGH;
                                  # "default" = XLA default precision
                                  # (TF32 on a GPU);
                                  # "bf16_3x_emul" = explicit bf16-split
                                  # three-product emulation, for
                                  # CPU-side quality studies. Panel math,
                                  # R11/R12 extraction corrections, and
                                  # the sketch downdate stay at the
                                  # driver ``precision`` in every mode.
    update_defer: int = 1         # both forms: aggregate this many
                                  # consecutive blocks' rank-b trailing
                                  # updates (the thin-k V·Z GEMMs) and
                                  # apply them as ONE k = defer·b GEMM.
                                  # Panel math stays at block_size — the
                                  # within-group corrections are lazy
                                  # low-rank terms (classic left-looking
                                  # blocked-Householder restructuring;
                                  # FLOP overhead ~2·m·b²·defer per group,
                                  # repaid by the wide-k GEMM shape)


def _select_pivots(Y_m, b, retired, cfg: BQRRPConfig, dtype, precision):
    """The per-block qrcp_wide pivot pass: LU partial pivoting on the
    masked sketch (rl_bqrrp.hh luqr), optionally restricted to top-norm
    candidate columns."""
    n = Y_m.shape[1]
    # non-finite entries carry no pivot information (the sanitized
    # downdate already zeroes them; zeroed columns go to _fix_pivots)
    Y_m = jnp.where(jnp.isfinite(Y_m), Y_m, 0.0)
    # lu_pivot_columns carries the finite guard AND the structural-
    # deficiency pad that keeps every elimination pivot nonzero
    from ..ops.qr import lu_pivot_columns
    if cfg.pivot_candidates is not None:
        n_cand = min(n, cfg.pivot_candidates * b)
        norms2 = jnp.sum(Y_m * Y_m, axis=0)
        _, cand = jax.lax.top_k(norms2, n_cand)
        sub = jnp.take(Y_m, cand, axis=1)
        perm_sub = lu_pivot_columns(sub.T)
        return jnp.take(cand, perm_sub[:b])
    perm_lu = lu_pivot_columns(Y_m.T)
    return perm_lu[:b]


def _fix_pivots(chosen, retired):
    """Make an LU-derived pivot block valid: b distinct, un-retired
    columns. LU partial pivoting on the *masked* sketch can return
    retired (zeroed) columns when the live block is numerically zero —
    e.g. past the numerical rank, or an all-zero trailing window — and
    duplicated/retired picks would corrupt the retirement bookkeeping.
    Invalid slots are remapped to the lowest-index unchosen live columns
    (the same "any order" the reference's early-exit leaves them in,
    rl_bqrrp.hh:373-399)."""
    b = chosen.shape[0]
    n = retired.shape[0]
    live_mask = retired < 0.5
    first_pos = jnp.full((n,), b, jnp.int32).at[chosen].min(
        jnp.arange(b, dtype=jnp.int32))
    valid = live_mask[chosen] & (first_pos[chosen]
                                 == jnp.arange(b, dtype=jnp.int32))

    def remap(args):
        chosen, valid = args
        taken = jnp.zeros((n,), bool).at[jnp.where(valid, chosen, n)].set(
            True, mode="drop")
        avail = live_mask & ~taken
        cols = jnp.arange(n, dtype=jnp.int32)
        ord_ = jnp.argsort(jnp.where(avail, cols, n + cols)).astype(
            jnp.int32)
        slot_rank = jnp.cumsum(~valid) - 1
        return jnp.where(valid, chosen, ord_[slot_rank])

    # healthy blocks skip the remap (lax.cond executes one branch)
    return jax.lax.cond(jnp.all(valid), lambda a: a[0], remap,
                        (chosen, valid))


def bf16_3x_matmul(X, Y):
    """X·Y by explicit bf16 splitting: each operand becomes a bfloat16
    high part plus a bfloat16 residual, and the three dominant cross
    products run with bf16 inputs and f32 accumulation. Used for
    CPU-side quality studies of mixed-precision trailing updates
    (``trailing_precision="bf16_3x_emul"``): on the CPU every f32
    precision is true f32, so a lossy product has to be emulated to be
    measured."""
    dtype = X.dtype
    xh = X.astype(jnp.bfloat16)
    xl = (X - xh.astype(dtype)).astype(jnp.bfloat16)
    yh = Y.astype(jnp.bfloat16)
    yl = (Y - yh.astype(dtype)).astype(jnp.bfloat16)

    def f(a, b):
        return jnp.matmul(a, b, preferred_element_type=jnp.float32)

    return (f(xh, yh) + (f(xh, yl) + f(xl, yh))).astype(dtype)


def _tp_matmul(X, Y, trailing_precision, precision):
    """X·Y at the configured trailing precision (see
    BQRRPConfig.trailing_precision): "highest" = driver precision,
    "high" = lax.Precision.HIGH, "default" = XLA default (TF32 on a GPU),
    "bf16_3x_emul" = explicit emulation for CPU quality studies."""
    if trailing_precision == "highest":
        return jnp.matmul(X, Y, precision=precision)
    if trailing_precision == "default":
        return jnp.matmul(X, Y, precision=None)
    if trailing_precision == "high":
        return jnp.matmul(X, Y, precision=jax.lax.Precision.HIGH)
    return bf16_3x_matmul(X, Y)


def masked_vt_a_mixed(V, A, mask, trailing_precision, precision):
    """W = Vᵀ·(A ⊙ mask) at the configured trailing precision — the
    factored form's masked trailing projection (the mask is an
    elementwise producer that XLA fuses into the GEMM)."""
    return _tp_matmul(V.T, A * mask[None, :], trailing_precision, precision)


def a_minus_vz_masked_mixed(A, V, Z, mask, trailing_precision, precision):
    """A − (V·Z) ⊙ mask at the configured trailing precision — the
    factored form's group-end trailing update."""
    return A - _tp_matmul(V, Z, trailing_precision,
                          precision) * mask[None, :]


def _sanitize_sketch(Y, fail, dtype):
    """Keep the downdated sketch finite and boundedly scaled.

    The trsm sketch downdate solves against a diagonal-clamped R11; on a
    numerically deficient panel each block can amplify the live sketch
    columns by ~1/clamp, and a few consecutive deficient blocks overflow
    f32 to Inf. An Inf in the sketch would poison the next block's LU
    pivot pass, so the driver keeps the sketch finite and degrades
    gracefully instead.

    Two safeguards, both exact no-ops on healthy data:
      * non-finite entries → 0 with ``fail`` raised (the repo convention:
        failure is a returned flag, never NaN/Inf);
      * a GLOBAL scalar rescale back to max|Y| ≲ 2^26 ≈ 6.7e7 — pivot
        selection and the sketch-R preconditioner are invariant under a
        global scale of the sketch (R_sk picks up 1/α, panel·R_sk⁻¹
        picks up α, R11 = R_chol·R_sk cancels it), so this changes
        nothing but the overflow headroom. The scale is an EXACT power
        of two (exponent-only divide, no mantissa rounding) so the
        pow2 scale-equivariance pinned in test_property_sweeps holds
        bitwise even when a 2^k-scaled input trips this guard; the
        healthy case keeps ``scale == 1.0`` and passes through bitwise.
    """
    from ..ops.cholqr import _pow2
    finite = jnp.isfinite(Y)
    bad = ~jnp.all(finite)
    Y = jnp.where(finite, Y, 0.0)
    mx = jnp.max(jnp.abs(Y))
    k = jnp.ceil(jnp.log2(jnp.where(mx > 0, mx, 1.0))).astype(jnp.int32)
    scale = jnp.where(mx > jnp.asarray(2.0**26, dtype),
                      _pow2(k - 26, dtype), jnp.asarray(1.0, dtype))
    return Y / scale, fail | bad


def _safe_triu_diag(R, dtype):
    """Replace (near-)zero diagonal entries so triangular solves stay
    finite; deficient columns produce garbage Q beyond the returned rank,
    as in the reference (a-posteriori rank logic, rl_cqrrpt.hh:311-332)."""
    eps = jnp.finfo(dtype).eps
    d = jnp.diag(R)
    mx = jnp.max(jnp.abs(d))
    # purely RELATIVE floor: an absolute +eps term would swamp every
    # diagonal of a legitimately small-normed R (e.g. input scaled by
    # 2^-60) and turn the solve into garbage; mx·eps commutes with
    # power-of-2 input scales. mx == 0 (zero matrix) falls back to 1.
    ref = jnp.where(mx > 0.0, mx * eps, jnp.asarray(1.0, dtype))
    dsafe = jnp.where(jnp.abs(d) > ref, d, ref)
    return R - jnp.diag(d) + jnp.diag(dsafe)


@partial(jax.jit, static_argnames=("cfg", "g0", "q_hi", "nblocks",
                                   "precision"))
def _stage(A_loc, A_sk_loc, Q, R_loc, J_loc, fail, cfg: BQRRPConfig,
           g0: int, q_hi: int, nblocks: int, precision):
    """Process ``nblocks`` panel blocks inside the column window starting
    at global column ``g0``. All arrays local to the window except Q
    (full, filled through column g0+nblocks·b ≤ q_hi) and R_loc (K rows ×
    window columns)."""
    m = A_loc.shape[0]
    w = A_loc.shape[1]
    d = A_sk_loc.shape[0]
    b = cfg.block_size
    dtype = A_loc.dtype
    cols = jnp.arange(w)
    Qp = Q[:, :q_hi]

    # Column retirement is MASK-based inside the stage: full-width column
    # permutations (two m×w gathers per block) would move as many bytes as
    # the trailing GEMMs, so instead the chosen pivots
    # stay in place, a `retired` mask excludes them, and ONE permutation at
    # the stage end restores the positional invariant the next (narrower)
    # stage window relies on.
    #
    # NO dynamic-index 2D column scatters (`X.at[:, chosen].set/add`)
    # anywhere in the block loop (a workaround kept from an earlier
    # backend whose runtime crashed on block-width column scatters;
    # ROADMAP D2 re-measures it). The chosen columns' R
    # contributions (BCGS2 proj + R11) are instead STACKED by block slot
    # via dynamic_update_slice into `patch` (selection-order layout) and
    # merged with ONE static-slice add after the stage-end permutation —
    # bitwise the same values, zero scatters, zero extra FLOPs. The
    # trailing matrices keep their stale chosen columns (T is masked to
    # zero there), which is invisible: every later read masks by `live`.
    def block(i, carry, j=None, Qg=None, Tg=None):
        """One panel block. With ``j`` given (update-deferred group slot,
        static) the trailing A update is appended to the (Qg, Tg)
        aggregates instead of applied; the true panel and T row-block are
        recovered via the telescoping A_j = A_stale − Qg·Tg — exact, since
        each T_i already carries its live-mask and R11 writes, so the
        group-end A −= Qg·Tg reproduces the per-block sequence as the
        same GEMM sum reordered."""
        deferred = j is not None
        A_work, A_sk, Qp, R, patch, order, retired, fail = carry
        c = i * b              # local block offset; global = g0 + c
        if cfg.shard_axis is not None:
            from jax.sharding import PartitionSpec as _P
            A_work = jax.lax.with_sharding_constraint(
                A_work, _P(cfg.shard_axis, None))
            Qp = jax.lax.with_sharding_constraint(
                Qp, _P(cfg.shard_axis, None))

        # -- qrcp_wide: LU pivots on the masked live sketch ---------------
        live = 1.0 - retired
        A_sk_m = A_sk * live[None, :]
        chosen = _select_pivots(A_sk_m, b, retired, cfg, dtype, precision)
        chosen = _fix_pivots(chosen, retired)

        # -- panel QR: sketch-preconditioned CholQR -----------------------
        A_sk_panel = jnp.take(A_sk, chosen, axis=1)     # (d, b) gather
        panel = jnp.take(A_work, chosen, axis=1)        # (m, b) gather
        if deferred and j > 0:
            panel = panel - jnp.matmul(
                Qg, jnp.take(Tg, chosen, axis=1), precision=precision)
        if cfg.block_reorth:
            # BCGS2 against the filled basis prefix; correction folded
            # into R's earlier rows at the chosen columns — deferred into
            # `patch` slot i (scatter-free; merged post-permutation).
            proj = jnp.matmul(Qp.T, panel, precision=precision)  # (q_hi, b)
            panel = panel - jnp.matmul(Qp, proj, precision=precision)
            projK = jnp.zeros((R.shape[0], b), dtype)
            projK = jax.lax.dynamic_update_slice(projK, proj, (0, 0))
            patch = jax.lax.dynamic_update_slice(patch, projK, (0, c))
        if cfg.qr_tall == QRTall.cholqr:
            _, R_sk = qr_econ(A_sk_panel)
            R_sk = _safe_triu_diag(R_sk, dtype)
            Q_panel, R11, failp = preconditioned_cholqr(panel, R_sk,
                                                        precision)
            if cfg.panel_reorth:
                Q_panel, R2, f2 = cholqr(Q_panel, precision)
                R11 = jnp.matmul(R2, R11, precision=precision)
                failp = failp | f2
            Q_panel, R11 = jax.lax.cond(
                failp, lambda p, q, r: qr_econ(p),
                lambda p, q, r: (q, r), panel, Q_panel, R11)
        else:
            Q_panel, R11 = qr_econ(panel)
            failp = jnp.asarray(False)
        R11 = jnp.triu(R11)
        # R11 goes into `patch` slot i at its final row block (rows
        # g0+c:g0+c+b are zero in projK, so this DUS overwrites zeros)
        patch = jax.lax.dynamic_update_slice(patch, R11, (g0 + c, c))

        # -- trailing update over the (masked) window ---------------------
        retired = retired.at[chosen].set(1.0)
        live2 = 1.0 - retired
        T = jnp.matmul(Q_panel.T, A_work, precision=precision)   # (b, w)
        if deferred and j > 0:
            # T must read the TRUE trailing matrix: correct through the
            # pending aggregates before masking
            T = T - jnp.matmul(
                jnp.matmul(Q_panel.T, Qg, precision=precision), Tg,
                precision=precision)
        # live2 zeroes the chosen columns too (their R values live in
        # `patch`); the panel columns of A_work/A_sk keep stale data that
        # every later read masks out
        T = T * live2[None, :]
        if not deferred:
            # trailing A update at cfg.trailing_precision — T itself (the
            # R rows) always stays at the driver precision; only the
            # rank-b A_work GEMM (half the trailing FLOPs) may drop to a
            # faster precision, mirroring the factored form's split
            A_work = A_work - _tp_matmul(Q_panel, T,
                                         cfg.trailing_precision,
                                         precision)

        # -- sketch downdate ----------------------------------------------
        SQ = jax.lax.linalg.triangular_solve(
            _safe_triu_diag(R11, dtype), A_sk_panel,
            left_side=False, lower=False)
        A_sk = A_sk - jnp.matmul(SQ, T, precision=precision)
        A_sk, fail = _sanitize_sketch(A_sk, fail, dtype)

        # -- commit -------------------------------------------------------
        Qp = jax.lax.dynamic_update_slice(Qp, Q_panel, (0, g0 + c))
        R = jax.lax.dynamic_update_slice(R, T, (g0 + c, 0))
        order = jax.lax.dynamic_update_slice(order, chosen, (c,))
        carry = (A_work, A_sk, Qp, R, patch, order, retired, fail | failp)
        if not deferred:
            return carry
        Qg = Q_panel if j == 0 else jnp.concatenate([Qg, Q_panel], axis=1)
        Tg = T if j == 0 else jnp.concatenate([Tg, T], axis=0)
        return Qg, Tg, carry

    order0 = jnp.zeros((w,), jnp.int32)
    retired0 = jnp.zeros((w,), dtype)
    patch0 = jnp.zeros((R_loc.shape[0], nblocks * b), dtype)
    carry = (A_loc, A_sk_loc, Qp, R_loc, patch0, order0, retired0, fail)
    g = max(1, min(int(cfg.update_defer), nblocks))
    if cfg.shard_axis is not None:
        g = 1   # the sharded path keeps per-block psum'd updates
    if g == 1:
        carry = jax.lax.fori_loop(0, nblocks, block, carry)
    else:
        def make_group(gsz, off):
            def group(gi, carry):
                i0 = off + gi * gsz
                Qg = Tg = None
                for j in range(gsz):
                    Qg, Tg, carry = block(i0 + j, carry, j, Qg, Tg)
                A_work, A_sk, Qp_, R, patch_, order, retired, fl = carry
                # ONE wide k = gsz·b trailing update (same GEMM sum as
                # the per-block sequence, reordered) — at
                # cfg.trailing_precision (see the eager branch)
                A_work = A_work - _tp_matmul(Qg, Tg,
                                             cfg.trailing_precision,
                                             precision)
                return (A_work, A_sk, Qp_, R, patch_, order, retired, fl)
            return group

        ngroups, grem = divmod(nblocks, g)
        if ngroups:
            carry = jax.lax.fori_loop(0, ngroups, make_group(g, 0), carry)
        if grem:
            carry = make_group(grem, ngroups * g)(0, carry)
    A_loc, A_sk_loc, Qp, R_loc, patch, order, retired, fail = carry
    Q = Q.at[:, :q_hi].set(Qp)

    # stage-end permutation: pivots (in selection order) move to the front,
    # the rest keep relative order — restores the positional layout for the
    # next stage window and for the final outputs.
    k_sel = nblocks * b
    pos = jnp.zeros((w,), jnp.int32).at[order[:k_sel]].set(
        jnp.arange(k_sel, dtype=jnp.int32))
    key_ = jnp.where(retired > 0, pos, k_sel + cols)
    perm = jnp.argsort(key_)
    A_loc = jnp.take(A_loc, perm, axis=1)
    A_sk_loc = jnp.take(A_sk_loc, perm, axis=1)
    R_loc = jnp.take(R_loc, perm, axis=1)
    # merge the deferred chosen-column R values (BCGS2 proj + R11, stacked
    # in selection order = post-permutation layout) as one static-slice add
    R_loc = R_loc.at[:, :k_sel].add(patch)
    J_loc = jnp.take(J_loc, perm)
    return A_loc, A_sk_loc, Q, R_loc, J_loc, fail


def bqrrp(A: jax.Array, cfg: BQRRPConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False):
    """Blocked randomized QRCP of A (any aspect ratio): A[:, J] ≈ Q R.

    Returns ``(Q, R, J, rank, fail, next_state)``:
      Q (m, K) orthonormal, R (K, n) upper-trapezoidal, J (n,) int32,
      K = min(m, n) — any size/aspect ratio (a non-multiple K runs a
      one-block remainder stage; rl_bqrrp.hh:569-576 semantics),
      ``rank`` an int32 upper-bound estimate from diag(R),
      ``fail`` the CholQR breakdown flag.

    ``timing=True`` additionally returns a phase-metrics dict as a 7th
    element (the reference's 10-slot timing vector, rl_bqrrp.hh:584-607,
    as named phases) — it synchronizes between phases, so use only when
    measuring.
    """
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()
    m, n = A.shape
    b = min(cfg.block_size, min(m, n))
    if b != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=b)
    K = min(m, n)
    K_full, r = divmod(K, b)
    K_full *= b
    d = int(cfg.d_factor * b)
    dtype = A.dtype

    # stages partition the FULL blocks; a non-multiple K adds a remainder
    # stage of one r-wide block (the reference handles any size,
    # rl_bqrrp.hh:569-576; wide matrices use the same shrinking windows)
    S = cfg.stages if (cfg.stages > 1 and K_full > 0
                       and K_full % (cfg.stages * b) == 0) else 1
    chunk = K_full // S if K_full else 0

    # one-time sketch (rl_bqrrp.hh:306-312)
    with _phase("sketch"):
        key, state = state.spawn()
        Smat = jax.random.normal(key, (d, m), dtype=dtype) / math.sqrt(d)
        A_sk = jnp.matmul(Smat, A, precision=precision)
        if timing:
            device_sync(A_sk)

    Q = jnp.zeros((m, K), dtype)
    R = jnp.zeros((K, n), dtype)
    J = jnp.arange(n, dtype=jnp.int32)
    fail = jnp.asarray(False)
    A_work = A

    # stage plan: (g0, q_hi, nblocks, stage_cfg) — S full stages plus an
    # optional one-block remainder stage of width r
    plan = [(s * chunk, min((s + 1) * chunk, K_full), chunk // b, cfg)
            for s in range(S) if chunk]
    if r:
        plan.append((K_full, K, 1, dataclasses.replace(
            cfg, block_size=r,
            pivot_candidates=(cfg.pivot_candidates
                              if cfg.pivot_candidates is None else
                              max(1, cfg.pivot_candidates)))))

    n_stages = len(plan)
    for s, (g0, q_hi, nblocks, scfg) in enumerate(plan):
        # local window [g0, n)
        A_loc = A_work[:, g0:] if s > 0 else A_work
        A_sk_loc = A_sk[:, g0:] if s > 0 else A_sk
        R_loc = R[:, g0:] if s > 0 else R
        J_loc = J[g0:] if s > 0 else J
        with _phase(f"stage_{s}"):
            A_loc, A_sk_loc, Q, R_loc, J_loc, fail = _stage(
                A_loc, A_sk_loc, Q, R_loc, J_loc, fail, scfg, g0, q_hi,
                nblocks, precision)
            if timing:
                device_sync(Q)
        if n_stages > 1:
            if s + 1 < n_stages:
                A_work = A_work.at[:, g0:].set(A_loc)
                A_sk = A_sk.at[:, g0:].set(A_sk_loc)
            R = R.at[:, g0:].set(R_loc)
            J = J.at[g0:].set(J_loc)
        else:
            R, J = R_loc, J_loc

    _fo = _phase("final_orth")
    _fo.__enter__()
    for _ in range(cfg.final_orth):
        # final-orth pass with shift rescue: on degenerate Q (rank-deficient
        # input → fallback panels can collide) the unshifted Cholesky breaks;
        # the shifted factor keeps outputs finite and `fail` records it.
        G = jnp.matmul(Q.T, Q, precision=precision)
        L = jax.lax.linalg.cholesky(G)
        bad = jnp.any(jnp.isnan(L)) | jnp.any(jnp.diag(L) <= 0)
        eps = jnp.finfo(dtype).eps
        s2 = 11.0 * eps * jnp.trace(G) + eps
        Ls = jax.lax.linalg.cholesky(G + s2 * jnp.eye(K, dtype=dtype))
        L = jnp.where(bad, Ls, L)
        Q = jax.lax.linalg.triangular_solve(L.T, Q, left_side=False,
                                            lower=False)
        if cfg.shard_axis is not None:
            from jax.sharding import PartitionSpec as _P
            Q = jax.lax.with_sharding_constraint(Q,
                                                 _P(cfg.shard_axis, None))
        R = jnp.matmul(L.T, R, precision=precision)
        fail = fail | bad

    if timing:
        device_sync(Q)
    _fo.__exit__(None, None, None)

    diag = jnp.diag(R[:, :K])
    eps = jnp.finfo(dtype).eps
    tol = jnp.abs(diag[0]) * jnp.sqrt(jnp.asarray(eps, dtype))
    rank = util.naive_rank_est(diag, tol)
    if timing:
        return Q, R, J, rank, fail, state, timer.report()
    return Q, R, J, rank, fail, state


# ---------------------------------------------------------------------------
# WY-form (implicit-Q) BQRRP — the reference's native output semantics
# ---------------------------------------------------------------------------

class BQRRPFactors(typing.NamedTuple):
    """Implicit factored output of :func:`bqrrp_factored` — the analogue of
    the reference's GEQP3-compatible (reflectors, tau, J) triple
    (rl_bqrrp.hh:132: "BQRRP is not in the business of forming Q
    explicitly"): A[:, J] = Q·R with Q = H₁·…·H_nb left implicit as
    block-WY transforms Hᵢ = I − Vᵢ·Tᵢ·Vᵢᵀ.

    Unlike LAPACK's elementary-reflector format, T is a *general* b×b
    matrix per block (the LU-free Householder reconstruction below trades
    the triangular-T convention for a pure-GEMM build); use
    :func:`bqrrp_q` / :func:`bqrrp_apply_qt` to consume it.
    """
    V: jax.Array        # (m, K) block reflector basis, block i in cols
                        # i·b:(i+1)·b, zeros above row i·b
    T: jax.Array        # (nb, b, b) per-block WY factors
    R: jax.Array        # (K, n) upper-trapezoidal
    J: jax.Array        # (n,) int32 pivots
    rank: jax.Array     # int32 upper-bound rank estimate
    fail: jax.Array     # bool — CholQR breakdown along the way


def _wy_reconstruct(Q_panel: jax.Array, c, precision):
    """Householder reconstruction — delegates to the blocked
    adaptive-sign ``orhr_col`` (ops/householder.py), the LAPACK-robust
    construction. A fixed sign choice S = −sign(diag Q₁) with
    T⁻¹ = I − Q₁ᵀS is NOT safe: when the panel is square (BQRRP's last
    block on a square matrix) Q₁ is orthogonal and Q₁·S can have an
    eigenvalue exactly 1, making T singular (observed in testing).
    The adaptive-sign LU keeps every pivot ≥ 1 unconditionally.

    Returns ``(V, T, s)``: H = I − V·T·Vᵀ exactly orthogonal up to the
    panel's own orthonormality error, with H·E_blk = Q_panel·diag(s).
    """
    from ..ops.householder import orhr_col
    return orhr_col(Q_panel, c, precision)


@partial(jax.jit, static_argnames=("cfg", "c0", "tidx0", "nblocks", "bsz",
                                   "precision"))
def _wy_stage(A, Y, Vall, Ts, J_loc, fail, cfg: BQRRPConfig,
              c0: int, tidx0: int, nblocks: int, bsz: int, precision):
    """Factored-form stage over a column WINDOW: in-place Householder
    coordinates (live columns carry QᵀA), mask-based retirement inside
    the window, exact trsm sketch downdate (rl_bqrrp.hh:630-650 — exact
    here because WY coordinates remove the BCGS drift term discussed in
    the explicit driver), then ONE stage-end permutation moving the
    pivots to the window front (the shrinking-width structure that lets
    the next stage's trailing GEMMs run narrower).

    ``A``/``Y``/``J_loc`` are the window slabs (columns [g0:n) of the
    global problem); ``c0``/``tidx0`` the global row offset / T-slot
    base; ``bsz`` the block width (the remainder stage passes r < b).
    Returns the permuted slabs.

    ``cfg.update_defer = g > 1`` restructures the loop left-looking:
    blocks run in groups of g; within a group the rank-b ``V·(TᵀW)``
    trailing GEMMs (thin-k) are NOT applied —
    each block's panel/W/R12 reads the stale A plus an exact low-rank
    correction through the group aggregates (V_g, U_g), and the group
    ends with ONE k = g·b masked GEMM. Identical math to the eager loop
    (the corrections are exact, not approximations), wider GEMM shapes.
    """
    m, n = A.shape
    b = bsz
    dtype = A.dtype
    rows = jnp.arange(m)
    order = jnp.zeros((nblocks * b,), jnp.int32)
    retired = jnp.zeros((n,), dtype)

    def subblock(i, j, Vg, Ug, carry):
        """Block ``i`` (traced stage-local index) in group slot ``j``
        (static). Appends this block's (V, U = Tᵀ·W) to the group
        aggregates instead of applying the rank-b update."""
        A, Y, Vall, Ts, Fstk, order, retired, fail = carry
        c = c0 + i * b
        live = 1.0 - retired
        if cfg.shard_axis is not None:
            from jax.sharding import PartitionSpec as _P
            A = jax.lax.with_sharding_constraint(
                A, _P(cfg.shard_axis, None))
            Vall = jax.lax.with_sharding_constraint(
                Vall, _P(cfg.shard_axis, None))

        # -- qrcp_wide: LU pivots on the masked live sketch -------------
        Y_m = Y * live[None, :]
        chosen = _select_pivots(Y_m, b, retired, cfg, dtype, precision)
        chosen = _fix_pivots(chosen, retired)

        # -- panel QR at row offset c (lazily-corrected true panel) ------
        panel = jnp.take(A, chosen, axis=1)
        if j > 0:
            panel = panel - jnp.matmul(
                Vg, jnp.take(Ug, chosen, axis=1), precision=precision)
        panel_m = jnp.where(rows[:, None] >= c, panel, 0.0)
        Ysk_p = jnp.take(Y, chosen, axis=1)
        if cfg.qr_tall == QRTall.hqr:
            # Householder-R panel (the reference's geqrf qr_tall option):
            # R from a backward-stable QR, explicit Q via one solve — the
            # solve preserves the zeros above row c that the WY form needs
            R11 = _safe_triu_diag(
                jnp.linalg.qr(panel_m, mode="r")[:b, :], dtype)
            Q_panel = jax.lax.linalg.triangular_solve(
                R11, panel_m, left_side=False, lower=False)
            failp = jnp.any(~jnp.isfinite(Q_panel))
        else:
            if cfg.sketch_r == "qr" or (cfg.sketch_r == "auto"
                                        and b > 512):
                # Householder R of the (d, b) sketch: no Gram squaring,
                # so the preconditioner survives panel condition numbers
                # that NaN the f32 Gram route (the round-2 b≥1024
                # quality collapse was exactly this Cholesky)
                R_sk = _safe_triu_diag(qr_econ(Ysk_p)[1], dtype)
            else:
                # pow2 band-normalize before the Gram: a uniformly tiny
                # sketch (input scaled ~2^-60) underflows G_sk toward the
                # denormal floor and silently destroys the preconditioner
                # (ops/cholqr.py::_finite_scaled has the full story)
                from ..ops.cholqr import _finite_scaled
                Ysk_n, s_y, _ = _finite_scaled(Ysk_p)
                G_sk = jnp.matmul(Ysk_n.T, Ysk_n, precision=precision)
                L_sk = jax.lax.linalg.cholesky(G_sk)
                badsk = jnp.any(jnp.isnan(L_sk))
                R_sk = _safe_triu_diag(
                    jnp.where(badsk, jnp.eye(b, dtype=dtype),
                              L_sk.T * s_y), dtype)
            Q_panel, R11, failp = preconditioned_cholqr(panel_m, R_sk,
                                                        precision)
        if cfg.panel_reorth:
            Q_panel, R2, f2 = cholqr(Q_panel, precision)
            R11 = jnp.matmul(R2, R11, precision=precision)
            failp = failp | f2
        # rescue 1: shifted CholQR3 (GEMM-form, survives ill-conditioning)
        # — LAZY: lax.cond executes only the taken branch, so the healthy
        # path skips the 3-pass rescue chain entirely
        Q_panel, R11, f_r = jax.lax.cond(
            failp,
            lambda pm, q, r: shifted_cholqr3(pm, precision),
            lambda pm, q, r: (q, r, jnp.asarray(False)),
            panel_m, Q_panel, R11)
        # rescue 1.5 (condition-aware auto-routing, VERDICT r3 item 5):
        # shifted CholQR3 fails loudly at κ ≳ 6e5 f32 — route those panels
        # through Householder-R preconditioned CholQR (backward-stable R is
        # the perfect preconditioner; measured eps-level orthogonality to
        # κ = 3e7 f32). The solve-based Q construction preserves the exact
        # zeros above row c that the WY reconstruction needs. Only truly
        # degenerate panels fall through to the identity pad below.
        def _hqr_rescue(pm, q, r):
            R_h = _safe_triu_diag(
                jnp.linalg.qr(pm, mode="r")[:b, :], dtype)
            Qh, Rh, fh = preconditioned_cholqr(pm, R_h, precision)
            return Qh, Rh, fh | jnp.any(~jnp.isfinite(Qh))
        Q_panel, R11, f_h = jax.lax.cond(
            failp & f_r, _hqr_rescue,
            lambda pm, q, r: (q, r, jnp.asarray(False)),
            panel_m, Q_panel, R11)
        fail = fail | (failp & f_r & f_h)
        # rescue 2: exactly-zero/degenerate panels NaN even the shifted
        # pass — substitute identity columns so outputs stay finite with
        # `fail` raised (repo convention: failure is a flag, never NaN)
        nanp = jnp.any(jnp.isnan(Q_panel)) | jnp.any(jnp.isnan(R11))
        # compare-based identity pad (no dynamic-index scatter, as in
        # _stage's layout note)
        E_pad = (rows[:, None] == c + jnp.arange(b)[None, :]).astype(dtype)
        Q_panel = jnp.where(nanp, E_pad, Q_panel)
        R11 = jnp.where(nanp, 0.0, R11)
        fail = fail | nanp
        R11 = jnp.triu(R11)

        # -- LU-free Householder reconstruction -------------------------
        V, T, s = _wy_reconstruct(Q_panel, c, precision)

        # -- the chosen columns' final values: R12 rows (< c) kept, signed
        # R11 — STACKED into the selection-order buffer Fstk (merged into
        # A once, post-permutation); A keeps its stale panel columns,
        # which every later read masks out via live2/retired (no
        # dynamic-index column scatter — see _stage's layout note)
        Rsigned = s[:, None] * R11
        Rpad = jnp.zeros((m, b), dtype)
        Rpad = jax.lax.dynamic_update_slice(Rpad, Rsigned, (c, 0))
        Fstk = jax.lax.dynamic_update_slice(
            Fstk, jnp.where(rows[:, None] < c, panel, 0.0) + Rpad,
            (0, c - c0))
        live2 = live.at[chosen].set(0.0)

        # -- W = Vᵀ·(A_true ⊙ live2); U = Tᵀ·W (update stays deferred) --
        W = masked_vt_a_mixed(V, A, live2, cfg.trailing_precision,
                              precision)
        if j > 0:
            W = W - jnp.matmul(
                jnp.matmul(V.T, Vg, precision=precision),
                Ug * live2[None, :], precision=precision)
        U = jnp.matmul(T.T, W, precision=precision)

        # -- R12 = rows c:c+b of the true post-update A, on live cols ---
        R12 = jax.lax.dynamic_slice(A, (c, 0), (b, n))
        if j > 0:
            Vg_rows = jax.lax.dynamic_slice(Vg, (c, 0), (b, Vg.shape[1]))
            R12 = R12 - jnp.matmul(Vg_rows, Ug, precision=precision)
        V_rows = jax.lax.dynamic_slice(V, (c, 0), (b, b))
        R12 = (R12 - jnp.matmul(V_rows, U, precision=precision)
               ) * live2[None, :]

        # -- exact sketch downdate: B = Y_panel·R11⁻¹·S -----------------
        B = jax.lax.linalg.triangular_solve(
            _safe_triu_diag(R11, dtype), Ysk_p,
            left_side=False, lower=False) * s[None, :]
        Y = Y - jnp.matmul(B, R12, precision=precision) * live2[None, :]
        Y, fail = _sanitize_sketch(Y, fail, dtype)

        # -- commit ------------------------------------------------------
        # remainder blocks (b < T-slot width) pad T with identity; the
        # matching V columns are zero, so H is unaffected
        bT = Ts.shape[1]
        Tpad = (T if b == bT
                else jnp.eye(bT, dtype=dtype).at[:b, :b].set(T))
        Vall = jax.lax.dynamic_update_slice(Vall, V, (0, c))
        Ts = jax.lax.dynamic_update_slice(Ts, Tpad[None], (tidx0 + i, 0, 0))
        order = jax.lax.dynamic_update_slice(order, chosen, (i * b,))
        retired = retired.at[chosen].set(1.0)
        Vg = V if j == 0 else jnp.concatenate([Vg, V], axis=1)
        Ug = U if j == 0 else jnp.concatenate([Ug, U], axis=0)
        return Vg, Ug, (A, Y, Vall, Ts, Fstk, order, retired, fail)

    def make_group(g, off):
        """A fori body processing g consecutive blocks (slots unrolled,
        so each slot's aggregate shapes are static) then applying their
        combined update as one masked k = g·b GEMM. Columns retired
        inside the group were written final values from lazily-corrected
        panels and are excluded by the end-of-group live mask."""
        def group(gi, carry):
            i0 = off + gi * g
            Vg = Ug = None
            for j in range(g):
                Vg, Ug, carry = subblock(i0 + j, j, Vg, Ug, carry)
            A, Y, Vall, Ts, Fstk, order, retired, fail = carry
            live_end = 1.0 - retired
            A = a_minus_vz_masked_mixed(A, Vg, Ug, live_end,
                                        cfg.trailing_precision,
                                        precision)
            return (A, Y, Vall, Ts, Fstk, order, retired, fail)
        return group

    g = max(1, min(int(cfg.update_defer), nblocks))
    ngroups, grem = divmod(nblocks, g)
    Fstk0 = jnp.zeros((m, nblocks * b), dtype)
    carry = (A, Y, Vall, Ts, Fstk0, order, retired, fail)
    carry = jax.lax.fori_loop(0, ngroups, make_group(g, 0), carry)
    if grem:
        carry = make_group(grem, ngroups * g)(0, carry)
    A, Y, Vall, Ts, Fstk, order, retired, fail = carry

    # stage-end permutation: pivots to the window front in selection
    # order; the rest keep relative order for the next (narrower) stage
    k_sel = nblocks * b
    cols = jnp.arange(n)
    pos = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(k_sel, dtype=jnp.int32))
    key_ = jnp.where(retired > 0, pos, k_sel + cols)
    perm = jnp.argsort(key_)
    A = jnp.take(A, perm, axis=1)
    # overwrite the window front with the stacked final pivot columns
    # (selection order = post-permutation layout; one static-slice set)
    A = A.at[:, :k_sel].set(Fstk)
    Y = jnp.take(Y, perm, axis=1)
    J_loc = jnp.take(J_loc, perm)
    return A, Y, Vall, Ts, J_loc, fail


def bqrrp_factored(A: jax.Array, cfg: BQRRPConfig, state: RNGState,
                   precision=STABLE_PRECISION, timing: bool = False):
    """Blocked randomized QRCP in the reference's native *factored* form:
    A[:, J] = Q·R with Q implicit (block-WY reflectors) — the
    GEQP3-semantics path (rl_bqrrp.hh returns reflectors+tau+J and
    explicitly does not form Q). Materialize Q with :func:`bqrrp_q`, or
    apply Qᵀ with :func:`bqrrp_apply_qt`.

    Orthogonality of the (materialized) Q is reflector-grade — the
    trailing matrix is carried in exactly-rotated coordinates, so there is
    no cross-block Gram-Schmidt drift and no final re-orthogonalization
    pass (the explicit driver's ``final_orth`` cost disappears).

    Any size/aspect ratio: a non-multiple min(m, n) runs one remainder
    block (identity-padded T slot, zero-padded V columns).
    Returns ``(BQRRPFactors, next_state)`` (+ phase dict when
    ``timing=True``).
    """
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()

    m, n = A.shape
    b = min(cfg.block_size, min(m, n))
    if b != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=b)
    K = min(m, n)
    K_full, rrem = divmod(K, b)
    K_full *= b
    nb_full = K_full // b
    nblocks = nb_full + (1 if rrem else 0)
    d = int(cfg.d_factor * b)
    dtype = A.dtype

    with _phase("sketch"):
        key, state = state.spawn()
        Smat = jax.random.normal(key, (d, m), dtype=dtype) / math.sqrt(d)
        Y = jnp.matmul(Smat, A, precision=precision)
        if timing:
            device_sync(Y)

    Kpad = nblocks * b
    Vall = jnp.zeros((m, Kpad), dtype)
    Ts = jnp.zeros((nblocks, b, b), dtype)
    fail = jnp.asarray(False)
    J = jnp.arange(n, dtype=jnp.int32)
    A_work = A

    # shrinking-width stage plan (same structure as the explicit driver):
    # S windows over the full blocks + an optional remainder stage
    S = cfg.stages if (cfg.stages > 1 and nb_full > 0
                       and nb_full % cfg.stages == 0) else 1
    chunk = nb_full // S if nb_full else 0
    plan = [(s * chunk * b, s * chunk, chunk, b)
            for s in range(S) if chunk]
    if rrem:
        plan.append((K_full, nb_full, 1, rrem))

    n_stages = len(plan)
    for si, (g0, tidx0, nbl, bsz) in enumerate(plan):
        A_loc = A_work[:, g0:] if si > 0 else A_work
        Y_loc = Y[:, g0:] if si > 0 else Y
        J_loc = J[g0:] if si > 0 else J
        with _phase(f"stage_{si}"):
            A_loc, Y_loc, Vall, Ts, J_loc, fail = _wy_stage(
                A_loc, Y_loc, Vall, Ts, J_loc, fail, cfg, g0, tidx0,
                nbl, bsz, precision)
            if timing:
                device_sync(A_loc)
        if n_stages > 1:
            if si + 1 < n_stages:
                A_work = A_work.at[:, g0:].set(A_loc)
                Y = Y.at[:, g0:].set(Y_loc)
            else:
                A_work = A_work.at[:, g0:].set(A_loc)
            J = J.at[g0:].set(J_loc)
        else:
            A_work, J = A_loc, J_loc

    with _phase("epilogue"):
        A_perm = A_work
        R = jnp.triu(A_perm[:K, :])
        if timing:
            device_sync(R)

    diag = jnp.diag(R[:, :K])
    eps = jnp.finfo(dtype).eps
    tol = jnp.abs(diag[0]) * jnp.sqrt(jnp.asarray(eps, dtype))
    rank = util.naive_rank_est(diag, tol)
    fac = BQRRPFactors(V=Vall, T=Ts, R=R, J=J, rank=rank, fail=fail)
    if timing:
        return fac, state, timer.report()
    return fac, state


def _wy_tree_merge(fac: BQRRPFactors, precision):
    """Merge the per-block WY factors into ONE (V, T) pair by pairwise
    combination: H₁H₂ = I − [V₁ V₂]·[[T₁, −T₁(V₁ᵀV₂)T₂],[0, T₂]]·[V₁ V₂]ᵀ.
    log₂(nb) levels of batched cross-GEMMs — turns the nb sequential
    2-GEMM applies into two full-size GEMMs at apply time."""
    m, Kpad = fac.V.shape
    nb, b, _ = fac.T.shape
    Vs = [fac.V[:, i * b:(i + 1) * b] for i in range(nb)]
    Ts = [fac.T[i] for i in range(nb)]
    while len(Vs) > 1:
        nVs, nTs = [], []
        for i in range(0, len(Vs) - 1, 2):
            V1, T1 = Vs[i], Ts[i]
            V2, T2 = Vs[i + 1], Ts[i + 1]
            cross = -jnp.matmul(
                T1, jnp.matmul(jnp.matmul(V1.T, V2, precision=precision),
                               T2, precision=precision),
                precision=precision)
            b1, b2 = T1.shape[0], T2.shape[0]
            T = jnp.block([[T1, cross],
                           [jnp.zeros((b2, b1), T1.dtype), T2]])
            nVs.append(jnp.concatenate([V1, V2], axis=1))
            nTs.append(T)
        if len(Vs) % 2:
            nVs.append(Vs[-1])
            nTs.append(Ts[-1])
        Vs, Ts = nVs, nTs
    return Vs[0], Ts[0]


@partial(jax.jit, static_argnames=("k", "method", "precision"))
def bqrrp_q(fac: BQRRPFactors, k: int | None = None,
            method: str = "sequential", precision=STABLE_PRECISION):
    """Materialize the leading ``k`` (default all K = min(m,n)) columns of
    Q from the factored form — the orgqr/ungqr analogue (cost ≈ 4·m·K·k
    flops; the reference likewise leaves this to the caller).

    ``method="sequential"`` (default) applies the nb blocks one by one
    and is slightly better-conditioned. ``"tree"`` merges
    the block-WY factors pairwise into one reflector block (two full-size
    GEMMs) — kept for apply-many workloads where the merge amortizes."""
    m, _ = fac.V.shape
    nb, b, _ = fac.T.shape
    k = fac.R.shape[0] if k is None else k
    dtype = fac.V.dtype

    if method == "tree":
        V, T = _wy_tree_merge(fac, precision)
        # Q = (I − V T Vᵀ)·E_k  = E_k − V·(T·(Vᵀ E_k)) ; Vᵀ E_k = V[:k].T
        W = jnp.matmul(T, V[:k, :].T, precision=precision)
        Q = -jnp.matmul(V, W, precision=precision)
        return Q.at[jnp.arange(k), jnp.arange(k)].add(1.0)

    Q = jnp.eye(m, k, dtype=dtype)

    def apply_h(j, Q):
        i = nb - 1 - j
        Vi = jax.lax.dynamic_slice(fac.V, (0, i * b), (m, b))
        Ti = jax.lax.dynamic_slice(fac.T, (i, 0, 0), (1, b, b))[0]
        Wk = jnp.matmul(Vi.T, Q, precision=precision)
        return Q - jnp.matmul(Vi, jnp.matmul(Ti, Wk, precision=precision),
                              precision=precision)

    return jax.lax.fori_loop(0, nb, apply_h, Q)


@partial(jax.jit, static_argnames=("precision",))
def bqrrp_apply_qt(fac: BQRRPFactors, X: jax.Array,
                   precision=STABLE_PRECISION):
    """Qᵀ·X from the factored form — the ormqr/gemqrt analogue
    (rl_bqrrp.hh:535-547)."""
    m, K = fac.V.shape
    nb, b, _ = fac.T.shape

    def apply_ht(i, X):
        Vi = jax.lax.dynamic_slice(fac.V, (0, i * b), (m, b))
        Ti = jax.lax.dynamic_slice(fac.T, (i, 0, 0), (1, b, b))[0]
        Wk = jnp.matmul(Vi.T, X, precision=precision)
        return X - jnp.matmul(Vi, jnp.matmul(Ti.T, Wk,
                                             precision=precision),
                              precision=precision)

    return jax.lax.fori_loop(0, nb, apply_ht, X)
