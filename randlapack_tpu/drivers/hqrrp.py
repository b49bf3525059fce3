"""HQRRP — Householder QR with randomized pivoting (reference:
RandLAPACK/drivers/rl_hqrrp.hh: hqrrp() :812; the
Martinsson/Quintana-Ortí/Heavner/van de Geijn algorithm).

A genuinely distinct driver from BQRRP — per block of ``b`` columns:

  1. QRCP of the downdated sketch: ``b`` steps of unblocked Householder
     QRCP with Drmač norm downdating on the live columns of Y = G·A
     (``NoFLA_QRPmod_WY_unb_var4`` :557, norm downdate :360); the pivots
     are applied to (V, A, Y) in lockstep (:415) — here realized as one
     gather of the chosen columns instead of three synchronized swap
     streams.
  2. Panel factorization of A[:, chosen] with per-config ``qr_type``
     (:1088): pivoted Householder QRCP (panel_pivoting=1, the default),
     unpivoted Householder (``GEQRF_mod_WY`` :465), or CholQR with
     Householder reconstruction (``CHOLQR_mod_WY`` :506 — the orhr_col
     path).
  3. Compact-WY trailing update A ← QᵀA on the live columns
     (``NoFLA_Apply_Q_WY_lhfc_blk_var4`` :300) — two GEMMs.
  4. Sketch *downdating* instead of re-sketching (``NoFLA_Downdate_Y``
     :207): G ← G·Q_blk, then Y₂ ← Y₂ − G_new[:, c:c+b]·R₁₂ — the exact
     WY algebra, so Y stays the exact sketch of the trailing residual.

Design notes:
  * Static shapes: mask-based column retirement (chosen pivots stay in
    place behind a ``retired`` mask), one permutation at the end; the
    reference's three-matrix lockstep swaps become gathers/scatters of
    the chosen block.
  * Householder form all the way down: A is overwritten in place (R
    above, reflector tails below, LAPACK packed layout), so Q is a
    product of exact reflectors — machine-grade orthogonality with no
    final re-orthogonalization pass. Explicit Q is materialized at the
    end via ``householder_product``; the packed (A, taus) pair is the
    native GEQP3-format output.
  * The WY T factor is built in GEMM form (T⁻¹ = diag(1/τ) +
    strict_upper(VᵀV)) instead of larft's column recurrence.
  * Unlike the reference (which skips the sketch QRCP on the last
    iteration, rl_hqrrp.hh:948,1029), the last block also selects pivots
    from the sketch — strictly better pivot quality at negligible cost.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..ops.qr import qrcp_select_pivots, qrcp_panel, wy_T
from ..ops.cholqr import cholqr2
from ..ops import util


class PanelQR(enum.Enum):
    qrcp = "qrcp"        # pivoted panels (reference panel_pivoting=1)
    geqrf = "geqrf"      # qr_type 1: unpivoted Householder panels
    cholqr = "cholqr"    # qr_type 2: CholQR + Householder reconstruction


@dataclasses.dataclass(frozen=True)
class HQRRPConfig:
    block_size: int = 64
    oversample: int = 10          # the reference's pp (sketch rows = b+pp)
    panel_qr: PanelQR = PanelQR.qrcp
    shard_axis: str | None = None  # mesh axis to row-shard the tall dim
                                   # over (set by dist_hqrrp): A and the
                                   # sketch operator G stay sharded, the
                                   # small Y/T/R stay replicated
    trailing_precision: str = "highest"
                                  # precision of the trailing-update GEMMs
                                  # (Wk = VᵀA and the A −= V·U update, the
                                  # FLOP bulk at b=128): "highest" = the
                                  # driver precision; "default" = XLA
                                  # default (TF32 on a GPU);
                                  # "bf16_3x_emul" = explicit emulation
                                  # for CPU quality studies. Panel math,
                                  # pivots, and the exact sketch downdate
                                  # always stay at driver precision (same
                                  # measured-safe split as
                                  # bqrrp.BQRRPConfig.trailing_precision).
    update_defer: int = 1         # aggregate this many consecutive blocks'
                                  # compact-WY trailing updates and apply
                                  # them as ONE k = defer·b GEMM (the same
                                  # left-looking telescoping as
                                  # bqrrp.BQRRPConfig.update_defer): at
                                  # b = 128 the per-block trailing GEMMs
                                  # are thin, so widening k improves their
                                  # shape.
                                  # Pivot selection, panel math and the
                                  # exact sketch downdate still run per
                                  # block on lazily-corrected operands.


def _cholqr_panel(panel, row0, precision):
    """CHOLQR_mod_WY (rl_hqrrp.hh:506): CholQR of the row-masked panel,
    then blocked Householder reconstruction (the orhr_col step,
    ops/householder.py — adaptive-sign LU, GEMM-form) at offset row0.
    τₗ = 2/‖vₗ‖² makes each stored reflector *exact*, so the
    householder_product materialization and the in-loop WY updates agree
    to the panel's CholQR quality. Returns (W, V, taus, sigma, fail) in
    qrcp_panel's layout."""
    from ..ops.householder import orhr_col
    m, b = panel.shape
    dtype = panel.dtype
    rows = jnp.arange(m)
    cols = jnp.arange(b)
    Pm = jnp.where(rows[:, None] >= row0, panel, 0.0)
    Qp, R_chol, fail = cholqr2(Pm, precision)
    # breakdown sanitize (repo convention: fail is a FLAG, outputs stay
    # finite): substitute identity columns at the panel offset so the
    # reconstruction and downstream WY algebra remain well-defined
    nanp = jnp.any(~jnp.isfinite(Qp)) | jnp.any(~jnp.isfinite(R_chol))
    # compare-based identity pad (no dynamic-index scatter — see the
    # layout note in bqrrp._stage)
    E_pad = (rows[:, None] == row0 + cols[None, :]).astype(dtype)
    Qp = jnp.where(nanp, E_pad, Qp)
    R_chol = jnp.where(nanp, 0.0, R_chol)
    fail = fail | nanp
    V, _, s = orhr_col(Qp, row0, precision)
    taus = 2.0 / jnp.sum(V * V, axis=0)
    R11 = s[:, None] * R_chol
    top = jnp.where(rows[:, None] < row0, panel, 0.0)
    Rpad = jnp.zeros((m, b), dtype)
    Rpad = jax.lax.dynamic_update_slice(Rpad, R11, (row0, 0))
    tails = jnp.where(rows[:, None] > row0 + cols[None, :], V, 0.0)
    W = top + Rpad + tails
    sigma = jnp.arange(b, dtype=jnp.int32)
    return W, V, taus, sigma, fail


@partial(jax.jit, static_argnames=("c0", "nblocks", "bsz", "cfg",
                                   "precision"))
def _hqrrp_blocks(A, Y, G, Fstk, order, taus_g, retired, fail, c0: int,
                  nblocks: int, bsz: int, cfg: HQRRPConfig, precision):
    """Process ``nblocks`` blocks of ``bsz`` columns starting at global
    rank position ``c0`` (one jitted fori_loop). With
    ``cfg.update_defer > 1`` the trailing updates of each group of
    ``defer`` blocks are aggregated into one wide GEMM (see
    :func:`_hqrrp_subblock_deferred`)."""
    m, n = A.shape
    d = Y.shape[0]
    g = max(1, min(int(cfg.update_defer), nblocks))
    if cfg.shard_axis is not None:
        g = 1   # the sharded path keeps the per-block psum'd updates

    carry = (A, Y, G, Fstk, order, taus_g, retired, fail)
    if g == 1:
        def block(ib, carry):
            return _hqrrp_block_step(carry, c0 + ib * bsz, bsz, cfg,
                                     precision)
        return jax.lax.fori_loop(0, nblocks, block, carry)

    def make_group(gsz, off):
        def group(gi, carry):
            c_first = c0 + (off + gi * gsz) * bsz
            Vg = Ug = Hg = None
            for j in range(gsz):
                Vg, Ug, Hg, carry = _hqrrp_subblock_deferred(
                    carry, c_first + j * bsz, bsz, j, Vg, Ug, Hg, cfg,
                    precision)
            A, Y, G, Fstk, order, taus_g, retired, fail = carry
            # ONE wide k = gsz·b trailing update + the sketch-operator
            # catch-up (retired columns hold stale data that every read
            # masks out — their final packed values live in Fstk)
            live_end = 1.0 - retired
            from .bqrrp import _tp_matmul as _tpm
            A = A - _tpm(Vg, Ug * live_end[None, :],
                         cfg.trailing_precision, precision)
            G = G - jnp.matmul(Hg, Vg.T, precision=precision)
            return (A, Y, G, Fstk, order, taus_g, retired, fail)
        return group

    ngroups, grem = divmod(nblocks, g)
    if ngroups:
        carry = jax.lax.fori_loop(0, ngroups, make_group(g, 0), carry)
    if grem:
        carry = make_group(grem, ngroups * g)(0, carry)
    return carry


def _hqrrp_subblock_deferred(carry, c, bsz, j: int, Vg, Ug, Hg,
                             cfg: HQRRPConfig, precision):
    """One HQRRP block inside an update-deferred group (slot ``j``,
    static): pivot selection and the exact sketch downdate run per block,
    but the rank-b trailing update of A and the sketch-operator update of
    G are APPENDED to the group aggregates instead of applied.

    Telescoping identities (the same left-looking restructuring as
    bqrrp's subblock): with per-block WY factors (V_i, T_i) and
    U_i = T_iᵀ V_iᵀ A_(i-1),

        A_j = A_stale − Σ_{i≤j} V_i U_i          (on each block's live set)
        G_j = G_stale − Σ_{i≤j} H_i V_iᵀ,  H_i = (G_(i-1) V_i) T_i

    so the true panel, Wk, the R12 rows, and the exact sketch-downdate
    slice B = G_j[:, c:c+b] are all recoverable from the aggregates
    (Vg, Ug, Hg) with thin corrections — the wide k = defer·b GEMMs are
    applied once per group.
    """
    A, Y, G, Fstk, order, taus_g, retired, fail = carry
    m, n = A.shape
    d = Y.shape[0]
    live = 1.0 - retired

    # 1. pivots from the exact (per-block downdated) sketch
    chosen = qrcp_select_pivots(Y, bsz, live, precision)

    # 2. panel factorization on the lazily-corrected true panel
    panel = jnp.take(A, chosen, axis=1)
    if j > 0:
        panel = panel - jnp.matmul(Vg, jnp.take(Ug, chosen, axis=1),
                                   precision=precision)
    if cfg.panel_qr == PanelQR.cholqr:
        W, V, taus, sigma, failp = _cholqr_panel(panel, c, precision)
    else:
        W, V, taus, sigma = qrcp_panel(
            panel, c, pivot=(cfg.panel_qr == PanelQR.qrcp),
            precision=precision)
        failp = jnp.asarray(False)
    chosen = jnp.take(chosen, sigma)
    # packed GEQP3 column (R above, reflector tail below) goes into the
    # selection-order stack; A keeps its stale (masked-out) column — no
    # dynamic-index column scatter (see bqrrp._stage)
    Fstk = jax.lax.dynamic_update_slice(Fstk, W, (0, c))

    # 3. deferred trailing update: U = Tᵀ Vᵀ A_true on the live columns
    from .bqrrp import _tp_matmul
    T, Vz = wy_T(V, taus, precision)
    live2 = live.at[chosen].set(0.0)
    Wk = _tp_matmul(Vz.T, A * live2[None, :], cfg.trailing_precision,
                    precision)
    if j > 0:
        Wk = Wk - jnp.matmul(
            jnp.matmul(Vz.T, Vg, precision=precision),
            Ug * live2[None, :], precision=precision)
    U = jnp.matmul(T.T, Wk, precision=precision)

    # 4. exact sketch downdate from the lazily-corrected G
    GV = jnp.matmul(G, Vz, precision=precision)
    if j > 0:
        GV = GV - jnp.matmul(
            Hg, jnp.matmul(Vg.T, Vz, precision=precision),
            precision=precision)
    H = jnp.matmul(GV, T, precision=precision)            # (d, b)
    B = jax.lax.dynamic_slice(G, (0, c), (d, bsz))
    if j > 0:
        Vg_rows = jax.lax.dynamic_slice(Vg, (c, 0), (bsz, Vg.shape[1]))
        B = B - jnp.matmul(Hg, Vg_rows.T, precision=precision)
    Vz_rows = jax.lax.dynamic_slice(Vz, (c, 0), (bsz, bsz))
    B = B - jnp.matmul(H, Vz_rows.T, precision=precision)
    R12 = jax.lax.dynamic_slice(A, (c, 0), (bsz, n))
    if j > 0:
        R12 = R12 - jnp.matmul(Vg_rows, Ug, precision=precision)
    R12 = (R12 - jnp.matmul(Vz_rows, U, precision=precision)
           ) * live2[None, :]
    Y = Y - jnp.matmul(B, R12, precision=precision) * live2[None, :]

    # commit + aggregate
    order = jax.lax.dynamic_update_slice(order, chosen, (c,))
    taus_g = jax.lax.dynamic_update_slice(taus_g, taus, (c,))
    retired = retired.at[chosen].set(1.0)
    Vg = Vz if j == 0 else jnp.concatenate([Vg, Vz], axis=1)
    Ug = U if j == 0 else jnp.concatenate([Ug, U], axis=0)
    Hg = H if j == 0 else jnp.concatenate([Hg, H], axis=1)
    return Vg, Ug, Hg, (A, Y, G, Fstk, order, taus_g, retired,
                        fail | failp)


def _hqrrp_block_step(carry, c, bsz, cfg: HQRRPConfig, precision,
                      timer=None):
    """One HQRRP block (shared by the fused fori_loop and the timed
    block-split path — ``timer`` accumulates the reference's nested
    per-phase slots, rl_hqrrp.hh:1150-1160, when given)."""
    import contextlib
    from ..utils.timing import device_sync

    def _phase(name):
        return timer.phase(name) if timer is not None else (
            contextlib.nullcontext())

    A, Y, G, Fstk, order, taus_g, retired, fail = carry
    m, n = A.shape
    d = Y.shape[0]
    live = 1.0 - retired
    if cfg.shard_axis is not None:
        from jax.sharding import PartitionSpec as _P
        A = jax.lax.with_sharding_constraint(A, _P(cfg.shard_axis, None))
        G = jax.lax.with_sharding_constraint(G, _P(None, cfg.shard_axis))

    # 1. QRCP of the downdated sketch -> b pivots (lockstep-equivalent)
    with _phase("qrcp"):
        chosen = qrcp_select_pivots(Y, bsz, live, precision)
        if timer is not None:
            device_sync(chosen.astype(jnp.float32))

    # 2. panel factorization at row offset c
    with _phase("qr"):
        panel = jnp.take(A, chosen, axis=1)
        if cfg.panel_qr == PanelQR.cholqr:
            W, V, taus, sigma, failp = _cholqr_panel(panel, c, precision)
        else:
            W, V, taus, sigma = qrcp_panel(
                panel, c, pivot=(cfg.panel_qr == PanelQR.qrcp),
                precision=precision)
            failp = jnp.asarray(False)
        chosen = jnp.take(chosen, sigma)
        # selection-order stack, merged post-permutation (no dynamic-
        # index column scatter — see bqrrp._stage)
        Fstk = jax.lax.dynamic_update_slice(Fstk, W, (0, c))
        if timer is not None:
            device_sync(W)

    # 3. compact-WY trailing update on the remaining live columns
    # (nested slots per rl_hqrrp.hh's timing_QR vector: the T-factor
    # build is timed apart from the two trailing GEMMs)
    with _phase("wy_t"):
        T, Vz = wy_T(V, taus, precision)
        if timer is not None:
            device_sync(T)
    with _phase("updating_A"):
        from .bqrrp import _tp_matmul
        live2 = live.at[chosen].set(0.0)
        Wk = _tp_matmul(Vz.T, A * live2[None, :],
                        cfg.trailing_precision, precision)
        Upd = _tp_matmul(Vz, jnp.matmul(T.T, Wk, precision=precision),
                         cfg.trailing_precision, precision)
        A = A - Upd * live2[None, :]
        if timer is not None:
            device_sync(A)

    # 4. sketch downdate: G <- G.Q_blk; Y2 -= G_new[:, c:c+b].R12
    # (split: the d×m G rotation vs the d×n Y downdate — the reference's
    # updating_Sketch slot covers both, rl_hqrrp.hh:1152)
    with _phase("updating_sketch_g"):
        GV = jnp.matmul(G, Vz, precision=precision)
        G = G - jnp.matmul(jnp.matmul(GV, T, precision=precision), Vz.T,
                           precision=precision)
        if timer is not None:
            device_sync(G)
    with _phase("updating_sketch_y"):
        B = jax.lax.dynamic_slice(G, (0, c), (d, bsz))
        R12 = jax.lax.dynamic_slice(A, (c, 0), (bsz, n)) * live2[None, :]
        Y = Y - jnp.matmul(B, R12, precision=precision) * live2[None, :]
        if timer is not None:
            device_sync(Y)

    # commit
    with _phase("downdating"):
        order = jax.lax.dynamic_update_slice(order, chosen, (c,))
        taus_g = jax.lax.dynamic_update_slice(taus_g, taus, (c,))
        retired = retired.at[chosen].set(1.0)
    return A, Y, G, Fstk, order, taus_g, retired, fail | failp


def _hqrrp_core(A: jax.Array, cfg: HQRRPConfig, state: RNGState,
                precision=STABLE_PRECISION, timing: bool = False):
    """Shared core: returns ``(A_packed, taus, J, rank, fail, state[,
    phases])`` where ``A_packed`` is the pivoted matrix in LAPACK GEQP3
    layout (R in the upper triangle, reflector tails below)."""
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()

    m, n = A.shape
    K = min(m, n)
    b = min(cfg.block_size, K)
    d = b + cfg.oversample
    dtype = A.dtype
    nb_full, r = divmod(K, b)

    with _phase("sketch"):
        # uniform sketch, as the reference (ScalarDist::Uniform, :929)
        key, state = state.spawn()
        G = jax.random.uniform(key, (d, m), dtype=dtype, minval=-1.0,
                               maxval=1.0)
        Y = jnp.matmul(G, A, precision=precision)
        if timing:
            device_sync(Y)

    order = jnp.zeros((K,), jnp.int32)
    taus_g = jnp.zeros((K,), dtype)
    retired = jnp.zeros((n,), dtype)
    fail = jnp.asarray(False)
    # packed pivot columns in selection order (= post-permutation layout);
    # merged as ONE static-slice set in the epilogue
    Fstk = jnp.zeros((m, K), dtype)

    with _phase("blocks"):
        carry = (A, Y, G, Fstk, order, taus_g, retired, fail)
        if timing and cfg.update_defer > 1:
            # the timed route is the eager per-block step — a deferred
            # config would measure a different execution structure than
            # the one being benchmarked, so say so loudly
            import warnings
            warnings.warn(
                "hqrrp(timing=True) forces eager trailing updates; "
                f"cfg.update_defer={cfg.update_defer} is ignored in the "
                "phase breakdown (time deferred configs with timing=False "
                "whole-run aggregates instead)", stacklevel=3)
        if timing:
            # block-split run with the nested per-phase slots accumulated
            # (qrcp / qr / updating_A / updating_sketch / downdating — the
            # reference's 26-slot vector collapsed to its top-level
            # per-iteration phases, rl_hqrrp.hh:1150-1160)
            for ib in range(nb_full):
                carry = _hqrrp_block_step(carry, ib * b, b, cfg,
                                          precision, timer)
            if r:
                carry = _hqrrp_block_step(carry, nb_full * b, r, cfg,
                                          precision, timer)
        else:
            if nb_full:
                carry = _hqrrp_blocks(*carry, 0, nb_full, b, cfg,
                                      precision)
            if r:
                carry = _hqrrp_blocks(*carry, nb_full * b, 1, r, cfg,
                                      precision)
        A, Y, G, Fstk, order, taus_g, retired, fail = carry
        if timing:
            device_sync(A)

    with _phase("epilogue"):
        # pivots to the front in selection order; the rest keep relative
        # order (only reachable when n > K)
        pos = jnp.zeros((n,), jnp.int32).at[order].set(
            jnp.arange(K, dtype=jnp.int32))
        key_ = jnp.where(retired > 0, pos, K + jnp.arange(n))
        perm = jnp.argsort(key_)
        A_perm = jnp.take(A, perm, axis=1)
        # the front K columns are the stacked packed pivot columns
        A_perm = A_perm.at[:, :K].set(Fstk)
        J = perm.astype(jnp.int32)
        if timing:
            device_sync(A_perm)

    diag = jnp.diag(A_perm[:K, :K])
    eps = jnp.finfo(dtype).eps
    tol = jnp.abs(diag[0]) * jnp.sqrt(jnp.asarray(eps, dtype))
    rank = util.naive_rank_est(diag, tol)
    if timing:
        return A_perm, taus_g, J, rank, fail, state, timer.report()
    return A_perm, taus_g, J, rank, fail, state


def hqrrp(A: jax.Array, cfg: HQRRPConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False):
    """Randomized-pivoting Householder QR of A (any aspect ratio, any
    size): A[:, J] ≈ Q R.

    Returns ``(Q, R, J, rank, fail, next_state)`` — same contract as
    :func:`randlapack_tpu.drivers.bqrrp.bqrrp`: Q (m, K) orthonormal
    (K = min(m, n)), R (K, n) upper-trapezoidal, J (n,) int32 pivots,
    ``rank`` an int32 upper-bound estimate from diag(R), ``fail`` the
    CholQR-panel breakdown flag (always False for Householder panels).

    Q is a product of exact Householder reflectors — orthogonality is
    machine-grade with no re-orthogonalization pass.

    ``timing=True`` appends a phase-metrics dict (sketch / blocks /
    epilogue — the reference's 26-slot vector collapsed to the phases
    of this static-shape design, rl_hqrrp.hh:1150-1160).
    """
    out = _hqrrp_core(A, cfg, state, precision, timing)
    A_perm, taus, J, rank, fail, state = out[:6]
    m, n = A_perm.shape
    K = min(m, n)
    R = jnp.triu(A_perm[:K, :])
    packed = jnp.tril(A_perm[:, :K], -1) + jnp.eye(m, K, dtype=A.dtype)
    Q = jax.lax.linalg.householder_product(packed, taus)
    if timing:
        return Q, R, J, rank, fail, state, out[6]
    return Q, R, J, rank, fail, state


def hqrrp_lapack_format(A: jax.Array, cfg: HQRRPConfig, state: RNGState,
                        precision=STABLE_PRECISION):
    """GEQP3-compatible output: ``(packed, taus, R, J, next_state)`` with
    the implicit-Q reflector representation — HQRRP's native form (the
    reference overwrites A with exactly this layout and is "almost
    compatible with LAPACK's dgeqp3", rl_hqrrp.hh:778-779).

    ``packed`` is (m, K) with reflector tails strictly below the diagonal
    (unit heads implicit); apply via
    :func:`randlapack_tpu.ops.householder.apply_reflectors`.
    """
    A_perm, taus, J, rank, fail, state = _hqrrp_core(A, cfg, state,
                                                     precision)
    m, n = A_perm.shape
    K = min(m, n)
    R = jnp.triu(A_perm[:K, :])
    packed = jnp.tril(A_perm[:, :K], -1)
    return packed, taus, R, J, state
