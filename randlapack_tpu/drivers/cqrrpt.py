"""CQRRPT — CholeskyQR with randomized pivoting for tall matrices
(reference: RandLAPACK/drivers/rl_cqrrpt.hh: CQRRPTalg :21, CQRRPT::call
:147; algorithm of arXiv:2311.08316):

    1. SASO sketch A_sk = S·A (d×n, d = d_factor·n)        [:214-222]
    2. QRCP on the small sketch                             [:230-248]
    3. rank estimate from diag(R_sk)                        [:267-272]
    4. pivot A, precondition A·R_sk⁻¹, CholQR               [:287-332]
    5. un-precondition R = R_chol·R_sk                      [:338-345]

Design: all static shapes — the rank estimate is *returned* rather
than used to shrink arrays (callers slice on host); the QRCP-on-sketch
subroutine is selectable (scan-based geqp3, HQRRP, or BQRRP for bigger n).
``timing=True`` reproduces the reference's 8-slot timing vector
(rl_cqrrpt.hh:370-383: saso / qrcp / rank_reveal / a_mod_piv / a_mod_trsm
/ cholqr / orth / total) as a named phase dict.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..sketching import SparseDist, fill_sparse, saso_left_apply

from ..ops.qr import geqp3
from ..ops import util


class QRCPKind(enum.Enum):
    """QRCP subroutine for the sketch — the reference's three-way switch
    (rl_cqrrpt.hh:230-248, CQRRPTSubroutines::QRCP {geqp3,hqrrp,bqrrp})."""
    geqp3 = "geqp3"       # scan-based pivoted Householder on the sketch
    hqrrp = "hqrrp"       # Householder QR with randomized pivoting
    bqrrp = "bqrrp"       # blocked randomized QRCP (for larger n)


@dataclasses.dataclass(frozen=True)
class CQRRPTConfig:
    d_factor: float = 1.25
    vec_nnz: int = 2
    sketch: str = "saso"          # "saso" | "srht" | "gaussian"
    qrcp: QRCPKind = QRCPKind.geqp3
    bqrrp_block: int = 128        # block size when qrcp == bqrrp/hqrrp
    bqrrp_stages: int = 1         # shrinking-width stages for the sketch
                                  # BQRRP (the headline's stages=2 knob)
    bqrrp_pivot_candidates: int | None = None  # sketch-BQRRP candidate
                                               # preselection multiple
    bqrrp_trailing_precision: str = "highest"
                                  # sketch-BQRRP trailing-update GEMM
                                  # precision (drivers/bqrrp.py knob) —
                                  # its trailing A_work GEMM does not
                                  # touch the R rows used as the
                                  # preconditioner
    bqrrp_update_defer: int = 1   # sketch-BQRRP aggregated trailing
                                  # updates (k = defer·b GEMMs instead
                                  # of thin b-wide ones)
    eps_rank: float | None = None  # rank-estimate threshold (None → machine)
    orthogonalization: bool = False  # complete a rank-deficient basis to a
                                     # full orthonormal Q with projected
                                     # Gaussians (rl_cqrrpt.hh:343-368)
    q_form: str = "inverse"       # how Q = A_pre·L⁻ᵀ is formed in the
                                  # CholQR phase: "inverse" inverts the
                                  # n×n Cholesky factor (tiny trsm vs I)
                                  # and applies it as ONE m×n GEMM;
                                  # "trsm" is the classic m×n triangular
                                  # solve. L is the factor of the
                                  # PRECONDITIONED Gram — κ(L) ≈ sketch
                                  # distortion = O(1) — so the explicit
                                  # inverse loses nothing
    gram_block: int = 512         # >0: compute the CholQR Gram with
                                  # ops/cholqr.py::gram_syrk at this
                                  # column-block size — only the upper-
                                  # triangular blocks (the BLAS syrk flop
                                  # saving the reference gets from
                                  # cblas_syrk, rl_cqrrpt.hh:310; 5/8 of
                                  # the full GEMM's flops at 4 blocks).
                                  # 0 = one full AᵀA GEMM; shapes that
                                  # don't block evenly fall back to it
    trsm_mode: str = "xla"        # a_mod_trsm implementation: "xla" =
                                  # lax triangular_solve (backward-
                                  # stable); "blockinv" = partitioned-
                                  # inverse trsm (ops/trsm.py — inverts
                                  # only the b×b diagonal blocks of
                                  # R_sk, back-substitution recurrence
                                  # as GEMMs, the cuBLAS/MAGMA
                                  # restructure). blockinv amplifies by
                                  # κ(diag block) ≈ κ(R)^(b/n) instead
                                  # of being backward-stable — fine for
                                  # pivoted R with spread-out decay
    trsm_block: int = 256         # diagonal-block size for blockinv


# --- phases (shared by the fused jit path and the timed path) -------------

@partial(jax.jit, static_argnames=("cfg", "precision"))
def _sketch_phase(A, cfg: CQRRPTConfig, state, precision):
    m, n = A.shape
    d = int(cfg.d_factor * n)
    if d >= m:
        # near-square input: a "sketch" with d >= m rows is pointless (and
        # the short-axis SASO convention breaks) — use A itself, the exact
        # zero-distortion sketch (the reference requires m >> n here)
        return A, state
    if cfg.sketch == "saso":
        op, state = fill_sparse(SparseDist(d, m, cfg.vec_nnz), state,
                                dtype=A.dtype)
        A_sk = saso_left_apply(op, A)
    elif cfg.sketch == "srht":
        from ..sketching import srht_left_apply, srht_skop
        op, state = srht_skop(d, m, state, dtype=A.dtype)
        A_sk = srht_left_apply(op, A, precision=precision)
    else:
        import math
        key, state = state.spawn()
        S = jax.random.normal(key, (d, m), dtype=A.dtype) / math.sqrt(d)
        A_sk = jnp.matmul(S, A, precision=precision)
    return A_sk, state


def _qrcp_phase(A_sk, cfg: CQRRPTConfig, state, precision):
    n = A_sk.shape[1]
    if cfg.qrcp == QRCPKind.geqp3:
        _, R_sk, J = geqp3(A_sk, want_q=False, precision=precision)
    elif cfg.qrcp == QRCPKind.hqrrp:
        from .hqrrp import HQRRPConfig, hqrrp_lapack_format
        _, _, R_sk, J, state = hqrrp_lapack_format(
            A_sk, HQRRPConfig(block_size=cfg.bqrrp_block), state,
            precision)
        R_sk = R_sk[:n, :]
    else:
        # the EXPLICIT driver on purpose: its final-orth pass re-couples
        # R to an orthonormalized Q at working precision, which matters
        # here because R_sk becomes the CholQR preconditioner — the
        # factored form's R (no final-orth) degraded the final
        # orthogonality 9.8e-5 -> 2.3e-3 at 131072x2048 f32
        from .bqrrp import BQRRPConfig, bqrrp
        _, R_sk, J, _, _, state = bqrrp(
            A_sk, BQRRPConfig(block_size=cfg.bqrrp_block,
                              stages=cfg.bqrrp_stages,
                              pivot_candidates=cfg.bqrrp_pivot_candidates,
                              update_defer=cfg.bqrrp_update_defer,
                              trailing_precision=(
                                  cfg.bqrrp_trailing_precision)),
            state, precision)
        R_sk = R_sk[:n, :]
    return R_sk, J, state


@partial(jax.jit, static_argnames=("cfg",))
def _rank_phase(R_sk, cfg: CQRRPTConfig):
    # the reference truncates where R[i,i]/R[0,0] < eps just to keep the
    # preconditioner invertible (rl_cqrrpt.hh:263-272); the *real* rank
    # comes a posteriori
    n = R_sk.shape[1]
    dtype = R_sk.dtype
    eps = cfg.eps_rank or float(jnp.finfo(dtype).eps)
    diag = jnp.abs(jnp.diag(R_sk))
    rank = util.naive_rank_est(jnp.diag(R_sk), diag[0] * eps)
    keep = (jnp.arange(n) < rank).astype(dtype)
    dsafe = jnp.where(keep > 0, jnp.diag(R_sk), 1.0)
    R_sk_safe = (jnp.triu(R_sk) - jnp.diag(jnp.diag(R_sk))
                 + jnp.diag(dsafe))
    return rank, keep, R_sk_safe


@jax.jit
def _piv_phase(A, J):
    return util.col_swap(A, J)


@partial(jax.jit, static_argnames=("mode", "block", "precision"))
def _trsm_phase(A_piv, R_sk_safe, keep, mode="xla", block=256,
                precision=None):
    if mode == "blockinv":
        from ..ops.trsm import trsm_right_upper_blockinv
        A_pre = trsm_right_upper_blockinv(A_piv, R_sk_safe, block,
                                          precision)
    else:
        A_pre = jax.lax.linalg.triangular_solve(
            R_sk_safe, A_piv, left_side=False, lower=False)
    return A_pre * keep[None, :]


@partial(jax.jit, static_argnames=("block", "precision"))
def _trsm_phase_gather(A, J, R_sk_safe, keep, block=256, precision=None):
    # blockinv production path: the pivot gather A[:, J] is folded into
    # the per-block reads of the back-substitution (ops/trsm.py ``cols``)
    # so the permuted m×n operand never materializes — removes the
    # a_mod_piv pass's ~2·m·n·4 bytes of HBM traffic. (The timed path
    # keeps the separate gather so the 8-slot reference timing vector
    # stays comparable, rl_cqrrpt.hh:370-383.)
    from ..ops.trsm import trsm_right_upper_blockinv
    A_pre = trsm_right_upper_blockinv(A, R_sk_safe, block, precision,
                                      cols=J)
    return A_pre * keep[None, :]


def _cholqr_gram(A_pre, keep, precision, gram_block=0):
    # band guard (ops/cholqr.py::_finite_scaled): the trsm against the
    # clamped R_sk diagonal can leave huge/Inf columns on deficient
    # inputs, and a Gram overflow would reach the Cholesky
    from ..ops.cholqr import _finite_scaled, gram_syrk
    A_pre, s, nonfin = _finite_scaled(A_pre)
    if gram_block > 0:
        G = gram_syrk(A_pre, precision, gram_block) + jnp.diag(1.0 - keep)
    else:
        G = (jnp.matmul(A_pre.T, A_pre, precision=precision)
             + jnp.diag(1.0 - keep))
    return A_pre, G, s, nonfin


def _cholqr_qform(A_pre, L, q_form, precision):
    if q_form == "inverse":
        # L factors the PRECONDITIONED Gram: κ(L) ~ the sketch distortion,
        # O(1) — the explicit n×n inverse is backward-stable here and the
        # m×n application is one GEMM instead of a trsm
        n = A_pre.shape[1]
        Linv_t = jax.lax.linalg.triangular_solve(
            L.T, jnp.eye(n, dtype=A_pre.dtype), left_side=True,
            lower=False)
        return jnp.matmul(A_pre, Linv_t, precision=precision)
    return jax.lax.linalg.triangular_solve(
        L.T, A_pre, left_side=False, lower=False)


@partial(jax.jit, static_argnames=("q_form", "precision", "gram_block"))
def _cholqr_phase(A_pre, keep, R_sk_safe, q_form, precision,
                  gram_block=0):
    # static-shape rank deficiency: zeroed columns + identity trailing
    # block in the Gram — Cholesky nests, so the leading rank×rank factor
    # matches the reference's shrunken computation exactly
    A_pre, G, s, nonfin = _cholqr_gram(A_pre, keep, precision, gram_block)
    L = jax.lax.linalg.cholesky(G)
    fail = jnp.any(jnp.isnan(L)) | nonfin
    Q = _cholqr_qform(A_pre, L, q_form, precision)
    R = jnp.matmul(L.T * s, R_sk_safe, precision=precision)
    return Q, R, fail


@partial(jax.jit, static_argnames=("precision",))
def _orth_phase(Q, keep, key, fail, precision):
    # basis completion (rl_cqrrpt.hh:343-368): replace the zeroed trailing
    # columns with Gaussians projected against the leading rank columns,
    # orthonormalized by CholQR (all n candidates completed, rank-masked)
    G_rand = jax.random.normal(key, Q.shape, dtype=Q.dtype)
    Qk = Q * keep[None, :]
    for _ in range(2):  # two projection passes (BCGS2)
        G_rand = G_rand - jnp.matmul(
            Qk, jnp.matmul(Qk.T, G_rand, precision=precision),
            precision=precision)
    from ..ops.cholqr import cholqr2
    Qc, _, f2 = cholqr2(G_rand, precision)
    return jnp.where(keep[None, :] > 0, Q, Qc), fail | f2


_cholqr_gram_jit = partial(jax.jit,
                           static_argnames=("precision", "gram_block"))(
    _cholqr_gram)
_potrf_jit = jax.jit(jax.lax.linalg.cholesky)
_qform_jit = partial(jax.jit, static_argnames=("q_form", "precision"))(
    _cholqr_qform)


@partial(jax.jit, static_argnames=("precision",))
def _unprec_jit(L, s, R_sk_safe, precision):
    return jnp.matmul(L.T * s, R_sk_safe, precision=precision)


def cqrrpt(A: jax.Array, cfg: CQRRPTConfig, state: RNGState,
           precision=STABLE_PRECISION, timing: bool = False):
    """Pivoted QR of tall A: A[:, J] ≈ Q R.

    Returns ``(Q, R, J, rank, fail, next_state)`` — Q (m,n) orthonormal,
    R (n,n) upper-triangular, J (n,) int32 pivots, ``rank`` the estimated
    numerical rank (int32 scalar; columns of Q / rows of R beyond it are
    garbage exactly as in the reference's truncated outputs — slice on
    host), ``fail`` the CholQR breakdown flag.

    ``timing=True`` appends the 8-phase metrics dict (synchronizes
    between phases — measurement mode only).
    """
    from ..errors import require
    require(A.shape[0] >= A.shape[1],
            "cqrrpt requires a tall input (m >= n, the reference's "
            "CQRRPT contract, rl_cqrrpt.hh) — got "
            f"{A.shape}; use hqrrp/bqrrp for wide matrices")
    from ..utils.timing import PhaseTimer, device_sync
    timer = PhaseTimer() if timing else None

    def _phase(name):
        import contextlib
        return timer.phase(name) if timing else contextlib.nullcontext()

    with _phase("saso"):
        A_sk, state = _sketch_phase(A, cfg, state, precision)
        if timing:
            device_sync(A_sk)
    with _phase("qrcp"):
        R_sk, J, state = _qrcp_phase(A_sk, cfg, state, precision)
        if timing:
            device_sync(R_sk)
    with _phase("rank_reveal"):
        rank, keep, R_sk_safe = _rank_phase(R_sk, cfg)
        if timing:
            device_sync(R_sk_safe)
    if cfg.trsm_mode == "blockinv" and not timing:
        with _phase("a_mod_trsm"):
            A_pre = _trsm_phase_gather(A, J, R_sk_safe, keep,
                                       cfg.trsm_block, precision)
    else:
        with _phase("a_mod_piv"):
            A_piv = _piv_phase(A, J)
            if timing:
                device_sync(A_piv)
        with _phase("a_mod_trsm"):
            A_pre = _trsm_phase(A_piv, R_sk_safe, keep, cfg.trsm_mode,
                                cfg.trsm_block, precision)
            if timing:
                device_sync(A_pre)
    with _phase("cholqr"):
        if timing:
            # sub-slot split (VERDICT r4 item 3: the slot became the
            # dominant phase — name where the time goes). Same math as
            # the fused _cholqr_phase, synced between pieces.
            with _phase("cholqr_gram"):
                A_pre2, G, s, nonfin = _cholqr_gram_jit(
                    A_pre, keep, precision, cfg.gram_block)
                device_sync(G)
            with _phase("cholqr_potrf"):
                L = _potrf_jit(G)
                device_sync(L)
            with _phase("cholqr_qform"):
                Q = _qform_jit(A_pre2, L, cfg.q_form, precision)
                device_sync(Q)
            with _phase("cholqr_unprec"):
                R = _unprec_jit(L, s, R_sk_safe, precision)
                fail = jnp.any(jnp.isnan(L)) | nonfin
                device_sync(R)
        else:
            Q, R, fail = _cholqr_phase(A_pre, keep, R_sk_safe,
                                       cfg.q_form, precision,
                                       cfg.gram_block)
    if cfg.orthogonalization:
        with _phase("orth"):
            key, state = state.spawn()
            Q, fail = _orth_phase(Q, keep, key, fail, precision)
            if timing:
                device_sync(Q)
    if timing:
        return Q, R, J, rank, fail, state, timer.report()
    return Q, R, J, rank, fail, state
