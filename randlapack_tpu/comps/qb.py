"""Blocked QB factorization (reference: RandLAPACK/comps/rl_qb.hh: QBalg
:18, QB::call :134 — grow Q,B by b_sz columns per iteration, Gram-Schmidt
re-orth against previous blocks, Frobenius error tracking, early stop).

Design (SURVEY.md §7 "dynamic shapes"): outputs are preallocated at
max rank k and filled blockwise inside one jitted fori_loop — no realloc
growth. Adaptive termination is done by the caller from the returned
per-block error vector (``qb`` helper), keeping the hot loop fully static.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from .orth import Stab, orth
from .rf import RFConfig, rf


@dataclasses.dataclass(frozen=True)
class QBConfig:
    rf: RFConfig = RFConfig()
    orth: Stab = Stab.cholqr2     # re-orthogonalization method
    block_size: int = 64


@partial(jax.jit, static_argnames=("k", "cfg", "precision"))
def qb_blocked(A: jax.Array, k: int, cfg: QBConfig, state: RNGState,
               precision=STABLE_PRECISION):
    """Fixed-rank blocked QB: A ≈ Q B with Q (m,k) orthonormal, B (k,n).

    Returns ``(Q, B, block_errs, next_state)`` where ``block_errs[i]`` is
    ‖A − Q_{:(i+1)b} B_{:(i+1)b}‖_F / ‖A‖_F after block i — the caller
    truncates to the first block meeting its tolerance (adaptive-rank
    behavior with a static compute graph).
    """
    m, n = A.shape
    b = cfg.block_size
    assert k % b == 0, "k must be a multiple of block_size"
    nblocks = k // b
    norm_A = jnp.linalg.norm(A)

    Q = jnp.zeros((m, k), A.dtype)
    B = jnp.zeros((k, n), A.dtype)
    # errs starts at a 2.0 sentinel (> any relative error) so block 0 can
    # read errs[-1 -> 0] as its "previous error" WITHOUT comparing the
    # loop induction variable: scalar predicates on the fori_loop index
    # (i > 0) were hoisted as loop-invariant and miscompiled by an earlier
    # backend (evaluated True at i=0); array-vs-index comparisons are
    # safe everywhere (ROADMAP D2 re-measures the workaround).
    errs = jnp.full((nblocks,), 2.0, A.dtype)

    # fori_loop-safe RNG: per-block independent streams branched off `state`
    base = state

    eps = jnp.finfo(A.dtype).eps
    tol_orth = 100.0 * jnp.sqrt(eps) * jnp.sqrt(float(b))

    def block(i, carry):
        A_work, Q, B, errs, stopped = carry
        bstate = base.branch(i)  # independent per-block stream
        Qi, _ = rf(A_work, b, cfg.rf, bstate, precision)
        # re-orthogonalize against all previous blocks (zeros in unfilled
        # columns of Q are no-ops): Qi ← Qi − Q (Qᵀ Qi), then re-orth
        proj = jnp.matmul(Q.T, Qi, precision=precision)
        Yi = Qi - jnp.matmul(Q, proj, precision=precision)
        Qi, fail = orth(Yi, cfg.orth, precision)
        Qi = jax.lax.cond(fail,
                          lambda y: orth(y, Stab.hqr, precision)[0],
                          lambda y: Qi, Yi)
        Bi = jnp.matmul(Qi.T, A_work, precision=precision)
        A_next = A_work - jnp.matmul(Qi, Bi, precision=precision)
        new_err = jnp.linalg.norm(A_next) / norm_A
        # at i=0 this reads the 2.0 sentinel (see errs init above)
        prev_err = errs[jnp.maximum(i - 1, 0)]
        # in-loop early-stop conditions (rl_qb.hh:228, codes 3-4): error
        # growth or orthogonality loss of the new block — the reference
        # discards the offending block and returns the previous iterate;
        # here the loop freezes (all later blocks are no-ops), which is
        # the static-shape equivalent.
        grew = new_err > prev_err * (1.0 + 100.0 * eps)
        orth_err = jnp.linalg.norm(
            jnp.matmul(Qi.T, Qi, precision=precision)
            - jnp.eye(b, dtype=A.dtype))
        lost = orth_err > tol_orth
        stop_now = stopped | grew | lost
        keep = jnp.where(stop_now, 0.0, 1.0).astype(A.dtype)
        A_work = A_work * (1.0 - keep) + A_next * keep
        Q = jax.lax.dynamic_update_slice(Q, Qi * keep, (0, i * b))
        B = jax.lax.dynamic_update_slice(B, Bi * keep, (i * b, 0))
        frozen_val = jnp.minimum(prev_err, 1.0)
        errs = errs.at[i].set(jnp.where(stop_now, frozen_val, new_err))
        return A_work, Q, B, errs, stop_now

    _, Q, B, errs, stopped = jax.lax.fori_loop(
        0, nblocks, block, (A, Q, B, errs, jnp.asarray(False)))
    # advance the counter so later branch()/spawn() streams differ from the
    # per-block streams consumed above (branch folds the counter in)
    return Q, B, errs, base.spawn()[1]


# Status codes mirroring the reference QB's return codes 0–6
# (rl_qb.hh:193-256): the subset meaningful under the static design.
QB_OK = 0                 # tolerance met within rank budget
QB_RANK_EXHAUSTED = 1     # ran to rank k without reaching tol
QB_ERROR_GREW = 2         # blockwise error increased -> loop froze
QB_STAGNATED = 3          # error history froze before the rank budget
                          # (in-loop growth/orthogonality stop tripped)


def qb(A: jax.Array, k: int, cfg: QBConfig, state: RNGState, tol: float = 0.0,
       precision=STABLE_PRECISION):
    """Adaptive QB: runs the blocked factorization and truncates at the
    first block whose relative Frobenius error is ≤ tol (or rank k).

    Returns ``(Q, B, rank, err, next_state)`` — Q, B are sliced on host.
    Use :func:`qb_status` on the full error history for the reference's
    return-code diagnostics.
    """
    b = cfg.block_size
    k_pad = -(-k // b) * b
    Q, B, errs, state = qb_blocked(A, k_pad, cfg, state, precision)
    errs_h = jax.device_get(errs)
    nb = len(errs_h)
    stop = next((i for i in range(nb) if errs_h[i] <= tol), nb - 1)
    rank = min((stop + 1) * b, k)
    return Q[:, :rank], B[:rank, :], rank, float(errs_h[stop]), state


def qb_status(errs, tol: float) -> int:
    """Diagnose a blocked-QB error history (reference return codes).

    The in-loop stop (qb_blocked) freezes the history on error growth or
    orthogonality loss, so a flat tail before the budget signals the
    tripped condition (codes 3-4 analogue)."""
    import numpy as np
    e = np.asarray(errs)
    if np.any(np.diff(e) > 1e-12):
        return QB_ERROR_GREW
    if e.min() <= tol:
        return QB_OK
    flat = np.isclose(np.diff(e), 0.0, atol=0.0)
    if len(e) > 1 and flat[-1] and not flat.all():
        return QB_STAGNATED
    return QB_RANK_EXHAUSTED
