"""QR kernels: Householder wrappers, scan-based column-pivoted QR (geqp3
equivalent — XLA has no pivoted-QR primitive, SURVEY.md §7 "hard parts"),
and LU-based pivot selection (the reference BQRRP's default ``luqr``
qrcp_wide, rl_bqrrp.hh:339-356).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


def qr_econ(A: jax.Array):
    """Economy Householder QR → (Q, R). Wraps lax.linalg.qr."""
    return jax.lax.linalg.qr(A, full_matrices=False)


def _larfg(x: jax.Array, i):
    """Householder reflector annihilating x[i+1:] with rows < i masked out.

    LAPACK larfg semantics, jit-safe with traced i.
    Returns (v, tau, alpha): v normalized so v[i] = 1 (zeros in rows < i),
    H = I − tau·v·vᵀ, H x = alpha·e_i (on the masked part).
    """
    m = x.shape[0]
    rows = jnp.arange(m)
    xm = jnp.where(rows >= i, x, 0)
    xi = x[i]
    normx = jnp.linalg.norm(xm)
    sign = jnp.where(xi >= 0, 1.0, -1.0).astype(x.dtype)
    alpha = -sign * normx
    denom = xi - alpha
    safe = jnp.abs(denom) > 0
    denom_s = jnp.where(safe, denom, 1.0)
    v = jnp.where(rows > i, xm / denom_s, 0.0)
    v = v.at[i].set(1.0)
    tau = jnp.where(safe, (alpha - xi) / jnp.where(alpha != 0, alpha, 1.0), 0.0)
    tau = jnp.where(normx > 0, tau, 0.0)
    alpha = jnp.where(normx > 0, alpha, xi)
    return v, tau.astype(x.dtype), alpha.astype(x.dtype)


@partial(jax.jit, static_argnames=("k", "want_q", "pivot", "precision"))
def geqp3(A: jax.Array, k: int | None = None, want_q: bool = True,
          pivot: bool = True, precision=STABLE_PRECISION):
    """Column-pivoted Householder QR (GEQP3 capability).

    Sequential over (at most) k columns with greedy max-norm pivoting and
    squared-norm downdating (the reference's HQRRP panel kernel
    ``NoFLA_QRPmod_WY_unb_var4`` uses the same math, rl_hqrrp.hh:360,557 —
    redesigned here as a lax.fori_loop of full-width masked rank-1 updates,
    which is how a column-sequential factorization stays static-shaped
    under jit).

    Returns ``(Q, R, J)``: Q (m×k) explicit orthonormal (or None if
    ``want_q=False``), R (k×n) upper-trapezoidal *of the pivoted matrix*,
    J (n,) int32 with A[:, J] ≈ Q R.

    Cost: O(m n k) VPU (rank-1) work — use only on small/sketch matrices;
    large pivoted QR should go through BQRRP.
    """
    m, n = A.shape
    if k is None:
        k = min(m, n)
    k = min(k, min(m, n))
    dtype = A.dtype

    def step(i, carry):
        Awork, V, taus, J, cn2 = carry
        cols = jnp.arange(n)
        if pivot:
            # 1. pivot selection on downdated squared norms
            # finite penalty, NOT -inf: an earlier backend miscompiled inf
            # constants inside fori_loop to 0 (cn2 >= 0 always)
            masked = jnp.where(cols >= i, cn2, -1.0)
            p = jnp.argmax(masked)
            # 2. swap columns i <-> p (gather-free swap via where)
            perm = jnp.where(cols == i, p, jnp.where(cols == p, i, cols))
            Awork = jnp.take(Awork, perm, axis=1)
            J = jnp.take(J, perm)
            cn2 = jnp.take(cn2, perm)
        # 3. reflector for column i
        v, tau, alpha = _larfg(Awork[:, i], i)
        # 4. apply H = I − tau v vᵀ to columns ≥ i
        w = tau * jnp.matmul(v, Awork, precision=precision)  # (n,)
        w = jnp.where(cols >= i, w, 0.0)
        Awork = Awork - jnp.outer(v, w)
        # 5. clean column i: alpha at (i, i), zeros below
        coli = jnp.where(jnp.arange(m) < i, Awork[:, i], 0.0).at[i].set(alpha)
        Awork = Awork.at[:, i].set(coli)
        # 6. store reflector, downdate norms
        V = V.at[:, i].set(v)
        taus = taus.at[i].set(tau)
        cn2 = jnp.where(cols > i, jnp.maximum(cn2 - Awork[i, :] ** 2, 0.0),
                        cn2)
        return Awork, V, taus, J, cn2

    carry = (A,
             jnp.zeros((m, k), dtype),
             jnp.zeros((k,), dtype),
             jnp.arange(n, dtype=jnp.int32),
             jnp.sum(A * A, axis=0))
    Awork, V, taus, J, _ = jax.lax.fori_loop(0, k, step, carry)

    R = jnp.triu(Awork[:k, :])
    Q = None
    if want_q:
        packed = jnp.tril(V, -1) + jnp.eye(m, k, dtype=dtype)
        Q = jax.lax.linalg.householder_product(packed, taus)
    return Q, R, J


def _drmac_downdate(W, i, r_row, dN, eN, update_mask):
    """Drmač partial-norm downdating with cancellation-triggered exact
    recompute (reference: rl_hqrrp.hh::NoFLA_QRP_downdate_partial_norms
    :360-411 — LAPACK dlaqp2's xLAQPS update rule).

    ``W``: current (rows × cols) working matrix after step ``i``'s
    reflector; ``r_row`` = W[i, :] (the new R row); ``dN``/``eN`` the
    partial/reference norm vectors; ``update_mask`` bool (cols,) selecting
    which columns to downdate. Returns (dN, eN).
    """
    dtype = W.dtype
    tol3z = jnp.sqrt(jnp.finfo(dtype).eps)
    rows = jnp.arange(W.shape[0])
    # exact trailing norms (rows > i) — feeds the recompute branch; the
    # full masked reduction replaces data-dependent control flow
    trail = jnp.sqrt(jnp.sum(
        jnp.where(rows[:, None] > i, W, 0.0) ** 2, axis=0))
    dsafe = jnp.where(dN > 0, dN, 1.0)
    esafe = jnp.where(eN > 0, eN, 1.0)
    temp = jnp.abs(r_row) / dsafe
    temp = jnp.maximum(0.0, (1.0 + temp) * (1.0 - temp))
    temp5 = dN / esafe
    temp2 = temp * temp5 * temp5
    recompute = temp2 <= tol3z
    d_new = jnp.where(recompute, trail, dN * jnp.sqrt(temp))
    e_new = jnp.where(recompute, trail, eN)
    keep = (~update_mask) | (dN == 0)
    dN = jnp.where(keep, dN, d_new)
    eN = jnp.where(keep, eN, e_new)
    return dN, eN


def qrcp_select_pivots(Y: jax.Array, nsteps: int, live: jax.Array,
                       precision=STABLE_PRECISION):
    """Greedy Householder-QRCP pivot selection on a small (d × n) sketch,
    restricted to ``live`` columns — the reference HQRRP's per-block QRCP
    of the downdated sketch (rl_hqrrp.hh::NoFLA_QRPmod_WY_unb_var4 :557,
    pivoting=1 path) with Drmač norm downdating (:360).

    Columns are never physically swapped: step ``l``'s reflector is built
    from pivot column ``p_l`` on rows ≥ l and applied to the remaining
    eligible columns; the accumulated pivot list is the same permutation
    the reference's lockstep three-matrix swaps produce.

    Returns ``chosen`` — (nsteps,) int32 global column indices in pivot
    order.
    """
    d, n = Y.shape
    dtype = Y.dtype
    cols = jnp.arange(n)
    livef = live > 0
    W0 = jnp.where(livef[None, :], Y, 0.0)
    d0 = jnp.linalg.norm(W0, axis=0)

    def step(i, carry):
        W, dN, eN, avail, chosen = carry
        p = jnp.argmax(jnp.where(avail, dN, -1.0))
        chosen = chosen.at[i].set(p.astype(jnp.int32))
        avail = avail & (cols != p)
        v, tau, _ = _larfg(W[:, p], i)
        w = tau * jnp.matmul(v, W, precision=precision)
        w = jnp.where(avail, w, 0.0)  # transform remaining eligible cols
        W = W - jnp.outer(v, w)
        dN, eN = _drmac_downdate(W, i, W[i, :], dN, eN, avail)
        return W, dN, eN, avail, chosen

    carry = (W0, d0, d0, livef, jnp.zeros((nsteps,), jnp.int32))
    _, _, _, _, chosen = jax.lax.fori_loop(0, nsteps, step, carry)
    return chosen


def qrcp_panel(panel: jax.Array, row0, pivot: bool = True,
               precision=STABLE_PRECISION):
    """Unblocked Householder QR(CP) of a full-height panel whose
    factorization starts at (traced) row offset ``row0`` — the reference
    HQRRP's panel kernel (rl_hqrrp.hh:1088, NoFLA_QRPmod_WY_unb_var4 on
    AB1 = A[j:, j:j+b]) in static-shape form: rows < row0 are never
    touched (they hold earlier R12 values), reflector ``l`` has its head
    at row ``row0 + l``.

    Returns ``(W, V, taus, sigma)``:
      W     (m, b) the transformed panel — R values in rows ≤ row0+b,
            reflector tails below (LAPACK packed layout at offset row0),
      V     (m, b) explicit reflectors (unit head at row0+l, zeros above),
      taus  (b,),
      sigma (b,) int32 — the within-panel pivot order (identity when
            ``pivot=False``), matching the reference's lockstep swaps of
            (AB1, A01, Y1).
    """
    m, b = panel.shape
    dtype = panel.dtype
    rows = jnp.arange(m)
    cols = jnp.arange(b)
    row0 = jnp.asarray(row0, jnp.int32)
    W0 = panel
    masked0 = jnp.where(rows[:, None] >= row0, W0, 0.0)
    d0 = jnp.linalg.norm(masked0, axis=0)

    def step(l, carry):
        W, V, taus, sigma, dN, eN = carry
        i = row0 + l
        if pivot:
            p = jnp.argmax(jnp.where(cols >= l, dN, -1.0))
            perm = jnp.where(cols == l, p, jnp.where(cols == p, l, cols))
            W = jnp.take(W, perm, axis=1)
            sigma = jnp.take(sigma, perm)
            dN = jnp.take(dN, perm)
            eN = jnp.take(eN, perm)
        v, tau, alpha = _larfg(W[:, l], i)
        w = tau * jnp.matmul(v, W, precision=precision)
        w = jnp.where(cols >= l, w, 0.0)
        W = W - jnp.outer(v, w)
        # column l in LAPACK packed layout: R above, alpha on the
        # "diagonal" (row i), the reflector tail v stored below
        coli = jnp.where(rows < i, W[:, l],
                         jnp.where(rows == i, alpha, v))
        W = W.at[:, l].set(coli)
        V = V.at[:, l].set(v)
        taus = taus.at[l].set(tau)
        if pivot:
            dN, eN = _drmac_downdate(W, i, W[i, :], dN, eN, cols > l)
        return W, V, taus, sigma, dN, eN

    carry = (W0, jnp.zeros((m, b), dtype), jnp.zeros((b,), dtype),
             jnp.arange(b, dtype=jnp.int32), d0, d0)
    W, V, taus, sigma, _, _ = jax.lax.fori_loop(0, b, step, carry)
    return W, V, taus, sigma


def wy_T(V: jax.Array, taus: jax.Array, precision=STABLE_PRECISION):
    """Compact-WY triangular factor: T (b×b upper) with
    H₁·…·H_b = I − V·T·Vᵀ (LAPACK larft, forward/columnwise — used by the
    reference's WY trailing updates, rl_hqrrp.hh:300,490).

    Built in GEMM form from T⁻¹ = diag(1/τ) + strict_upper(VᵀV) — one
    b×b Gram plus one small triangular solve instead of larft's column
    recurrence. τ = 0 (identity reflector) columns contribute nothing:
    their V column is zeroed and the diagonal is patched to 1.
    """
    b = taus.shape[0]
    dtype = V.dtype
    active = taus != 0
    Vz = jnp.where(active[None, :], V, 0.0)
    S = jnp.matmul(Vz.T, Vz, precision=precision)
    tinv = jnp.where(active, 1.0 / jnp.where(active, taus, 1.0), 1.0)
    Tinv = jnp.triu(S, 1) + jnp.diag(tinv.astype(dtype))
    T = jax.lax.linalg.triangular_solve(
        Tinv, jnp.eye(b, dtype=dtype), left_side=True, lower=False)
    return T, Vz


def lu_pivot_columns(A_panel_t: jax.Array):
    """Column-pivot selection via partial-pivoted LU — BQRRP's ``luqr``
    qrcp_wide (rl_bqrrp.hh:339-349): getrf on the transposed sketch panel;
    the LU row permutation of A_skᵀ is the column pivot order of A_sk.

    ``A_panel_t``: (n, d) = transposed d×n sketch panel.
    Returns the full length-n permutation (first d entries are the chosen
    pivot columns, in order).
    """
    # non-finite columns carry no pivot information (drivers/bqrrp.py::
    # _sanitize_sketch)
    A_panel_t = jnp.where(jnp.isfinite(A_panel_t), A_panel_t, 0.0)
    # STRUCTURAL-DEFICIENCY PAD: when fewer than d rows are nonzero
    # (masked/retired sketch columns, or rank < d), textbook elimination
    # hits an exactly-zero pivot — 0/0 and 1/0 arise INSIDE the kernel,
    # and a kernel fed internally-generated Inf/NaN returns garbage
    # pivots (harmless to prevent). A cyclic
    # identity pattern at δ = 2^(e_max - 40) — an EXACT power of two, so
    # the pow2 scale-equivariance pinned in test_property_sweeps holds —
    # makes every pivot nonzero while sitting 2^-40 below the data scale:
    # pivot ORDER among live columns is unchanged except at δ-level ties,
    # where any choice is equally valid (and _fix_pivots remaps retired
    # picks anyway).
    n, d = A_panel_t.shape
    from .cholqr import _pow2
    mx = jnp.max(jnp.abs(A_panel_t))
    e = jnp.floor(jnp.log2(jnp.where(mx > 0, mx, 1.0))).astype(jnp.int32)
    delta = _pow2(e - 40, A_panel_t.dtype)
    pad = delta * jax.nn.one_hot(jnp.arange(n) % d, d,
                                 dtype=A_panel_t.dtype)
    _, _, perm = jax.lax.linalg.lu(A_panel_t + pad)
    return perm.astype(jnp.int32)
