"""Householder-format compatibility — the ``orhr_col``/GEQP3-output
capability (reference: lapack::orhr_col used in rl_bqrrp.hh:453-510 and the
reference impl rl_util.hh:339).

The framework's primary output is explicit Q (SURVEY.md §7
recommendation); this adapter reconstructs the LAPACK implicit form
(packed reflectors + taus, plus the diagonal sign matrix) for drop-in
compatibility with GEQP3/GEQRF consumers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


def householder_reconstruct(Q: jax.Array, precision=STABLE_PRECISION):
    """Given orthonormal Q (m, k), return ``(packed, taus, signs)`` such
    that applying the k reflectors (LAPACK convention, v[i]=1 implicit on
    the diagonal of ``packed``'s strict lower part) to I reproduces
    Q·diag(signs).

    Because Q is orthonormal, Householder QR of Q yields R = diag(±1)
    exactly — the reflectors ARE the implicit representation.
    """
    return _reconstruct(Q, precision)


def _reconstruct(Q, precision):
    from .qr import _larfg
    m, k = Q.shape
    dtype = Q.dtype

    def step(i, carry):
        W, V, taus = carry
        v, tau, alpha = _larfg(W[:, i], i)
        w = tau * jnp.matmul(v, W, precision=precision)
        w = jnp.where(jnp.arange(k) >= i, w, 0.0)
        W = W - jnp.outer(v, w)
        coli = jnp.where(jnp.arange(m) < i, W[:, i], 0.0).at[i].set(alpha)
        W = W.at[:, i].set(coli)
        V = V.at[:, i].set(v)
        taus = taus.at[i].set(tau)
        return W, V, taus

    W, V, taus = jax.lax.fori_loop(
        0, k, step, (Q, jnp.zeros((m, k), dtype), jnp.zeros((k,), dtype)))
    signs = jnp.sign(jnp.diag(W[:k, :]))
    packed = jnp.tril(V, -1)
    return packed, taus, signs


def apply_reflectors(packed: jax.Array, taus: jax.Array,
                     X: jax.Array | None = None,
                     precision=STABLE_PRECISION):
    """Form Q (or Q·X) from the packed implicit representation via
    ``householder_product`` — the gemqrt/ormqr capability."""
    m, k = packed.shape
    a = packed + jnp.eye(m, k, dtype=packed.dtype)
    Q = jax.lax.linalg.householder_product(a, taus)
    if X is None:
        return Q
    return jnp.matmul(Q, X, precision=precision)


def getrfnp(M: jax.Array, base: int = 32):
    """Unpivoted LU with adaptive diagonal sign modification — the
    LAPACK ``launhr_col_getrfnp2`` kernel that makes Householder
    reconstruction unconditionally robust: it factors M − diag(s) = L·U
    where each sᵢ = −sign(current Schur diagonal) is chosen *during*
    elimination, so every pivot satisfies |uᵢᵢ| ≥ 1 (for ‖M‖ ≤ 1 inputs
    like orthonormal-Q blocks). A fixed sign choice from diag(M) alone is
    NOT safe: a square orthogonal Q1 can make Q1 − S exactly singular
    (observed: eigenvalue 1 of Q1·S at BQRRP's last block).

    Recursive halving (trace-time unrolled): GEMM + triangular solves at
    the internal nodes, a ``base``-step rank-1 loop at the leaves.

    Returns ``(F, s)``: F packed (unit-L strict-lower + U upper), s (k,).
    """
    k = M.shape[0]
    dtype = M.dtype

    if k <= base:
        rows = jnp.arange(k)

        def step(j, carry):
            F, s = carry
            d = F[j, j]
            sj = jnp.where(d >= 0, -1.0, 1.0).astype(dtype)
            piv = d - sj
            col = jnp.where(rows > j, F[:, j] / piv, 0.0)
            row = jnp.where(rows > j, F[j, :], 0.0)
            F = F - jnp.outer(col, row)
            F = F.at[j, j].set(piv)
            F = F.at[:, j].set(jnp.where(rows > j, col, F[:, j]))
            s = s.at[j].set(sj)
            return F, s

        F, s = jax.lax.fori_loop(0, k, step, (M, jnp.zeros((k,), dtype)))
        return F, s

    k1 = k // 2
    M11, M12 = M[:k1, :k1], M[:k1, k1:]
    M21, M22 = M[k1:, :k1], M[k1:, k1:]
    F11, s1 = getrfnp(M11, base)
    L11 = jnp.tril(F11, -1) + jnp.eye(k1, dtype=dtype)
    U11 = jnp.triu(F11)
    U12 = jax.lax.linalg.triangular_solve(
        L11, M12, left_side=True, lower=True, unit_diagonal=True)
    L21 = jax.lax.linalg.triangular_solve(
        U11, M21, left_side=False, lower=False)
    S22 = M22 - jnp.matmul(L21, U12, precision=jax.lax.Precision.HIGHEST)
    F22, s2 = getrfnp(S22, base)
    F = jnp.block([[F11, U12], [L21, F22]])
    return F, jnp.concatenate([s1, s2])


def orhr_col(Q_panel: jax.Array, row0, precision=STABLE_PRECISION):
    """Blocked Householder reconstruction (LAPACK ``orhr_col``,
    rl_bqrrp.hh:453-510 / rl_hqrrp.hh:537): given Q_panel (m×b) with
    orthonormal columns and zeros above (traced) row ``row0``, produce the
    compact-WY factors of an *exactly defined* orthogonal H = I − V·T·Vᵀ
    with H·E_blk = Q_panel·diag(s):

        Q1 − S = L1·U1   (adaptive-sign unpivoted LU, |u_ii| ≥ 1)
        V = (Q_panel − S_pad)·U1⁻¹   (unit diagonal at row0+l)
        T = −U1·S·L1⁻ᵀ               (upper triangular — LAPACK layout)

    All GEMM/trsm except the small LU leaves. Returns ``(V, T, s)``.
    """
    m, b = Q_panel.shape
    dtype = Q_panel.dtype
    Q1 = jax.lax.dynamic_slice(Q_panel, (row0, 0), (b, b))
    with jax.named_scope("getrfnp"):
        F, s = getrfnp(Q1)
    L1 = jnp.tril(F, -1) + jnp.eye(b, dtype=dtype)
    U1 = jnp.triu(F)
    S_pad = jnp.zeros((m, b), dtype).at[
        row0 + jnp.arange(b), jnp.arange(b)].set(s)
    V = jax.lax.linalg.triangular_solve(
        U1, Q_panel - S_pad, left_side=False, lower=False)
    # T = −U1·S·L1⁻ᵀ  via  Tᵀ = −L1⁻¹·(U1·S)ᵀ
    T = -jax.lax.linalg.triangular_solve(
        L1, (U1 * s[None, :]).T, left_side=True, lower=True,
        unit_diagonal=True).T
    return V, T, s
