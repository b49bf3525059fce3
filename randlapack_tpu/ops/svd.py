"""Economy SVD of small/skinny factors.

Every driver in this framework only ever takes the SVD of a SMALL factor
(QB's B, ABRIK's band, REVD2's B, sketch SVDs). Two routes compute it:
XLA's own SVD (``"xla"``: LAPACK on the CPU, cuSOLVER on a GPU) and the
Gram/eigh route (``"gram_eigh"``):

    p ≤ q:  eigh(B Bᵀ) → U, σ²;  Vᵀ = diag(1/σ)·UᵀB
    p > q:  eigh(BᵀB) → V, σ²;  U  = B·V·diag(1/σ)

Accuracy of the Gram route (measured in f32, docs/svd_envelope.md): the
Rayleigh refinement (σᵢ = ‖Bvᵢ‖, one already-needed GEMM) extends the
λ-path's range, but its floor is set by eigh's f32 subspace
contamination, NOT by the naive eps·σ₁/σᵢ model — on dense decaying
spectra, values are ~1e-4-accurate for σ ≥ 1e-2·σ₁ and ~1e-3-accurate
down to σ ≈ 3e-3·σ₁, degrading to O(10%) near the √eps·σ₁ cutoff;
flat/clustered spectra are accurate throughout; triplet residuals stay
≤ ~1e-3·σ₁ everywhere. Vectors for σ < √eps·σ₁ are zeroed. Refined values
are re-sorted descending (they can swap order within their error band vs
eigh's λ sort, and downstream S[:k] truncations assume monotone s).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION


# "auto" by platform, from compile + run time at the drivers' factor shapes
# (H100: gram_eigh runs 6-14x faster than cuSOLVER's SVD at 256×4096 to
# 8000×2000, both compile in about a second; PERF.md, PR 1). The Gram
# route's f32 trust region (module docstring) is the price; pass
# method="xla" where values below ~√eps·σ₁ matter. A platform not listed
# takes the accurate route.
_AUTO_SVD = {"cpu": "xla", "gpu": "gram_eigh"}


def resolve_svd_method(method: str) -> str:
    """"auto" → the route measured fastest on this platform
    (``_AUTO_SVD``); any other name passes through. "jacobi" is the
    opt-in high-relative-accuracy route (see _svd_jacobi)."""
    if method != "auto":
        return method
    return _AUTO_SVD.get(jax.default_backend(), "xla")


def _round_robin_schedule(q: int):
    """Static tournament schedule: (q-1) rounds of q/2 DISJOINT column
    pairs (circle method) covering every pair exactly once per sweep.
    Disjointness is what makes each round one vectorized rotation."""
    import numpy as _np
    idx = list(range(q))
    rounds = []
    for _ in range(q - 1):
        pairs = [(min(idx[i], idx[q - 1 - i]),
                  max(idx[i], idx[q - 1 - i])) for i in range(q // 2)]
        rounds.append(pairs)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return _np.asarray(rounds, _np.int32)


@partial(jax.jit, static_argnames=("sweeps",))
def _svd_jacobi_tall(B: jax.Array, sweeps: int = 20):
    """One-sided Jacobi SVD of a TALL (p ≥ q) factor — high RELATIVE
    accuracy for small singular values (measured: reaches the
    eps·σ₁/σᵢ input-rounding bound, ~4-25× deeper f32 trust region than
    the gram_eigh route on decaying spectra; docs/svd_envelope.md).

    Structure: a static round-robin schedule makes each of
    the (q−1) rounds per sweep a single VECTORIZED rotation of q/2
    disjoint column pairs (gather → elementwise 2-column rotation →
    scatter, no serial 2×2 loop); the whole iteration is one fori_loop
    body compiled once. Cost ~ sweeps·(q−1) vector rounds — heavier than
    one eigh, meant for accuracy-critical final factors.
    """
    p, q0 = B.shape
    dtype = B.dtype
    q = q0 + (q0 % 2)                     # pad odd widths w/ a zero col
    W = jnp.zeros((p, q), dtype).at[:, :q0].set(B)
    sched = jnp.asarray(_round_robin_schedule(q))
    nrounds = sched.shape[0]
    V = jnp.eye(q, dtype=dtype)

    def round_body(k, carry):
        W, V = carry
        pairs = sched[k % nrounds]
        i, j = pairs[:, 0], pairs[:, 1]
        Wi, Wj = W[:, i], W[:, j]
        a = jnp.sum(Wi * Wi, axis=0)
        b = jnp.sum(Wj * Wj, axis=0)
        c = jnp.sum(Wi * Wj, axis=0)
        # Rutishauser rotation annihilating the (i,j) Gram entry; columns
        # already orthogonal (|c| ~ 0) rotate by identity. sign(0) must
        # be +1 (an exact a == b tie still needs the 45° rotation).
        tiny = jnp.finfo(dtype).tiny
        skip = jnp.abs(c) <= tiny
        tau = (b - a) / jnp.where(skip, 1.0, 2.0 * c)
        sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(dtype)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        cs = 1.0 / jnp.sqrt(1.0 + t * t)
        sn = cs * t
        cs = jnp.where(skip, 1.0, cs)
        sn = jnp.where(skip, 0.0, sn)
        W = W.at[:, i].set(cs[None, :] * Wi - sn[None, :] * Wj) \
             .at[:, j].set(sn[None, :] * Wi + cs[None, :] * Wj)
        Vi, Vj = V[:, i], V[:, j]
        V = V.at[:, i].set(cs[None, :] * Vi - sn[None, :] * Vj) \
             .at[:, j].set(sn[None, :] * Vi + cs[None, :] * Vj)
        return W, V

    W, V = jax.lax.fori_loop(0, sweeps * nrounds, round_body, (W, V))
    s = jnp.linalg.norm(W, axis=0)
    ordr = jnp.argsort(-s, stable=True)
    s, W, V = s[ordr], W[:, ordr], V[:, ordr]
    s_safe = jnp.where(s > 0, s, 1.0)
    U = W / s_safe[None, :]
    # NO derived-side zeroing here (unlike the gram route): a deep
    # column u = B·v/‖B·v‖ with the CORRECT σ keeps the triplet
    # B·vᵢ ≈ σᵢ·uᵢ eps-consistent at any depth — that consistency is
    # this route's distinctive property. Individual deep left vectors do
    # lose truth-alignment/orthogonality below ~1e-3·σ₁ (same f32
    # subspace physics as everywhere); see docs/svd_envelope.md.
    # Drop the pad column/coordinate (its zero column never mixes: c = 0
    # skips every rotation, so the leading right-vectors have exactly
    # zero component along the pad coordinate).
    return U[:, :q0], s[:q0], V.T[:q0, :q0]


@partial(jax.jit, static_argnames=("method", "precision"))
def svd_econ(B: jax.Array, method: str = "auto",
             precision=STABLE_PRECISION):
    """Economy SVD → (U, s, Vt) with s descending.

    ``method``: "auto" (platform-dependent, see ``resolve_svd_method``),
    "gram_eigh" (one Gram GEMM + eigh, √eps relative cutoff), "jacobi"
    (one-sided Jacobi — high RELATIVE value accuracy to the f32
    input-rounding bound, eps-level triplet residuals at any depth;
    ~sweeps·(q−1) vector rounds, heavier than eigh) or "xla" (native
    lowering — accurate).
    """
    method = resolve_svd_method(method)
    if method == "xla":
        return jnp.linalg.svd(B, full_matrices=False)
    if method == "jacobi":
        p, q = B.shape
        if p >= q:
            return _svd_jacobi_tall(B)
        U, s, Vt = _svd_jacobi_tall(B.T)
        return Vt.T, s, U.T

    p, q = B.shape
    k = min(p, q)
    eps = jnp.finfo(B.dtype).eps
    if p <= q:
        G = jnp.matmul(B, B.T, precision=precision)
        lam, U = jnp.linalg.eigh(0.5 * (G + G.T))
        lam, U = lam[::-1], U[:, ::-1]
        # Rayleigh refinement: σᵢ = ‖uᵢᵀB‖ has absolute error ~eps·σ₁
        # (relative eps·σ₁/σᵢ) instead of the λ-path's eps·σ₁²/σᵢ
        # (relative eps·(σ₁/σᵢ)²) — one already-needed GEMM, no extra cost
        W = jnp.matmul(U.T, B, precision=precision)
        s = jnp.linalg.norm(W, axis=1)
        # refined values can swap order within their error band vs eigh's
        # λ sort — re-sort so downstream S[:k] truncations stay valid
        ordr = jnp.argsort(-s, stable=True)
        s, U, W = s[ordr], U[:, ordr], W[ordr, :]
        good = s > s[0] * jnp.sqrt(eps)
        s_safe = jnp.where(good, s, 1.0)
        Vt = W / s_safe[:, None]
        Vt = jnp.where(good[:, None], Vt, 0.0)
        return U, s, Vt
    G = jnp.matmul(B.T, B, precision=precision)
    lam, V = jnp.linalg.eigh(0.5 * (G + G.T))
    lam, V = lam[::-1], V[:, ::-1]
    W = jnp.matmul(B, V, precision=precision)
    s = jnp.linalg.norm(W, axis=0)   # Rayleigh-refined σ (see above)
    ordr = jnp.argsort(-s, stable=True)     # see re-sort note above
    s, V, W = s[ordr], V[:, ordr], W[:, ordr]
    good = s > s[0] * jnp.sqrt(eps)
    s_safe = jnp.where(good, s, 1.0)
    U = W / s_safe[None, :]
    U = jnp.where(good[None, :], U, 0.0)
    return U, s, V.T
