"""RPCholesky — randomly pivoted block Cholesky of an implicit PSD matrix
(reference: RandLAPACK/comps/rl_rpchol.hh: rp_cholesky :112/:195, algorithm
of arXiv:2304.12465). The operator is accessed only through column
evaluations and its diagonal — exactly the access pattern of kernel
matrices in KRILL.

Design: fixed block size b, one jitted fori_loop over k/b blocks.
Within-block duplicate pivots (iid CDF sampling can repeat) are resolved by
a scatter-winner mask + eigh-based pseudo-inverse square root of the block
Gram — numerically equivalent to the reference's dedup + potrf/trsm, but
branch-free and static-shaped.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..sketching.sampling import weights_to_cdf


@dataclasses.dataclass(frozen=True)
class RPCholConfig:
    block_size: int = 64
    sampling: str = "gumbel"      # "gumbel": exact without-replacement
                                  # block sampling (Gumbel top-k over the
                                  # residual diagonal — distinct pivots by
                                  # construction, no zero factor columns);
                                  # "iid": the reference's
                                  # sample-with-replacement + dedup
                                  # (collisions become zero columns under
                                  # static shapes)


@partial(jax.jit, static_argnames=("k", "cfg", "precision"))
def rp_cholesky(A, k: int, cfg: RPCholConfig, state: RNGState,
                precision=STABLE_PRECISION):
    """Rank-k approximation A ≈ F Fᵀ with randomly pivoted column selection.

    ``A`` is any object with ``dim``, ``diagonal()`` and ``columns(idx)``
    (ExplicitSymLinOp, RegExplicitSymLinOp, or a kernel linop).

    Returns ``(F, pivots, next_state)``: F (n, k), pivots (k,) int32 (the
    selected columns; repeated draws yield zero columns in F).
    """
    n = A.dim
    b = cfg.block_size
    assert k % b == 0, "k must be a multiple of block_size"
    nblocks = k // b
    diag0 = A.diagonal()
    dtype = diag0.dtype
    eps = jnp.finfo(dtype).eps
    base = state

    F0 = jnp.zeros((n, k), dtype)
    piv0 = jnp.zeros((k,), jnp.int32)

    def block(i, carry):
        F, piv, d = carry
        bstate = base.branch(i)
        key, _ = bstate.spawn()
        # 1. sample b pivots from the residual-diagonal distribution
        if cfg.sampling == "gumbel":
            # exact without-replacement: argtop-b of log d + Gumbel noise
            g = jax.random.gumbel(key, (n,), dtype=dtype)
            # finite floor, NOT -inf (an earlier backend miscompiled inf
            # constants inside fori_loop to 0): -1e30 + Gumbel noise
            # still loses to every live weight
            logd = jnp.where(d > 0, jnp.log(jnp.where(d > 0, d, 1.0)),
                             -1e30)
            _, idx = jax.lax.top_k(logd + g, b)
            idx = idx.astype(jnp.int32)
        else:
            cdf = weights_to_cdf(d)
            u = jax.random.uniform(key, (b,), dtype=dtype)
            idx = jnp.clip(jnp.searchsorted(cdf, u, side="left"), 0, n - 1
                           ).astype(jnp.int32)
        # 2. winner mask: one representative per distinct pivot
        winner = jnp.zeros((n,), jnp.int32).at[idx].set(
            jnp.arange(b, dtype=jnp.int32))
        keep = (winner[idx] == jnp.arange(b)).astype(dtype)
        # 3. residual columns: G = A[:, idx] − F F[idx,:]ᵀ
        cols = A.columns(idx)
        G = cols - jnp.matmul(F, jnp.take(F, idx, axis=0).T,
                              precision=precision)
        G = G * keep[None, :]
        # 4. block factor via pinv-sqrt of the (possibly singular) pivot
        #    Gram — replaces potrf/trsm, robust to duplicates/deficiency
        # mask rows AND columns of the pivot Gram: duplicate pivots must be
        # fully zeroed or H loses symmetry (their row would alias the
        # winner's) and the Schur complement overshoots.
        H = jnp.take(G, idx, axis=0) * keep[None, :] * keep[:, None]
        H = 0.5 * (H + H.T)
        w, U = jnp.linalg.eigh(H)
        tol = jnp.maximum(jnp.max(w), 0.0) * b * eps
        inv_sqrt = jnp.where(w > tol, 1.0 / jnp.sqrt(jnp.where(w > tol, w, 1.0)),
                             0.0)
        Fb = jnp.matmul(G, U * inv_sqrt[None, :], precision=precision)
        # 5. commit block, downdate the diagonal
        F = jax.lax.dynamic_update_slice(F, Fb, (0, i * b))
        piv = jax.lax.dynamic_update_slice(piv, idx, (i * b,))
        d = jnp.maximum(d - jnp.sum(Fb * Fb, axis=1), 0.0)
        d = d * (1.0 - jnp.zeros((n,), dtype).at[idx].set(keep))
        return F, piv, d

    F, piv, _ = jax.lax.fori_loop(0, nblocks, block, (F0, piv0, diag0))
    # advance the counter so later branch()/spawn() streams differ from the
    # per-block streams consumed above (branch folds the counter in)
    return F, piv, base.spawn()[1]
