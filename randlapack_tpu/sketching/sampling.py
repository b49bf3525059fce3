"""Index-sampling utilities (RandBLAS sampling capability).

Reference surface (SURVEY.md §2.9): ``weights_to_cdf``,
``sample_indices_iid``, ``sample_indices_iid_uniform``,
``repeated_fisher_yates``. Used by RPCholesky pivot sampling
(reference: RandLAPACK/comps/rl_rpchol.hh:139-143) and SASO construction.

Design: CDF inversion via ``searchsorted`` (vectorized), and
without-replacement sampling via the Gumbel top-k trick instead of a
sequential Fisher-Yates loop — identical distribution for uniform weights,
fully parallel on the VPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..rng import RNGState


def weights_to_cdf(weights: jax.Array, eps: float = 0.0) -> jax.Array:
    """Normalize nonnegative weights to a CDF. Negative weights are clamped.

    ``eps`` mirrors the reference's error_if_below guard loosely: weights
    below eps are treated as zero.
    """
    w = jnp.where(weights > eps, weights, 0.0)
    c = jnp.cumsum(w)
    total = c[-1]
    return c / jnp.where(total > 0, total, 1.0)


def sample_indices_iid(cdf: jax.Array, n: int, state: RNGState):
    """n iid draws from the distribution with the given CDF.

    Returns ``(indices, next_state)``; int32 indices in [0, len(cdf)).
    """
    key, nxt = state.spawn()
    u = jax.random.uniform(key, (n,), dtype=cdf.dtype)
    idx = jnp.searchsorted(cdf, u, side="left")
    return jnp.clip(idx, 0, cdf.shape[0] - 1).astype(jnp.int32), nxt


def sample_indices_iid_uniform(n_population: int, n: int, state: RNGState):
    key, nxt = state.spawn()
    idx = jax.random.randint(key, (n,), 0, n_population, dtype=jnp.int32)
    return idx, nxt


def sample_distinct_uniform(n_population: int, k: int, n_batches: int,
                            state: RNGState, chunk: int = 8192):
    """For each of ``n_batches`` independent batches, draw ``k`` DISTINCT
    uniform indices in [0, n_population) — the role ``repeated_fisher_yates``
    plays in RandBLAS SASO construction.

    Gumbel/uniform top-k: per batch, draw n_population uniforms and take the
    top-k positions — exact sampling without replacement, fully parallel.
    Chunked over batches to bound memory at ``chunk * n_population`` floats.

    Returns ``(idx, next_state)`` with idx shape (n_batches, k), int32.
    """
    key, nxt = state.spawn()

    def one_chunk(ck):
        u = jax.random.uniform(ck, (chunk, n_population))
        _, idx = jax.lax.top_k(u, k)
        return idx.astype(jnp.int32)

    n_chunks = -(-n_batches // chunk)
    keys = jax.random.split(key, n_chunks)
    out = jax.lax.map(one_chunk, keys)  # (n_chunks, chunk, k)
    out = out.reshape(n_chunks * chunk, k)[:n_batches]
    return out, nxt
