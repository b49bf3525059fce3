"""Subsampled Randomized Hadamard Transform (SRHT) — the GEMM-based sketch.

Not present in the reference (RandBLAS ships dense + SASO), but SURVEY.md §7
recommends SRHT as the accelerator-friendly structured sketch: the
Walsh-Hadamard transform factorizes into dense 128×128 (or smaller)
Hadamard matmuls, so sketching an m×n matrix costs O(m·n·log m / 128) GEMM time
instead of an m×d Gaussian GEMM.

S = sqrt(m_pad/d) · R · H · D with D = diag(±1), H the m_pad-point
Walsh-Hadamard transform (m_pad = next power of two ≥ m), R a uniform row
sampler. ``S/sqrt(d)``-style scaling is folded in so E[SᵀS] = I.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..config import SKETCH_PRECISION
from ..rng import RNGState


def _hadamard_matrix(k: int, dtype):
    """Dense k×k Hadamard matrix (k a power of two), unnormalized."""
    h = jnp.ones((1, 1), dtype)
    while h.shape[0] < k:
        h = jnp.block([[h, h], [h, -h]])
    return h


def fwht(x: jax.Array, precision=SKETCH_PRECISION) -> jax.Array:
    """Walsh-Hadamard transform along axis 0 (length must be a power of 2).

    Radix-128 (tail radices as needed) so every stage is a dense matmul on
    rather than log2(m) butterfly passes over device memory.
    """
    m = x.shape[0]
    assert m & (m - 1) == 0, "fwht length must be a power of two"
    radix = 128
    rest = x.shape[1:]
    done = 1
    while done < m:
        r = min(radix, m // done)
        # view as (m // (done*r), r, done, *rest); transform the r axis.
        h = _hadamard_matrix(r, x.dtype)
        x = x.reshape(m // (done * r), r, done, *rest)
        x = jnp.einsum("ij,ajb...->aib...", h, x, precision=precision)
        x = x.reshape(m, *rest)
        done *= r
    return x


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SRHTSkOp:
    """Sampled SRHT operator: d×m (sketches the length-m axis down to d;
    a pytree)."""

    n_rows: int = dataclasses.field(metadata=dict(static=True))   # d
    n_cols: int = dataclasses.field(metadata=dict(static=True))   # m
    signs: jax.Array = None   # (m,) ±1
    rows: jax.Array = None    # (d,) sampled indices into [0, m_pad)

    @property
    def m_pad(self) -> int:
        return 1 << max(0, (self.n_cols - 1).bit_length())


def srht_skop(d: int, m: int, state: RNGState, dtype=jnp.float32):
    """Sample an SRHT operator. Returns ``(SRHTSkOp, next_state)``."""
    m_pad = 1 << max(0, (m - 1).bit_length())
    k1, state = state.spawn()
    signs = jax.random.rademacher(k1, (m,), dtype=dtype)
    k2, state = state.spawn()
    rows = jax.random.randint(k2, (d,), 0, m_pad, dtype=jnp.int32)
    return SRHTSkOp(d, m, signs, rows), state


def srht_left_apply(S: SRHTSkOp, A: jax.Array,
                    precision=SKETCH_PRECISION) -> jax.Array:
    """Compute S @ A (d×m · m×n), scaled so E[SᵀS] = I."""
    m, n = A.shape
    assert m == S.n_cols
    m_pad = S.m_pad
    x = A * S.signs[:, None]
    if m_pad != m:
        x = jnp.pad(x, ((0, m_pad - m), (0, 0)))
    x = fwht(x, precision=precision)
    out = x[S.rows]
    # H/√m_pad is orthogonal; row-sampling d of m_pad coords with scale
    # √(m_pad/d) is an isometry in expectation → net scale 1/√d on raw H.
    return out * jnp.asarray(1.0 / math.sqrt(S.n_rows), A.dtype)
