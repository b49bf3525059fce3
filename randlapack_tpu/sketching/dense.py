"""Dense sketching operators (RandBLAS ``DenseDist``/``DenseSkOp`` capability).

Reference surface (SURVEY.md §2.9): ``DenseDist`` + ``ScalarDist::{Gaussian,
Uniform}`` + ``fill_dense``/``fill_dense_unpacked`` + ``DenseSkOp``.

Design: a dense sketch is just an array produced deterministically
from an ``RNGState``; entries have unit variance so ``S/sqrt(d)`` is an
isometry in expectation. The fused generate+apply path (never materializing
S in HBM for huge m) lives in ``randlapack_tpu.sketching.apply``.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import jax
import jax.numpy as jnp

from ..rng import RNGState


class ScalarDist(enum.Enum):
    Gaussian = "gaussian"
    Uniform = "uniform"


@dataclasses.dataclass(frozen=True)
class DenseDist:
    """Distribution over dense n_rows × n_cols sketching operators."""

    n_rows: int
    n_cols: int
    family: ScalarDist = ScalarDist.Gaussian

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def isometry_scale(self) -> float:
        # Unit-variance entries: isometry scale is 1/sqrt(short axis).
        return 1.0 / math.sqrt(min(self.n_rows, self.n_cols))


def fill_dense(dist: DenseDist, state: RNGState, dtype=jnp.float32):
    """Sample S ~ dist. Returns ``(S, next_state)``.

    Entries are iid unit-variance: N(0,1) for Gaussian, U(-√3, √3) for
    Uniform (matching the RandBLAS convention of unit second moment).
    """
    key, nxt = state.spawn()
    if dist.family == ScalarDist.Gaussian:
        s = jax.random.normal(key, dist.shape, dtype=dtype)
    elif dist.family == ScalarDist.Uniform:
        r = math.sqrt(3.0)
        s = jax.random.uniform(key, dist.shape, dtype=dtype, minval=-r, maxval=r)
    else:  # pragma: no cover
        raise ValueError(f"unknown family {dist.family}")
    return s, nxt


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseSkOp:
    """A sampled dense sketching operator (materialized, a pytree)."""

    dist: DenseDist = dataclasses.field(metadata=dict(static=True))
    mat: jax.Array = None  # (n_rows, n_cols)

    @property
    def n_rows(self):
        return self.dist.n_rows

    @property
    def n_cols(self):
        return self.dist.n_cols


def dense_skop(dist: DenseDist, state: RNGState, dtype=jnp.float32):
    s, nxt = fill_dense(dist, state, dtype)
    return DenseSkOp(dist, s), nxt
