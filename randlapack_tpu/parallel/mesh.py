"""Mesh construction and sharding helpers."""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices (default all).

    The tall (row) dimension of every operator shards over this axis; the
    short dimension stays replicated — Gram reductions are then a single
    psum of a k×k tile.
    """
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.asarray(devs), (axis,))


def row_sharded(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    return NamedSharding(mesh, P(axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
