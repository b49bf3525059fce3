"""Distributed sketching + rangefinder step — the framework's sharded
"training step": one randomized power/orthogonalize/project cycle over a
row-sharded operator, with all collectives (psum of Gram tiles and of
sketch partial sums) across the device interconnect.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import STABLE_PRECISION


def dist_sketch_left(S: jax.Array, A: jax.Array, mesh: Mesh,
                     axis: str = "rows",
                     precision=STABLE_PRECISION) -> jax.Array:
    """(d×m dense sketch) @ (row-sharded m×n A) → replicated d×n:
    each device multiplies its row block by the matching sketch columns
    and the partial products psum over the mesh."""

    def local(s_cols, a):
        part = jnp.matmul(s_cols, a, precision=precision)
        return jax.lax.psum(part, axis)

    # S columns shard along the same axis as A's rows
    return shard_map(local, mesh=mesh, in_specs=(P(None, axis), P(axis, None)),
                     out_specs=P())(S, A)


def dist_rangefinder_step(A: jax.Array, Omega: jax.Array, mesh: Mesh,
                          axis: str = "rows",
                          precision=STABLE_PRECISION):
    """One sharded rangefinder cycle (the core of RSVD/QB over a mesh):

        Y = A·Ω            (local rows)
        Q = dist CholQR(Y) (one k×k psum + redundant small Cholesky)
        B = QᵀA            (local + psum)
        Ω' = AᵀY / ‖·‖      (power refresh: local + psum)

    A and Y/Q row-sharded; Ω, B replicated. Returns ``(Q, B, Omega')``.
    """
    n = A.shape[1]
    k = Omega.shape[1]

    def local(a, om):
        from .tsqr import _band_guard_local
        y = jnp.matmul(a, om, precision=precision)
        # CholQR2 inline (two psum'd Gram passes); Q is invariant under
        # the band guard's power-of-2 scale, and no R is returned, so no
        # scale bookkeeping is needed here
        q = y
        r = None
        fail = jnp.asarray(False)
        for _ in range(2):
            q, _, nonfin = _band_guard_local(q, axis)
            g = jax.lax.psum(jnp.matmul(q.T, q, precision=precision), axis)
            l = jax.lax.linalg.cholesky(g)
            fail = fail | jnp.any(jnp.isnan(l)) | nonfin
            q = jax.lax.linalg.triangular_solve(l.T, q, left_side=False,
                                                lower=False)
        b = jax.lax.psum(jnp.matmul(q.T, a, precision=precision), axis)
        # power refresh with the orthonormal basis (Ω' = AᵀQ = Bᵀ): refreshing
        # with the raw Y squares the conditioning per iteration and breaks
        # f32 CholQR on decaying spectra
        om_new = b.T
        return q, b, om_new, fail

    return shard_map(local, mesh=mesh,
                     in_specs=(P(axis, None), P()),
                     out_specs=(P(axis, None), P(), P(), P()))(A, Omega)
