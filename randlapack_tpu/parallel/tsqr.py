"""Distributed tall-skinny orthogonalization over a row-sharded mesh.

CholeskyQR is the communication-optimal TSQR: each device computes its
local Gram contribution (one matmul), a single ``psum`` of the k×k tile
crosses the interconnect, the Cholesky factor is computed redundantly on every
device (k×k — cheaper than broadcasting), and the triangular solve is
local. This replaces both the reference's threaded-BLAS CholQR
(rl_orth.hh:69) and its column-blocked Gram loops
(rl_cholqr_linops.hh:217-231) with a mesh dimension.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import STABLE_PRECISION


def dist_gram(A: jax.Array, mesh: Mesh, axis: str = "rows",
              precision=STABLE_PRECISION) -> jax.Array:
    """G = AᵀA for row-sharded A — local matmul + one psum."""

    def local(a):
        g = jnp.matmul(a.T, a, precision=precision)
        return jax.lax.psum(g, axis)

    return shard_map(local, mesh=mesh, in_specs=P(axis, None),
                     out_specs=P())(A)


def _band_guard_local(a, axis):
    """Shard-local half of ops/cholqr.py::_finite_scaled: sanitize
    non-finite entries and normalize by a power of 2 when the GLOBAL
    max|A| (one pmax over the mesh) would over- or underflow the Gram.
    Bitwise no-op on healthy data (scale == 1.0)."""
    finite = jnp.isfinite(a)
    nonfin = jax.lax.pmax(
        jnp.any(~finite).astype(jnp.int32), axis) > 0
    a = jnp.where(finite, a, 0.0)
    fi = jnp.finfo(a.dtype)
    m, n = a.shape
    big = jnp.sqrt(fi.max / (8.0 * m * n))    # conservative: local m
    small = jnp.asarray(fi.eps, a.dtype) ** 2
    mx = jax.lax.pmax(jnp.max(jnp.abs(a)), axis)
    in_band = ((mx <= big) & (mx >= small)) | (mx == 0.0)
    from ..ops.cholqr import _pow2   # exact 2^k (exp2/ldexp are not)
    k = jnp.round(jnp.log2(jnp.where(mx > 0, mx, 1.0))).astype(jnp.int32)
    s = jnp.where(in_band, jnp.asarray(1.0, a.dtype), _pow2(k, a.dtype))
    return a / s, s, nonfin


def dist_cholqr(A: jax.Array, mesh: Mesh, axis: str = "rows",
                passes: int = 2, precision=STABLE_PRECISION):
    """Distributed CholeskyQR over row shards. Returns ``(Q, R, fail)``
    with Q sharded like A and R replicated. ``passes=2`` (CholQR2) is the
    stability default."""
    n = A.shape[1]

    def one_pass(a):
        a, s, nonfin = _band_guard_local(a, axis)
        g = jax.lax.psum(jnp.matmul(a.T, a, precision=precision), axis)
        l = jax.lax.linalg.cholesky(g)
        fail = jnp.any(jnp.isnan(l)) | nonfin
        q = jax.lax.linalg.triangular_solve(l.T, a, left_side=False,
                                            lower=False)
        return q, l.T * s, fail

    def local(a):
        q, r, fail = one_pass(a)
        for _ in range(passes - 1):
            q, r2, f2 = one_pass(q)
            r = jnp.matmul(r2, r, precision=precision)
            fail = fail | f2
        return q, r, fail

    return shard_map(local, mesh=mesh, in_specs=P(axis, None),
                     out_specs=(P(axis, None), P(), P()))(A)


def dist_shifted_cholqr3(A: jax.Array, mesh: Mesh, axis: str = "rows",
                         precision=STABLE_PRECISION):
    """Distributed shifted CholeskyQR3 (rl_scholqr3_linops.hh capability
    over a mesh): survives cond(A) ~ 1/eps without Householder."""
    n = A.shape[1]

    def local(a):
        a, sc, nonfin = _band_guard_local(a, axis)
        g = jax.lax.psum(jnp.matmul(a.T, a, precision=precision), axis)
        eps = jnp.finfo(a.dtype).eps
        s = 11.0 * eps * n * jnp.trace(g)
        l1 = jax.lax.linalg.cholesky(g + s * jnp.eye(n, dtype=a.dtype))
        fail = jnp.any(jnp.isnan(l1)) | nonfin
        q = jax.lax.linalg.triangular_solve(l1.T, a, left_side=False,
                                            lower=False)
        r = l1.T * sc
        for _ in range(2):
            g2 = jax.lax.psum(jnp.matmul(q.T, q, precision=precision), axis)
            l2 = jax.lax.linalg.cholesky(g2)
            fail = fail | jnp.any(jnp.isnan(l2))
            q = jax.lax.linalg.triangular_solve(l2.T, q, left_side=False,
                                                lower=False)
            r = jnp.matmul(l2.T, r, precision=precision)
        return q, r, fail

    return shard_map(local, mesh=mesh, in_specs=P(axis, None),
                     out_specs=(P(axis, None), P(), P()))(A)
