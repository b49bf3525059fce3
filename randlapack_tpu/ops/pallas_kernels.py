"""Fused squared-exponential kernel matmat for NVIDIA GPUs (Pallas through
Triton).

``kernel_matmat`` computes K(X, X)·V for the squared-exponential kernel
without writing any block of K to device memory: each program owns a
``block_rows``-row tile of the output and loops over the column tiles,
building a kernel tile in registers (distance GEMM + exp) and contracting it
with the matching rows of V at once. The plain path
(``pdkernels.SquaredExpKernelLinOp.matmat``) writes and reads every n×block
slab of K for each matmat, which grows as n². This is KRILL's matvec on
every PCG iteration (the reference's OpenMP-blocked entrywise kernel,
rl_pdkernels.hh:133).

Every product runs at full f32 (``Precision.HIGHEST`` lowers to Triton's
IEEE dot), so the kernel agrees with ``kernel_matmat_reference`` to f32
rounding. The squared distances are summed by unrolled FMAs over the d
coordinates (exact differences, no norm expansion). One right-hand side
is a row reduction; more are zero-padded to a power of two of at least 16
(Triton's smallest dot operand) for one dot per tile. n is zero-padded to
a multiple of the tile, with zero rows of V so padded points contribute
nothing.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION

# tiling measured on an H100 (700 W) at n=8192, d=8: within 6% of the best
# of eight tilings at s=1 and the best at s=64 (PERF.md, PR 1)
TM = 32          # output rows per program (default ``block_rows``)
TN = 32          # kernel columns per inner-loop step (``block_cols``)
SPLITS = 8       # column ranges per row tile (``col_splits``)
NUM_WARPS = 2
MAX_D = 64       # points of higher dimension take the plain path


def kernel_matmat_reference(X, V, bandwidth, precision=STABLE_PRECISION):
    """Plain K(X, X)·V: forms the whole n×n kernel matrix."""
    d2 = (jnp.sum(X * X, axis=0)[:, None]
          + jnp.sum(X * X, axis=0)[None, :]
          - 2.0 * jnp.matmul(X.T, X, precision=precision))
    K = jnp.exp(-jnp.maximum(d2, 0.0) / (2.0 * bandwidth ** 2))
    return jnp.matmul(K, V, precision=precision)


def use_fused_matmat(platform: str, d: int, dtype) -> bool:
    """Whether ``SquaredExpKernelLinOp.matmat`` takes the fused kernel: on
    a GPU, for f32 points of dimension at most ``MAX_D``. Everything else
    (the CPU, f64) takes the plain blocked path."""
    return (platform == "gpu" and jnp.dtype(dtype) == jnp.float32
            and d <= MAX_D)


def _pow2_at_least_16(k: int) -> int:
    return max(16, 1 << max(k - 1, 0).bit_length())


@functools.partial(jax.jit, static_argnames=("interpret", "block_rows",
                                             "block_cols", "col_splits",
                                             "num_warps"))
def kernel_matmat(X: jax.Array, V: jax.Array, bandwidth,
                  interpret: bool = False, block_rows: int = TM,
                  block_cols: int = TN, col_splits: int = SPLITS,
                  num_warps: int = NUM_WARPS) -> jax.Array:
    """K(X, X)·V for the squared-exponential kernel, fused.

    X: (d, n) points, one per column; V: (n, s). Returns (n, s) in
    X.dtype. Any n, d ≤ ``MAX_D`` and s; padding is handled here.
    ``interpret=True`` runs the kernel through the Pallas interpreter
    (the CPU tests); on the GPU it compiles through Triton.
    ``block_rows``/``block_cols`` (powers of two ≥ 16) and ``num_warps``
    set the tiling; each row tile's columns are split into
    ``col_splits`` ranges handled by separate programs (enough programs
    to fill the card), whose partial sums are added afterwards.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    d, n = X.shape
    s = V.shape[1]
    dtype = X.dtype
    # one right-hand side (KRILL's PCG): a row reduction, not a 16-wide dot
    vec = s == 1
    s_pad = 1 if vec else _pow2_at_least_16(s)
    tm, tn, P = block_rows, block_cols, col_splits
    tile = max(tm, tn * P)
    n_pad = -(-n // tile) * tile
    Xp = jnp.pad(X, ((0, 0), (0, n_pad - n)))
    Vp = jnp.pad(V.astype(dtype), ((0, n_pad - n), (0, s_pad - s)))
    if vec:
        Vp = Vp[:, 0]
    bw = jnp.asarray(bandwidth, dtype)
    scale = jnp.broadcast_to(-1.0 / (2.0 * bw * bw), (16,)).astype(dtype)
    tiles_per_split = n_pad // (tn * P)
    hp = jax.lax.Precision.HIGHEST

    def kern(scale_ref, x_ref, v_ref, o_ref):
        i = pl.program_id(0)
        j0 = pl.program_id(1) * tiles_per_split
        neg_inv = scale_ref[0]
        rows_i = pl.ds(i * tm, tm)
        xi = [x_ref[k, rows_i] for k in range(d)]        # d × (tm,)

        def body(j, acc):
            cols_j = pl.ds(j * tn, tn)
            d2 = jnp.zeros((tm, tn), jnp.float32)
            for k in range(d):
                diff = xi[k][:, None] - x_ref[k, cols_j][None, :]
                d2 = d2 + diff * diff
            kt = jnp.exp(d2 * neg_inv)                   # (tm, tn)
            if vec:
                return acc + jnp.sum(kt * v_ref[cols_j][None, :], axis=1)
            return acc + pl.dot(kt, v_ref[cols_j, :], precision=hp)

        acc0 = jnp.zeros((tm,) if vec else (tm, s_pad), jnp.float32)
        acc = jax.lax.fori_loop(j0, j0 + tiles_per_split, body, acc0)
        o_ref[...] = acc.astype(o_ref.dtype)

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(
            (P, n_pad) if vec else (P, n_pad, s_pad), jnp.float32),
        grid=(n_pad // tm, P),
        in_specs=[
            pl.BlockSpec((16,), lambda i, p: (0,)),
            pl.BlockSpec((d, n_pad), lambda i, p: (0, 0)),
            pl.BlockSpec(Vp.shape, lambda i, p: (0,) * Vp.ndim),
        ],
        out_specs=(pl.BlockSpec((None, tm), lambda i, p: (p, i)) if vec
                   else pl.BlockSpec((None, tm, s_pad),
                                     lambda i, p: (p, i, 0))),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=2),
        interpret=interpret,
        name="sqexp_kernel_matmat",
    )(scale, Xp, Vp)
    out = jnp.sum(out, axis=0).astype(dtype)
    if vec:
        return out[:n, None]
    return out[:n, :s]
