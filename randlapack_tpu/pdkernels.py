"""Positive-definite kernel utilities + kernel linear operator
(reference: RandLAPACK/misc/rl_pdkernels.hh: standardize_dataset :34,
euclidean_distance_submatrix :74, squared_exp_kernel :102,
squared_exp_kernel_submatrix :133, block_arrowhead_multiply :161).

Data convention: X is (d, n) — n points in d dimensions, one point per
column (the reference's convention). All distance math is GEMM-based; the
OpenMP-blocked entrywise kernel of the reference becomes a fused XLA
elementwise-over-GEMM, or on a GPU one fused kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import STABLE_PRECISION


def standardize_dataset(X: jax.Array) -> jax.Array:
    """Center each coordinate (row) and scale so the average squared column
    norm is the dimension count — the reference's preprocing for kernel
    matrices with unit diagonal scale."""
    Xc = X - jnp.mean(X, axis=1, keepdims=True)
    scale = jnp.sqrt(jnp.mean(jnp.sum(Xc * Xc, axis=0)) / X.shape[0])
    return Xc / jnp.maximum(scale, jnp.finfo(X.dtype).tiny)


def squared_distances(XI: jax.Array, XJ: jax.Array,
                      precision=STABLE_PRECISION) -> jax.Array:
    """Pairwise squared Euclidean distances between columns of XI (d,p) and
    XJ (d,q) → (p, q); GEMM-based (euclidean_distance_submatrix)."""
    ni = jnp.sum(XI * XI, axis=0)
    nj = jnp.sum(XJ * XJ, axis=0)
    cross = jnp.matmul(XI.T, XJ, precision=precision)
    return jnp.maximum(ni[:, None] + nj[None, :] - 2.0 * cross, 0.0)


def squared_exp_kernel(XI: jax.Array, XJ: jax.Array, bandwidth,
                       precision=STABLE_PRECISION) -> jax.Array:
    """k(x, y) = exp(−‖x−y‖² / (2σ²)) for all column pairs."""
    d2 = squared_distances(XI, XJ, precision)
    return jnp.exp(-d2 / (2.0 * bandwidth ** 2))


def squared_exp_kernel_submatrix(X: jax.Array, rows: jax.Array,
                                 cols: jax.Array, bandwidth,
                                 precision=STABLE_PRECISION) -> jax.Array:
    """K[rows, cols] for the squared-exponential kernel over X (d, n)."""
    return squared_exp_kernel(jnp.take(X, rows, axis=1),
                              jnp.take(X, cols, axis=1), bandwidth, precision)


def block_arrowhead_multiply(D_diag: jax.Array, B: jax.Array, C: jax.Array,
                             V: jax.Array, precision=STABLE_PRECISION):
    """Multiply the block-arrowhead matrix [[diag(D), B], [Bᵀ, C]] by V —
    helper for restricted KRR systems (rl_pdkernels.hh:161)."""
    k = D_diag.shape[0]
    V1, V2 = V[:k, :], V[k:, :]
    top = D_diag[:, None] * V1 + jnp.matmul(B, V2, precision=precision)
    bot = (jnp.matmul(B.T, V1, precision=precision)
           + jnp.matmul(C, V2, precision=precision))
    return jnp.concatenate([top, bot], axis=0)


@jax.tree_util.register_pytree_node_class
class SquaredExpKernelLinOp:
    """Implicit kernel matrix K(X, X) + μ·I as a symmetric linop — the
    KRILL working operator (reference: RegExplicitSymLinOp over a kernel,
    rl_krill.hh usage). Column evaluation (`columns`) is what RPCholesky
    needs; `matmat` evaluates K blockwise to cap memory at O(n·block).
    """

    def __init__(self, X: jax.Array, bandwidth, mus,
                 evals_include_reg: bool = True, block: int = 2048):
        self.X = X
        self.bandwidth = jnp.asarray(bandwidth, X.dtype)
        self.mus = jnp.atleast_1d(jnp.asarray(mus, X.dtype))
        self.evals_include_reg = evals_include_reg
        self.block = block

    def tree_flatten(self):
        return (self.X, self.bandwidth, self.mus), (self.evals_include_reg,
                                                    self.block)

    @classmethod
    def tree_unflatten(cls, aux, children):
        X, bw, mus = children
        return cls(X, bw, mus, aux[0], aux[1])

    def with_reg(self, flag: bool):
        return SquaredExpKernelLinOp(self.X, self.bandwidth, self.mus, flag,
                                     self.block)

    @property
    def dim(self):
        return self.X.shape[1]

    n_rows = n_cols = dim

    @property
    def num_ops(self):
        return self.mus.shape[0]

    @property
    def dtype(self):
        return self.X.dtype

    def diagonal(self):
        d = jnp.ones((self.dim,), self.X.dtype)
        if self.evals_include_reg:
            assert self.num_ops == 1
            d = d + self.mus[0]
        return d

    def columns(self, idx: jax.Array):
        cols = squared_exp_kernel(self.X, jnp.take(self.X, idx, axis=1),
                                  self.bandwidth)
        if self.evals_include_reg:
            assert self.num_ops == 1
            onehots = (jnp.arange(self.dim)[:, None] == idx[None, :])
            cols = cols + self.mus[0] * onehots.astype(cols.dtype)
        return cols

    def matmat(self, V: jax.Array, precision=STABLE_PRECISION):
        """K V (+ per-column μ V), evaluated in column blocks of K so the
        n×n kernel matrix never fully materializes. On a GPU with f32
        points this dispatches to the fused kernel
        (``ops.pallas_kernels.kernel_matmat``), which writes no block of
        K to device memory at all."""
        n = self.dim
        from .ops.pallas_kernels import kernel_matmat, use_fused_matmat
        if use_fused_matmat(jax.default_backend(), self.X.shape[0],
                            self.X.dtype):
            out = kernel_matmat(self.X, V, self.bandwidth)
            if self.evals_include_reg:
                if self.num_ops == 1:
                    out = out + self.mus[0] * V
                else:
                    out = out + V * self.mus[None, :]
            return out
        b = min(self.block, n)
        nblocks = -(-n // b)
        out = jnp.zeros_like(V)

        def body(i, acc):
            start = i * b
            idx = jnp.clip(start + jnp.arange(b), 0, n - 1)
            Kb = squared_exp_kernel(self.X, jnp.take(self.X, idx, axis=1),
                                    self.bandwidth, precision)  # (n, b)
            Vb = jnp.take(V, idx, axis=0)                        # (b, s)
            mask = ((start + jnp.arange(b)) < n).astype(V.dtype)
            return acc + jnp.matmul(Kb * mask[None, :], Vb,
                                    precision=precision)

        out = jax.lax.fori_loop(0, nblocks, body, out)
        if self.evals_include_reg:
            if self.num_ops == 1:
                out = out + self.mus[0] * V
            else:
                assert V.shape[1] == self.num_ops
                out = out + V * self.mus[None, :]
        return out

    tmatmat = matmat

    def fro_nrm(self):
        raise NotImplementedError("implicit kernel operator")
