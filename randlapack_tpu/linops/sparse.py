"""Sparse linear operator over jax.experimental.sparse BCOO
(reference: rl_sparse_linop.hh wraps RandBLAS CSR/CSC/COO; here the
batched-COO format is the XLA-lowerable one, and spmm lowers to
gather/scatter + dot fusions).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse


@jax.tree_util.register_pytree_node_class
class SparseLinOp:
    """Wraps a BCOO matrix as a linear operator."""

    def __init__(self, A: jsparse.BCOO):
        self.A = A

    @classmethod
    def from_coo(cls, rows, cols, vals, shape):
        idx = jnp.stack([jnp.asarray(rows), jnp.asarray(cols)], axis=1)
        return cls(jsparse.BCOO((jnp.asarray(vals), idx), shape=shape))

    @classmethod
    def from_dense(cls, mat, nse=None):
        return cls(jsparse.BCOO.fromdense(mat, nse=nse))

    # pytree
    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    # protocol
    @property
    def n_rows(self):
        return self.A.shape[0]

    @property
    def n_cols(self):
        return self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    def matmat(self, X, precision=None):
        return self.A @ X

    def tmatmat(self, X, precision=None):
        return self.A.T @ X

    def rmatmat(self, X, precision=None):
        return X @ self.A

    def fro_nrm(self):
        return jnp.linalg.norm(self.A.data)

    def to_dense(self):
        return self.A.todense()

    def cols(self, start, size: int, precision=None):
        """Materialize ``size`` columns from (traced) ``start`` via a
        one-hot selector (spmm keeps it sparse-friendly)."""
        sel = (jnp.arange(self.n_cols)[:, None]
               == (start + jnp.arange(size))[None, :]).astype(self.dtype)
        return self.A @ sel

    # views: BCOO slicing keeps nse static by masking out-of-range entries
    def row_block(self, start: int, stop: int):
        rows = self.A.indices[:, 0]
        keep = (rows >= start) & (rows < stop)
        idx = jnp.stack([jnp.where(keep, rows - start, stop - start),
                         self.A.indices[:, 1]], axis=1)
        data = jnp.where(keep, self.A.data, 0)
        # out-of-range entries are parked at a padded row then dropped by shape
        m = stop - start
        idx = jnp.stack([jnp.clip(idx[:, 0], 0, m - 1), idx[:, 1]], axis=1)
        return SparseLinOp(
            jsparse.BCOO((data, idx), shape=(m, self.n_cols)))

    def col_block(self, start: int, stop: int):
        cols = self.A.indices[:, 1]
        keep = (cols >= start) & (cols < stop)
        n = stop - start
        new_cols = jnp.clip(jnp.where(keep, cols - start, 0), 0, n - 1)
        idx = jnp.stack([self.A.indices[:, 0], new_cols], axis=1)
        data = jnp.where(keep, self.A.data, 0)
        return SparseLinOp(
            jsparse.BCOO((data, idx), shape=(self.n_rows, n)))
