"""CSR/CSC block-view types (reference: RandLAPACK/linops/
rl_sparse_views.hh — ``CSRRowBlockView`` :27 zero-copy rowptr offset,
``CSRColBlock`` :56 copy+filter, ``CSCColBlockView`` :94, ``CSCRowBlock``
:119 + factory free functions).

Design: a "view" holds *references* to the parent's index/data
arrays plus offsets — no buffer copies at construction (the reference's
zero-copy semantics; JAX arrays are immutable so sharing is safe by
construction). CSC is carried as the CSR of the transpose (the module-wide
convention, see sketching/sparse_data.py). Application gathers rows — no
scatters — and materialization densifies only the viewed block.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["CSRMatrixView", "CSRRowBlockView", "CSRColBlock",
           "CSCColBlockView", "CSCRowBlock", "csr_row_block",
           "csr_col_block", "csc_col_block", "csc_row_block"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrixView:
    """A CSR matrix (or a row-window view into one): ``indptr`` addresses
    ``indices``/``data`` globally, with rows [row0, row0+n_rows)."""
    indptr: jax.Array                  # (parent_rows + 1,) int32
    indices: jax.Array                 # (nnz,) int32 — shared, never copied
    data: jax.Array                    # (nnz,)       — shared, never copied
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    row0: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def materialize(self):
        """Densify the viewed block (rl_materialize.hh fast path)."""
        nr, nc = self.shape
        out = jnp.zeros((nr, nc), self.data.dtype)
        lo = self.indptr[self.row0]
        hi = self.indptr[self.row0 + nr]
        k = jnp.arange(self.indices.shape[0])
        inside = (k >= lo) & (k < hi)
        # row of entry k: searchsorted over the windowed indptr
        r = jnp.searchsorted(self.indptr, k, side="right") - 1 - self.row0
        r = jnp.where(inside, r, nr)
        return out.at[r, jnp.where(inside, self.indices, 0)].add(
            jnp.where(inside, self.data, 0.0), mode="drop")

    def matmat(self, X, precision=None):
        """Gather-based spmm: (view) @ X."""
        return jnp.matmul(self.materialize(), X,
                          precision=precision)  # small blocks: densify

    def row_block(self, start: int, stop: int) -> "CSRRowBlockView":
        return csr_row_block(self, start, stop)

    def col_block(self, start: int, stop: int) -> "CSRColBlock":
        return csr_col_block(self, start, stop)


class CSRRowBlockView(CSRMatrixView):
    """Zero-copy row-window view (rl_sparse_views.hh:27): shares the
    parent's indptr/indices/data; only offsets change."""


class CSRColBlock(CSRMatrixView):
    """Column block of a CSR matrix — like the reference (:56) this one
    COPIES + filters (a column window of CSR has no zero-copy form).
    Storage stays in the parent's indptr addressing with out-of-window
    entries masked (static shapes: masked, not compacted)."""


def csr_row_block(A: CSRMatrixView, start: int, stop: int):
    """Zero-copy: same indices/data arrays, shifted row window."""
    return CSRRowBlockView(A.indptr, A.indices, A.data,
                           (stop - start, A.shape[1]),
                           row0=A.row0 + start)


def csr_col_block(A: CSRMatrixView, start: int, stop: int):
    """Copy + filter (reference :56): keep entries with start ≤ col <
    stop, rebase columns. Static shapes: entries are masked (data 0 /
    col 0), not compacted — the nnz bound is the parent's."""
    nr = A.shape[0]
    keep = (A.indices >= start) & (A.indices < stop)
    return CSRColBlock(A.indptr,
                       jnp.where(keep, A.indices - start, 0),
                       jnp.where(keep, A.data, 0.0),
                       (nr, stop - start), row0=A.row0)


def csc_col_block(At_csr: CSRMatrixView, start: int, stop: int):
    """CSC column window = zero-copy CSR row window of the transpose
    (rl_sparse_views.hh:94)."""
    return CSCColBlockView(csr_row_block(At_csr, start, stop))


def csc_row_block(At_csr: CSRMatrixView, start: int, stop: int):
    """CSC row window = CSR column block of the transpose (:119)."""
    return CSCRowBlock(csr_col_block(At_csr, start, stop))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSCColBlockView:
    """CSC column-window view — wraps the transpose's CSR row view
    (zero-copy) and transposes on materialization."""
    t: CSRRowBlockView

    @property
    def shape(self):
        return (self.t.shape[1], self.t.shape[0])

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    def materialize(self):
        return self.t.materialize().T

    def matmat(self, X, precision=None):
        return jnp.matmul(self.materialize(), X, precision=precision)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSCRowBlock:
    """CSC row window — wraps the transpose's CSR column block."""
    t: CSRColBlock

    @property
    def shape(self):
        return (self.t.shape[1], self.t.shape[0])

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    def materialize(self):
        return self.t.materialize().T

    def matmat(self, X, precision=None):
        return jnp.matmul(self.materialize(), X, precision=precision)
