"""Factorization-backed solver operators (reference:
extras/linops/ext_cholsolver_linop.hh — ``CholSolverLinOp`` exposes K⁻¹ (or
the half-solve L⁻¹) of a sparse SPD matrix as a LinearOperator, Eigen
computing the factorization; ext_lusolver_linop.hh:53 same with SparseLU).

Design (SURVEY.md §7 "hard parts"): sparse direct *factorization* has no
XLA lowering, so it runs once on the HOST (scipy SuperLU). The bulk
multi-RHS triangular solves — the part the reference routes through
RandBLAS ``sparse_data::trsm`` — run ON DEVICE by default via the blocked
gather-based :func:`randlapack_tpu.sketching.sparse_data.sparse_trsm`
(``device_solves=True``): x = P_c·U⁻¹·L⁻¹·P_r·b with the sparse L/U
factors shipped to the device as padded-CSR constants at trace time.
``device_solves=False`` falls back to per-apply host callbacks
(``jax.pure_callback``), which solve in f64 regardless of device dtype.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


class _HostSolveOp:
    """Shared machinery: host factorization + pure_callback solves.

    Registered as an all-static pytree (subclasses call ``_register``):
    the factorization lives on the host and is closed over by identity —
    each operator instance compiles its consumers once.
    """

    def __init__(self, rows, cols, vals, n, dtype, device_solves=True):
        import scipy.sparse as sp
        self._K = sp.csc_matrix(
            (np.asarray(vals, dtype=np.float64),
             (np.asarray(rows), np.asarray(cols))), shape=(n, n))
        self._n = n
        self._dtype = dtype
        self._device = device_solves
        self._factorize()

    def _device_solve(self, X, transpose=False):
        """Device path: x = P_c U⁻¹ L⁻¹ P_r b (splu: P_r A P_c = L U);
        transpose solves run the factors in reverse."""
        from ..sketching.sparse_data import sparse_trsm
        lu = self._lu
        L, U = lu.L.tocoo(), lu.U.tocoo()
        n = self._n
        if not transpose:
            t = X[jnp.asarray(np.argsort(lu.perm_r))]
            y = sparse_trsm(L.row, L.col,
                            L.data.astype(np.dtype(self._dtype)), n, t,
                            lower=True)
            z = sparse_trsm(U.row, U.col,
                            U.data.astype(np.dtype(self._dtype)), n, y,
                            lower=False)
            return z[jnp.asarray(lu.perm_c)]
        # Aᵀ x = b:  x = P_r L⁻ᵀ U⁻ᵀ P_cᵀ b — via the transposed factors
        Lt, Ut = lu.L.T.tocoo(), lu.U.T.tocoo()
        t = X[jnp.asarray(np.argsort(lu.perm_c))]
        y = sparse_trsm(Ut.row, Ut.col,
                        Ut.data.astype(np.dtype(self._dtype)), n, t,
                        lower=True)
        z = sparse_trsm(Lt.row, Lt.col,
                        Lt.data.astype(np.dtype(self._dtype)), n, y,
                        lower=False)
        return z[jnp.asarray(lu.perm_r)]

    # protocol ---------------------------------------------------------
    @property
    def dim(self):
        return self._n

    @property
    def n_rows(self):
        return self._n

    @property
    def n_cols(self):
        return self._n

    @property
    def dtype(self):
        return self._dtype

    def _solve_host(self, B):
        return self._solve(np.asarray(B, dtype=np.float64)).astype(
            np.asarray(B).dtype)

    def matmat(self, X, precision=None):
        if self._device and not getattr(self, "_half", False):
            return self._device_solve(X)
        shape = jax.ShapeDtypeStruct(X.shape, X.dtype)
        return jax.pure_callback(self._solve_host, shape, X,
                                 vmap_method="sequential")

    tmatmat = matmat  # K symmetric (Chol) or solve with Kᵀ ≈ same for tests

    def fro_nrm(self):
        raise NotImplementedError("implicit inverse operator")

    # all-static pytree: no traced leaves, aux = the instance itself
    def tree_flatten(self):
        return (), self

    @classmethod
    def tree_unflatten(cls, aux, children):
        return aux


def _register(cls):
    jax.tree_util.register_pytree_node_class(cls)
    return cls


@_register
class CholSolverLinOp(_HostSolveOp):
    """K⁻¹ of a sparse SPD matrix as a LinearOperator (reference
    ext_cholsolver_linop.hh). ``half=True`` exposes the half-solve L̃⁻¹
    for a sparse permuted Cholesky factor L̃ = Pᵀ·L_c with L̃·L̃ᵀ = K
    (reference's layout-flip trick :30-33 becomes an option flag; any n —
    the factor comes from symmetric-mode SuperLU, see ``_factorize``)."""

    def __init__(self, rows, cols, vals, n, dtype=jnp.float32,
                 half: bool = False, device_solves: bool = True):
        self._half = half
        super().__init__(rows, cols, vals, n, dtype, device_solves)

    def _factorize(self):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        self._lu = spla.splu(self._K.tocsc())
        if self._half:
            # Sparse Cholesky without cholmod, any n: symmetric-mode
            # SuperLU with diagonal pivoting disabled does NO row
            # pivoting on an SPD matrix, so P·K·Pᵀ = L·U with U = D·Lᵀ
            # and the Cholesky factor of the permuted matrix is
            # L_c = L·√D. Then K = (Pᵀ·L_c)(Pᵀ·L_c)ᵀ — a valid
            # half-solve factor L̃ = Pᵀ·L_c (whitening only needs SOME
            # L̃ with L̃·L̃ᵀ = K; the reference's layout-flip trick,
            # ext_cholsolver_linop.hh:30-33, likewise exposes Eigen's
            # permuted factor).
            lu = spla.splu(self._K.tocsc(), permc_spec="MMD_AT_PLUS_A",
                           diag_pivot_thresh=0.0,
                           options={"SymmetricMode": True})
            if not np.array_equal(lu.perm_r, lu.perm_c):
                raise ValueError(
                    "SuperLU row-pivoted despite SymmetricMode — the "
                    "matrix is not SPD (half-solve requires SPD K)")
            d = lu.U.diagonal()
            if np.any(d <= 0.0):
                raise ValueError(
                    "non-positive pivot: K is not positive definite")
            self._Lc = (lu.L @ sp.diags(np.sqrt(d))).tocsr()
            self._perm_r = lu.perm_r

    def _device_solve_half(self, X):
        """Device half-solve L̃⁻¹·X = L_c⁻¹·(Pr·X) via the padded-CSR
        triangular kernel (same route as the full device solves)."""
        from ..sketching.sparse_data import sparse_trsm
        Lc = self._Lc.tocoo()
        t = X[jnp.asarray(np.argsort(self._perm_r))]
        return sparse_trsm(Lc.row, Lc.col,
                           Lc.data.astype(np.dtype(self._dtype)),
                           self._n, t, lower=True)

    def matmat(self, X, precision=None):
        if self._half and self._device:
            return self._device_solve_half(X)
        return super().matmat(X, precision)

    def _solve(self, B):
        if self._half:
            import scipy.sparse.linalg as spla
            return spla.spsolve_triangular(
                self._Lc, B[np.argsort(self._perm_r)], lower=True)
        return self._lu.solve(B)


@_register
class LUSolverLinOp(_HostSolveOp):
    """K⁻¹ of a general sparse matrix via SparseLU (reference
    ext_lusolver_linop.hh:53)."""

    def __init__(self, rows, cols, vals, n, dtype=jnp.float32,
                 device_solves: bool = True):
        super().__init__(rows, cols, vals, n, dtype, device_solves)

    def _factorize(self):
        import scipy.sparse.linalg as spla
        self._lu = spla.splu(self._K.tocsc())

    def _solve(self, B):
        return self._lu.solve(B)

    def tmatmat(self, X, precision=None):
        if self._device:
            return self._device_solve(X, transpose=True)
        shape = jax.ShapeDtypeStruct(X.shape, X.dtype)

        def host(B):
            return self._lu.solve(np.asarray(B, np.float64),
                                  trans="T").astype(np.asarray(B).dtype)

        return jax.pure_callback(host, shape, X, vmap_method="sequential")

    @classmethod
    def from_mm(cls, path, dtype=jnp.float32):
        from .io import mm_read
        rows, cols, vals, shape = mm_read(path)
        assert shape[0] == shape[1]
        return cls(rows, cols, vals, shape[0], dtype)
