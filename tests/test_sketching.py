"""Sketching substrate tests — reproducibility, isometry moments, SASO
structure. Mirrors RandBLAS's own guarantees as used by the reference
(SURVEY.md §2.9)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState
from randlapack_tpu import sketching as sk


class TestRNGState:
    def test_reproducible(self):
        s = RNGState(42)
        k1, s1 = s.spawn()
        k1b, _ = RNGState(42).spawn()
        assert jnp.all(jax.random.key_data(k1) == jax.random.key_data(k1b))

    def test_advances(self):
        s = RNGState(42)
        k1, s1 = s.spawn()
        k2, s2 = s1.spawn()
        assert not jnp.all(jax.random.key_data(k1) == jax.random.key_data(k2))
        assert int(s2.counter) == 2

    def test_branch_independent(self):
        s = RNGState(7)
        b1, b2 = s.branch(1), s.branch(2)
        k1, _ = b1.spawn()
        k2, _ = b2.spawn()
        assert not jnp.all(jax.random.key_data(k1) == jax.random.key_data(k2))

    def test_jit_traceable(self):
        @jax.jit
        def draw(state):
            key, state = state.spawn()
            return jax.random.normal(key, (4,)), state

        x1, _ = draw(RNGState(3))
        x2, _ = draw(RNGState(3))
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


class TestDenseSketch:
    def test_gaussian_moments(self):
        dist = sk.DenseDist(2000, 300)
        S, _ = sk.fill_dense(dist, RNGState(0), dtype=jnp.float64)
        assert S.shape == (2000, 300)
        assert abs(float(jnp.mean(S))) < 0.01
        assert abs(float(jnp.var(S)) - 1.0) < 0.02

    def test_uniform_moments(self):
        dist = sk.DenseDist(2000, 300, sk.ScalarDist.Uniform)
        S, _ = sk.fill_dense(dist, RNGState(0), dtype=jnp.float64)
        assert float(jnp.max(jnp.abs(S))) < np.sqrt(3) + 1e-12
        assert abs(float(jnp.var(S)) - 1.0) < 0.02

    def test_isometry(self):
        # E[SᵀS/d] = I for the scaled operator used in sketch_left
        d, m, n = 256, 2048, 32
        op, _ = sk.dense_skop(sk.DenseDist(d, m), RNGState(1),
                              dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(0), (m, n), dtype=jnp.float64)
        SA = sk.sketch_left(op, A)
        # norms preserved to ~1/sqrt(d)
        ratio = jnp.linalg.norm(SA) / jnp.linalg.norm(A)
        assert abs(float(ratio) - 1.0) < 0.15


class TestSASO:
    def test_structure(self):
        dist = sk.SparseDist(50, 400, vec_nnz=4)
        op, _ = sk.fill_sparse(dist, RNGState(0), dtype=jnp.float64)
        assert op.rows.shape == (4, 400)
        assert int(jnp.max(op.rows)) < 50
        # distinct rows per column
        rows = np.asarray(op.rows)
        for c in range(0, 400, 37):
            assert len(set(rows[:, c])) == 4
        assert set(np.unique(np.asarray(op.vals))) <= {-1.0, 1.0}

    def test_apply_matches_dense(self):
        dist = sk.SparseDist(50, 400, vec_nnz=3)
        op, _ = sk.fill_sparse(dist, RNGState(5), dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(1), (400, 20), dtype=jnp.float64)
        S_dense = sk.saso_to_dense(op, dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(sk.saso_left_apply(op, A)),
                                   np.asarray(S_dense @ A), rtol=1e-12, atol=1e-13)

    def test_right_apply_matches_dense(self):
        # tall m×d operator sketching columns of a (n×m) matrix
        dist = sk.SparseDist(400, 50, vec_nnz=3)
        op, _ = sk.fill_sparse(dist, RNGState(6), dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(2), (20, 400), dtype=jnp.float64)
        S_dense = sk.saso_to_dense(op, dtype=jnp.float64)
        assert S_dense.shape == (400, 50)
        np.testing.assert_allclose(np.asarray(sk.saso_right_apply(A, op)),
                                   np.asarray(A @ S_dense), rtol=1e-12, atol=1e-13)

    def test_subspace_embedding(self):
        # SASO with d = 4n distorts singular values of an orthonormal basis
        # by a modest factor — the property CQRRPT relies on.
        m, n, d = 4000, 50, 200
        Q, _ = jnp.linalg.qr(jax.random.normal(jax.random.key(3), (m, n),
                                               dtype=jnp.float64))
        op, _ = sk.fill_sparse(sk.SparseDist(d, m, vec_nnz=8), RNGState(9),
                               dtype=jnp.float64)
        SQ = sk.saso_left_apply(op, Q)
        s = jnp.linalg.svd(SQ, compute_uv=False)
        assert float(s[0]) < 2.0 and float(s[-1]) > 0.3


class TestSRHT:
    def test_fwht_orthogonal(self):
        x = jax.random.normal(jax.random.key(0), (256, 8), dtype=jnp.float64)
        y = sk.fwht(x)
        # H Hᵀ = m I
        np.testing.assert_allclose(float(jnp.linalg.norm(y) ** 2),
                                   256 * float(jnp.linalg.norm(x) ** 2),
                                   rtol=1e-10)

    def test_fwht_matches_naive(self):
        import scipy.linalg as sla
        m = 64
        x = np.random.default_rng(0).normal(size=(m, 3))
        H = sla.hadamard(m).astype(np.float64)
        y = sk.fwht(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), H @ x, rtol=1e-10)

    def test_embedding(self):
        m, n, d = 1000, 40, 320
        A = jax.random.normal(jax.random.key(1), (m, n), dtype=jnp.float64)
        op, _ = sk.srht_skop(d, m, RNGState(2), dtype=jnp.float64)
        SA = sk.srht_left_apply(op, A)
        assert SA.shape == (d, n)
        s_ref = jnp.linalg.svd(A, compute_uv=False)
        s_sk = jnp.linalg.svd(SA, compute_uv=False)
        ratio = np.asarray(s_sk / s_ref)
        assert ratio.max() < 1.6 and ratio.min() > 0.5


class TestSampling:
    def test_cdf_and_iid(self):
        w = jnp.asarray([0.0, 1.0, 3.0, 0.0], dtype=jnp.float64)
        cdf = sk.weights_to_cdf(w)
        np.testing.assert_allclose(np.asarray(cdf), [0, 0.25, 1.0, 1.0])
        idx, _ = sk.sample_indices_iid(cdf, 4000, RNGState(0))
        counts = np.bincount(np.asarray(idx), minlength=4)
        assert counts[0] == 0 and counts[3] == 0
        assert abs(counts[1] / 4000 - 0.25) < 0.05

    def test_distinct(self):
        idx, _ = sk.sample_distinct_uniform(10, 4, 257, RNGState(1), chunk=64)
        assert idx.shape == (257, 4)
        a = np.asarray(idx)
        assert all(len(set(r)) == 4 for r in a)
        assert a.min() >= 0 and a.max() < 10


class TestSparseData:
    def test_conversions_roundtrip(self):
        from randlapack_tpu.sketching import sparse_data as sd
        rng = np.random.default_rng(0)
        m, n, nnz = 30, 20, 120
        rows = rng.integers(0, m, nnz).astype(np.int32)
        cols = rng.integers(0, n, nnz).astype(np.int32)
        vals = rng.standard_normal(nnz)
        D = np.asarray(sd.coo_to_dense(rows, cols, vals, (m, n)))
        indptr, idx, data = sd.coo_to_csr(rows, cols, vals, (m, n))
        r2, c2, v2 = sd.csr_to_coo(indptr, idx, data)
        D2 = np.asarray(sd.coo_to_dense(r2, c2, v2, (m, n)))
        np.testing.assert_allclose(D2, D, atol=1e-14)
        # CSC = CSR of transpose
        indptr_c, idx_c, data_c = sd.coo_to_csc(rows, cols, vals, (m, n))
        rT, cT, vT = sd.csr_to_coo(indptr_c, idx_c, data_c)
        DT = np.asarray(sd.coo_to_dense(rT, cT, vT, (n, m)))
        np.testing.assert_allclose(DT, D.T, atol=1e-14)
        # dense_to_coo roundtrip
        r3, c3, v3 = sd.dense_to_coo(jnp.asarray(D))
        np.testing.assert_allclose(
            np.asarray(sd.coo_to_dense(r3, c3, v3, (m, n))), D, atol=1e-14)

    def test_spmm_bcoo_bcsr(self):
        from randlapack_tpu.sketching import sparse_data as sd
        rng = np.random.default_rng(1)
        m, n, nnz = 25, 15, 80
        rows = rng.integers(0, m, nnz).astype(np.int32)
        cols = rng.integers(0, n, nnz).astype(np.int32)
        vals = rng.standard_normal(nnz)
        D = np.asarray(sd.coo_to_dense(rows, cols, vals, (m, n)))
        B = rng.standard_normal((n, 4))
        bcoo = sd.to_bcoo(rows, cols, vals, (m, n))
        np.testing.assert_allclose(np.asarray(sd.left_spmm(bcoo, jnp.asarray(B))),
                                   D @ B, atol=1e-12)
        indptr, idx, data = sd.coo_to_csr(rows, cols, vals, (m, n))
        bcsr = sd.to_bcsr(indptr, idx, data, (m, n))
        np.testing.assert_allclose(np.asarray(sd.left_spmm(bcsr, jnp.asarray(B))),
                                   D @ B, atol=1e-12)
        A = rng.standard_normal((6, m))
        np.testing.assert_allclose(np.asarray(sd.right_spmm(jnp.asarray(A), bcoo)),
                                   A @ D, atol=1e-12)


class TestSASOGatherApply:
    """Gather-layer SASO apply == scatter reference (SURVEY.md §7
    "SASO")."""

    def test_matches_scatter(self):
        from randlapack_tpu.sketching import (SparseDist, fill_sparse,
                                              saso_left_apply)
        for (d, m, nnz, n) in [(64, 1000, 2, 33), (40, 300, 4, 7),
                               (128, 128, 8, 16)]:
            op, _ = fill_sparse(SparseDist(d, m, nnz), RNGState(0),
                                dtype=jnp.float64)
            A = jax.random.normal(jax.random.key(1), (m, n), jnp.float64)
            o1 = saso_left_apply(op, A, method="scatter")
            o2 = saso_left_apply(op, A, method="gather")
            np.testing.assert_allclose(np.asarray(o2), np.asarray(o1),
                                       atol=1e-12)

    def test_gather_jits(self):
        from randlapack_tpu.sketching import (SparseDist, fill_sparse,
                                              saso_left_apply)
        op, _ = fill_sparse(SparseDist(32, 500, 2), RNGState(2),
                            dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(3), (500, 5), jnp.float64)
        f = jax.jit(lambda s, a: saso_left_apply(s, a, method="gather"))
        np.testing.assert_allclose(
            np.asarray(f(op, A)),
            np.asarray(saso_left_apply(op, A, method="scatter")),
            atol=1e-12)


class TestSparseTrsm:
    """Device-side blocked sparse triangular solve — the RandBLAS
    sparse_data::trsm capability (SURVEY.md §2.9)."""

    def _tri(self, n, lower, seed=0, diagless=False):
        import scipy.sparse as sp
        rng = np.random.default_rng(seed)
        T = sp.random(n, n, density=0.02, random_state=rng)
        T = sp.tril(T, -1) if lower else sp.triu(T, 1)
        if not diagless:
            T = T + sp.diags(rng.uniform(1, 2, n))
        return T.tocoo(), rng

    def test_lower_upper_multirhs(self):
        import scipy.sparse as sp
        from randlapack_tpu.sketching.sparse_data import sparse_trsm
        for lower in [True, False]:
            T, rng = self._tri(500, lower)
            B = rng.standard_normal((500, 7))
            X = sparse_trsm(T.row, T.col, T.data, 500, jnp.asarray(B),
                            lower=lower, block=64)
            Xr = sp.linalg.spsolve_triangular(T.tocsr(), B, lower=lower)
            np.testing.assert_allclose(np.asarray(X), Xr, atol=1e-11)

    def test_unit_diagonal_ignores_stored_diag(self):
        import scipy.sparse as sp
        from randlapack_tpu.sketching.sparse_data import sparse_trsm
        T, rng = self._tri(200, True)      # has a stored non-unit diagonal
        b = rng.standard_normal(200)
        x = sparse_trsm(T.row, T.col, T.data, 200, jnp.asarray(b),
                        lower=True, unit_diagonal=True, block=64)
        Tu = (sp.tril(T, -1) + sp.eye(200)).tocsr()
        xr = sp.linalg.spsolve_triangular(Tu, b, lower=True)
        np.testing.assert_allclose(np.asarray(x), xr, atol=1e-12)

    def test_non_multiple_block(self):
        import scipy.sparse as sp
        from randlapack_tpu.sketching.sparse_data import sparse_trsm
        T, rng = self._tri(333, True, seed=3)
        B = rng.standard_normal((333, 3))
        X = sparse_trsm(T.row, T.col, T.data, 333, jnp.asarray(B),
                        lower=True, block=128)
        Xr = sp.linalg.spsolve_triangular(T.tocsr(), B, lower=True)
        np.testing.assert_allclose(np.asarray(X), Xr, atol=1e-11)
