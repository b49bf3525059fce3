"""Extras + aux-subsystem tests (reference: extras/test/linops/*,
test/misc/test_memory_tracker.cc)."""
import os
import tempfile

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from randlapack_tpu.extras import (CholSolverLinOp, LUSolverLinOp, mm_read,
                                   mm_write)
from randlapack_tpu.utils import (PeakRSSTracker, PhaseTimer,
                                  analytical_peak_bytes,
                                  device_memory_stats, device_sync)


def _spd_coo(n=60, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    K = A @ A.T + n * np.eye(n)
    rows, cols = np.nonzero(K)
    return rows, cols, K[rows, cols], K


class TestSolverLinops:
    def test_chol_solver(self):
        rows, cols, vals, K = _spd_coo()
        op = CholSolverLinOp(rows, cols, vals, K.shape[0], jnp.float64)
        B = jnp.asarray(np.random.default_rng(1).standard_normal((60, 3)))
        X = op.matmat(B)
        np.testing.assert_allclose(np.asarray(K @ np.asarray(X)),
                                   np.asarray(B), atol=1e-9)

    def test_half_solve(self):
        # the exposed factor is the permuted sparse Cholesky L̃ = Pᵀ·L_c
        # (any L̃ with L̃·L̃ᵀ = K is a valid half factor — whitening is
        # basis-free); verify the defining property and the solve
        rows, cols, vals, K = _spd_coo(40, 2)
        op = CholSolverLinOp(rows, cols, vals, 40, jnp.float64, half=True)
        Lc = op._Lc.toarray()
        Lt = Lc[op._perm_r]                  # permuted factor rows
        np.testing.assert_allclose(Lt @ Lt.T, K, atol=1e-9)
        B = jnp.asarray(np.random.default_rng(2).standard_normal((40, 2)))
        X = np.asarray(op.matmat(B))
        np.testing.assert_allclose(Lt @ X, np.asarray(B), atol=1e-9)
        # whitening: cov of L̃⁻¹·K·L̃⁻ᵀ = I
        W = np.asarray(op.matmat(jnp.asarray(K))) @ np.linalg.inv(Lt).T
        np.testing.assert_allclose(W, np.eye(40), atol=1e-8)

    def test_half_solve_large_n_host(self):
        # the former n<=4096 NotImplementedError is gone: the sparse
        # symmetric-mode factorization handles any n (here 5000, host
        # path to keep the CPU test fast)
        n = 5000
        rng = np.random.default_rng(5)
        diag = 4.0 + rng.random(n)
        rows = np.concatenate([np.arange(n), np.arange(n - 1),
                               np.arange(1, n)])
        cols = np.concatenate([np.arange(n), np.arange(1, n),
                               np.arange(n - 1)])
        vals = np.concatenate([diag, -np.ones(n - 1), -np.ones(n - 1)])
        op = CholSolverLinOp(rows, cols, vals, n, jnp.float64, half=True,
                             device_solves=False)
        B = jnp.asarray(rng.standard_normal((n, 2)))
        X = np.asarray(op.matmat(B))
        Lc = op._Lc
        Lt_X = (Lc @ X)[op._perm_r]          # (Pᵀ·L_c)·X
        np.testing.assert_allclose(Lt_X, np.asarray(B), atol=1e-9)

    def test_lu_solver_and_transpose(self):
        rng = np.random.default_rng(3)
        n = 50
        A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
        A += np.diag(5.0 + rng.random(n))
        rows, cols = np.nonzero(A)
        op = LUSolverLinOp(rows, cols, A[rows, cols], n, jnp.float64)
        B = jnp.asarray(rng.standard_normal((n, 2)))
        np.testing.assert_allclose(A @ np.asarray(op.matmat(B)),
                                   np.asarray(B), atol=1e-9)
        np.testing.assert_allclose(A.T @ np.asarray(op.tmatmat(B)),
                                   np.asarray(B), atol=1e-9)

    def test_composes_with_abrik(self):
        # spectral analysis of K^{-1} through the generic driver — the
        # GSVD-style workflow the reference extras enable
        from randlapack_tpu import RNGState
        from randlapack_tpu.drivers import ABRIKConfig, abrik
        rows, cols, vals, K = _spd_coo(64, 4)
        op = CholSolverLinOp(rows, cols, vals, 64, jnp.float64)
        U, S, Vt, _, _ = abrik(op, 4, ABRIKConfig(block_size=4, max_iters=8),
                               RNGState(0))
        w = np.sort(np.linalg.eigvalsh(K))
        # K has a near-degenerate eigenvalue cluster at the shift — Krylov
        # separates it slowly; the point here is operator composition
        np.testing.assert_allclose(np.asarray(S), 1.0 / w[:4], rtol=5e-3)


class TestMMIO:
    def test_roundtrip(self):
        rows, cols, vals, K = _spd_coo(30, 5)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "k.mtx")
            mm_write(p, rows, cols, vals, K.shape)
            r2, c2, v2, shape = mm_read(p)
            D = np.zeros(shape)
            np.add.at(D, (r2, c2), v2)
            np.testing.assert_allclose(D, K, atol=1e-12)
            Dd = mm_read(p, dense=True)
            np.testing.assert_allclose(Dd, K, atol=1e-12)


class TestAux:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("a"):
            x = jnp.ones((128, 128)) @ jnp.ones((128, 128))
            device_sync(x)
        rep = t.report()
        assert rep["a"] > 0

    @pytest.mark.parametrize("env_set", [True, False])
    def test_compile_cache_dir(self, env_set, monkeypatch, tmp_path):
        """JAX_COMPILATION_CACHE_DIR wins when set (and no code sets
        another); otherwise the cache is .jax_cache/ in the checkout."""
        from randlapack_tpu.utils import (compile_cache_dir,
                                          enable_compile_cache)
        before = jax.config.jax_compilation_cache_dir
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "elsewhere"))
            assert compile_cache_dir("/some/checkout") == str(
                tmp_path / "elsewhere")
            assert enable_compile_cache("/some/checkout") == str(
                tmp_path / "elsewhere")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert compile_cache_dir(str(tmp_path)) == str(
                tmp_path / ".jax_cache")

    def test_rss_tracker(self):
        with PeakRSSTracker() as trk:
            _ = np.zeros((1000, 1000))
        assert trk.peak_kb > 0

    def test_memory_model(self):
        assert analytical_peak_bytes("bqrrp", 8192, 8192, 256) > 0
        assert analytical_peak_bytes("cholqr_linops", 10000, 100, 50) > 0

    def test_device_stats(self):
        stats = device_memory_stats()
        assert isinstance(stats, dict)


class TestTestingHelpers:
    def test_helpers(self):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState
        from randlapack_tpu.testing import (buffs_approx_equal,
                                            coo_view_of_skop,
                                            iid_sparsify_random_dense,
                                            matrices_approx_equal,
                                            random_coo)
        from randlapack_tpu.sketching import SparseDist, fill_sparse, saso_to_dense
        A = jnp.ones((4, 4))
        assert matrices_approx_equal(A, A + 1e-14)
        assert not matrices_approx_equal(A, A + 1.0)
        assert buffs_approx_equal([1.0], [1.0 + 1e-9], 1e-8)
        S, _ = iid_sparsify_random_dense(50, 40, 0.3, RNGState(0))
        frac = float(jnp.mean((S != 0).astype(jnp.float64)))
        assert 0.2 < frac < 0.4
        (r, c, v), _ = random_coo(20, 30, 100, RNGState(1))
        assert r.shape == (100,)
        # coo view reproduces the dense SASO
        op, _ = fill_sparse(SparseDist(10, 40, 3), RNGState(2),
                            dtype=jnp.float64)
        rr, cc, vv, shape = coo_view_of_skop(op)
        D = np.zeros(shape)
        np.add.at(D, (np.asarray(rr), np.asarray(cc)), np.asarray(vv))
        np.testing.assert_allclose(D, np.asarray(saso_to_dense(op)),
                                   atol=1e-14)

    def test_qb_status(self):
        from randlapack_tpu.comps.qb import (QB_ERROR_GREW, QB_OK,
                                             QB_RANK_EXHAUSTED, qb_status)
        assert qb_status([0.5, 0.1, 1e-8], 1e-6) == QB_OK
        assert qb_status([0.5, 0.1, 0.01], 1e-6) == QB_RANK_EXHAUSTED
        assert qb_status([0.5, 0.1, 0.2], 1e-6) == QB_ERROR_GREW

    def test_debug_checks(self):
        from randlapack_tpu.utils import debug_checks
        import jax as _jax
        import jax.numpy as _jnp
        import pytest as _pt
        with debug_checks():
            with _pt.raises(FloatingPointError):
                _jax.jit(lambda x: _jnp.log(x) * 0 + _jnp.sqrt(x))(
                    _jnp.asarray(-1.0))
        assert not _jax.config.jax_debug_nans


class TestDeviceSolves:
    """Device-path bulk solves (reference architecture parity: factor once
    on the host, bulk trsm on device — ext_cholsolver_linop.hh +
    RandBLAS sparse_data::trsm)."""

    def test_chol_device_matches_host(self):
        import scipy.sparse as sp
        rng = np.random.default_rng(0)
        n = 250
        M = sp.random(n, n, density=0.03, random_state=rng)
        K = (M @ M.T + sp.eye(n) * n).tocoo()
        B = jnp.asarray(rng.standard_normal((n, 5)))
        dev = CholSolverLinOp(K.row, K.col, K.data, n, jnp.float64,
                              device_solves=True)
        host = CholSolverLinOp(K.row, K.col, K.data, n, jnp.float64,
                               device_solves=False)
        np.testing.assert_allclose(np.asarray(dev.matmat(B)),
                                   np.asarray(host.matmat(B)), atol=1e-10)

    def test_lu_device_matmat_tmatmat(self):
        import scipy.sparse as sp
        rng = np.random.default_rng(1)
        n = 250
        G = (sp.random(n, n, density=0.05, random_state=rng)
             + sp.eye(n) * 5).tocoo()
        B = jnp.asarray(rng.standard_normal((n, 4)))
        dev = LUSolverLinOp(G.row, G.col, G.data, n, jnp.float64)
        ref = sp.linalg.spsolve(G.tocsc(), np.asarray(B))
        reft = sp.linalg.spsolve(G.tocsc().T, np.asarray(B))
        np.testing.assert_allclose(np.asarray(dev.matmat(B)), ref,
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(dev.tmatmat(B)), reft,
                                   atol=1e-10)

    def test_device_solve_inside_jit(self):
        import scipy.sparse as sp
        rng = np.random.default_rng(2)
        n = 150
        G = (sp.random(n, n, density=0.05, random_state=rng)
             + sp.eye(n) * 5).tocoo()
        op = LUSolverLinOp(G.row, G.col, G.data, n, jnp.float64)
        B = jnp.asarray(rng.standard_normal((n, 2)))
        f = jax.jit(lambda x: op.matmat(x))
        np.testing.assert_allclose(np.asarray(f(B)),
                                   sp.linalg.spsolve(G.tocsc(),
                                                     np.asarray(B)),
                                   atol=1e-10)


class TestSolverComposites:
    """Composite operators over solver linops (reference:
    extras/test/linops/test_ext_composite_linop.cc — CholSolver×Dense and
    Dense×CholSolver compositions materialized against a dense oracle,
    plus a driver running over the composite)."""

    def _spd(self, n, seed=0):
        import scipy.sparse as sp
        rng = np.random.default_rng(seed)
        M = sp.random(n, n, density=0.05, random_state=rng)
        return (M @ M.T + sp.eye(n) * n).tocoo(), rng

    def test_cholsolver_times_dense(self):
        from randlapack_tpu.linops import CompositeLinOp, DenseLinOp
        n, k = 120, 30
        K, rng = self._spd(n)
        inv_op = CholSolverLinOp(K.row, K.col, K.data, n, jnp.float64)
        D = jnp.asarray(rng.standard_normal((n, k)))
        comp = CompositeLinOp(inv_op, DenseLinOp(D))
        import scipy.sparse as sp
        ref = sp.linalg.spsolve(K.tocsc(), np.asarray(D))
        X = jnp.asarray(rng.standard_normal((k, 4)))
        np.testing.assert_allclose(np.asarray(comp.matmat(X)),
                                   ref @ np.asarray(X), atol=1e-9)
        # transpose apply: (K^-1 D)^T = D^T K^-1 (K SPD)
        Y = jnp.asarray(rng.standard_normal((n, 3)))
        np.testing.assert_allclose(np.asarray(comp.tmatmat(Y)),
                                   ref.T @ np.asarray(Y), atol=1e-9)

    def test_dense_times_cholsolver(self):
        from randlapack_tpu.linops import CompositeLinOp, DenseLinOp
        n, r = 100, 40
        K, rng = self._spd(n, seed=1)
        inv_op = CholSolverLinOp(K.row, K.col, K.data, n, jnp.float64)
        D = jnp.asarray(rng.standard_normal((r, n)))
        comp = CompositeLinOp(DenseLinOp(D), inv_op)
        import scipy.sparse as sp
        ref = np.asarray(D) @ sp.linalg.spsolve(K.tocsc(), np.eye(n))
        X = jnp.asarray(rng.standard_normal((n, 5)))
        np.testing.assert_allclose(np.asarray(comp.matmat(X)),
                                   ref @ np.asarray(X), atol=1e-8)

    def test_abrik_over_inverse_composite(self):
        """Driver over the composite: top singular values of K^-1·D (the
        GSVD-style workflow the reference extras target)."""
        from randlapack_tpu.linops import CompositeLinOp, DenseLinOp
        from randlapack_tpu.drivers import ABRIKConfig, abrik
        from randlapack_tpu import RNGState
        n, k = 150, 60
        K, rng = self._spd(n, seed=2)
        inv_op = CholSolverLinOp(K.row, K.col, K.data, n, jnp.float64)
        D = jnp.asarray(rng.standard_normal((n, k)))
        comp = CompositeLinOp(inv_op, DenseLinOp(D))
        U, S, Vt, info, _ = abrik(comp, 6, ABRIKConfig(block_size=6,
                                                       max_iters=8),
                                  RNGState(3))
        import scipy.sparse as sp
        ref = sp.linalg.spsolve(K.tocsc(), np.asarray(D))
        s_ref = np.linalg.svd(ref, compute_uv=False)[:6]
        # gaussian D gives a flat spectrum: Krylov convergence is slow,
        # so compare at iteration-accuracy, not machine accuracy
        np.testing.assert_allclose(np.asarray(S), s_ref, rtol=1e-3)
