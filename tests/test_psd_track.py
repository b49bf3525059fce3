"""Symmetric/PSD track tests: SYPS/SYRF, REVD2, RPCholesky, PCG family,
preconditioners, KRILL, SPLS — mirroring test/comps/test_{syrf,rpchol,
determiter,preconditioners}.cc and test/drivers/test_{revd2,krill}.cc."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState
from randlapack_tpu.comps import (PCGConfig, PCGSaddleConfig, RPCholConfig,
                                  SYRFConfig, make_right_orthogonalizer,
                                  pcg, pcg_saddle, rp_cholesky,
                                  rpc_data_svd_saso, rpchol_pc_data, syrf)
from randlapack_tpu.drivers import (KrillConfig, REVD2Config,
                                    krill_full_rpchol, revd2,
                                    revd2_fixed_rank, SPLSConfig, spls)
from randlapack_tpu.gen import (MatGenInfo, MatType, gen_exp_singvals,
                                mat_gen, psd_from_eigvals)
from randlapack_tpu.linops import ExplicitSymLinOp, RegExplicitSymLinOp, SpectralPrecond
from randlapack_tpu.pdkernels import (SquaredExpKernelLinOp,
                                      squared_exp_kernel,
                                      standardize_dataset)
from randlapack_tpu.ops import util

EPS = np.finfo(np.float64).eps
ATOL = EPS ** 0.75


class TestSYRF:
    def test_captures_dominant_space(self):
        lam = gen_exp_singvals(200, 1e6, jnp.float64)
        A, st = psd_from_eigvals(200, lam, RNGState(0))
        Q, _ = syrf(A, 20, SYRFConfig(), st)
        assert float(util.orthogonality_check(Q)) < 1e-12
        # captured energy close to best rank-20
        cap = float(jnp.linalg.norm(Q.T @ A @ Q))
        best = float(jnp.linalg.norm(jnp.diag(lam[:20])))
        assert cap > 0.9 * best

    def test_linop_input(self):
        lam = gen_exp_singvals(150, 1e4, jnp.float64)
        A, st = psd_from_eigvals(150, lam, RNGState(1))
        Q1, _ = syrf(ExplicitSymLinOp(A), 16, SYRFConfig(), RNGState(5))
        Q2, _ = syrf(A, 16, SYRFConfig(), RNGState(5))
        np.testing.assert_allclose(np.asarray(Q1), np.asarray(Q2), atol=1e-12)


class TestREVD2:
    def test_fixed_rank(self):
        lam = jnp.concatenate([jnp.ones(10, jnp.float64),
                               1e-8 * jnp.ones(190, jnp.float64)])
        A, st = psd_from_eigvals(200, lam, RNGState(2))
        V, lam_est, err, _, fail, _ = revd2_fixed_rank(A, 16, REVD2Config(), st)
        assert not bool(fail)
        assert float(util.orthogonality_check(V)) < 1e-12
        np.testing.assert_allclose(np.asarray(lam_est[:10]), 1.0, rtol=1e-6)
        assert float(err) < 1e-6

    def test_adaptive_doubles(self):
        lam = gen_exp_singvals(256, 1e12, jnp.float64)
        A, st = psd_from_eigvals(256, lam, RNGState(3))
        V, lam_est, k_used, err, fail, _ = revd2(A, 8, tol=1e-6, cfg=REVD2Config(),
                                           state=st, k_max=128)
        assert k_used >= 16  # must have doubled at least once
        assert err < 5 * 1e-6 * float(lam[0]) + 1e-5


class TestRPCholesky:
    def test_exact_low_rank(self):
        # rank-30 PSD matrix: rank-64 RPCholesky must capture it (nearly)
        lam = jnp.concatenate([jnp.ones(30, jnp.float64),
                               jnp.zeros(170, jnp.float64)])
        A, st = psd_from_eigvals(200, lam, RNGState(4))
        F, piv, _ = rp_cholesky(ExplicitSymLinOp(A), 64,
                                RPCholConfig(block_size=16), st)
        res = float(jnp.linalg.norm(A - F @ F.T) / jnp.linalg.norm(A))
        assert res < 1e-8

    def test_kernel_operator(self):
        key = jax.random.key(0)
        X = standardize_dataset(jax.random.normal(key, (5, 300),
                                                  dtype=jnp.float64))
        K = squared_exp_kernel(X, X, 1.0)
        op = SquaredExpKernelLinOp(X, 1.0, 0.0, evals_include_reg=False)
        F, piv, _ = rp_cholesky(op, 128, RPCholConfig(block_size=32),
                                RNGState(5))
        res = float(jnp.linalg.norm(K - F @ F.T) / jnp.linalg.norm(K))
        s = jnp.linalg.svd(K, compute_uv=False)
        opt = float(jnp.linalg.norm(s[128:]) / jnp.linalg.norm(K))
        assert res < 4 * opt  # RPCholesky guarantee: modest factor of optimal

    def test_trace_decreases(self):
        lam = gen_exp_singvals(200, 1e4, jnp.float64)
        A, st = psd_from_eigvals(200, lam, RNGState(6))
        F32, _, _ = rp_cholesky(ExplicitSymLinOp(A), 32,
                                RPCholConfig(block_size=16), st)
        F64, _, _ = rp_cholesky(ExplicitSymLinOp(A), 64,
                                RPCholConfig(block_size=16), st)
        r32 = float(jnp.linalg.norm(A - F32 @ F32.T))
        r64 = float(jnp.linalg.norm(A - F64 @ F64.T))
        assert r64 < r32


class TestPCG:
    def _spd(self, n, cond, seed):
        lam = gen_exp_singvals(n, cond, jnp.float64)
        return psd_from_eigvals(n, lam, RNGState(seed))

    def test_lockstep_converges(self):
        A, _ = self._spd(120, 100, 7)
        H = jax.random.normal(jax.random.key(1), (120, 3), dtype=jnp.float64)
        X, hist, iters = pcg(A, H, None, jnp.zeros_like(H),
                             PCGConfig(tol=1e-10, max_iters=300))
        res = float(jnp.linalg.norm(A @ X - H) / jnp.linalg.norm(H))
        assert res < 1e-9
        assert int(iters) < 300

    def test_block_mode(self):
        A, _ = self._spd(120, 100, 8)
        H = jax.random.normal(jax.random.key(2), (120, 4), dtype=jnp.float64)
        X, hist, iters = pcg(A, H, None, jnp.zeros_like(H),
                             PCGConfig(tol=1e-10, max_iters=300,
                                       mode="block"))
        res = float(jnp.linalg.norm(A @ X - H) / jnp.linalg.norm(H))
        assert res < 1e-9

    def test_preconditioner_speeds_up(self):
        A, _ = self._spd(200, 1e6, 9)
        H = jax.random.normal(jax.random.key(3), (200, 1), dtype=jnp.float64)
        cfg = PCGConfig(tol=1e-8, max_iters=500)
        _, _, it_plain = pcg(A, H, None, jnp.zeros_like(H), cfg)
        # exact-inverse preconditioner converges immediately
        Ainv = jnp.linalg.inv(A)
        _, _, it_pre = pcg(A, H, Ainv, jnp.zeros_like(H), cfg)
        assert int(it_pre) < int(it_plain) / 2

    def test_pcg_saddle_least_squares(self):
        A, _ = mat_gen(MatGenInfo(500, 40, MatType.exponential, cond_num=50),
                       RNGState(10))
        x_true = jax.random.normal(jax.random.key(4), (40, 1),
                                   dtype=jnp.float64)
        b = A @ x_true
        M = jnp.eye(40, dtype=jnp.float64)
        x, hist, it = pcg_saddle(A, b, jnp.zeros_like(x_true), 0.0, M,
                                 jnp.zeros_like(x_true), PCGSaddleConfig())
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                                   atol=1e-7)


class TestPreconditioners:
    def test_right_orthogonalizer(self):
        # A·M should be near-orthonormal for mu=0
        A, st = mat_gen(MatGenInfo(3000, 50, MatType.exponential,
                                   cond_num=1e6), RNGState(11))
        V, s, _ = rpc_data_svd_saso(A, 400, st)
        M, rank = make_right_orthogonalizer(V, s, 0.0)
        assert int(rank) == 50
        AM = A @ M
        c = float(util.cond_num_check(AM))
        assert c < 3.0  # subspace-embedding distortion only

    def test_spls_end_to_end(self):
        # note: accuracy through the (preconditioned) normal equations is
        # limited by kappa(A)^2 * eps — same as the reference's pcg_saddle —
        # so the test condition number is moderate.
        A, st = mat_gen(MatGenInfo(5000, 100, MatType.exponential,
                                   cond_num=1e4), RNGState(12))
        x_true = jax.random.normal(jax.random.key(5), (100,),
                                   dtype=jnp.float64)
        b = A @ x_true
        x, hist, iters, _ = spls(A, b, 0.0, SPLSConfig(), RNGState(13))
        rel = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
        assert rel < 1e-6
        assert int(iters) < 60  # preconditioned: fast convergence


class TestKrill:
    def test_kernel_ridge_solve(self):
        key = jax.random.key(6)
        n = 400
        X = standardize_dataset(jax.random.normal(key, (6, n),
                                                  dtype=jnp.float64))
        mu = 1e-3
        G = SquaredExpKernelLinOp(X, 1.0, mu)
        K = squared_exp_kernel(X, X, 1.0)
        h = jax.random.normal(jax.random.key(7), (n, 1), dtype=jnp.float64)
        Xsol, hist, iters, _ = krill_full_rpchol(
            G, h, mu, KrillConfig(rpchol_block=32), RNGState(14))
        res = float(jnp.linalg.norm(
            (K + mu * jnp.eye(n)) @ Xsol - h) / jnp.linalg.norm(h))
        assert res < 1e-6

    def test_per_column_mus(self):
        key = jax.random.key(8)
        n = 300
        X = standardize_dataset(jax.random.normal(key, (4, n),
                                                  dtype=jnp.float64))
        K = squared_exp_kernel(X, X, 1.0)
        mus = jnp.asarray([1e-2, 1e-3], dtype=jnp.float64)
        G = RegExplicitSymLinOp(K, mus)
        H = jax.random.normal(jax.random.key(9), (n, 2), dtype=jnp.float64)
        # small μ needs a higher-rank preconditioner: residual spectrum
        # cond ≈ λ_{k+1}/μ drives CG iteration count
        from randlapack_tpu.comps import PCGConfig
        Xs, hist, iters, _ = krill_full_rpchol(
            G, H, mus, KrillConfig(k=128, rpchol_block=32,
                                   pcg=PCGConfig(tol=1e-8, max_iters=400)),
            RNGState(15))
        for i, mu in enumerate([1e-2, 1e-3]):
            res = float(jnp.linalg.norm(
                (K + mu * jnp.eye(n)) @ Xs[:, i] - H[:, i])
                / jnp.linalg.norm(H[:, i]))
            assert res < 1e-6, (i, res)


class TestLSQR:
    def test_plain_lsqr(self):
        from randlapack_tpu.comps import LSQRConfig, lsqr
        A, _ = mat_gen(MatGenInfo(300, 40, MatType.exponential,
                                  cond_num=50), RNGState(40))
        xt = jax.random.normal(jax.random.key(40), (40,), dtype=jnp.float64)
        b = A @ xt
        x, hist, it = lsqr(A, b, None, LSQRConfig(tol=1e-12, max_iters=500))
        np.testing.assert_allclose(np.asarray(x), np.asarray(xt), atol=1e-8)

    def test_preconditioned_beats_normal_equations_at_high_cond(self):
        # kappa = 1e8: normal equations floor ~ kappa^2*eps = 1; LSQR on the
        # preconditioned system reaches ~kappa*eps = 1e-8
        A, _ = mat_gen(MatGenInfo(4000, 80, MatType.exponential,
                                  cond_num=1e8), RNGState(41))
        xt = jax.random.normal(jax.random.key(41), (80,), dtype=jnp.float64)
        b = A @ xt
        cfg_l = SPLSConfig(solver="lsqr", precond="qr")
        x_l, _, it_l, _ = spls(A, b, 0.0, cfg_l, RNGState(42))
        rel_l = float(jnp.linalg.norm(x_l - xt) / jnp.linalg.norm(xt))
        cfg_p = SPLSConfig(solver="pcg", precond="svd")
        x_p, _, it_p, _ = spls(A, b, 0.0, cfg_p, RNGState(42))
        rel_p = float(jnp.linalg.norm(x_p - xt) / jnp.linalg.norm(xt))
        # measured: lsqr 7.9e-5 vs pcg 8.2e-2 at kappa=1e8 (1000x better;
        # both paths floor well above their theoretical bounds here, but
        # the ordering is the point)
        assert rel_l < 1e-3, rel_l
        assert rel_l < rel_p / 10, (rel_l, rel_p)


class TestREVD2Battery:
    """The reference's REVD2 adaptive battery (test_revd2.cc:223-414:
    Underestimation1/2, Overestimation1/2, Exactness) on this API."""

    def _spiked(self, n, true_rank, seed):
        lam = jnp.concatenate([
            jnp.linspace(1.0, 0.5, true_rank),
            1e-12 * jnp.ones(n - true_rank)]).astype(jnp.float64)
        return psd_from_eigvals(n, lam, RNGState(seed))

    def test_underestimation_doubles_to_rank(self):
        # k0 far below the true rank: adaptive must double until the
        # estimate covers the spike
        A, st = self._spiked(256, 64, 4)
        V, lam_est, k_used, err, fail, _ = revd2(
            A, 8, tol=1e-8, cfg=REVD2Config(), state=st, k_max=256)
        assert k_used >= 64
        assert err < 1e-6

    def test_underestimation_partial_budget(self):
        # k_max below the true rank: returns the budget with honest error
        A, st = self._spiked(256, 128, 5)
        V, lam_est, k_used, err, fail, _ = revd2(
            A, 8, tol=1e-10, cfg=REVD2Config(), state=st, k_max=32)
        assert k_used == 32
        assert err > 1e-10  # cannot certify the tolerance

    def test_overestimation_stops_early(self):
        # k0 already above the true rank: one round suffices
        A, st = self._spiked(256, 16, 6)
        V, lam_est, k_used, err, fail, _ = revd2(
            A, 64, tol=1e-6, cfg=REVD2Config(), state=st, k_max=256)
        assert k_used == 64
        assert err < 1e-6

    def test_overestimation_rank_revealed(self):
        # eigenvalues beyond the true rank must be ~0, not noise
        A, st = self._spiked(200, 12, 7)
        V, lam_est, k_used, err, fail, _ = revd2(
            A, 32, tol=1e-6, cfg=REVD2Config(), state=st, k_max=64)
        tail = np.asarray(lam_est[12:])
        assert np.all(np.abs(tail) < 1e-8)

    def test_exactness(self):
        # exactly low-rank PSD: REVD2 reproduces it to machine precision
        A, st = self._spiked(128, 8, 8)
        V, lam_est, k_used, err, fail, _ = revd2(
            A, 8, tol=1e-12, cfg=REVD2Config(), state=st, k_max=16)
        Ahat = np.asarray(V[:, :8] * lam_est[:8][None, :]) @ np.asarray(
            V[:, :8]).T
        assert np.linalg.norm(Ahat - np.asarray(A)) < 1e-10


class TestKrillRestricted:
    """krill_restricted_rpchol — the reference's documented-but-disabled
    restricted-domain KRR (rl_krill.hh:75-141), implemented here."""

    def test_solves_restricted_problem(self):
        from randlapack_tpu.drivers import KrillConfig, krill_restricted_rpchol
        from randlapack_tpu.linops import RegExplicitSymLinOp
        n, k, s = 200, 40, 3
        lam = jnp.concatenate([jnp.linspace(1.0, 0.1, k),
                               1e-4 * jnp.ones(n - k)]).astype(jnp.float64)
        K, st = psd_from_eigvals(n, lam, RNGState(40))
        mus = jnp.asarray([1e-3, 1e-2, 1e-1])
        G = RegExplicitSymLinOp(K, mus)
        H = jax.random.normal(jax.random.key(41), (n, s), jnp.float64)
        X, inds, y, _ = krill_restricted_rpchol(
            G, H, mus, KrillConfig(k=k, rpchol_block=20), st)
        # support restricted to the pivot rows
        mask = np.ones(n, bool)
        mask[np.asarray(inds)] = False
        assert float(jnp.linalg.norm(X[jnp.asarray(mask)])) == 0.0
        # optimality: y solves (V^T V + mu I) y = V^T H for the rank-k
        # Nystrom factor; check the normal-equation residual per column
        from randlapack_tpu.comps.rpchol import RPCholConfig, rp_cholesky
        F, inds2, _ = rp_cholesky(G.with_reg(False), k,
                                  RPCholConfig(block_size=20), st)
        np.testing.assert_array_equal(np.asarray(inds), np.asarray(inds2))
        Gv = np.asarray(F.T @ F)
        for j in range(s):
            r = (Gv + float(mus[j]) * np.eye(k)) @ np.asarray(y[:, j]) \
                - np.asarray(F.T @ H[:, j])
            assert np.linalg.norm(r) < 1e-8
        # consistency: x restricted-basis identity X[inds] = M^-T y
        M = np.asarray(F)[np.asarray(inds), :]
        np.testing.assert_allclose(np.asarray(X[jnp.asarray(inds)]),
                                   np.linalg.solve(M.T, np.asarray(y)),
                                   atol=1e-10)

    def test_single_rhs_vector(self):
        from randlapack_tpu.drivers import KrillConfig, krill_restricted_rpchol
        from randlapack_tpu.linops import RegExplicitSymLinOp
        n = 120
        lam = gen_exp_singvals(n, 1e4, jnp.float64)
        K, st = psd_from_eigvals(n, lam, RNGState(42))
        G = RegExplicitSymLinOp(K, jnp.asarray([1e-2]))
        h = jax.random.normal(jax.random.key(43), (n,), jnp.float64)
        x, inds, y, _ = krill_restricted_rpchol(
            G, h, 1e-2, KrillConfig(k=24, rpchol_block=12), st)
        assert x.shape == (n,) and y.shape == (24,)
