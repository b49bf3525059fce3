"""Randomized property sweeps — seeded mini-fuzz across driver/config
grids, checking only invariants (residual/orthogonality/pivot validity/
finiteness). The full-size sweeps that caught the near-square sketch
degeneracy, the ABRIK Krylov-exhaustion corruption and the Gram-block
divisibility restriction live in the session logs; these seeded
reductions keep the classes covered.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np

from randlapack_tpu import RNGState
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen

hp = jax.lax.Precision.HIGHEST


class TestQRSweep:
    def test_random_configs(self):
        from randlapack_tpu.drivers import (BQRRPConfig, HQRRPConfig,
                                            CQRRPTConfig, bqrrp,
                                            bqrrp_factored, bqrrp_q,
                                            cqrrpt, hqrrp)
        rng = random.Random(0)
        mts = [MatType.polynomial, MatType.exponential, MatType.gaussian]
        for trial in range(10):
            m = rng.choice([33, 97, 128, 200])
            n = rng.choice([30, 64, 100, 190])
            b = rng.choice([8, 16, 32])
            A, st = mat_gen(MatGenInfo(m, n, rng.choice(mts),
                                       cond_num=10 ** rng.choice([2, 5, 8])),
                            RNGState(trial))
            drv = rng.choice(["bqrrp", "factored", "hqrrp", "cqrrpt"])
            if drv == "cqrrpt" and m < n:
                drv = "hqrrp"
            if drv == "bqrrp":
                Q, R, J, rank, fail, _ = bqrrp(
                    A, BQRRPConfig(block_size=b,
                                   stages=rng.choice([1, 2])), st)
            elif drv == "factored":
                fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=b), st)
                Q, R, J, fail = bqrrp_q(fac), fac.R, fac.J, fac.fail
            elif drv == "hqrrp":
                Q, R, J, rank, fail, _ = hqrrp(
                    A, HQRRPConfig(block_size=b), st)
            else:
                Q, R, J, rank, fail, _ = cqrrpt(A, CQRRPTConfig(), st)
            kq = Q.shape[1]
            AJ = jnp.take(A, J, axis=1)
            res = float(jnp.linalg.norm(
                jnp.matmul(Q, R[:kq], precision=hp) - AJ)
                / max(float(jnp.linalg.norm(A)), 1e-300))
            assert sorted(np.asarray(J).tolist()) == list(range(n)), \
                (trial, drv)
            assert bool(fail) or res < 1e-10, (trial, drv, m, n, b, res)

    def test_abrik_overcomplete_configs(self):
        """q*b past the numerical rank must degrade gracefully (the
        Krylov-exhaustion freeze)."""
        from randlapack_tpu.drivers import ABRIKConfig, abrik
        from randlapack_tpu.linops import DenseLinOp, CompositeLinOp
        A1, _ = mat_gen(MatGenInfo(150, 60, MatType.gaussian), RNGState(10))
        A2, _ = mat_gen(MatGenInfo(60, 100, MatType.gaussian),
                        RNGState(110))
        comp = CompositeLinOp(DenseLinOp(A1), DenseLinOp(A2))
        s_ref = np.linalg.svd(np.asarray(A1) @ np.asarray(A2),
                              compute_uv=False)[:4]
        for q in [12, 30]:
            U, S, Vt, info, _ = abrik(
                comp, 4, ABRIKConfig(block_size=8, max_iters=q),
                RNGState(10))
            np.testing.assert_allclose(np.asarray(S), s_ref, rtol=1e-9)


class TestLSSweep:
    def test_spls_solver_grid(self):
        from randlapack_tpu.drivers import SPLSConfig, spls
        from randlapack_tpu.comps import PCGSaddleConfig
        rng = random.Random(1)
        for trial in range(4):
            m, n = rng.choice([(300, 40), (500, 80)])
            mu = rng.choice([0.0, 1e-4])
            A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential,
                                      cond_num=1e4), RNGState(trial))
            xt = jax.random.normal(jax.random.key(trial), (n,), jnp.float64)
            b = A @ xt
            for solver in ["pcg", "lsqr"]:
                cfg = SPLSConfig(solver=solver,
                                 pcg=PCGSaddleConfig(tol=1e-12,
                                                     max_iters=200))
                x, hist, it, _ = spls(A, b, mu, cfg, RNGState(trial + 1))
                r = (jnp.matmul(A.T, jnp.matmul(A, x, precision=hp) - b,
                                precision=hp) + mu * x)
                opt = float(jnp.linalg.norm(r) / jnp.linalg.norm(
                    jnp.matmul(A.T, b, precision=hp)))
                assert opt < 1e-7, (trial, solver, mu, opt)
                # the plateau stop must fire well before the cap
                assert int(it) < 200, (trial, solver, int(it))


class TestTransformComposition:
    def test_vmap_batches_hqrrp_and_factored(self):
        from randlapack_tpu.drivers import (BQRRPConfig, HQRRPConfig,
                                            bqrrp_factored, hqrrp)
        As = jnp.stack([mat_gen(MatGenInfo(60, 48, MatType.exponential,
                                           cond_num=1e4), RNGState(i))[0]
                        for i in range(3)])
        Qs, Rs = jax.vmap(
            lambda a: hqrrp(a, HQRRPConfig(block_size=16), RNGState(0))[:2]
        )(As)
        for i in range(3):
            ref = hqrrp(As[i], HQRRPConfig(block_size=16), RNGState(0))
            np.testing.assert_allclose(np.asarray(Qs[i]),
                                       np.asarray(ref[0]), atol=1e-11)
        Rsb = jax.vmap(lambda a: bqrrp_factored(
            a, BQRRPConfig(block_size=16), RNGState(1))[0].R)(As)
        for i in range(3):
            ref = bqrrp_factored(As[i], BQRRPConfig(block_size=16),
                                 RNGState(1))[0].R
            np.testing.assert_allclose(np.asarray(Rsb[i]),
                                       np.asarray(ref), atol=1e-11)

    def test_grad_through_hqrrp_r(self):
        """hqrrp_lapack_format is the differentiable path (explicit-Q
        materialization uses householder_product, which has no JVP)."""
        from randlapack_tpu.drivers import HQRRPConfig, hqrrp_lapack_format
        A0, _ = mat_gen(MatGenInfo(40, 32, MatType.exponential,
                                   cond_num=100), RNGState(9))

        def loss(a):
            _, _, R, _, _ = hqrrp_lapack_format(
                a, HQRRPConfig(block_size=16), RNGState(2))
            return jnp.sum(jnp.diag(R[:32, :32]) ** 2)

        gr = jax.grad(loss)(A0)
        d = jax.random.normal(jax.random.key(3), A0.shape, jnp.float64)
        e = 1e-6
        fd = (loss(A0 + e * d) - loss(A0 - e * d)) / (2 * e)
        assert abs(float(fd) - float(jnp.sum(gr * d))) < 1e-4 * max(
            abs(float(fd)), 1.0)


class TestDeferSweep:
    """Round-3 fuzz: left-looking aggregated updates (update_defer) across
    random config boundaries — exactly the config-boundary territory the
    earlier sweeps found 7 real bugs in."""

    def test_defer_pivot_route_grid(self):
        from randlapack_tpu.drivers import (BQRRPConfig, bqrrp_factored,
                                            bqrrp_q)
        rng = random.Random(3)
        mts = [MatType.polynomial, MatType.exponential, MatType.gaussian]
        for trial in range(10):
            m = rng.choice([65, 128, 200, 256])
            n = rng.choice([48, 96, 130, 192])
            b = rng.choice([16, 32, 48])
            defer = rng.choice([1, 2, 3, 4, 5])
            A, st = mat_gen(MatGenInfo(m, n, rng.choice(mts),
                                       cond_num=10 ** rng.choice([2, 6])),
                            RNGState(100 + trial))
            cfg = BQRRPConfig(
                block_size=b, update_defer=defer,
                stages=rng.choice([1, 2]),
                pivot_candidates=rng.choice([None, 2, 4]),
                sketch_r=rng.choice(["auto", "qr", "gram"]))
            fac, _ = bqrrp_factored(A, cfg, st)
            Q = bqrrp_q(fac)
            AJ = jnp.take(A, fac.J, axis=1)
            res = float(jnp.linalg.norm(
                jnp.matmul(Q, fac.R, precision=hp) - AJ)
                / max(float(jnp.linalg.norm(A)), 1e-300))
            assert sorted(np.asarray(fac.J).tolist()) == list(range(n)), \
                (trial, defer)
            assert bool(fac.fail) or res < 1e-10, \
                (trial, m, n, b, defer, res)


class TestDistSweep:
    """Round-3 fuzz: distributed drivers over random sub-mesh sizes."""

    def test_dist_driver_grid(self):
        import pytest as _pt
        if len(jax.devices()) < 8:
            _pt.skip("needs 8 virtual devices")
        from jax.sharding import Mesh
        from randlapack_tpu.parallel import (dist_abrik, dist_bqrrp,
                                             dist_bqrrp_factored,
                                             dist_cqrrpt)
        from randlapack_tpu.drivers import bqrrp_q
        rng = random.Random(5)
        for trial in range(6):
            p = rng.choice([2, 4, 8])
            mesh = Mesh(np.array(jax.devices()[:p]).reshape(p), ("rows",))
            m = rng.choice([16, 24, 32]) * p
            n = rng.choice([32, 48, 64])
            A, st = mat_gen(MatGenInfo(m, n, MatType.exponential,
                                       cond_num=10 ** rng.choice([2, 5])),
                            RNGState(200 + trial))
            drv = rng.choice(["bqrrp", "factored", "cqrrpt", "abrik"])
            if drv == "abrik":
                # with excess Krylov room (q·b = 32 > k = 8) the leading
                # values resolve; basis orthogonality holds regardless
                U, S, Vt, info, _ = dist_abrik(A, 8, mesh, st,
                                               block_size=8, max_iters=4)
                sv = np.linalg.svd(np.asarray(A), compute_uv=False)
                np.testing.assert_allclose(np.asarray(S[:2]), sv[:2],
                                           rtol=1e-3)
                orth_u = float(jnp.linalg.norm(
                    jnp.matmul(U.T, U, precision=hp) - jnp.eye(8)))
                assert orth_u < 1e-10, (trial, p, orth_u)
                continue
            if drv == "bqrrp":
                Q, R, J, rank, fail, _ = dist_bqrrp(A, mesh, st,
                                                    block_size=16)
            elif drv == "factored":
                fac, _ = dist_bqrrp_factored(A, mesh, st, block_size=16)
                with jax.sharding.set_mesh(mesh):
                    Q = bqrrp_q(fac)
                R, J, fail = fac.R, fac.J, fac.fail
            else:
                Q, R, J, rank, fail, _ = dist_cqrrpt(A, mesh, st)
            AJ = jnp.take(A, J, axis=1)
            res = float(jnp.linalg.norm(
                jnp.matmul(Q, R[:Q.shape[1]], precision=hp) - AJ)
                / max(float(jnp.linalg.norm(A)), 1e-300))
            assert bool(fail) or res < 1e-9, (trial, drv, p, m, n, res)


class TestScaleInvariance:
    """Round-3 guards (sketch rescale, CholQR scale guard) promise exact
    global-scale equivariance: J and Q invariant, R linear in the scale.
    Pin it across extreme f32 scales — the guard territory."""

    def test_qr_drivers_scale_equivariant(self):
        from randlapack_tpu.drivers import (BQRRPConfig, CQRRPTConfig,
                                            bqrrp_factored, bqrrp_q,
                                            cqrrpt)
        A64, st = mat_gen(MatGenInfo(96, 64, MatType.exponential,
                                     cond_num=1e3), RNGState(900))
        A = A64.astype(jnp.float32)
        cfg = BQRRPConfig(block_size=16)
        fac0, _ = bqrrp_factored(A, cfg, st)
        # powers of 2: an exponent-only scale commutes bitwise with f32
        # arithmetic (given the band guards), so J must match EXACTLY;
        # arbitrary scales perturb rounding and may flip pivot ties
        for scale in [2.0 ** -60, 2.0 ** 60]:
            s = jnp.float32(scale)
            fac, _ = bqrrp_factored(A * s, cfg, st)
            np.testing.assert_array_equal(np.asarray(fac.J),
                                          np.asarray(fac0.J))
            np.testing.assert_allclose(np.asarray(fac.R) / scale,
                                       np.asarray(fac0.R),
                                       rtol=2e-5, atol=2e-5
                                       * float(jnp.max(jnp.abs(fac0.R))))
            Q0 = np.asarray(bqrrp_q(fac0))
            Q1 = np.asarray(bqrrp_q(fac))
            np.testing.assert_allclose(Q1, Q0, atol=5e-5)
        At = jnp.concatenate([A, A], axis=0)   # taller for cqrrpt
        Q0, R0, J0, r0, f0, _ = cqrrpt(At, CQRRPTConfig(), st)
        Qs, Rs, Js, rs, fs, _ = cqrrpt(At * jnp.float32(2.0 ** 50),
                                       CQRRPTConfig(), st)
        np.testing.assert_array_equal(np.asarray(Js), np.asarray(J0))
        np.testing.assert_allclose(np.asarray(Rs) / 2.0 ** 50,
                                   np.asarray(R0), rtol=2e-5,
                                   atol=2e-5 * float(jnp.max(jnp.abs(R0))))

    def test_cholqr_scale_equivariant_f32(self):
        from randlapack_tpu.ops.cholqr import cholqr
        hp = jax.lax.Precision.HIGHEST
        A = (mat_gen(MatGenInfo(128, 16, MatType.gaussian),
                     RNGState(901))[0]).astype(jnp.float32)
        Q0, R0, f0 = cholqr(A, hp)
        for scale in [1e-20, 1e20, 1e30]:
            Q, R, f = cholqr(A * jnp.float32(scale), hp)
            assert not bool(f), scale
            np.testing.assert_allclose(np.asarray(Q), np.asarray(Q0),
                                       atol=1e-5)

    def test_abrik_spls_small_scale(self):
        """The R_sk floors in abrik/spls/cholqr_linops are now relative:
        uniformly tiny inputs must factor/solve as well as O(1) ones."""
        from randlapack_tpu.drivers import (ABRIKConfig, SPLSConfig, abrik,
                                            spls)
        s = jnp.float64(2.0 ** -60)
        A, st = mat_gen(MatGenInfo(150, 60, MatType.exponential,
                                   cond_num=1e4), RNGState(902))
        U0, S0, Vt0, info0, _ = abrik(
            A, 8, ABRIKConfig(block_size=8, max_iters=8), RNGState(903))
        U1, S1, Vt1, info1, _ = abrik(
            A * s, 8, ABRIKConfig(block_size=8, max_iters=8), RNGState(903))
        np.testing.assert_allclose(np.asarray(S1) / float(s),
                                   np.asarray(S0), rtol=1e-12)
        xt = jax.random.normal(jax.random.key(904), (60,), jnp.float64)
        b = A @ xt
        x0, _, it0, _ = spls(A, b, 0.0, SPLSConfig(), RNGState(905))
        x1, _, it1, _ = spls(A * s, b * s, 0.0, SPLSConfig(), RNGState(905))
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                                   rtol=1e-10)

    def test_cqrrt_scale_equivariant(self):
        from randlapack_tpu.drivers import CQRRTConfig, cqrrt
        A64, _ = mat_gen(MatGenInfo(256, 48, MatType.exponential,
                                    cond_num=1e4), RNGState(906))
        A = A64.astype(jnp.float32)
        Q0, R0, f0, _ = cqrrt(A, CQRRTConfig(), RNGState(907))
        for scale in [2.0 ** -60, 2.0 ** 55]:
            Q1, R1, f1, _ = cqrrt(A * jnp.float32(scale), CQRRTConfig(),
                                  RNGState(907))
            assert not bool(f1), scale
            np.testing.assert_allclose(np.asarray(Q1), np.asarray(Q0),
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(R1) / scale,
                                       np.asarray(R0), rtol=2e-5,
                                       atol=2e-5
                                       * float(jnp.max(jnp.abs(R0))))
        # Q-less route at scale
        _, Rq, fq, _ = cqrrt(A * jnp.float32(2.0 ** -60),
                             CQRRTConfig(compute_q=False), RNGState(907))
        assert not bool(fq)
        np.testing.assert_allclose(np.asarray(Rq) / 2.0 ** -60,
                                   np.asarray(R0), rtol=2e-4,
                                   atol=2e-4 * float(jnp.max(jnp.abs(R0))))
