"""Multi-chip SPMD layer tests on the 8-device virtual CPU mesh
(SURVEY.md §5.8: the sharded growth path is a NEW design — these validate
that collectives produce bitwise-sensible numerics vs single-device)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from randlapack_tpu import RNGState
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.ops import util
from randlapack_tpu.parallel import (dist_cholqr, dist_gram,
                                     dist_rangefinder_step,
                                     dist_shifted_cholqr3, dist_sketch_left,
                                     make_mesh, row_sharded)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def A_sharded(mesh):
    A, _ = mat_gen(MatGenInfo(640, 48, MatType.exponential, cond_num=1e4),
                   RNGState(0))
    return jax.device_put(A, row_sharded(mesh)), A


class TestDistOps:
    def test_gram(self, mesh, A_sharded):
        As, A = A_sharded
        G = dist_gram(As, mesh)
        np.testing.assert_allclose(np.asarray(G), np.asarray(A.T @ A),
                                   rtol=1e-10)

    def test_cholqr(self, mesh, A_sharded):
        As, A = A_sharded
        Q, R, fail = dist_cholqr(As, mesh)
        assert not bool(fail)
        Qh = np.asarray(Q)
        assert np.linalg.norm(Qh.T @ Qh - np.eye(48)) < 1e-12
        np.testing.assert_allclose(Qh @ np.asarray(R), np.asarray(A),
                                   atol=1e-10)

    def test_scholqr3_illcond(self, mesh):
        A, _ = mat_gen(MatGenInfo(640, 48, MatType.exponential,
                                  cond_num=1e11), RNGState(1))
        As = jax.device_put(A, row_sharded(mesh))
        Q, R, fail = dist_shifted_cholqr3(As, mesh)
        assert not bool(fail)
        Qh = np.asarray(Q)
        assert np.linalg.norm(Qh.T @ Qh - np.eye(48)) < 1e-11

    def test_sketch_left(self, mesh, A_sharded):
        As, A = A_sharded
        S = jax.random.normal(jax.random.key(2), (32, 640), jnp.float64)
        Ss = jax.device_put(S, NamedSharding(mesh, P(None, "rows")))
        got = dist_sketch_left(Ss, As, mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(S @ A),
                                   rtol=1e-10)

    def test_rangefinder_step(self, mesh, A_sharded):
        As, A = A_sharded
        Om = jax.random.normal(jax.random.key(3), (48, 16), jnp.float64)
        Oms = jax.device_put(Om, NamedSharding(mesh, P()))
        Q, B, Om2, fail = dist_rangefinder_step(As, Oms, mesh)
        assert not bool(fail)
        Qh = np.asarray(Q)
        assert np.linalg.norm(Qh.T @ Qh - np.eye(16)) < 1e-12
        # B = QᵀA
        np.testing.assert_allclose(np.asarray(B), Qh.T @ np.asarray(A),
                                   atol=1e-10)
        # rank-16 capture error matches the single-device computation
        res = np.linalg.norm(np.asarray(A) - Qh @ np.asarray(B))
        s = np.linalg.svd(np.asarray(A), compute_uv=False)
        assert res < 3 * np.linalg.norm(s[16:])

    def test_jit_end_to_end(self, mesh, A_sharded):
        As, A = A_sharded

        @jax.jit
        def step(a):
            Q, R, fail = dist_cholqr(a, mesh)
            return jnp.linalg.norm(Q.T @ Q - jnp.eye(48, dtype=a.dtype))

        assert float(step(As)) < 1e-12


class TestDistDrivers:
    def test_dist_cqrrpt(self, mesh):
        from randlapack_tpu.parallel import dist_cqrrpt
        A, _ = mat_gen(MatGenInfo(1024, 64, MatType.exponential,
                                  cond_num=1e5), RNGState(20))
        As = jax.device_put(A, row_sharded(mesh))
        Q, R, J, rank, fail, _ = dist_cqrrpt(As, mesh, RNGState(21))
        assert not bool(fail)
        assert int(rank) == 64
        Qh = np.asarray(Q)
        assert np.linalg.norm(Qh.T @ Qh - np.eye(64)) < 1e-11
        res = np.linalg.norm(Qh @ np.asarray(R)
                             - np.asarray(util.col_swap(A, J)))
        assert res < 1e-11 * float(jnp.linalg.norm(A)) * 64

    def test_dist_cqrrpt_collective_and_shards(self, mesh):
        """The compiled program reduces the Gram over the mesh with an
        all-reduce, and Q keeps m/8 rows on each device."""
        from randlapack_tpu.parallel import dist_cqrrpt
        m, n = 1024, 64
        A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential,
                                  cond_num=1e5), RNGState(20))
        As = jax.device_put(A, row_sharded(mesh))
        hlo = jax.jit(lambda a: dist_cqrrpt(a, mesh, RNGState(21))[:5]
                      ).lower(As).compile().as_text()
        assert "all-reduce" in hlo
        Q = dist_cqrrpt(As, mesh, RNGState(21))[0]
        shapes = {sh.data.shape for sh in Q.addressable_shards}
        assert shapes == {(m // 8, n)}
        assert len(Q.addressable_shards) == 8

    def test_dist_rsvd(self, mesh):
        from randlapack_tpu.parallel import dist_rsvd
        from randlapack_tpu.gen import gen_exp_singvals, gen_singvec
        s = gen_exp_singvals(48, 1e6, jnp.float64)
        A, _ = gen_singvec(640, 48, s, RNGState(22))
        As = jax.device_put(A, row_sharded(mesh))
        U, S, Vt, fail, _ = dist_rsvd(As, 16, mesh, RNGState(23))
        assert not bool(fail)
        s_ref = np.linalg.svd(np.asarray(A), compute_uv=False)
        np.testing.assert_allclose(np.asarray(S[:8]), s_ref[:8], rtol=1e-4)
        Uh = np.asarray(U)
        assert np.linalg.norm(Uh.T @ Uh - np.eye(16)) < 1e-10

    def test_dist_bqrrp(self, mesh):
        from randlapack_tpu.parallel import dist_bqrrp
        A, _ = mat_gen(MatGenInfo(1024, 256, MatType.exponential,
                                  cond_num=1e5), RNGState(24))
        As = jax.device_put(A, row_sharded(mesh))
        Q, R, J, rank, fail, _ = dist_bqrrp(As, mesh, RNGState(25),
                                            block_size=64)
        assert not bool(fail)
        res = np.linalg.norm(np.asarray(Q) @ np.asarray(R)
                             - np.asarray(util.col_swap(A, J)))
        assert res < 1e-12 * float(jnp.linalg.norm(A)) * 256
        Qh = np.asarray(Q)
        assert np.linalg.norm(Qh.T @ Qh - np.eye(256)) < 1e-12
        # matches the single-device result (same RNG stream)
        from randlapack_tpu.drivers import BQRRPConfig, bqrrp
        Q2, R2, J2, *_ = bqrrp(A, BQRRPConfig(block_size=64), RNGState(25))
        np.testing.assert_array_equal(np.asarray(J), np.asarray(J2))


class TestDistBQRRPFactored:
    def test_matches_single_device(self):
        from randlapack_tpu.parallel import dist_bqrrp_factored, make_mesh
        from randlapack_tpu.drivers import bqrrp_q
        mesh = make_mesh(8)
        m, n = 128, 96
        A, st = mat_gen(MatGenInfo(m, n, MatType.polynomial, cond_num=1e5),
                        RNGState(31))
        fac, _ = dist_bqrrp_factored(A, mesh, RNGState(32), block_size=32)
        with jax.sharding.set_mesh(mesh):
            Q = bqrrp_q(fac)
        AJ = jnp.take(A, fac.J, axis=1)
        res = float(jnp.linalg.norm(Q @ fac.R - AJ) / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(Q.T @ Q - jnp.eye(96)))
        assert res < 1e-12 and orth < 1e-11
        # bit-match the single-device run (same RNG, same algorithm)
        from randlapack_tpu.drivers import BQRRPConfig, bqrrp_factored
        fac1, _ = bqrrp_factored(A, BQRRPConfig(block_size=32), RNGState(32))
        np.testing.assert_array_equal(np.asarray(fac.J), np.asarray(fac1.J))


class TestDistHQRRP:
    def test_matches_single_device(self):
        from randlapack_tpu.parallel import dist_hqrrp, make_mesh
        mesh = make_mesh(8)
        A, st = mat_gen(MatGenInfo(128, 96, MatType.polynomial,
                                   cond_num=1e5), RNGState(33))
        Q, R, J, rank, fail, _ = dist_hqrrp(A, mesh, RNGState(34),
                                            block_size=32)
        AJ = jnp.take(A, J, axis=1)
        res = float(jnp.linalg.norm(Q @ R - AJ) / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(Q.T @ Q - jnp.eye(96)))
        assert res < 1e-12 and orth < 1e-11
        from randlapack_tpu.drivers import HQRRPConfig, hqrrp
        _, _, J1, _, _, _ = hqrrp(A, HQRRPConfig(block_size=32),
                                  RNGState(34))
        np.testing.assert_array_equal(np.asarray(J), np.asarray(J1))


class TestDistLinopTrack:
    """Round-3 additions: sharded ABRIK + distributed KRILL matvec
    (SURVEY §5.8 — new design, no reference analogue)."""

    def test_dist_abrik_matches_svd(self, mesh):
        from randlapack_tpu.parallel import dist_abrik
        from randlapack_tpu.gen import fast_decay_matrix
        A, _ = fast_decay_matrix(256, 128, RNGState(7), dtype=jnp.float64,
                                 decay=6.0)
        sv = np.linalg.svd(np.asarray(A), compute_uv=False)
        U, S, Vt, info, _ = dist_abrik(A, 32, mesh, RNGState(8),
                                       block_size=16, max_iters=4)
        np.testing.assert_allclose(np.asarray(S[:8]), sv[:8], rtol=1e-6)
        orth = float(jnp.linalg.norm(U.T @ U - jnp.eye(32)))
        assert orth < 1e-10

    def test_dist_kernel_matmat_matches_local(self, mesh):
        from randlapack_tpu.parallel import DistSquaredExpKernelLinOp
        from randlapack_tpu.pdkernels import (SquaredExpKernelLinOp,
                                              standardize_dataset)
        n = 128
        X = standardize_dataset(
            jax.random.normal(jax.random.key(1), (6, n), dtype=jnp.float64))
        V = jax.random.normal(jax.random.key(2), (n, 3), dtype=jnp.float64)
        Gd = DistSquaredExpKernelLinOp(X, 2.0, 1e-2, mesh)
        Gl = SquaredExpKernelLinOp(X, 2.0, 1e-2)
        np.testing.assert_allclose(np.asarray(Gd.matmat(V)),
                                   np.asarray(Gl.matmat(V)), atol=1e-12)

    def test_dist_krill_converges(self, mesh):
        from randlapack_tpu.parallel import dist_krill
        from randlapack_tpu.pdkernels import (SquaredExpKernelLinOp,
                                              standardize_dataset)
        n = 256
        X = standardize_dataset(
            jax.random.normal(jax.random.key(5), (6, n), dtype=jnp.float64))
        sub = np.asarray(X[:, :64])
        d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
        bw = float(np.sqrt(np.median(d2[d2 > 0])))
        H = jax.random.normal(jax.random.key(6), (n, 1), dtype=jnp.float64)
        Xs, hist, it, _ = dist_krill(X, bw, 1e-2, H, mesh, RNGState(9),
                                     k=64, rpchol_block=32, tol=1e-8,
                                     max_iters=100)
        G = SquaredExpKernelLinOp(X, bw, 1e-2)
        r = float(jnp.linalg.norm(G.matmat(Xs) - H) / jnp.linalg.norm(H))
        assert r < 1e-6 and int(it) < 100

    def test_dist_cqrrt(self, mesh):
        from randlapack_tpu.parallel import dist_cqrrt
        m, n = 960, 64
        A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=1e6),
                       RNGState(31))
        As = jax.device_put(A, row_sharded(mesh))
        Q, R, fail, _ = dist_cqrrt(As, mesh, RNGState(32))
        assert not bool(fail)
        hp = jax.lax.Precision.HIGHEST
        res = float(jnp.linalg.norm(jnp.matmul(Q, R, precision=hp) - A)
                    / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(n)))
        assert res < 1e-12 and orth < 1e-12, (res, orth)
        assert float(jnp.min(jnp.diag(R))) != 0.0

    def test_dist_revd2_matches_single(self, mesh):
        from randlapack_tpu.drivers import REVD2Config, revd2_fixed_rank
        from randlapack_tpu.parallel import dist_revd2
        n, k = 512, 24
        B, _ = mat_gen(MatGenInfo(n, n, MatType.exponential, cond_num=1e8),
                       RNGState(41))
        hp = jax.lax.Precision.HIGHEST
        A = jnp.matmul(B, B.T, precision=hp) / float(jnp.linalg.norm(B)) ** 2
        As = jax.device_put(A, row_sharded(mesh))
        V, lam, err, nu, fail, _ = dist_revd2(As, k, mesh, RNGState(42))
        assert not bool(fail)
        orth = float(jnp.linalg.norm(
            jnp.matmul(V.T, V, precision=hp) - jnp.eye(k)))
        assert orth < 1e-11, orth
        # rank-k reconstruction error ≈ the single-device driver's
        Vr, lr, er, nur, fr, _ = revd2_fixed_rank(
            A, k, REVD2Config(), RNGState(42))
        rec_d = float(jnp.linalg.norm(
            A - jnp.matmul(V * lam[None, :], V.T, precision=hp)))
        rec_s = float(jnp.linalg.norm(
            A - jnp.matmul(Vr * lr[None, :], Vr.T, precision=hp)))
        assert rec_d < 2.0 * rec_s + 1e-12, (rec_d, rec_s)
        assert float(err) < 10 * max(rec_d, float(nu)), (float(err), rec_d)

    def test_dist_spls_matches_single(self, mesh):
        from randlapack_tpu.parallel import dist_spls
        m, n = 960, 48
        A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=1e6),
                       RNGState(21))
        xt = jax.random.normal(jax.random.key(22), (n,), jnp.float64)
        b = A @ xt + 1e-8 * jax.random.normal(jax.random.key(23), (m,),
                                              jnp.float64)
        for mu in [0.0, 1e-4]:
            As = jax.device_put(A, row_sharded(mesh))
            x, hist, it, _ = dist_spls(As, b, mu, mesh, RNGState(24),
                                       tol=1e-12, max_iters=100)
            hp = jax.lax.Precision.HIGHEST
            r = (jnp.matmul(A.T, jnp.matmul(A, x, precision=hp) - b,
                            precision=hp) + mu * x)
            opt = float(jnp.linalg.norm(r) / jnp.linalg.norm(
                jnp.matmul(A.T, b, precision=hp)))
            assert opt < 1e-9, (mu, opt)
            assert int(it) < 60, (mu, int(it))

    def test_dist_spls_multi_rhs(self, mesh):
        from randlapack_tpu.parallel import dist_spls
        m, n, k = 640, 32, 3
        A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=1e4),
                       RNGState(61))
        B = jax.random.normal(jax.random.key(62), (m, k), jnp.float64)
        As = jax.device_put(A, row_sharded(mesh))
        X, hist, it, _ = dist_spls(As, B, 1e-6, mesh, RNGState(63),
                                   tol=1e-12, max_iters=100)
        assert X.shape == (n, k)
        hp = jax.lax.Precision.HIGHEST
        R = (jnp.matmul(A.T, jnp.matmul(A, X, precision=hp) - B,
                        precision=hp) + 1e-6 * X)
        opt = float(jnp.linalg.norm(R) / jnp.linalg.norm(
            jnp.matmul(A.T, B, precision=hp)))
        assert opt < 1e-9, opt

    def test_dist_cholqr_scale_band(self, mesh):
        """Extreme global scales through the shard_map TSQR paths: the
        pmax band guard must keep Cholesky in range and return R linear
        in the scale."""
        A, _ = mat_gen(MatGenInfo(640, 32, MatType.exponential,
                                  cond_num=1e4), RNGState(71))
        A = A.astype(jnp.float32)
        As = jax.device_put(A, row_sharded(mesh))
        Q0, R0, f0 = dist_cholqr(As, mesh)
        assert not bool(f0)
        for scale in [2.0 ** -60, 2.0 ** 55]:
            Qs, Rs, fs = dist_cholqr(
                jax.device_put(A * jnp.float32(scale), row_sharded(mesh)),
                mesh)
            assert not bool(fs), scale
            np.testing.assert_allclose(np.asarray(Qs), np.asarray(Q0),
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(Rs) / scale,
                                       np.asarray(R0), rtol=2e-5,
                                       atol=2e-5
                                       * float(jnp.max(jnp.abs(R0))))
        from randlapack_tpu.parallel import dist_shifted_cholqr3
        Qs, Rs, fs = dist_shifted_cholqr3(
            jax.device_put(A * jnp.float32(2.0 ** -60), row_sharded(mesh)),
            mesh)
        assert not bool(fs)
        hp = jax.lax.Precision.HIGHEST
        orth = float(jnp.linalg.norm(
            jnp.matmul(Qs.T, Qs, precision=hp) - jnp.eye(32)))
        assert orth < 1e-5, orth
