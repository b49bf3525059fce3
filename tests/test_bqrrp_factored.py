"""Factored (WY / implicit-Q) BQRRP and the blocked Householder
reconstruction (reference: rl_bqrrp.hh — GEQP3-format output with
orhr_col at :453-510; LAPACK launhr_col_getrfnp2 semantics for the
adaptive-sign LU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen, kahan_matrix
from randlapack_tpu.drivers import (BQRRPConfig, bqrrp, bqrrp_apply_qt,
                                    bqrrp_factored, bqrrp_q)
from randlapack_tpu.ops.householder import getrfnp, orhr_col

EPS = float(jnp.finfo(jnp.float64).eps)
ATOL = EPS ** 0.75
hp = jax.lax.Precision.HIGHEST


class TestGetrfnp:
    @pytest.mark.parametrize("k", [4, 32, 48, 96])
    def test_factorizes_with_unit_pivots(self, k):
        rng = np.random.default_rng(k)
        Q = jnp.asarray(np.linalg.qr(rng.standard_normal((k, k)))[0])
        F, s = getrfnp(Q)
        L = jnp.tril(F, -1) + jnp.eye(k)
        U = jnp.triu(F)
        assert float(jnp.linalg.norm(L @ U - (Q - jnp.diag(s)))) < 1e-13
        assert float(jnp.min(jnp.abs(jnp.diag(U)))) >= 1.0 - 1e-12
        assert set(np.unique(np.asarray(s))) <= {-1.0, 1.0}

    @pytest.mark.parametrize("b", [64, 256])
    def test_matches_numpy_packed_lu(self, b):
        """The recursive jnp getrfnp equals a plain numpy adaptive-sign
        elimination (packed unit-L + U, s_j = −sign(Schur diagonal)) at
        the block sizes BQRRP runs, on an orthonormal block."""
        rng = np.random.default_rng(b)
        Q = np.linalg.qr(rng.standard_normal((b, b)))[0]
        F_ref = Q.copy()
        s_ref = np.zeros(b)
        for j in range(b):
            s_ref[j] = -1.0 if F_ref[j, j] >= 0 else 1.0
            F_ref[j, j] -= s_ref[j]
            F_ref[j + 1:, j] /= F_ref[j, j]
            F_ref[j + 1:, j + 1:] -= np.outer(F_ref[j + 1:, j],
                                              F_ref[j, j + 1:])
        F, s = getrfnp(jnp.asarray(Q))
        np.testing.assert_array_equal(np.asarray(s), s_ref)
        np.testing.assert_allclose(np.asarray(F), F_ref, atol=1e-11)

    def test_adversarial_rotation(self):
        """Block-diagonal rotations give Q1·S_fixed an eigenvalue exactly
        1 (the fixed-sign construction is singular there); the adaptive
        signs must stay robust."""
        th = 0.7
        R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        Q = jnp.asarray(np.kron(np.eye(8), R2))
        F, s = getrfnp(Q)
        U = jnp.triu(F)
        assert float(jnp.min(jnp.abs(jnp.diag(U)))) >= 1.0 - 1e-12


class TestOrhrCol:
    @pytest.mark.parametrize("m,b,c", [(40, 6, 9), (64, 64, 0),
                                       (100, 50, 50), (96, 32, 33)])
    def test_exact_orthogonal_and_range(self, m, b, c):
        rng = np.random.default_rng(m + b)
        A = rng.standard_normal((m, b))
        A[:c] = 0.0
        Q = jnp.asarray(np.linalg.qr(A)[0])
        V, T, s = orhr_col(Q, c)
        H = jnp.eye(m) - V @ T @ V.T
        assert float(jnp.linalg.norm(H.T @ H - jnp.eye(m))) < 1e-12
        assert float(jnp.linalg.norm(H[:, c:c + b] - Q * s[None, :])) < 1e-12
        # LAPACK layout: T upper triangular, V unit diagonal at offset
        assert float(jnp.linalg.norm(jnp.tril(T, -1))) == 0.0
        assert float(jnp.linalg.norm(
            V[c + jnp.arange(b), jnp.arange(b)] - 1.0)) < 1e-12
        assert float(jnp.linalg.norm(V[:c])) < 1e-13

    def test_square_orthogonal_block(self):
        """The BQRRP last-block regression: square orthogonal panel."""
        th = 0.7
        R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        Q = jnp.asarray(np.kron(np.eye(8), R2))
        V, T, s = orhr_col(Q, 0)
        H = jnp.eye(16) - V @ T @ V.T
        assert float(jnp.linalg.norm(H.T @ H - jnp.eye(16))) < 1e-12
        assert float(jnp.linalg.norm(H - Q * s[None, :])) < 1e-12


class TestBQRRPFactored:
    @pytest.mark.parametrize("shape,b,cand", [
        ((400, 400), 100, 2),    # square: exercises the square last panel
        ((500, 300), 75, 2),     # tall
        ((200, 320), 50, 2),     # wide
        ((256, 256), 64, None),  # full-width LU pivots
    ])
    def test_invariants(self, shape, b, cand):
        m, n = shape
        K = min(m, n)
        A, st = mat_gen(MatGenInfo(m, n, MatType.polynomial, cond_num=1e6),
                        RNGState(5))
        fac, _ = bqrrp_factored(
            A, BQRRPConfig(block_size=b, pivot_candidates=cand), st)
        assert not bool(fac.fail)
        Q = bqrrp_q(fac)
        AJ = jnp.take(A, fac.J, axis=1)
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, fac.R, precision=hp) - AJ) / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(K)))
        assert res < ATOL * 10
        assert orth < ATOL * np.sqrt(K) * 10
        assert sorted(np.asarray(fac.J).tolist()) == list(range(n))
        assert float(jnp.linalg.norm(jnp.tril(fac.R[:, :K], -1))) == 0.0

    def test_apply_qt(self):
        A, st = mat_gen(MatGenInfo(300, 200, MatType.exponential,
                                   cond_num=1e4), RNGState(6))
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=50), st)
        QtAJ = bqrrp_apply_qt(fac, jnp.take(A, fac.J, axis=1))
        np.testing.assert_allclose(np.asarray(jnp.triu(QtAJ[:200])),
                                   np.asarray(fac.R), atol=1e-10)
        # rows below K must be annihilated
        assert float(jnp.linalg.norm(QtAJ[200:])) < 1e-10 * float(
            jnp.linalg.norm(A))

    def test_partial_q_materialization(self):
        A, st = mat_gen(MatGenInfo(240, 240, MatType.gaussian), RNGState(7))
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=60), st)
        Qk = bqrrp_q(fac, k=60)
        Qfull = bqrrp_q(fac)
        np.testing.assert_allclose(np.asarray(Qk), np.asarray(Qfull[:, :60]),
                                   atol=1e-12)

    def test_matches_explicit_driver_quality(self):
        """Factored and explicit drivers are the same algorithm family:
        equal-quality residuals on the same input (not identical pivots —
        the explicit driver BCGS-projects panels before QR)."""
        A, st = mat_gen(MatGenInfo(320, 320, MatType.polynomial,
                                   cond_num=1e8), RNGState(8))
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=80), st)
        Qf = bqrrp_q(fac)
        res_f = float(jnp.linalg.norm(
            jnp.matmul(Qf, fac.R, precision=hp)
            - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
        Q, R, J, rank, fail, _ = bqrrp(A, BQRRPConfig(block_size=80), st)
        res_e = float(jnp.linalg.norm(
            jnp.matmul(Q, R, precision=hp)
            - jnp.take(A, J, axis=1)) / jnp.linalg.norm(A))
        assert res_f < max(10 * res_e, ATOL * 10)

    def test_rank_deficient(self):
        A, st = mat_gen(MatGenInfo(300, 240, MatType.polynomial,
                                   cond_num=1e4, rank=60), RNGState(9))
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=60), st)
        assert int(fac.rank) <= 90
        Q = bqrrp_q(fac, k=60)
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, fac.R[:60], precision=hp)
            - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
        assert res < 1e-8
        # Q stays machine-orthonormal past the rank (reflector form)
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(60)))
        assert orth < ATOL * 10

    def test_kahan(self):
        A = kahan_matrix(128, jnp.float64)
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=32), st := RNGState(10))
        Q = bqrrp_q(fac)
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, fac.R, precision=hp)
            - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
        assert res < ATOL * 10

    def test_timing_dict(self):
        A, st = mat_gen(MatGenInfo(120, 120, MatType.gaussian), RNGState(11))
        out = bqrrp_factored(A, BQRRPConfig(block_size=40), st, timing=True)
        assert {"sketch", "stage_0", "epilogue"} <= set(out[2])


class TestBQRRPShapeFreedom:
    """VERDICT item: arbitrary min(m,n) (remainder block) and wide-matrix
    stages for BOTH drivers (rl_bqrrp.hh:569-576 semantics)."""

    @pytest.mark.parametrize("shape,cfg", [
        ((317, 317), BQRRPConfig(block_size=64)),
        ((450, 290), BQRRPConfig(block_size=64, pivot_candidates=2)),
        ((200, 330), BQRRPConfig(block_size=64)),
        ((256, 512), BQRRPConfig(block_size=64, stages=2)),
        ((120, 80), BQRRPConfig(block_size=128)),  # block > K clamps
    ])
    def test_explicit_and_factored(self, shape, cfg):
        m, n = shape
        K = min(m, n)
        A, st = mat_gen(MatGenInfo(m, n, MatType.polynomial, cond_num=1e6),
                        RNGState(5))
        Q, R, J, rank, fail, _ = bqrrp(A, cfg, st)
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, R, precision=hp) - jnp.take(A, J, axis=1))
            / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(K)))
        assert res < ATOL * 10 and orth < ATOL * np.sqrt(K) * 10
        fac, _ = bqrrp_factored(A, cfg, st)
        Qf = bqrrp_q(fac)
        resf = float(jnp.linalg.norm(
            jnp.matmul(Qf, fac.R, precision=hp)
            - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
        orthf = float(jnp.linalg.norm(
            jnp.matmul(Qf.T, Qf, precision=hp) - jnp.eye(K)))
        assert resf < ATOL * 10 and orthf < ATOL * np.sqrt(K) * 10


class TestFactoredQRTallVariants:
    def test_hqr_panel_variant(self):
        """qr_tall=hqr (the reference's geqrf panel option) in the
        factored form: Householder R + one solve keeps zeros above c."""
        from randlapack_tpu.drivers.bqrrp import QRTall
        A, st = mat_gen(MatGenInfo(320, 320, MatType.polynomial,
                                   cond_num=1e8), RNGState(13))
        fac, _ = bqrrp_factored(
            A, BQRRPConfig(block_size=80, qr_tall=QRTall.hqr), st)
        Q = bqrrp_q(fac)
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, fac.R, precision=hp)
            - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(320)))
        assert res < ATOL * 10 and orth < ATOL * np.sqrt(320) * 10


class TestBQRRPQMethods:
    def test_tree_equals_sequential(self):
        A, st = mat_gen(MatGenInfo(250, 180, MatType.polynomial,
                                   cond_num=1e6), RNGState(5))
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=50), st)
        Qt = bqrrp_q(fac, method="tree")
        Qs = bqrrp_q(fac, method="sequential")
        np.testing.assert_allclose(np.asarray(Qt), np.asarray(Qs),
                                   atol=1e-13)
        Qk = bqrrp_q(fac, k=50, method="tree")
        np.testing.assert_allclose(np.asarray(Qk), np.asarray(Qs[:, :50]),
                                   atol=1e-13)


class TestUpdateDefer:
    """Left-looking aggregated trailing updates (update_defer > 1) must be
    exactly equivalent math to the eager loop — the within-group lazy
    corrections are exact low-rank algebra, not approximations."""

    @pytest.mark.parametrize("defer,stages", [(2, 1), (4, 1), (3, 1),
                                              (2, 2), (4, 2)])
    def test_matches_eager_quality(self, defer, stages):
        A, _ = mat_gen(MatGenInfo(384, 320, MatType.polynomial,
                                  cond_num=1e7), RNGState(11),
                       dtype=jnp.float64)
        cfg = BQRRPConfig(block_size=64, update_defer=defer, stages=stages,
                          pivot_candidates=3)
        fac, _ = bqrrp_factored(A, cfg, RNGState(5))
        Q = bqrrp_q(fac)
        K = min(A.shape)
        res = float(jnp.linalg.norm(Q @ fac.R - jnp.take(A, fac.J, axis=1))
                    / jnp.linalg.norm(A))
        orth = float(jnp.linalg.norm(Q.T @ Q - jnp.eye(K)))
        assert res < 1e-13 and orth < 1e-12, (defer, stages, res, orth)
        assert not bool(fac.fail)

    def test_defer_non_divisible_blocks(self):
        # 5 blocks with defer=4 exercises the remainder group
        A, _ = mat_gen(MatGenInfo(320, 320, MatType.exponential,
                                  cond_num=1e5), RNGState(3),
                       dtype=jnp.float64)
        cfg = BQRRPConfig(block_size=64, update_defer=4)
        fac, _ = bqrrp_factored(A, cfg, RNGState(6))
        Q = bqrrp_q(fac)
        res = float(jnp.linalg.norm(Q @ fac.R - jnp.take(A, fac.J, axis=1))
                    / jnp.linalg.norm(A))
        assert res < 1e-13


class TestTrailingPrecision:
    """Mixed-precision trailing updates: the bf16_3x emulation of a lossy
    f32 matmul precision must keep residual
    within f32 reference tolerance (measured CPU envelope ~5.5e-6 vs
    7.5e-7 at HIGHEST) and leave orthogonality untouched. CQRRPT's
    sketch-QRCP trailing must be completely insensitive (the R rows it
    consumes never see the trailing GEMM)."""

    def test_factored_emul_quality(self):
        from randlapack_tpu.gen import fast_decay_matrix
        A, _ = fast_decay_matrix(512, 512, RNGState(0),
                                 dtype=jnp.float32)
        hp = jax.lax.Precision.HIGHEST
        res = {}
        for tp in ("highest", "bf16_3x_emul"):
            cfg = BQRRPConfig(block_size=128, trailing_precision=tp)
            fac, _ = bqrrp_factored(A, cfg, RNGState(1))
            Q = bqrrp_q(fac)
            res[tp] = float(jnp.linalg.norm(
                jnp.matmul(Q, fac.R, precision=hp)
                - jnp.take(A, fac.J, axis=1)) / jnp.linalg.norm(A))
            orth = float(jnp.linalg.norm(
                jnp.matmul(Q.T, Q, precision=hp)
                - jnp.eye(512, dtype=Q.dtype)))
            assert orth < 1e-4, (tp, orth)
            assert not bool(fac.fail)
        assert res["highest"] < 3e-6
        assert res["bf16_3x_emul"] < 3e-5   # measured ~5.5e-6; 5x margin

    def test_explicit_emul_quality(self):
        from randlapack_tpu.drivers import bqrrp
        from randlapack_tpu.gen import fast_decay_matrix
        A, _ = fast_decay_matrix(512, 512, RNGState(2),
                                 dtype=jnp.float32)
        hp = jax.lax.Precision.HIGHEST
        cfg = BQRRPConfig(block_size=128,
                          trailing_precision="bf16_3x_emul")
        Q, R, J, rank, fail, _ = bqrrp(A, cfg, RNGState(3))
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, R, precision=hp) - jnp.take(A, J, axis=1))
            / jnp.linalg.norm(A))
        assert res < 3e-5 and not bool(fail), res

    def test_cqrrpt_insensitive_to_sketch_trailing(self):
        from randlapack_tpu.drivers import CQRRPTConfig, cqrrpt
        from randlapack_tpu.gen import fast_decay_matrix
        A, _ = fast_decay_matrix(4096, 256, RNGState(4),
                                 dtype=jnp.float32, decay=6.0)
        outs = {}
        for tp in ("highest", "bf16_3x_emul"):
            cfg = CQRRPTConfig(bqrrp_trailing_precision=tp)
            Q, R, J, rank, fail, _ = cqrrpt(A, cfg, RNGState(5))
            outs[tp] = (np.asarray(J), np.asarray(R))
            assert not bool(fail)
        # identical pivots; R equal to f32 roundoff (the preconditioner
        # path never reads the trailing GEMM's output rows)
        np.testing.assert_array_equal(outs["highest"][0],
                                      outs["bf16_3x_emul"][0])
        np.testing.assert_allclose(outs["highest"][1],
                                   outs["bf16_3x_emul"][1],
                                   rtol=0, atol=1e-5 * float(
                                       np.abs(outs["highest"][1]).max()))


class TestF64LUPivotRoute:
    """f64 takes the same LU pivot route as f32 on every backend (XLA's
    LU is f64-capable on the CPU and, through cuSOLVER getrf, on a GPU)."""

    def test_lu_pivot_route(self):
        A, _ = mat_gen(MatGenInfo(256, 256, MatType.exponential,
                                  cond_num=1e8), RNGState(13),
                       dtype=jnp.float64)
        for cand in (None, 2):
            cfg = BQRRPConfig(block_size=64, pivot_candidates=cand)
            fac, _ = bqrrp_factored(A, cfg, RNGState(7))
            Q = bqrrp_q(fac)
            res = float(jnp.linalg.norm(Q @ fac.R
                                        - jnp.take(A, fac.J, axis=1))
                        / jnp.linalg.norm(A))
            assert res < 1e-13, (cand, res)
            # pivot quality: leading |R| diagonal reflects the decay
            dg = np.abs(np.asarray(jnp.diag(fac.R)))
            assert dg[0] > dg[-1]


class TestMaskedTrailingHelpers:
    """The factored form's masked trailing GEMMs against numpy."""

    @pytest.mark.parametrize("tp", ["highest", "high", "default"])
    def test_against_numpy(self, tp):
        from randlapack_tpu.drivers.bqrrp import (a_minus_vz_masked_mixed,
                                                  masked_vt_a_mixed)
        rng = np.random.default_rng(1)
        V = rng.standard_normal((96, 16))
        A = rng.standard_normal((96, 40))
        Z = rng.standard_normal((16, 40))
        mask = (rng.random(40) > 0.4).astype(np.float64)
        W = masked_vt_a_mixed(jnp.asarray(V), jnp.asarray(A),
                              jnp.asarray(mask), tp, hp)
        np.testing.assert_allclose(np.asarray(W), V.T @ (A * mask),
                                   atol=1e-12)
        out = a_minus_vz_masked_mixed(jnp.asarray(A), jnp.asarray(V),
                                      jnp.asarray(Z), jnp.asarray(mask),
                                      tp, hp)
        np.testing.assert_allclose(np.asarray(out), A - (V @ Z) * mask,
                                   atol=1e-12)

    def test_bf16_3x_emulation(self):
        """The bf16-split emulation lands at bf16_3x accuracy (~1e-5
        relative), between bf16 (~4e-3) and f32."""
        from randlapack_tpu.drivers.bqrrp import masked_vt_a_mixed
        rng = np.random.default_rng(2)
        V = rng.standard_normal((128, 32)).astype(np.float32)
        A = rng.standard_normal((128, 64)).astype(np.float32)
        mask = (rng.random(64) > 0.5).astype(np.float32)
        W = masked_vt_a_mixed(jnp.asarray(V), jnp.asarray(A),
                              jnp.asarray(mask), "bf16_3x_emul", hp)
        ref = V.astype(np.float64).T @ (A.astype(np.float64) * mask)
        rel = np.linalg.norm(np.asarray(W, np.float64) - ref) / \
            np.linalg.norm(ref)
        assert 0.0 < rel < 1e-4, rel
