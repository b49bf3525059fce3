"""Kernel toolbox tests: CholQR family, geqp3, LU pivots, utilities.
Tolerances follow the reference's test conventions (residual and
orthogonality ≤ eps^0.75-scale, SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState
from randlapack_tpu.ops import cholqr, cholqr2, shifted_cholqr3, geqp3, qr_econ
from randlapack_tpu.ops.qr import lu_pivot_columns
from randlapack_tpu.ops import util
from randlapack_tpu.gen import (MatGenInfo, MatType, mat_gen,
                                bad_cholqr_matrix, kahan_matrix)

EPS = np.finfo(np.float64).eps
ATOL = EPS ** 0.75


def _orth_err(Q):
    return float(util.orthogonality_check(Q))


class TestCholQR:
    def test_wellcond(self):
        A, _ = mat_gen(MatGenInfo(500, 60, MatType.exponential, cond_num=10),
                       RNGState(0))
        Q, R, fail = cholqr(A)
        assert not bool(fail)
        assert _orth_err(Q) < ATOL * np.sqrt(60)
        np.testing.assert_allclose(np.asarray(Q @ R), np.asarray(A),
                                   atol=ATOL * float(jnp.linalg.norm(A)))

    def test_cholqr2_illcond(self):
        A, _ = mat_gen(MatGenInfo(500, 60, MatType.exponential, cond_num=1e6),
                       RNGState(1))
        Q, R, fail = cholqr2(A)
        assert not bool(fail)
        assert _orth_err(Q) < ATOL * np.sqrt(60)

    @pytest.mark.parametrize("cond", [10.0, 1e3, 1e4, 1e6, 1e7, 3e7])
    def test_cholqr_auto_ladder_f32(self, cond):
        # condition-aware auto-routing (VERDICT r3 item 5): the κ=1e4-class
        # f32 inputs that cholqr/cholqr2 fail-flag must come back at
        # reference tolerance via the lazy rescue ladder
        from randlapack_tpu.ops import cholqr_auto
        A, _ = mat_gen(MatGenInfo(2000, 100, MatType.exponential,
                                  cond_num=cond), RNGState(7),
                       dtype=jnp.float32)
        Q, R, fail = cholqr_auto(A)
        assert not bool(fail), f"auto ladder failed at cond={cond}"
        hp = jax.lax.Precision.HIGHEST
        orth = float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(100, dtype=Q.dtype)))
        res = float(jnp.linalg.norm(
            jnp.matmul(Q, R, precision=hp) - A) / jnp.linalg.norm(A))
        assert orth < 1e-4, f"cond={cond} orth={orth}"
        assert res < 1e-5, f"cond={cond} res={res}"

    def test_cholqr_auto_rank_deficient_flags(self):
        # genuinely rank-deficient input: the ladder must flag, not NaN
        from randlapack_tpu.ops import cholqr_auto
        A, _ = mat_gen(MatGenInfo(400, 40, MatType.exponential,
                                  cond_num=10), RNGState(8),
                       dtype=jnp.float32)
        A = A.at[:, 20:].set(A[:, :20])  # exact rank 20
        Q, R, fail = cholqr_auto(A)
        assert bool(jnp.all(jnp.isfinite(Q)))

    def test_stab_auto_routes(self):
        from randlapack_tpu.comps.orth import Stab, orth
        A, _ = mat_gen(MatGenInfo(1000, 50, MatType.exponential,
                                  cond_num=1e5), RNGState(9),
                       dtype=jnp.float32)
        Q, fail = orth(A, Stab.auto)
        assert not bool(fail)
        assert float(jnp.linalg.norm(
            jnp.matmul(Q.T, Q, precision=jax.lax.Precision.HIGHEST)
            - jnp.eye(50, dtype=Q.dtype))) < 1e-4

    @pytest.mark.parametrize("n,block", [(128, 32), (96, 32), (100, 32),
                                         (64, 64), (128, 128)])
    def test_gram_syrk_matches_full(self, n, block):
        # blocked upper-triangle Gram == full GEMM Gram (exact in f64 up
        # to summation order); uneven / single-block shapes fall back
        from randlapack_tpu.ops.cholqr import gram_syrk, _gram
        A, _ = mat_gen(MatGenInfo(700, n, MatType.gaussian), RNGState(11))
        G_s = gram_syrk(A, jax.lax.Precision.HIGHEST, block)
        G_f = _gram(A, jax.lax.Precision.HIGHEST)
        assert np.allclose(np.asarray(G_s), np.asarray(G_f),
                           atol=1e-12 * float(jnp.max(jnp.abs(G_f))))
        if n % block == 0 and n // block >= 2:
            # the blocked path's assembled output is EXACTLY symmetric
            # (uneven shapes fall back to the full GEMM, which is not)
            assert np.array_equal(np.asarray(G_s), np.asarray(G_s).T)

    @pytest.mark.parametrize("n,block", [(128, 32), (96, 32), (100, 32),
                                         (64, 64)])
    def test_trsm_blockinv_matches_xla(self, n, block):
        # partitioned-inverse right-trsm == XLA triangular_solve on a
        # pivoted-QR-style R (decay spread along the diagonal); uneven /
        # single-block shapes fall back to the XLA solve exactly
        from randlapack_tpu.ops.trsm import trsm_right_upper_blockinv
        A, st = mat_gen(MatGenInfo(500, n, MatType.polynomial,
                                   cond_num=1e8), RNGState(3))
        _, R, _ = geqp3(A, want_q=False,
                        precision=jax.lax.Precision.HIGHEST)
        R = R[:n, :]
        B, _ = mat_gen(MatGenInfo(500, n, MatType.gaussian), st)
        X_ref = jax.lax.linalg.triangular_solve(
            R, B, left_side=False, lower=False)
        X_blk = trsm_right_upper_blockinv(
            B, R, block, jax.lax.Precision.HIGHEST)
        rel = (float(jnp.linalg.norm(X_blk - X_ref))
               / float(jnp.linalg.norm(X_ref)))
        assert rel < 1e-10  # f64: both solves agree to roundoff-class

    def test_cholqr_fails_on_bad(self):
        # cond ~ 1/sqrt(eps_f64) breaks one-pass CholQR's Gram matrix
        A, _ = bad_cholqr_matrix(400, 50, RNGState(2), jnp.float64,
                                 cond=1e13)
        _, _, fail = cholqr(A)
        # shifted CholQR3 must survive the same matrix
        Q, R, f3 = shifted_cholqr3(A)
        assert not bool(f3)
        assert _orth_err(Q) < 1e-10 * np.sqrt(50)
        np.testing.assert_allclose(np.asarray(Q @ R), np.asarray(A),
                                   atol=ATOL * float(jnp.linalg.norm(A)))


class TestGEQP3:
    def test_factorization(self):
        A, _ = mat_gen(MatGenInfo(80, 60, MatType.polynomial, cond_num=1e8),
                       RNGState(3))
        Q, R, J = geqp3(A)
        AJ = np.asarray(util.col_swap(A, J))
        np.testing.assert_allclose(np.asarray(Q @ R), AJ,
                                   atol=ATOL * float(jnp.linalg.norm(A)))
        assert _orth_err(Q) < 1e-12 * np.sqrt(60)
        # pivoting property: diagonal decreasing in magnitude
        d = np.abs(np.diag(np.asarray(R)))
        assert np.all(d[:-1] >= d[1:] * (1 - 1e-10))

    def test_vs_scipy(self):
        import scipy.linalg as sla
        A, _ = mat_gen(MatGenInfo(50, 40, MatType.exponential, cond_num=1e4),
                       RNGState(4))
        _, R, J = geqp3(A)
        _, Rs, Js = sla.qr(np.asarray(A), pivoting=True, mode="economic")
        np.testing.assert_allclose(np.abs(np.diag(np.asarray(R))),
                                   np.abs(np.diag(Rs)), rtol=1e-8)
        np.testing.assert_array_equal(np.asarray(J), Js)

    def test_kahan_pivots(self):
        # Kahan matrix: QRCP must reveal the small trailing singular value
        A = kahan_matrix(40, jnp.float64)
        _, R, J = geqp3(A)
        s = np.linalg.svd(np.asarray(A), compute_uv=False)
        d = np.abs(np.diag(np.asarray(R)))
        assert d[-1] < 100 * s[-1] + 1e-12

    def test_rank_deficient(self):
        A, _ = mat_gen(MatGenInfo(60, 40, MatType.exponential, cond_num=1e3),
                       RNGState(5), dtype=jnp.float64)
        A = jnp.concatenate([A[:, :20], A[:, :20]], axis=1)  # rank 20
        Q, R, J = geqp3(A)
        d = np.abs(np.diag(np.asarray(R)))
        assert d[20] < 1e-10 * d[0]
        AJ = np.asarray(util.col_swap(A, J))
        np.testing.assert_allclose(np.asarray(Q @ R), AJ,
                                   atol=ATOL * float(jnp.linalg.norm(A)))


class TestLUPivots:
    def test_first_pivot_is_large(self):
        A, _ = mat_gen(MatGenInfo(30, 100, MatType.polynomial, cond_num=1e6),
                       RNGState(6))
        perm = lu_pivot_columns(A.T)
        norms = np.linalg.norm(np.asarray(A), axis=0)
        # first chosen column should be within a small factor of the max
        assert norms[int(perm[0])] > 0.3 * norms.max()


class TestUtil:
    def test_naive_rank_est(self):
        d = jnp.asarray([3.0, 2.0, 1e-14, 5.0])
        assert int(util.naive_rank_est(d, 1e-10)) == 2

    def test_pivots(self):
        J = jnp.asarray([2, 0, 1], dtype=jnp.int32)
        inv = util.invert_pivots(J)
        np.testing.assert_array_equal(np.asarray(inv), [1, 2, 0])
        A = jnp.arange(9.0).reshape(3, 3)
        np.testing.assert_allclose(
            np.asarray(util.col_swap(util.col_swap(A, J), inv)),
            np.asarray(A))


class TestUtilCoverage:
    def test_normc(self):
        A = jnp.asarray([[3.0, 0.0], [4.0, 0.0]])
        N = util.normc(A)
        np.testing.assert_allclose(np.asarray(jnp.linalg.norm(N, axis=0)),
                                   [1.0, 0.0], atol=1e-15)

    def test_fro_and_rank(self):
        A, _ = mat_gen(MatGenInfo(50, 30, MatType.exponential,
                                  cond_num=10), RNGState(60))
        assert abs(float(util.fro_norm(A))
                   - np.linalg.norm(np.asarray(A))) < 1e-12
        assert int(util.rank_check(A)) == 30
        B = jnp.concatenate([A[:, :10], A[:, :10]], axis=1)
        assert int(util.rank_check(B)) == 10

    def test_diag_and_search(self):
        R = jnp.diag(jnp.asarray([3.0, 2.0, 1.0, 1e-13]))
        assert bool(util.diag_is_nonzero(R, tol=1e-14))
        assert not bool(util.diag_is_nonzero(R, tol=1e-12))
        s = jnp.asarray([5.0, 1.0, 0.1, 1e-9])
        assert int(util.rank_search_binary(s, 1e-3)) == 3

    def test_compose_pivots(self):
        J1 = jnp.asarray([2, 0, 1], jnp.int32)
        J2 = jnp.asarray([1, 2, 0], jnp.int32)
        # applying J1 then J2 == composed gather
        x = jnp.asarray([10.0, 20.0, 30.0])
        step = jnp.take(jnp.take(x, J1), J2)
        composed = jnp.take(x, util.compose_pivots(J1, J2))
        np.testing.assert_allclose(np.asarray(step), np.asarray(composed))

    def test_require(self):
        from randlapack_tpu.errors import RandLAPACKError, require
        require(True, "fine")
        import pytest as _pt
        with _pt.raises(RandLAPACKError, match="boom"):
            require(False, "boom")


class TestRandBLASSmallUtils:
    """SURVEY §2.9 small-symbol parity: symmetrize / safe_scal /
    omatcopy / dims_before_op."""

    def test_symmetrize(self):
        A = jnp.asarray(np.arange(9.0).reshape(3, 3))
        Su = util.symmetrize(A, "upper")
        Sl = util.symmetrize(A, "lower")
        assert np.allclose(np.asarray(Su), np.asarray(Su).T)
        assert np.allclose(np.asarray(Sl), np.asarray(Sl).T)
        assert np.allclose(np.triu(np.asarray(Su)), np.triu(np.asarray(A)))
        assert np.allclose(np.tril(np.asarray(Sl)), np.tril(np.asarray(A)))

    def test_safe_scal_split_path(self):
        # alpha above the sqrt(max) threshold takes the split-scaling
        # path; the representable product must come out exact
        x = jnp.asarray(np.ones(4, np.float32) * 1e5)
        y = util.safe_scal(np.float32(1e30), x)
        np.testing.assert_allclose(np.asarray(y), 1e35, rtol=1e-6)
        z = util.safe_scal(2.0, jnp.asarray([1.0, -2.0]))
        np.testing.assert_allclose(np.asarray(z), [2.0, -4.0])
        zn = util.safe_scal(-1e30, jnp.asarray(np.ones(2, np.float32)))
        np.testing.assert_allclose(np.asarray(zn), -1e30, rtol=1e-6)

    def test_omatcopy_dims_before_op(self):
        A = jnp.asarray(np.arange(6.0).reshape(2, 3))
        np.testing.assert_allclose(np.asarray(util.omatcopy(A, trans=True,
                                                            alpha=2.0)),
                                   2.0 * np.arange(6.0).reshape(2, 3).T)
        assert util.dims_before_op(4, 7, True) == (7, 4)
        assert util.dims_before_op(4, 7, False) == (4, 7)

    def test_transpose_square(self):
        A = jnp.asarray(np.arange(16.0).reshape(4, 4))
        np.testing.assert_allclose(np.asarray(util.transpose_square(A)),
                                   np.arange(16.0).reshape(4, 4).T)
        with pytest.raises(AssertionError):
            util.transpose_square(jnp.zeros((3, 4)))


class TestSVDEnvelope:
    """Pin the MEASURED f32 accuracy envelope of the gram_eigh SVD route
    (docs/svd_envelope.md; tools/svd_envelope_sweep.py). The route is a
    selectable SVD method, so its trustworthy-sigma region is a library
    contract, not an implementation detail."""

    @staticmethod
    def _factor(p, q, kappa, seed):
        rng = np.random.default_rng(seed)
        k = min(p, q)
        s = np.logspace(0, -np.log10(kappa), k)
        U, _ = np.linalg.qr(rng.standard_normal((p, k)))
        V, _ = np.linalg.qr(rng.standard_normal((q, k)))
        return jnp.asarray((U * s) @ V.T, jnp.float32), s

    @pytest.mark.parametrize("p,q,kappa", [(256, 256, 1e6),
                                           (128, 1024, 1e8)])
    def test_value_envelope_f32(self, p, q, kappa):
        from randlapack_tpu.ops.svd import svd_econ
        B, s_true = self._factor(p, q, kappa, seed=p + q)
        U, s, Vt = svd_econ(B, method="gram_eigh")
        s = np.asarray(s)[:len(s_true)]
        rel = np.abs(s - s_true) / s_true
        ratio = s_true / s_true[0]
        # rule 1: sigma >= 1e-2*sigma_1 good to ~1e-4 (5x safety margin)
        assert np.all(rel[ratio >= 1e-2] < 5e-4), \
            f"shallow values degraded: {rel[ratio >= 1e-2].max():.2e}"
        # rule 2: sigma >= 1e-2..3e-3 region good to ~1e-3 is spectrum-
        # dependent (measured 2.3e-3..9.6e-3 boundary); assert the
        # conservative 1e-2 boundary at the 1e-3 level as the contract
        assert np.all(rel[ratio >= 1e-2] < 1e-3)

    def test_triplet_residual_envelope_f32(self):
        from randlapack_tpu.ops.svd import svd_econ
        B, s_true = self._factor(256, 256, 1e8, seed=3)
        U, s, Vt = svd_econ(B, method="gram_eigh")
        U, s, Vt = (np.asarray(U, np.float64), np.asarray(s, np.float64),
                    np.asarray(Vt, np.float64))
        Bf = np.asarray(B, np.float64)
        r1 = np.linalg.norm(Bf @ Vt.T - U * s, axis=0)
        r2 = np.linalg.norm(Bf.T @ U - Vt.T * s, axis=0)
        res = np.maximum(r1, r2) / s_true[0]
        # rule 4: consistent factors across the returned spectrum
        # (measured <= 1.1e-3; 3x margin)
        assert float(res.max()) < 3.5e-3, f"triplet residual {res.max():.2e}"

    @pytest.mark.parametrize("p,q", [(256, 256), (128, 1024), (301, 77)])
    def test_jacobi_route_f32(self, p, q):
        # one-sided Jacobi: values to the input-rounding bound, eps-level
        # triplet residuals at any depth (docs/svd_envelope.md r4 table);
        # odd widths exercise the pad column
        from randlapack_tpu.ops.svd import svd_econ
        B, s_true = self._factor(p, q, 1e6, seed=11 * p + q)
        U, s, Vt = svd_econ(B, method="jacobi")
        s_ = np.asarray(s)[:len(s_true)]
        rel = np.abs(s_ - s_true) / s_true
        ratio = s_true / s_true[0]
        # values: 2e-4-accurate down to 3e-3*sigma1 (measured <= 3.2e-5
        # at sweeps=20 across these shapes; margin for platform noise —
        # deeper than gram_eigh's 1e-3@1e-2 contract either way)
        assert np.all(rel[ratio >= 3e-3] < 2e-4), \
            f"{rel[ratio >= 3e-3].max():.2e}"
        # triplet residuals eps-level everywhere (the jacobi advantage)
        Bf = np.asarray(B, np.float64)
        Uf, Vtf = np.asarray(U, np.float64), np.asarray(Vt, np.float64)
        r = np.linalg.norm(Bf @ Vtf.T - Uf * s_, axis=0) / s_true[0]
        assert float(r.max()) < 1e-5, f"triplet res {r.max():.2e}"
        # leading left vectors orthonormal
        k = int((ratio >= 1e-2).sum())
        orth = np.linalg.norm(Uf[:, :k].T @ Uf[:, :k] - np.eye(k))
        # 20 sweeps of f32 rotation roundoff accumulate ~1e-4
        assert orth < 3e-4, orth

    def test_flat_spectrum_accurate_throughout(self):
        # rule 5: step spectra (flat head + cliff) stay accurate at depth
        # — FULL-RANK factor (a tail cluster sitting just above a null
        # space loses its vectors to eigh null-space mixing instead; that
        # regime is below the trust region by construction)
        from randlapack_tpu.ops.svd import svd_econ
        rng = np.random.default_rng(7)
        k = 300
        s_true = np.ones(k); s_true[k // 2:] = 1e-5
        U, _ = np.linalg.qr(rng.standard_normal((400, k)))
        V, _ = np.linalg.qr(rng.standard_normal((k, k)))
        B = jnp.asarray((U * s_true) @ V.T, jnp.float32)
        _, s, _ = svd_econ(B, method="gram_eigh")
        s = np.asarray(s)[:k]
        rel = np.abs(s - s_true) / s_true
        head, tail = rel[:k // 2], rel[k // 2:]
        assert np.all(head < 1e-5), f"flat head degraded: {head.max():.2e}"
        assert np.all(tail < 1e-2), f"cliff tail degraded: {tail.max():.2e}"
