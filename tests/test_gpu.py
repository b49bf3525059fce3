"""Tests that need an NVIDIA GPU. They skip elsewhere; on the card run

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(``chip_smoke.py`` does, in a child process). Whether a card is present is
decided inside the ``gpu`` fixture, never at import."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState

pytestmark = pytest.mark.gpu
hp = jax.lax.Precision.HIGHEST


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.mark.parametrize("n,s", [(2048, 1), (1000, 64)])
def test_kernel_matmat_compiled(gpu, n, s):
    """The Triton kernel, compiled for the card, agrees with the plain
    reference at full f32 (a TF32 product would read ~1e-3)."""
    from randlapack_tpu.ops.pallas_kernels import (kernel_matmat,
                                                   kernel_matmat_reference)
    X = jax.random.normal(jax.random.key(0), (8, n), jnp.float32)
    V = jax.random.normal(jax.random.key(1), (n, s), jnp.float32)
    out = kernel_matmat(X, V, 2.0)
    ref = kernel_matmat_reference(X, V, 2.0, precision=hp)
    rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    assert rel < 1e-5, rel


def test_linop_takes_fused_kernel(gpu):
    from randlapack_tpu.pdkernels import SquaredExpKernelLinOp
    X = jax.random.normal(jax.random.key(2), (8, 512), jnp.float32)
    V = jax.random.normal(jax.random.key(3), (512, 2), jnp.float32)
    op = SquaredExpKernelLinOp(X, 1.5, 0.1)
    assert "pallas_call" in str(jax.make_jaxpr(op.matmat)(V))


@pytest.mark.parametrize("dtype,res_tol", [(jnp.float32, 6.5e-6),
                                           (jnp.float64, 1e-13)])
def test_bqrrp_factored_on_card(gpu, dtype, res_tol):
    """Both dtypes take the LU pivot route on the card (cuSOLVER getrf)."""
    from randlapack_tpu.drivers import BQRRPConfig, bqrrp_factored, bqrrp_q
    from randlapack_tpu.gen import fast_decay_matrix
    A, st = fast_decay_matrix(1024, 1024, RNGState(0), dtype=dtype)
    fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=128,
                                           pivot_candidates=2), st)
    Q = bqrrp_q(fac)
    res = float(jnp.linalg.norm(jnp.matmul(Q, fac.R, precision=hp)
                                - jnp.take(A, fac.J, axis=1))
                / jnp.linalg.norm(A))
    assert res < res_tol and not bool(fac.fail), res


def test_svd_auto_route(gpu):
    from randlapack_tpu.ops.svd import _AUTO_SVD, resolve_svd_method, svd_econ
    assert resolve_svd_method("auto") == _AUTO_SVD["gpu"]
    B = jax.random.normal(jax.random.key(4), (256, 1024), jnp.float32)
    s_auto = svd_econ(B)[1]
    s_ref = np.linalg.svd(np.asarray(B, np.float64), compute_uv=False)
    np.testing.assert_allclose(np.asarray(s_auto), s_ref, rtol=1e-4)
