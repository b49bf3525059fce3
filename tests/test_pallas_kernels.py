"""The fused squared-exp kernel matmat (ops/pallas_kernels.py): the Triton
kernel run through the Pallas interpreter on CPU, and the choice between
it and the plain blocked path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu.ops.pallas_kernels import (kernel_matmat,
                                               kernel_matmat_reference,
                                               use_fused_matmat)
from randlapack_tpu.pdkernels import SquaredExpKernelLinOp


class TestKernelMatmat:
    # s=1 takes the row reduction, s=20 pads to 32 columns; n=100, 200
    # and 300 are not tile multiples; d=3 and d=20 are not powers of two
    @pytest.mark.parametrize("d,n,s", [(8, 512, 128), (3, 100, 1),
                                       (8, 200, 20), (20, 256, 64),
                                       (8, 300, 1)])
    def test_matches_reference(self, d, n, s):
        X = jax.random.normal(jax.random.key(0), (d, n), jnp.float32)
        V = jax.random.normal(jax.random.key(1), (n, s), jnp.float32)
        out = kernel_matmat(X, V, 1.3, interpret=True)
        ref = kernel_matmat_reference(X, V, 1.3)
        assert out.shape == (n, s) and out.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-5, atol=1e-5)

    def test_bandwidth_traced(self):
        d, n, s = 8, 256, 128
        X = jax.random.normal(jax.random.key(2), (d, n), jnp.float32)
        V = jax.random.normal(jax.random.key(3), (n, s), jnp.float32)

        @jax.jit
        def f(bw):
            return kernel_matmat(X, V, bw, interpret=True)

        out = f(jnp.float32(0.7))
        ref = kernel_matmat_reference(X, V, 0.7)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-5, atol=1e-5)


class TestKernelChoice:
    @pytest.mark.parametrize("platform,d,dtype,fused", [
        ("gpu", 8, jnp.float32, True),
        ("gpu", 64, jnp.float32, True),
        ("cpu", 8, jnp.float32, False),     # never interpret mode on a run
        ("gpu", 8, jnp.float64, False),     # f64 takes the plain path
        ("gpu", 65, jnp.float32, False),    # wide points take it too
    ])
    def test_choice(self, platform, d, dtype, fused):
        assert use_fused_matmat(platform, d, dtype) is fused

    def test_linop_on_cpu_takes_plain_path(self):
        """On the CPU the linop's matmat is the blocked jnp path and
        agrees with the dense reference plus the regularization."""
        X = jax.random.normal(jax.random.key(4), (4, 300), jnp.float32)
        V = jax.random.normal(jax.random.key(5), (300, 3), jnp.float32)
        op = SquaredExpKernelLinOp(X, 1.1, 0.5, block=128)
        out = op.matmat(V)
        ref = kernel_matmat_reference(X, V, 1.1) + 0.5 * V
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
