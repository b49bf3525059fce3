"""jax_debug_nans smoke lane (the accelerator analogue of the reference's Debug+ASan CI lane, docs/CI.md:9-23).

Drives every driver family on small HEALTHY inputs with
``jax_debug_nans`` enabled: any unintended NaN produced along the
healthy path raises immediately with a traceback. The failure-detection
machinery itself (Cholesky-NaN probes inside lax.cond rescues) never
executes on healthy inputs, so a clean run means the production graphs
are NaN-free end to end.

Usage: python tools/debug_nans_smoke.py   (exit 0 iff clean)
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_debug_nans", True)

import jax.numpy as jnp

from randlapack_tpu import RNGState
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen


def main():
    A, st = mat_gen(MatGenInfo(300, 200, MatType.exponential,
                               cond_num=1e4), RNGState(0))

    from randlapack_tpu.comps import QBConfig
    from randlapack_tpu.drivers import RSVDConfig
    from randlapack_tpu.drivers.rsvd import rsvd_fixed_rank
    U, S, Vt, err, _ = rsvd_fixed_rank(
        A, 32, RSVDConfig(QBConfig(block_size=16)), RNGState(1))
    print("rsvd ok", float(err))

    from randlapack_tpu.drivers import (ABRIKConfig, BQRRPConfig,
                                        CQRRPTConfig, CQRRTConfig,
                                        HQRRPConfig, abrik, bqrrp,
                                        bqrrp_factored, cqrrpt, cqrrt,
                                        hqrrp)
    Q, R, J, rank, fail, _ = bqrrp(A, BQRRPConfig(block_size=50),
                                   RNGState(2))
    assert not bool(fail)
    print("bqrrp ok")
    fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=50), RNGState(3))
    assert not bool(fac.fail)
    print("bqrrp_factored ok")
    Q, R, J, rank, fail, _ = cqrrpt(A, CQRRPTConfig(), RNGState(4))
    assert not bool(fail)
    print("cqrrpt ok")
    Q, R, fail, _ = cqrrt(A, CQRRTConfig(), RNGState(5))
    assert not bool(fail)
    print("cqrrt ok")
    Q, R, J, rank, fail, _ = hqrrp(A, HQRRPConfig(block_size=50),
                                   RNGState(6))
    assert not bool(fail)
    print("hqrrp ok")
    U, S, Vt, info, _ = abrik(A, 16, ABRIKConfig(block_size=8,
                                                 max_iters=6), RNGState(7))
    print("abrik ok")

    from randlapack_tpu.drivers import REVD2Config, revd2_fixed_rank
    G = jnp.matmul(A.T, A, precision=jax.lax.Precision.HIGHEST)
    V, lam, err_est, nu, fail, _ = revd2_fixed_rank(
        G, 16, REVD2Config(), RNGState(8))
    assert not bool(fail)
    print("revd2 ok")

    from randlapack_tpu.comps.rpchol import RPCholConfig, rp_cholesky
    from randlapack_tpu.linops import ExplicitSymLinOp
    F, piv, _ = rp_cholesky(ExplicitSymLinOp(G), 32,
                            RPCholConfig(block_size=8), RNGState(9))
    print("rp_cholesky ok")

    print("debug-nans smoke: ALL CLEAN")


if __name__ == "__main__":
    main()
