"""HQRRP full-size wall-time measurement (reference: the HQRRP rows of
bench_general/{GEQP3,HQRRP}_* and rl_hqrrp.hh's role as CQRRPT's fallback
QRCP).

Same-process min-of-N.

Usage: python benchmarks/hqrrp_speed.py [n] [b] [reps] [defer] [tp]
    defer / tp accept comma lists ("1,2,4"); tp in {highest, high,
    default}: trailing-update GEMM precision (default = XLA's default,
    TF32 on a GPU).
"""
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from randlapack_tpu import RNGState
from randlapack_tpu.drivers import HQRRPConfig, hqrrp
from randlapack_tpu.gen import fast_decay_matrix


def run(n, b, reps, defer=1, tp="highest"):
    hp = jax.lax.Precision.HIGHEST
    A, st = fast_decay_matrix(n, n, RNGState(0), dtype=jnp.float32)
    nrmA = float(jnp.linalg.norm(A))
    cfg = HQRRPConfig(block_size=b, update_defer=defer,
                      trailing_precision=tp)
    t0 = time.perf_counter()
    Q, R, J, rank, fail, _ = jax.block_until_ready(hqrrp(A, cfg, st))
    t_c = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        Q, R, J, rank, fail, _ = jax.block_until_ready(hqrrp(A, cfg, st))
        best = min(best, time.perf_counter() - t0)
    res = float(jnp.linalg.norm(
        jnp.matmul(Q, R, precision=hp) - jnp.take(A, J, axis=1)) / nrmA)
    orth = float(jnp.linalg.norm(
        jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(n, dtype=jnp.float32)))
    # packed GEQP3-semantics form (no explicit Q) — the number comparable
    # to bqrrp_factored's headline
    from randlapack_tpu.drivers import hqrrp_lapack_format
    jax.block_until_ready(hqrrp_lapack_format(A, cfg, st))
    best_p = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(hqrrp_lapack_format(A, cfg, st))
        best_p = min(best_p, time.perf_counter() - t0)
    print(f"[{jax.devices()[0].device_kind}] hqrrp n={n} b={b} d{defer} "
          f"tp={tp}: {best:8.3f}s  "
          f"{4/3*n**3/best/1e9:6.0f} GF/s  res {res:.2e}  orth {orth:.2e}  "
          f"fail={bool(fail)}  packed {best_p:.3f}s "
          f"({4/3*n**3/best_p/1e9:.0f} GF/s)  (compile {t_c:.0f}s)",
          flush=True)
    return best


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    b = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    # defer / tp accept comma lists ("1,2,4") — the grid runs in ONE
    # process so the min-of-N numbers are same-process comparable
    defers = [int(d) for d in (sys.argv[4] if len(sys.argv) > 4
                               else "1").split(",")]
    tps = (sys.argv[5] if len(sys.argv) > 5 else "highest").split(",")
    for tp in tps:
        for defer in defers:
            run(n, b, reps, defer, tp)


if __name__ == "__main__":
    main()
