"""Per-driver runtime breakdowns — the reference's *_runtime_breakdown
programs (bench_CQRRPT/CQRRPT_runtime_breakdown.cc,
bench_BQRRP/{BQRRP,HQRRP}_runtime_breakdown.cc,
bench_ABRIK/ABRIK_runtime_breakdown.cc) driven through the drivers'
``timing=True`` phase dicts.

Usage: python benchmarks/runtime_breakdown.py [driver] [m] [n]
  driver ∈ {bqrrp, bqrrp_factored, hqrrp, cqrrpt, cqrrt, abrik, all}
Runs on the default backend; phases synchronize, so
totals exceed the fused-graph wall time — use the speed CLIs for
end-to-end numbers.
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax.numpy as jnp  # noqa: E402

from randlapack_tpu import RNGState  # noqa: E402
from randlapack_tpu.gen import fast_decay_matrix  # noqa: E402
from randlapack_tpu.drivers import (ABRIKConfig, BQRRPConfig,  # noqa: E402
                                    CQRRPTConfig, CQRRTConfig, HQRRPConfig,
                                    abrik, bqrrp, bqrrp_factored, cqrrpt,
                                    cqrrt, hqrrp)


AGGREGATES = {"total", "main_loop"}


def show(name, phases):
    leaf = {k: v for k, v in phases.items() if k not in AGGREGATES}
    total = sum(leaf.values())
    print(f"\n== {name} (synced phase totals: {total:.3f}s) ==")
    for k, v in sorted(leaf.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<16}{v:>9.4f}s {100*v/max(total,1e-12):>6.1f}%")
    for k in sorted(AGGREGATES & set(phases)):
        print(f"  ({k}: {phases[k]:.4f}s)")


def main():
    driver = sys.argv[1] if len(sys.argv) > 1 else "all"
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
    A, st = fast_decay_matrix(m, n, RNGState(0), dtype=jnp.float32)
    b = max(64, min(m, n) // 8)

    if driver in ("bqrrp", "all"):
        out = bqrrp(A, BQRRPConfig(block_size=b, stages=2), st,
                    timing=True)
        show("BQRRP (explicit)", out[6])
    if driver in ("bqrrp_factored", "all"):
        out = bqrrp_factored(A, BQRRPConfig(block_size=b, stages=2), st,
                             timing=True)
        show("BQRRP (factored)", out[2])
    if driver in ("hqrrp", "all"):
        out = hqrrp(A[:1024, :512], HQRRPConfig(block_size=64), st,
                    timing=True)
        show("HQRRP (1024x512)", out[6])
    if driver in ("cqrrpt", "all"):
        out = cqrrpt(A, CQRRPTConfig(qrcp=__import__(
            "randlapack_tpu.drivers", fromlist=["QRCPKind"]
        ).QRCPKind.bqrrp, bqrrp_block=b), st, timing=True)
        show("CQRRPT", out[6])
    if driver in ("cqrrt", "all"):
        out = cqrrt(A, CQRRTConfig(), st, timing=True)
        show("CQRRT", out[4])
    if driver in ("abrik", "all"):
        out = abrik(A, 64, ABRIKConfig(block_size=64, max_iters=4), st,
                    timing=True)
        show("ABRIK", out[5])


if __name__ == "__main__":
    main()
