"""Measures, on one GPU, the choices this repository makes by measurement:

  svd     compile and warm run time of ``svd_econ`` by route ("xla", i.e.
          cuSOLVER, against "gram_eigh") at the factor shapes the drivers
          use — decides ``ops.svd._AUTO_SVD["gpu"]``;
  kernel  the fused squared-exp ``kernel_matmat`` (Triton) over a few
          tilings against the plain blocked matmat and the dense
          reference at n=8192, d=8, s ∈ {1, 64};
  krill   ``krill_full_rpchol`` at n=8192 with the fused kernel against
          the plain matmat, in turns (fused, plain, plain, fused) — the
          end-to-end test the kernel has to pass to stay;
  trace   a ``jax.profiler`` trace of one warm 8192² ``bqrrp_factored``
          (library defaults), reduced to device kernel time by primitive
          and the share taken by the ``getrfnp`` named scope.

Usage: python benchmarks/gpu_routes.py [--trace-dir DIR] [parts ...]
(parts default to all four). Every line names the card and its power
limit. Needs a GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import functools
import glob
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from randlapack_tpu.utils import enable_compile_cache  # noqa: E402

CARD = "?"


def say(part, **kw):
    body = ", ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{CARD}] {part}: {body}", flush=True)


def warm_time(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def part_svd():
    from randlapack_tpu.ops.svd import svd_econ
    # RSVD's B (k=256 of 4096), ABRIK/QB-sized small factors, SPLS's
    # d×n sketch (d = 4n at n = 2000)
    for shape in [(256, 4096), (64, 4096), (512, 512), (8000, 2000)]:
        B = jax.random.normal(jax.random.key(0), shape, jnp.float32)
        for method in ("xla", "gram_eigh"):
            f = jax.jit(functools.partial(svd_econ, method=method))
            t0 = time.perf_counter()
            f.lower(B).compile()
            comp = time.perf_counter() - t0
            run = warm_time(f, B)
            say("svd", shape=shape, method=method, compile_s=round(comp, 3),
                warm_s=round(run, 6))


def _krr_data(n, d=8):
    from randlapack_tpu.pdkernels import standardize_dataset
    X = standardize_dataset(jax.random.normal(jax.random.key(11), (d, n),
                                              dtype=jnp.float32))
    sub = np.asarray(X[:, :256], np.float64)
    d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
    return X, float(np.sqrt(np.median(d2[d2 > 0])))


def part_kernel():
    from randlapack_tpu.ops import pallas_kernels as pk
    from randlapack_tpu.pdkernels import SquaredExpKernelLinOp
    n = 8192
    X, bw = _krr_data(n)
    best = {}
    for s in (1, 64):
        V = jax.random.normal(jax.random.key(1), (n, s), jnp.float32)
        ref = jax.jit(lambda x, v: pk.kernel_matmat_reference(
            x, v, bw, precision=jax.lax.Precision.HIGHEST))
        say("kernel", s=s, route="dense reference",
            warm_s=round(warm_time(ref, X, V), 6))
        orig = pk.use_fused_matmat
        pk.use_fused_matmat = lambda *a: False
        jax.clear_caches()
        plain = jax.jit(lambda x, v: SquaredExpKernelLinOp(
            x, bw, 1e-2).matmat(v))
        say("kernel", s=s, route="plain blocked matmat",
            warm_s=round(warm_time(plain, X, V), 6))
        pk.use_fused_matmat = orig
        r = ref(X, V)
        for tm, tn, sp, nw in [(32, 64, 1, 4), (32, 64, 4, 4),
                               (32, 64, 8, 4), (32, 64, 16, 4),
                               (16, 64, 8, 4), (64, 64, 8, 4),
                               (32, 128, 8, 4), (32, 32, 8, 2)]:
            f = jax.jit(functools.partial(pk.kernel_matmat, bandwidth=bw,
                                          block_rows=tm, block_cols=tn,
                                          col_splits=sp, num_warps=nw))
            t = warm_time(lambda x, v: f(x, v), X, V, reps=10)
            rel = float(jnp.linalg.norm(f(X, V) - r) / jnp.linalg.norm(r))
            say("kernel", s=s, route="fused", block_rows=tm, block_cols=tn,
                col_splits=sp, num_warps=nw, warm_s=round(t, 6),
                rel_err=rel)
            best.setdefault(s, (t, tm, tn, sp, nw))
            best[s] = min(best[s], (t, tm, tn, sp, nw))
    say("kernel", best_by_s=best)


def part_krill():
    from randlapack_tpu import RNGState
    from randlapack_tpu.comps import PCGConfig
    from randlapack_tpu.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu.ops import pallas_kernels as pk
    from randlapack_tpu.pdkernels import SquaredExpKernelLinOp
    n = 8192
    X, bw = _krr_data(n)
    G = SquaredExpKernelLinOp(X, bw, 1e-2)
    h = jax.random.normal(jax.random.key(12), (n, 1), dtype=jnp.float32)
    cfg = KrillConfig(k=256, rpchol_block=64,
                      pcg=PCGConfig(tol=1e-5, max_iters=100))
    orig = pk.use_fused_matmat
    for route in ("fused", "plain", "plain", "fused"):
        pk.use_fused_matmat = orig if route == "fused" else (
            lambda *a: False)
        jax.clear_caches()

        def run(g, hh, s):
            return krill_full_rpchol(g, hh, 1e-2, cfg, s)

        t0 = time.perf_counter()
        out = jax.block_until_ready(run(G, h, RNGState(6)))
        cold = time.perf_counter() - t0
        warm = warm_time(run, G, h, RNGState(6), reps=3)
        say("krill", n=n, route=route, iters=int(out[2]),
            cold_s=round(cold, 3), warm_s=round(warm, 5))
    pk.use_fused_matmat = orig


_HLO_META = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def reduce_trace(trace_dir, hlo_text):
    """Device kernel time by primitive and by the getrfnp scope, from the
    newest .xplane.pb under ``trace_dir``; the op_name of each kernel comes
    from the compiled module's metadata."""
    op_name = {}
    for ln in hlo_text.splitlines():
        m = _HLO_META.match(ln)
        if m:
            op_name[m.group(1)] = m.group(2)
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    by_prim = collections.Counter()
    total = scoped = 0.0
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        say("trace", plane=plane.name,
            lines=[(ln.name, len(list(ln.events))) for ln in plane.lines])
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                st = dict(ev.stats) if ev.stats else {}
                hop = str(st.get("hlo_op", ""))
                name = op_name.get(hop, "")
                dur = ev.duration_ns
                total += dur
                spans.append((ev.start_ns, ev.start_ns + dur))
                prim = name.rsplit("/", 1)[-1] if name else (
                    hop or ev.name)[:40]
                by_prim[prim] += dur
                if "getrfnp" in name:
                    scoped += dur
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return total, scoped, busy, window, by_prim


def part_trace(trace_dir):
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu.gen import fast_decay_matrix
    from randlapack_tpu.ops.householder import getrfnp
    n = 8192
    A, st = fast_decay_matrix(n, n, RNGState(0), dtype=jnp.float32)
    for label, cfg in [("defaults", BQRRPConfig()),
                       ("bench", BQRRPConfig(block_size=256,
                                             pivot_candidates=2, stages=2,
                                             update_defer=4))]:
        f = jax.jit(lambda a, s: bqrrp_factored(a, cfg, s)[0])
        hlo = f.lower(A, st).compile().as_text()
        warm = warm_time(f, A, st, reps=3)
        d = os.path.join(trace_dir, label)
        with jax.profiler.trace(d):
            jax.block_until_ready(f(A, st))
        total, scoped, busy, window, by_prim = reduce_trace(d, hlo)
        say("trace", config=label, warm_s=round(warm, 5),
            kernel_ms=round(total / 1e6, 3),
            getrfnp_ms=round(scoped / 1e6, 3),
            getrfnp_share=round(scoped / max(total, 1.0), 4),
            busy_ms=round(busy / 1e6, 3), window_ms=round(window / 1e6, 3),
            idle_share=round(1.0 - busy / max(window, 1.0), 4))
        for prim, ns in by_prim.most_common(12):
            say("trace", config=label, primitive=prim,
                ms=round(ns / 1e6, 3), share=round(ns / max(total, 1.0), 4))
        # cross-check: one getrfnp on a b×b orthonormal block, alone
        b = cfg.block_size
        Q1 = jnp.linalg.qr(jax.random.normal(jax.random.key(3), (b, b),
                                             jnp.float32))[0]
        g = jax.jit(getrfnp)
        t1 = warm_time(g, Q1, reps=10)
        say("trace", config=label, getrfnp_alone_s=round(t1, 6),
            calls=n // b, times_calls_over_warm=round(t1 * (n // b) / warm,
                                                      4))


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parts", nargs="*",
                    default=["svd", "kernel", "krill", "trace"])
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "traces"))
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("gpu_routes: needs a GPU", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    CARD = out.stdout.strip().splitlines()[0]
    enable_compile_cache(ROOT)
    for part in args.parts:
        t0 = time.perf_counter()
        if part == "trace":
            part_trace(args.trace_dir)
        else:
            globals()[f"part_{part}"]()
        say(part, part_seconds=round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
