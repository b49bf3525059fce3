"""On-card check of the randomized QR / SVD / KRR drivers on an NVIDIA GPU.

Usage:
    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the row-sharded phase only

One GPU, in order:
  1. the card's name and power limit (``nvidia-smi``); no card → exit 1;
  2. ``pytest -m gpu tests/`` in a child process, before this process
     touches the card, so only one process holds it at a time;
  3. the main path through the public drivers at the sizes the benchmark
     uses, f32 unless stated, every input made from a seed:
       bqrrp_factored 8192² (library defaults, then the bench config) and
       bqrrp_q; bqrrp_factored 4096² f64; pivot quality of bqrrp_factored
       2048² against host f64 LAPACK geqp3; cqrrpt 131072×2048;
       hqrrp_lapack_format 8192²; rsvd_fixed_rank 4096², k=256; abrik
       8192×4096, k=64; krill_full_rpchol n=8192, d=8, k=256; spls
       100000×2000 (LSQR);
  4. the fused kernel_matmat against its plain reference at n=8192, d=8,
     s ∈ {1, 64}, both in full f32.

Four GPUs (``--four-cards``): dist_cqrrpt on a 4-card row mesh at
131072×2048 f32 against one-card cqrrpt with the same Gaussian sketch on
the same matrix, both under the QR contract and with their R diagonals
agreeing (trailing-norm ratios within the pivot-quality gate); the
compiled program must hold an all-reduce and each card a m/4-row shard
of Q.

Every driver prints its cold time (compile included), one warm time
(``jax.block_until_ready``), the process's peak device memory so far
(``memory_stats()``) and its accuracy beside the stated tolerance. QR
tolerances are the reference's (BASELINE.md): residual ‖A[:,J] − QR‖/‖A‖
≤ ε^0.75 and ‖QᵀQ − I‖_F ≤ ε^0.75·√n, computed at Precision.HIGHEST.

Sizes cut, and why: none of the benchmark's sizes is cut. The f64 QR runs
at 4096² and the pivot-quality comparison at 2048² because their
yardsticks (f64 arithmetic, host LAPACK geqp3) cost minutes at 8192².

Exit status is 0 only if every phase ran and met its tolerance. The last
line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_description() -> str | None:
    """``name, power.limit`` of every card as nvidia-smi reports them, or
    None when there is no NVIDIA card to ask."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        return None
    return " | ".join(sorted(set(lines)))


def run_gpu_tests(card: str) -> bool:
    """``pytest -m gpu`` in a child process that has the card to itself."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
           "-p", "no:cacheprovider", os.path.join(ROOT, "tests")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    tail = (proc.stdout.strip().splitlines() or ["(no output)"])[-15:]
    for ln in tail:
        print(f"  pytest -m gpu | {ln}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    print(f"[{card}] gpu tests: rc={proc.returncode} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return proc.returncode == 0


class Smoke:
    """Runs phases, prints one line per result beside the card, and
    remembers every failure (a phase that raises or misses a tolerance)."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def line(self, name: str, **fields):
        body = ", ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[{self.card}] {name}: {body}", flush=True)

    def check(self, name: str, what: str, value: float, bound: float,
              above: bool = False):
        ok = value >= bound if above else value <= bound
        rel = ">=" if above else "<="
        self.line(name, check=what, value=value, bound=f"{rel} {bound}",
                  ok=ok)
        if not ok:
            self.failed.append(f"{name}: {what} {value} not {rel} {bound}")

    def phase(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:
            traceback.print_exc()
            self.failed.append(f"{name}: raised")
        print(f"[{self.card}] {name}: phase seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)


def timed(fn, *args):
    """(output, cold seconds incl. compile, warm seconds)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, cold, time.perf_counter() - t0


def peak_bytes() -> int:
    import jax
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1))


def qr_contract(sm: Smoke, name: str, Q, R, J, A):
    """The reference's residual and orthogonality tolerances, at the
    factors' ε, evaluated in f64 at Precision.HIGHEST: an f32 QᵀQ over
    131072 rows carries rounding of its own near n·ε_f32, which would
    otherwise be charged to the factorization."""
    import jax
    import jax.numpy as jnp
    hp = jax.lax.Precision.HIGHEST
    K = min(A.shape)
    eps = float(jnp.finfo(A.dtype).eps)
    Q, R, A = (x.astype(jnp.float64) for x in (Q, R, A))
    res = float(jnp.linalg.norm(jnp.matmul(Q, R, precision=hp)
                                - jnp.take(A, J, axis=1))
                / jnp.linalg.norm(A))
    orth = float(jnp.linalg.norm(jnp.matmul(Q.T, Q, precision=hp)
                                 - jnp.eye(K, dtype=Q.dtype)))
    del Q, R, A
    sm.check(name, "residual", res, eps ** 0.75)
    sm.check(name, "orthogonality", orth, eps ** 0.75 * math.sqrt(K))


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def phase_bqrrp(sm: Smoke, n: int, dtype_name: str, cfg_name: str):
    import jax.numpy as jnp
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import BQRRPConfig, bqrrp_factored, bqrrp_q
    from randlapack_tpu.gen import fast_decay_matrix
    dtype = jnp.dtype(dtype_name)
    cfg = (BQRRPConfig() if cfg_name == "defaults" else
           BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                       update_defer=4))
    name = f"bqrrp_factored {n}x{n} {dtype_name} {cfg_name}"
    A, st = fast_decay_matrix(n, n, RNGState(0), dtype=dtype)
    (fac, _), cold, warm = timed(lambda a, s: bqrrp_factored(a, cfg, s),
                                 A, st)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            fail_flag=bool(fac.fail), peak_bytes=peak_bytes())
    Q, q_cold, q_warm = timed(lambda f: bqrrp_q(f), fac)
    sm.line(f"bqrrp_q {n}x{n} {dtype_name}", cold_s=round(q_cold, 3),
            warm_s=round(q_warm, 4), peak_bytes=peak_bytes())
    qr_contract(sm, name, Q, fac.R, fac.J, A)


def phase_pivot_quality(sm: Smoke, n: int):
    import jax.numpy as jnp
    import numpy as np
    import scipy.linalg as sla
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu.gen import fast_decay_matrix
    from randlapack_tpu.testing import PIVOT_RATIO_GATE, pivot_norm_ratios
    name = f"pivot quality bqrrp_factored {n}x{n} f32 vs host dgeqp3"
    A, st = fast_decay_matrix(n, n, RNGState(3), dtype=jnp.float32)
    fac, _ = bqrrp_factored(A, BQRRPConfig(), st)
    R_qp3, _ = sla.qr(np.asarray(A, np.float64), mode="r", pivoting=True)
    ratios = pivot_norm_ratios(np.asarray(fac.R, np.float64), R_qp3)
    lo, hi = PIVOT_RATIO_GATE
    sm.check(name, "trailing-norm ratio min", float(ratios.min()), lo,
             above=True)
    sm.check(name, "trailing-norm ratio max", float(ratios.max()), hi)


def phase_cqrrpt(sm: Smoke, m: int, n: int):
    import jax.numpy as jnp
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import CQRRPTConfig, cqrrpt
    from randlapack_tpu.gen import fast_decay_matrix
    name = f"cqrrpt {m}x{n} f32 defaults"
    A, st = fast_decay_matrix(m, n, RNGState(2), dtype=jnp.float32,
                              decay=9.0)
    cfg = CQRRPTConfig()
    (Q, R, J, rank, fail, _), cold, warm = timed(
        lambda a, s: cqrrpt(a, cfg, s), A, st)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            rank=int(rank), fail_flag=bool(fail), peak_bytes=peak_bytes())
    qr_contract(sm, name, Q, R, J, A)


def phase_hqrrp(sm: Smoke, n: int):
    import jax
    import jax.numpy as jnp
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import HQRRPConfig, hqrrp_lapack_format
    from randlapack_tpu.gen import fast_decay_matrix
    name = f"hqrrp_lapack_format {n}x{n} f32 defaults"
    A, st = fast_decay_matrix(n, n, RNGState(7), dtype=jnp.float32)
    cfg = HQRRPConfig()
    (packed, taus, R, J, _), cold, warm = timed(
        lambda a, s: hqrrp_lapack_format(a, cfg, s), A, st)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            peak_bytes=peak_bytes())
    Q = jax.lax.linalg.householder_product(
        packed + jnp.eye(n, dtype=packed.dtype), taus)
    qr_contract(sm, name, Q, R, J, A)


def _gram_eigvals_f64(A):
    """σ(A)² descending, from the f64 Gram on the card and a host f64
    symmetric eigensolver — the yardstick spectrum."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    A64 = A.astype(jnp.float64)
    G = jnp.matmul(A64.T, A64, precision=jax.lax.Precision.HIGHEST)
    lam = np.linalg.eigvalsh(np.asarray(G))[::-1]
    return np.maximum(lam, 0.0)


def phase_rsvd(sm: Smoke, n: int, k: int, decay: float = 80.0):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from randlapack_tpu import RNGState
    from randlapack_tpu.comps import QBConfig
    from randlapack_tpu.comps.rf import RFConfig
    from randlapack_tpu.comps.rs import RSConfig
    from randlapack_tpu.drivers import RSVDConfig
    from randlapack_tpu.drivers.rsvd import rsvd_fixed_rank
    from randlapack_tpu.gen import fast_decay_matrix
    name = f"rsvd_fixed_rank {n}x{n} k={k} f32"
    A, st = fast_decay_matrix(n, n, RNGState(1), dtype=jnp.float32,
                              decay=decay)
    # two power iterations (4 passes over A): the QB error then sits at
    # the optimal tail instead of ~1.1x above it
    cfg = RSVDConfig(QBConfig(rf=RFConfig(rs=RSConfig(passes_over_data=4)),
                              block_size=64))
    (U, S, Vt, err, _), cold, warm = timed(
        lambda a, s: rsvd_fixed_rank(a, k, cfg, s), A, st)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            peak_bytes=peak_bytes())
    hp = jax.lax.Precision.HIGHEST
    e = float(jnp.linalg.norm(A - jnp.matmul(U * S[None, :], Vt,
                                             precision=hp))
              / jnp.linalg.norm(A))
    lam = _gram_eigvals_f64(A)
    opt = math.sqrt(float(np.sum(lam[k:]))) / math.sqrt(float(np.sum(lam)))
    sm.line(name, qb_rel_err=float(err), rel_err=e, optimal_tail=opt)
    sm.check(name, "error / optimal rank-k tail", e / opt, 1.1)


def phase_abrik(sm: Smoke, m: int, n: int, k: int, decay: float = 200.0):
    import jax.numpy as jnp
    import numpy as np
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import ABRIKConfig, abrik
    from randlapack_tpu.gen import fast_decay_matrix
    name = f"abrik {m}x{n} k={k} f32"
    # decay 200 at n=4096: σ_64/σ_1 ≈ 0.04, the leading values separated
    A, st = fast_decay_matrix(m, n, RNGState(5), dtype=jnp.float32,
                              decay=decay)
    cfg = ABRIKConfig(block_size=64, max_iters=4)
    (U, S, Vt, info, _), cold, warm = timed(
        lambda a, s: abrik(a, k, cfg, s), A, st)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            peak_bytes=peak_bytes())
    sv = np.sqrt(_gram_eigvals_f64(A)[:k])
    rel = np.abs(np.asarray(S[:k], np.float64) - sv) / sv
    # f32 Ritz values: ~eps·σ₁/σ_k ≈ 3e-6 rounding at σ_64; 30x margin
    sm.check(name, "max relative error of the leading values",
             float(rel.max()), 1e-4)


def phase_krill(sm: Smoke, n: int, d: int, k: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from randlapack_tpu import RNGState
    from randlapack_tpu.comps import PCGConfig
    from randlapack_tpu.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu.pdkernels import (SquaredExpKernelLinOp,
                                          standardize_dataset)
    name = f"krill_full_rpchol n={n} d={d} k={k} f32"
    X = standardize_dataset(jax.random.normal(jax.random.key(11), (d, n),
                                              dtype=jnp.float32))
    sub = np.asarray(X[:, :256], np.float64)
    d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
    bw = float(np.sqrt(np.median(d2[d2 > 0])))   # median heuristic
    G = SquaredExpKernelLinOp(X, bw, 1e-2)
    h = jax.random.normal(jax.random.key(12), (n, 1), dtype=jnp.float32)
    cfg = KrillConfig(k=k, rpchol_block=64,
                      pcg=PCGConfig(tol=1e-5, max_iters=100))
    (Xs, hist, iters, _), cold, warm = timed(
        lambda g, hh, s: krill_full_rpchol(g, hh, 1e-2, cfg, s),
        G, h, RNGState(6))
    hk = np.asarray(hist)[: int(iters) + 1, 0]
    sm.line(name, bandwidth=round(bw, 4), iters=int(iters),
            cold_s=round(cold, 3), warm_s=round(warm, 4),
            peak_bytes=peak_bytes())
    sm.check(name, "PCG iterations", int(iters), 99)
    sm.check(name, "final relative residual", float(hk[-1] / hk[0]), 1e-5)


def phase_spls(sm: Smoke, m: int, n: int):
    import jax
    import jax.numpy as jnp
    from randlapack_tpu import RNGState
    from randlapack_tpu.comps import PCGSaddleConfig
    from randlapack_tpu.drivers import SPLSConfig, spls
    from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
    name = f"spls {m}x{n} f32 lsqr"
    cond = 1e4
    A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=cond),
                   RNGState(12), dtype=jnp.float32)
    xt = jax.random.normal(jax.random.key(5), (n,), dtype=jnp.float32)
    b = jnp.matmul(A, xt, precision=jax.lax.Precision.HIGHEST)
    cfg = SPLSConfig(pcg=PCGSaddleConfig(tol=1e-6, max_iters=100))
    (x, hist, iters, _), cold, warm = timed(
        lambda a, bb, s: spls(a, bb, 0.0, cfg, s), A, b, RNGState(13))
    sm.line(name, iters=int(iters), cold_s=round(cold, 3),
            warm_s=round(warm, 4), peak_bytes=peak_bytes())
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    # the CPU test (f64, κ=1e4) holds x-error to 1e-6; in f32 the
    # attainable x-error is ~κ·ε = 1.2e-3, so the bound is 10·κ·ε
    sm.check(name, "x relative error", err,
             10 * cond * float(jnp.finfo(jnp.float32).eps))
    sm.check(name, "iterations", int(iters), 59)   # CPU test: < 60


def phase_kernel(sm: Smoke, n: int, d: int, s: int):
    import jax
    import jax.numpy as jnp
    from randlapack_tpu.ops.pallas_kernels import (kernel_matmat,
                                                   kernel_matmat_reference)
    name = f"kernel_matmat n={n} d={d} s={s} f32"
    X = jax.random.normal(jax.random.key(20), (d, n), dtype=jnp.float32)
    V = jax.random.normal(jax.random.key(21), (n, s), dtype=jnp.float32)
    bw = 2.5
    out, cold, warm = timed(lambda x, v: kernel_matmat(x, v, bw), X, V)
    ref, r_cold, r_warm = timed(
        jax.jit(lambda x, v: kernel_matmat_reference(
            x, v, bw, precision=jax.lax.Precision.HIGHEST)), X, V)
    sm.line(name, fused_cold_s=round(cold, 3), fused_warm_s=round(warm, 5),
            reference_warm_s=round(r_warm, 5), peak_bytes=peak_bytes())
    rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    sm.check(name, "relative Frobenius difference vs reference", rel, 1e-5)


def one_card(sm: Smoke):
    sm.phase("bqrrp 8192 defaults", phase_bqrrp, 8192, "float32",
             "defaults")
    sm.phase("bqrrp 8192 bench config", phase_bqrrp, 8192, "float32",
             "bench")
    sm.phase("bqrrp 4096 f64", phase_bqrrp, 4096, "float64", "defaults")
    sm.phase("pivot quality 2048", phase_pivot_quality, 2048)
    sm.phase("cqrrpt 131072x2048", phase_cqrrpt, 131072, 2048)
    sm.phase("hqrrp 8192", phase_hqrrp, 8192)
    sm.phase("rsvd 4096 k256", phase_rsvd, 4096, 256)
    sm.phase("abrik 8192x4096 k64", phase_abrik, 8192, 4096, 64)
    sm.phase("krill 8192", phase_krill, 8192, 8, 256)
    sm.phase("spls 100000x2000", phase_spls, 100000, 2000)
    for s in (1, 64):
        sm.phase(f"kernel_matmat s={s}", phase_kernel, 8192, 8, s)


# --------------------------------------------------------------------------
# four-card phase
# --------------------------------------------------------------------------

def phase_dist_cqrrpt(sm: Smoke, m: int, n: int, cards: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from randlapack_tpu import RNGState
    from randlapack_tpu.drivers import CQRRPTConfig, cqrrpt
    from randlapack_tpu.gen import fast_decay_matrix
    from randlapack_tpu.parallel import dist_cqrrpt, make_mesh, row_sharded
    name = f"dist_cqrrpt {m}x{n} f32 on {cards} cards"
    A, _ = fast_decay_matrix(m, n, RNGState(2), dtype=jnp.float32,
                             decay=9.0)
    mesh = make_mesh(cards)
    As = jax.device_put(A, row_sharded(mesh))
    hlo = jax.jit(lambda a: dist_cqrrpt(a, mesh, RNGState(21))[:5]
                  ).lower(As).compile().as_text()
    has_ar = "all-reduce" in hlo
    sm.line(name, all_reduce_in_hlo=has_ar)
    if not has_ar:
        sm.failed.append(f"{name}: no all-reduce in the compiled program")
    (Q, R, J, rank, fail, _), cold, warm = timed(
        lambda a: dist_cqrrpt(a, mesh, RNGState(21)), As)
    sm.line(name, cold_s=round(cold, 3), warm_s=round(warm, 4),
            rank=int(rank), fail_flag=bool(fail), peak_bytes=peak_bytes())
    shard_rows = sorted({sh.data.shape[0] for sh in Q.addressable_shards})
    sm.line(name, q_shard_rows=shard_rows, shards=len(Q.addressable_shards))
    if shard_rows != [m // cards] or len(Q.addressable_shards) != cards:
        sm.failed.append(f"{name}: Q shards {shard_rows}, want {m // cards}")
    qr_contract(sm, name, Q, R, J, As)
    # one card, the same Gaussian sketch: the same pivots and R
    one = f"cqrrpt {m}x{n} f32 gaussian sketch on one card"
    cfg = CQRRPTConfig(sketch="gaussian")
    (Q1, R1, J1, rank1, fail1, _), cold1, warm1 = timed(
        lambda a: cqrrpt(a, cfg, RNGState(21)), A)
    sm.line(one, cold_s=round(cold1, 3), warm_s=round(warm1, 4),
            rank=int(rank1), fail_flag=bool(fail1))
    qr_contract(sm, one, Q1, R1, J1, A)
    # pivots: the summation order of the psum legitimately decides near-
    # ties between candidate columns (a Gaussian-factor matrix has many),
    # so the two runs may part ways; the diagonals must still agree as a
    # rank-revealing profile — the repo's trailing-norm gate between them
    from randlapack_tpu.testing import PIVOT_RATIO_GATE, pivot_norm_ratios
    J_d, J_1 = np.asarray(J), np.asarray(J1)
    differ = np.nonzero(J_d != J_1)[0]
    sm.line(name, share_of_pivots_equal_to_one_card=float(
        np.mean(J_d == J_1)), first_differing_pivot=(
        int(differ[0]) if differ.size else None))
    ratios = pivot_norm_ratios(np.asarray(R, np.float64),
                               np.asarray(R1, np.float64)[:, :n])
    lo, hi = PIVOT_RATIO_GATE
    sm.check(name, "trailing-norm ratio vs one card, min",
             float(ratios.min()), lo, above=True)
    sm.check(name, "trailing-norm ratio vs one card, max",
             float(ratios.max()), hi)


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card row-sharded dist_cqrrpt phase")
    args = ap.parse_args(argv)

    card = card_description()
    if card is None:
        print("chip_smoke: no NVIDIA GPU (nvidia-smi found none)",
              file=sys.stderr)
        return 1
    print(card, flush=True)
    sm = Smoke(card)
    if not args.four_cards and not run_gpu_tests(card):
        sm.failed.append("pytest -m gpu")

    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from randlapack_tpu.utils import enable_compile_cache
    enable_compile_cache(ROOT)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform})", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.four_cards:
        sm.phase("dist_cqrrpt 4 cards", phase_dist_cqrrpt, 131072, 2048, 4)
    else:
        one_card(sm)
    print(f"[{card}] total seconds={time.perf_counter() - t0:.1f}",
          flush=True)
    if sm.failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(sm.failed),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
