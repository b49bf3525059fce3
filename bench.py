"""Benchmark suite — runs the BASELINE.md configs on the GPU and prints
ONE JSON line with the headline metric.

Headline: BQRRP blocked randomized pivoted QR on 8192×8192 (f32) in its
factored (implicit-Q, GEQP3-semantics) form — the reference's own output
contract — reported as effective GFLOP/s at the Householder-QR flop count
(4/3·n³), with ``vs_baseline`` the speedup over host LAPACK sgeqp3
(measured at 2048² on this host and scaled cubically). Explicit-Q
materialization is timed separately.

The headline config runs first; every other config runs after it, and a
config that raises is reported and makes the exit status non-zero without
stopping the others. Details for every config go to BENCH_details.json;
progress to stderr. Without a GPU the script exits non-zero.
"""
import dataclasses
import json
import os
import sys
import time
import traceback

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FAILED = []


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def failed(what):
    """Record a config that raised: it is reported, the rest still run,
    and the exit status becomes non-zero."""
    traceback.print_exc()
    FAILED.append(what)
    log(f"[bench] {what} FAILED")


def timed(fn, *args, reps=3):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def main():
    if jax.devices()[0].platform != "gpu":
        log(f"[bench] needs a GPU; JAX found {jax.devices()[0].platform}")
        return 1
    from randlapack_tpu.utils import enable_compile_cache
    enable_compile_cache(ROOT)
    from randlapack_tpu import RNGState
    from randlapack_tpu.gen import fast_decay_matrix
    from randlapack_tpu.comps import QBConfig, PCGSaddleConfig
    from randlapack_tpu.drivers import (BQRRPConfig, CQRRPTConfig, QRCPKind,
                                        RSVDConfig, SPLSConfig, bqrrp,
                                        cqrrpt, spls)
    from randlapack_tpu.drivers.rsvd import rsvd_fixed_rank

    dtype = jnp.float32
    dev = jax.devices()[0]
    details = {"device": {"platform": dev.platform,
                          "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "dtype": "float32"}
    results = {}
    hp = jax.lax.Precision.HIGHEST

    # ---- config 4 (headline): BQRRP 8192x8192 --------------------------
    # Headline times the FACTORED form (implicit block-WY Q) — the
    # reference BQRRP's own output semantics (rl_bqrrp.hh returns
    # reflectors+tau+J, GEQP3-compatible, and does not form Q), measured
    # at the geqp3 flop count and compared against raw LAPACK sgeqp3.
    # Explicit-Q materialization is timed separately in the details.
    from randlapack_tpu.drivers import bqrrp_factored, bqrrp_q
    n = 8192
    log(f"[bench] BQRRP {n}x{n} (factored / GEQP3-semantics) ...")
    A, st = fast_decay_matrix(n, n, RNGState(0), dtype=dtype)
    # the bench config carried over from the earlier benchmark; it is not
    # the library default and has not been re-tuned on this card (ROADMAP
    # S4, D6)
    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    (fac, _), t = timed(lambda a, s: bqrrp_factored(a, cfg, s), A, st,
                        reps=8)
    qr_flops = 4.0 / 3.0 * n ** 3
    gflops = qr_flops / t / 1e9
    Q = jax.block_until_ready(bqrrp_q(fac))
    t0q = time.perf_counter()
    Q = jax.block_until_ready(bqrrp_q(fac))
    t_q = time.perf_counter() - t0q
    res = float(jnp.linalg.norm(
        jnp.matmul(Q, fac.R, precision=hp) - jnp.take(A, fac.J, axis=1))
        / jnp.linalg.norm(A))
    orth = float(jnp.linalg.norm(
        jnp.matmul(Q.T, Q, precision=hp) - jnp.eye(n, dtype=dtype)))
    results["bqrrp_8192"] = {"seconds": t, "gflops": gflops,
                             "residual": res, "orth": orth,
                             "fail": bool(fac.fail),
                             "materialize_q_seconds": t_q,
                             # provenance: the recorded number names
                             # the config that produced it
                             "config": {"block_size": cfg.block_size,
                                        "pivot_candidates":
                                            cfg.pivot_candidates,
                                        "stages": cfg.stages,
                                        "update_defer": cfg.update_defer,
                                        "trailing_precision":
                                            cfg.trailing_precision}}
    log(f"[bench] BQRRP {n}: {t:.3f}s = {gflops:.0f} GFLOP/s "
        f"(+{t_q:.3f}s explicit Q), res {res:.2e}, orth {orth:.2e}")

    del Q, fac

    # LAPACK geqp3 baseline + headline JSON line FIRST
    vs_baseline = None
    try:
        import numpy as np
        from scipy.linalg import lapack as slapack
        nb = 2048
        An = np.random.default_rng(0).standard_normal((nb, nb)).astype(
            np.float32)
        t0 = time.perf_counter()
        slapack.sgeqp3(An)  # raw geqp3: implicit Q, same semantics as ours
        t_lapack_small = time.perf_counter() - t0
        t_lapack_8192 = t_lapack_small * (8192 / nb) ** 3
        details["lapack_geqp3_2048_s"] = t_lapack_small
        details["lapack_geqp3_8192_extrapolated_s"] = t_lapack_8192
        vs_baseline = t_lapack_8192 / results["bqrrp_8192"]["seconds"]
        log(f"[bench] LAPACK sgeqp3 2048: {t_lapack_small:.2f}s -> 8192 "
            f"extrapolated {t_lapack_8192:.1f}s -> speedup "
            f"{vs_baseline:.1f}x")
    except Exception:  # pragma: no cover
        failed("LAPACK baseline")

    print(json.dumps({
        "metric": "bqrrp_8192_f32_gflops",
        "value": round(results["bqrrp_8192"]["gflops"], 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
    }), flush=True)

    # speed mode: trailing A-update GEMMs at Precision.HIGH (panel/R/T
    # math stays HIGHEST); on a GPU HIGH is TF32
    try:
        cfg_sp = BQRRPConfig(block_size=256, pivot_candidates=2,
                             stages=2, update_defer=4,
                             trailing_precision="high")
        (fac_sp, _), t_sp = timed(
            lambda a, s: bqrrp_factored(a, cfg_sp, s), A, st, reps=6)
        Qs = bqrrp_q(fac_sp)
        res_sp = float(jnp.linalg.norm(
            jnp.matmul(Qs, fac_sp.R, precision=hp)
            - jnp.take(A, fac_sp.J, axis=1)) / jnp.linalg.norm(A))
        results["bqrrp_8192_speed_mode"] = {
            "seconds": t_sp, "gflops": qr_flops / t_sp / 1e9,
            "residual": res_sp, "trailing_precision": "high",
            "block_size": 256, "pivot_candidates": 2,
            "update_defer": 4}
        log(f"[bench] BQRRP {n} speed mode (trailing=high): "
            f"{t_sp:.3f}s = {qr_flops / t_sp / 1e9:.0f} GFLOP/s, "
            f"res {res_sp:.2e}")
        del Qs, fac_sp
    except Exception:  # pragma: no cover
        failed("BQRRP speed mode")
    del A

    # ---- config 1: RSVD 4096x4096 rank 256 -----------------------------
    try:
        log("[bench] RSVD 4096 rank 256 ...")
        # decay chosen so the optimal rank-256 tail is ~1e-2: the QB error
        # should land within ~1.1x of it
        A, st = fast_decay_matrix(4096, 4096, RNGState(1), dtype=dtype,
                                  decay=80.0)
        rcfg = RSVDConfig(QBConfig(block_size=64))
        (U, S, Vt, err, _), t_rsvd = timed(
            lambda a, s: rsvd_fixed_rank(a, 256, rcfg, s), A, st)
        results["rsvd_4096_k256"] = {"seconds": t_rsvd,
                                     "qb_rel_err": float(err)}
        log(f"[bench] RSVD: {t_rsvd:.3f}s, QB rel err {float(err):.3e}")
        del A, U, S, Vt
    except Exception:  # pragma: no cover
        failed("RSVD")

    # ---- config 3: CQRRPT 131072x2048 ----------------------------------
    try:
        log("[bench] CQRRPT 131072x2048 ...")
        m, nc = 131072, 2048
        A, st = fast_decay_matrix(m, nc, RNGState(2), dtype=dtype, decay=9.0)
        # the bench config carried over from the earlier benchmark
        # (trsm_mode="blockinv" is opt-in; the library default stays the
        # backward-stable XLA solve) — not re-tuned on this card (S5)
        ccfg = CQRRPTConfig(sketch="srht", qrcp=QRCPKind.bqrrp,
                            bqrrp_block=256, bqrrp_pivot_candidates=2,
                            trsm_mode="blockinv")
        (Qc, Rc, Jc, rkc, failc, _), t_cq = timed(
            lambda a, s: cqrrpt(a, ccfg, s), A, st)
        cq_flops = 2.0 * m * nc ** 2
        results["cqrrpt_131072x2048"] = {
            "seconds": t_cq, "gflops": cq_flops / t_cq / 1e9,
            "rank": int(rkc), "fail": bool(failc),
            "config": {"sketch": ccfg.sketch, "qrcp": ccfg.qrcp.value,
                       "bqrrp_block": ccfg.bqrrp_block,
                       "bqrrp_pivot_candidates":
                           ccfg.bqrrp_pivot_candidates,
                       "q_form": ccfg.q_form,
                       "gram_block": ccfg.gram_block,
                       "trsm_mode": ccfg.trsm_mode,
                       "trsm_block": ccfg.trsm_block}}
        log(f"[bench] CQRRPT: {t_cq:.3f}s = {cq_flops/t_cq/1e9:.0f} GFLOP/s")
        # phase attribution (the reference's CQRRPT_runtime_breakdown.cc):
        # one synchronized run — phase sums exceed the fused wall time
        cqrrpt(A, ccfg, st, timing=True)  # warm: compile + caches
        out_t = cqrrpt(A, ccfg, st, timing=True)
        results["cqrrpt_131072x2048"]["phase_breakdown_s"] = {
            k2: round(v2, 4) for k2, v2 in out_t[-1].items()}
        log(f"[bench] CQRRPT phases: {out_t[-1]}")
        del A, Qc, Rc
    except Exception:  # pragma: no cover
        failed("CQRRPT")

    # ---- config 6: HQRRP 8192x8192 --------------------------------------
    # The randomized-pivoting Householder driver (CQRRPT's fallback QRCP).
    try:
        log("[bench] HQRRP 8192x8192 ...")
        from randlapack_tpu.drivers import HQRRPConfig, hqrrp_lapack_format
        A, st = fast_decay_matrix(8192, 8192, RNGState(7), dtype=dtype)
        hcfg = HQRRPConfig(block_size=128, update_defer=4)
        # time the packed GEQP3-semantics form (the reference's native
        # output, rl_hqrrp.hh:778 — same semantics as the BQRRP
        # headline); explicit Q is timed separately like bqrrp_q
        (packed_h, taus_h, Rh, Jh, _), t_hq = timed(
            lambda a, s: hqrrp_lapack_format(a, hcfg, s), A, st, reps=2)
        mk_q = jax.jit(lambda p, t: jax.lax.linalg.householder_product(
            p + jnp.eye(8192, dtype=dtype), t))
        jax.block_until_ready(mk_q(packed_h, taus_h))  # warm the compile
        t0q = time.perf_counter()
        Qh = jax.block_until_ready(mk_q(packed_h, taus_h))
        t_hq_q = time.perf_counter() - t0q
        res_h = float(jnp.linalg.norm(
            jnp.matmul(Qh, Rh, precision=hp) - jnp.take(A, Jh, axis=1))
            / jnp.linalg.norm(A))
        orth_h = float(jnp.linalg.norm(
            jnp.matmul(Qh.T, Qh, precision=hp)
            - jnp.eye(8192, dtype=dtype)))
        results["hqrrp_8192"] = {
            "seconds": t_hq,
            "gflops": (4.0 / 3.0 * 8192 ** 3) / t_hq / 1e9,
            "residual": res_h, "orth": orth_h,
            "materialize_q_seconds": t_hq_q,
            "vs_bqrrp_factored": t_hq / results["bqrrp_8192"]["seconds"]}
        log(f"[bench] HQRRP: {t_hq:.3f}s = "
            f"{4/3*8192**3/t_hq/1e9:.0f} GFLOP/s (+{t_hq_q:.3f}s Q), "
            f"res {res_h:.2e}, orth {orth_h:.2e} "
            f"({t_hq/results['bqrrp_8192']['seconds']:.2f}x BQRRP)")
        # speed mode: trailing GEMMs at Precision.HIGH (TF32 on a GPU)
        try:
            hcfg_sp = HQRRPConfig(block_size=128, update_defer=4,
                                  trailing_precision="high")
            (ph_s, ta_s, Rh_s, Jh_s, _), t_hq_sp = timed(
                lambda a, s: hqrrp_lapack_format(a, hcfg_sp, s), A, st,
                reps=2)
            results["hqrrp_8192_speed_mode"] = {
                "seconds": t_hq_sp,
                "gflops": (4.0 / 3.0 * 8192 ** 3) / t_hq_sp / 1e9,
                "trailing_precision": "high", "update_defer": 4}
            log(f"[bench] HQRRP speed mode (trailing=high): "
                f"{t_hq_sp:.3f}s = "
                f"{4/3*8192**3/t_hq_sp/1e9:.0f} GFLOP/s")
            del ph_s, Rh_s
        except Exception:
            failed("HQRRP speed mode")
        del A, Qh, Rh, packed_h
    except Exception:  # pragma: no cover
        failed("HQRRP")

    # ---- config 5: ABRIK block-Krylov SVD + KRILL KRR -------------------
    try:
        log("[bench] ABRIK 8192x4096 k=64 ...")
        from randlapack_tpu.drivers import ABRIKConfig, abrik
        A, st = fast_decay_matrix(8192, 4096, RNGState(5), dtype=dtype,
                                  decay=12.0)
        acfg = ABRIKConfig(block_size=64, max_iters=4)
        (U, S, Vt, info, _), t_ab = timed(
            lambda a, s: abrik(a, 64, acfg, s), A, st, reps=2)
        r0 = float(jnp.linalg.norm(
            jnp.matmul(A, Vt[0], precision=hp) - S[0] * U[:, 0]))
        results["abrik_8192x4096_k64"] = {"seconds": t_ab,
                                          "triplet0_resid": r0}
        log(f"[bench] ABRIK: {t_ab:.3f}s, triplet-0 resid {r0:.2e}")
        # ABRIK-vs-RSVD at matched rank — the reference ships
        # ABRIK_speed_comparisons.cc precisely to COMPARE the Krylov
        # driver against RSVD; record both sides on the same matrix so
        # the artifact carries the comparison, not a lone point.
        try:
            S_ab = S
            rcfg_cmp = RSVDConfig(QBConfig(block_size=64))
            (Ur, Sr, Vtr, err_r, _), t_rv = timed(
                lambda a, s: rsvd_fixed_rank(a, 64, rcfg_cmp, s), A, st,
                reps=2)
            rr0 = float(jnp.linalg.norm(
                jnp.matmul(A, Vtr[0], precision=hp) - Sr[0] * Ur[:, 0]))
            results["abrik_vs_rsvd_8192x4096_k64"] = {
                "abrik_seconds": t_ab, "rsvd_seconds": t_rv,
                "abrik_triplet0_resid": r0, "rsvd_triplet0_resid": rr0,
                "sv_rel_gap_max": float(jnp.max(
                    jnp.abs(S_ab[:64] - Sr[:64])
                    / jnp.maximum(Sr[:64], 1e-30)))}
            log(f"[bench] ABRIK vs RSVD k=64: {t_ab:.3f}s vs {t_rv:.3f}s, "
                f"triplet-0 resid {r0:.2e} vs {rr0:.2e}")
            del Ur, Sr, Vtr
        except Exception:
            failed("ABRIK vs RSVD")
        del A, U, S, Vt

        log("[bench] KRILL n=8192 ...")
        from randlapack_tpu.drivers import KrillConfig, krill_full_rpchol
        from randlapack_tpu.comps import PCGConfig
        from randlapack_tpu.pdkernels import (SquaredExpKernelLinOp,
                                              standardize_dataset)
        import numpy as np
        X = standardize_dataset(jax.random.normal(jax.random.key(11),
                                                  (8, 8192), dtype=dtype))
        # bandwidth = median pairwise distance (the RBF median heuristic):
        # bw=1.0 on 8-dim standardized data makes K near-diagonal and the
        # rank-k preconditioner useless
        sub = np.asarray(X[:, :256])
        d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
        bw = float(np.sqrt(np.median(d2[d2 > 0])))
        G = SquaredExpKernelLinOp(X, bw, 1e-2, block=2048)
        h = jax.random.normal(jax.random.key(12), (8192, 1), dtype=dtype)
        kcfg = KrillConfig(k=256, rpchol_block=64,
                           pcg=PCGConfig(tol=1e-5, max_iters=100))
        (Xs, histk, itk, _), t_kr = timed(
            lambda gg, hh, s: krill_full_rpchol(gg, hh, 1e-2, kcfg, s),
            G, h, RNGState(6), reps=1)
        hk = jnp.asarray(histk)[: int(itk) + 1, 0]
        final_rel = float(hk[-1] / hk[0])
        results["krill_8192"] = {"seconds": t_kr, "iters": int(itk),
                                 "bandwidth_median_heuristic": bw,
                                 "final_rel_resid": final_rel,
                                 "converged": bool(int(itk) < 100)}
        log(f"[bench] KRILL: {t_kr:.3f}s, {int(itk)} CG iters, "
            f"final rel resid {final_rel:.2e} (bw={bw:.2f})")
        # latency split: a max_iters=1 run isolates setup (the rpchol
        # build) from the per-iteration kernel-matvec cost
        try:
            kcfg1 = dataclasses.replace(
                kcfg, pcg=dataclasses.replace(kcfg.pcg, max_iters=1))
            (_, _, it1, _), t_k1 = timed(
                lambda g, hh, s: krill_full_rpchol(g, hh, 1e-2, kcfg1, s),
                G, h, RNGState(6), reps=2)
            per_iter = max(t_kr - t_k1, 0.0) / max(int(itk) - 1, 1)
            results["krill_8192"]["latency_split"] = {
                "setup_seconds": t_k1,
                "per_cg_iteration_seconds": per_iter}
            log(f"[bench] KRILL split: setup {t_k1*1e3:.1f} ms, "
                f"per-iter {per_iter*1e3:.2f} ms x {int(itk)} iters")
        except Exception:
            failed("KRILL latency split")
    except Exception:  # pragma: no cover
        failed("ABRIK/KRILL")

    # ---- config 2: sketch-precondition least squares -------------------
    try:
        log("[bench] SPLS 100000x2000 ...")
        m2, n2 = 100000, 2000
        A, st = fast_decay_matrix(m2, n2, RNGState(3), dtype=dtype,
                                  decay=7.0)
        xt = jax.random.normal(jax.random.key(9), (n2,), dtype=dtype)
        b = jnp.matmul(A, xt, precision=hp)
        # default solver is "auto" -> LSQR for this single-rhs b:
        # x-accuracy attainable at ~kappa*eps instead of the normal-
        # equations kappa^2*eps floor
        scfg = SPLSConfig(pcg=PCGSaddleConfig(tol=1e-6, max_iters=60))
        (x, hist, iters, _), t_ls = timed(
            lambda a, bb, s: spls(a, bb, 0.0, scfg, s), A, b, RNGState(4),
            reps=1)
        r_vec = jnp.matmul(A, x, precision=hp) - b
        rel_resid = float(jnp.linalg.norm(r_vec) / jnp.linalg.norm(b))
        ne_resid = float(
            jnp.linalg.norm(jnp.matmul(A.T, r_vec, precision=hp))
            / (jnp.linalg.norm(A) ** 2 * jnp.linalg.norm(x)))
        x_err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
        results["spls_100000x2000"] = {
            "solver": "lsqr (auto default)",
            "seconds": t_ls, "iters": int(iters),
            "rel_residual": rel_resid,
            "normal_eq_resid": ne_resid,
            "x_rel_err": x_err}
        log(f"[bench] SPLS (lsqr default): {t_ls:.3f}s, {int(iters)} "
            f"iters, rel resid {rel_resid:.2e}, NE resid {ne_resid:.2e}, "
            f"x-err {x_err:.2e}")
        # PCG (the reference's only LS solver, rl_determiter.hh:19) as
        # the comparison point: same problem, residual converges the
        # same but x-err is kappa^2*eps-floored
        try:
            pcfg = SPLSConfig(solver="pcg",
                              pcg=PCGSaddleConfig(tol=1e-6, max_iters=60))
            (xp, histp, itp, _), t_pc = timed(
                lambda a, bb, s: spls(a, bb, 0.0, pcfg, s), A, b,
                RNGState(4), reps=1)
            rp_vec = jnp.matmul(A, xp, precision=hp) - b
            ne_p = float(
                jnp.linalg.norm(jnp.matmul(A.T, rp_vec, precision=hp))
                / (jnp.linalg.norm(A) ** 2 * jnp.linalg.norm(xp)))
            xp_err = float(jnp.linalg.norm(xp - xt) / jnp.linalg.norm(xt))
            results["spls_100000x2000"]["pcg_reference_path"] = {
                "seconds": t_pc, "iters": int(itp),
                "normal_eq_resid": ne_p,
                "x_rel_err_f32_kappa2eps_limited": xp_err}
            log(f"[bench] SPLS/pcg (reference path): {t_pc:.3f}s, "
                f"{int(itp)} iters, NE resid {ne_p:.2e}, "
                f"x-err {xp_err:.2e} (kappa^2*eps floor)")
        except Exception:
            failed("SPLS/pcg")
        del A, b, x
    except Exception:  # pragma: no cover
        failed("SPLS")

    # ---- sparse-operator track ------------------------------------------
    # The reference benchmarks sparse inputs as a first-class axis
    # (benchmark/bench_ABRIK/ABRIK_speed_comparisons_sparse.cc:309-316,
    # generators rl_gen.hh:538,614). Record BCOO-operator perf next to the
    # dense run of the SAME matrix so the artifact carries the
    # dense-vs-sparse crossover.
    try:
        log("[bench] sparse-operator track ...")
        from randlapack_tpu.drivers import ABRIKConfig, abrik
        from randlapack_tpu.drivers.cholqr_linops import cholqr_linops
        from randlapack_tpu.gen import (gen_exp_singvals,
                                        gen_sparse_from_singvals)
        from randlapack_tpu.linops import DenseLinOp, SparseLinOp
        m_s, n_s, k_s = 8192, 4096, 64
        sv = gen_exp_singvals(n_s, 1e6, dtype)
        acfg_s = ABRIKConfig(block_size=k_s, max_iters=4)
        sp_res = {}
        for dens in (0.01, 0.05):
            Ad, _ = gen_sparse_from_singvals(m_s, n_s, sv, dens,
                                             RNGState(21))
            A_op = SparseLinOp.from_dense(Ad)
            (_, S_sp, _, _, _), t_sp = timed(
                lambda a, s: abrik(a, k_s, acfg_s, s), A_op,
                RNGState(22), reps=2)
            (_, S_dn, _, _, _), t_dn = timed(
                lambda a, s: abrik(a, k_s, acfg_s, s), Ad,
                RNGState(22), reps=2)
            gap = float(jnp.max(jnp.abs(S_sp - S_dn)
                                / jnp.maximum(S_dn, 1e-30)))
            sp_res[f"abrik_{m_s}x{n_s}_k{k_s}_density_{dens}"] = {
                "sparse_op_seconds": t_sp, "dense_seconds": t_dn,
                "sparse_over_dense": t_sp / t_dn,
                "sv_rel_gap_vs_dense": gap,
                "nnz": int(m_s * n_s * dens)}
            log(f"[bench] sparse ABRIK d={dens}: BCOO {t_sp:.3f}s vs "
                f"dense {t_dn:.3f}s ({t_sp/t_dn:.2f}x), sv gap "
                f"{gap:.1e}")
            del Ad, A_op
        # CholQR_linops column-blocked Gram on a tall sparse operator
        Atall, _ = gen_sparse_from_singvals(
            65536, 1024, gen_exp_singvals(1024, 1e4, dtype), 0.02,
            RNGState(23))
        At_op = SparseLinOp.from_dense(Atall)
        (Rt, ft, _), t_cq_sp = timed(
            lambda a: cholqr_linops(a), At_op, reps=2)
        (Rtd, ftd, _), t_cq_dn = timed(
            lambda a: cholqr_linops(a), DenseLinOp(Atall), reps=2)
        # Q-less quality: A^T A = R^T R up to the Gram's own rounding
        G_true = jnp.matmul(Atall.T, Atall, precision=hp)
        gram_err = float(jnp.linalg.norm(
            jnp.matmul(Rt.T, Rt, precision=hp) - G_true)
            / jnp.linalg.norm(G_true))
        sp_res["cholqr_linops_65536x1024_density_0.02"] = {
            "sparse_op_seconds": t_cq_sp, "dense_seconds": t_cq_dn,
            "sparse_over_dense": t_cq_sp / t_cq_dn,
            "gram_rel_err": gram_err, "fail": bool(ft)}
        log(f"[bench] sparse CholQR_linops: BCOO {t_cq_sp:.3f}s vs "
            f"dense {t_cq_dn:.3f}s ({t_cq_sp/t_cq_dn:.2f}x), "
            f"gram err {gram_err:.2e}")
        results["sparse_operator_track"] = sp_res
        del Atall, At_op, Rt, Rtd
    except Exception:  # pragma: no cover
        failed("sparse-operator track")

    details["results"] = results
    details["failed"] = FAILED
    with open(os.path.join(ROOT, "BENCH_details.json"), "w") as f:
        json.dump(details, f, indent=2)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
