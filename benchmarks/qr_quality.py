"""QR driver quality benchmark — error analysis + pivot quality
(reference programs: bench_CQRRPT/CQRRPT_{error_analysis,pivot_quality}.cc,
bench_BQRRP/BQRRP_{error_analysis,pivot_quality}.cc; methodology of
arXiv:2311.08316 §4).

Metrics per driver (CQRRPT / BQRRP explicit / BQRRP factored / HQRRP):
  residual    ‖A[:,J] − QR‖_F / ‖A‖_F
  orth        ‖QᵀQ − I‖_F
  pivot metric 1: ‖R_geqp3[i:, i:]‖_F / ‖R_ours[i:, i:]‖_F per i
                  (summarized min/max over the leading half)
  pivot metric 2: |diag(R)|_i / σ_i(A) (summarized min/max)

Usage: python benchmarks/qr_quality.py [m] [n] [mat_type] [cond] [--chip]
Defaults: 1000 800 polynomial 1e8, f64 on CPU (reference-grade analysis).
--chip: drivers run on the default accelerator in f32 (the production
arithmetic); the yardsticks (f64 SVD + LAPACK geqp3) stay on the host
CPU. The full results print as one JSON line at the end; a pivot-ratio
outside ``randlapack_tpu.testing.PIVOT_RATIO_GATE`` exits non-zero.
"""
import json
import sys

import jax

CHIP = "--chip" in sys.argv
if CHIP:
    sys.argv = [a for a in sys.argv if a != "--chip"]
else:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.linalg as sla  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from randlapack_tpu import RNGState  # noqa: E402
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen  # noqa: E402
from randlapack_tpu.drivers import (BQRRPConfig, CQRRPTConfig,  # noqa: E402
                                    HQRRPConfig, bqrrp, bqrrp_factored,
                                    bqrrp_q, cqrrpt, hqrrp)
from randlapack_tpu.testing import (PIVOT_RATIO_GATE,  # noqa: E402
                                    pivot_norm_ratios)

hp = jax.lax.Precision.HIGHEST


def analyze(name, Q, R, J, A, svals, R_qp3):
    K = min(A.shape)
    AJ = np.asarray(A)[:, np.asarray(J)]
    res = float(np.linalg.norm(np.asarray(Q) @ np.asarray(R) - AJ)
                / np.linalg.norm(A))
    orth = float(np.linalg.norm(np.asarray(Q).T @ np.asarray(Q)
                                - np.eye(K)))
    ratio1 = pivot_norm_ratios(R, R_qp3)
    d = np.abs(np.diag(np.asarray(R)[:K, :K]))
    ratio2 = d / np.maximum(svals[:K], 1e-300)
    rec = {
        "residual": res, "orth": orth,
        "pivot_norm_ratio_min": float(ratio1.min()),
        "pivot_norm_ratio_max": float(ratio1.max()),
        "diag_over_sv_min": float(ratio2[: K // 2].min()),
        "diag_over_sv_max": float(ratio2[: K // 2].max()),
    }
    print(f"{name:<18} res {res:.2e}  orth {orth:.2e}  "
          f"norm-ratio [{rec['pivot_norm_ratio_min']:.2f}, "
          f"{rec['pivot_norm_ratio_max']:.2f}]  "
          f"diag/sv [{rec['diag_over_sv_min']:.2f}, "
          f"{rec['diag_over_sv_max']:.2f}]")
    return rec


def main(argv):
    m = int(argv[1]) if len(argv) > 1 else 1000
    n = int(argv[2]) if len(argv) > 2 else 800
    mt = MatType[argv[3]] if len(argv) > 3 else MatType.polynomial
    cond = float(argv[4]) if len(argv) > 4 else 1e8
    K = min(m, n)
    arith = f"f32 on {jax.devices()[0].device_kind}" if CHIP else "f64"
    print(f"[qr_quality] {m}x{n} {mt.value} cond={cond:g} ({arith})")

    dtype = jnp.float32 if CHIP else jnp.float64
    A, st = mat_gen(MatGenInfo(m, n, mt, cond_num=cond), RNGState(0),
                    dtype=dtype)
    # the yardsticks always run in f64 on the host CPU: the pivot-quality
    # ratios compare the chip's f32 factorization against reference-grade
    # truth, not against another f32 run
    An = np.asarray(A).astype(np.float64)
    svals = np.linalg.svd(An, compute_uv=False)
    Qp3, R_qp3, piv = sla.qr(An, mode="economic", pivoting=True)

    results = {}
    Q, R, J, rank, fail, _ = cqrrpt(A, CQRRPTConfig(), RNGState(1)) \
        if m >= n else (None,) * 6
    if Q is not None:
        results["cqrrpt"] = analyze("CQRRPT", Q, R, J, A, svals, R_qp3)

    b = max(32, K // 8)
    Q, R, J, rank, fail, _ = bqrrp(A, BQRRPConfig(block_size=b),
                                   RNGState(2))
    results["bqrrp"] = analyze("BQRRP (explicit)", Q, R, J, A, svals,
                               R_qp3)
    fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=b), RNGState(2))
    results["bqrrp_factored"] = analyze("BQRRP (factored)", bqrrp_q(fac),
                                        fac.R, fac.J, A, svals, R_qp3)
    Q, R, J, rank, fail, _ = hqrrp(A, HQRRPConfig(block_size=min(64, b)),
                                   RNGState(3))
    results["hqrrp"] = analyze("HQRRP", Q, R, J, A, svals, R_qp3)

    # GEQP3 itself as the yardstick row
    results["geqp3"] = analyze("LAPACK geqp3", Qp3, R_qp3,
                               piv.astype(np.int32), A, svals, R_qp3)

    payload = {"m": m, "n": n, "mat": mt.value, "cond": cond,
               "arithmetic": "f32_chip" if CHIP else "f64_cpu",
               "results": results}
    lo, hi = PIVOT_RATIO_GATE
    bad = [k for k, r in results.items()
           if not lo <= r["pivot_norm_ratio_min"] <= r["pivot_norm_ratio_max"]
           <= hi]
    payload["pivot_gate_failed"] = bad
    print(json.dumps(payload))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
