"""Gram/eigh SVD accuracy envelope (VERDICT r3 item 7).

ops/svd.py::svd_econ's "gram_eigh" route squares the
condition number through the Gram matrix, then Rayleigh-refines the
singular VALUES (σᵢ = ‖Bvᵢ‖, relative error ~eps·σ₁/σᵢ instead of the
λ-path's eps·(σ₁/σᵢ)²). This sweep measures, against f64 LAPACK truth,
how far down the spectrum values and triplet residuals stay trustworthy
in f32 — the dtype the accelerator runs.

Output: a table over decay laws × matrix shapes, reporting for each
tolerance the deepest σᵢ/σ₁ at which every shallower singular value
still meets it, plus triplet-residual envelopes. Feeds
docs/svd_envelope.md and the assertions in tests/test_ops.py.

Usage: python tools/svd_envelope_sweep.py
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from randlapack_tpu.ops.svd import svd_econ

hp = jax.lax.Precision.HIGHEST


def make_factor(p, q, law, kappa, seed):
    """Random factor with a prescribed spectrum (f64 construction)."""
    rng = np.random.default_rng(seed)
    k = min(p, q)
    if law == "exp":
        s = np.logspace(0, -np.log10(kappa), k)
    elif law == "poly":
        s = 1.0 / (1.0 + (kappa - 1.0) * (np.arange(k) / max(k - 1, 1)) ** 2)
    else:  # step: flat head, cliff, flat tail
        s = np.ones(k)
        s[k // 2:] = 1.0 / kappa
    U, _ = np.linalg.qr(rng.standard_normal((p, k)))
    V, _ = np.linalg.qr(rng.standard_normal((q, k)))
    B = (U * s) @ V.T
    return B, s


def envelope(B64, s_true):
    B = jnp.asarray(B64, jnp.float32)
    U, s, Vt = svd_econ(B, method="gram_eigh", precision=hp)
    U, s, Vt = np.asarray(U), np.asarray(s), np.asarray(Vt)
    k = s_true.shape[0]
    s, U, Vt = s[:k], U[:, :k], Vt[:k]
    rel = np.abs(s - s_true) / s_true
    # triplet residuals vs the f32-rounded B (what the route actually saw)
    Bf = np.asarray(B, np.float64)
    r1 = np.linalg.norm(Bf @ Vt.T - U * s, axis=0)        # ‖Bv−σu‖
    r2 = np.linalg.norm(Bf.T @ U - Vt.T * s, axis=0)      # ‖Bᵀu−σv‖
    res = np.maximum(r1, r2) / s_true[0]
    return s_true / s_true[0], rel, res


def deepest_ok(ratio, rel, tol):
    """Smallest σᵢ/σ₁ such that ALL values with σ/σ₁ >= it meet tol."""
    bad = np.where(rel > tol)[0]
    if len(bad) == 0:
        return ratio[-1]
    first_bad = bad[0]
    return ratio[first_bad - 1] if first_bad > 0 else float("nan")


def main():
    eps32 = np.finfo(np.float32).eps
    shapes = [(128, 1024), (256, 256), (640, 640)]
    laws = [("exp", 1e6), ("exp", 1e8), ("poly", 1e8), ("step", 1e5)]
    tols = (1e-4, 1e-3, 1e-2)

    print(f"# f32 gram_eigh vs f64 truth; eps32={eps32:.2e}; "
          f"theory: rel(σᵢ) ~ eps·σ₁/σᵢ")
    hdr = f"{'shape':<11} {'law':<10}" + "".join(
        f"  ok@{t:g}" for t in tols) + "   max-res  res@σ/σ₁>1e-3"
    print(hdr)
    worst = {t: 0.0 for t in tols}
    for p, q in shapes:
        for law, kappa in laws:
            B64, s_true = make_factor(p, q, law, kappa, seed=p + q)
            ratio, rel, res = envelope(B64, s_true)
            row = f"{p}x{q:<6} {law}:{kappa:<8.0e}"
            for t in tols:
                d = deepest_ok(ratio, rel, t)
                row += f"  {d:8.1e}"
                # worst rel err among σ/σ₁ >= eps/t (the theory region)
                region = ratio >= eps32 / t
                if region.any():
                    worst[t] = max(worst[t], float(np.max(rel[region])))
            m1 = float(np.max(res))
            m2 = float(np.max(res[ratio > 1e-3])) if (ratio > 1e-3).any() \
                else float("nan")
            row += f"  {m1:8.1e}  {m2:8.1e}"
            print(row)
    print("\n# worst rel err inside the theory region σ/σ₁ >= eps/tol:")
    for t in tols:
        print(f"  tol={t:g}: worst={worst[t]:.2e} "
              f"({'OK' if worst[t] <= t else 'VIOLATED'})")


if __name__ == "__main__":
    main()
