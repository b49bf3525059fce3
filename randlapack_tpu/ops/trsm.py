"""Blocked partitioned-inverse triangular solve (right side, upper R).

An m×n right-solve can run well below GEMM rate (ROADMAP S5 measures
XLA's ``triangular_solve`` against this on the GPU). The classic
GPU-library restructure (cuBLAS/MAGMA trsm): invert ONLY the b×b
diagonal blocks of R (tiny solves, well-conditioned — a pivoted R's
decay is spread along the diagonal, so κ(R_jj) ≈ κ(R)^(b/n)), and do
the back-substitution recurrence with GEMMs:

    X_j = (A_j − X_{:,<j} · R_{<j,j}) · R_jj⁻¹

Forward error keeps trsm's back-substitution structure; only the b×b
base case is an inverse-multiply, amplifying by κ(R_jj) instead of
being backward-stable — the standard accuracy trade every GPU BLAS
makes. NOT safe when individual diagonal blocks are ill-conditioned
(κ(R_jj) ≳ 1/√eps); CQRRPT's rank gate clamps the deficient diagonal
entries first, which bounds the blocks in practice.

Reference analogue: rl_cqrrpt.hh:287-310 uses cblas_strsm; this is a
GEMM-based restructure of the same step.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def trsm_right_upper_blockinv(A, R, block: int = 256, precision=None,
                              cols=None):
    """Solve X · R = A[:, cols] for X, with R (n×n) upper-triangular,
    A (m×·), by inverting the b×b diagonal blocks of R and GEMM-ing the
    rest.

    ``cols`` (optional, traced int vector of length n) fuses the column
    gather A[:, cols] into the per-block reads: the permuted operand is
    never materialized as a full m×n array — each 256-column gather is a
    producer XLA can fuse into the back-substitution subtract (CQRRPT's
    a_mod_piv pass, ~2·m·n·4 bytes of pure traffic, disappears). Gathers
    are device-safe on this backend (unlike block-width scatters — see
    CLAUDE.md WORKER KILL #2).

    Falls back to ``jax.lax.linalg.triangular_solve`` when n doesn't
    divide into ≥2 blocks (no GEMM work to restructure).
    """
    n = R.shape[1]
    if n % block or n // block < 2:
        if cols is not None:
            A = jnp.take(A, cols, axis=1)
        return jax.lax.linalg.triangular_solve(
            R, A, left_side=False, lower=False)
    nb = n // block
    # batched inversion of the diagonal blocks: one (nb, b, b) solve
    diag = jnp.stack([R[i * block:(i + 1) * block,
                        i * block:(i + 1) * block] for i in range(nb)])
    eye = jnp.broadcast_to(jnp.eye(block, dtype=A.dtype),
                           (nb, block, block))
    dinv = jax.lax.linalg.triangular_solve(
        diag, eye, left_side=True, lower=False)
    X = jnp.zeros((A.shape[0], n), A.dtype)
    for j in range(nb):
        if cols is not None:
            Aj = jnp.take(A, cols[j * block:(j + 1) * block], axis=1)
        else:
            Aj = A[:, j * block:(j + 1) * block]
        if j:
            # static slice of the already-written block columns — XLA
            # keeps the dynamic_update_slice writes in place
            Aj = Aj - jnp.matmul(X[:, :j * block],
                                 R[:j * block,
                                   j * block:(j + 1) * block],
                                 precision=precision)
        Xj = jnp.matmul(Aj, dinv[j], precision=precision)
        X = jax.lax.dynamic_update_slice(X, Xj, (0, j * block))
    return X
