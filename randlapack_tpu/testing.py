"""Testing helpers — the RandBLAS/RandLAPACK test-utility surface
(reference: RandLAPACK/testing/rl_test_utils.hh; RandBLAS testing symbols
``matrices_approx_equal``, ``buffs_approx_equal``,
``iid_sparsify_random_dense``, ``random_coo``; ``coo_view_of_skop``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rng import RNGState


def matrices_approx_equal(A, B, rel_tol: float | None = None) -> bool:
    """‖A − B‖_F ≤ tol·‖A‖_F (reference uses eps-scaled tolerances)."""
    A = np.asarray(A)
    B = np.asarray(B)
    tol = rel_tol if rel_tol is not None else np.finfo(A.dtype).eps ** 0.75
    return bool(np.linalg.norm(A - B) <= tol * max(np.linalg.norm(A), 1e-30))


def buffs_approx_equal(a, b, atol: float) -> bool:
    return bool(np.max(np.abs(np.asarray(a) - np.asarray(b))) <= atol)


def iid_sparsify_random_dense(m: int, n: int, density: float,
                              state: RNGState, dtype=jnp.float64):
    """Dense iid Gaussian matrix with iid Bernoulli(density) sparsification
    (RandBLAS testing helper). Returns ``(A, next_state)``."""
    k1, state = state.spawn()
    k2, state = state.spawn()
    A = jax.random.normal(k1, (m, n), dtype=dtype)
    mask = jax.random.uniform(k2, (m, n)) < density
    return A * mask.astype(dtype), state


def random_coo(m: int, n: int, nnz: int, state: RNGState, dtype=jnp.float64):
    """Random COO triple (rows, cols, vals) — RandBLAS testing helper."""
    from .gen import gen_sparse_coo
    return gen_sparse_coo(m, n, nnz, state, dtype)


def coo_view_of_skop(op):
    """COO triple view of a sampled SASO (RandBLAS ``coo_view_of_skop``):
    returns ``(rows, cols, vals, shape)`` with the isometry scale folded
    into vals."""
    from .sketching.sparse_ops import SparseSkOp
    assert isinstance(op, SparseSkOp)
    vec_nnz, long_axis = op.rows.shape
    cols = jnp.broadcast_to(jnp.arange(long_axis), op.rows.shape).ravel()
    rows = op.rows.ravel()
    vals = op.vals.ravel() * op.dist.isometry_scale
    shape = (op.dist.n_rows, op.dist.n_cols)
    if op.dist.n_rows > op.dist.n_cols:  # tall operator: short axis = cols
        rows, cols = cols, rows
    return rows, cols, vals, shape


def materialize_linop(op):
    """Densify any linop (reference rl_test_utils.hh:191)."""
    from .linops.base import materialize
    return materialize(op)


def orthogonality_error(Q) -> float:
    from .ops import util
    return float(util.orthogonality_check(jnp.asarray(Q)))


def write_dense_to_mtx(filename: str, A) -> None:
    """Write a dense matrix to a Matrix Market coordinate file, dropping
    entries ≤ eps·max|A| as structural zeros
    (rl_test_utils.hh:379 write_dense_to_mtx)."""
    A = np.asarray(A)
    tol = np.finfo(A.dtype).eps * np.max(np.abs(A)) if A.size else 0.0
    rows, cols = np.nonzero(np.abs(A) > tol)
    from .extras.io import mm_write
    mm_write(filename, rows.astype(np.int32), cols.astype(np.int32),
             A[rows, cols], A.shape)


def generate_spd_matrix_file(filename: str, n: int, cond_num: float,
                             state: RNGState, dtype=jnp.float64):
    """Random n×n SPD matrix with κ = cond_num written to .mtx
    (rl_test_utils.hh:426 generate_spd_matrix_file).
    Returns ``next_state``."""
    from .gen import gen_quadratic_singvals, psd_from_eigvals
    lam = gen_quadratic_singvals(n, cond_num, dtype)
    A, state = psd_from_eigvals(n, lam, state)
    write_dense_to_mtx(filename, A)
    return state


def generate_invertible_matrix_file(filename: str, n: int, cond_num: float,
                                    state: RNGState, dtype=jnp.float64):
    """Random invertible (non-symmetric) n×n matrix with κ = cond_num,
    written to .mtx (rl_test_utils.hh:440). Returns ``next_state``."""
    from .gen import gen_quadratic_singvals, gen_singvec
    s = gen_quadratic_singvals(n, cond_num, dtype)
    A, state = gen_singvec(n, n, s, state)
    write_dense_to_mtx(filename, A)
    return state


def left_multiply_by_orthmat(A, state: RNGState):
    """Q·A for a Haar-random orthogonal Q (rl_test_utils.hh:468).
    Returns ``(QA, next_state)``."""
    from .gen import haar_basis
    m = A.shape[0]
    Q, state = haar_basis(m, m, state, A.dtype)
    from .config import STABLE_PRECISION
    return jnp.matmul(Q, A, precision=STABLE_PRECISION), state


# pivot-quality gate on the trailing-norm ratio ‖R_geqp3[i:, i:]‖ /
# ‖R[i:, i:]‖ over the leading half of the diagonal (benchmarks/
# qr_quality.py, methodology of arXiv:2311.08316 §4)
PIVOT_RATIO_GATE = (0.5, 2.0)


def trailing_norms(R):
    """‖R[i:, i:]‖_F for every i (the reference's get_norms)."""
    import numpy as np
    R = np.asarray(R)
    n = min(R.shape)
    sq = np.abs(np.triu(R[:n, :n])) ** 2
    # suffix[i, j] = sum of sq[i:, j:]; trailing norm i = sqrt(suffix[i,i])
    suffix = np.flip(np.flip(sq, (0, 1)).cumsum(0).cumsum(1), (0, 1))
    return np.sqrt(np.diag(suffix))


def pivot_norm_ratios(R, R_geqp3):
    """Trailing-norm ratios of a pivoted R against LAPACK geqp3's R over
    the leading half of the diagonal; each should lie in
    ``PIVOT_RATIO_GATE``."""
    import numpy as np
    K = min(np.asarray(R_geqp3).shape)
    tn_ours = trailing_norms(np.asarray(R)[:, :K])
    tn_qp3 = trailing_norms(R_geqp3)
    return tn_qp3[: K // 2] / np.maximum(tn_ours[: K // 2], 1e-300)
