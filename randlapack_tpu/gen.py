"""Synthetic matrix generators with controlled spectra — the reference's
``RandLAPACK::gen`` test fuel (reference: RandLAPACK/testing/rl_gen.hh:
mat_type enum :22-31, mat_gen :713, spectrum builders :106/:216, adversarial
generators :311/:384/:409).

Every generator is deterministic in the RNGState and returns
``(A, next_state)``. Spectra are built on host (tiny vectors), factors
assembled with matmuls.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import jax
import jax.numpy as jnp

from .config import STABLE_PRECISION
from .rng import RNGState


class MatType(enum.Enum):
    polynomial = "polynomial"
    exponential = "exponential"
    gaussian = "gaussian"
    step = "step"
    spiked = "spiked"
    adversarial = "adversarial"
    bad_cholqr = "bad_cholqr"
    kahan = "kahan"
    custom_input = "custom_input"   # read from a Matrix Market file
                                    # (rl_gen.hh:438 process_input_mat)


@dataclasses.dataclass(frozen=True)
class MatGenInfo:
    """Port of ``mat_gen_info`` (rl_gen.hh:36)."""

    n_rows: int
    n_cols: int
    mat_type: MatType = MatType.gaussian
    cond_num: float = 1e3        # target 2-norm condition number
    rank: int | None = None      # numerical rank (None = full)
    exponent: float = 2.0        # polynomial decay power
    scaling: float = 1.0
    filename: str | None = None  # .mtx path for MatType.custom_input


# -- spectrum builders --------------------------------------------------------

def gen_poly_singvals(k: int, cond: float, p: float, dtype) -> jax.Array:
    """σ_i ∝ (1+i)^-p, rescaled so σ_0/σ_{k-1} = cond (rl_gen.hh:106)."""
    if k == 1:
        return jnp.ones((1,), dtype)
    i = jnp.arange(k, dtype=dtype)
    raw = (1.0 + i) ** (-p)
    # renormalize the log-profile so σ_0/σ_{k-1} = cond exactly while
    # keeping the polynomial decay shape
    t = jnp.log(raw / raw[0]) / jnp.log(raw[-1] / raw[0])
    s = jnp.exp(t * jnp.log(jnp.asarray(1.0 / cond, dtype)))
    return s.astype(dtype)


def gen_exp_singvals(k: int, cond: float, dtype) -> jax.Array:
    """Geometric decay from 1 to 1/cond."""
    if k == 1:
        return jnp.ones((1,), dtype)
    t = jnp.arange(k, dtype=dtype) / (k - 1)
    return jnp.exp(-t * math.log(cond)).astype(dtype)


def gen_quadratic_singvals(k: int, cond: float, dtype) -> jax.Array:
    """σᵢ = 1 + (cond−1)·(i/(k−1))², descending after normalization —
    the reference's quadratic spectrum (rl_test_utils.hh:446 usage,
    ``gen_quadratic_singvals``); κ = cond exactly."""
    if k == 1:
        return jnp.ones((1,), dtype)
    t = jnp.arange(k, dtype=dtype) / (k - 1)
    s = 1.0 + (cond - 1.0) * t * t
    return (s[::-1] / s[-1]).astype(dtype)


def gen_step_singvals(k: int, cond: float, dtype,
                      n_steps: int = 4) -> jax.Array:
    """Piecewise-constant spectrum (rl_gen.hh:216)."""
    lev = jnp.exp(-jnp.arange(n_steps, dtype=dtype) / max(n_steps - 1, 1)
                  * math.log(cond))
    idx = jnp.minimum((jnp.arange(k) * n_steps) // k, n_steps - 1)
    return lev[idx].astype(dtype)


def gen_spiked_singvals(k: int, cond: float, dtype,
                        n_spikes: int = 10) -> jax.Array:
    s = jnp.full((k,), 1.0 / cond, dtype)
    return s.at[:n_spikes].set(1.0)


# -- factor assembly ----------------------------------------------------------

def haar_basis(m: int, k: int, state: RNGState, dtype):
    """Orthonormal m×k factor from QR of a Gaussian (Haar-ish, rl_gen.hh:63)."""
    key, state = state.spawn()
    G = jax.random.normal(key, (m, k), dtype=dtype)
    Q, _ = jnp.linalg.qr(G)
    return Q, state


def gen_singvec(m: int, n: int, singvals: jax.Array, state: RNGState):
    """A = U diag(σ) Vᵀ with Haar-ish U, V."""
    dtype = singvals.dtype
    k = singvals.shape[0]
    U, state = haar_basis(m, k, state, dtype)
    V, state = haar_basis(n, k, state, dtype)
    A = jnp.matmul(U * singvals[None, :], V.T, precision=STABLE_PRECISION)
    return A, state


# -- special matrices ---------------------------------------------------------

def kahan_matrix(n: int, dtype, theta: float = 1.2) -> jax.Array:
    """Kahan's upper-triangular QR-pivoting stress matrix (rl_gen.hh:409):
    K = diag(s^i) · (I - c·strict_upper), s = sin θ, c = cos θ."""
    s, c = math.sin(theta), math.cos(theta)
    i = jnp.arange(n, dtype=dtype)
    scale = jnp.power(jnp.asarray(s, dtype), i)
    body = jnp.eye(n, dtype=dtype) - c * jnp.triu(jnp.ones((n, n), dtype), 1)
    return scale[:, None] * body


def bad_cholqr_matrix(m: int, n: int, state: RNGState, dtype,
                      cond: float | None = None):
    """Tall matrix engineered to break one-pass CholQR (rl_gen.hh:384):
    cond ≈ 1/√eps so the Gram matrix is numerically indefinite."""
    eps = float(jnp.finfo(dtype).eps)
    cond = cond or (0.5 / math.sqrt(eps))
    s = gen_exp_singvals(min(m, n), cond, dtype)   # k = min(m, n): wide
    return gen_singvec(m, n, s, state)             # inputs work too


def adversarial_matrix(m: int, n: int, state: RNGState, dtype,
                       n_copies: int = 4):
    """High-coherence matrix with (near-)repeated columns — the reference's
    'oleg adversarial' generator (rl_gen.hh:311) stresses pivoting."""
    key, state = state.spawn()
    base = jax.random.normal(key, (m, max(n // n_copies, 1)), dtype=dtype)
    reps = -(-n // base.shape[1])
    A = jnp.tile(base, (1, reps))[:, :n]
    key2, state = state.spawn()
    A = A + 1e-8 * jax.random.normal(key2, (m, n), dtype=dtype)
    return A, state


# -- dispatch -----------------------------------------------------------------

def mat_gen(info: MatGenInfo, state: RNGState, dtype=jnp.float64):
    """Generate a matrix per ``info`` (rl_gen.hh:713 dispatch).

    Returns ``(A, next_state)``.
    """
    m, n = info.n_rows, info.n_cols
    k = info.rank or min(m, n)
    t = info.mat_type
    if t == MatType.gaussian:
        key, state = state.spawn()
        return jax.random.normal(key, (m, n), dtype=dtype) * info.scaling, state
    if t == MatType.polynomial:
        s = gen_poly_singvals(k, info.cond_num, info.exponent, dtype)
    elif t == MatType.exponential:
        s = gen_exp_singvals(k, info.cond_num, dtype)
    elif t == MatType.step:
        s = gen_step_singvals(k, info.cond_num, dtype)
    elif t == MatType.spiked:
        s = gen_spiked_singvals(k, info.cond_num, dtype)
    elif t == MatType.kahan:
        return kahan_matrix(min(m, n), dtype), state
    elif t == MatType.bad_cholqr:
        return bad_cholqr_matrix(m, n, state, dtype)
    elif t == MatType.adversarial:
        return adversarial_matrix(m, n, state, dtype)
    elif t == MatType.custom_input:
        # rl_gen.hh:438: route a Matrix Market file through mat_gen
        from .extras.io import mm_read
        assert info.filename, "custom_input requires MatGenInfo.filename"
        A = jnp.asarray(mm_read(info.filename, dense=True), dtype=dtype)
        assert A.shape == (m, n), (
            f"file is {A.shape}, MatGenInfo says {(m, n)}")
        return A * info.scaling, state
    else:  # pragma: no cover
        raise ValueError(t)
    A, state = gen_singvec(m, n, s * info.scaling, state)
    return A, state


def fast_decay_matrix(m: int, n: int, state: RNGState, dtype=jnp.float32,
                      decay: float = 6.0, precision=STABLE_PRECISION):
    """Cheap benchmark matrix with an approximately exponential spectrum:
    A = (G₁·diag(e^{-decay·i/k}))·G₂ᵀ/√(mk) with iid Gaussian factors — no
    Haar QR, so generation is one GEMM (needed for 8192²+ bench inputs
    where gen_singvec's orthogonal factors dominate runtime)."""
    k = min(m, n)
    key1, state = state.spawn()
    key2, state = state.spawn()
    s = jnp.exp(-decay * jnp.arange(k, dtype=dtype) / k)
    G1 = jax.random.normal(key1, (m, k), dtype=dtype)
    G2 = jax.random.normal(key2, (n, k), dtype=dtype)
    import math
    A = jnp.matmul(G1 * s[None, :], G2.T,
                   precision=precision) / math.sqrt(float(m) * k)
    return A, state


def gen_sparse_coo(m: int, n: int, nnz: int, state: RNGState,
                   dtype=jnp.float64):
    """Random sparse COO matrix (rl_gen.hh:538). Returns
    ``((rows, cols, vals), next_state)`` with iid positions/values
    (duplicates possible, as in the reference's generator)."""
    k1, state = state.spawn()
    k2, state = state.spawn()
    k3, state = state.spawn()
    rows = jax.random.randint(k1, (nnz,), 0, m, dtype=jnp.int32)
    cols = jax.random.randint(k2, (nnz,), 0, n, dtype=jnp.int32)
    vals = jax.random.normal(k3, (nnz,), dtype=dtype)
    return (rows, cols, vals), state


def gen_sparse_from_singvals(m: int, n: int, singvals: jax.Array,
                             density: float, state: RNGState):
    """Tall sparse matrix with (approximately) prescribed spectrum
    (rl_gen.hh:614): dense spectrum-shaped core masked to the target
    density and rescaled. Returns ``(A_dense_masked, next_state)`` —
    convert with SparseLinOp.from_dense for operator use."""
    A, state = gen_singvec(m, n, singvals, state)
    key, state = state.spawn()
    mask = jax.random.uniform(key, (m, n)) < density
    import math
    return A * mask.astype(A.dtype) / math.sqrt(density), state


def psd_from_eigvals(n: int, eigvals: jax.Array, state: RNGState):
    """Symmetric PSD matrix with prescribed eigenvalues."""
    dtype = eigvals.dtype
    U, state = haar_basis(n, n, state, dtype)
    A = jnp.matmul(U * eigvals[None, :], U.T, precision=STABLE_PRECISION)
    return 0.5 * (A + A.T), state
