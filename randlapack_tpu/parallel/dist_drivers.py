"""Distributed drivers over a row-sharded mesh — multi-chip versions of the
tall-matrix pipelines (SURVEY.md §5.7/§5.8: the reference's one-pass
sketches and blocked Gram loops are exactly what shards along m).

``dist_cqrrpt`` is GSPMD-style: the tall operand carries a row sharding,
the small (d×n / n×n) intermediates are replicated, and XLA inserts the
psum for every m-contraction (sketch apply, Gram). The QRCP of the sketch
runs redundantly on every device — cheaper than broadcasting its outputs.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..ops.qr import geqp3
from ..ops import util


def dist_cqrrpt(A: jax.Array, mesh: Mesh, state: RNGState,
                d_factor: float = 1.25, axis: str = "rows",
                precision=STABLE_PRECISION):
    """Pivoted QR of a row-sharded tall A: A[:, J] ≈ Q R with Q sharded
    like A and R/J replicated.

    Returns ``(Q, R, J, rank, fail, next_state)`` — the sharded analogue of
    :func:`randlapack_tpu.drivers.cqrrpt` (Gaussian sketch variant: the
    sketch operator's columns shard with A's rows so the d×n sketch is one
    psum; SASO scatter does not shard as cleanly).
    """
    from ..errors import require
    m, n = A.shape
    require(m >= n, "dist_cqrrpt requires a tall input (m >= n) — got "
            f"{A.shape}")
    d = int(d_factor * n)
    dtype = A.dtype
    rows_sh = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    key, state = state.spawn()
    S = jax.random.normal(key, (d, m), dtype=dtype) / math.sqrt(d)
    S = jax.lax.with_sharding_constraint(S, NamedSharding(mesh,
                                                          P(None, axis)))

    @jax.jit
    def impl(A, S):
        A = jax.lax.with_sharding_constraint(A, rows_sh)
        # sketch: column-sharded S against row-sharded A → replicated d×n
        A_sk = jax.lax.with_sharding_constraint(
            jnp.matmul(S, A, precision=precision), repl)
        # QRCP of the small sketch, replicated on every device
        _, R_sk, J = geqp3(A_sk, want_q=False, precision=precision)
        eps = jnp.finfo(dtype).eps
        diag = jnp.abs(jnp.diag(R_sk))
        rank = util.naive_rank_est(jnp.diag(R_sk), diag[0] * eps)
        keep = (jnp.arange(n) < rank).astype(dtype)
        dsafe = jnp.where(keep > 0, jnp.diag(R_sk), 1.0)
        R_sk_safe = (jnp.triu(R_sk) - jnp.diag(jnp.diag(R_sk))
                     + jnp.diag(dsafe))
        # pivot + precondition: row-local ops on the sharded operand
        from ..ops.cholqr import _finite_scaled
        A_piv = jnp.take(A, J, axis=1)
        A_pre = jax.lax.linalg.triangular_solve(
            R_sk_safe, A_piv, left_side=False, lower=False) * keep[None, :]
        # band guard (the global max reduces over the mesh under GSPMD)
        A_pre, s, nonfin = _finite_scaled(A_pre)
        A_pre = jax.lax.with_sharding_constraint(A_pre, rows_sh)
        # Gram over the mesh (psum inserted by SPMD partitioner)
        G = jax.lax.with_sharding_constraint(
            jnp.matmul(A_pre.T, A_pre, precision=precision)
            + jnp.diag(1.0 - keep), repl)
        L = jax.lax.linalg.cholesky(G)
        fail = jnp.any(jnp.isnan(L)) | nonfin
        Q = jax.lax.linalg.triangular_solve(L.T, A_pre, left_side=False,
                                            lower=False)
        Q = jax.lax.with_sharding_constraint(Q, rows_sh)
        R = jnp.matmul(L.T * s, R_sk_safe, precision=precision)
        return Q, R, J, rank, fail

    Q, R, J, rank, fail = impl(A, S)
    return Q, R, J, rank, fail, state


def dist_bqrrp(A: jax.Array, mesh: Mesh, state: RNGState,
               block_size: int = 256, stages: int = 1,
               axis: str = "rows", precision=STABLE_PRECISION):
    """Distributed flagship BQRRP: the standard blocked engine with the
    tall dimension row-sharded over the mesh (panel Grams and trailing
    projections become psums; pivot selection on the replicated sketch is
    redundant per device). Returns the standard bqrrp outputs with Q
    sharded like A."""
    import dataclasses as _dc
    from ..drivers.bqrrp import BQRRPConfig, bqrrp
    cfg = BQRRPConfig(block_size=block_size, stages=stages,
                      shard_axis=axis)
    A = jax.lax.with_sharding_constraint(
        A, NamedSharding(mesh, P(axis, None)))
    with jax.sharding.set_mesh(mesh):
        return bqrrp(A, cfg, state, precision)


def dist_rsvd(A: jax.Array, k: int, mesh: Mesh, state: RNGState,
              power_iters: int = 2, axis: str = "rows",
              precision=STABLE_PRECISION):
    """Fixed-rank randomized SVD of a row-sharded A: one sharded
    rangefinder cycle per power iteration (distributed CholQR2), then a
    replicated small SVD. Returns ``(U, S, Vt, fail, next_state)`` with U
    sharded like A; ``fail`` ORs the CholQR breakdown flags of every
    rangefinder step (the repo convention: breakdown is a returned flag)."""
    from .distributed import dist_rangefinder_step
    from ..ops.svd import svd_econ

    n = A.shape[1]
    key, state = state.spawn()
    Omega = jax.random.normal(key, (n, k), dtype=A.dtype)

    Q = B = None
    fail = jnp.asarray(False)
    for _ in range(max(power_iters, 1)):
        Q, B, Omega, step_fail = dist_rangefinder_step(A, Omega, mesh, axis,
                                                       precision)
        fail = fail | step_fail
    Ub, S, Vt = svd_econ(B, precision=precision)
    U = jnp.matmul(Q, Ub, precision=precision)
    return U, S, Vt, fail, state


def dist_bqrrp_factored(A: jax.Array, mesh: Mesh, state: RNGState,
                        block_size: int = 256, stages: int = 1,
                        axis: str = "rows", precision=STABLE_PRECISION):
    """Distributed factored (implicit-Q) BQRRP: the WY engine with the
    tall dimension row-sharded — panel Grams, trailing WY updates and the
    reflector basis V all stay row-sharded; pivot work on the replicated
    sketch is redundant per device. Returns ``(BQRRPFactors, next_state)``
    with V sharded like A; materialize with
    :func:`randlapack_tpu.drivers.bqrrp_q` under the same mesh."""
    from ..drivers.bqrrp import BQRRPConfig, bqrrp_factored
    cfg = BQRRPConfig(block_size=block_size, stages=stages,
                      shard_axis=axis)
    A = jax.lax.with_sharding_constraint(
        A, NamedSharding(mesh, P(axis, None)))
    with jax.sharding.set_mesh(mesh):
        return bqrrp_factored(A, cfg, state, precision)


def dist_hqrrp(A: jax.Array, mesh: Mesh, state: RNGState,
               block_size: int = 64, axis: str = "rows",
               precision=STABLE_PRECISION):
    """Distributed HQRRP: Householder-QR-with-randomized-pivoting with
    the tall dimension row-sharded — the sketch QRCP runs redundantly on
    the replicated d×n sketch, panel factorizations and WY trailing
    updates psum over the row shards, and the sketch operator G stays
    column-sharded along m. Returns the standard hqrrp outputs with Q
    sharded like A."""
    from ..drivers.hqrrp import HQRRPConfig, hqrrp
    cfg = HQRRPConfig(block_size=block_size, shard_axis=axis)
    A = jax.lax.with_sharding_constraint(
        A, NamedSharding(mesh, P(axis, None)))
    with jax.sharding.set_mesh(mesh):
        return hqrrp(A, cfg, state, precision)


def dist_abrik(A: jax.Array, k: int, mesh: Mesh, state: RNGState,
               block_size: int = 32, max_iters: int = 10,
               axis: str = "rows", precision=STABLE_PRECISION):
    """Distributed ABRIK: block-Krylov SVD with the tall (row) dimension
    sharded over the mesh. The operator applies shard trivially — A·V is
    row-local, Aᵀ·U psums over the shards — and the m-sided inner QRs run
    Gram-based (``qr_explicit="cqrrt"``: sketch + Gram psum + row-local
    trsm) so no Householder gather ever materializes the tall factors.
    V-side work (n-dim) is replicated. (New design — SURVEY §5.8; the
    reference has no distributed ABRIK.)

    Returns ``(U, S, Vt, info, next_state)`` with U sharded like A.
    """
    from ..drivers.abrik import ABRIKConfig, abrik
    cfg = ABRIKConfig(block_size=block_size, max_iters=max_iters,
                      qr_explicit="cqrrt", shard_axis=axis)
    A = jax.lax.with_sharding_constraint(
        A, NamedSharding(mesh, P(axis, None)))
    with jax.sharding.set_mesh(mesh):
        return abrik(A, k, cfg, state, precision=precision)


def dist_spls(A: jax.Array, b: jax.Array, mu, mesh: Mesh,
              state: RNGState, d_factor: float = 4.0, tol: float = 1e-8,
              max_iters: int = 200, axis: str = "rows",
              precision=STABLE_PRECISION):
    """Distributed sketch-and-precondition least squares: solve
    min ‖Ax−b‖² + μ‖x‖² with the tall dimension row-sharded over the
    mesh (BASELINE config 2 at multi-chip scale; new design — SURVEY
    §5.8, the reference's test_pcgls workflow is single-process).

    Structure: a column-sharded Gaussian sketch contracts the row shards
    into ONE replicated d×n sketch (one psum), the SVD
    preconditioner + CholQR sketch-space refinement
    (comps/preconditioners.py::right_precond_saso semantics) run
    replicated on the small sketch, and every PCG iteration's normal-
    equation matvec Aᵀ(A·v) is a row-local GEMM followed by one psum'd
    n-contraction — the small n-vector algebra stays replicated.

    Returns ``(x, res_hist, iters, next_state)`` with x replicated.
    """
    from ..comps.determiter import PCGSaddleConfig, pcg_saddle
    from ..comps.preconditioners import make_right_orthogonalizer
    from ..ops.svd import svd_econ

    m, n = A.shape
    d = min(int(d_factor * n), m)
    dtype = A.dtype
    rows_sh = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    key, state = state.spawn()
    S = jax.random.normal(key, (d, m), dtype=dtype) / math.sqrt(d)
    S = jax.lax.with_sharding_constraint(
        S, NamedSharding(mesh, P(None, axis)))

    @jax.jit
    def impl(A, b, S):
        A = jax.lax.with_sharding_constraint(A, rows_sh)
        A_sk = jax.lax.with_sharding_constraint(
            jnp.matmul(S, A, precision=precision), repl)
        _, sigma, Vt = svd_econ(A_sk, precision=precision)
        M, rank = make_right_orthogonalizer(Vt.T, sigma, mu)
        # one CholQR refinement pass in sketch space (exact sketch-space
        # conditioning; repairs the Gram/eigh SVD's trailing vectors)
        mu_ = jnp.asarray(mu, dtype)
        AskM = jnp.matmul(A_sk, M, precision=precision)
        G = jnp.matmul(AskM.T, AskM, precision=precision)
        G = G + mu_ * jnp.matmul(M.T, M, precision=precision)
        keep = jnp.diag(G) > 0
        G = G + jnp.diag(jnp.where(keep, 0.0, 1.0).astype(dtype))
        L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
        bad = jnp.any(jnp.isnan(L))
        L_safe = jnp.where(bad, jnp.eye(n, dtype=dtype), L)
        M = jax.lax.linalg.triangular_solve(
            L_safe.T, M, left_side=False, lower=False)
        b2 = b[:, None] if b.ndim == 1 else b
        x0 = jnp.zeros((n,) + b2.shape[1:], dtype)
        x, hist, iters = pcg_saddle(
            A, b2, jnp.zeros_like(x0), mu, M, x0,
            PCGSaddleConfig(tol=tol, max_iters=max_iters), precision)
        if b.ndim == 1:
            x = x[:, 0]
        return x, hist, iters, bad

    with jax.sharding.set_mesh(mesh):
        x, hist, iters, bad = impl(A, b, S)
    return x, hist, iters, state


def dist_cqrrt(A: jax.Array, mesh: Mesh, state: RNGState,
               d_factor: float = 1.25, axis: str = "rows",
               precision=STABLE_PRECISION):
    """Unpivoted sketch-preconditioned QR of a row-sharded tall A — the
    sharded analogue of :func:`randlapack_tpu.drivers.cqrrt`
    (rl_cqrrt.hh capability over a mesh; new design, SURVEY §5.8).

    One psum contracts the row shards into the replicated d×n sketch, its
    Householder QR runs redundantly per device, the preconditioning trsm
    is row-local, and the CholQR Gram is the second (and last) psum.

    Returns ``(Q, R, fail, next_state)`` with Q sharded like A, R
    replicated; ``fail`` mirrors cqrrt's potrf-breakdown signal.
    """
    from ..errors import require
    from ..ops.qr import qr_econ

    m, n = A.shape
    require(m >= n, "dist_cqrrt requires a tall input (m >= n) — got "
            f"{A.shape}")
    d = min(int(d_factor * n), m)
    dtype = A.dtype
    rows_sh = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    key, state = state.spawn()
    S = jax.random.normal(key, (d, m), dtype=dtype) / math.sqrt(d)
    S = jax.lax.with_sharding_constraint(
        S, NamedSharding(mesh, P(None, axis)))

    @jax.jit
    def impl(A, S):
        A = jax.lax.with_sharding_constraint(A, rows_sh)
        A_sk = jax.lax.with_sharding_constraint(
            jnp.matmul(S, A, precision=precision), repl)
        _, R_sk = qr_econ(A_sk)
        # eps-RELATIVE diagonal floor, same as cqrrt's _sketch_qr: an
        # exact-zero-only clamp lets denormal-tiny diagonals through and
        # the trsm blows A_pre up to the band guard's rescue instead of
        # preventing it (advisor r3 finding)
        d_sk = jnp.diag(R_sk)
        mx_d = jnp.max(jnp.abs(d_sk))
        ref_d = jnp.where(mx_d > 0.0,
                          mx_d * jnp.finfo(dtype).eps,
                          jnp.asarray(1.0, dtype))
        dsafe = jnp.where(jnp.abs(d_sk) > ref_d, d_sk, ref_d)
        R_sk = jnp.triu(R_sk) - jnp.diag(d_sk) + jnp.diag(dsafe)
        from ..ops.cholqr import _finite_scaled
        A_pre = jax.lax.linalg.triangular_solve(
            R_sk, A, left_side=False, lower=False)
        A_pre, s, nonfin = _finite_scaled(A_pre)
        A_pre = jax.lax.with_sharding_constraint(A_pre, rows_sh)
        G = jax.lax.with_sharding_constraint(
            jnp.matmul(A_pre.T, A_pre, precision=precision), repl)
        L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
        fail = jnp.any(jnp.isnan(L)) | nonfin
        L_safe = jnp.where(fail, jnp.eye(n, dtype=dtype), L)
        Q = jax.lax.linalg.triangular_solve(L_safe.T, A_pre,
                                            left_side=False, lower=False)
        Q = jax.lax.with_sharding_constraint(Q, rows_sh)
        R = jnp.matmul(L_safe.T * s, R_sk, precision=precision)
        return Q, R, fail

    with jax.sharding.set_mesh(mesh):
        Q, R, fail = impl(A, S)
    return Q, R, fail, state


def dist_revd2(A: jax.Array, k: int, mesh: Mesh, state: RNGState,
               power_iters: int = 2, error_est_passes: int = 10,
               axis: str = "rows", precision=STABLE_PRECISION):
    """Distributed rank-k Nyström EVD of a row-sharded PSD A — the sharded
    analogue of :func:`randlapack_tpu.drivers.revd2_fixed_rank`
    (rl_revd2.hh math; new design, SURVEY §5.8).

    Every A·X apply is row-local; each rangefinder orthogonalization and
    the Nyström Gram QᵀY cost one k×k psum, and the trailing small-factor
    algebra (ν shift, Cholesky, Gram-SVD de-regularization, power error
    estimate) runs replicated. Returns ``(V, lam, err_est, nu, fail,
    next_state)`` with V sharded like A.
    """
    n = A.shape[0]
    dtype = A.dtype
    rows_sh = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    key, state = state.spawn()
    Omega = jax.random.normal(key, (n, k), dtype=dtype)
    key_v, state = state.spawn()
    v0 = jax.random.normal(key_v, (n, 1), dtype=dtype)

    @jax.jit
    def impl(A, Omega, v0):
        A = jax.lax.with_sharding_constraint(A, rows_sh)
        fail = jnp.asarray(False)
        X = Omega
        for _ in range(max(power_iters, 1)):
            Y = jax.lax.with_sharding_constraint(
                jnp.matmul(A, X, precision=precision), rows_sh)
            G = jax.lax.with_sharding_constraint(
                jnp.matmul(Y.T, Y, precision=precision), repl)
            L = jax.lax.linalg.cholesky(0.5 * (G + G.T))
            step_fail = jnp.any(jnp.isnan(L))
            L_safe = jnp.where(step_fail, jnp.eye(k, dtype=dtype), L)
            X = jax.lax.linalg.triangular_solve(
                L_safe.T, Y, left_side=False, lower=False)
            # second Gram pass (CholQR2 stability default)
            G2 = jax.lax.with_sharding_constraint(
                jnp.matmul(X.T, X, precision=precision), repl)
            L2 = jax.lax.linalg.cholesky(0.5 * (G2 + G2.T))
            step_fail = step_fail | jnp.any(jnp.isnan(L2))
            L2_safe = jnp.where(step_fail, jnp.eye(k, dtype=dtype), L2)
            X = jax.lax.linalg.triangular_solve(
                L2_safe.T, X, left_side=False, lower=False)
            X = jax.lax.with_sharding_constraint(X, rows_sh)
            fail = fail | step_fail
        Q = X
        Y = jax.lax.with_sharding_constraint(
            jnp.matmul(A, Q, precision=precision), rows_sh)
        eps = jnp.finfo(dtype).eps
        nu = jnp.sqrt(jnp.asarray(n, dtype)) * eps * jnp.linalg.norm(Y)
        Y = Y + nu * Q
        Gc = jax.lax.with_sharding_constraint(
            jnp.matmul(Q.T, Y, precision=precision), repl)
        C = jax.lax.linalg.cholesky(0.5 * (Gc + Gc.T))
        fail = fail | jnp.any(jnp.isnan(C))
        C_safe = jnp.where(jnp.any(jnp.isnan(C)), jnp.eye(k, dtype=dtype),
                           C)
        B = jax.lax.linalg.triangular_solve(
            C_safe, Y, left_side=False, lower=True, transpose_a=True)
        # Gram-SVD of the sharded tall B: BᵀB is one psum, the basis
        # rotation stays row-local (ops/svd.py::svd_econ semantics)
        GB = jax.lax.with_sharding_constraint(
            jnp.matmul(B.T, B, precision=precision), repl)
        W, lam_g = jax.lax.linalg.eigh(0.5 * (GB + GB.T))
        lam_g = lam_g[::-1]
        W = W[:, ::-1]
        s = jnp.sqrt(jnp.maximum(lam_g, 0.0))
        s_safe = jnp.maximum(s, jnp.finfo(dtype).tiny)
        V = jax.lax.with_sharding_constraint(
            jnp.matmul(B, W / s_safe[None, :], precision=precision),
            rows_sh)
        lam = jnp.maximum(s * s - nu, 0.0)
        # power error estimate on the replicated small vectors
        v = v0 / jnp.linalg.norm(v0)

        def body(i, carry):
            v, est = carry
            w = (jnp.matmul(A, v, precision=precision)
                 - jnp.matmul(V, lam[:, None]
                              * jnp.matmul(V.T, v, precision=precision),
                              precision=precision))
            w = jax.lax.with_sharding_constraint(w, repl)
            nrm = jnp.linalg.norm(w)
            return (w / jnp.maximum(nrm, jnp.finfo(dtype).tiny), nrm)

        _, err = jax.lax.fori_loop(
            0, error_est_passes, body, (v, jnp.zeros((), dtype)))
        return V, lam, err, nu, fail

    with jax.sharding.set_mesh(mesh):
        V, lam, err, nu, fail = impl(A, Omega, v0)
    return V, lam, err, nu, fail, state


class DistSquaredExpKernelLinOp:
    """Squared-exponential kernel operator with the matvec sharded over
    row blocks of the (never-materialized) kernel matrix: each device
    evaluates k(X_local, X_full)·V for its shard of the data points
    (O(n²/p) local work and memory, no K slab). Column/diagonal access
    (what RPCholesky's preconditioner build needs — O(n·k) work) stays
    replicated. (New design — SURVEY §5.8: the KRILL linop track's
    clearest multi-chip value.)
    """

    def __init__(self, X: jax.Array, bandwidth, mus, mesh: Mesh,
                 axis: str = "rows", evals_include_reg: bool = True,
                 block: int = 2048):
        from ..pdkernels import SquaredExpKernelLinOp
        self._base = SquaredExpKernelLinOp(X, bandwidth, mus,
                                           evals_include_reg, block)
        self.mesh = mesh
        self.axis = axis

    # pytree: delegate the traced leaves to the base operator
    def tree_flatten(self):
        return (self._base,), (self.mesh, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj._base = children[0]
        obj.mesh, obj.axis = aux
        return obj

    def with_reg(self, flag: bool):
        new = object.__new__(DistSquaredExpKernelLinOp)
        new._base = self._base.with_reg(flag)
        new.mesh, new.axis = self.mesh, self.axis
        return new

    # replicated protocol pieces (RPCholesky build path)
    @property
    def dim(self):
        return self._base.dim

    n_rows = n_cols = dim

    @property
    def num_ops(self):
        return self._base.num_ops

    @property
    def dtype(self):
        return self._base.dtype

    @property
    def X(self):
        return self._base.X

    def diagonal(self):
        return self._base.diagonal()

    def columns(self, idx):
        return self._base.columns(idx)

    def matmat(self, V: jax.Array, precision=STABLE_PRECISION):
        from jax import shard_map
        from ..pdkernels import squared_exp_kernel
        base = self._base
        n = base.dim
        p = self.mesh.shape[self.axis]
        assert n % p == 0, (n, p)
        bw, mus = base.bandwidth, base.mus
        include_reg, num_ops = base.evals_include_reg, base.num_ops

        def local(Xl, Xf, Vf, Vl):
            # rows of K for this device's points, against ALL points
            Kl = squared_exp_kernel(Xl, Xf, bw, precision)   # (nl, n)
            out = jnp.matmul(Kl, Vf, precision=precision)    # (nl, s)
            if include_reg:
                if num_ops == 1:
                    out = out + mus[0] * Vl
                else:
                    out = out + Vl * mus[None, :]
            return out

        fn = shard_map(
            local, mesh=self.mesh,
            in_specs=(P(None, self.axis), P(None, None), P(None, None),
                      P(self.axis, None)),
            out_specs=P(self.axis, None))
        return fn(base.X, base.X, V, V)

    tmatmat = matmat

    def fro_nrm(self):
        raise NotImplementedError("implicit kernel operator")


jax.tree_util.register_pytree_node_class(DistSquaredExpKernelLinOp)


def dist_krill(X: jax.Array, bandwidth, mu, H: jax.Array, mesh: Mesh,
               state: RNGState, k: int = 256, rpchol_block: int = 64,
               tol: float = 1e-5, max_iters: int = 100,
               axis: str = "rows", precision=STABLE_PRECISION):
    """Distributed KRILL: kernel ridge regression whose PCG matvecs run
    the sharded kernel row blocks of :class:`DistSquaredExpKernelLinOp`
    (the dominant O(n²·s) cost), with the RPCholesky preconditioner built
    replicated (O(n·k²)). Returns ``(X, res_hist, iters, next_state)``
    with the solution replicated (pcg's small-vector algebra is
    n-replicated; only the kernel applies shard).
    """
    from ..drivers.krill import KrillConfig, krill_full_rpchol
    from ..comps.determiter import PCGConfig
    G = DistSquaredExpKernelLinOp(X, bandwidth, mu, mesh, axis)
    cfg = KrillConfig(k=k, rpchol_block=rpchol_block,
                      pcg=PCGConfig(tol=tol, max_iters=max_iters))
    with jax.sharding.set_mesh(mesh):
        return krill_full_rpchol(G, H, mu, cfg, state, precision)
