"""Orthogonalizers / stabilizers — the reference's interchangeable
``Stabilization`` implementations (reference: RandLAPACK/comps/rl_orth.hh:
CholQRQ :69, HQRQ :145, PLUL :212), as an enum-dispatched pure function —
the "subroutine object" of the reference becomes a config enum
(SURVEY.md §5.6).
"""
from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from ..config import STABLE_PRECISION
from ..ops.cholqr import cholqr, cholqr2, cholqr_auto, shifted_cholqr3
from ..ops.qr import qr_econ


class Stab(enum.Enum):
    cholqr = "cholqr"            # CholQRQ: syrk→potrf→trsm
    cholqr2 = "cholqr2"          # two-pass (default orthogonalizer)
    scholqr3 = "scholqr3"        # shifted CholQR3 (unconditionally stable)
    hqr = "hqr"                  # Householder (geqrf+ungqr)
    plu = "plu"                  # PLUL: pivoted-LU lower factor (stabilize only)
    auto = "auto"                # condition-aware ladder: CholQR2 with a
                                 # free diag-R κ estimate routing bad
                                 # inputs through scholqr3 → Householder-
                                 # preconditioned CholQR (lax.cond-lazy;
                                 # ops/cholqr.py::cholqr_auto)


def orth(A: jax.Array, method: Stab = Stab.cholqr2,
         precision=STABLE_PRECISION):
    """Orthonormalize the columns of A. Returns ``(Q, fail)``.

    ``fail`` is a traced bool; CholQR-family failures mirror the reference's
    ``chol_fail`` flag (rl_orth.hh:81-84) — callers fall back to ``hqr``.
    """
    if method == Stab.auto:
        Q, _, fail = cholqr_auto(A, precision)
    elif method == Stab.cholqr:
        Q, _, fail = cholqr(A, precision)
    elif method == Stab.cholqr2:
        Q, _, fail = cholqr2(A, precision)
    elif method == Stab.scholqr3:
        Q, _, fail = shifted_cholqr3(A, precision)
    elif method == Stab.hqr:
        Q, _ = qr_econ(A)
        fail = jnp.asarray(False)
    else:
        raise ValueError(f"{method} is a stabilizer, not an orthogonalizer")
    return Q, fail


def stabilize(A: jax.Array, method: Stab = Stab.plu,
              precision=STABLE_PRECISION):
    """Return a well-conditioned basis of range(A) — used between power
    iterations where orthonormality is unnecessary (reference PLUL,
    rl_orth.hh:212-230: getrf → unit-lower L). Returns ``(B, fail)``."""
    if method == Stab.plu:
        # non-finite operands carry no pivot information (drivers/
        # bqrrp.py::_sanitize_sketch): sanitize and raise the flag instead
        finite = jnp.isfinite(A)
        bad = ~jnp.all(finite)
        A = jnp.where(finite, A, 0.0)
        # structural-deficiency pad (see ops/qr.py::lu_pivot_columns):
        # keep every elimination pivot nonzero so the LU never generates
        # 0/0 internally. δ = 2^(e_max−40) is an exact power of
        # two BELOW f32 eps relative to the data scale — invisible to the
        # stabilized basis, only lifts exact-zero pivot structure.
        from ..ops.cholqr import _pow2
        m_, n_ = A.shape
        mx = jnp.max(jnp.abs(A))
        e = jnp.floor(jnp.log2(jnp.where(mx > 0, mx, 1.0))).astype(
            jnp.int32)
        pad = _pow2(e - 40, A.dtype) * jax.nn.one_hot(
            jnp.arange(m_) % n_, n_, dtype=A.dtype)
        lu, _, perm = jax.lax.linalg.lu(A + pad)
        L = jnp.tril(lu[:, :A.shape[1]], -1) + jnp.eye(
            A.shape[0], A.shape[1], dtype=A.dtype)
        # un-permute rows so range is preserved: P^T L
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype))
        return jnp.take(L, inv, axis=0), bad
    return orth(A, method, precision)
