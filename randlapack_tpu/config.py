"""Global numerics configuration for randlapack_tpu.

The reference library (RandLAPACK) is templated on float/double and inherits
precision from the BLAS it links. Here the analogous knobs are the array
dtype and the XLA matmul `precision` (on a GPU, f32 at DEFAULT may run in
TF32; HIGHEST keeps full f32).

Policy:
  * dtype is always taken from the input arrays — the library is dtype-generic.
  * Gram-matrix / orthogonalization matmuls default to ``Precision.HIGHEST``
    (full f32) because CholeskyQR stability is
    precision-critical (see SURVEY.md §7 "Hard parts").
  * Sketch-apply matmuls use ``SKETCH_PRECISION``, currently also
    ``Precision.HIGHEST``; randomized sketches would tolerate lower
    precision (ROADMAP S2 measures it per call site).
"""
from __future__ import annotations

import jax

# Precision used for numerically sensitive matmuls (Gram matrices, CholQR,
# re-orthogonalization, trailing updates).
STABLE_PRECISION = jax.lax.Precision.HIGHEST

# Precision used for sketch application (S @ A) where statistical error
# already dominates rounding error.
SKETCH_PRECISION = jax.lax.Precision.HIGHEST

# Machine-epsilon helpers ----------------------------------------------------

def eps(dtype) -> float:
    import numpy as np
    return float(np.finfo(np.dtype(dtype)).eps)


def resolve_precision(precision):
    """None -> STABLE_PRECISION; otherwise pass through."""
    return STABLE_PRECISION if precision is None else precision
