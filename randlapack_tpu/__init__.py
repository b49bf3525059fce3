"""randlapack_tpu — a randomized numerical linear algebra framework in JAX.

Built from scratch in JAX/XLA/Pallas with capability parity to
BallisticLA/RandLAPACK (see SURVEY.md): a sketching substrate with
counter-based RNG, composable randomized building blocks (comps), and
user-facing drivers (RSVD, REVD2, CQRRPT, BQRRP, HQRRP, CQRRT, ABRIK,
KRILL, CholQR-over-linops), over a jit-traceable linear-operator protocol.

Design stance (SURVEY.md §7): functional JAX core — pure functions,
state-in/state-out PRNG, frozen dataclass configs mirroring the reference's
"algorithms as objects" tuning surface, static shapes under jit, GEMM-first
kernels (CholQR instead of column Householder wherever stability allows).
"""
from .rng import RNGState, as_state
from . import sketching, ops, linops, comps, drivers, gen, pdkernels
from . import utils, extras, parallel, testing

__version__ = "0.1.0"
__all__ = ["RNGState", "as_state", "sketching", "ops", "linops", "comps",
           "drivers", "gen", "pdkernels", "utils", "extras", "parallel",
           "testing", "__version__"]
