"""Multi-chip SPMD layer — the framework's (new, not ported) growth path.

The reference is single-process (SURVEY.md §2.8/§5.8); its blocked/
streaming structures (column-blocked Gram loops, one-pass sketches) are
exactly what shards over a device mesh along the tall dimension. This package
provides:

  * mesh helpers (``make_mesh``)
  * distributed tall-skinny orthogonalization (``dist_cholqr``,
    ``dist_shifted_cholqr3``): local Gram + psum over the mesh + replicated
    Cholesky + local triangular solve — the communication-optimal
    CholeskyQR layout (one k×k all-reduce per pass)
  * distributed Gram (``dist_gram``) and sketch-apply (``dist_sketch_left``)
  * a sharded randomized-rangefinder step (``dist_qb_step``) composing all
    of the above — the "full training step" of this framework
"""
from .mesh import make_mesh, row_sharded, replicated
from .tsqr import dist_cholqr, dist_gram, dist_shifted_cholqr3
from .distributed import dist_sketch_left, dist_rangefinder_step
from .dist_drivers import (dist_abrik, dist_bqrrp, dist_bqrrp_factored,
                           dist_cqrrpt, dist_cqrrt, dist_hqrrp, dist_krill,
                           dist_revd2, dist_rsvd, dist_spls,
                           DistSquaredExpKernelLinOp)

__all__ = ["make_mesh", "row_sharded", "replicated",
           "dist_cholqr", "dist_gram", "dist_shifted_cholqr3",
           "dist_sketch_left", "dist_rangefinder_step",
           "dist_bqrrp", "dist_bqrrp_factored", "dist_cqrrpt", "dist_hqrrp",
           "dist_rsvd", "dist_abrik", "dist_krill", "dist_spls",
           "dist_cqrrt", "dist_revd2",
           "DistSquaredExpKernelLinOp"]
