"""Sliding-window bundle adjustment + pose-graph backend.

Absent in the reference (pure frame-to-frame chaining, SURVEY.md §1);
required by BASELINE configs #4/#5. Formulation:

* Fixed-shape dense observation grid: M keyframes x N landmarks with a
  visibility mask — residuals (M, N, 2), Jacobians (M, N, 2, 6)/(2, 3)
  computed with closed-form expressions, everything batched.
* Because each observation couples exactly one pose and one landmark,
  the Gauss-Newton Hessian has block structure: B (per-pose 6x6 blocks,
  block-diagonal), C (per-landmark 3x3, embarrassingly parallel
  inverse), E (pose-landmark). The reduced camera system
  S = B - E C^-1 E^T is (6M x 6M), solved by Cholesky or block-Jacobi
  PCG; landmarks back-substitute in parallel.
* Distribution (config #5): landmarks sharded over the mesh; S and b
  are psum-reduced; the tiny pose solve is replicated (ba/sharded.py).
"""

from davo_tpu.ba.residuals import (  # noqa: F401
    project_points,
    reprojection_residuals,
    reprojection_jacobians,
    huber_weights,
)
from davo_tpu.ba.schur import (  # noqa: F401
    gauss_newton_system,
    schur_reduce,
    solve_window,
    backsubstitute,
)
from davo_tpu.ba.gn import ba_refine, BAProblem  # noqa: F401
from davo_tpu.ba.posegraph import pose_graph_optimize  # noqa: F401
from davo_tpu.ba.window import SlidingWindowBA  # noqa: F401
