# noqa: D400 D205
"""
Device compute kernels (JAX/XLA)
--------------------------------

Device replacements for the reference's two Cython extension modules
(`mlfriends.pyx` kernels and `stepfuncs.pyx`). Everything here is jittable,
shape-stable (padded + masked), and batched:

* :mod:`.pairwise` — pairwise-distance reductions (MLFriends radius,
  neighbour queries) by direct-difference distances;
* :mod:`.bootstrap` — the bootstrapped radius/enlargement kernel, computing
  the N x N distance matrix once and reusing it for all bootstrap rounds;
* :mod:`.cluster` — connected components (friends-of-friends) via
  pointer-jumping label propagation;
* :mod:`.sampling` — batched region proposal kernels;
* :mod:`.stepfuncs` — vectorized population step-sampler state machines.
"""

from .pairwise import (  # noqa: F401
    pairwise_sqdist, count_nearby, find_nearby, compute_maxradiussq,
    compute_mean_pair_distance, subtract_nearby,
)
from .bootstrap import bootstrap_radius_enlargement  # noqa: F401
from .cluster import connected_components  # noqa: F401
