"""Vertex reordering for locality.

The attraction gathers receiver coordinates and the DIA decomposition rolls
along constant index offsets; both run faster when the vertex numbering
clusters neighborhoods (gathers stay in cache, more edges land on a
diagonal).  The halo sharding's boundary is the cut of this numbering.  Two
orderings are provided:

* ``rcm_order``: reverse Cuthill-McKee (scipy), the classic bandwidth
  reducer -- good for meshes/roadnets;
* ``partition_order``: sort vertices by their aggregate id from this
  framework's own coarsener (optionally composed over several levels) -- the
  multilevel structure doubles as a locality order, the synergy called out
  in SURVEY.md SS7 layer 6.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges


def rcm_order(g: Graph) -> np.ndarray:
    """perm[new_id] = old_id via reverse Cuthill-McKee."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s, r, w = g.to_coo_numpy()
    m = sp.csr_matrix((np.ones_like(w), (s, r)), shape=(g.n, g.n))
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True))


def partition_order(g: Graph, coarsening_factor: float = 0.1, *,
                    levels=None) -> np.ndarray:
    """Order vertices by composed aggregate ids of the multilevel hierarchy
    (coarsest first key, finest last), grouping communities contiguously.

    ``levels``: reuse an existing hierarchy (list of Partition, fine to
    coarse) instead of re-partitioning -- the embed pipeline already has
    one, and at LJ scale the re-partition costs minutes."""
    from ..partition.interpolation import compose

    if levels is None:
        from ..partition.hierarchy import partition_hierarchy

        levels = partition_hierarchy(g, coarsening_factor).levels
    keys = []
    for upto in range(len(levels), 0, -1):
        keys.append(compose(levels, upto).vertex_to_agg_numpy())
    keys.append(np.arange(g.n))
    return np.lexsort(tuple(reversed(keys)))


def apply_order(g: Graph, perm: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Relabel the graph so new vertex i is old perm[i].
    Returns (reordered graph, inverse permutation old->new)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    s, r, w = g.to_coo_numpy()
    return from_edges(inv[s], inv[r], w, n=g.n, dtype=g.dtype), inv
