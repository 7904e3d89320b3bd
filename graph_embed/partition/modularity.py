"""Modularity of a partition, Q = sum_A (d_A/T - alpha_A^2).

Array replacement for ``partition::modularity``
(src/partitioner.cpp:69-114): d_A = intra-aggregate stored weight, out_A =
outgoing inter-aggregate weight, alpha_A = (d_A + out_A)/T, T = total stored
weight.  All three are one segment-sum over the edge arrays.

Reference quirk (SURVEY.md SS7 #6): the C++ truncates each weight to ``int``
(``int a_ij = D[k]``, partitioner.cpp:90).  The correct non-truncating math is
the default here; ``int_truncate=True`` reproduces the quirk for exact-parity
comparison runs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..graph.csr import Graph
from .interpolation import Partition


@partial(jax.jit, static_argnames=("num_aggs", "int_truncate"))
def _modularity(senders, receivers, weights, edge_mask, vertex_to_agg,
                num_aggs: int, int_truncate: bool):
    w = jnp.where(edge_mask, weights, 0)
    if int_truncate:
        w = jnp.trunc(w)  # C-style (int) cast rounds toward zero
    nv = vertex_to_agg.shape[0]
    a = vertex_to_agg[jnp.clip(senders, 0, nv - 1)]
    b = vertex_to_agg[jnp.clip(receivers, 0, nv - 1)]
    intra = a == b
    T = jnp.sum(w)
    d = jax.ops.segment_sum(jnp.where(intra, w, 0), a, num_segments=num_aggs)
    out = jax.ops.segment_sum(jnp.where(intra, 0, w), a, num_segments=num_aggs)
    alpha = (d + out) / T
    return jnp.sum(d / T - alpha * alpha)


def modularity(g: Graph, p: Partition, *, int_truncate: bool = False):
    """Q of graph ``g`` under partition ``p`` (src/partitioner.cpp:69-114)."""
    return _modularity(g.senders, g.receivers, g.weights, g.edge_mask,
                       p.vertex_to_agg, p.num_aggs, int_truncate)
