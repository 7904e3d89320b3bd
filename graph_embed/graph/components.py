"""Connected components and degree-outlier filtering.

Array replacement for the embedder pipeline's iterative-DFS
``largestComponent`` (examples/embedder.cpp:35-93) and ``removeLargest``
(:95-114).  DFS is inherently sequential; the device formulation is label
propagation (pointer-jump min-label), which converges in O(diameter) sparse
rounds with a doubling trick, all as segment ops under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .csr import Graph, submatrix


@jax.jit
def _component_labels(senders, receivers, n_arr):
    """Min-label propagation with pointer jumping; returns [n] labels."""
    n = n_arr.shape[0]
    labels = jnp.arange(n, dtype=jnp.int32)

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        # propagate min label across edges (both directions are stored)
        neigh = jax.ops.segment_min(labels[receivers], senders, num_segments=n)
        new = jnp.minimum(labels, neigh)
        # pointer jumping: label <- label[label] until stable within this round
        new = new[new]
        new = new[new]
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.array(True)))
    return labels


def component_labels(g: Graph) -> np.ndarray:
    """[n] component id per vertex (ids are min vertex id in the component)."""
    if g.num_edges == 0:
        return np.arange(g.n, dtype=np.int32)
    # mask padded edges: ghost sender n is out of segment range and dropped,
    # but segment_min needs an explicit fill; route pads to a ghost segment.
    s = np.asarray(g.senders)
    r = np.asarray(g.receivers)
    e = g.num_edges
    labels = _component_labels(
        jnp.asarray(s[:e]), jnp.asarray(r[:e]), jnp.zeros(g.n)
    )
    return np.asarray(labels)


def largest_component(g: Graph) -> tuple[Graph, np.ndarray]:
    """Induced subgraph on the largest connected component
    (examples/embedder.cpp:35-93).  Returns (subgraph, kept vertex ids)."""
    labels = component_labels(g)
    ids, counts = np.unique(labels, return_counts=True)
    best = ids[np.argmax(counts)]
    vertices = np.nonzero(labels == best)[0]
    return submatrix(g, vertices), vertices


def remove_largest(g: Graph, threshold: float = 0.01) -> tuple[Graph, np.ndarray]:
    """Drop vertices whose stored-entry count is >= threshold * max degree
    (examples/embedder.cpp:95-114)."""
    counts = np.diff(np.asarray(g.indptr))
    mx = counts.max() if counts.size else 0
    vertices = np.nonzero(counts < threshold * mx)[0]
    return submatrix(g, vertices), vertices
