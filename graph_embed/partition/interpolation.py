"""Aggregation (interpolation) operators.

Array replacement for the CSR ``P^T`` built by ``interpolationMatrix``
(src/partitioner.cpp:29-65).  Because every column of P^T has exactly one unit
entry, the whole matrix is just a dense vertex->aggregate assignment vector;
P^T A P is a relabel+sum (ops/spgemm.py), P^T x is a segment-sum, P x is a
gather.  A CSR materialization is provided for export/debug parity.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Partition:
    """vertex -> aggregate assignment; the framework's ``P^T``.

    ``vertex_to_agg``: [n] int32 with dense ids in [0, num_aggs).
    ``num_aggs``: static int (rows of P^T).
    """

    vertex_to_agg: jnp.ndarray
    num_aggs: int

    def tree_flatten(self):
        return (self.vertex_to_agg,), (self.num_aggs,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    @property
    def n(self) -> int:
        return int(self.vertex_to_agg.shape[0])

    @classmethod
    def from_numpy(cls, v2a: np.ndarray, num_aggs: int) -> "Partition":
        """Build from a host assignment vector, keeping the host copy cached
        (no device->host readback later -- same pattern as
        Graph._host_coo)."""
        v2a = np.ascontiguousarray(v2a, dtype=np.int32)
        p = cls(jnp.asarray(v2a), int(num_aggs))
        object.__setattr__(p, "_host_v2a", v2a)
        return p

    def vertex_to_agg_numpy(self) -> np.ndarray:
        """Host view of the assignment vector; memoizes the device pull when
        no host copy was cached at construction."""
        cached = getattr(self, "_host_v2a", None)
        if cached is None:
            cached = np.asarray(self.vertex_to_agg)
            object.__setattr__(self, "_host_v2a", cached)
        return cached

    def agg_sizes(self) -> jnp.ndarray:
        return jax.ops.segment_sum(
            jnp.ones_like(self.vertex_to_agg), self.vertex_to_agg,
            num_segments=self.num_aggs,
        )

    def restrict(self, x: jnp.ndarray) -> jnp.ndarray:
        """P^T x: sum vertex values into aggregates."""
        return jax.ops.segment_sum(x, self.vertex_to_agg, num_segments=self.num_aggs)

    def prolong(self, y: jnp.ndarray) -> jnp.ndarray:
        """P y: copy aggregate values to member vertices."""
        return y[self.vertex_to_agg]

    def members_csr(self):
        """(indptr[num_aggs+1], order[n]): CSR rows of P^T -- each aggregate's
        member vertices, sorted by vertex id (matches interpolationMatrix's
        member ordering, src/partitioner.cpp:54-62).  Host-side."""
        v2a = self.vertex_to_agg_numpy()
        order = np.argsort(v2a, kind="stable")
        counts = np.bincount(v2a, minlength=self.num_aggs)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return indptr.astype(np.int64), order.astype(np.int64)

    def __repr__(self):
        return f"Partition(n={self.n}, num_aggs={self.num_aggs})"


def partition_from_labels(labels, *, num_aggs: int | None = None) -> Partition:
    """Build a Partition from arbitrary (possibly sparse) labels by dense
    re-ranking (host-side)."""
    labels = np.asarray(labels)
    uniq, dense = np.unique(labels, return_inverse=True)
    return Partition.from_numpy(dense.astype(np.int32), int(uniq.size))


def compose(parts: list[Partition], upto: int | None = None) -> Partition:
    """Compose level assignments 0..upto-1 into original-vertex -> coarse-agg."""
    if upto is None:
        upto = len(parts)
    if all(getattr(p, "_host_v2a", None) is not None for p in parts[:upto]):
        h = parts[0]._host_v2a
        for p in parts[1:upto]:
            h = p._host_v2a[h]
        return Partition.from_numpy(h, parts[upto - 1].num_aggs)
    v2a = parts[0].vertex_to_agg
    for p in parts[1:upto]:
        v2a = p.vertex_to_agg[v2a]
    return Partition(v2a, parts[upto - 1].num_aggs)
