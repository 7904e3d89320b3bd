"""Generic/pluggable multilevel embedding.

Array equivalents of ``anyToMultilevel`` (src/embed.cpp:23-83),
``embedVia`` (:85-106) and ``embedViaMultilevel`` (:108-335).

``any_to_multilevel`` wraps any flat ``(graph, dim) -> coords`` embedder into
the multilevel building-block signature: per aggregate, the induced subgraph
is extracted with unit entry weights (the reference adds 1.0 per stored
entry, embed.cpp:62), embedded flat, normalized by max norm (no centering,
:67-74) and placed at ``coords_A[a] + r_A[a] * x / max`` (:75-79).

Reference quirk preserved (SURVEY.md row embedVia): the recursion for coarse
levels calls the *ForceAtlas* multilevel driver (embed.cpp:144 recurses into
``embedMultilevel``, not itself), so the supplied embedder only acts on the
finest level; the base case wraps everything in one aggregate over the unit
ball (:121-138).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph, from_edges
from ..partition.interpolation import Partition
from ..utils.params import ForceAtlasParams, MultilevelFAParams


def any_to_multilevel(flat_embedder):
    """(graph, dim) -> coords   =>   multilevel building block
    (A, part, coords_A, r_A, dim, key) -> coords  (src/embed.cpp:23-83)."""

    def block(g: Graph, part: Partition, coords_A, r_A, dim, key=None):
        s, r, _ = g.to_coo_numpy()
        v2a = part.vertex_to_agg_numpy()
        coords = np.zeros((g.n, dim), dtype=np.asarray(coords_A).dtype)
        cA = np.asarray(coords_A)
        rA = np.asarray(r_A)
        indptr, order = part.members_csr()
        if key is None:
            key = jax.random.PRNGKey(0)
        for a in range(part.num_aggs):
            v = order[indptr[a]:indptr[a + 1]]
            local = {int(g_id): i for i, g_id in enumerate(v)}
            keep = (v2a[s] == a) & (v2a[r] == a)
            ls = np.array([local[int(x)] for x in s[keep]], dtype=np.int64)
            lr = np.array([local[int(x)] for x in r[keep]], dtype=np.int64)
            sub = from_edges(ls, lr, np.ones(ls.size), n=len(v),
                             dtype=g.dtype)
            key, subkey = jax.random.split(key)
            new_coords = np.asarray(flat_embedder(sub, dim, key=subkey))
            mx = np.sqrt((new_coords ** 2).sum(axis=1)).max()
            if mx <= 0:
                mx = 1.0
            coords[v] = cA[a][None, :] + rA[a] * (new_coords / mx)
        return jnp.asarray(coords)

    return block


def embed_via(graphs: list[Graph], parts: list[Partition], dim: int,
              embedder_block, *, key=None,
              base_params: ForceAtlasParams | None = None,
              refine_params: MultilevelFAParams | None = None,
              base_iterations: int | None = None,
              refine_iterations: int = 100):
    """Generic multilevel embed (src/embed.cpp:85-106 + :108-335).

    ``embedder_block`` has the building-block signature produced by
    :func:`any_to_multilevel`.  Coarse levels run the standard ForceAtlas
    recursion (reference quirk at embed.cpp:144); the custom block is applied
    at the finest level only.
    """
    from .driver import embed, validate_hierarchy

    validate_hierarchy(graphs, parts)
    if key is None:
        key = jax.random.PRNGKey(0)
    k = len(parts)
    if k == 0:
        # base case: one aggregate, unit ball at the origin (:121-138)
        part = Partition(jnp.zeros(graphs[0].n, jnp.int32), 1)
        coords_A = jnp.zeros((1, dim), graphs[0].dtype)
        r_A = jnp.ones(1, graphs[0].dtype)
        return embedder_block(graphs[0], part, coords_A, r_A, dim, key=key)

    return embed(graphs, parts, dim, key=key, base_params=base_params,
                 refine_params=refine_params,
                 base_iterations=base_iterations,
                 refine_iterations=refine_iterations,
                 final_block=embedder_block)
