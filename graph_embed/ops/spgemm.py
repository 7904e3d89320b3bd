"""Galerkin triple product  A_c = P^T A P  as relabel + sort + segment-sum.

Array replacement for the two SpGEMMs of the reference
(examples/embed.cpp:95-98, embedder.cpp:213-216:
``As[l+1] = P_T.Mult(As[l]).Mult(P_T.Transpose())``).

Because P is an aggregation matrix (one 1 per row of P / column of P^T,
interpolationMatrix at src/partitioner.cpp:29-65), the triple product reduces
to mapping every edge (i, j, w) through the vertex->aggregate assignment and
summing duplicates:  (A_c)_{ab} = sum_{(i,j): agg(i)=a, agg(j)=b} w_ij.
That's a gather + 64-bit-key sort + segment boundary sum -- no general SpGEMM
needed, and the result is *exactly* the reference product (same additions,
reordered).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.csr import Graph, from_edges


def coarsen_graph(g: Graph, vertex_to_agg, num_aggs: int, *,
                  pad_multiple: int = 128) -> Graph:
    """A_c = P^T A P given the vertex->aggregate map (host-boundary wrapper).

    The heavy lifting (relabel/sort/sum) runs device-side; the final repack to
    the tight coarse capacity is a host step between levels, per SURVEY.md SS7
    hard-part #1 (no shape change inside jit).
    """
    s, r, w = g.to_coo_numpy()
    v2a = np.asarray(vertex_to_agg)
    return from_edges(v2a[s], v2a[r], w, n=int(num_aggs), dtype=g.dtype,
                      pad_multiple=pad_multiple)


def coarsen_graph_device(g: Graph, vertex_to_agg, num_aggs: int, *,
                         pad_multiple: int = 128) -> Graph:
    """A_c = P^T A P entirely on device (device-resident Galerkin).

    Device-first counterpart of :func:`coarsen_graph` for pipelines whose
    graph never lives on the host: the relabel + sort + duplicate-sum runs as
    one jitted program, the coarse CSR indptr is a device ``searchsorted``,
    and the only host traffic is ONE scalar readback (the live coarse edge
    count, needed because ``Graph.num_edges`` is static).  The result carries
    no host COO cache -- ``to_coo_numpy`` on it would pull the whole edge
    list from the device; use :func:`coarsen_graph` when the fine graph
    already has a host copy.
    """
    m = int(num_aggs)
    ns, nr, nw = jax.jit(coarsen_coo_device, static_argnums=(4,))(
        g.senders, g.receivers, g.weights, jnp.asarray(vertex_to_agg), m)
    e = int(jnp.sum(ns < m))  # the one host sync (a scalar)
    cap = max(-(-max(e, 1) // pad_multiple) * pad_multiple, pad_multiple)
    E = int(ns.shape[0])
    if cap <= E:
        # dead slots sort last ((m, m) keys), so a static prefix slice keeps
        # exactly the live entries plus ghost padding
        ns, nr, nw = ns[:cap], nr[:cap], nw[:cap]
    else:
        ns = jnp.pad(ns, (0, cap - E), constant_values=m)
        nr = jnp.pad(nr, (0, cap - E), constant_values=m)
        nw = jnp.pad(nw, (0, cap - E))
    indptr = jnp.searchsorted(ns, jnp.arange(m + 1)).astype(jnp.int32)
    return Graph(indptr=indptr, senders=ns.astype(jnp.int32),
                 receivers=nr.astype(jnp.int32), weights=nw,
                 n=m, num_edges=e)


def coarsen_coo_device(senders, receivers, weights, vertex_to_agg, num_aggs_cap: int):
    """Device-side edge relabel + duplicate-sum at fixed capacity.

    Inputs are edge arrays of capacity E (ghost sender >= n on padding with
    weight 0).  Returns (new_senders, new_receivers, new_weights) of the same
    capacity E where duplicates are summed, dead slots have sender=receiver=
    ``num_aggs_cap`` and weight 0, and entries are sorted by (sender, receiver).
    Fully jittable; used inside the coarsener's contraction step.
    """
    E = senders.shape[0]
    nv = vertex_to_agg.shape[0]
    s = vertex_to_agg[jnp.clip(senders, 0, nv - 1)].astype(jnp.int32)
    r = vertex_to_agg[jnp.clip(receivers, 0, nv - 1)].astype(jnp.int32)
    dead = (weights == 0) | (senders >= nv)
    s = jnp.where(dead, num_aggs_cap, s)
    r = jnp.where(dead, num_aggs_cap, r)
    # lexicographic (s, r) sort via two stable passes -- avoids 64-bit keys,
    # which silently truncate without x64
    order1 = jnp.argsort(r, stable=True)
    order2 = jnp.argsort(s[order1], stable=True)
    order = order1[order2]
    s_s, r_s, w_s = s[order], r[order], weights[order]
    is_new = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), (s_s[1:] != s_s[:-1]) | (r_s[1:] != r_s[:-1])]
    )
    seg = jnp.cumsum(is_new) - 1  # [E] group index, in sorted order
    w_sum = jax.ops.segment_sum(w_s, seg, num_segments=E)
    heads = jnp.nonzero(is_new, size=E, fill_value=E - 1)[0]
    ns, nr, nw = s_s[heads], r_s[heads], w_sum
    ngroups = jnp.sum(is_new)
    keep = (jnp.arange(E) < ngroups) & (ns < num_aggs_cap)
    ns = jnp.where(keep, ns, num_aggs_cap)
    nr = jnp.where(keep, nr, num_aggs_cap)
    nw = jnp.where(keep, nw, 0)
    return ns, nr, nw
