"""Multi-chip multilevel refinement: aggregates sharded across the mesh.

The reference's refinement parallelizes over aggregates -- independent local
subproblems (forceAtlasMultilevel, include/forceatlas.hpp:340-341, OpenMP
``parallel for`` over aggregates).  The array equivalent shards
AGGREGATES over the device mesh: within-aggregate repulsion, intra-aggregate
attraction (both endpoints share the aggregate by definition), the
precomputed cut-edge pull, gravity, the swing/speed schedule and the
pack-into-parent-ball epilogue (forceatlas.hpp:539-570) are ALL local to the
device that owns the aggregate.  One refinement iteration therefore needs
ZERO collectives; the only communication in a level is the final read of the
placed coordinates.  This is the scaling design BASELINE.md configs 4/5 need
for the multilevel pipeline (the flat coarsest level rides the edge-sharded
step in parallel/sharded.py).

Layout: device-major slot space.  Aggregates are bucketed into power-of-two
size classes with exactly the single-chip rule (multilevel_tiled.
bucket_size_classes) and dealt contiguously to devices within each bucket.
Every device's local slot space then has IDENTICAL static structure -- same
buckets, same aggregate counts per bucket -- so the whole level runs as ONE
shard_map program; devices that run out of real aggregates in a bucket
carry ghost aggregates (valid=False, weight 0).  Per-aggregate arithmetic
is identical across device counts, so 1-device and N-device embeddings
agree allclose (SURVEY.md SS4 multi-chip contract); the only
reduction-order difference is the order of the per-device edge lists.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from ..partition.interpolation import Partition
from ..utils.params import MultilevelFAParams
from ..ops import spmv as SP
from ..forceatlas.multilevel_tiled import (RefineLayout, bucket_size_classes,
                                           local_degree_and_weights,
                                           refine_iterations_and_place)
from .mesh import EDGE_AXIS


@dataclasses.dataclass(frozen=True)
class ShardedRefineLayout:
    """Host-built per-level layout for the aggregate-sharded refinement.

    All per-slot arrays are GLOBAL [ndev * n_slots_local] (device-major:
    device d owns slots [d*n_slots_local, (d+1)*n_slots_local)), sharded
    with PartitionSpec('x') so each device sees its local slot space.  Edge
    arrays are stacked [ndev, e_max] (LOCAL slot indices, sender-sorted per
    device; pad edges carry weight 0 on the last local slot).
    """

    ndev: int
    n: int                       # fine vertices
    n_slots_local: int           # identical per device
    m_local: int                 # local aggregate count (identical)
    bucket_meta_local: tuple     # static, identical per device
    slot_of_vertex: np.ndarray   # [n] -> global slot
    global_agg_of_slot: np.ndarray  # [ndev*n_slots_local] -> agg id (ghost m)
    agg_of_slot: np.ndarray      # [ndev*n_slots_local] -> LOCAL agg (ghost m_local)
    valid_slot: np.ndarray       # [ndev*n_slots_local] bool
    deg_loc: np.ndarray          # [ndev*n_slots_local] f32
    deg_w_att: np.ndarray        # [ndev*n_slots_local] f32 folded row sums
    senders: np.ndarray          # [ndev, e_max] int32
    receivers: np.ndarray        # [ndev, e_max] int32
    weights: np.ndarray          # [ndev, e_max] f32

    @property
    def n_slots_global(self) -> int:
        return self.ndev * self.n_slots_local


def prepare_refine_sharded(g: Graph, part: Partition,
                           params: MultilevelFAParams, ndev: int, *,
                           min_bucket: int = 8) -> ShardedRefineLayout:
    """Build the device-major slot layout + per-device edge lists."""
    v2a = part.vertex_to_agg_numpy()
    m = part.num_aggs
    n = g.n
    counts = np.bincount(v2a, minlength=m)
    S_of_agg = bucket_size_classes(counts, min_bucket=min_bucket)

    # ---- per-bucket device deal + one shared local plan
    order_a = np.lexsort((np.arange(m), S_of_agg))
    S_in_order = S_of_agg[order_a]
    bucket_meta_local = []
    base = 0
    # per aggregate: owning device and local slot start
    dev_of_agg = np.zeros(m, dtype=np.int64)
    local_start_of_agg = np.zeros(m, dtype=np.int64)
    local_agg_rows = []   # (local_agg_base, S, q, aggregate ids)
    m_local = 0
    i = 0
    while i < m:
        S = int(S_in_order[i])
        j = i
        while j < m and S_in_order[j] == S:
            j += 1
        ids = order_a[i:j]
        q = -(-ids.size // ndev)                      # aggregates per device
        d, rank = np.divmod(np.arange(ids.size), q)
        dev_of_agg[ids] = d
        local_start_of_agg[ids] = base + rank * S
        local_agg_rows.append((m_local, S, q, ids))
        bucket_meta_local.append((int(base), int(q), S))
        m_local += q
        base += q * S
        i = j
    n_slots_local = max(-(-base // 128) * 128, 128)

    # ---- global slot of every vertex (device-major)
    order_v = np.argsort(v2a, kind="stable")
    vstart = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(n) - vstart[v2a[order_v]]
    slot_of_vertex = np.zeros(n, dtype=np.int64)
    slot_of_vertex[order_v] = (dev_of_agg[v2a[order_v]] * n_slots_local
                               + local_start_of_agg[v2a[order_v]] + pos)

    n_glob = ndev * n_slots_local
    global_agg_of_slot = np.full(n_glob, m, dtype=np.int32)
    global_agg_of_slot[slot_of_vertex] = v2a
    # local aggregate id per slot (bucket-local rank within the device);
    # whole S-ranges are labeled -- ghost member slots of a real aggregate
    # carry its id too, so the epilogue's segment ops see one id per range
    agg_of_slot = np.full(n_glob, m_local, dtype=np.int32)
    for (m_agg_base, S, q, ids) in local_agg_rows:
        local_ids = (m_agg_base + np.arange(ids.size) % q).astype(np.int32)
        start = (dev_of_agg[ids] * n_slots_local + local_start_of_agg[ids])
        rows = (start[:, None] + np.arange(S)[None, :]).reshape(-1)
        agg_of_slot[rows] = np.repeat(local_ids, S)

    valid = np.zeros(n_glob, dtype=bool)
    valid[slot_of_vertex] = True

    deg_np, es_, er_, ew_ = local_degree_and_weights(g, v2a, params)
    deg_loc = np.zeros(n_glob, np.float32)
    deg_loc[slot_of_vertex] = deg_np

    # ---- per-device edge lists over the LOCAL slot space
    e_dev = dev_of_agg[v2a[es_]]
    ls = slot_of_vertex[es_] - e_dev * n_slots_local
    lr = slot_of_vertex[er_] - e_dev * n_slots_local
    e_max = int(np.bincount(e_dev, minlength=ndev).max()) if es_.size else 0
    senders = np.full((ndev, e_max), n_slots_local - 1, np.int32)
    receivers = np.zeros((ndev, e_max), np.int32)
    weights = np.zeros((ndev, e_max), np.float32)
    deg_w_att = np.zeros(n_glob, np.float32)
    for d in range(ndev):
        sel = e_dev == d
        order = np.argsort(ls[sel], kind="stable")
        k = int(sel.sum())
        senders[d, :k] = ls[sel][order]
        receivers[d, :k] = lr[sel][order]
        weights[d, :k] = ew_[sel][order]
        deg_w_att[d * n_slots_local:(d + 1) * n_slots_local] = np.bincount(
            ls[sel], weights=ew_[sel].astype(np.float64),
            minlength=n_slots_local)

    return ShardedRefineLayout(
        ndev=ndev, n=n, n_slots_local=int(n_slots_local),
        m_local=int(m_local), bucket_meta_local=tuple(bucket_meta_local),
        slot_of_vertex=slot_of_vertex,
        global_agg_of_slot=global_agg_of_slot, agg_of_slot=agg_of_slot,
        valid_slot=valid, deg_loc=deg_loc, deg_w_att=deg_w_att,
        senders=senders, receivers=receivers, weights=weights)


def make_refine_sharded_step(mesh: Mesh, shl: ShardedRefineLayout, dim: int,
                             params: MultilevelFAParams, iterations: int):
    """Jitted whole-level refinement: shard_map over aggregates, zero
    per-iteration collectives, epilogue included.

    step(coords0[gs,d], valid[gs], deg_loc[gs], agg[gs], global agg[gs],
    deg_w_att[gs],
    senders/receivers/weights [ndev, e_max], pull[gs,d], center[gs,d],
    r_slot[gs], key) -> placed[gs,d], everything slot-sharded with P('x').
    """
    nsl = shl.n_slots_local
    has_edges = shl.senders.shape[1] > 0

    def local_refine(coords0, valid, deg_loc, agg, gagg, deg_w_att, es, er,
                     ew, pull_slot, center_slot, r_slot, key):
        edges = (SP.EdgeList(senders=es[0], receivers=er[0], weights=ew[0],
                             n_pad=nsl) if has_edges else None)
        layout = RefineLayout(
            slot_of_vertex=jnp.zeros(1, jnp.int32),  # unused device-side
            agg_of_slot=agg, sample_id=gagg, valid_slot=valid,
            deg_loc=deg_loc,
            edges=edges, deg_w_att=deg_w_att,
            bucket_meta=shl.bucket_meta_local, n=shl.n, n_slots=nsl,
            num_aggs=shl.m_local)
        # one key on every device: sampled draws are keyed by the global
        # aggregate id, so layouts do not depend on the device count
        return refine_iterations_and_place(
            coords0, layout, pull_slot, center_slot, r_slot, agg,
            shl.m_local, params, iterations, dim, key)

    gs = P(EDGE_AXIS)           # global slot arrays, sharded by device block
    dv = P(EDGE_AXIS)           # [ndev, ...] stacked per-device arrays
    step = jax.shard_map(
        local_refine, mesh=mesh,
        in_specs=(gs, gs, gs, gs, gs, gs, dv, dv, dv, gs, gs, gs, P()),
        out_specs=gs,
        check_vma=False,
    )
    return jax.jit(step)


def refine_level_sharded(g: Graph, part: Partition, coords_A, r_A, dim: int,
                         *, mesh: Mesh, key=None, iterations: int = 100,
                         params: MultilevelFAParams | None = None,
                         layout: ShardedRefineLayout | None = None,
                         coords0=None):
    """Multi-chip drop-in for refine_level_tiled / force_atlas_multilevel
    (forceatlas.hpp:314-574 semantics; called per level by embed's mesh
    path, the src/embed.cpp:786-793 slot of the recursion).

    ``coords0``: optional [n, dim] warm-start member offsets in the local
    aggregate frame.  Random init is drawn per VERTEX (device-count
    invariant), so layouts agree across mesh sizes given the same key."""
    params = params or MultilevelFAParams()
    if key is None:
        key = jax.random.PRNGKey(0)
    ndev = mesh.devices.size
    if layout is None:
        layout = prepare_refine_sharded(g, part, params, ndev)

    from ..forceatlas.multilevel import external_pull

    coords_A = jnp.asarray(coords_A, jnp.float32)
    r_A = jnp.asarray(r_A, jnp.float32)
    pull_v = external_pull(g, part, coords_A, pull=params.pull,
                           eps=params.epsilon)                 # [n, d]
    n_glob = layout.n_slots_global
    sov = jnp.asarray(layout.slot_of_vertex.astype(np.int64))
    pull_slot = jnp.zeros((n_glob, dim), jnp.float32).at[sov].set(
        pull_v.astype(jnp.float32))

    key, init_key = jax.random.split(key)
    if coords0 is None:
        coords0 = jax.random.uniform(init_key, (layout.n, dim),
                                     dtype=jnp.float32, minval=-1.0,
                                     maxval=1.0)
    c0 = jnp.zeros((n_glob, dim), jnp.float32).at[sov].set(
        jnp.asarray(coords0, jnp.float32))

    # per-slot parent centers/radii (ghost aggregates -> row m is 0/1)
    ga = jnp.asarray(layout.global_agg_of_slot.astype(np.int64))
    cA_pad = jnp.concatenate([coords_A, jnp.zeros((1, dim), jnp.float32)], 0)
    rA_pad = jnp.concatenate([r_A, jnp.ones((1,), jnp.float32)], 0)
    center_slot = cA_pad[jnp.minimum(ga, coords_A.shape[0])]
    r_slot = rA_pad[jnp.minimum(ga, coords_A.shape[0])]

    step = make_refine_sharded_step(mesh, layout, dim, params, iterations)
    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P(EDGE_AXIS)))
    placed = step(
        put(c0), put(layout.valid_slot), put(layout.deg_loc),
        put(layout.agg_of_slot), put(layout.global_agg_of_slot),
        put(layout.deg_w_att),
        put(layout.senders), put(layout.receivers), put(layout.weights),
        put(pull_slot), put(center_slot), put(r_slot), key)
    # the ONE communication of the level: re-replicate the placed slots and
    # read them out in vertex order
    placed = jax.device_put(placed, NamedSharding(mesh, P()))
    return placed[sov]
