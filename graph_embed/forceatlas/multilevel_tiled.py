"""Slot-space route for the multilevel refinement (forceAtlasMultilevel).

The portable implementation (multilevel.py) gathers member coordinates
through [m, S] member tables and scatters the forces back.  This module
re-lays the level out in *slot space* instead, so the within-aggregate work
reads contiguous slices:

* aggregates are ordered by (size bucket, id) and each aggregate of bucket
  size-class S_b occupies a contiguous range of S_b slots; ghost slots pad
  each aggregate to exactly S_b (total slots <= 2n);
* within-aggregate repulsion is one batched XLA computation per bucket over
  the [D_PAD, m_b, S_b] view of its slot range -- exact pairs in diff form,
  the sampled estimator past ``sampled_slots_threshold``;
* intra-aggregate attraction is the edge-list SpMV (ops/spmv.py) over the
  slot space (inter-aggregate edges are dropped; the cut-edge pull is the
  usual precomputed vector);
* the epilogue (center / max-norm / pack into parent balls,
  forceatlas.hpp:539-570) is segment ops over slots;
* one host-built permutation maps slots back to vertices at level end.

Semantics match multilevel.ml_forces (same reference citations).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops import spmv as SP
from ..partition.interpolation import Partition
from ..utils.params import MultilevelFAParams
from . import forces as F

D_PAD = SP.D_PAD


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RefineLayout:
    """Slot-space layout of one level (host-built once per level)."""

    slot_of_vertex: jnp.ndarray   # [n] vertex -> slot
    agg_of_slot: jnp.ndarray      # [n_slots] aggregate id (ghosts -> m)
    # [n_slots] GLOBAL aggregate id (keys the sampled estimator, so draws
    # do not depend on where an aggregate lands); = agg_of_slot on one chip
    sample_id: jnp.ndarray
    valid_slot: jnp.ndarray       # [n_slots] bool
    deg_loc: jnp.ndarray          # [n_slots] local degree (ghosts 0)
    edges: object                 # intra-aggregate EdgeList over slots|None
    deg_w_att: jnp.ndarray        # [n_slots] folded-weight row sums
    bucket_meta: tuple            # static: ((base, m_b, S_b),)
    n: int
    n_slots: int
    num_aggs: int

    def tree_flatten(self):
        return ((self.slot_of_vertex, self.agg_of_slot, self.sample_id,
                 self.valid_slot, self.deg_loc, self.edges, self.deg_w_att),
                (self.bucket_meta, self.n, self.n_slots, self.num_aggs))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (slot_of_vertex, agg_of_slot, sample_id, valid_slot, deg_loc, edges,
         deg_w_att) = children
        bucket_meta, n, n_slots, num_aggs = aux
        return cls(slot_of_vertex, agg_of_slot, sample_id, valid_slot,
                   deg_loc, edges, deg_w_att, bucket_meta, n, n_slots,
                   num_aggs)


def bucket_size_classes(counts, *, min_bucket: int = 8):
    """Power-of-two size class per aggregate (>= min_bucket)."""
    return np.maximum(min_bucket,
                      1 << np.ceil(np.log2(np.maximum(counts, 1))
                                   ).astype(np.int64))


def local_degree_and_weights(g: Graph, v2a, params: MultilevelFAParams):
    """Host (numpy): local degree (same-aggregate incident weight incl.
    self-loops, forceatlas.hpp:362-383) and the intra-aggregate edges
    (j != i) with their folded attraction constants.
    Returns (deg_loc [n] float64, s, r, folded)."""
    s, r, w = g.to_coo_numpy()
    both = v2a[s] == v2a[r]
    intra = both & (s != r)
    deg_np = np.zeros(g.n, np.float64)
    np.add.at(deg_np, s[both], w[both] if params.use_weights else 1.0)
    folded = SP.fold_edge_weights(w, deg_np[s],
                                  use_weights=params.use_weights,
                                  delta=params.delta, nohubs=params.nohubs)
    return deg_np, s[intra], r[intra], np.asarray(folded[intra], np.float32)


def prepare_refine(g: Graph, part: Partition, params: MultilevelFAParams,
                   *, min_bucket: int = 8) -> RefineLayout:
    """Build the slot layout + attraction edge list for one level (host)."""
    v2a = part.vertex_to_agg_numpy()
    m = part.num_aggs
    n = g.n
    counts = np.bincount(v2a, minlength=m)

    # bucket size classes (power of two >= min_bucket); aggregates ordered
    # by (bucket, id), each bucket one contiguous slot range
    S_of_agg = bucket_size_classes(counts, min_bucket=min_bucket)
    order_a = np.lexsort((np.arange(m), S_of_agg))
    bucket_meta = []
    base = 0
    slot_start = np.zeros(m, dtype=np.int64)
    S_in_order = S_of_agg[order_a]
    i = 0
    while i < m:
        S = int(S_in_order[i])
        j = i
        while j < m and S_in_order[j] == S:
            j += 1
        slot_start[order_a[i:j]] = base + np.arange(j - i) * S
        bucket_meta.append((int(base), int(j - i), S))
        base += (j - i) * S
        i = j
    n_slots = max(-(-base // 128) * 128, 128)

    # vertex -> slot
    order_v = np.argsort(v2a, kind="stable")
    vstart = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(n) - vstart[v2a[order_v]]
    slot_of_vertex = np.zeros(n, dtype=np.int64)
    slot_of_vertex[order_v] = slot_start[v2a[order_v]] + pos

    agg_of_slot = np.full(n_slots, m, dtype=np.int32)
    agg_of_slot[slot_of_vertex] = v2a
    valid = np.zeros(n_slots, dtype=bool)
    valid[slot_of_vertex] = True

    deg_np, s, r, folded = local_degree_and_weights(g, v2a, params)
    edges, deg_w_att = None, np.zeros(n_slots, np.float32)
    if s.size:
        edges, deg_w_att = SP.build_edge_list(
            slot_of_vertex[s], slot_of_vertex[r], folded, n_slots)
    deg_loc = np.zeros(n_slots, np.float32)
    deg_loc[slot_of_vertex] = deg_np

    agg_of_slot = jnp.asarray(agg_of_slot)
    return RefineLayout(
        slot_of_vertex=jnp.asarray(slot_of_vertex.astype(np.int32)),
        agg_of_slot=agg_of_slot,
        sample_id=agg_of_slot,
        valid_slot=jnp.asarray(valid),
        deg_loc=jnp.asarray(deg_loc),
        edges=edges,
        deg_w_att=jnp.asarray(deg_w_att),
        bucket_meta=tuple(bucket_meta),
        n=n, n_slots=int(n_slots), num_aggs=m)


def bucket_repulsion(xT_deg, layout: RefineLayout, repel: float, eps: float,
                     *, dim: int = 3, key=None, num_samples: int = 256,
                     sampled_threshold: int = 0):
    """[D_PAD, n_slots] within-aggregate repulsion in slot space.

    ``xT_deg``: [D_PAD, n_slots] with coords in rows 0..d-1 and deg_loc in
    row D_PAD-1 (ghost slots carry -1 there: the validity mask).

    Buckets whose size class S reaches ``sampled_threshold`` (> 0, and a
    ``key`` is given) use the unbiased negative-sampling estimator of
    forces.repulsion_sampled restricted to each aggregate, instead of the
    exact O(S^2) sum -- snowballed aggregates otherwise dominate the level
    (thousands of slots each; sampling at 256 partners is ~20x less)."""
    n_slots = layout.n_slots
    out = jnp.zeros((D_PAD, n_slots), jnp.float32)
    for (base, m_b, S) in layout.bucket_meta:
        width = m_b * S
        seg3 = xT_deg[:, base: base + width].reshape(D_PAD, m_b, S)
        if (sampled_threshold > 0 and S >= sampled_threshold
                and key is not None):
            # members are packed from offset 0: the first slot of each
            # aggregate range carries its id
            ids = layout.sample_id[base: base + width].reshape(m_b, S)[:, 0]
            res = _bucket_repulsion_sampled(seg3, key, ids, num_samples,
                                            repel, eps, dim)
        elif m_b * S * S * 4 <= 512 << 20:
            # one batched pass while the [m_b, S, S] interaction stays
            # modest (<= 512 MiB); compile size O(1)
            res = _diff_batch_xla(seg3, repel, eps, dim)
        elif S <= 512:
            # many medium aggregates past the byte budget: lax.map over
            # LARGE slices of the aggregate axis -- a per-aggregate map
            # would run hundreds of thousands of sequential steps
            res = _diff_batch_sliced(seg3, repel, eps, dim)
        else:
            res = _diff_blocked_xla(seg3, dim, repel, eps)
        out = out.at[:, base: base + width].set(res.reshape(D_PAD, width))
    return out


def _diff_batch_xla(x3, repel: float, eps: float, dim: int):
    """Exact within-aggregate repulsion in diff form.  x3: [D_PAD, m, S]
    (coords rows 0..dim-1, deg/validity row D_PAD-1).  Every pair term is
    computed from coordinate differences -- the gram identity
    |x|^2 + |y|^2 - 2 x.y cancels on near pairs -- so the result keeps full
    f32 accuracy at any matmul precision setting."""
    dval = x3[D_PAD - 1]
    valid = dval >= 0.0
    w = jnp.where(valid, dval + 1.0, 0.0)                    # [m, S]
    y = jnp.where(valid[None], x3[:dim], 0.0)                # [dim, m, S]
    diff = y[:, :, :, None] - y[:, :, None, :]               # [dim, m, S, T]
    dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=0)), eps)
    W = w[:, None, :] / (dist * dist * dist)                 # [m, S, T]
    S = x3.shape[-1]
    eye = jnp.eye(S, dtype=bool)
    W = jnp.where(eye[None] | ~valid[:, None, :], 0.0, W)
    f = jnp.sum(W[None] * diff, axis=-1)                     # [dim, m, S]
    f = jnp.where(valid[None], (repel * w)[None] * f, 0.0)
    return jnp.pad(f, ((0, D_PAD - dim), (0, 0), (0, 0)))


def _bucket_repulsion_sampled(x3, key, agg_ids, num_samples: int,
                              repel: float, eps: float, dim: int):
    """Per-aggregate negative-sampling repulsion estimator over one bucket.

    x3: [D_PAD, m_b, S] slot block (coords rows 0..dim-1, deg/validity row
    D_PAD-1).  Members are packed at offsets [0, cnt_b) of each aggregate's
    range (prepare_refine), so sampling offset = floor(u * cnt_b) draws
    uniformly from the aggregate's members; the estimator and its self-pair
    masking follow forces.repulsion_sampled with n := cnt_b per aggregate.
    Each aggregate's draws come from ``key`` folded with its id in
    ``agg_ids`` [m_b], so they do not depend on the layout (device count,
    bucket position)."""
    d_pad, m_b, S = x3.shape
    K = num_samples
    dval = x3[D_PAD - 1]                                     # [m_b, S]
    valid = dval >= 0.0
    cnt = jnp.sum(valid, axis=-1)                            # [m_b]
    w_i = jnp.where(valid, dval + 1.0, 0.0)
    y = jnp.where(valid[None], x3[:dim], 0.0)                # [dim, m_b, S]

    u = jax.vmap(lambda a: jax.random.uniform(jax.random.fold_in(key, a),
                                              (K,)))(agg_ids)
    idx = jnp.minimum((u * cnt[:, None]).astype(jnp.int32),
                      jnp.maximum(cnt[:, None] - 1, 0))      # [m_b, K]
    take = jnp.broadcast_to(idx[None], (dim, m_b, K))
    ys = jnp.take_along_axis(y, take, axis=2)                # [dim, m_b, K]
    dval_s = jnp.take_along_axis(dval, idx, axis=1)          # [m_b, K]
    w_s = dval_s + 1.0                                       # samples valid

    diff = y[:, :, :, None] - ys[:, :, None, :]              # [dim, m_b, S, K]
    dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=0)), eps)
    W = w_s[:, None, :] / (dist * dist * dist)               # [m_b, S, K]
    own = jax.lax.broadcasted_iota(jnp.int32, (m_b, S, 1), 1)
    W = jnp.where(idx[:, None, :] == own, 0.0, W)
    f = jnp.sum(W[None] * diff, axis=-1)                     # [dim, m_b, S]
    scale = (cnt.astype(jnp.float32) / K)[None, :, None]
    f = (repel * w_i)[None] * f * scale
    out = jnp.zeros((D_PAD, m_b, S), jnp.float32)
    return out.at[:dim].set(jnp.where(valid[None], f, 0.0))


def _diff_batch_sliced(x3, repel: float, eps: float, dim: int,
                       max_bytes: int = 256 << 20):
    """_diff_batch_xla over slices of the aggregate axis: [d, m, S] split
    into ceil(m/per) slices with per*S*S*4 <= max_bytes, mapped with
    lax.map (one trace, few large steps).  Ghost-padded slices contribute
    nothing (dval = -1 -> weight 0 on both sides)."""
    d, m, S = x3.shape
    per = max(1, max_bytes // (S * S * 4))
    k = -(-m // per)
    pad = k * per - m
    if pad:
        ghost = jnp.zeros((d, pad, S), x3.dtype).at[D_PAD - 1].set(-1.0)
        x3 = jnp.concatenate([x3, ghost], axis=1)
    sl = jnp.moveaxis(x3.reshape(d, k, per, S), 1, 0)      # [k, d, per, S]
    res = jax.lax.map(lambda seg: _diff_batch_xla(seg, repel, eps, dim), sl)
    return jnp.moveaxis(res, 0, 1).reshape(d, k * per, S)[:, :m]


def _diff_blocked_xla(x3, dim: int, repel: float, eps: float,
                      block: int = 1024):
    """Giant-aggregate repulsion, exact and in diff form: per aggregate,
    row blocks of ``block`` members against all S members (an [S, S]
    interaction tensor would be gigabytes).  x3: [D_PAD, m, S].

    ``lax.map`` over aggregates and row blocks traces the body ONCE: power-
    law levels have hundreds of oversize aggregates, and a Python loop
    would inline (and compile) each of them."""
    d_pad, m, S = x3.shape
    block = min(block, S)
    nb = -(-S // block)

    def one(seg):                                      # seg: [D_PAD, S]
        dval = seg[D_PAD - 1]
        valid = dval >= 0.0
        w = jnp.where(valid, dval + 1.0, 0.0)
        y = jnp.where(valid[None], seg[:dim], 0.0)     # [dim, S]
        cols = jnp.arange(S)
        yb = jnp.pad(y, ((0, 0), (0, nb * block - S))).reshape(
            dim, nb, block)

        def rows(i):
            r = i * block + jnp.arange(block)
            return F.sampled_repulsion_sum(yb[:, i], r, y, w, cols, eps)

        f = jnp.moveaxis(jax.lax.map(rows, jnp.arange(nb)), 0, 1)
        f = f.reshape(dim, nb * block)[:, :S]
        f = jnp.where(valid[None], (repel * w)[None] * f, 0.0)
        return jnp.pad(f, ((0, D_PAD - dim), (0, 0)))

    return jnp.moveaxis(jax.lax.map(one, jnp.moveaxis(x3, 1, 0)), 0, 1)


def refine_forces(coords, layout: RefineLayout, pull_slot,
                  params: MultilevelFAParams, dim: int, key=None):
    """Total per-slot force of one refinement iteration (slot space);
    semantics of multilevel.ml_forces (forceatlas.hpp:390-475).  ``key``
    enables the sampled estimator for oversize buckets (see
    bucket_repulsion); without one, repulsion is exact everywhere."""
    n_slots = layout.n_slots
    eps = params.epsilon
    valid = layout.valid_slot
    deg_p1 = layout.deg_loc + 1.0
    # pack coords + deg into one [D_PAD, n_slots] stream for repulsion
    xT = jnp.zeros((D_PAD, n_slots), jnp.float32)
    xT = xT.at[:dim, :].set(coords.T)
    xT_deg = xT.at[D_PAD - 1, :].set(jnp.where(valid, layout.deg_loc, -1.0))
    repT = bucket_repulsion(xT_deg, layout, params.repel, eps, dim=dim,
                            key=key,
                            num_samples=params.num_negative_samples,
                            sampled_threshold=params.sampled_slots_threshold)
    rep = repT[:dim, :].T
    att = jnp.zeros_like(coords)
    if layout.edges is not None:
        # intra-aggregate attraction: edge-list SpMV over slots
        y = SP.spmv_T(xT, layout.edges, dim)[:dim].T
        att = params.attract * (y - coords * layout.deg_w_att[:, None])
    mag = jnp.maximum(jnp.sqrt(jnp.sum(coords * coords, axis=1)), eps)
    ext = pull_slot / mag[:, None]
    grav = -(coords / mag[:, None]) * (params.gravity * deg_p1)[:, None]
    f = rep + att + ext + grav
    return jnp.where(valid[:, None], f, 0.0)


def refine_level_tiled(g: Graph, part: Partition, coords_A, r_A, dim: int,
                       *, key=None, iterations: int = 100,
                       params: MultilevelFAParams | None = None,
                       layout: RefineLayout | None = None, coords0=None):
    """Drop-in for multilevel.force_atlas_multilevel over slot space.

    ``coords0``: optional [n, dim] warm-start member offsets in the local
    aggregate frame (same contract as force_atlas_multilevel)."""
    params = params or MultilevelFAParams()
    if key is None:
        key = jax.random.PRNGKey(0)
    if layout is None:
        layout = prepare_refine(g, part, params)

    # per-slot external pull (cut edges), computed once in slot space
    from .multilevel import external_pull

    pull_v = external_pull(g, part, jnp.asarray(coords_A), pull=params.pull,
                           eps=params.epsilon)              # [n, d] vertex
    pull_slot = jnp.zeros((layout.n_slots, dim), jnp.float32).at[
        layout.slot_of_vertex].set(pull_v.astype(jnp.float32))

    key, rep_key = jax.random.split(key)
    if coords0 is None:
        coords0 = jax.random.uniform(key, (layout.n_slots, dim),
                                     dtype=jnp.float32, minval=-1.0,
                                     maxval=1.0)
    else:
        coords0 = jnp.zeros((layout.n_slots, dim), jnp.float32).at[
            layout.slot_of_vertex].set(jnp.asarray(coords0, jnp.float32))
    coords0 = jnp.where(layout.valid_slot[:, None], coords0, 0.0)

    out_slots = _refine_loop(coords0, layout, pull_slot,
                             jnp.asarray(coords_A, jnp.float32),
                             jnp.asarray(r_A, jnp.float32), params,
                             iterations, dim, rep_key)
    return out_slots[layout.slot_of_vertex]


def refine_iterations_and_place(coords0, layout: RefineLayout, pull_slot,
                                center_slot, r_slot, agg, num_aggs: int,
                                params: MultilevelFAParams, iterations: int,
                                dim: int, rep_key):
    """The refinement loop plus the slot-space epilogue
    (forceatlas.hpp:539-570): center per aggregate, scale by the max member
    norm, pack into the parent ball.  ``agg`` [n_slots] labels each slot's
    aggregate in [0, num_aggs] (num_aggs = ghost); ``center_slot`` and
    ``r_slot`` are the parent center and radius of each slot."""
    eps = params.epsilon
    deg_p1 = layout.deg_loc + 1.0
    valid = layout.valid_slot

    def body(i, carry):
        coords, fprev = carry
        key_i = (jax.random.fold_in(rep_key, i)
                 if rep_key is not None else None)
        f = refine_forces(coords, layout, pull_slot, params, dim, key=key_i)
        new_coords = F.speed_update(coords, f, fprev, deg_p1, ks=params.ks,
                                    ksmax=params.ksmax,
                                    tolerate=params.tolerate,
                                    swing_clamp_eps=eps)
        new_coords = jnp.where(valid[:, None], new_coords, coords)
        return new_coords, f

    fprev = jnp.zeros_like(coords0)
    coords, _ = jax.lax.fori_loop(0, iterations, body, (coords0, fprev))

    ones = jnp.where(valid, 1.0, 0.0)
    cnt = jax.ops.segment_sum(ones, agg, num_segments=num_aggs + 1)
    mean = jax.ops.segment_sum(
        jnp.where(valid[:, None], coords, 0.0), agg,
        num_segments=num_aggs + 1) / jnp.maximum(cnt, 1.0)[:, None]
    centered = coords - mean[agg]
    norms = jnp.where(valid, jnp.sqrt(jnp.sum(centered * centered, axis=1)),
                      0.0)
    mx = jax.ops.segment_max(norms, agg, num_segments=num_aggs + 1)
    mx = jnp.maximum(mx, eps)
    placed = center_slot + (r_slot / mx[agg])[:, None] * centered
    return jnp.where(valid[:, None], placed, 0.0)


@partial(jax.jit, static_argnames=("params", "iterations", "dim"))
def _refine_loop(coords0, layout: RefineLayout, pull_slot, coords_A, r_A,
                 params: MultilevelFAParams, iterations: int, dim: int,
                 rep_key=None):
    mm = layout.num_aggs
    agg_c = jnp.clip(layout.agg_of_slot, 0, mm - 1)
    return refine_iterations_and_place(
        coords0, layout, pull_slot, coords_A[agg_c], r_A[agg_c],
        layout.agg_of_slot, mm, params, iterations, dim, rep_key)
