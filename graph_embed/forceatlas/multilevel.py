"""Per-aggregate ForceAtlas refinement -- the multilevel prolongation kernel.

Array re-design of ``forceAtlasMultilevel`` (include/forceatlas.hpp:
314-574).  The reference OpenMP-parallelizes over aggregates, each an
independent local layout.  Here the refinement runs as ONE global jitted
iteration over all vertices simultaneously:

* repulsion is only ever computed *within* an aggregate (forceatlas.hpp:
  394-410) -> batched masked pairwise blocks over [num_aggs, S, S], scanned
  in aggregate chunks to bound memory, gram-matmul shaped;
* intra-aggregate attraction (:415-450) is a global edge gather/segment-sum
  restricted to edges with both endpoints in the same aggregate (and j != i);
* the cut-edge pull (:451-466) -- constant magnitude ``pull`` toward the
  *other aggregate's parent center*, scaled by 1/|x_i| -- depends only on the
  (fixed) parent centers, so the per-vertex pull vector is precomputed once
  per level and divided by |x_i| each iteration;
* local degree counts only same-aggregate edge weight incl. self-loops
  (:362-383); gravity and the pull scale use |x_i| clamped at epsilon
  (:411-414); swing is clamped at epsilon (:484);
* epilogue (:539-570): members are centered, scaled by the max norm (clamped
  eps), and placed at coords_A[a] + r_A[a] * x / max -- segment ops.

Members are re-randomized in [-1, 1]^d at entry (:356-360): the reference's
prolongation is re-randomize-inside-the-parent-ball, not interpolation
(SURVEY.md SS3.4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..partition.interpolation import Partition
from ..utils.params import MultilevelFAParams
from . import forces as F


def build_members(part: Partition, *, pad_multiple: int = 8):
    """[m, S] member table (host): row a lists the global vertex ids of
    aggregate a, padded with n.  S is the max aggregate size rounded up."""
    v2a = part.vertex_to_agg_numpy()
    m = part.num_aggs
    n = v2a.shape[0]
    order = np.argsort(v2a, kind="stable")
    counts = np.bincount(v2a, minlength=m)
    S = int(counts.max()) if counts.size else 1
    S = max(((S + pad_multiple - 1) // pad_multiple) * pad_multiple, pad_multiple)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(n) - starts[v2a[order]]
    members = np.full((m, S), n, dtype=np.int64)
    members[v2a[order], pos] = order
    return jnp.asarray(members.astype(np.int32))


def build_member_buckets(part: Partition, *, pad_multiple: int = 8):
    """Size-bucketed member tables (SURVEY.md SS2.2: ragged aggregate sizes
    handled by bucketing/padding).  Aggregates are grouped into power-of-two
    size classes so one snowballed aggregate cannot inflate the padding of
    the thousands of small ones; returns a tuple of [m_b, S_b] arrays."""
    v2a = part.vertex_to_agg_numpy()
    m = part.num_aggs
    n = v2a.shape[0]
    order = np.argsort(v2a, kind="stable")
    counts = np.bincount(v2a, minlength=m)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(n) - starts[v2a[order]]
    full = np.full((m, max(int(counts.max()), 1)), n, dtype=np.int64)
    full[v2a[order], pos] = order

    buckets = []
    cap = pad_multiple
    remaining = np.arange(m)
    sizes = counts
    while remaining.size:
        in_b = remaining[sizes[remaining] <= cap]
        remaining = remaining[sizes[remaining] > cap]
        if in_b.size:
            w = min(cap, full.shape[1])
            w_pad = ((w + pad_multiple - 1) // pad_multiple) * pad_multiple
            arr = np.full((in_b.size, w_pad), n, dtype=np.int64)
            arr[:, :w] = full[in_b, :w]
            buckets.append(jnp.asarray(arr.astype(np.int32)))
        cap *= 2
    if not buckets:
        buckets.append(jnp.asarray(np.full((1, pad_multiple), n, np.int32)))
    return tuple(buckets)


def local_degrees(g: Graph, part: Partition, use_weights: bool):
    """deg_i = same-aggregate incident edge weight, self-loops included
    (forceatlas.hpp:362-383)."""
    n = g.n
    v2a = part.vertex_to_agg
    sc = jnp.clip(g.senders, 0, n - 1)
    rc = jnp.clip(g.receivers, 0, n - 1)
    same = (v2a[sc] == v2a[rc]) & g.edge_mask
    val = g.weights if use_weights else jnp.ones_like(g.weights)
    val = jnp.where(same, val, 0)
    seg = jnp.where(g.senders < n, g.senders, n)
    return jax.ops.segment_sum(val, seg, num_segments=n + 1)[:n]


def external_pull(g: Graph, part: Partition, coords_A, *, pull: float,
                  eps: float):
    """Per-vertex precomputed cut-edge pull vector (forceatlas.hpp:451-466):
    P_i = sum over stored entries (i, j) with agg(j) != agg(i) of
    pull * (c_{agg j} - c_{agg i}) / max(|c_{agg j} - c_{agg i}|, eps).
    (Self-loops fall in the reference's external branch but contribute 0.)"""
    n = g.n
    d = coords_A.shape[1]
    v2a = part.vertex_to_agg
    sc = jnp.clip(g.senders, 0, n - 1)
    rc = jnp.clip(g.receivers, 0, n - 1)
    a_s = v2a[sc]
    a_r = v2a[rc]
    # unrolled over the coordinate axis: every temporary is a flat [E]
    # vector, so no layout pads the trailing d = 3
    diff_k = [coords_A[:, k][a_r] - coords_A[:, k][a_s] for k in range(d)]
    d2 = diff_k[0] * diff_k[0]
    for k in range(1, d):
        d2 = d2 + diff_k[k] * diff_k[k]
    dist = jnp.maximum(jnp.sqrt(d2), eps)
    ext = (a_s != a_r) & g.edge_mask
    scale = jnp.where(ext, pull / dist, 0.0)
    seg = jnp.where(g.senders < n, g.senders, n)
    cols = [jax.ops.segment_sum(diff_k[k] * scale, seg,
                                num_segments=n + 1)[:n] for k in range(d)]
    return jnp.stack(cols, axis=1)


def _agg_repulsion_chunk(members_chunk, coords, deg_loc_p1, repel, eps, n,
                         exact: bool = False):
    """Masked within-aggregate pairwise repulsion for a chunk of aggregates.

    members_chunk: [B, S]; returns per-member forces [B, S, d].  ``exact``
    uses per-pair differences (oracle-parity); default is the gram form.
    """
    mem = jnp.clip(members_chunk, 0, n - 1)
    valid = members_chunk < n                                  # [B, S]
    y = coords[mem]                                            # [B, S, d]
    w = jnp.where(valid, deg_loc_p1[mem], 0.0)                 # [B, S]
    S = members_chunk.shape[1]
    eye = jnp.eye(S, dtype=bool)
    if exact:
        diff = y[:, :, None, :] - y[:, None, :, :]             # [B, S, S, d]
        dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, -1)), eps)
        W = w[:, None, :] / (dist * dist * dist)
        W = jnp.where(eye[None] | ~valid[:, None, :], 0.0, W)
        f = jnp.einsum("bstd,bst->bsd", diff, W,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        sq = jnp.sum(y * y, axis=-1)                           # [B, S]
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * jnp.einsum(
            "bsd,btd->bst", y, y,
            precision=jax.lax.Precision.HIGHEST)           # see forces.py cancellation note
        dist = jnp.maximum(jnp.sqrt(jnp.maximum(d2, 0.0)), eps)
        W = w[:, None, :] / (dist * dist * dist)               # [B, S, S]
        W = jnp.where(eye[None] | ~valid[:, None, :], 0.0, W)
        f = y * jnp.sum(W, axis=-1, keepdims=True) - jnp.einsum(
            "bst,btd->bsd", W, y,
            precision=jax.lax.Precision.HIGHEST)           # cancellation, see forces.py
    f = (repel * w)[:, :, None] * f
    return jnp.where(valid[:, :, None], f, 0.0)


def aggregate_repulsion(coords, members, deg_loc_p1, repel, eps,
                        *, chunk: int = 256, exact: bool = False):
    """[n, d] within-aggregate repulsion.  ``members`` is either one
    [m, S] table or a tuple of size-bucketed tables (build_member_buckets);
    each table is scanned in aggregate chunks sized so chunk*S^2 stays
    bounded."""
    n, d = coords.shape
    if not isinstance(members, (tuple, list)):
        members = (members,)
    out0 = jnp.zeros((n + 1, d), coords.dtype)

    for table in members:
        m, S = table.shape
        c = max(8, min(chunk, 2_000_000 // max(S * S, 1)))
        nb = -(-m // c)
        pad = nb * c - m
        mem_p = jnp.pad(table, ((0, pad), (0, 0)), constant_values=n)
        mem_b = mem_p.reshape(nb, c, S)

        def body(carry, mem_chunk):
            f = _agg_repulsion_chunk(mem_chunk, coords, deg_loc_p1, repel,
                                     eps, n, exact=exact)
            # each vertex belongs to exactly one aggregate -> no collisions
            flat_idx = jnp.where(mem_chunk < n, mem_chunk, n).reshape(-1)
            carry = carry.at[flat_idx].add(f.reshape(-1, f.shape[-1]),
                                           mode="drop")
            return carry, None

        out0, _ = jax.lax.scan(body, out0, mem_b)
    return out0[:n]


def ml_forces(coords, g: Graph, part: Partition, members, deg_loc, pull_vec,
              params: MultilevelFAParams):
    """Total per-vertex force of one multilevel refinement iteration
    (forceatlas.hpp:390-475)."""
    n = g.n
    eps = params.epsilon
    deg_p1 = deg_loc + 1.0
    rep = aggregate_repulsion(coords, members, deg_p1, params.repel, eps,
                              exact=(params.repulsion == "exact"))

    # intra-aggregate attraction over stored entries with j != i (:415-450)
    v2a = part.vertex_to_agg
    sc = jnp.clip(g.senders, 0, n - 1)
    rc = jnp.clip(g.receivers, 0, n - 1)
    intra = (v2a[sc] == v2a[rc]) & (g.senders != g.receivers) & g.edge_mask
    xs, xr = coords[sc], coords[rc]
    diff = xr - xs
    dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=-1)), eps)
    fa = F.attraction_fa(dist, g.weights, deg_p1[sc], linlog=params.linlog,
                         delta=params.delta, nohubs=params.nohubs,
                         use_weights=params.use_weights)
    per_edge = jnp.where(intra[:, None],
                         diff * (params.attract * fa / dist)[:, None], 0.0)
    seg = jnp.where(g.senders < n, g.senders, n)
    att = jax.ops.segment_sum(per_edge, seg, num_segments=n + 1)[:n]

    # |x_i| clamped at eps scales both the cut-edge pull and gravity
    # (forceatlas.hpp:411-414,463,469-473)
    mag = jnp.maximum(jnp.sqrt(jnp.sum(coords * coords, axis=-1)), eps)
    ext = pull_vec / mag[:, None]
    grav = -(coords / mag[:, None]) * (params.gravity * deg_p1)[:, None]
    return rep + att + ext + grav


@partial(jax.jit, static_argnames=("params", "iterations"))
def _ml_loop(coords0, g: Graph, part: Partition, members, deg_loc, pull_vec,
             coords_A, r_A, params: MultilevelFAParams, iterations: int):
    def body(it, carry):
        coords, forces_prev = carry
        f = ml_forces(coords, g, part, members, deg_loc, pull_vec, params)
        new_coords = F.speed_update(
            coords, f, forces_prev, deg_loc + 1.0, ks=params.ks,
            ksmax=params.ksmax, tolerate=params.tolerate,
            swing_clamp_eps=params.epsilon)
        return new_coords, f

    forces_prev = jnp.zeros_like(coords0)
    coords, _ = jax.lax.fori_loop(0, iterations, body, (coords0, forces_prev))

    # epilogue: center per aggregate, scale by max norm, pack into the parent
    # ball (forceatlas.hpp:539-570)
    v2a = part.vertex_to_agg
    m = part.num_aggs
    sizes = jax.ops.segment_sum(jnp.ones_like(v2a, coords.dtype), v2a,
                                num_segments=m)
    mean = jax.ops.segment_sum(coords, v2a, num_segments=m) / jnp.maximum(
        sizes, 1.0)[:, None]
    centered = coords - mean[v2a]
    norms = jnp.sqrt(jnp.sum(centered * centered, axis=-1))
    mx = jax.ops.segment_max(norms, v2a, num_segments=m)
    mx = jnp.maximum(mx, params.epsilon)
    return coords_A[v2a] + (r_A[v2a] / mx[v2a])[:, None] * centered


def force_atlas_multilevel(g: Graph, part: Partition, coords_A, r_A,
                           dim: int, *, key=None, iterations: int = 100,
                           params: MultilevelFAParams | None = None,
                           members=None, coords0=None):
    """Refine level-``l`` coordinates inside the parent balls
    (forceatlas.hpp:314-574; called with 100 iterations by the embed driver,
    src/embed.cpp:793).

    ``coords0``: optional [n, dim] warm-start member offsets in the LOCAL
    aggregate frame (roughly [-1, 1]^dim); replaces the reference's
    re-randomization at :356-360 (an intentional extension -- the reference's
    only warm-start hook is the flat path, forceatlas.hpp:118-125)."""
    params = params or MultilevelFAParams()
    if key is None:
        key = jax.random.PRNGKey(0)
    if members is None:
        members = build_member_buckets(part)
    if coords0 is None:
        coords0 = jax.random.uniform(key, (g.n, dim), dtype=coords_A.dtype,
                                     minval=-1.0, maxval=1.0)
    deg_loc = local_degrees(g, part, params.use_weights)
    pull_vec = external_pull(g, part, coords_A, pull=params.pull,
                             eps=params.epsilon)
    return _ml_loop(coords0, g, part, members, deg_loc, pull_vec,
                    jnp.asarray(coords_A), jnp.asarray(r_A), params,
                    iterations)
