"""Boundary-aware flat FA sharding: vertex-partitioned coords + halo exchange.

The baseline multi-chip step (parallel/sharded.py) keeps coordinates
REPLICATED and all_gathers the full [n_pad, d] block every iteration -- fine
at mesh scale, but at the 100M-vertex / 1e9-edge target (BASELINE configs
4/5) the per-step all_gather payload and the replicated-coords memory footprint
become the ceiling.  This module is the
boundary-aware design from SURVEY.md SS2.2 row 3 / SS5 (long-context row):

* vertices are partitioned into contiguous blocks (one per device) -- run a
  locality ordering first (graph.reorder.partition_order) so communities are
  contiguous and the cut is small;
* every edge lives on its SENDER's device, so attraction accumulates locally
  (the symmetric adjacency stores both directions -- each device computes
  exactly the forces on its own vertices);
* per step each device all_gathers only its BOUNDARY vertices (those any
  remote edge receives from): comm = ndev * B_max * d floats instead of
  n_pad * d, and per-device memory holds blk + ndev*B_max coords instead of
  n_pad;
* sampled repulsion draws samples from each device's own block and
  all_gathers the tiny [samples, d] sample set (+ degrees) -- an unbiased
  global estimator with O(samples) comm, stratified by block;
* gravity / swing / speed run on the local block; no force exchange exists
  at all (senders own their forces).

Per-step comm model (floats):
  replicated design:  2 * n_pad * d            (all_gather + psum_scatter)
  halo design:        ndev * B_max * d  +  samples * (d + 1)
For a partition-ordered graph B is the vertex boundary of the cut, typically
a few percent of n: the bench mesh at 8 blocks has B_max/n ~ 1.5%, RMAT ~ 20%
(hubs touch everything).

The exchange is an explicit ``all_gather`` under ``shard_map``; XLA hands
it to the collective library and may overlap it with independent work.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..forceatlas import forces as F
from ..graph.csr import Graph
from ..utils.params import ForceAtlasParams
from .mesh import EDGE_AXIS, round_up


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-built static exchange plan.

    Per-device arrays are stacked on axis 0 (sharded with P('x')).
    Receiver indices address the concatenation [local block | boundary pool]
    where the pool is the all_gathered [ndev * B_max, d] boundary coords.
    """

    ndev: int
    n: int
    blk: int                   # vertices per device (padded)
    B_max: int                 # boundary slots per device (padded, >= 1)
    e_max: int                 # edges per device (padded)
    senders_loc: np.ndarray    # [ndev, e_max] local sender index (pad blk)
    recv_idx: np.ndarray       # [ndev, e_max] index into [blk | pool]
    weights: np.ndarray        # [ndev, e_max] (pad 0)
    boundary_idx: np.ndarray   # [ndev, B_max] local idx of exported vertices
    boundary_counts: np.ndarray  # [ndev] real exported count per device
    deg: np.ndarray            # [ndev, blk]
    n_real: np.ndarray         # [ndev, 1] real vertex count per device

    @property
    def boundary_fraction(self) -> float:
        """Exported-vertex fraction of n (the comm-model B/n)."""
        return float(self.boundary_counts.sum()) / max(self.n, 1)

    def comm_floats_per_step(self, dim: int, num_samples: int) -> int:
        """Interconnect floats per step (gathered boundary + sample set:
        coords + degree + row id + stratum weight per sample) -- compare
        against the replicated design's 2 * n_pad * dim."""
        return (self.ndev * self.B_max * dim
                + num_samples * (dim + 3))


def build_halo_plan(g: Graph, ndev: int, *, block_multiple: int = 8,
                    edge_multiple: int = 8) -> HaloPlan:
    """Partition vertices into ``ndev`` contiguous blocks and build the
    static halo-exchange plan.  Reorder the graph first (partition_order /
    rcm_order) -- the plan's boundary size IS the cut of this ordering."""
    s, r, w = g.to_coo_numpy()
    n = g.n
    blk = round_up(max(-(-n // ndev), 1), block_multiple)
    dev_of = np.minimum(np.arange(n) // blk, ndev - 1)

    e_dev = np.minimum(s // blk, ndev - 1)
    r_dev = np.minimum(r // blk, ndev - 1)

    # boundary of device e: owned vertices some OTHER device receives from
    cross = e_dev != r_dev
    bnd_ids = [np.unique(r[cross & (r_dev == e)]) for e in range(ndev)]
    B_max = max(max((b.size for b in bnd_ids), default=0), 1)
    B_max = round_up(B_max, block_multiple)
    boundary_idx = np.zeros((ndev, B_max), np.int32)   # pad with slot 0
    pool_pos = np.full(n, -1, np.int64)                # vertex -> pool slot
    for e in range(ndev):
        ids = bnd_ids[e]
        boundary_idx[e, : ids.size] = (ids - e * blk).astype(np.int32)
        pool_pos[ids] = e * B_max + np.arange(ids.size)

    counts = np.bincount(e_dev, minlength=ndev)
    e_max = round_up(max(int(counts.max()), 1), edge_multiple)
    senders_loc = np.full((ndev, e_max), blk, np.int32)   # pad -> ghost row
    recv_idx = np.zeros((ndev, e_max), np.int32)
    weights = np.zeros((ndev, e_max), np.asarray(w).dtype)
    order = np.argsort(e_dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for e in range(ndev):
        sel = order[starts[e]: starts[e + 1]]
        k = sel.size
        senders_loc[e, :k] = (s[sel] - e * blk).astype(np.int32)
        local = r_dev[sel] == e
        ri = np.where(local, r[sel] - e * blk, blk + pool_pos[r[sel]])
        recv_idx[e, :k] = ri.astype(np.int32)
        weights[e, :k] = w[sel]

    deg = np.zeros((ndev, blk), np.asarray(w).dtype)
    dall = np.asarray(g.degrees(True))
    for e in range(ndev):
        lo = min(e * blk, n)
        hi = min((e + 1) * blk, n)
        if hi > lo:
            deg[e, : hi - lo] = dall[lo:hi]
    n_real = np.array([[max(min((e + 1) * blk, n) - e * blk, 0)]
                       for e in range(ndev)], np.int32)
    return HaloPlan(ndev=ndev, n=n, blk=blk, B_max=B_max, e_max=e_max,
                    senders_loc=senders_loc, recv_idx=recv_idx,
                    weights=weights, boundary_idx=boundary_idx,
                    boundary_counts=np.array([b.size for b in bnd_ids],
                                             np.int64),
                    deg=deg, n_real=n_real)


def make_halo_fa_step(mesh: Mesh, plan: HaloPlan, dim: int,
                      params: ForceAtlasParams, dtype=jnp.float32, *,
                      sample_mode: str = "stratified"):
    """Jitted halo-exchange FA step.

    step(x_blk[ndev*blk, d] block-sharded, fprev same, senders_loc,
    recv_idx, weights, boundary_idx, deg, n_real, key) over the static plan
    arrays (passed as sharded arguments, never closed over as constants).
    Returns (x_blk', forces_blk).

    ``sample_mode`` picks the repulsion sample design:
      'stratified'  (default) each device draws samp_per from its own
                    block (per-sample weight nr_e/samp_per) -- lowest
                    variance, but the draw depends on the device count;
      'invariant'   ALL devices draw the same num_negative_samples global
                    indices from the shared replicated key; each device
                    contributes the samples it owns and a psum assembles
                    the set -- device-count-INVARIANT layouts (the SURVEY
                    SS5 determinism contract with repulsion ON), at
                    uniform-sampling variance.
    """
    ndev = plan.ndev
    blk = plan.blk
    eps = params.epsilon
    samp_per = max(params.num_negative_samples // ndev, 1)
    if sample_mode not in ("stratified", "invariant"):
        raise ValueError(f"unknown sample_mode {sample_mode!r}")

    def local_step(x_blk, fprev, s_loc, r_idx, w, bidx, deg, n_real, key):
        me = jax.lax.axis_index(EDGE_AXIS)
        nr = n_real[0, 0]
        deg_p1 = deg[0] + 1.0
        xb = x_blk                                     # [blk, d]

        # --- halo exchange: ONLY boundary coords ride the interconnect
        bnd = xb[bidx[0]]                              # [B_max, d]
        pool = jax.lax.all_gather(bnd, EDGE_AXIS)      # [ndev, B_max, d]
        xcat = jnp.concatenate([xb, pool.reshape(-1, dim)], axis=0)

        # --- attraction over the local edge shard (senders all mine)
        sc = jnp.clip(s_loc[0], 0, blk - 1)
        xs_e = xcat[sc]
        xr_e = xcat[r_idx[0]]
        diff = xr_e - xs_e
        dist_e = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=-1)), eps)
        fa = F.attraction_fa(dist_e, w[0], deg_p1[sc],
                             linlog=params.linlog, delta=params.delta,
                             nohubs=params.nohubs,
                             use_weights=params.use_weights)
        live = s_loc[0] < blk
        per_edge = jnp.where(
            live[:, None], diff * (params.attract * fa / dist_e)[:, None],
            0.0)
        seg = jnp.where(live, s_loc[0], blk)
        att = jax.ops.segment_sum(per_edge, seg, num_segments=blk + 1)[:blk]

        # --- sampled repulsion: global sample set, O(samp) comm
        if sample_mode == "invariant":
            # every device draws the SAME global indices from the shared
            # replicated key; each contributes the samples it owns, a psum
            # assembles the set.  The draw never references ndev/blk, so
            # layouts are identical across device counts.
            K = params.num_negative_samples
            idx_g = jax.random.randint(key, (K,), 0,
                                       jnp.asarray(max(plan.n, 1)))
            own = (idx_g >= me * blk) & (idx_g - me * blk < nr)
            loc = jnp.clip(idx_g - me * blk, 0, blk - 1)
            xs_all = jax.lax.psum(
                jnp.where(own[:, None], xb[loc], 0.0), EDGE_AXIS)
            ds_all = jax.lax.psum(
                jnp.where(own, deg_p1[loc], 0.0), EDGE_AXIS)
            rows_all = idx_g
            w_all = jnp.full((K,), 1.0, dtype) * (
                jnp.asarray(plan.n, dtype) / K)
        else:
            key_d = jax.random.fold_in(key, me)
            idx = jax.random.randint(key_d, (samp_per,), 0,
                                     jnp.maximum(nr, 1))
            xs_mine = xb[idx]                          # [samp_per, d]
            ds_mine = deg_p1[idx]
            rows_mine = me * blk + idx
            # per-sample stratum weight nr_e / samp_per: each device is a
            # stratum of nr_e real vertices sampled samp_per times, so the
            # unbiased estimator of the full n-vertex sum weights its
            # samples by nr_e/samp_per -- NOT the uniform n/(samp*ndev),
            # which biases whenever blocks are uneven (last device short /
            # empty) or num_negative_samples < ndev clamps samp_per to 1.
            # Empty strata (nr_e == 0) get weight 0, so their ghost draws
            # never pollute the sum.
            w_mine = jnp.full((samp_per,), 1.0, dtype) * (
                nr.astype(dtype) / samp_per)
            xs_all = jax.lax.all_gather(xs_mine, EDGE_AXIS).reshape(-1, dim)
            ds_all = jax.lax.all_gather(ds_mine, EDGE_AXIS).reshape(-1)
            rows_all = jax.lax.all_gather(rows_mine, EDGE_AXIS).reshape(-1)
            w_all = jax.lax.all_gather(w_mine, EDGE_AXIS).reshape(-1)
        f = F.sampled_repulsion_sum(xb.T, me * blk + jnp.arange(blk),
                                    xs_all.T, ds_all * w_all, rows_all, eps)
        # unbiased estimator of the exact n-vertex sum (weights above)
        rep = (params.repel * deg_p1)[:, None] * f.T

        grav = F.gravity_force(xb, deg_p1, params.gravity)
        f_blk = rep + att + grav
        real = (jnp.arange(blk) < nr)[:, None]
        f_blk = jnp.where(real, f_blk, 0.0)
        new_blk = F.speed_update(xb, f_blk, fprev, deg_p1, ks=params.ks,
                                 ksmax=params.ksmax,
                                 tolerate=params.tolerate)
        new_blk = jnp.where(real, new_blk, xb)
        return new_blk, f_blk

    bs = P(EDGE_AXIS)
    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(bs,) * 8 + (P(),),
        out_specs=(bs, bs),
        check_vma=False,
    )
    return jax.jit(step)


def halo_force_atlas(g: Graph, dim: int = 2, *, mesh: Mesh,
                     params: ForceAtlasParams | None = None,
                     iterations: int = 100, key=None, coords0=None,
                     plan: HaloPlan | None = None,
                     sample_mode: str = "stratified"):
    """Flat FA layout with vertex-partitioned coords + boundary-only halo
    exchange.  ``params.repulsion`` must be 'sampled' (the point of the
    design is never materializing remote coords); use sharded_force_atlas
    for the replicated/gram baseline."""
    params = params or ForceAtlasParams(repulsion="sampled")
    if params.repulsion != "sampled":
        raise ValueError("halo_force_atlas supports repulsion='sampled' "
                         "only (remote coords are never replicated)")
    if key is None:
        key = jax.random.PRNGKey(0)
    ndev = mesh.devices.size
    if plan is None:
        plan = build_halo_plan(g, ndev)
    dtype = g.dtype

    key, init_key = jax.random.split(key)
    if coords0 is None:
        coords0 = jax.random.uniform(init_key, (g.n, dim), dtype=dtype,
                                     minval=-1.0, maxval=1.0)
    nblk = ndev * plan.blk
    x = jnp.zeros((nblk, dim), dtype).at[: g.n].set(
        jnp.asarray(coords0, dtype))
    fprev = jnp.zeros_like(x)

    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P(EDGE_AXIS)))
    x = put(x)
    fprev = put(fprev)
    args = (put(plan.senders_loc), put(plan.recv_idx),
            put(jnp.asarray(plan.weights, dtype)), put(plan.boundary_idx),
            put(jnp.asarray(plan.deg, dtype)), put(plan.n_real))
    step = make_halo_fa_step(mesh, plan, dim, params, dtype,
                             sample_mode=sample_mode)
    for i in range(iterations):
        key, sub = jax.random.split(key)
        x, fprev = step(x, fprev, *args, sub)
    # final readout: re-replicate once, then slice to the real vertices
    x = jax.device_put(x, NamedSharding(mesh, P()))
    return x[: g.n]
