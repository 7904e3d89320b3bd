"""Multi-chip ForceAtlas: edge-sharded attraction + vertex-block repulsion.

The distributed design (SURVEY.md SS2.2 row 'graph partitioned across
devices' and SS5 long-context row): the edge list -- the long axis, up to
1e9 edges -- is 1D-sharded over the mesh; vertex coordinate state is kept
replicated between steps while the *work* is split two ways:

* attraction: each device segment-sums its local edge shard into a full
  [n_pad, d] partial force, combined with ``psum_scatter`` so each device
  ends up with exactly its vertex block -- the graph analogue of
  sequence-sharded attention, with the collective riding the interconnect;
* repulsion (dense or sampled, diff form): each device computes only its
  vertex row-block against the replicated coordinates (a row-parallel,
  tensor-parallel-like split of the n x n interaction);
* gravity/swing/speed: on the local vertex block;
* one ``all_gather`` of the updated blocks re-replicates coordinates for the
  next step.

Per step the comm volume is 2 * n_pad * d floats, independent of E: edges
dominate compute, so scaling efficiency follows the edge shard.  Small
coarse levels should simply be run replicated (single-device path) -- the
multilevel driver does exactly that below a size threshold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..forceatlas import forces as F
from ..graph.csr import Graph
from ..utils.params import ForceAtlasParams
from .mesh import EDGE_AXIS, make_mesh, round_up


def pad_graph_for_mesh(g: Graph, n_devices: int, *, edge_multiple: int = 128):
    """Host-side: pad edge arrays to a multiple of n_devices*edge_multiple
    and the vertex count to a multiple of n_devices.  Returns
    (senders, receivers, weights, n_pad) numpy arrays; ghost slots use
    sender = receiver = n_pad with zero weight."""
    s, r, w = g.to_coo_numpy()
    e_pad = round_up(max(g.num_edges, 1), n_devices * edge_multiple)
    n_pad = round_up(g.n, n_devices)
    sp = np.full(e_pad, n_pad, dtype=np.int32)
    rp = np.full(e_pad, n_pad, dtype=np.int32)
    wp = np.zeros(e_pad, dtype=np.asarray(g.weights).dtype)
    sp[: g.num_edges] = s
    rp[: g.num_edges] = r
    wp[: g.num_edges] = w
    return sp, rp, wp, n_pad


def make_sharded_fa_step(mesh: Mesh, n_pad: int, e_pad: int, dim: int,
                         params: ForceAtlasParams, n_real: int,
                         dtype=jnp.float32):
    """Build the jitted multi-chip FA step.

    Returns step(coords[n_pad,d] replicated, fprev[n_pad,d] block-sharded,
    senders/receivers/weights [e_pad] edge-sharded, deg [n_pad] replicated,
    key) -> (coords', fprev').
    """
    ndev = mesh.devices.size
    blk = n_pad // ndev
    eps = params.epsilon

    def local_step(coords, fprev_blk, s, r, w, deg, key):
        # --- vertex block this device owns
        me = jax.lax.axis_index(EDGE_AXIS)
        row0 = me * blk
        x_blk = jax.lax.dynamic_slice(coords, (row0, jnp.zeros((), row0.dtype)),
                                      (blk, dim))
        deg_blk = jax.lax.dynamic_slice(deg, (row0,), (blk,))
        deg_p1 = deg + 1.0
        deg_blk_p1 = deg_blk + 1.0

        # --- repulsion on the row block (TP-like row split)
        if params.repulsion == "sampled":
            samp = params.num_negative_samples
            idx = jax.random.randint(key, (samp,), 0, n_real)
            f = F.sampled_repulsion_sum(x_blk.T, row0 + jnp.arange(blk),
                                        coords[idx].T, deg_p1[idx], idx, eps)
            rep_blk = (params.repel * deg_blk_p1)[:, None] * f.T * (
                jnp.asarray(n_real / samp, dtype))
        else:
            # the exact sum in diff form, every vertex a "sample" of weight
            # deg+1 (ghost rows 0): the gram identity's cancellation turned
            # per-block-size matmul rounding into layouts that depended on
            # the device count
            cols = jnp.arange(n_pad)
            ws = jnp.where(cols < n_real, deg_p1, 0.0)
            f = F.sampled_repulsion_sum(x_blk.T, row0 + jnp.arange(blk),
                                        coords.T, ws, cols, eps)
            rep_blk = (params.repel * deg_blk_p1)[:, None] * f.T

        # --- attraction over the local edge shard (SP-like edge split)
        sc = jnp.clip(s, 0, n_pad - 1)
        rc = jnp.clip(r, 0, n_pad - 1)
        xs_e, xr_e = coords[sc], coords[rc]
        diff = xr_e - xs_e
        dist_e = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=-1)), eps)
        fa = F.attraction_fa(dist_e, w, deg_p1[sc], linlog=params.linlog,
                             delta=params.delta, nohubs=params.nohubs,
                             use_weights=params.use_weights)
        live = s < n_pad
        per_edge = jnp.where(live[:, None],
                             diff * (params.attract * fa / dist_e)[:, None],
                             0.0)
        seg = jnp.where(live, s, n_pad)
        att_full = jax.ops.segment_sum(per_edge, seg,
                                       num_segments=n_pad)
        # combine partial attraction across devices; land on my block
        att_blk = jax.lax.psum_scatter(att_full, EDGE_AXIS, scatter_dimension=0,
                                       tiled=True)

        # --- gravity + speed update on the block
        grav_blk = F.gravity_force(x_blk, deg_blk_p1, params.gravity)
        f_blk = rep_blk + att_blk + grav_blk
        # freeze padded ghost rows
        rows = row0 + jnp.arange(blk)
        real = (rows < n_real)[:, None]
        f_blk = jnp.where(real, f_blk, 0.0)
        new_blk = F.speed_update(x_blk, f_blk, fprev_blk, deg_blk_p1,
                                 ks=params.ks, ksmax=params.ksmax,
                                 tolerate=params.tolerate)
        new_blk = jnp.where(real, new_blk, x_blk)
        coords_new = jax.lax.all_gather(new_blk, EDGE_AXIS, axis=0,
                                        tiled=True)
        return coords_new, f_blk

    spec_rep = P()
    spec_blk = P(EDGE_AXIS)
    spec_edge = P(EDGE_AXIS)
    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(spec_rep, spec_blk, spec_edge, spec_edge, spec_edge,
                  spec_rep, spec_rep),
        out_specs=(spec_rep, spec_blk),
        # coords_new is replicated by construction (all_gather); the static
        # varying-manual-axes check cannot see that
        check_vma=False,
    )
    return jax.jit(step)


# Largest per-device dense-repulsion distance block [blk, n_pad] (f32
# bytes) before sharded_force_atlas auto-switches params.repulsion to
# 'sampled'.  The default gram path materializes that block per device; at
# the default mesh_min_n=65536 a single-device gram is 65536^2 * 4B =
# 17.2 GB per materialized [n, n] temporary.
DENSE_D2_MAX_BYTES = 2 << 30


def sharded_force_atlas(g: Graph, dim: int = 2, *, mesh: Mesh | None = None,
                        params: ForceAtlasParams | None = None,
                        iterations: int = 100, key=None, coords0=None):
    """Run the flat FA layout over a device mesh (BASELINE.md config 4/5
    path).  Results are allclose to the single-device path up to float
    reduction order (SURVEY.md SS4 multi-chip test contract).

    ``coords0``: optional [n, dim] warm start (the forceatlas.hpp:118-125
    hook).  Random init draws [n, dim] BEFORE padding, so layouts are
    device-count invariant given the same key.

    If the per-device dense-repulsion block [blk, n_pad] would exceed
    DENSE_D2_MAX_BYTES, repulsion auto-switches to the sampled estimator
    (same policy spirit as the halo path, which always samples) -- the
    dense gram at embed()'s mesh_min_n scale cannot fit device memory."""
    import dataclasses

    params = params or ForceAtlasParams()
    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    ndev = mesh.devices.size
    n_pad_v = round_up(max(g.n, 1), ndev)
    itemsize = float(np.dtype(g.dtype).itemsize)  # d2 block is g.dtype
    if (params.repulsion != "sampled"
            and itemsize * (n_pad_v // ndev) * n_pad_v > DENSE_D2_MAX_BYTES):
        params = dataclasses.replace(params, repulsion="sampled")
    dtype = g.dtype

    key, init_key = jax.random.split(key)
    if coords0 is None:
        coords0 = jax.random.uniform(init_key, (g.n, dim), dtype=dtype,
                                     minval=-1.0, maxval=1.0)
    s, r, w, n_pad = pad_graph_for_mesh(g, ndev)
    coords = jnp.zeros((n_pad, dim), dtype).at[: g.n].set(
        jnp.asarray(coords0, dtype))
    deg = np.zeros(n_pad, dtype=np.asarray(g.weights).dtype)
    deg[: g.n] = np.asarray(g.degrees(params.use_weights))
    deg = jnp.asarray(deg, dtype=dtype)

    from jax.sharding import NamedSharding
    shard_e = NamedSharding(mesh, P(EDGE_AXIS))
    shard_r = NamedSharding(mesh, P())
    shard_b = NamedSharding(mesh, P(EDGE_AXIS))
    s = jax.device_put(jnp.asarray(s), shard_e)
    r = jax.device_put(jnp.asarray(r), shard_e)
    w = jax.device_put(jnp.asarray(w, dtype=dtype), shard_e)
    coords = jax.device_put(coords, shard_r)
    deg = jax.device_put(deg, shard_r)
    fprev = jax.device_put(jnp.zeros((n_pad, dim), dtype), shard_b)

    step = make_sharded_fa_step(mesh, n_pad, s.shape[0], dim, params, g.n,
                                dtype)
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        coords, fprev = step(coords, fprev, s, r, w, deg, sub)
    return coords[: g.n]
