"""Staged milestone configs from BASELINE.md, runnable end to end.

  python examples/staged_configs.py 1   # ~1k-vertex flat FA, 2D, dense rep.
  python examples/staged_configs.py 2   # 50k-vertex mesh, hierarchy cf=1/8,
                                        # multilevel embed, 2D
  python examples/staged_configs.py 3   # ~1M-edge graph, sampled repulsion,
                                        # 3D (transposed-layout step)
  python examples/staged_configs.py 4   # synthetic LiveJournal-scale stand-in,
                                        # edge-sharded across all devices

Each config prints a JSONL record with sizes, wall-clock and quality
numbers.  (Real SNAP datasets are not bundled; synthetic generators of the
same scale/shape stand in -- pass a path as argv[2] to use a real edge
list.)
"""

import json
import sys
import time

import numpy as np


def mesh2d(L):
    import jax.numpy as jnp

    import graph_embed as gt

    n = L * L
    idx = np.arange(n)
    x, y = idx % L, idx // L
    s_list, r_list = [], []
    for dx, dy in ((1, 0), (0, 1), (1, 1)):
        m = (x + dx < L) & (y + dy < L)
        s_list.append(idx[m])
        r_list.append(idx[m] + dx + dy * L)
    return gt.from_edges(np.concatenate(s_list), np.concatenate(r_list),
                         None, n=n, symmetrize=True, dtype=jnp.float32)


def powerlaw(n, e, seed=0):
    import jax.numpy as jnp

    import graph_embed as gt

    rng = np.random.default_rng(seed)
    u = rng.random(e)
    s = (u * u * n).astype(np.int64)
    r = rng.integers(0, n, e)
    keep = s != r
    return gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                         dtype=jnp.float32)


def config1():
    import jax

    import graph_embed as gt

    g = powerlaw(1000, 4000, seed=1)
    t0 = time.time()
    coords = gt.force_atlas(g, 2, params=gt.ForceAtlasParams(repulsion="gram"),
                            iterations=1000, key=jax.random.PRNGKey(0))
    jax.block_until_ready(coords)
    return {"config": 1, "n": g.n, "edges": g.num_edges,
            "seconds": time.time() - t0,
            "finite": bool(np.isfinite(np.asarray(coords)).all())}


def config2(path=None):
    import jax

    import graph_embed as gt

    g = gt.read_graph(path, "coolist", symmetric=True) if path else mesh2d(224)
    t0 = time.time()
    res = gt.partition_hierarchy(g, 1.0 / 8.0)
    t_part = time.time() - t0
    graphs = gt.build_galerkin_chain(g, res.levels)
    t0 = time.time()
    coords = gt.embed(graphs, res.levels, 2, base_iterations=2000,
                      refine_iterations=100, key=jax.random.PRNGKey(0))
    jax.block_until_ready(coords)
    t_embed = time.time() - t0
    q = float(gt.modularity(g, res.levels[0]))
    return {"config": 2, "n": g.n, "edges": g.num_edges,
            "levels": res.level_sizes, "partition_seconds": t_part,
            "embed_seconds": t_embed, "modularity_l1": q,
            "finite": bool(np.isfinite(np.asarray(coords)).all())}


def config3(path=None):
    import jax

    import graph_embed as gt
    from graph_embed.forceatlas import tiled as TL

    g = gt.read_graph(path, "coolist", symmetric=True) if path else powerlaw(
        200_000, 1_000_000, seed=3)
    params = gt.ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    t0 = time.time()
    coords = TL.force_atlas_tiled(g, 3, params=params, iterations=200,
                                  key=jax.random.PRNGKey(0))
    jax.block_until_ready(coords)
    return {"config": 3, "n": g.n, "edges": g.num_edges,
            "seconds": time.time() - t0,
            "finite": bool(np.isfinite(np.asarray(coords)).all())}


def config4(path=None):
    import jax

    import graph_embed as gt
    from graph_embed.parallel import make_mesh, sharded_force_atlas

    # com-LiveJournal stand-in: 4M vertices / ~35M stored entries scaled to
    # fit the available devices' memory; pass a real edge list to override
    g = gt.read_graph(path, "coolist", symmetric=True) if path else powerlaw(
        1_000_000, 8_000_000, seed=4)
    mesh = make_mesh()
    params = gt.ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    t0 = time.time()
    coords = sharded_force_atlas(g, 3, mesh=mesh, params=params,
                                 iterations=50)
    jax.block_until_ready(coords)
    return {"config": 4, "n": g.n, "edges": g.num_edges,
            "devices": int(mesh.devices.size),
            "seconds": time.time() - t0,
            "finite": bool(np.isfinite(np.asarray(coords)).all())}


def main():
    which = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    path = sys.argv[2] if len(sys.argv) > 2 else None
    fn = {1: config1, 2: config2, 3: config3, 4: config4}[which]
    rec = fn(path) if which != 1 else fn()
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
