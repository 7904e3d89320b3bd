"""Worker for the two-process PRODUCT-PIPELINE test
(tests/test_aux.py::test_two_process_embed_pipeline).

Runs the full multilevel ``embed(mesh=...)`` driver — partition hierarchy,
Galerkin chain, sharded flat base case + aggregate-sharded refinement —
across 2 processes x 4 virtual CPU devices each (8 global), asserting the
product pipeline (not just one step) works under jax.distributed.  Process
0 writes the final coords; the test compares against a single-process run
on an identical 8-device mesh.

  python tests/_dist_embed_worker.py <pid> <nprocs> <port> <out.npz>
"""
import os
import sys


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    ndev_local = int(os.environ.get("DIST_WORKER_DEVICES", "4"))
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={ndev_local}")

    import jax

    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nprocs, process_id=pid)
    assert len(jax.devices()) == ndev_local * nprocs

    import numpy as np
    import jax.numpy as jnp

    import graph_embed as gt
    from graph_embed.parallel.multihost import global_mesh

    # deterministic graph: ring of cliques (same on every process)
    rng = np.random.default_rng(11)
    k, m = 24, 10                      # 240 vertices
    n = k * m
    ss, rr = [], []
    for c in range(k):
        base = c * m
        for i in range(m):
            for j in range(i + 1, m):
                if rng.random() < 0.6:
                    ss.append(base + i)
                    rr.append(base + j)
        ss.append(base + m - 1)
        rr.append(((c + 1) % k) * m)
    g = gt.from_edges(np.array(ss), np.array(rr), None, n=n,
                      symmetrize=True, dtype=jnp.float32)

    res = gt.partition_hierarchy(g, 0.3)
    graphs = gt.build_galerkin_chain(g, res.levels)
    mesh = global_mesh()
    # DIST_WORKER_SHARDING=halo exercises the config-5 flat design across
    # processes (vertex-partitioned base case, boundary-only exchange,
    # invariant sampling); mesh_min_n drops so the tiny coarsest level
    # still takes the mesh path
    sharding = os.environ.get("DIST_WORKER_SHARDING", "replicated")
    min_n = 16 if sharding == "halo" else 64
    coords = gt.embed(graphs, res.levels, 2, key=jax.random.PRNGKey(5),
                      base_iterations=20, refine_iterations=5,
                      mesh=mesh, mesh_min_n=min_n, sharding=sharding)
    # the final level's coords are replicated (or host) -- read shard 0
    arr = coords
    if hasattr(arr, "addressable_data"):
        out = np.asarray(arr.addressable_data(0))
    else:
        out = np.asarray(arr)
    assert np.isfinite(out).all()
    if pid == 0:
        np.savez(out_path, coords=out[:n])
    if nprocs > 1:
        jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
