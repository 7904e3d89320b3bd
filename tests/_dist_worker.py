"""Worker for the two-process jax.distributed CPU smoke test
(tests/test_aux.py::test_two_process_distributed_smoke).

Each process owns 2 virtual CPU devices (4 global); the worker bootstraps
jax.distributed, assembles edge-sharded global arrays via
shard_edges_global (make_array_from_callback reads only locally-addressable
rows), runs TWO sharded FA steps, and process 0 writes the replicated
result to the given .npz path.

  python tests/_dist_worker.py <pid> <nprocs> <port> <out.npz>
"""
import os
import sys


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    ndev_local = int(os.environ.get("DIST_WORKER_DEVICES", "2"))
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={ndev_local}")

    import jax

    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == ndev_local * nprocs

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import graph_embed as gt
    from graph_embed.parallel.multihost import (global_mesh,
                                                    shard_edges_global)
    from graph_embed.parallel.sharded import (make_sharded_fa_step,
                                                  pad_graph_for_mesh)
    from graph_embed.utils.params import ForceAtlasParams

    rng = np.random.default_rng(7)
    n, m = 96, 400
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    keep = s != r
    g = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=jnp.float32)
    mesh = global_mesh()
    ndev = mesh.devices.size
    sp, rp, wp, n_pad = pad_graph_for_mesh(g, ndev, edge_multiple=8)

    key = jax.random.PRNGKey(0)
    coords0 = jax.random.uniform(key, (n_pad, 3), dtype=jnp.float32,
                                 minval=-1.0, maxval=1.0)
    coords0 = np.asarray(coords0)
    deg = np.zeros(n_pad, np.float32)
    deg[:n] = np.asarray(g.degrees(True))
    fprev0 = np.zeros((n_pad, 3), np.float32)

    def put(a, spec):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, NamedSharding(mesh, spec), lambda idx: a[idx])

    s_g, r_g, w_g = shard_edges_global(
        (sp, rp, wp.astype(np.float32)), mesh)
    step = make_sharded_fa_step(mesh, n_pad, sp.shape[0], 3,
                                ForceAtlasParams(repulsion="gram"), g.n,
                                jnp.float32)
    coords = put(coords0, P())
    fprev = put(fprev0, P("x"))
    deg_g = put(deg, P())
    for i in range(2):
        coords, fprev = step(coords, fprev, s_g, r_g, w_g, deg_g,
                             jax.random.PRNGKey(1))
    out = np.asarray(coords.addressable_data(0))  # replicated output
    if pid == 0:
        np.savez(out_path, coords=out[:n])
    # all processes must exit cleanly for the test to pass
    if nprocs > 1:
        jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
