"""Benchmark: ForceAtlas iteration throughput in edges/s/chip.

Prints ONE JSON line:
  {"metric": "fa_edges_per_sec_per_chip", "value": N, "unit": "edges/s",
   "vs_baseline": N, "workloads": {...}}

Metric (BASELINE.md north star): stored adjacency entries traversed per
second by the full jitted ForceAtlas iteration -- attraction (DIA lane
rolls + the edge-list SpMV) + sampled (negative-sampling) repulsion +
gravity + adaptive speed schedule -- on one chip.  ``vs_baseline`` =
value / 1e9 (the >= 1e9 edges/s/chip target).

Two workloads cover the reference roster's two graph families
(run-tests.cpp:361-400):

* ``mesh``      -- 3D 128^3 grid, 12.6M stored entries (mat_*, delaunay,
                   roadNet family).  DIA absorbs every edge.
* ``scattered`` -- RMAT(20, 8) power-law, ~16M stored entries, unit
                   weights (com-lj/com-youtube family; Graph500 RMAT is
                   the WORST case for locality -- real social graphs
                   cluster, RMAT by construction does not).  Every edge
                   rides the sender-sorted edge-list SpMV.

The headline ``value``/``vs_baseline`` is the WORST workload, so the
one-line JSON cannot overstate the family the north star names.

Each workload runs in its own child process, and the parent never imports
JAX, so exactly one process holds the card at a time.  Timing is a
device-side fori_loop closed by ``block_until_ready``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WORKLOAD_TIMEOUT_S = 1500


def build_graph(workload: str):
    import numpy as np

    if workload == "mesh":
        from graph_embed.graph.synth import mesh3d

        return mesh3d(128)
    assert workload == "scattered", workload
    import graph_embed as gt
    from graph_embed.graph.synth import rmat

    g = rmat(20, 8, seed=1)
    # simple-graph weights (com-lj is unweighted): drop dedup multiplicities
    s, r, _ = g.to_coo_numpy()
    return gt.from_edges(s, r, np.ones(s.size, np.float32), n=g.n,
                         symmetrize=False)


def make_fa_loop(params):
    """Jitted ``iters`` transposed FA steps: (xT, fprevT, key, tfa) ->
    (xT', fprevT')."""
    import jax
    from functools import partial

    from graph_embed.forceatlas import tiled as TL

    @partial(jax.jit, static_argnames=("iters",))
    def run(xT, fprevT, key, tfa, iters):
        def body(i, carry):
            c, f, k = carry
            k, sub = jax.random.split(k)
            c, f = TL.fa_step_tiled_T(c, f, tfa, params, sub)
            return c, f, k

        c, f, _ = jax.lax.fori_loop(0, iters, body, (xT, fprevT, key))
        return c, f

    return run


def bench_fa(workload: str, iters_per_call=20, repeats=5, dim=3,
             num_samples=64):
    import jax
    import jax.numpy as jnp

    from graph_embed.forceatlas import tiled as TL
    from graph_embed.ops.spmv import pad_coords_T
    from graph_embed.utils.params import ForceAtlasParams

    g = build_graph(workload)
    params = ForceAtlasParams(repulsion="sampled",
                              num_negative_samples=num_samples)
    tfa = TL.prepare_tiled(g, dim, params)
    key = jax.random.PRNGKey(0)
    coords = jax.random.uniform(key, (g.n, dim), dtype=jnp.float32,
                                minval=-1.0, maxval=1.0)
    # transposed loop state: no [n, d] <-> [D_PAD, n_pad] relayouts per iter
    xT = pad_coords_T(coords, tfa.n_pad)
    fprev = jnp.zeros_like(xT)
    run = make_fa_loop(params)
    c, f = jax.block_until_ready(run(xT, fprev, key, tfa, iters_per_call))
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        c, f = jax.block_until_ready(
            run(c, f, jax.random.PRNGKey(i), tfa, iters_per_call))
        times.append(time.perf_counter() - t0)
    times.sort()
    sec_per_iter = times[len(times) // 2] / iters_per_call
    return g.num_edges / sec_per_iter, g


def run_child(workload: str) -> dict | None:
    cmd = [sys.executable, os.path.abspath(__file__), "--workload", workload]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=WORKLOAD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"workload {workload}: timed out", file=sys.stderr)
        return None
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    print(f"workload {workload}: no result "
          f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}", file=sys.stderr)
    return None


def main():
    if "--workload" in sys.argv:
        wl = sys.argv[sys.argv.index("--workload") + 1]
        edges_per_sec, g = bench_fa(wl)
        print(json.dumps({"workload": wl, "edges_per_sec": edges_per_sec,
                          "n": g.n, "edges": g.num_edges}))
        return 0

    results = {}
    failed = []
    for wl in ("mesh", "scattered"):
        r = run_child(wl)
        if r is not None:
            results[wl] = {"value": r["edges_per_sec"],
                           "n": r["n"], "edges": r["edges"],
                           "vs_baseline": r["edges_per_sec"] / 1e9}
        else:
            # a failed workload pins the headline to 0 -- the min-across-
            # workloads rule must not silently promote the survivor
            failed.append(wl)
            results[wl] = {"value": 0.0, "vs_baseline": 0.0,
                           "error": "workload failed or timed out"}
    if failed == ["mesh", "scattered"]:
        print(json.dumps({"metric": "fa_edges_per_sec_per_chip",
                          "value": 0.0, "unit": "edges/s",
                          "vs_baseline": 0.0,
                          "error": "all workloads failed"}))
        return 1
    # headline = WORST workload: the one-line JSON must not read "target
    # beaten" while the family the north star names sits below it
    worst = min(results, key=lambda k: results[k]["vs_baseline"])
    headline = results[worst]
    out = {
        "metric": "fa_edges_per_sec_per_chip",
        "value": headline["value"],
        "unit": "edges/s",
        "vs_baseline": headline["value"] / 1e9,
        "headline_workload": worst,
        "workloads": results,
    }
    if failed:
        out["failed_workloads"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
