"""Smoke run of the multilevel embed on one GPU (four with ``--chips 4``).

    python3 chip_smoke.py              # one card: every phase below
    python3 chip_smoke.py --chips 4    # four cards: the mesh phase only

Phases on one card, all in this one process:
  1. card identity (nvidia-smi name and power limit, JAX version, XLA_FLAGS);
  2. each force term against a plain reference at the bench widths --
     rmat(20, 8) with unit weights and mesh3d(128), built as bench.py
     builds them -- printing each normwise relative error beside its bound;
  3. the FA step of both bench graphs: compile seconds, ms/iter, edges/s;
  4. the CLI ``embed`` of rmat(20, 8) end to end, with per-phase seconds;
  5. a planted-partition layout quality check (~100k vertices).
With ``--chips 4``: ``embed(mesh=...)`` on the rmat(20, 8) hierarchy over
four cards in both sharding designs, against the one-card run.

The last line of stdout is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, outside the repository, when a phase raises or when a
comparison is out of bounds, it exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DIM = 3
SAMPLES = 64   # the bench's negative samples per step

# Normwise relative error bounds ||got - ref|| / ||ref||.
BOUNDS = {
    # f32 sums in another order than the float64 reference: each row sum
    # carries ~log2(deg) * 2^-24 relative error
    "spmv": 1e-5,
    # A @ x - x * rowsum(A) cancels for rows whose neighbours surround
    # them, so the error is relative to the larger A @ x terms
    "attraction": 1e-4,
    # 64 diff-form terms per vertex, 1/d^3 amplifies each coordinate's
    # rounding three-fold
    "repulsion": 1e-5,
    # forces of one whole step against flat.fa_step: the same terms in
    # other forms (linear vs per-edge attraction, other sum orders)
    "fa_step": 1e-4,
    # slot-space vs member-table refinement forces, both exact pairs in
    # diff form: f32 sums in other orders
    "refine": 1e-4,
    # the same against the member-table route's gram form (used when its
    # exact form would not fit): the |x|^2 identity loses ~sqrt(2^-24)
    # relative on near pairs
    "refine_gram": 1e-3,
    # 1-vs-4-card layouts after a short budget: atomics reorder the sums
    # and the adaptive speed amplifies the difference over iterations
    "mesh": 1e-3,
    # planted partition: mean intra-community distance over mean
    # inter-community distance; random coordinates give ~1
    "quality": 0.5,
}


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, name: str, err: float, bound: float):
        ok = bool(np.isfinite(err) and err <= bound)
        print(f"check {name}: err={err:.3e} bound={bound:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def card_identity(chips: int):
    import jax

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in out.stdout.strip().splitlines()[:chips]:
        print(line)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}"
          f"; g++ {shutil.which('g++') or 'missing (native builds fall back)'}")


def bench_graphs():
    import bench

    t0 = time.perf_counter()
    g = {"scattered": bench.build_graph("scattered"),
         "mesh": bench.build_graph("mesh")}
    print(f"set-up: bench graphs in {time.perf_counter() - t0:.1f}s "
          + ", ".join(f"{k} n={v.n} stored={v.num_edges}"
                      for k, v in g.items()), flush=True)
    return g


def random_coords(n: int, seed: int):
    import jax
    import jax.numpy as jnp

    return jax.random.uniform(jax.random.PRNGKey(seed), (n, DIM),
                              dtype=jnp.float32, minval=-1.0, maxval=1.0)


def check_attraction(sm: Smoke, name: str, g, dia_min_count):
    """Attraction term (attract = 1) against scipy in float64."""
    import jax
    import scipy.sparse as sps

    from graph_embed.forceatlas import tiled as TL
    from graph_embed.ops import spmv as SP
    from graph_embed.utils.params import ForceAtlasParams

    params = ForceAtlasParams(repulsion="sampled",
                              num_negative_samples=SAMPLES)
    tfa = TL.prepare_tiled(g, DIM, params, dia_min_count=dia_min_count)
    x = random_coords(g.n, 1)
    xT = SP.pad_coords_T(x, tfa.n_pad)
    s, r, w = g.to_coo_numpy()
    A = sps.csr_matrix((np.asarray(w, np.float64), (s, r)), (g.n, g.n))
    x64 = np.asarray(x, np.float64)
    Ax = A @ x64
    want = Ax - x64 * np.asarray(A.sum(axis=1))
    att = jax.jit(TL._attraction_T, static_argnames="params")
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(att(xT, tfa, params))[:DIM, :g.n].T
        sm.check(f"attraction {name} ({prec})", rel(got, want),
                 BOUNDS["attraction"])
    if tfa.edges is not None and not tfa.dia_offsets:
        got = np.asarray(jax.jit(SP.spmv_T, static_argnames="dim")(
            xT, tfa.edges, dim=DIM))[:DIM, :g.n].T
        sm.check(f"spmv {name}", rel(got, Ax), BOUNDS["spmv"])


def check_repulsion(sm: Smoke, name: str, g):
    """Sampled repulsion against a float64 numpy transcription on the same
    sample indices (threefry draws are backend-invariant)."""
    import jax
    import jax.numpy as jnp

    from graph_embed.forceatlas import forces as F
    from graph_embed.ops import spmv as SP

    n = g.n
    n_pad = -(-n // 128) * 128
    x = random_coords(n, 2)
    xT = SP.pad_coords_T(x, n_pad)
    deg_p1 = jnp.zeros(n_pad, jnp.float32).at[:n].set(
        jnp.asarray(g.degrees_numpy(True), jnp.float32) + 1.0)
    key = jax.random.PRNGKey(7)
    rep = jax.jit(F.repulsion_sampled_T, static_argnames=(
        "n", "num_samples", "repel", "eps", "dim"))
    idx = np.asarray(jax.random.randint(key, (SAMPLES,), 0, n))
    x64 = np.asarray(x, np.float64)
    d64 = np.asarray(deg_p1, np.float64)[:n]
    want = np.zeros((n, DIM))
    xs, ds = x64[idx], d64[idx]
    for lo in range(0, n, 1 << 17):
        hi = min(lo + (1 << 17), n)
        diff = x64[lo:hi, None, :] - xs[None, :, :]
        dist = np.maximum(np.sqrt((diff * diff).sum(-1)), 1e-5)
        wgt = ds[None, :] / dist ** 3
        wgt[np.arange(lo, hi)[:, None] == idx[None, :]] = 0.0
        want[lo:hi] = (wgt[:, :, None] * diff).sum(1)
    want *= d64[:, None] * (n / SAMPLES)
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(rep(xT, deg_p1, key, n=n, num_samples=SAMPLES,
                                 repel=1.0, eps=1e-5, dim=DIM))[:DIM, :n].T
        sm.check(f"repulsion {name} ({prec})", rel(got, want),
                 BOUNDS["repulsion"])


def check_fa_step(sm: Smoke, name: str, g):
    """One full transposed FA step against flat.fa_step."""
    import jax
    import jax.numpy as jnp

    from graph_embed.forceatlas import flat
    from graph_embed.forceatlas import tiled as TL
    from graph_embed.ops import spmv as SP
    from graph_embed.utils.params import ForceAtlasParams

    params = ForceAtlasParams(repulsion="sampled",
                              num_negative_samples=SAMPLES)
    tfa = TL.prepare_tiled(g, DIM, params)
    x = random_coords(g.n, 3)
    key = jax.random.PRNGKey(11)
    xT = SP.pad_coords_T(x, tfa.n_pad)
    step_T = jax.jit(TL.fa_step_tiled_T, static_argnames="params")
    with jax.default_matmul_precision("highest"):
        _, f_ref = jax.jit(flat.fa_step, static_argnames="params")(
            x, jnp.zeros_like(x), g, g.degrees(True), params, key)
    f_ref = np.asarray(f_ref)
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            _, fT = step_T(xT, jnp.zeros_like(xT), tfa, params, key)
        sm.check(f"fa_step {name} ({prec})",
                 rel(np.asarray(fT)[:DIM, :g.n].T, f_ref), BOUNDS["fa_step"])


def check_refine(sm: Smoke, g, part):
    """One slot-space refinement force evaluation against
    multilevel.ml_forces on the same level."""
    import jax
    import jax.numpy as jnp

    from graph_embed.forceatlas import multilevel as ML
    from graph_embed.forceatlas import multilevel_tiled as MT
    from graph_embed.utils.params import MultilevelFAParams

    params = MultilevelFAParams()
    layout = MT.prepare_refine(g, part, params)
    x = random_coords(g.n, 4)
    cA = random_coords(part.num_aggs, 5) * 10.0
    members = ML.build_member_buckets(part)
    # the member-table route's exact form holds [8, S, S, dim] per chunk
    s_max = max(int(t.shape[1]) for t in members)
    exact = 8 * s_max * s_max * DIM * 4 <= 8 << 30
    ref_params = dataclasses.replace(
        params, repulsion="exact" if exact else "gram")
    print(f"refine level 0: n={g.n} aggregates={part.num_aggs} "
          f"largest={s_max} reference={ref_params.repulsion}", flush=True)
    deg_loc = ML.local_degrees(g, part, params.use_weights)
    pull = ML.external_pull(g, part, cA, pull=params.pull,
                            eps=params.epsilon)
    sov = layout.slot_of_vertex
    xs = jnp.zeros((layout.n_slots, DIM), jnp.float32).at[sov].set(x)
    ps = jnp.zeros((layout.n_slots, DIM), jnp.float32).at[sov].set(pull)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(ML.ml_forces, static_argnames="params")(
            x, g, part, members, deg_loc, pull, ref_params))
    slot_forces = jax.jit(MT.refine_forces, static_argnames=("params", "dim"))
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(slot_forces(xs, layout, ps, params, DIM)[sov])
        sm.check(f"refine level 0 ({prec})", rel(got, want),
                 BOUNDS["refine" if exact else "refine_gram"])


def time_fa_step(name: str, g, iters: int = 20, repeats: int = 5):
    import jax
    import jax.numpy as jnp

    import bench
    from graph_embed.forceatlas import tiled as TL
    from graph_embed.ops import spmv as SP
    from graph_embed.utils.params import ForceAtlasParams

    params = ForceAtlasParams(repulsion="sampled",
                              num_negative_samples=SAMPLES)
    tfa = TL.prepare_tiled(g, DIM, params)
    xT = SP.pad_coords_T(random_coords(g.n, 0), tfa.n_pad)
    f = jnp.zeros_like(xT)
    run = bench.make_fa_loop(params)
    t0 = time.perf_counter()
    xT, f = jax.block_until_ready(run(xT, f, jax.random.PRNGKey(0), tfa,
                                      iters))
    first = time.perf_counter() - t0
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        xT, f = jax.block_until_ready(
            run(xT, f, jax.random.PRNGKey(i + 1), tfa, iters))
        times.append(time.perf_counter() - t0)
    per_call = float(np.median(times))
    ms = per_call / iters * 1e3
    print(f"fa_step {name}: n={g.n} stored={g.num_edges} "
          f"compile+first={first:.2f}s ({first - per_call:.2f}s over a "
          f"warm call) ms/iter={ms:.4f} edges/s={g.num_edges / ms * 1e3:.4e}",
          flush=True)
    if not np.isfinite(np.asarray(xT)).all():
        raise RuntimeError(f"fa_step {name}: non-finite coordinates")


def write_edge_file(g, path: str):
    """Upper-triangle unit-weight coolist: read back with -symmetric true
    it is the same graph."""
    s, r, _ = g.to_coo_numpy()
    up = s < r
    np.savetxt(path, np.stack([s[up], r[up]], axis=1), fmt="%d %d 1")


def run_cli(sm: Smoke, g, workdir: str):
    from graph_embed import cli

    edges = os.path.join(workdir, "rmat20.coo")
    out = os.path.join(workdir, "coords.txt")
    metrics = os.path.join(workdir, "metrics.jsonl")
    t0 = time.perf_counter()
    write_edge_file(g, edges)
    print(f"set-up: edge file in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    rc = cli.main(["embed", "-f", edges, "-format", "coolist",
                   "-symmetric", "true", "-dimension", str(DIM), "-o", out,
                   "-metrics", metrics])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli embed exited {rc}")
    with open(metrics) as fh:
        for line in fh:
            rec = json.loads(line)
            rec.pop("t", None)
            print("cli phase", json.dumps(rec))
    coords = np.loadtxt(out)
    print(f"cli embed: wall={wall:.2f}s coords={coords.shape}", flush=True)
    if coords.shape != (g.n, DIM) or not np.isfinite(coords).all():
        raise RuntimeError(f"cli embed: bad output {coords.shape}")
    # not collapsed: the layout spans space and vertices stay apart
    spread = float(coords.std(axis=0).min())
    distinct = np.unique(np.round(coords, 6), axis=0).shape[0] / g.n
    print(f"cli embed: min coordinate std={spread:.3e} "
          f"distinct rows={distinct:.4f}")
    if spread <= 1e-3 or distinct < 0.99:
        sm.failures.append("cli collapsed")


def quality(sm: Smoke, communities: int = 100, size: int = 1000):
    """embed_graph on a planted partition: members of one community must
    land closer together than members of different ones."""
    import jax

    import graph_embed as gt
    from graph_embed.graph.synth import planted_partition

    # ~20 intra-community and ~2 inter-community neighbours per vertex
    g, labels = planted_partition(communities, size, p_in=20.0 / size,
                                  p_out=2.0 / (communities * size), seed=1)
    t0 = time.perf_counter()
    coords, _ = gt.embed_graph(g, DIM, key=jax.random.PRNGKey(0))
    coords = np.asarray(coords)
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    i = rng.integers(0, g.n, 200_000)
    j = rng.integers(0, g.n, 200_000)
    inter = labels[i] != labels[j]
    # labels are contiguous blocks of ``size``: same-community partners
    j_in = (i // size) * size + rng.integers(0, size, i.size)
    d_in = np.linalg.norm(coords[i] - coords[j_in], axis=1).mean()
    d_out = np.linalg.norm(coords[i] - coords[j], axis=1)[inter].mean()
    ratio = float(d_in / d_out)
    print(f"quality: n={g.n} stored={g.num_edges} wall={wall:.2f}s "
          f"intra/inter mean distance={ratio:.4f}", flush=True)
    sm.check("quality intra/inter", ratio, BOUNDS["quality"])


def mesh_phase(sm: Smoke, chips: int, g=None):
    """embed(mesh=...) on the rmat(20, 8) hierarchy over ``chips`` cards
    against one card, in both sharding designs."""
    import jax

    import bench
    import graph_embed as gt
    from graph_embed.parallel import make_mesh

    if g is None:
        g = bench.build_graph("scattered")
    t0 = time.perf_counter()
    res = gt.partition_hierarchy(g, 0.1, emit_graphs=True)
    graphs = [g] + res.coarse_graphs
    print(f"set-up: partition in {time.perf_counter() - t0:.1f}s, levels "
          f"{[x.n for x in graphs]}", flush=True)
    for sharding in ("replicated", "halo"):
        outs = []
        for nd in (1, chips, 1):
            t0 = time.perf_counter()
            out = gt.embed(graphs, res.levels, DIM,
                           key=jax.random.PRNGKey(0), base_iterations=50,
                           refine_iterations=5, mesh=make_mesh(nd),
                           mesh_min_n=1, sharding=sharding)
            outs.append(np.asarray(out))
            print(f"mesh {sharding} devices={nd}: "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
        # the repeat shows the run-to-run spread of one card (atomics)
        print(f"mesh {sharding} 1 vs 1 repeat: "
              f"{rel(outs[2], outs[0]):.3e}", flush=True)
        sm.check(f"mesh {sharding} 1 vs {chips}", rel(outs[1], outs[0]),
                 BOUNDS["mesh"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phases", default="kernels,fa_step,cli,quality",
                    help="comma list of one-card phases to run")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import graph_embed  # noqa: F401
        import bench  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository is not here ({e})",
              file=sys.stderr)
        return 2
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devs)}", file=sys.stderr)
        return 2

    sm = Smoke()
    phases = (["mesh"] if args.chips > 1
              else [p for p in args.phases.split(",") if p])
    try:
        card_identity(args.chips)
        if "mesh" in phases:
            mesh_phase(sm, args.chips)
        graphs = None
        if {"kernels", "fa_step", "cli"} & set(phases):
            graphs = bench_graphs()
        if "kernels" in phases:
            import graph_embed as gt

            check_attraction(sm, "scattered", graphs["scattered"], None)
            check_attraction(sm, "mesh dia", graphs["mesh"], None)
            check_attraction(sm, "mesh edges", graphs["mesh"], 0)
            for name, g in graphs.items():
                check_repulsion(sm, name, g)
                check_fa_step(sm, name, g)
            res = gt.partition_hierarchy(graphs["scattered"], 0.1)
            check_refine(sm, graphs["scattered"], res.levels[0])
        if "fa_step" in phases:
            for name, g in graphs.items():
                time_fa_step(name, g)
        if "cli" in phases:
            with tempfile.TemporaryDirectory(dir=ROOT,
                                             prefix=".smoke-") as wd:
                run_cli(sm, graphs["scattered"], wd)
        if "quality" in phases:
            quality(sm)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: a phase raised", file=sys.stderr)
        return 1
    if sm.failures:
        print(f"chip_smoke: failed {sm.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
