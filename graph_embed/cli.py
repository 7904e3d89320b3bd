"""Command-line drivers.

``embed`` matches the reference CLI contract exactly
(examples/embed.cpp:37,47-67):

    python -m graph_embed.cli embed -f <input> -format
        {adjlist,coolist,table,csr,mtx} -o <output> [-dimension d]
        [-symmetric true|false] [-metrics <jsonl path>]

(the reference's argv loop is hand-rolled single-dash parsing; reproduced
here, including the default dimension 3 and symmetric false).
``-metrics`` appends one JSON line per phase (read, partition, base,
radii and refine per level, write) with its seconds.  The reference
driver as shipped does not compile (undeclared ``k`` at examples/embed.cpp:96)
-- the intended Galerkin loop over the full hierarchy is what runs here
(SURVEY.md SS7 #6: fix outright bugs).

``embedder`` is the batch pipeline of examples/embedder.cpp:140-295
(largest component, hierarchy, Galerkin, embed, temp dumps, plot).
``run-tests`` is the quality harness (see harness/runtests.py).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _parse_kv(argv):
    opts = {}
    i = 0
    while i < len(argv) - 1:
        if argv[i].startswith("-"):
            opts[argv[i]] = argv[i + 1]
            i += 2
        else:
            i += 1
    # trailing lone flag
    if argv and argv[-1].startswith("-") and argv[-1] not in opts:
        opts[argv[-1]] = ""
    return opts


def cmd_embed(argv) -> int:
    from . import embed_graph, read_graph, write_coords
    from .graph.io import FORMATS
    from .utils.timing import MetricsLogger

    opts = _parse_kv(argv)
    inputpath = opts.get("-f", "")
    outputpath = opts.get("-o", "")
    fmt = opts.get("-format", "")
    dimension = int(opts.get("-dimension", "3"))
    symmetric = opts.get("-symmetric", "false") == "true"
    coarsening = float(opts.get("-coarsening", "0.1"))

    if fmt and fmt not in FORMATS:
        print("-format must be from [adjlist coolist table csr mtx]",
              file=sys.stderr)
        return 1
    if not inputpath:
        print("-f must be present with one argument", file=sys.stderr)
        return 1
    if not outputpath:
        print("-o must be present with one argument", file=sys.stderr)
        return 1
    if not fmt:
        print("--inputformat must be present with one argument",
              file=sys.stderr)
        return 1

    metrics_path = opts.get("-metrics", "")
    metrics = MetricsLogger(metrics_path) if metrics_path else None
    t0 = time.perf_counter()
    g = read_graph(inputpath, fmt, symmetric=symmetric)
    if metrics:
        metrics.log(phase="read", n=g.n, edges=g.num_edges,
                    seconds=time.perf_counter() - t0)
    coords, _ = embed_graph(g, dimension, coarsening_factor=coarsening,
                            metrics=metrics)
    t0 = time.perf_counter()
    write_coords(np.asarray(coords), outputpath)
    if metrics:
        metrics.log(phase="write", seconds=time.perf_counter() - t0)
        metrics.close()
    return 0


def cmd_embedder(argv) -> int:
    """Batch pipeline (examples/embedder.cpp:140-295)."""
    from . import (embed, build_galerkin_chain, largest_component,
                   partition_hierarchy, read_adjlist, write_coords)
    from .graph.io import write_multilevel_partition
    from .utils.params import PartitionParams
    from .viz import plot_graph_html

    opts = _parse_kv(argv)
    inputpath = opts.get("-f", "")
    outdir = opts.get("-outdir", "temp")
    dimension = int(opts.get("-dimension", "3"))
    coarsening = float(opts.get("-coarsening", str(1.0 / 10.0)))
    do_plot = opts.get("-plot", "true") == "true"
    if not inputpath:
        print("-f must be present", file=sys.stderr)
        return 1

    import os

    os.makedirs(outdir, exist_ok=True)
    print(f"doing: {inputpath}")
    g = read_adjlist(inputpath, symmetric=True)
    print(f"before: {g.n}")
    g, _ = largest_component(g)
    print(f"after: {g.n}")
    print(f"{g.n} {g.n} {g.num_edges}")
    print("input read")

    # embedder.cpp:186-187: partition(A, 1/10, false, true, 1.0, 1, false)
    res = partition_hierarchy(g, coarsening, PartitionParams(
        printing=False, positive_merging=True, stall_stop_threshold=1.0,
        matching_iterations=1, merge_leaves=False), emit_graphs=True)
    print("partitioned!")
    print(" ".join(str(s) for s in res.level_sizes))

    # the native backend emits the Galerkin chain with the hierarchy;
    # build_galerkin_chain covers the device-backend fallback
    graphs = ([g] + res.coarse_graphs if res.coarse_graphs is not None
              else build_galerkin_chain(g, res.levels))
    print("starting embedding: ")
    t0 = time.perf_counter()
    coords = np.asarray(embed(graphs, res.levels, dimension))
    print(f"embedded! in time {time.perf_counter() - t0}s")
    assert np.isfinite(coords).all()   # NaN check (embedder.cpp:224-228)

    partpath = f"{outdir}/part.temp"
    coordspath = f"{outdir}/coords.temp"
    plotpath = f"{outdir}/plot.html"
    matpath = f"{outdir}/mat.temp"

    write_multilevel_partition(
        [p.vertex_to_agg_numpy() for p in res.levels], partpath)
    c3 = coords if dimension == 3 else np.concatenate(
        [coords, np.zeros((coords.shape[0], 3 - dimension))], axis=1)
    write_coords(c3, coordspath)
    s, r, _ = g.to_coo_numpy()
    with open(matpath, "w") as f:
        for i, j in zip(s, r):
            f.write(f"{i} {j}\n")
    if do_plot:
        plot_graph_html(matpath, partpath, coordspath, plotpath)
        print(f"wrote {plotpath}")
    return 0


def cmd_run_tests(argv) -> int:
    from .harness.runtests import main as harness_main

    return harness_main(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "embed":
        return cmd_embed(rest)
    if cmd == "embedder":
        return cmd_embedder(rest)
    if cmd in ("run-tests", "runtests"):
        return cmd_run_tests(rest)
    # default: treat argv as embed options (reference has a single binary)
    return cmd_embed(argv)


if __name__ == "__main__":
    raise SystemExit(main())
