"""Quality/benchmark harness.

Array equivalent of examples/run-tests.cpp: for a roster of graphs it
measures partition wall-time (:197-202), modularity (:204), optionally
compares against an external Louvain implementation (:217-227, the reference
shells out to ``lib/Community_latest/community``; here the binary path is a
flag and the comparison is skipped when absent), A/B variant comparison
(:285-300) and ground-truth ``.cmty`` pair-counting similarity (:302-349).

The reference's ``compareComm`` counts pairs with an O(n^2) double loop and
has a quirk: four of its six returned ratios are never incremented
(run-tests.cpp:104-106 are declared but only ``comm1_and_comm2`` is ever
updated) -- so only the last two outputs are meaningful.  Here the pair
counting is exact via a contingency table (O(n + #cells)) and all ratios are
real; the two meaningful reference ratios are reproduced bit-for-bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def read_louvain_aggregates(path, n=None):
    """Parse a Louvain ``.tree`` file (multi-level 'node comm' pairs,
    run-tests.cpp:42-89) into an original-vertex assignment."""
    levels = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            node, comm = int(toks[0]), int(toks[1])
            if node == 0:
                levels.append([])
            levels[-1].append(comm)
    if not levels:
        return np.zeros(0, dtype=np.int64)
    v = np.arange(len(levels[0]), dtype=np.int64)
    for lvl in levels:
        lvl = np.asarray(lvl, dtype=np.int64)
        v = lvl[v]
    return v


def read_cmty(path, n):
    """Ground-truth communities: one community per line listing members
    (the SNAP ``.cmty`` convention consumed at run-tests.cpp:302-317).
    Vertices in no community get -1; in several, the last wins."""
    assign = np.full(n, -1, dtype=np.int64)
    with open(path) as f:
        for c, line in enumerate(f):
            for tok in line.split():
                assign[int(tok)] = c
    return assign


def louvain_networkx(g, seed: int = 0):
    """Louvain community assignment via networkx -- the in-process stand-in
    for the external Louvain binary the reference shells out to
    (run-tests.cpp:217).  Returns [n] labels.

    Scale note: this oracle is practical to ~150k vertices (pure-python
    networkx); at >= 1M the quality loop is closed against the native
    one-sided greedy instead (greedy IS the reference's own partitionBase
    algorithm) plus the layout-stress metric.  networkx is optional: only
    this comparison needs it."""
    try:
        import networkx as nx
    except ImportError as e:
        raise RuntimeError("the networkx Louvain comparison (-louvain "
                           "networkx) needs the networkx package, which is "
                           "not installed") from e

    s, r, w = g.to_coo_numpy()
    G = nx.Graph()
    G.add_nodes_from(range(g.n))
    G.add_weighted_edges_from(zip(s.tolist(), r.tolist(), w.tolist()))
    comms = nx.community.louvain_communities(G, seed=seed)
    assign = np.zeros(g.n, dtype=np.int64)
    for c, members in enumerate(comms):
        for v in members:
            assign[v] = c
    return assign


def pair_counting_similarity(comm1, comm2):
    """Exact pair-counting agreement between two assignments.

    Returns dict with total same-pairs in each, the intersection, and the
    precision/recall-style ratios of run-tests.cpp:331-348 (its two live
    outputs are intersection/total1 and intersection/total2)."""
    comm1 = np.asarray(comm1)
    comm2 = np.asarray(comm2)
    assert comm1.shape == comm2.shape

    def same_pairs(labels):
        _, counts = np.unique(labels, return_counts=True)
        return int((counts * (counts - 1) // 2).sum())

    # contingency table over (comm1, comm2) cells
    key = comm1.astype(np.int64) * (comm2.max() + 2) + comm2
    _, cell_counts = np.unique(key, return_counts=True)
    both = int((cell_counts * (cell_counts - 1) // 2).sum())
    t1, t2 = same_pairs(comm1), same_pairs(comm2)
    return {
        "total_pairs_1": t1,
        "total_pairs_2": t2,
        "pairs_in_both": both,
        "precision": both / t1 if t1 else 0.0,   # run-tests.cpp:347
        "recall": both / t2 if t2 else 0.0,      # run-tests.cpp:348
    }


def _load_roster_graph(graph_path_prefix, fmt):
    """Resolve a roster entry: a file prefix (reads <prefix>.edges) or a
    synthetic spec ``synth:<family>:<args>`` standing in for the reference's
    SNAP/DIMACS roster (run-tests.cpp:361-400) in air-gapped environments:

      synth:mesh3d:L[:extra_frac[:seed]]          roadnet/mesh family
      synth:rmat:scale[:edge_factor[:seed]]       social/web power-law
      synth:planted:k:size[:p_in[:p_out[:seed]]]  ground-truth communities
      synth:ring:cliques:size                     modularity sanity

    Returns (graph, truth_labels_or_None)."""
    import graph_embed as gt
    from ..graph import synth

    if not graph_path_prefix.startswith("synth:"):
        return gt.read_graph(graph_path_prefix + ".edges", fmt,
                             symmetric=True), None
    parts = graph_path_prefix.split(":")
    fam, args = parts[1], parts[2:]
    if fam == "mesh3d":
        return synth.mesh3d(int(args[0]),
                            extra_frac=float(args[1]) if len(args) > 1 else 0.0,
                            seed=int(args[2]) if len(args) > 2 else 0), None
    if fam == "rmat":
        return synth.rmat(int(args[0]),
                          int(args[1]) if len(args) > 1 else 16,
                          seed=int(args[2]) if len(args) > 2 else 0), None
    if fam == "planted":
        g, labels = synth.planted_partition(
            int(args[0]), int(args[1]),
            p_in=float(args[2]) if len(args) > 2 else 0.3,
            p_out=float(args[3]) if len(args) > 3 else 0.01,
            seed=int(args[4]) if len(args) > 4 else 0)
        return g, labels
    if fam == "ring":
        return synth.ring_of_cliques(int(args[0]), int(args[1])), None
    raise ValueError(f"unknown synth family: {fam}")


def run_test(graph_path_prefix, fmt="coolist", *, has_true_communities=False,
             louvain_bin=None, do_heuristics=False, randomize=False,
             do_louvain_nx=False, out=sys.stdout):
    """One roster entry (run-tests.cpp:145-353)."""
    import graph_embed as gt

    graph_path = graph_path_prefix + ".edges"
    g, synth_truth = _load_roster_graph(graph_path_prefix, fmt)

    if randomize:
        # +-0.1% random vertex reweighting to break ties
        # (run-tests.cpp:162-181)
        rng = np.random.default_rng(0)
        s, r, w = g.to_coo_numpy()
        vw = rng.uniform(1 - 0.001, 1 + 0.001, size=g.n)
        g = gt.from_edges(s, r, w * vw[s] * vw[r], n=g.n, dtype=g.dtype)

    record = {"graph": graph_path_prefix, "n": g.n, "edges": g.num_edges}
    t0 = time.perf_counter()
    part = gt.partition_base(g, 0.999)
    record["partition_seconds"] = time.perf_counter() - t0
    record["aggregates"] = part.num_aggs
    record["modularity"] = float(gt.modularity(g, part))

    if louvain_bin == "networkx" or (louvain_bin is None and do_louvain_nx):
        t0 = time.perf_counter()
        nx_assign = louvain_networkx(g)
        record["louvain_seconds"] = time.perf_counter() - t0
        lp = gt.partition_from_labels(nx_assign)
        record["louvain_modularity"] = float(gt.modularity(g, lp))
    elif louvain_bin and os.path.exists(louvain_bin):
        tree = graph_path_prefix + ".tree"
        t0 = time.perf_counter()
        subprocess.run([louvain_bin, graph_path, "-l", "-1"],
                       stdout=open(tree, "w"), check=False)
        record["louvain_seconds"] = time.perf_counter() - t0
        louvain = read_louvain_aggregates(tree, g.n)
        if louvain.size == g.n:
            lp = gt.partition_from_labels(louvain)
            record["louvain_modularity"] = float(gt.modularity(g, lp))

    if do_heuristics:
        t0 = time.perf_counter()
        part2 = gt.partition_test(g, 0.999)
        record["variant_seconds"] = time.perf_counter() - t0
        record["variant_modularity"] = float(gt.modularity(g, part2))
        record["variant_similarity"] = pair_counting_similarity(
            part.vertex_to_agg_numpy(), part2.vertex_to_agg_numpy())

    if has_true_communities or synth_truth is not None:
        truth = synth_truth
        if truth is None:
            cmty_path = graph_path_prefix + ".cmty"
            truth = (read_cmty(cmty_path, g.n)
                     if os.path.exists(cmty_path) else None)
        if truth is not None:
            truth = np.asarray(truth)
            mask = truth >= 0
            record["ground_truth_similarity"] = pair_counting_similarity(
                part.vertex_to_agg_numpy()[mask], truth[mask])

    print(json.dumps(record), file=out)
    return record


def main(argv) -> int:
    """CLI: run-tests <prefix> [<prefix> ...] [-louvain <bin>]
    [-communities] [-heuristics] [-format coolist]"""
    prefixes = [a for a in argv if not a.startswith("-")]
    def opt(name, default=None):
        return argv[argv.index(name) + 1] if name in argv else default

    louvain = opt("-louvain")
    fmt = opt("-format", "coolist")
    for p in prefixes:
        run_test(p, fmt, has_true_communities="-communities" in argv,
                 louvain_bin=louvain, do_heuristics="-heuristics" in argv,
                 do_louvain_nx="-louvain-nx" in argv)
    return 0


def layout_stress(g, coords):
    """Edge-stress of a layout with optimal global scale:
    min_a sum_edges (a*|x_i - x_j| - 1)^2 / |E|  (the quality row of
    BASELINE.md; the reference harness never computed it -- run-tests.cpp
    measures partitions only)."""
    import numpy as np

    s, r, _ = g.to_coo_numpy()
    coords = np.asarray(coords)
    keep = s < r
    d = np.linalg.norm(coords[s[keep]] - coords[r[keep]], axis=1)
    denom = float((d * d).sum())
    if denom == 0:
        return float("inf")
    a = float(d.sum()) / denom
    return float(((a * d - 1.0) ** 2).mean())


def run_embed_test(graph_path_prefix, fmt="coolist", *, dim=3,
                   coarsening=0.1, out=sys.stdout):
    """Embed-quality roster entry: multilevel embed wall-clock + stress
    (the embedder pipeline measurement, embedder.cpp:219-222)."""
    import jax

    import graph_embed as gt

    g, _ = _load_roster_graph(graph_path_prefix, fmt)
    record = {"graph": graph_path_prefix, "n": g.n, "edges": g.num_edges}
    t0 = time.perf_counter()
    coords, res = gt.embed_graph(g, dim, coarsening_factor=coarsening)
    jax.block_until_ready(coords)
    record["embed_seconds"] = time.perf_counter() - t0
    record["levels"] = res.level_sizes
    record["stress"] = layout_stress(g, coords)
    record["modularity_l1"] = float(gt.modularity(g, res.levels[0]))
    print(json.dumps(record), file=out)
    return record
