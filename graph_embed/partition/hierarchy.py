"""Partition drivers: single-level, numParts, and the multilevel hierarchy.

Array re-design of the three ``partition::partition`` overloads
(src/partitioner.cpp:970-1266 single-level, :1272-1544 numParts,
:1550-1893 hierarchy) plus the ``partitionTest/partitionBase`` variants
(:116-433, :436-694, :696-966) which are behaviorally the same matching loop
in float32.

The round loop is host-driven (merge counts are scalar readbacks); each round
is one jitted device program (coarsen.py).  Level snapshots happen when the
live count crosses the coarsening factor (:1797-1815): the union-find labels
are path-compressed, representatives densely ranked, and the level assignment
recorded.  A final snapshot is always appended (:1840-1853).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..utils.params import PartitionParams
from .coarsen import (CoarsenState, absorb_round, coarsen_round, dense_ranks,
                      init_state, merge_leaves_round, resolve_labels)
from .interpolation import Partition


@dataclasses.dataclass
class HierarchyResult:
    """Outcome of the hierarchy partitioner.

    levels:       list of Partition; levels[l] maps level-l vertices to
                  level-(l+1) aggregates (the reference's vector of P_T's).
    modularity:   final running Q (reference prints it at :1882).
    level_sizes:  [n_0, n_1, ...] vertex counts per level (printed at
                  :1885-1888).
    coarse_graphs: with ``partition_hierarchy(emit_graphs=True)`` on the
                  native backend, the Galerkin chain tail [A_1 ... A_k]
                  emitted straight from the coarsener's contraction state
                  (allclose to build_galerkin_chain up to duplicate-sum
                  order, tested); None otherwise.
    """

    levels: list[Partition]
    modularity: float
    level_sizes: list[int]
    coarse_graphs: list | None = None


@jax.jit
def _snapshot_core(label, live):
    """The fixed-[n]-shape part of a snapshot -- compiled once per graph and
    reused by every level (the per-snapshot shapes (m_prev, m) change, so
    anything jitted with them would recompile ~5s per level)."""
    return resolve_labels(label), dense_ranks(live)


def _snapshot(state: CoarsenState, prev_reps, m: int):
    """Compute (assignment for the previous level, new reps array) ON DEVICE
    (no large label pulls to the host; the live count ``m`` is host-tracked
    so every shape stays static).

    prev_reps: [m_prev] original-vertex ids representing the previous level's
    aggregates.  Returns (assign [m_prev] -> [0, m), reps [m]).
    """
    label, ranks = _snapshot_core(state.label, state.live)
    # eager gathers: tiny per-(m_prev, m) programs, negligible to build
    assign = ranks[label[prev_reps]].astype(jnp.int32)
    reps = jnp.nonzero(state.live, size=m)[0].astype(jnp.int32)
    return assign, reps


def _run_rounds(state: CoarsenState, T, n0: int, params: PartitionParams,
                *, coarsening_factor: float | None = None,
                num_parts: int | None = None):
    """Shared merge loop.  Yields snapshots per coarsening-factor crossing when
    ``coarsening_factor`` is given; otherwise runs to stall (or numParts)."""
    levels: list[Partition] = []
    level_sizes = [n0]
    prev_reps = jnp.arange(n0, dtype=jnp.int32)

    if params.merge_leaves:
        while True:
            state, num = merge_leaves_round(state, T, jnp.asarray(params.positive_merging))
            if int(num) == 0:
                break

    m = int(np.asarray(state.live).sum())
    n_level = n0
    m_prev = m
    rnd = 0
    positive = params.positive_merging
    while True:
        state, merged, live_edges = coarsen_round(
            state, T, rnd, params.max_agg_size,
            matching_iterations=params.matching_iterations,
            positive_merging=positive,
            tie_break=params.tie_break)
        rnd += 1
        merged = int(merged)
        m_prev = m
        m = m - merged

        if (coarsening_factor is not None and params.absorb_below > 0
                and merged < params.absorb_below * m_prev and m > 1
                and (num_parts is None or m > num_parts)):
            # mutual-rate collapse (hub serialization): star-absorb round
            state, merged2, live_edges = absorb_round(
                state, T, rnd * params.matching_iterations,
                params.max_agg_size,
                positive_merging=positive,
                tie_break=params.tie_break)
            rnd += 1
            m = m - int(merged2)

        # shrink the edge capacity as contraction empties it: _dedup_edges
        # leaves live edges in a sorted prefix, so repacking is a device-side
        # slice (each round's sort cost then tracks the live edge count, not
        # the original capacity).  Capacities snap to powers of two so the
        # round program compiles once per 2x size class -- shapes recur across
        # levels, graphs and (with the persistent compilation cache) runs.
        cap = int(state.es.shape[0])
        if cap > 1024:
            live_edges = int(live_edges)
            if live_edges <= cap // 4:
                new_cap = max(1024, 1 << (2 * live_edges - 1).bit_length())
                if new_cap < cap:
                    state = dataclasses.replace(
                        state, es=state.es[:new_cap],
                        er=state.er[:new_cap], ew=state.ew[:new_cap])

        if coarsening_factor is not None and m / n_level <= coarsening_factor:
            assign, prev_reps = _snapshot(state, prev_reps, m)
            levels.append(Partition(assign, m))
            level_sizes.append(m)
            n_level = m
            if params.max_agg_size > 0 and params.cap_unit != "original":
                # the size cap is per level: each snapshot's aggregates are
                # the next level's unit-size vertices (cap_unit="original"
                # keeps accumulating, bounding original-vertex mass instead)
                state = dataclasses.replace(
                    state, size=jnp.ones_like(state.size))

        if num_parts is not None and m <= num_parts:
            break
        if m_prev == 0 or m / max(m_prev, 1) >= params.stall_stop_threshold:
            # stall under an active size cap: merging often halts only
            # because every candidate pair would exceed the cap, not because
            # gains ran out.  Treat it as a level boundary (snapshot + size
            # reset) and resume, provided the level made real progress --
            # otherwise capped hierarchies truncate at the first level whose
            # natural coarsening wants aggregates larger than the cap
            if (params.max_agg_size > 0 and coarsening_factor is not None
                    and m <= 0.8 * n_level and m > 1):
                assign, prev_reps = _snapshot(state, prev_reps, m)
                levels.append(Partition(assign, m))
                level_sizes.append(m)
                n_level = m
                if params.cap_unit != "original":
                    state = dataclasses.replace(
                        state, size=jnp.ones_like(state.size))
                continue
            if (coarsening_factor is not None and positive
                    and params.force_coarsen_to > 0
                    and m > params.force_coarsen_to and m > 1):
                # positive merging exhausted (modularity optimum) while the
                # level is still large: relax DeltaQ > 0 and keep building
                # the embedding hierarchy (params.force_coarsen_to)
                positive = False
                continue
            break
        if m <= 1:
            break

    # final snapshot (partitioner.cpp:1840-1853; skipped when the loop exited
    # right after a crossing snapshot -- an m == m identity level would only
    # add a no-op refinement pass to the embed recursion)
    if not levels or m < level_sizes[-1]:
        assign, prev_reps = _snapshot(state, prev_reps, m)
        levels.append(Partition(assign, m))
        level_sizes.append(m)
    return state, levels, level_sizes


def _native_available(g: Graph) -> bool:
    """The native coarsener is preferred when the graph carries a host COO
    cache (no device pull needed) and the toolchain builds."""
    if getattr(g, "_host_coo", None) is None:
        return False
    try:
        from ..native import coarsen_lib
        coarsen_lib._lib()
        return True
    except Exception:
        return False


def _run_native(g: Graph, params: PartitionParams, *,
                coarsening_factor: float = 0.0, num_parts: int = 0,
                emit_graphs: bool = False):
    """Host C++ backend (native/coarsen.cpp): same mutual-best algorithm and
    tie-breaks as the device round program, at C++ wall-clock (the device
    path's per-capacity-class XLA compiles dominate small/medium graphs)."""
    from ..native import coarsen_lib

    s, r, w = g.to_coo_numpy()
    # the host COO cache may be wider than the device arrays; compute in the
    # graph's dtype so both backends see identical arithmetic
    w = np.asarray(w).astype(np.dtype(g.dtype.name), copy=False)
    out = coarsen_lib.coarsen_run(
        g.n, s, r, w,
        coarsening_factor=coarsening_factor, num_parts=num_parts,
        matching_iterations=params.matching_iterations,
        positive_merging=params.positive_merging,
        stall_stop_threshold=params.stall_stop_threshold,
        merge_leaves=params.merge_leaves, tie_break=params.tie_break,
        weight_jitter=params.weight_jitter,
        max_agg_size=(-params.max_agg_size
                      if params.cap_unit == "original"
                      else params.max_agg_size),
        absorb_below=(params.absorb_below if coarsening_factor > 0 else 0.0),
        force_coarsen_to=(params.force_coarsen_to
                          if coarsening_factor > 0 else 0),
        emit_graphs=emit_graphs)
    assignments, level_sizes, Q = out[:3]
    levels = [Partition.from_numpy(a, int(level_sizes[i + 1]))
              for i, a in enumerate(assignments)]
    graphs = None
    if emit_graphs:
        from ..graph.csr import from_canonical_coo

        graphs = [from_canonical_coo(cs, cr, cw, int(level_sizes[i + 1]),
                                     dtype=g.dtype)
                  for i, (cs, cr, cw) in enumerate(out[3])]
    return levels, level_sizes, Q, graphs


def _pick_backend(backend: str, g: Graph) -> str:
    if backend == "auto":
        return "native" if _native_available(g) else "device"
    return backend


def partition_hierarchy(g: Graph, coarsening_factor: float,
                        params: PartitionParams | None = None,
                        backend: str = "auto",
                        emit_graphs: bool = False) -> HierarchyResult:
    """THE multilevel entry point (partitioner.cpp:1550-1893): returns a
    hierarchy of level assignments, one snapshot per crossing of
    ``coarsening_factor`` plus a final one.

    ``backend``: 'native' = host C++ (native/coarsen.cpp), 'device' = jitted
    round programs (coarsen.py), 'auto' = native when the graph has a host
    COO cache and the toolchain is present.  Both backends implement the
    identical order-independent algorithm and produce the same hierarchy
    (tests/test_partition.py parity)."""
    params = params or PartitionParams()
    if _pick_backend(backend, g) == "native":
        levels, level_sizes, Q, graphs = _run_native(
            g, params, coarsening_factor=coarsening_factor,
            emit_graphs=emit_graphs)
        res = HierarchyResult(levels=levels, modularity=Q,
                              level_sizes=[int(x) for x in level_sizes],
                              coarse_graphs=graphs)
        if params.printing:
            print(f"modularity: {res.modularity}")
            print(f"level 0: {g.n} aggregates")
            for i, p in enumerate(levels):
                print(f"level {i + 1}: {p.num_aggs} aggregates")
        return res
    state, T = init_state(g, weight_jitter=params.weight_jitter)
    state, levels, level_sizes = _run_rounds(
        state, T, g.n, params, coarsening_factor=coarsening_factor)
    res = HierarchyResult(levels=levels, modularity=float(state.Q),
                          level_sizes=level_sizes)
    if params.printing:
        print(f"modularity: {res.modularity}")
        print(f"level 0: {g.n} aggregates")
        for i, p in enumerate(levels):
            print(f"level {i + 1}: {p.num_aggs} aggregates")
    return res


def partition_single(g: Graph, params: PartitionParams | None = None,
                     backend: str = "auto") -> Partition:
    """Single-level production coarsener (partitioner.cpp:970-1266): run the
    merge loop to stall and return one vertex->aggregate Partition."""
    params = params or PartitionParams()
    if _pick_backend(backend, g) == "native":
        levels, _, Q, _ = _run_native(g, params)
        part = levels[0]
        if params.printing:
            print(f"modularity: {Q}")
            print(f"aggregates: {part.num_aggs}")
        return part
    state, T = init_state(g, weight_jitter=params.weight_jitter)
    state, levels, _ = _run_rounds(state, T, g.n, params)
    # compose every snapshot down to original vertices (single final snapshot
    # when no coarsening factor is given)
    assign = levels[0].vertex_to_agg
    for p in levels[1:]:
        assign = p.vertex_to_agg[assign]
    part = Partition(assign, levels[-1].num_aggs)
    if params.printing:
        print(f"modularity: {float(state.Q)}")
        print(f"aggregates: {part.num_aggs}")
    return part


def partition_num_parts(g: Graph, num_parts: int,
                        params: PartitionParams | None = None,
                        backend: str = "auto") -> Partition:
    """numParts variant (partitioner.cpp:1272-1544): also halt once the live
    count reaches ``num_parts``."""
    params = params or PartitionParams()
    if _pick_backend(backend, g) == "native":
        levels, _, _, _ = _run_native(g, params, num_parts=num_parts)
        return levels[0]
    state, T = init_state(g, weight_jitter=params.weight_jitter)
    state, levels, _ = _run_rounds(state, T, g.n, params,
                                   num_parts=num_parts)
    assign = levels[0].vertex_to_agg
    for p in levels[1:]:
        assign = p.vertex_to_agg[assign]
    return Partition(assign, levels[-1].num_aggs)


def partition_test(g: Graph, stall_stop_threshold: float = 1.0) -> Partition:
    """partitionTest-equivalent (partitioner.cpp:116-433): mutual-best rule,
    positive merges only, single matching pass."""
    return partition_single(g, PartitionParams(
        positive_merging=True, stall_stop_threshold=stall_stop_threshold,
        matching_iterations=1))


def _partition_greedy(g: Graph, stall_stop_threshold: float,
                      variant: str, backend: str) -> Partition:
    if backend == "python":
        from .greedy import greedy_partition_py

        part, _ = greedy_partition_py(g, stall_stop_threshold,
                                      variant=variant)
        return part
    from ..native import greedy_lib

    if backend == "auto" and not greedy_lib.available():
        from .greedy import greedy_partition_py

        part, _ = greedy_partition_py(g, stall_stop_threshold,
                                      variant=variant)
        return part
    s, r, w = g.to_coo_numpy()
    assign, m, _ = greedy_lib.greedy_run(
        g.n, s, r, w, stall_stop_threshold=stall_stop_threshold,
        variant=variant)
    return Partition(jnp.asarray(assign), m)


def partition_base(g: Graph, stall_stop_threshold: float = 1.0, *,
                   backend: str = "auto") -> Partition:
    """partitionBase (partitioner.cpp:436-694): the ONE-SIDED greedy rule
    the reference's benchmark harness runs (run-tests.cpp:199).  Per round,
    each live vertex takes its argmax-DeltaQ neighbor; a sequential commit
    merges (i, j) when neither was touched and eta_i >= eta_j -- no
    mutuality required.  Inherently sequential, so it runs on the host
    (native C++ by default, pure-Python fallback with bit-identical f32
    math); the order-independent mutual rule (partition_test / partition)
    remains the production device path."""
    return _partition_greedy(g, stall_stop_threshold, "base", backend)


def partition_base2(g: Graph, stall_stop_threshold: float = 1.0, *,
                    backend: str = "auto") -> Partition:
    """partitionBase2 (partitioner.cpp:696-966): same greedy rule with two
    differences reproduced/noted -- commits have no i<j gate (:836-858), and
    the reference scans neighbors in parallel-array (swap-erase) order,
    a cache-layout A/B we keep sorted instead (documented deviation,
    quality-equivalent)."""
    return _partition_greedy(g, stall_stop_threshold, "base2", backend)
