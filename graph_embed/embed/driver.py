"""Multilevel embed driver: coarse-to-fine recursion over the hierarchy.

Array re-design of ``embed`` / ``embedMultilevel``
(src/embed.cpp:561-796).  The recursion is host-level Python over levels
(SURVEY.md SS7 layer 5); all per-level work (flat FA base case, radii sweep,
renormalization, multilevel refinement) runs as jitted device programs.

Per level l (coarse -> fine), matching src/embed.cpp:576-796:
  1. base case (coarsest): flat forceAtlas(A_k, d) (:582-587);
  2. radii: ball-growing first-collision sweep -- all pairs at the first
     level below the base case (:616-678), per-grandparent coarse-graph
     edges further down (:680-756); singletons inherit (:707-711);
  3. renormalize children into parent balls (:757-777) (not at the first
     level below the base case, where there are no parent radii);
  4. refine with forceAtlasMultilevel(A_l, P_l, ..., 100 iters) (:786-793).
"""

from __future__ import annotations

import jax
import numpy as np

from ..graph.csr import Graph
from ..forceatlas.flat import force_atlas
from ..forceatlas.multilevel import force_atlas_multilevel
from ..partition.interpolation import Partition
from ..utils.params import ForceAtlasParams, MultilevelFAParams
from ..utils.timing import MetricsLogger
from .radii import radii_inner, radii_top_level, renormalize_into_parents


def validate_hierarchy(graphs: list[Graph], parts: list[Partition]) -> None:
    """Shape-chain invariants of embed (src/embed.cpp:564-570)."""
    if len(graphs) != len(parts) + 1:
        raise ValueError("need len(graphs) == len(parts) + 1")
    for i, p in enumerate(parts):
        if graphs[i].n != p.n:
            raise ValueError(f"level {i}: graph has {graphs[i].n} vertices "
                             f"but partition maps {p.n}")
        if graphs[i + 1].n != p.num_aggs:
            raise ValueError(f"level {i}: coarse graph has {graphs[i+1].n} "
                             f"vertices but partition makes {p.num_aggs}")


def project_to_levels(coords0, parts: list[Partition]):
    """Aggregate-mean projections of fine coords up the hierarchy:
    returns [c_0 ... c_k] with c_0 = coords0 and c_{l+1}[a] = mean of
    c_l over aggregate a (the warm-start chain)."""
    import jax.numpy as jnp

    cs = [jnp.asarray(coords0)]
    for p in parts:
        v2a = p.vertex_to_agg
        m = p.num_aggs
        sizes = jax.ops.segment_sum(jnp.ones(v2a.shape[0], cs[-1].dtype),
                                    v2a, num_segments=m)
        mean = jax.ops.segment_sum(cs[-1], v2a, num_segments=m)
        cs.append(mean / jnp.maximum(sizes, 1.0)[:, None])
    return cs


# Size-aware default for the coarsest-level (base-case) iteration budget.
# The reference runs a flat 100000 iterations regardless of size
# (forceatlas.hpp:92); at pipeline scale that is almost all waste -- a
# 1,630-vertex coarsest level showed no visible layout change past ~20k
# iterations, i.e. ~12 iterations per vertex sufficed.  base_iterations=None
# in embed() therefore resolves to min(params.iterations, max(FLOOR,
# PER_VERTEX * n)): small levels keep a generous floor (they are cheap),
# large levels never exceed the reference's own default.  Pass
# base_iterations explicitly to override; the flat force_atlas() API keeps
# the faithful reference default untouched.
BASE_ITERS_PER_VERTEX = 12
BASE_ITERS_FLOOR = 10_000


def default_base_iterations(n: int, params: ForceAtlasParams) -> int:
    """Driver default for the coarsest-level iteration count (see above)."""
    return min(params.iterations,
               max(BASE_ITERS_FLOOR, BASE_ITERS_PER_VERTEX * n))


def refine_route(params: MultilevelFAParams,
                 refine_backend: str = "auto") -> str:
    """The one place that picks a refinement route: "slots" or "portable".

    "auto" takes the portable member-table route (forceatlas/multilevel.py)
    at every level: end to end on an H100 it embedded rmat(20, 8) in 34 s
    against 38-42 s for the slot-space route, whose per-iteration speed
    (9x at level 0) does not repay its longer compile at 100 refinement
    iterations (PERF.md).  "tiled" forces the slot-space route, "portable"
    the member tables; linlog always runs portable (the slot route carries
    the linear attraction form only)."""
    if refine_backend not in ("auto", "portable", "tiled"):
        raise ValueError(f"unknown refine_backend {refine_backend!r}")
    if refine_backend == "tiled" and not params.linlog:
        return "slots"
    return "portable"


def embed(graphs: list[Graph], parts: list[Partition], dim: int = 3, *,
          key=None, base_params: ForceAtlasParams | None = None,
          refine_params: MultilevelFAParams | None = None,
          base_iterations: int | None = None,
          refine_iterations: int = 100,
          metrics: MetricsLogger | None = None,
          final_block=None,
          refine_backend: str = "auto",
          coords0=None,
          store=None,
          mesh=None,
          mesh_min_n: int = 65536,
          sharding: str = "replicated",
          base_order=None):
    """Multilevel embedding (src/embed.cpp:561-574 entry + :576-796 body).

    graphs: [A_0 ... A_k] with A_{l+1} = P_l^T A_l P_l (caller-side Galerkin
    exactly as examples/embed.cpp:95-98 -- use ops.spgemm.coarsen_graph).
    parts:  [P_0 ... P_{k-1}] level assignments from partition_hierarchy.
    ``base_iterations``: coarsest-level flat-FA budget.  None (the default)
    resolves to the size-aware ``default_base_iterations(n_k)`` policy --
    min(params.iterations, max(10k, 12*n)) -- instead of the reference's
    flat 100000 (forceatlas.hpp:92), which at pipeline scale is almost all
    converged-already iterations (see the policy comment above).  Pass an
    int to pin the budget exactly.
    ``final_block`` optionally replaces the finest-level refinement with a
    custom building block (the embedViaMultilevel hook, src/embed.cpp:332 --
    coarse levels always use ForceAtlas per the reference's :144 recursion).
    ``refine_backend``: "portable" (member tables + segment ops), "tiled"
    (the slot-space route), or "auto" (see ``refine_route``).
    ``coords0``: optional [n_0, dim] warm-start layout (e.g. a checkpoint or
    a previous embedding of a slightly-changed graph): every level starts
    from its aggregate-mean projection instead of random init -- extends the
    reference's flat-only warm-start hook (forceatlas.hpp:118-125) to the
    whole recursion.
    ``store``: optional CheckpointStore (embed.checkpoint) -- each level's
    outputs are persisted at the natural level boundary and a rerun resumes
    after the last completed level.  Per-level PRNG keys are derived up
    front, so resume == fresh for any backend/warm-start combination.
    ``mesh``: optional jax.sharding.Mesh -- levels with at least
    ``mesh_min_n`` vertices run the sharded refinement (aggregates dealt
    round-robin over devices; zero per-iteration collectives) and a
    coarsest level that large runs the edge-sharded flat step; smaller
    levels run replicated on one device (the DP-like regime,
    SURVEY.md SS2.2).
    ``sharding`` picks the flat-step design for a large coarsest level:
    "replicated" (default) all_gathers the full coordinate block per
    iteration; "halo" partition-orders the level, vertex-partitions the
    coordinates and exchanges ONLY boundary coords + an O(samples) sample
    set per step (parallel/halo.py -- the BASELINE config-5 scaling
    design; per-device memory drops from n_pad to blk + ndev*B_max and the
    interconnect payload from 2*n_pad*d to the cut).  Repulsion is forced
    to 'sampled' on that path (remote coords are never materialized).
    Refinement levels are aggregate-sharded either way (their slot spaces
    already avoid cross-device traffic).
    ``base_order``: optional [n_k] permutation (new_pos -> old_id) for the
    halo base case's locality ordering.  Without it the halo path
    partition-orders the coarsest level by running the coarsener on it
    (~minutes at tens of millions of edges); a caller that truncated a
    deeper hierarchy (the embedder.cpp:189-200 startLevel pattern) already
    HAS that ordering in the dropped levels -- pass
    ``graph.reorder.partition_order(graphs[k], levels=dropped_parts)``.
    Ignored unless sharding == "halo".
    Returns [n_0, dim] coordinates.
    """
    import jax.numpy as jnp

    validate_hierarchy(graphs, parts)
    if sharding not in ("replicated", "halo"):
        # a typo ('Halo', 'haloed') must not silently fall through to the
        # replicated all_gather path with a different repulsion estimator
        raise ValueError(f"unknown sharding {sharding!r}; "
                         "expected 'replicated' or 'halo'")
    if key is None:
        key = jax.random.PRNGKey(0)
    base_params = base_params or ForceAtlasParams()
    refine_params = refine_params or MultilevelFAParams()
    k = len(parts)
    if base_iterations is None:
        base_iterations = default_base_iterations(graphs[k].n, base_params)
    # per-level keys derived up front so a checkpoint resume reproduces the
    # same streams at every level regardless of where it restarts
    level_keys = {}
    kk = key
    for l in range(k, -1, -1):
        kk, sub = jax.random.split(kk)
        level_keys[l] = sub
    warm = None
    if coords0 is not None:
        # match the force path's float width (f64 under x64 testing)
        dt = graphs[0].weights.dtype
        warm = project_to_levels(jnp.asarray(coords0, dtype=dt), parts)

    import time as _time

    def _span(t0, out):
        jax.block_until_ready(out)
        return _time.perf_counter() - t0

    r_Ac = None
    coords_Ac = None
    resume_from = store.last_completed(k) if store is not None else None
    if resume_from is not None:
        data = store.load_level(resume_from)
        coords_A = jnp.asarray(data["coords"])
        r_Ac = jnp.asarray(data["r_A"]) if "r_A" in data else None
        coords_Ac = (jnp.asarray(data["coords_parent"])
                     if "coords_parent" in data else None)
        start = resume_from - 1
        if metrics:
            metrics.log(phase="resume", level=resume_from)
    else:
        # ---- base case: flat ForceAtlas on the coarsest level (:582-587)
        t0 = _time.perf_counter()
        if mesh is not None and graphs[k].n >= mesh_min_n:
            iters_k = base_iterations
            warm_k = warm[k] if warm is not None else None
            if sharding == "halo":
                coords_A = _halo_base_case(
                    graphs[k], dim, mesh, base_params, iters_k,
                    level_keys[k], warm_k, order=base_order)
            else:
                from ..parallel.sharded import sharded_force_atlas

                coords_A = sharded_force_atlas(
                    graphs[k], dim, mesh=mesh, params=base_params,
                    iterations=iters_k, key=level_keys[k], coords0=warm_k)
        else:
            coords_A = force_atlas(graphs[k], dim, key=level_keys[k],
                                   params=base_params,
                                   iterations=base_iterations,
                                   coords=(warm[k] if warm is not None
                                           else None))
        if metrics:
            metrics.log(phase="base", level=k, n=graphs[k].n,
                        seconds=_span(t0, coords_A))
        if store is not None:
            store.save_level(k, coords=coords_A)
        start = k - 1
    if k == 0 or start < 0:
        return coords_A

    for l in range(start, -1, -1):
        A_c = graphs[l + 1]
        t0 = _time.perf_counter()
        if r_Ac is None:
            # first level below the base case: all-pairs sweep (:616-678)
            s, r, _ = A_c.to_coo_numpy()
            r_A = radii_top_level(coords_A, coarse_edges=(s, r))
        else:
            grandparent = parts[l + 1]
            r_A = radii_inner(coords_A, r_Ac, None, A_c, grandparent)
            coords_A, r_A = renormalize_into_parents(
                coords_A, r_A, coords_Ac, r_Ac, grandparent)
        if metrics:
            metrics.log(phase="radii", level=l, m=A_c.n,
                        seconds=_span(t0, r_A))
            t0 = _time.perf_counter()

        sub = level_keys[l]
        local0 = None
        if warm is not None:
            # map the warm fine layout into each aggregate's local frame
            # (refinement works in member offsets packed into parent balls)
            v2a = parts[l].vertex_to_agg
            local0 = ((warm[l] - coords_A[v2a])
                      / jnp.maximum(r_A[v2a], 1e-9)[:, None])
        if l == 0 and final_block is not None:
            coords = final_block(graphs[0], parts[0], coords_A, r_A, dim,
                                 key=sub)
        elif mesh is not None and graphs[l].n >= mesh_min_n:
            from ..parallel.sharded_ml import refine_level_sharded

            coords = refine_level_sharded(
                graphs[l], parts[l], coords_A, r_A, dim, mesh=mesh, key=sub,
                iterations=refine_iterations, params=refine_params,
                coords0=local0)
        elif refine_route(refine_params, refine_backend) == "slots":
            from ..forceatlas.multilevel_tiled import refine_level_tiled

            coords = refine_level_tiled(
                graphs[l], parts[l], coords_A, r_A, dim, key=sub,
                iterations=refine_iterations, params=refine_params,
                coords0=local0)
        else:
            coords = force_atlas_multilevel(
                graphs[l], parts[l], coords_A, r_A, dim, key=sub,
                iterations=refine_iterations, params=refine_params,
                coords0=local0)
        if metrics:
            metrics.log(phase="refine", level=l, n=graphs[l].n,
                        num_aggs=parts[l].num_aggs,
                        seconds=_span(t0, coords))
        if store is not None:
            # state a resume at level l-1 needs: this level's coords, the
            # parent radii r_A, and the (renormalized) parent coords
            store.save_level(l, coords=coords, r_A=r_A,
                             coords_parent=coords_A)
        coords_Ac, r_Ac = coords_A, r_A
        coords_A = coords
    return coords_A


def _halo_base_case(g: Graph, dim: int, mesh, base_params, iterations,
                    key, warm, order=None):
    """Boundary-aware flat base case: partition-order the level so the
    device cut is small, run the halo-exchange FA step (parallel/halo.py),
    and un-permute the result.  The ordering pass reuses the framework's
    own coarsener as the locality order (graph/reorder.py); ``order``
    skips it when the caller already has one (embed's base_order)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from ..graph.reorder import apply_order, partition_order
    from ..parallel.halo import halo_force_atlas

    params = base_params
    if params.repulsion != "sampled":
        params = dataclasses.replace(params, repulsion="sampled")
    perm = np.asarray(order) if order is not None else partition_order(g)
    if perm.shape[0] != g.n:
        raise ValueError(f"base_order has {perm.shape[0]} entries for a "
                         f"{g.n}-vertex coarsest level")
    if order is not None and np.bincount(perm, minlength=g.n).max() != 1:
        # a non-permutation silently corrupts apply_order's inverse scatter
        raise ValueError("base_order is not a permutation of range(n)")
    g_ord, inv = apply_order(g, perm)
    warm_ord = None
    if warm is not None:
        warm_ord = jnp.asarray(warm)[jnp.asarray(perm)]
    # invariant sampling: the replicated flat path is device-count
    # invariant (shared key), so the pipeline's halo base case matches --
    # embed(mesh=..., sharding="halo") layouts are identical at any ndev
    out = halo_force_atlas(g_ord, dim, mesh=mesh, params=params,
                           iterations=iterations, key=key,
                           coords0=warm_ord, sample_mode="invariant")
    return out[jnp.asarray(inv)]


def build_galerkin_chain(g: Graph, parts: list[Partition], *,
                         backend: str = "host") -> list[Graph]:
    """[A_0 ... A_k] via repeated P^T A P (examples/embed.cpp:95-98).

    ``backend="host"`` (default) builds each coarse level with the native
    radix dedup and keeps host COO caches -- the right choice whenever the
    fine graph originated on the host (the embed pipeline needs host COOs
    for edge lists and the radii sweep anyway).  ``backend="device"``
    keeps the whole chain in device memory (ops.spgemm.coarsen_graph_device;
    one scalar readback per level) -- for flat-FA/analysis pipelines on
    graphs that never visit the host."""
    if backend == "device":
        from ..ops.spgemm import coarsen_graph_device

        graphs = [g]
        for p in parts:
            graphs.append(coarsen_graph_device(graphs[-1], p.vertex_to_agg,
                                               p.num_aggs))
        return graphs
    from ..ops.spgemm import coarsen_graph

    graphs = [g]
    for p in parts:
        graphs.append(coarsen_graph(graphs[-1], p.vertex_to_agg_numpy(),
                                    p.num_aggs))
    return graphs


def embed_graph(g: Graph, dim: int = 3, *, coarsening_factor: float = 0.1,
                key=None, **embed_kw):
    """End-to-end convenience: partition + Galerkin + multilevel embed --
    the examples/embed.cpp:93-100 pipeline as one call."""
    import time

    from ..partition.hierarchy import partition_hierarchy

    t0 = time.perf_counter()
    res = partition_hierarchy(g, coarsening_factor, emit_graphs=True)
    graphs = ([g] + res.coarse_graphs if res.coarse_graphs is not None
              else build_galerkin_chain(g, res.levels))
    metrics = embed_kw.get("metrics")
    if metrics:
        metrics.log(phase="partition", levels=len(res.levels),
                    sizes=[gr.n for gr in graphs],
                    seconds=time.perf_counter() - t0)
    return embed(graphs, res.levels, dim, key=key, **embed_kw), res
