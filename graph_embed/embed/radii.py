"""Aggregate ball radii: the ball-growing / first-collision sweep.

Array re-design of the radii computation of ``embedMultilevel``
(src/embed.cpp:616-678 top level with all pairs, :680-756 inner levels
restricted to coarse-graph edges within one grandparent aggregate).

The reference keeps a sorted vector of "collision times" tau = d_ij/2 and
re-sorts after every assignment.  Device formulation: the sweep over one
candidate list is a ``fori_loop`` that pops the masked argmin each step (no
sort needed); independent per-grandparent subproblems are vmapped.  Pops of
different grandparents never share endpoints, so the batched sweep is exactly
equivalent to the reference's per-aggregate sequential sweeps.

Semantics per pop of the closest alive pair (i, j) at time tau (embed.cpp:
645-677): if neither has a radius both get tau; if exactly one lacks a
radius it gets tau (the remaining gap); pairs touching newly-assigned
vertices update tau' = 2 tau_old - tau_pop; pairs between two assigned
vertices are discarded.  Unassigned vertices keep radius 0 (reference
behavior).  Singleton aggregates inherit the parent radius (:707-711).
Tie-breaking among equal times differs from the reference's tuple sort
(deterministic smallest-index here) -- quality-neutral, SURVEY.md SS7 #2.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _sweep_one(tau0, pi, pj, valid, num_local: int):
    """Sequential collision sweep over one candidate list.

    tau0: [P] initial times (d_ij / 2); pi/pj: [P] local vertex ids in
    [0, num_local); valid: [P] mask.  Returns r [num_local] (0 = unassigned).
    """
    P = tau0.shape[0]
    S = num_local
    BIG = jnp.asarray(jnp.finfo(tau0.dtype).max, tau0.dtype)

    def body(_, carry):
        r, assigned, alive, tau = carry
        masked = jnp.where(alive, tau, BIG)
        idx = jnp.argmin(masked)
        has = masked[idx] < BIG
        i = pi[idx]
        j = pj[idx]
        tpop = tau[idx]
        ai = assigned[i]
        aj = assigned[j]
        newly_i = has & ~ai
        newly_j = has & ~aj
        r = r.at[i].set(jnp.where(newly_i, tpop, r[i]))
        r = r.at[j].set(jnp.where(newly_j, tpop, r[j]))
        assigned = assigned.at[i].set(ai | newly_i)
        assigned = assigned.at[j].set(aj | newly_j)
        alive = alive.at[idx].set(False)
        touched = (newly_i & ((pi == i) | (pj == i))) | (
            newly_j & ((pi == j) | (pj == j)))
        tau = jnp.where(touched & alive, 2.0 * tau - tpop, tau)
        return r, assigned, alive, tau

    r0 = jnp.zeros(S, tau0.dtype)
    a0 = jnp.zeros(S, jnp.bool_)
    carry = (r0, a0, valid, jnp.where(valid, tau0, BIG))
    r, _, _, _ = jax.lax.fori_loop(0, P, body, carry)
    return r


_sweep_one_jit = partial(jax.jit, static_argnums=(4,))(_sweep_one)
_sweep_batched = partial(jax.jit, static_argnums=(4,))(
    jax.vmap(_sweep_one, in_axes=(0, 0, 0, 0, None)))

# candidate lists at least this long sweep on the host: the device sweep is
# a sequential fori_loop with a full argmin per step -- O(P^2) work -- which
# a hub grandparent can push past 1e10 (a 6755-child grandparent at com-LJ
# scale carries ~130k pairs).  The host heap sweep is O(P log P) with
# identical semantics and tie-breaks.
HOST_SWEEP_P = 8192


def _sweep_host(tau0, pi, pj, num_local: int):
    """Heap-based host sweep, semantics identical to _sweep_one: pop the
    alive pair with minimal (tau, pair-index); assign unassigned endpoints
    tau; update alive pairs touching newly-assigned vertices to
    2*tau - tau_popped.  Lazy heap entries are revalidated against the
    current tau, so each pair costs O(log P) per endpoint assignment."""
    import heapq

    P = tau0.shape[0]
    S = num_local
    tau0 = np.asarray(tau0)
    pi = np.asarray(pi)
    pj = np.asarray(pj)
    r = np.zeros(S, tau0.dtype)
    assigned = np.zeros(S, dtype=bool)
    alive = np.ones(P, dtype=bool)
    cur = tau0.copy()
    # per-vertex incident pair lists (CSR over pairs)
    cnt = np.bincount(pi, minlength=S) + np.bincount(pj, minlength=S)
    starts = np.concatenate([[0], np.cumsum(cnt)])
    v_all = np.concatenate([pi, pj])
    k_all = np.concatenate([np.arange(P, dtype=np.int64),
                            np.arange(P, dtype=np.int64)])
    inc = k_all[np.argsort(v_all, kind="stable")]
    heap = [(float(tau0[k]), k) for k in range(P)]
    heapq.heapify(heap)
    while heap:
        t, k = heapq.heappop(heap)
        if not alive[k] or t != float(cur[k]):
            continue
        alive[k] = False
        i, j = int(pi[k]), int(pj[k])
        newly = []
        if not assigned[i]:
            r[i] = cur[k]
            assigned[i] = True
            newly.append(i)
        if not assigned[j]:
            r[j] = cur[k]
            assigned[j] = True
            newly.append(j)
        if not newly:
            continue
        touched = np.unique(np.concatenate(
            [inc[starts[v]: starts[v + 1]] for v in newly]))
        tpop = cur[k]
        for kk in touched:
            if alive[kk]:
                cur[kk] = tau0.dtype.type(2.0) * cur[kk] - tpop
                heapq.heappush(heap, (float(cur[kk]), int(kk)))
    return r


def _sweep(tau0, pi, pj, num_local: int):
    """Host sweep dispatch: the native C++ heap (native/sweep.cpp,
    bit-identical to _sweep_host -- tests/test_embed.py::test_native_sweep_matches_python pins equality)
    when buildable, else the Python reference.  The Python heap costs
    ~50s per million pairs; hub grandparents at LiveJournal scale carry
    ~1e5 pairs each and truncated-hierarchy top sweeps ~2e7."""
    from ..native import sweep_lib

    if sweep_lib.available():
        return sweep_lib.sweep_run(np.asarray(tau0), np.asarray(pi),
                                   np.asarray(pj), num_local)
    return _sweep_host(np.asarray(tau0), np.asarray(pi), np.asarray(pj),
                       num_local)


def _half_nn_radius(coords, *, block: int = 2048):
    """r_i = half the distance to the nearest OTHER center -- the fallback
    radius for aggregates untouched by any sweep candidate (mutually
    disconnected aggregates, e.g. a fully-contracted multi-component graph:
    the coarse graph then has no edges at all, so the edge-candidate sweep
    covers nothing; the reference never meets this because its drivers embed
    one component, embedder.cpp:35-93).  Half-nearest-center keeps the balls
    disjoint, which is the invariant the collision sweep exists to provide."""
    coords = np.asarray(coords)
    m = coords.shape[0]
    if m <= 1:
        return np.ones(m, coords.dtype)
    out = np.empty(m, coords.dtype)
    sq = (coords * coords).sum(-1)
    for b0 in range(0, m, block):
        blk = coords[b0: b0 + block]
        d2 = (sq[b0: b0 + block, None] + sq[None, :]
              - 2.0 * blk @ coords.T)
        np.fill_diagonal(d2[:, b0: b0 + block], np.inf)
        out[b0: b0 + block] = np.sqrt(np.maximum(d2.min(axis=1), 0.0)) / 2.0
    return out


def radii_top_level(coords_A, *, max_all_pairs: int = 512,
                    coarse_edges=None):
    """Top-level radii among all coarsest aggregates (embed.cpp:616-678,
    ``doAll=true``).  Falls back to coarse-graph-edge candidates (the
    reference's dead ``doAll=false`` branch, :626-634) above
    ``max_all_pairs`` aggregates to bound the O(m^2) pair list.  Aggregates
    no candidate pair touches (isolated components) get half the distance
    to their nearest neighbor instead of the reference's radius 0 (which
    would collapse their children onto one point)."""
    coords_A = jnp.asarray(coords_A)
    m = coords_A.shape[0]
    if m <= 1:
        return jnp.ones(m, coords_A.dtype)
    if m <= max_all_pairs or coarse_edges is None:
        iu, ju = np.triu_indices(m, k=1)
        pi_n = iu.astype(np.int32)
        pj_n = ju.astype(np.int32)
    else:
        s, r = coarse_edges
        keep = np.asarray(s) < np.asarray(r)
        pi_n = np.asarray(s)[keep].astype(np.int32)
        pj_n = np.asarray(r)[keep].astype(np.int32)
    if pi_n.size == 0:
        return jnp.asarray(_half_nn_radius(coords_A), dtype=coords_A.dtype)
    if pi_n.size >= HOST_SWEEP_P:
        # host sweep: compute the taus on host too.  The center block is
        # tiny ([m, d] -- one pull), while the device route would ship the
        # [P] pair indices to the device and the [P] taus back (23M pairs =
        # 276 MB round trip at rmat22 scale).
        cA = np.asarray(coords_A)
        dv = cA[pi_n] - cA[pj_n]
        tau0 = (np.sqrt((dv * dv).sum(-1)) / 2.0).astype(cA.dtype)
        r_A = _sweep(tau0, pi_n, pj_n, m)
    else:
        pi = jnp.asarray(pi_n)
        pj = jnp.asarray(pj_n)
        d = coords_A[pi] - coords_A[pj]
        tau0 = jnp.sqrt(jnp.sum(d * d, axis=-1)) / 2.0
        valid = jnp.ones(tau0.shape[0], jnp.bool_)
        r_A = np.asarray(_sweep_one_jit(tau0, pi, pj, valid, m))
    untouched = np.ones(m, dtype=bool)
    untouched[pi_n] = False
    untouched[pj_n] = False
    if untouched.any():
        r_A = r_A.copy()
        r_A[untouched] = _half_nn_radius(coords_A)[untouched]
    return jnp.asarray(r_A)


def radii_inner(coords_A, r_Ac, child_of, coarse_graph, grandparent,
                backend: str = "auto"):
    """Inner-level radii (embed.cpp:680-756): per grandparent aggregate b,
    candidates are coarse-graph edges (a < j) with the same grandparent.

    coords_A:    [m, d] child-aggregate centers (level l+1 coords).
    r_Ac:        [mc] parent (level l+2) radii.
    child_of:    unused placeholder for API symmetry (kept for clarity).
    coarse_graph: the level-(l+1) Graph A_c.
    grandparent: Partition mapping level-(l+1) aggregates to level-(l+2).
    ``backend``: "auto" sweeps every grandparent in ONE native batched
    call (native/sweep.cpp, two threads over the independent rows -- the
    embed.cpp:685 OpenMP axis) when the toolchain is available;
    "bucketed" keeps the device/bucket path (pow2 pair-count classes on
    the vmapped fori sweep + host heaps for hubs).  Outputs are bitwise
    identical (test_radii_inner_native_matches_bucketed).
    Returns r_A [m].
    """
    m = coords_A.shape[0]
    gp = grandparent.vertex_to_agg_numpy()
    mc = grandparent.num_aggs
    s, r, _ = coarse_graph.to_coo_numpy()
    keep = (s < r) & (gp[s] == gp[r])
    es, er = s[keep], r[keep]
    b_of_pair = gp[es]

    # local child ids within each grandparent (host; sizes become static)
    order_v = np.argsort(gp, kind="stable")
    counts_v = np.bincount(gp, minlength=mc)
    starts_v = np.concatenate([[0], np.cumsum(counts_v)])
    pos_v = np.arange(m) - starts_v[gp[order_v]]
    local_of = np.zeros(m, dtype=np.int64)
    local_of[order_v] = pos_v

    dd = np.asarray(coords_A)
    r_A = np.zeros(m, dtype=dd.dtype)

    # Grandparents are swept in power-of-two pair-count buckets.  A single
    # flat [mc, max_pairs] padding is quadratically wrong when one aggregate
    # snowballs (uniform-weight meshes: one level-1 aggregate of the bench
    # mesh holds 23k pairs vs a median of ~10, so the dense form allocated
    # [19038, 23683] sweep state -- out of device memory -- and the vmapped
    # argmin sweep costs P^2 per row at the padded P).  Bucketing keeps the
    # padding within 2x per row and the pow2 classes recur across levels, so
    # the sweep compiles O(log P) programs total.
    counts_p = (np.bincount(b_of_pair, minlength=mc) if es.size
                else np.zeros(mc, np.int64))
    if es.size and backend == "auto":
        from ..native import sweep_lib

        if sweep_lib.available():
            # every grandparent in one batched native call: pairs sorted
            # by grandparent (pair index within a row = the bucketed
            # path's pos_p, so tie-breaks agree bitwise); the concatenated
            # radii land in order_v layout
            order_p = np.argsort(b_of_pair, kind="stable")
            starts_p = np.concatenate([[0], np.cumsum(counts_p)])
            epi = local_of[es[order_p]].astype(np.int32)
            epj = local_of[er[order_p]].astype(np.int32)
            dv = dd[es[order_p]] - dd[er[order_p]]
            tau0 = np.sqrt((dv * dv).sum(-1)) / 2.0
            r_concat = sweep_lib.sweep_batch(tau0.astype(dd.dtype),
                                             epi, epj, starts_p, starts_v)
            r_A[order_v] = r_concat
            return _radii_inner_epilogue(r_A, r_Ac, dd, gp, counts_v,
                                         order_v, starts_v)
    if es.size:
        order_p = np.argsort(b_of_pair, kind="stable")
        starts_p = np.concatenate([[0], np.cumsum(counts_p)])
        sb = b_of_pair[order_p]
        pos_p = np.arange(es.size) - starts_p[sb]
        epi = es[order_p]
        epj = er[order_p]
        pcls = np.zeros(mc, dtype=np.int64)
        haspair = counts_p > 0
        pcls[haspair] = 1 << np.ceil(
            np.log2(counts_p[haspair])).astype(np.int64)
        for P in np.unique(pcls[haspair]):
            rows = np.nonzero(pcls == P)[0]
            mb = rows.size
            rank = np.full(mc, -1, dtype=np.int64)
            rank[rows] = np.arange(mb)
            sel = rank[sb] >= 0
            rsel, psel = rank[sb[sel]], pos_p[sel]
            P = int(P)
            if P >= HOST_SWEEP_P:
                # hub grandparents: heap sweep on host (device fori+argmin
                # is O(P^2): ~1.7e10 steps at ~130k pairs)
                dt = np.dtype(np.asarray(coords_A).dtype)
                for b in rows:
                    pk = order_p[starts_p[b]: starts_p[b + 1]]
                    li = local_of[es[pk]]
                    lj = local_of[er[pk]]
                    dv = (dd[es[pk]] - dd[er[pk]]).astype(dt)
                    tau0 = np.sqrt((dv * dv).sum(-1)) / 2.0
                    S_loc = int(counts_v[b])
                    r_loc1 = _sweep(tau0, li, lj, S_loc)
                    kids = order_v[starts_v[b]: starts_v[b + 1]]
                    r_A[kids] = r_loc1[local_of[kids]]
                continue
            Sb = int(counts_v[rows].max())
            Sb = 1 << (Sb - 1).bit_length() if Sb > 1 else 1
            pair_i = np.zeros((mb, P), dtype=np.int32)
            pair_j = np.zeros((mb, P), dtype=np.int32)
            pvalid = np.zeros((mb, P), dtype=bool)
            pair_i[rsel, psel] = local_of[epi[sel]].astype(np.int32)
            pair_j[rsel, psel] = local_of[epj[sel]].astype(np.int32)
            pvalid[rsel, psel] = True
            dvec = np.zeros((mb, P, dd.shape[1]), dtype=dd.dtype)
            dvec[rsel, psel] = dd[epi[sel]] - dd[epj[sel]]
            tau0 = jnp.asarray(np.sqrt((dvec * dvec).sum(-1)) / 2.0,
                               dtype=coords_A.dtype)
            r_loc = np.asarray(_sweep_batched(
                tau0, jnp.asarray(pair_i), jnp.asarray(pair_j),
                jnp.asarray(pvalid), Sb))
            vsel = rank[gp] >= 0
            r_A[vsel] = r_loc[rank[gp[vsel]], local_of[vsel]]

    return _radii_inner_epilogue(r_A, r_Ac, dd, gp, counts_v, order_v,
                                 starts_v)


def _radii_inner_epilogue(r_A, r_Ac, dd, gp, counts_v, order_v, starts_v):
    # singleton aggregates inherit the parent radius (embed.cpp:707-711)
    singles = counts_v == 1
    if singles.any():
        only_member = order_v[starts_v[:-1][singles]]
        r_A[only_member] = np.asarray(r_Ac)[singles]

    # children no candidate pair touches (multi-child grandparents whose
    # coarse graph has no intra edges -- disconnected-component hierarchies)
    # get half the distance to their nearest sibling instead of radius 0
    untouched = r_A == 0.0
    if untouched.any():
        for b in np.unique(gp[untouched]):
            kids = order_v[starts_v[b]: starts_v[b + 1]]
            if kids.size <= 1:
                continue
            sub = dd[kids]
            d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            nn = np.sqrt(np.maximum(d2.min(axis=1), 0.0)) / 2.0
            need = r_A[kids] == 0.0
            r_A[kids[need]] = nn[need]
    return jnp.asarray(r_A)


def renormalize_into_parents(coords_A, r_A, coords_Ac, r_Ac, grandparent,
                             *, eps: float = 1e-6):
    """Scale children into the parent ball (embed.cpp:757-777):
    alpha_b = max_a (|c_b - c_a| + r_a) over children a of b, clamped at eps;
    c_a <- c_b + (r_b/alpha_b)(c_a - c_b);  r_a <- (r_b/alpha_b) r_a."""
    gp = grandparent.vertex_to_agg
    mc = grandparent.num_aggs
    cb = coords_Ac[gp]                                   # [m, d] parent centers
    dist = jnp.sqrt(jnp.sum((coords_A - cb) ** 2, axis=-1))
    alpha = jax.ops.segment_max(dist + r_A, gp, num_segments=mc)
    alpha = jnp.maximum(alpha, eps)
    scale = (r_Ac / alpha)[gp]
    new_coords = cb + scale[:, None] * (coords_A - cb)
    new_r = scale * r_A
    return new_coords, new_r
