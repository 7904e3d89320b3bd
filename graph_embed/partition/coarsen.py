"""Device-side modularity coarsener: parallel mutual-best-DeltaQ matching.

Array re-design of the reference's coarseners
(src/partitioner.cpp: partitionTest :116-433, partitionBase :436-694,
partition single-level :970-1266, numParts :1272-1544, hierarchy :1550-1893).

The reference keeps per-vertex ``std::map`` adjacency and merges pairs with a
greedy sequential commit loop.  That shape is wrong for an accelerator; the state
is flat edge arrays at fixed capacity and each round is one jitted program:

  1. per-edge gain   eta_e = 2 (w_e / T - alpha_i alpha_j)     (:1715)
  2. per-vertex best partner via segment-max + smallest-index tie-break
  3. commit *mutual best* pairs (partitionTest's order-independent rule,
     :252: ``max_ind[j] == i``) -- the parallel-safe matching; the greedy
     one-sided rule (:1732) is order-dependent and kept only as a host oracle
     in the test suite (SURVEY.md SS7 hard-part #2)
  4. union (label[j] = i), relabel edge endpoints, fold self-loops,
     sum duplicate edges by a two-pass stable sort, merge alpha
  5. repeat ``matching_iterations`` times per round with a ``notouch`` mask
     between passes (:1135, :1182-1183)

Everything is static-shaped: dead edge slots carry sender = receiver = n_cap
and weight 0; dead vertices are tracked with a live mask.  The round loop is
host-driven (a handful of scalar readbacks), matching SURVEY.md SS7 layer 4.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..graph.csr import Graph


NEG_INF = -jnp.inf


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CoarsenState:
    """Flat coarsening state at fixed capacity.

    es/er/ew: [E] contracted edge arrays, both directions stored, self-loops
              removed (like the reference ``a[i]`` maps, partitioner.cpp:991).
              Dead slots: es = er = n, ew = 0.
    alpha:    [n] row sums (incl. original diagonal) divided by T (:1594).
    live:     [n] bool, vertex still a representative.
    label:    [n] union-find parent pointer (id[], :1620).
    Q:        running modularity (scalar).
    """

    es: jnp.ndarray
    er: jnp.ndarray
    ew: jnp.ndarray
    alpha: jnp.ndarray
    live: jnp.ndarray
    label: jnp.ndarray
    Q: jnp.ndarray
    size: jnp.ndarray  # [n] member count per representative (for the
    #                    optional max_agg_size matching cap)

    def tree_flatten(self):
        return (self.es, self.er, self.ew, self.alpha, self.live, self.label,
                self.Q, self.size), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n(self) -> int:
        return int(self.alpha.shape[0])


def init_state(g: Graph, *, weight_jitter: float = 0.0
               ) -> tuple[CoarsenState, jnp.ndarray]:
    """Build the initial state from a symmetric Graph.  Returns (state, T).

    alpha_i = full row sum including diagonal (partitioner.cpp:1565-1577);
    Q_0 = d_sum/T - sum_i alpha_i^2 (:1601-1605); the edge list drops
    self-loops (:1569).  ``weight_jitter`` applies a deterministic symmetric
    per-undirected-edge factor (1 + jitter*u), u in [-1, 1) from an integer
    hash of the endpoint pair -- the tie-break randomization of
    run-tests.cpp:162-181, made reproducible.
    """
    n = g.n
    w = jnp.where(g.edge_mask, g.weights, 0)
    if weight_jitter > 0.0:
        lo = jnp.minimum(g.senders, g.receivers).astype(jnp.uint32)
        hi = jnp.maximum(g.senders, g.receivers).astype(jnp.uint32)
        h = (lo * jnp.uint32(2654435761) ^ (hi * jnp.uint32(40503) + jnp.uint32(0x9E3779B9)))
        u = (h >> 8).astype(jnp.float32) / jnp.float32(1 << 24) * 2.0 - 1.0
        w = w * (1.0 + weight_jitter * u.astype(w.dtype))
    T = jnp.sum(w)
    alpha = jax.ops.segment_sum(w, g.senders, num_segments=n + 1)[:n] / T
    is_self = g.senders == g.receivers
    d_sum = jnp.sum(jnp.where(is_self, w, 0))
    keep = g.edge_mask & ~is_self
    es = jnp.where(keep, g.senders, n).astype(jnp.int32)
    er = jnp.where(keep, g.receivers, n).astype(jnp.int32)
    ew = jnp.where(keep, w, 0)
    Q0 = d_sum / T - jnp.sum(alpha * alpha)
    state = CoarsenState(
        es=es, er=er, ew=ew, alpha=alpha,
        live=jnp.ones(n, dtype=jnp.bool_),
        label=jnp.arange(n, dtype=jnp.int32),
        Q=Q0,
        size=jnp.ones(n, dtype=jnp.int32),
    )
    return state, T


def _dedup_edges(es, er, ew, n_cap: int):
    """Sum duplicate (s, r) edges; drop self-loops and zero-weight slots.

    Two-pass stable sort = lexicographic (s, r); group heads + segment-sum.
    Returns arrays in sorted order with dead slots (s = r = n_cap, w = 0) at
    the end.  Fully static shapes.
    """
    E = es.shape[0]
    dead = (ew == 0) | (es == er) | (es >= n_cap)
    s = jnp.where(dead, n_cap, es)
    r = jnp.where(dead, n_cap, er)
    w = jnp.where(dead, 0, ew)
    order1 = jnp.argsort(r, stable=True)
    order2 = jnp.argsort(s[order1], stable=True)
    order = order1[order2]
    s, r, w = s[order], r[order], w[order]
    is_new = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), (s[1:] != s[:-1]) | (r[1:] != r[:-1])]
    )
    seg = jnp.cumsum(is_new) - 1
    w_sum = jax.ops.segment_sum(w, seg, num_segments=E)
    heads = jnp.nonzero(is_new, size=E, fill_value=E - 1)[0]
    ns, nr, nw = s[heads], r[heads], w_sum
    ngroups = jnp.sum(is_new)
    keep = (jnp.arange(E) < ngroups) & (ns < n_cap)
    return (jnp.where(keep, ns, n_cap).astype(jnp.int32),
            jnp.where(keep, nr, n_cap).astype(jnp.int32),
            jnp.where(keep, nw, 0))


def _edge_hash(es, er, salt):
    """Deterministic symmetric per-undirected-edge priority in [0, 2^31).

    Symmetry (hash of {i, j}) matters: when eta ties, both endpoints rank the
    tied edges by the SAME pair priority, so the locally max-priority edge is
    chosen from both sides and matches -- the classic random-edge parallel
    matching.  An asymmetric hash would make mutual agreement ~1/deg likely."""
    lo = jnp.minimum(es, er).astype(jnp.uint32)
    hi = jnp.maximum(es, er).astype(jnp.uint32)
    h = lo * jnp.uint32(2654435761) ^ (hi * jnp.uint32(40503)
                                       + jnp.uint32(0x9E3779B9))
    h = h ^ (salt.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    return (h >> 1).astype(jnp.int32)


def _best_partner(es, er, ew, alpha, live, notouch, T, salt, size, cap,
                  positive_merging: bool, tie_break: str):
    """Per-vertex best merge partner: (eta, pair-hash, -id) lexicographic max.

    Returns (partner [n] int32, -1 = none; gain [n]: eta at the chosen edge).

    ``cap`` (traced int scalar; 0 = off): pairs whose merged member count
    would exceed it are excluded -- the size-penalized matching that keeps
    aggregates balanced on tie-heavy mesh families.
    """
    n = alpha.shape[0]
    valid = (ew != 0) & ~notouch[jnp.clip(es, 0, n - 1)] & ~notouch[jnp.clip(er, 0, n - 1)] \
        & (es < n) & (er < n)
    merged_size = (size[jnp.clip(es, 0, n - 1)]
                   + size[jnp.clip(er, 0, n - 1)])
    valid = valid & ((cap <= 0) | (merged_size <= cap))
    eta = 2.0 * (ew / T - alpha[jnp.clip(es, 0, n - 1)] * alpha[jnp.clip(er, 0, n - 1)])
    eta = jnp.where(valid, eta, NEG_INF)
    seg = jnp.where(es < n, es, n)
    m = jax.ops.segment_max(eta, seg, num_segments=n + 1)[:n]
    is_best = eta == m[jnp.clip(es, 0, n - 1)]
    is_best = is_best & (eta > NEG_INF)
    if tie_break == "hash":
        # among eta-ties, prefer the edge with max symmetric pair hash (salted
        # per pass).  Uniform-weight graphs tie *everywhere* (every unit edge
        # of equal-alpha endpoints), and the smallest-index rule then yields
        # almost no mutual pairs (all vertices point down-index): profiling a
        # 262k 3D mesh showed 155 rounds under the index rule vs ~30 with the
        # hash rule.  Deterministic given (edge, salt); salt varies per pass.
        h = _edge_hash(es, er, salt)
        hv = jnp.where(is_best, h, -1)
        hm = jax.ops.segment_max(hv, seg, num_segments=n + 1)[:n]
        is_best = is_best & (hv == hm[jnp.clip(es, 0, n - 1)])
    # final tie-break: smallest partner id, making the matching fully
    # order-independent and deterministic
    cand = jnp.where(is_best, er, n).astype(jnp.int32)
    best = jax.ops.segment_min(cand, seg, num_segments=n + 1)[:n]
    has = (m > NEG_INF) & (best < n) & live & ~notouch
    if positive_merging:
        has = has & (m > 0.0)
    partner = jnp.where(has, best, -1)
    return partner, m


def _match_pass(es, er, ew, alpha, live, notouch, T, salt, size, cap,
                positive_merging: bool, tie_break: str):
    """One matching pass: per-vertex best partner, mutual commit.

    Returns (match_to [n] int32: for a removed vertex j, its representative i;
    -1 elsewhere; pair_gain [n]: eta at the representative; notouch updated).
    """
    n = alpha.shape[0]
    partner, m = _best_partner(es, er, ew, alpha, live, notouch, T, salt,
                               size, cap, positive_merging, tie_break)
    has = partner >= 0
    # mutual: partner[partner[i]] == i
    pp = jnp.where(has, partner, 0)
    mutual = has & (partner[pp] == jnp.arange(n, dtype=jnp.int32))
    # canonical orientation: representative = smaller index
    iarr = jnp.arange(n, dtype=jnp.int32)
    is_removed = mutual & (partner < iarr)  # j > i gets removed into i
    match_to = jnp.where(is_removed, partner, -1)
    is_rep = mutual & (partner > iarr)
    pair_gain = jnp.where(is_rep, m, 0.0)
    notouch = notouch | mutual
    return match_to, pair_gain, notouch


@partial(jax.jit, static_argnames=("matching_iterations", "positive_merging",
                                   "tie_break"))
def coarsen_round(state: CoarsenState, T, salt=0, max_agg_size=0, *,
                  matching_iterations: int = 2, positive_merging: bool = True,
                  tie_break: str = "hash"):
    """One coarsening round (the body of the do-loop at partitioner.cpp:1696).

    ``salt`` (traced int scalar, typically the round index) varies the hash
    tie-break between rounds without recompiling.  ``max_agg_size`` (traced
    int scalar, 0 = off) excludes merges whose member count would exceed it.
    Returns (new_state, num_merged, num_live_edges) -- both scalars device
    ints (the live-edge count rides along so capacity-shrinking needs no
    extra program).
    """
    n = state.n
    salt = jnp.asarray(salt, jnp.int32)
    cap = jnp.asarray(max_agg_size, jnp.int32)
    notouch = ~state.live  # dead vertices can never match
    match_to_all = jnp.full(n, -1, dtype=jnp.int32)
    gain_total = jnp.zeros((), dtype=state.ew.dtype)
    for it in range(matching_iterations):
        match_to, pair_gain, notouch = _match_pass(
            state.es, state.er, state.ew, state.alpha, state.live, notouch,
            T, salt * matching_iterations + it, state.size, cap,
            positive_merging, tie_break)
        match_to_all = jnp.where(match_to >= 0, match_to, match_to_all)
        gain_total = gain_total + jnp.sum(pair_gain)

    return _commit(state, match_to_all, gain_total)


def _commit(state: CoarsenState, match_to_all, gain_total):
    """Apply a set of merges (match_to_all[j] = representative or -1): union,
    alpha/size merge, one-hop endpoint relabel, dedup.  Targets of committed
    merges are never themselves removed (mutual orientation / absorb receive
    rule), so one relabel gather suffices."""
    n = state.n
    removed = match_to_all >= 0
    num_merged = jnp.sum(removed)

    # union: label[j] = i (partitioner.cpp:1828)
    label = jnp.where(removed, match_to_all, state.label)

    # alpha merge: alpha[i] += alpha[j] (:1770)
    rep_of = jnp.where(removed, match_to_all, n)  # scatter target, ghost drops
    alpha = state.alpha + jax.ops.segment_sum(
        jnp.where(removed, state.alpha, 0.0), rep_of, num_segments=n + 1)[:n]
    size = state.size + jax.ops.segment_sum(
        jnp.where(removed, state.size, 0), rep_of, num_segments=n + 1)[:n]

    map_v = jnp.where(removed, match_to_all, jnp.arange(n, dtype=jnp.int32))
    es = jnp.where(state.es < n, map_v[jnp.clip(state.es, 0, n - 1)], n).astype(jnp.int32)
    er = jnp.where(state.er < n, map_v[jnp.clip(state.er, 0, n - 1)], n).astype(jnp.int32)
    es2, er2, ew2 = _dedup_edges(es, er, state.ew, n)

    live = state.live & ~removed
    new_state = CoarsenState(es=es2, er=er2, ew=ew2, alpha=alpha, live=live,
                             label=label, Q=state.Q + gain_total, size=size)
    return new_state, num_merged, jnp.sum(ew2 != 0)


@partial(jax.jit, static_argnames=("positive_merging", "tie_break"))
def absorb_round(state: CoarsenState, T, salt=0, max_agg_size=0, *,
                 positive_merging: bool = True, tie_break: str = "hash"):
    """Star-absorption round: many-to-one commits for hub-dominated graphs.

    The mutual-best rule serializes hub contraction -- on power-law graphs
    (RMAT/social/web families) every leaf's best partner is the hub but the
    hub reciprocates with exactly one of them, so each round removes one
    vertex per hub and coarsening collapses (262k RMAT: merge rate < 1%
    after a few rounds, hierarchy truncates at a 0.43 level ratio).  Here
    every vertex j with a best partner p(j) merges into p(j) unless j itself
    *receives* a merge; receivers are never removed, so labels stay one hop
    and a star contracts in ONE round.  The reference's one-sided greedy
    commit (partitioner.cpp:1732) has the same serialization (notouch[i']
    blocks further merges into a touched hub within a round) -- this is a
    deliberate capability extension, not a parity deviation; quality is
    checked by modularity as usual.  Running-Q accounting uses pre-round
    alphas, so it is approximate under multi-absorb (recompute via
    modularity() for exact values); the size cap is likewise checked
    pairwise.  Mutual pairs (i <-> j) both "receive" and are left to the
    regular rounds."""
    n = state.n
    salt = jnp.asarray(salt, jnp.int32)
    cap = jnp.asarray(max_agg_size, jnp.int32)
    notouch = ~state.live
    partner, m = _best_partner(state.es, state.er, state.ew, state.alpha,
                               state.live, notouch, T, salt, state.size, cap,
                               positive_merging, tie_break)
    has = partner >= 0
    tgt = jnp.where(has, partner, n)
    receives = jnp.zeros(n + 1, jnp.bool_).at[tgt].set(True)[:n]
    removed = has & ~receives
    match_to = jnp.where(removed, partner, -1)
    gain_total = jnp.sum(jnp.where(removed, m, 0.0))
    return _commit(state, match_to, gain_total)


@jax.jit
def merge_leaves_round(state: CoarsenState, T, positive: jnp.ndarray):
    """One pass of the mergeLeaves pre-pass (partitioner.cpp:1642-1689):
    every vertex with exactly one incident edge merges into its neighbor.
    Mutual-leaf pairs (2-vertex components) keep the smaller index.
    Returns (new_state, num_merged)."""
    n = state.n
    seg = jnp.where(state.es < n, state.es, n)
    one = jnp.where(state.ew != 0, 1, 0)
    deg = jax.ops.segment_sum(one, seg, num_segments=n + 1)[:n]
    nbr = jax.ops.segment_max(
        jnp.where(state.ew != 0, state.er, -1), seg, num_segments=n + 1)[:n]
    wt = jax.ops.segment_max(
        jnp.where(state.ew != 0, state.ew, NEG_INF), seg, num_segments=n + 1)[:n]
    is_leaf = state.live & (deg == 1) & (nbr >= 0)
    gain = 2.0 * (wt / T - state.alpha * state.alpha[jnp.clip(nbr, 0, n - 1)])
    ok = is_leaf & jnp.where(positive, gain > 0, True)
    # conflict: two leaves pointing at each other (a 2-vertex component) --
    # only the larger index merges in; the smaller survives as representative
    iarr = jnp.arange(n, dtype=jnp.int32)
    nbr_c = jnp.clip(nbr, 0, n - 1)
    both = ok & ok[nbr_c]
    keep_side = ~(both & (iarr < nbr))  # smaller index survives
    removed = ok & keep_side
    match_to = jnp.where(removed, nbr, -1)

    num = jnp.sum(removed)
    label = jnp.where(removed, match_to, state.label)
    rep_of = jnp.where(removed, match_to, n)
    alpha = state.alpha + jax.ops.segment_sum(
        jnp.where(removed, state.alpha, 0.0), rep_of, num_segments=n + 1)[:n]
    size = state.size + jax.ops.segment_sum(
        jnp.where(removed, state.size, 0), rep_of, num_segments=n + 1)[:n]
    gain_total = jnp.sum(jnp.where(removed, gain, 0.0))
    map_v = jnp.where(removed, match_to, iarr)
    es = jnp.where(state.es < n, map_v[jnp.clip(state.es, 0, n - 1)], n).astype(jnp.int32)
    er = jnp.where(state.er < n, map_v[jnp.clip(state.er, 0, n - 1)], n).astype(jnp.int32)
    es2, er2, ew2 = _dedup_edges(es, er, state.ew, n)
    live = state.live & ~removed
    return CoarsenState(es=es2, er=er2, ew=ew2, alpha=alpha, live=live,
                        label=label, Q=state.Q + gain_total, size=size), num


@jax.jit
def resolve_labels(label):
    """Full path compression: label[v] <- root(v) by pointer jumping."""
    def cond(st):
        lab, changed = st
        return changed

    def body(st):
        lab, _ = st
        new = lab[lab]
        return new, jnp.any(new != lab)

    lab, _ = jax.lax.while_loop(cond, body, (label, jnp.array(True)))
    return lab


@jax.jit
def dense_ranks(live):
    """Dense ids for live vertices: rank[v] = #live vertices with id < v."""
    return (jnp.cumsum(live.astype(jnp.int32)) - 1).astype(jnp.int32)
