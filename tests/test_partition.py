"""Coarsener/modularity/Galerkin tests: invariants + differential vs oracle
(SURVEY.md SS4 points (1)-(3))."""

import numpy as np
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.partition.coarsen import init_state, coarsen_round
from graph_embed.utils.params import PartitionParams

from conftest import random_graph
import oracle


def _two_cliques(k=8, bridge_w=0.1):
    """Two k-cliques joined by one weak edge -- unambiguous communities."""
    s, r, w = [], [], []
    for c in range(2):
        off = c * k
        for i in range(k):
            for j in range(i + 1, k):
                s.append(off + i); r.append(off + j); w.append(1.0)
    s.append(0); r.append(k); w.append(bridge_w)
    return gt.from_edges(s, r, w, n=2 * k, symmetrize=True, dtype=jnp.float64)


def test_modularity_matches_oracle(rng):
    g = random_graph(rng, 60)
    v2a = rng.integers(0, 7, size=60)
    p = gt.Partition(jnp.asarray(v2a.astype(np.int32)), 7)
    got = float(gt.modularity(g, p))
    want = oracle.modularity(g, v2a)
    assert abs(got - want) < 1e-10


def test_modularity_int_truncate_quirk():
    g = gt.from_edges([0, 1, 1, 2], [1, 0, 2, 1], [1.7, 1.7, 2.3, 2.3], n=3,
                      dtype=jnp.float64)
    v2a = np.array([0, 0, 1])
    p = gt.Partition(jnp.asarray(v2a.astype(np.int32)), 2)
    got = float(gt.modularity(g, p, int_truncate=True))
    want = oracle.modularity(g, v2a, int_truncate=True)
    assert abs(got - want) < 1e-10
    # and it differs from the exact math (documented quirk, partitioner.cpp:90)
    assert abs(got - float(gt.modularity(g, p))) > 1e-6


def test_galerkin_matches_dense(rng):
    g = random_graph(rng, 40)
    v2a = rng.integers(0, 5, size=40).astype(np.int32)
    coarse = gt.coarsen_graph(g, v2a, 5)
    want = oracle.galerkin_dense(g, v2a, 5)
    np.testing.assert_allclose(coarse.to_dense_numpy(), want, rtol=1e-12)


def test_partition_of_unity_and_shapes(rng):
    g = random_graph(rng, 200)
    res = gt.partition_hierarchy(g, 0.1)
    # shape chain invariant (embed.cpp:564-570)
    sizes = res.level_sizes
    assert sizes[0] == g.n
    for lvl, p in enumerate(res.levels):
        assert p.n == sizes[lvl]
        assert p.num_aggs == sizes[lvl + 1]
        # partition of unity: every vertex in exactly one aggregate
        v2a = np.asarray(p.vertex_to_agg)
        assert v2a.min() >= 0 and v2a.max() < p.num_aggs
        # every aggregate nonempty
        assert np.bincount(v2a, minlength=p.num_aggs).min() >= 1
    # hierarchy coarsens
    assert sizes[-1] < sizes[0]


def test_coarsen_round_reduces_and_preserves_weight(rng):
    g = random_graph(rng, 100)
    state, T = init_state(g)
    w0 = float(np.asarray(state.ew).sum()) + 0.0
    state2, merged, _ = coarsen_round(state, T)
    assert int(merged) > 0
    # total off-diagonal weight only moves into folded self-loops (alpha),
    # never disappears from the union of both
    alive = np.asarray(state2.ew)
    assert np.isfinite(alive).all()
    # live count consistent with merges
    assert int(np.asarray(state2.live).sum()) == g.n - int(merged)


def test_two_cliques_found():
    g = _two_cliques()
    part = gt.partition_single(g)
    v2a = np.asarray(part.vertex_to_agg)
    # the two cliques end up in different aggregates
    assert len(set(v2a[:8])) == 1
    assert len(set(v2a[8:])) == 1
    assert v2a[0] != v2a[8]
    # modularity close to the ideal for this family
    q = float(gt.modularity(g, part))
    assert q > 0.4


def test_quality_close_to_greedy_reference(rng):
    """Mutual-rule quality parity vs the sequential greedy oracle
    (quality-level, not bitwise -- SURVEY.md SS7 #2)."""
    g = random_graph(rng, 120, avg_deg=6)
    v2a_ref, q_ref, _ = oracle.greedy_partition_rounds(g)
    part = gt.partition_single(g)
    q_ours = float(gt.modularity(g, part))
    q_ref_true = oracle.modularity(g, v2a_ref)
    # within 10% relative (or better)
    assert q_ours > q_ref_true - 0.1 * abs(q_ref_true)


def test_running_q_matches_final_modularity(rng):
    """The coarsener's running Q (sum of committed DeltaQ) must equal the
    modularity of the final partition -- the invariant behind
    partitioner.cpp:1259-1262."""
    g = random_graph(rng, 80)
    state, T = init_state(g)
    m = g.n
    while True:
        state, merged, _ = coarsen_round(state, T)
        m -= int(merged)
        if int(merged) == 0:
            break
    from graph_embed.partition.coarsen import resolve_labels
    labels = np.asarray(resolve_labels(state.label))
    part = gt.partition_from_labels(labels)
    q_direct = oracle.modularity(g, np.asarray(part.vertex_to_agg))
    assert abs(float(state.Q) - q_direct) < 1e-8


def test_num_parts(rng):
    g = random_graph(rng, 150)
    part = gt.partition_num_parts(g, 10)
    assert part.num_aggs <= max(10 * 2, 20) or part.num_aggs <= 150
    # must stop at or soon after crossing num_parts
    assert part.num_aggs >= 1


def test_merge_leaves():
    # star: center 0, leaves 1..5 -- mergeLeaves folds all leaves in
    s = [0] * 5
    r = list(range(1, 6))
    g = gt.from_edges(s, r, None, n=6, symmetrize=True, dtype=jnp.float64)
    part = gt.partition_single(g, PartitionParams(merge_leaves=True,
                                                  positive_merging=False))
    v2a = np.asarray(part.vertex_to_agg)
    assert part.num_aggs == 1
    assert len(set(v2a)) == 1


def test_compose(rng):
    g = random_graph(rng, 100)
    res = gt.partition_hierarchy(g, 0.3)
    if len(res.levels) >= 2:
        comp = gt.compose(res.levels, 2)
        direct = res.levels[1].vertex_to_agg[res.levels[0].vertex_to_agg]
        np.testing.assert_array_equal(np.asarray(comp.vertex_to_agg),
                                      np.asarray(direct))


def test_hierarchy_galerkin_chain(rng):
    """Coarse graphs built level-by-level keep total weight (Galerkin
    conservation: P^T A P preserves the sum of all entries)."""
    g = random_graph(rng, 120)
    res = gt.partition_hierarchy(g, 0.2)
    total0 = float(np.asarray(g.total_weight()))
    cur = g
    for p in res.levels:
        cur = gt.coarsen_graph(cur, np.asarray(p.vertex_to_agg), p.num_aggs)
        assert abs(float(np.asarray(cur.total_weight())) - total0) < 1e-8
        assert cur.n == p.num_aggs


def test_coarsen_coo_device_matches_host(rng):
    """Device-side Galerkin relabel+sum (fixed capacity) == host coarsen
    (ops/spgemm.coarsen_coo_device vs coarsen_graph)."""
    from graph_embed.ops.spgemm import coarsen_coo_device

    g = random_graph(rng, 50)
    v2a = rng.integers(0, 7, size=50).astype(np.int32)
    want = gt.coarsen_graph(g, v2a, 7).to_dense_numpy()
    ns, nr, nw = coarsen_coo_device(g.senders, g.receivers,
                                    jnp.where(g.edge_mask, g.weights, 0),
                                    jnp.asarray(v2a), 7)
    ns, nr, nw = np.asarray(ns), np.asarray(nr), np.asarray(nw)
    got = np.zeros((7, 7))
    live = ns < 7
    np.add.at(got, (ns[live], nr[live]), nw[live])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # duplicates summed: each (s, r) appears at most once among live slots
    keys = ns[live] * 7 + nr[live]
    assert len(keys) == len(set(keys.tolist()))


def test_coarsen_graph_device_chain_matches_host(rng):
    """HBM-resident Galerkin chain (coarsen_graph_device / backend="device")
    produces the same coarse matrices as the host chain, level by level."""
    from graph_embed.embed.driver import build_galerkin_chain
    from graph_embed.ops.spgemm import coarsen_graph_device

    g = random_graph(rng, 120)
    res = gt.partition_hierarchy(g, 0.2)
    host = build_galerkin_chain(g, res.levels)
    dev = build_galerkin_chain(g, res.levels, backend="device")
    assert len(host) == len(dev)
    for hg, dg in zip(host[1:], dev[1:]):
        assert dg.n == hg.n
        np.testing.assert_allclose(dg.to_dense_numpy(), hg.to_dense_numpy(),
                                   rtol=1e-12, atol=0)
        # CSR indptr built on device matches the host CSR
        np.testing.assert_array_equal(np.asarray(dg.indptr),
                                      np.asarray(hg.indptr))
        # degrees/total weight work on the device-only graph
        np.testing.assert_allclose(np.asarray(dg.degrees(True)),
                                   np.asarray(hg.degrees(True)), rtol=1e-12)
    # single-level call keeps capacity rounded and ghosts == n
    p = res.levels[0]
    dc = coarsen_graph_device(g, p.vertex_to_agg, p.num_aggs)
    assert dc.capacity % 128 == 0
    tail = np.asarray(dc.senders)[dc.num_edges:]
    assert (tail == dc.n).all()


# ---------------------------------------------------------------------------
# Native (C++) coarsener backend: same algorithm at host wall-clock
# ---------------------------------------------------------------------------

def _assert_hierarchies_equal(a, b):
    assert a.level_sizes == b.level_sizes
    assert len(a.levels) == len(b.levels)
    for pa, pb in zip(a.levels, b.levels):
        assert pa.num_aggs == pb.num_aggs
        np.testing.assert_array_equal(np.asarray(pa.vertex_to_agg),
                                      np.asarray(pb.vertex_to_agg))
    assert abs(a.modularity - b.modularity) < 1e-8


def test_native_matches_device_hierarchy(rng):
    """native/coarsen.cpp implements the identical mutual-best rounds: with
    the default hash tie-break the hierarchies agree exactly (weighted f64)."""
    pytest.importorskip("graph_embed.native.coarsen_lib")
    g = random_graph(rng, 300, avg_deg=6)
    params = PartitionParams()
    dev = gt.partition_hierarchy(g, 1 / 8, params, backend="device")
    nat = gt.partition_hierarchy(g, 1 / 8, params, backend="native")
    _assert_hierarchies_equal(dev, nat)


def test_native_matches_device_unit_weights_leaves_jitter(rng):
    """Unit weights + merge_leaves + weight_jitter: the degenerate-tie regime
    plus both auxiliary passes, still exact agreement."""
    pytest.importorskip("graph_embed.native.coarsen_lib")
    g = random_graph(rng, 300, avg_deg=5, weighted=False)
    params = PartitionParams(merge_leaves=True, weight_jitter=0.01)
    dev = gt.partition_hierarchy(g, 1 / 8, params, backend="device")
    nat = gt.partition_hierarchy(g, 1 / 8, params, backend="native")
    _assert_hierarchies_equal(dev, nat)


def test_native_single_and_num_parts(rng):
    pytest.importorskip("graph_embed.native.coarsen_lib")
    g = random_graph(rng, 200, avg_deg=5)
    pd = gt.partition_single(g, backend="device")
    pn = gt.partition_single(g, backend="native")
    np.testing.assert_array_equal(np.asarray(pd.vertex_to_agg),
                                  np.asarray(pn.vertex_to_agg))
    pd = gt.partition_num_parts(g, 10, backend="device")
    pn = gt.partition_num_parts(g, 10, backend="native")
    assert pn.num_aggs <= 10 or pn.num_aggs == pd.num_aggs
    np.testing.assert_array_equal(np.asarray(pd.vertex_to_agg),
                                  np.asarray(pn.vertex_to_agg))


def test_native_index_tiebreak_quality(rng):
    """The index tie-break depends on exact equality of independently
    computed gains; XLA CPU's approximate division (tens of ulps) makes
    bitwise agreement impossible, so this mode is held to quality parity
    (same coarsening trajectory scale, close modularity)."""
    pytest.importorskip("graph_embed.native.coarsen_lib")
    g = random_graph(rng, 300, avg_deg=6)
    params = PartitionParams(tie_break="index")
    dev = gt.partition_hierarchy(g, 1 / 8, params, backend="device")
    nat = gt.partition_hierarchy(g, 1 / 8, params, backend="native")
    assert abs(dev.modularity - nat.modularity) < 0.05
    assert abs(len(dev.level_sizes) - len(nat.level_sizes)) <= 1


def test_max_agg_size_cap(rng):
    """Size-penalized matching: per-level member counts never exceed the cap,
    and both backends agree exactly."""
    g = random_graph(rng, 300, avg_deg=6, weighted=False)
    params = PartitionParams(max_agg_size=4)
    dev = gt.partition_hierarchy(g, 1 / 8, params, backend="device")
    sizes = np.bincount(np.asarray(dev.levels[0].vertex_to_agg))
    assert sizes.max() <= 4
    try:
        from graph_embed.native import coarsen_lib  # noqa: F401
        nat = gt.partition_hierarchy(g, 1 / 8, params, backend="native")
        _assert_hierarchies_equal(dev, nat)
    except OSError:
        pass


def test_star_absorb_contracts_hub(rng):
    """A star graph coarsens fully despite mutual-matching serialization:
    the absorb round merges every leaf into the hub at once."""
    import time

    n = 4001
    s = np.zeros(n - 1, dtype=np.int64)
    r = np.arange(1, n, dtype=np.int64)
    g = gt.from_edges(s, r, None, n=n, symmetrize=True, dtype=jnp.float64)
    t0 = time.time()
    res = gt.partition_hierarchy(g, 0.1, backend="native")
    assert time.time() - t0 < 5.0  # one-merge-per-round would crawl
    assert res.levels[-1].num_aggs == 1
    # every leaf lands with the hub
    assert len({int(x) for x in np.asarray(
        gt.compose(res.levels).vertex_to_agg_numpy())}) == 1


def test_force_coarsen_past_modularity_optimum():
    """Power-law graphs stall at the modularity optimum with ~40% of the
    vertices left; the hierarchy path relaxes DeltaQ > 0 (force_coarsen_to)
    and still reaches a small coarsest level.  Device and native backends
    stay identical through absorb + relaxed rounds."""
    from graph_embed.graph.synth import rmat

    g = rmat(12, 8, seed=3, dtype=jnp.float64)
    res_n = gt.partition_hierarchy(g, 0.1, backend="native")
    assert res_n.levels[-1].num_aggs < 0.1 * g.n
    res_d = gt.partition_hierarchy(g, 0.1, backend="device")
    assert [p.num_aggs for p in res_n.levels] == \
        [p.num_aggs for p in res_d.levels]
    for a, b in zip(res_n.levels, res_d.levels):
        np.testing.assert_array_equal(a.vertex_to_agg_numpy(),
                                      b.vertex_to_agg_numpy())
    # community-quality callers are unaffected (no coarsening factor ->
    # positive merging only, so modularity never goes negative)
    part = gt.partition_base(g, 0.999)
    assert float(gt.modularity(g, part)) > 0.0


def test_greedy_native_matches_python(rng):
    """The native one-sided greedy (partitionBase semantics,
    partitioner.cpp:436-694) is bit-identical to the pure-Python
    transcription-equivalent, both variants, weighted and not."""
    from graph_embed.partition.greedy import greedy_partition_py
    from graph_embed.native import greedy_lib

    if not greedy_lib.available():
        pytest.skip("no native toolchain")
    for n, weighted in [(60, True), (150, False)]:
        g = random_graph(rng, n, avg_deg=5, weighted=weighted)
        s, r, w = g.to_coo_numpy()
        for variant in ("base", "base2"):
            p_py, q_py = greedy_partition_py(g, 0.999, variant=variant)
            a_nat, m_nat, q_nat = greedy_lib.greedy_run(
                g.n, s, r, w, stall_stop_threshold=0.999, variant=variant)
            assert m_nat == p_py.num_aggs
            np.testing.assert_array_equal(
                np.asarray(p_py.vertex_to_agg), a_nat)
            assert q_nat == pytest.approx(q_py, rel=1e-6)


def test_greedy_vs_mutual_quality():
    """The harness A/B (run-tests.cpp:285-300): one-sided greedy
    (partition_base) vs the mutual rule (partition_test) both recover a
    planted ring of cliques with the same modularity."""
    edges = []
    for c in range(12):
        b = c * 10
        for i in range(10):
            for j in range(i + 1, 10):
                edges.append((b + i, b + j))
        edges.append((b + 9, ((c + 1) % 12) * 10))
    es = np.array([e[0] for e in edges])
    er = np.array([e[1] for e in edges])
    g = gt.from_edges(es, er, None, n=120, symmetrize=True,
                      dtype=jnp.float64)
    pg = gt.partition_base(g, 0.999)
    pb2 = gt.partition_base2(g, 0.999)
    pm = gt.partition_test(g, 0.999)
    assert pg.num_aggs == 12 and pm.num_aggs == 12 and pb2.num_aggs == 12
    qg = float(gt.modularity(g, pg))
    qm = float(gt.modularity(g, pm))
    assert qg == pytest.approx(qm, abs=1e-9)
    # every clique lands in one aggregate under the greedy rule
    v2a = pg.vertex_to_agg_numpy()
    for c in range(12):
        assert np.unique(v2a[c * 10:(c + 1) * 10]).size == 1


def test_max_agg_size_original_units(rng):
    """cap_unit='original': composed aggregate mass in ORIGINAL vertices
    never exceeds the cap at ANY level (the community-recovery mode), both
    backends identical.  The per-level default would blow past the cap at
    deeper levels (sizes reset at snapshots)."""
    g = random_graph(rng, 400, avg_deg=6, weighted=False)
    params = PartitionParams(max_agg_size=10, cap_unit="original")
    dev = gt.partition_hierarchy(g, 1 / 8, params, backend="device")
    for upto in range(1, len(dev.levels) + 1):
        comp = gt.compose(dev.levels, upto)
        sizes = np.bincount(comp.vertex_to_agg_numpy(), minlength=comp.num_aggs)
        assert sizes.max() <= 10, (upto, sizes.max())
    try:
        from graph_embed.native import coarsen_lib  # noqa: F401
        nat = gt.partition_hierarchy(g, 1 / 8, params, backend="native")
        _assert_hierarchies_equal(dev, nat)
    except OSError:
        pass
    # the per-level unit cap lets deeper levels exceed 10 original vertices
    lvl = gt.partition_hierarchy(g, 1 / 8, PartitionParams(max_agg_size=10),
                                 backend="device")
    comp = gt.compose(lvl.levels)
    assert np.bincount(comp.vertex_to_agg_numpy()).max() > 10


def test_native_emitted_galerkin_chain(rng):
    """partition_hierarchy(emit_graphs=True) emits the Galerkin chain
    straight from the native coarsener's contraction state (round-5 prep
    work): identical sparsity structure to build_galerkin_chain's
    P^T A P and allclose weights (duplicate sums accumulate in a
    different order)."""
    from graph_embed.embed.driver import build_galerkin_chain
    from graph_embed.partition.hierarchy import partition_hierarchy

    for weighted in (False, True):
        g = random_graph(rng, 400, avg_deg=6, weighted=weighted)
        res = partition_hierarchy(g, 0.25, backend="native",
                                  emit_graphs=True)
        assert res.coarse_graphs is not None
        assert len(res.coarse_graphs) == len(res.levels)
        want = build_galerkin_chain(g, res.levels)
        for gn, gw_ in zip(res.coarse_graphs, want[1:]):
            assert gn.n == gw_.n and gn.num_edges == gw_.num_edges
            sn, rn, wn = gn.to_coo_numpy()
            sw, rw_, ww = gw_.to_coo_numpy()
            np.testing.assert_array_equal(sn, sw)
            np.testing.assert_array_equal(rn, rw_)
            np.testing.assert_allclose(wn, ww, rtol=1e-6, atol=1e-9)


def test_native_emitted_chain_with_leaves_and_jitter(rng):
    """Emission parity through the OTHER contraction paths: mergeLeaves
    pre-merges (leaf_round -> contract -> diag) and weight_jitter (the
    emitted chain then carries the jittered weights, like the internal
    state the hierarchy itself used)."""
    from graph_embed.embed.driver import build_galerkin_chain
    from graph_embed.partition.hierarchy import partition_hierarchy
    from graph_embed.utils.params import PartitionParams

    g = random_graph(rng, 350, avg_deg=4, weighted=True)
    res = partition_hierarchy(
        g, 0.3, PartitionParams(merge_leaves=True), backend="native",
        emit_graphs=True)
    assert res.coarse_graphs is not None
    want = build_galerkin_chain(g, res.levels)
    for gn, gw_ in zip(res.coarse_graphs, want[1:]):
        assert gn.n == gw_.n and gn.num_edges == gw_.num_edges
        sn, rn, wn = gn.to_coo_numpy()
        sw, rw_, ww = gw_.to_coo_numpy()
        np.testing.assert_array_equal(sn, sw)
        np.testing.assert_array_equal(rn, rw_)
        np.testing.assert_allclose(wn, ww, rtol=1e-6, atol=1e-9)
