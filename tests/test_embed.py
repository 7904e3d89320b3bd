"""Embed subsystem tests: multilevel FA force parity, radii sweep parity,
renormalization parity, end-to-end multilevel embed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas import multilevel as ml
from graph_embed.embed import radii as R
from graph_embed.utils.params import MultilevelFAParams

from conftest import random_graph
import oracle
import oracle_ml


def _setup_level(rng, n=40, m=6, d=2):
    g = random_graph(rng, n)
    v2a = rng.integers(0, m, size=n).astype(np.int32)
    # ensure every aggregate nonempty
    v2a[:m] = np.arange(m)
    part = gt.Partition(jnp.asarray(v2a), m)
    coords = rng.uniform(-1, 1, size=(n, d))
    coords_A = rng.uniform(-1, 1, size=(m, d))
    return g, part, v2a, coords, coords_A


def test_ml_local_degrees(rng):
    g, part, v2a, _, _ = _setup_level(rng)
    got = np.asarray(ml.local_degrees(g, part, True))
    want = oracle_ml.ml_local_degrees(g, v2a, True)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_ml_forces_match_oracle(rng):
    g, part, v2a, coords, coords_A = _setup_level(rng)
    deg = oracle_ml.ml_local_degrees(g, v2a)
    want = oracle_ml.ml_forces(g, v2a, coords, coords_A, deg)
    params = MultilevelFAParams(repulsion="exact")
    members = ml.build_members(part)
    pull_vec = ml.external_pull(g, part, jnp.asarray(coords_A),
                                pull=params.pull, eps=params.epsilon)
    got = ml.ml_forces(jnp.asarray(coords), g, part, members,
                       jnp.asarray(deg), pull_vec, params)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_ml_forces_variants(rng):
    g, part, v2a, coords, coords_A = _setup_level(rng, n=30, m=4, d=3)
    deg = oracle_ml.ml_local_degrees(g, v2a, use_weights=False)
    want = oracle_ml.ml_forces(g, v2a, coords, coords_A, deg, linlog=True,
                               nohubs=True, use_weights=False)
    params = MultilevelFAParams(repulsion="exact", linlog=True, nohubs=True,
                                use_weights=False)
    members = ml.build_members(part)
    pull_vec = ml.external_pull(g, part, jnp.asarray(coords_A),
                                pull=params.pull, eps=params.epsilon)
    got = ml.ml_forces(jnp.asarray(coords), g, part, members,
                       jnp.asarray(deg), pull_vec, params)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_sweep_matches_oracle_all_pairs(rng):
    m, d = 12, 3
    coords_A = rng.uniform(-2, 2, size=(m, d))
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    dists = [np.linalg.norm(coords_A[i] - coords_A[j]) for i, j in pairs]
    want = oracle_ml.collision_sweep(pairs, dists, m)
    got = np.asarray(R.radii_top_level(jnp.asarray(coords_A)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_sweep_edge_candidates(rng):
    """Sweep over a sparse candidate list matches the oracle on the same
    list (inner-level semantics)."""
    m = 10
    coords_A = rng.uniform(-2, 2, size=(m, 2))
    pairs = [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (7, 8)]
    dists = [np.linalg.norm(coords_A[i] - coords_A[j]) for i, j in pairs]
    want = oracle_ml.collision_sweep(pairs, dists, m)
    pi = jnp.asarray(np.array([p[0] for p in pairs], np.int32))
    pj = jnp.asarray(np.array([p[1] for p in pairs], np.int32))
    tau0 = jnp.asarray(np.array(dists) / 2.0)
    got = np.asarray(R._sweep_one_jit(tau0, pi, pj,
                                      jnp.ones(len(pairs), jnp.bool_), m))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_radii_inner_matches_oracle(rng):
    """Batched per-grandparent sweep == oracle per-aggregate sweeps."""
    # coarse level: 12 child aggregates, 3 grandparents
    m = 12
    coords_A = rng.uniform(-2, 2, size=(m, 2))
    gp = np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2], dtype=np.int32)
    # coarse graph edges (symmetric)
    es = [0, 1, 2, 4, 5, 6, 8, 9, 10, 0]
    er = [1, 2, 3, 5, 6, 7, 9, 10, 11, 4]  # last edge crosses grandparents
    A_c = gt.from_edges(es, er, None, n=m, symmetrize=True,
                        dtype=jnp.float64)
    grandparent = gt.Partition(jnp.asarray(gp), 3)
    r_Ac = rng.uniform(0.5, 1.5, size=3)
    got = np.asarray(R.radii_inner(jnp.asarray(coords_A), jnp.asarray(r_Ac),
                                   None, A_c, grandparent))
    # oracle: per grandparent, candidate pairs = same-gp coarse edges a < j
    want = np.zeros(m)
    s, r, _ = A_c.to_coo_numpy()
    for b in range(3):
        pairs = [(a, j) for a, j in zip(s, r)
                 if a < j and gp[a] == b and gp[j] == b]
        if not pairs:
            continue
        dists = [np.linalg.norm(coords_A[i] - coords_A[j]) for i, j in pairs]
        rb = oracle_ml.collision_sweep(pairs, dists, m)
        for a in np.nonzero(gp == b)[0]:
            want[a] = rb[a]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_radii_singleton_inherits(rng):
    m = 3
    coords_A = rng.uniform(-1, 1, size=(m, 2))
    gp = np.array([0, 0, 1], dtype=np.int32)  # grandparent 1 has 1 child
    A_c = gt.from_edges([0], [1], None, n=m, symmetrize=True,
                        dtype=jnp.float64)
    grandparent = gt.Partition(jnp.asarray(gp), 2)
    r_Ac = np.array([2.0, 0.7])
    got = np.asarray(R.radii_inner(jnp.asarray(coords_A), jnp.asarray(r_Ac),
                                   None, A_c, grandparent))
    assert got[2] == pytest.approx(0.7)


def test_renormalize_matches_oracle(rng):
    m, mc, d = 9, 3, 2
    gp = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2], dtype=np.int32)
    coords_A = rng.uniform(-2, 2, size=(m, d))
    r_A = rng.uniform(0.1, 1.0, size=m)
    coords_Ac = rng.uniform(-2, 2, size=(mc, d))
    r_Ac = rng.uniform(0.5, 2.0, size=mc)
    want_c, want_r = oracle_ml.renormalize(coords_A, r_A, coords_Ac, r_Ac, gp)
    got_c, got_r = R.renormalize_into_parents(
        jnp.asarray(coords_A), jnp.asarray(r_A), jnp.asarray(coords_Ac),
        jnp.asarray(r_Ac), gt.Partition(jnp.asarray(gp), mc))
    np.testing.assert_allclose(np.asarray(got_c), want_c, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got_r), want_r, rtol=1e-12)


def test_ml_epilogue_packs_into_parent_balls(rng):
    """After refinement every vertex lies within r_A of its parent center
    (forceatlas.hpp:539-570 guarantees max-norm scaling)."""
    g, part, v2a, _, coords_A = _setup_level(rng, n=48, m=6)
    r_A = rng.uniform(0.5, 1.0, size=6)
    out = np.asarray(ml.force_atlas_multilevel(
        g, part, jnp.asarray(coords_A), jnp.asarray(r_A), 2,
        key=jax.random.PRNGKey(1), iterations=5))
    dist = np.linalg.norm(out - coords_A[v2a], axis=1)
    assert (dist <= r_A[v2a] + 1e-9).all()
    assert np.isfinite(out).all()


def test_embed_end_to_end(rng):
    g = random_graph(rng, 300, avg_deg=6)
    coords, res = gt.embed_graph(g, dim=2, coarsening_factor=0.2,
                                 base_iterations=200, refine_iterations=20,
                                 key=jax.random.PRNGKey(0))
    coords = np.asarray(coords)
    assert coords.shape == (300, 2)
    assert np.isfinite(coords).all()   # NaN assertion, embedder.cpp:224-228
    assert len(res.levels) >= 1


def test_embed_validates_shape_chain(rng):
    g = random_graph(rng, 50)
    bad_part = gt.Partition(jnp.zeros(49, jnp.int32), 1)
    with pytest.raises(ValueError):
        gt.embed([g, g], [bad_part], 2)


def test_embed_via_minimization_runs(rng):
    g = random_graph(rng, 20)
    coords = gt.embed_via_minimization(g, 2, iterations=3)
    c = np.asarray(coords)
    assert c.shape == (20, 2)
    assert np.isfinite(c).all()
    # normalized to unit ball over vertices 1..n-1 (embed.cpp:528-557)
    assert np.linalg.norm(c[1:], axis=1).max() == pytest.approx(1.0)


def test_embed_via_custom_block(rng):
    g = random_graph(rng, 80)
    res = gt.partition_hierarchy(g, 0.3)
    graphs = gt.build_galerkin_chain(g, res.levels)

    def flat(sub, dim, key=None):
        return gt.force_atlas(sub, dim, key=key, iterations=20)

    block = gt.any_to_multilevel(flat)
    coords = gt.embed_via(graphs, res.levels, 2, block,
                          base_iterations=50, refine_iterations=10)
    c = np.asarray(coords)
    assert c.shape == (80, 2) and np.isfinite(c).all()


def test_ml_full_iteration_and_epilogue_match_oracle(rng):
    """One complete refinement iteration + epilogue vs the loop transcription
    (swing clamp, speed schedule, ball packing)."""
    from graph_embed.forceatlas.multilevel import _ml_loop

    g, part, v2a, coords, coords_A = _setup_level(rng, n=36, m=5, d=2)
    r_A = rng.uniform(0.5, 1.2, size=5)
    deg = oracle_ml.ml_local_degrees(g, v2a)
    params = MultilevelFAParams(repulsion="exact")
    members = ml.build_members(part)
    pull_vec = ml.external_pull(g, part, jnp.asarray(coords_A),
                                pull=params.pull, eps=params.epsilon)
    deg_loc = ml.local_degrees(g, part, True)

    got = np.asarray(_ml_loop(
        jnp.asarray(coords), g, part, members, deg_loc, pull_vec,
        jnp.asarray(coords_A), jnp.asarray(r_A), params, 1))

    x1, _ = oracle_ml.ml_iteration(g, v2a, coords, np.zeros_like(coords),
                                   coords_A, deg)
    want = oracle_ml.ml_epilogue(v2a, x1, coords_A, r_A)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_minimization_matches_oracle(rng):
    """Coordinate-descent embedder vs the literal transcription of
    src/embed.cpp:341-559 (same warm start, 2 sweeps)."""
    from graph_embed.embed.minimization import embed_via_minimization
    import oracle_min

    g = random_graph(rng, 12, avg_deg=3)
    x0 = rng.uniform(-1, 1, size=(12, 2))
    want = oracle_min.minimize_sweeps(g, x0, 2)
    got = np.asarray(embed_via_minimization(
        g, 2, coords=jnp.asarray(x0), iterations=2))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)


def test_embed_graph_deterministic(rng):
    """Same key => identical layout (the determinism contract replacing the
    reference's std::random_device nondeterminism; SURVEY.md SS5 race row)."""
    g = random_graph(rng, 80)
    a, _ = gt.embed_graph(g, 2, coarsening_factor=0.3, base_iterations=40,
                          refine_iterations=5, key=jax.random.PRNGKey(9))
    b, _ = gt.embed_graph(g, 2, coarsening_factor=0.3, base_iterations=40,
                          refine_iterations=5, key=jax.random.PRNGKey(9))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_radii_top_level_edge_fallback(rng):
    """Above max_all_pairs the top-level sweep restricts candidates to
    coarse-graph edges (the reference's dormant doAll=false branch,
    embed.cpp:626-634) -- verify against the oracle on the same list."""
    m = 30
    coords_A = rng.uniform(-2, 2, size=(m, 3))
    es = rng.integers(0, m, size=60)
    er = rng.integers(0, m, size=60)
    keep = es != er
    A_c = gt.from_edges(es[keep], er[keep], None, n=m, symmetrize=True,
                        dtype=jnp.float64)
    s, r, _ = A_c.to_coo_numpy()
    got = np.asarray(R.radii_top_level(jnp.asarray(coords_A),
                                       max_all_pairs=8,
                                       coarse_edges=(s, r)))
    pairs = [(int(a), int(b)) for a, b in zip(s, r) if a < b]
    dists = [np.linalg.norm(coords_A[i] - coords_A[j]) for i, j in pairs]
    want = oracle_ml.collision_sweep(pairs, dists, m)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_embed_via_minimization_block(rng):
    """The reference's actual generic-path use: anyToMultilevel over
    embedViaMinimization (embed.hpp:22-34)."""
    g = random_graph(rng, 60, avg_deg=4)
    res = gt.partition_hierarchy(g, 0.3)
    graphs = gt.build_galerkin_chain(g, res.levels)

    def flat(sub, dim, key=None):
        return gt.embed_via_minimization(sub, dim, iterations=2, key=key)

    block = gt.any_to_multilevel(flat)
    coords = gt.embed_via(graphs, res.levels, 2, block,
                          base_iterations=30, refine_iterations=5)
    c = np.asarray(coords)
    assert c.shape == (60, 2) and np.isfinite(c).all()


def test_embed_warm_start(rng):
    """coords0 warm-starts every level (base FA + local refinement frames);
    output stays finite and the projection chain has the right shapes."""
    from graph_embed.embed.driver import project_to_levels, embed

    g = random_graph(rng, 250, avg_deg=6)
    res = gt.partition_hierarchy(g, 0.2)
    graphs = gt.build_galerkin_chain(g, res.levels)
    prev = np.asarray(rng.uniform(-1, 1, size=(g.n, 2)), np.float32)

    cs = project_to_levels(jnp.asarray(prev), res.levels)
    assert len(cs) == len(res.levels) + 1
    for c, n_l in zip(cs, [g.n] + [p.num_aggs for p in res.levels]):
        assert c.shape == (n_l, 2)
    # aggregate means really are means
    v2a = np.asarray(res.levels[0].vertex_to_agg)
    a0 = v2a[0]
    np.testing.assert_allclose(np.asarray(cs[1])[a0],
                               prev[v2a == a0].mean(axis=0), rtol=1e-5)

    coords = np.asarray(embed(graphs, res.levels, 2,
                              key=jax.random.PRNGKey(3), base_iterations=50,
                              refine_iterations=10, coords0=prev))
    assert coords.shape == (g.n, 2)
    assert np.isfinite(coords).all()
    # warm start is deterministic: same inputs -> same layout
    coords2 = np.asarray(embed(graphs, res.levels, 2,
                               key=jax.random.PRNGKey(3), base_iterations=50,
                               refine_iterations=10, coords0=prev))
    np.testing.assert_allclose(coords, coords2)


def test_radii_disconnected_fallbacks(rng):
    """Aggregates untouched by any sweep candidate (mutually disconnected
    components) get half-nearest-center radii instead of the reference's 0
    (which collapses their children onto one point)."""
    from graph_embed.embed.radii import radii_top_level, radii_inner

    # top level: no coarse edges at all
    c = rng.uniform(-1, 1, size=(600, 3))
    r = np.asarray(radii_top_level(jnp.asarray(c),
                                   coarse_edges=(np.empty(0, np.int64),
                                                 np.empty(0, np.int64))))
    assert (r > 0).all()
    # balls stay disjoint: r_i + r_j <= d_ij for the closest pair
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert (r[:, None] + r[None, :] <= d + 1e-9).min()

    # inner level: grandparent with several children but no intra edges
    m = 9
    coords_A = rng.uniform(-1, 1, size=(m, 2))
    r_Ac = np.ones(3, np.float64)
    gpart = gt.Partition(jnp.asarray(np.array([0, 0, 0, 1, 1, 1, 2, 2, 2],
                                              np.int32)), 3)
    # coarse graph: edges only inside grandparent 0
    cg = gt.from_edges(np.array([0, 1]), np.array([1, 2]), None, n=m,
                       symmetrize=True, dtype=jnp.float64)
    r_A = np.asarray(radii_inner(jnp.asarray(coords_A), jnp.asarray(r_Ac),
                                 None, cg, gpart))
    assert (r_A > 0).all()


def test_host_sweep_matches_device(rng):
    """The heap host sweep (large-pair-count path) is semantically identical
    to the device fori sweep, including tie-breaks and gap updates."""
    from graph_embed.embed.radii import _sweep_host, _sweep_one_jit

    S = 40
    c = rng.uniform(-1, 1, size=(S, 3))
    iu, ju = np.triu_indices(S, k=1)
    keep = rng.random(iu.size) < 0.4
    pi, pj = iu[keep].astype(np.int32), ju[keep].astype(np.int32)
    d = np.linalg.norm(c[pi] - c[pj], axis=1)
    tau0 = (d / 2.0).astype(np.float64)
    want = np.asarray(_sweep_one_jit(jnp.asarray(tau0), jnp.asarray(pi),
                                     jnp.asarray(pj),
                                     jnp.ones(pi.size, bool), S))
    got = _sweep_host(tau0, pi, pj, S)
    np.testing.assert_array_equal(got, want)
    # with exact duplicate taus too (tie-break by pair index)
    tau_t = np.round(tau0, 1)
    want = np.asarray(_sweep_one_jit(jnp.asarray(tau_t), jnp.asarray(pi),
                                     jnp.asarray(pj),
                                     jnp.ones(pi.size, bool), S))
    got = _sweep_host(tau_t, pi, pj, S)
    np.testing.assert_array_equal(got, want)


def test_radii_inner_host_sweep_bucket(rng, monkeypatch):
    """A grandparent over the host-sweep pair threshold produces the same
    radii as the device bucket path."""
    from graph_embed.embed import radii as RD

    n, mc = 120, 4
    gp = gt.Partition(jnp.asarray((np.arange(n) % mc).astype(np.int32)), mc)
    s = rng.integers(0, n, size=2500)
    r = rng.integers(0, n, size=2500)
    keep = s != r
    cg = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                       dtype=jnp.float64)
    coords = rng.uniform(-1, 1, size=(n, 3))
    r_Ac = np.ones(mc)
    want = np.asarray(RD.radii_inner(jnp.asarray(coords), jnp.asarray(r_Ac),
                                     None, cg, gp))
    monkeypatch.setattr(RD, "HOST_SWEEP_P", 4)  # force the host path
    got = np.asarray(RD.radii_inner(jnp.asarray(coords), jnp.asarray(r_Ac),
                                    None, cg, gp))
    np.testing.assert_array_equal(got, want)


def test_radii_inner_native_matches_bucketed(rng):
    """radii_inner backend='auto' (one batched native sweep over all
    grandparents) is BITWISE the bucketed device/host path, f64 and f32,
    including singleton inheritance and untouched-children fallbacks."""
    from graph_embed.embed import radii as RD
    from graph_embed.native import sweep_lib

    if not sweep_lib.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    n, mc = 300, 14
    gp_sizes = rng.multinomial(n - mc, np.ones(mc) / mc) + 1
    v2a = np.repeat(np.arange(mc), gp_sizes).astype(np.int32)
    gp = gt.Partition(jnp.asarray(v2a), mc)
    s = rng.integers(0, n, size=3000)
    r = rng.integers(0, n, size=3000)
    keep = s != r
    for dtype in (jnp.float64, jnp.float32):
        cg = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                           dtype=dtype)
        coords = rng.uniform(-1, 1, size=(n, 3))
        r_Ac = np.ones(mc)
        cA = jnp.asarray(coords, dtype)
        want = np.asarray(RD.radii_inner(cA, jnp.asarray(r_Ac, dtype),
                                         None, cg, gp, backend="bucketed"))
        got = np.asarray(RD.radii_inner(cA, jnp.asarray(r_Ac, dtype),
                                        None, cg, gp, backend="auto"))
        np.testing.assert_array_equal(got, want)


def test_native_sweep_matches_python(rng):
    """The C++ first-collision sweep (native/sweep.cpp) is BIT-identical to
    the Python heap reference (_sweep_host) -- same pops, same tie-breaks
    (tau, then pair index), same 2*tau - tpop gap updates in the candidate
    dtype -- for f64 and f32, with and without exact duplicate taus, and
    with repeated (i, j) pairs."""
    from graph_embed.embed.radii import _sweep_host
    from graph_embed.native import sweep_lib

    if not sweep_lib.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    for S, P, seed in ((40, 300, 0), (500, 8000, 1), (97, 2000, 2)):
        r2 = np.random.default_rng(seed)
        c = r2.uniform(-1, 1, size=(S, 3))
        pi = r2.integers(0, S - 1, size=P).astype(np.int32)
        pj = (pi + 1 + r2.integers(0, S - pi - 1)).astype(np.int32)
        d = np.linalg.norm(c[pi] - c[pj], axis=1)
        for tau0 in ((d / 2.0).astype(np.float64),
                     (d / 2.0).astype(np.float32),
                     np.round(d / 2.0, 1).astype(np.float64),  # heavy ties
                     np.round(d / 2.0, 1).astype(np.float32)):
            want = _sweep_host(tau0, pi, pj, S)
            got = sweep_lib.sweep_run(tau0, pi, pj, S)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_default_base_iterations_policy():
    """embed()'s base_iterations=None resolves to the size-aware default
    min(params.iterations, max(10k, 12n)) --
    floor for tiny coarsest levels, the n=1630-justified 12/vertex slope,
    never above the reference's own 100k default."""
    from graph_embed.embed.driver import default_base_iterations
    from graph_embed.utils.params import ForceAtlasParams

    p = ForceAtlasParams()
    assert default_base_iterations(100, p) == 10_000
    assert default_base_iterations(1630, p) == 19_560
    assert default_base_iterations(10**6, p) == 100_000
    assert default_base_iterations(10**6, ForceAtlasParams(iterations=500)) \
        == 500
