"""Slot-space multilevel refinement vs the portable implementation and the
numpy oracle, and the one refine-route decision."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas import multilevel as ml
from graph_embed.forceatlas import multilevel_tiled as mlt
from graph_embed.utils.params import MultilevelFAParams


def _level(rng, n=120, m=10, d=2, weighted=False):
    mm = n * 3
    s = rng.integers(0, n, size=mm)
    r = rng.integers(0, n, size=mm)
    keep = s != r
    w = rng.uniform(0.5, 2.0, size=keep.sum()) if weighted else None
    g = gt.from_edges(s[keep], r[keep], w, n=n, symmetrize=True,
                      dtype=jnp.float32)
    v2a = rng.integers(0, m, size=n).astype(np.int32)
    v2a[:m] = np.arange(m)
    part = gt.Partition(jnp.asarray(v2a), m)
    coords_A = rng.uniform(-1, 1, size=(m, d)).astype(np.float32)
    return g, part, v2a, coords_A


def test_refine_forces_match_portable(rng):
    g, part, v2a, coords_A = _level(rng)
    params = MultilevelFAParams()
    layout = mlt.prepare_refine(g, part, params)
    coords_v = rng.uniform(-1, 1, size=(g.n, 2)).astype(np.float32)

    # portable reference forces (gram repulsion, f32 weights)
    members = ml.build_member_buckets(part)
    deg_loc = ml.local_degrees(g, part, True)
    pull_vec = ml.external_pull(g, part, jnp.asarray(coords_A),
                                pull=params.pull, eps=params.epsilon)
    want = np.asarray(ml.ml_forces(jnp.asarray(coords_v), g, part, members,
                                   deg_loc, pull_vec, params))

    slot = np.asarray(layout.slot_of_vertex)
    coords_s = np.zeros((layout.n_slots, 2), np.float32)
    coords_s[slot] = coords_v
    pull_s = np.zeros((layout.n_slots, 2), np.float32)
    pull_s[slot] = np.asarray(pull_vec)
    got_s = mlt.refine_forces(jnp.asarray(coords_s), layout,
                              jnp.asarray(pull_s), params, 2)
    got = np.asarray(got_s)[slot]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_refine_level_tiled_runs_and_packs(rng):
    g, part, v2a, coords_A = _level(rng, n=90, m=8)
    r_A = rng.uniform(0.5, 1.0, size=8).astype(np.float32)
    out = np.asarray(mlt.refine_level_tiled(
        g, part, jnp.asarray(coords_A), jnp.asarray(r_A), 2,
        key=jax.random.PRNGKey(0), iterations=4))
    assert out.shape == (g.n, 2)
    assert np.isfinite(out).all()
    dist = np.linalg.norm(out - coords_A[v2a], axis=1)
    assert (dist <= r_A[v2a] + 1e-5).all()


def test_layout_invariants(rng):
    g, part, v2a, _ = _level(rng, n=200, m=16)
    layout = mlt.prepare_refine(g, part, MultilevelFAParams())
    slot = np.asarray(layout.slot_of_vertex)
    assert len(set(slot.tolist())) == g.n          # injective
    agg = np.asarray(layout.agg_of_slot)
    np.testing.assert_array_equal(agg[slot], v2a)  # consistent
    valid = np.asarray(layout.valid_slot)
    assert valid.sum() == g.n
    # slots of one aggregate are contiguous
    for a in range(part.num_aggs):
        ss = np.sort(slot[v2a == a])
        assert (np.diff(ss) == 1).all()


def test_sampled_bucket_repulsion_unbiased(rng):
    """Mean of the per-aggregate negative-sampling estimator over many keys
    converges to the exact repulsion of the same bucket."""
    m_b, S, dim = 3, 64, 2
    x3 = np.zeros((mlt.D_PAD, m_b, S), np.float32)
    cnts = [64, 40, 1]
    for b, c in enumerate(cnts):
        # jittered grid: separated points keep the 1/d^3 estimator variance
        # bounded (uniform points create near-pairs whose Monte-Carlo noise
        # converges too slowly for a tight tolerance)
        gx, gy = np.meshgrid(np.arange(8), np.arange(8))
        pts = np.stack([gx.ravel(), gy.ravel()], axis=0)[:, :c] * 0.3
        x3[:dim, b, :c] = pts + rng.uniform(-0.05, 0.05, size=(dim, c))
        x3[mlt.D_PAD - 1, b, :c] = rng.integers(0, 5, size=c)  # deg_loc
        x3[mlt.D_PAD - 1, b, c:] = -1.0                        # ghosts
    x3 = jnp.asarray(x3)
    exact = np.asarray(mlt._diff_batch_xla(x3, 1.3, 1e-5, dim))

    @jax.jit
    def one(key):
        return mlt._bucket_repulsion_sampled(x3, key, jnp.arange(m_b), 512,
                                             1.3, 1e-5, dim)

    acc = np.zeros_like(exact)
    reps = 800
    for i in range(reps):
        acc += np.asarray(one(jax.random.PRNGKey(i)))
    got = acc / reps
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got / scale, exact / scale, atol=2.2e-2)


def test_refine_level_tiled_sampled_oversize(rng):
    """An oversize (snowballed) aggregate takes the sampled path end-to-end:
    finite output, members packed inside the parent ball."""
    n, m = 700, 8
    mm = n * 3
    s = rng.integers(0, n, size=mm)
    r = rng.integers(0, n, size=mm)
    keep = s != r
    g = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=jnp.float32)
    v2a = np.zeros(n, np.int32)
    v2a[:m] = np.arange(m)
    v2a[m:100] = rng.integers(1, m, size=100 - m)
    # aggregate 0 snowballs: 600 members -> S = 1024 bucket
    part = gt.Partition(jnp.asarray(v2a), m)
    coords_A = rng.uniform(-1, 1, size=(m, 2)).astype(np.float32)
    r_A = rng.uniform(0.5, 1.0, size=m).astype(np.float32)
    params = MultilevelFAParams(sampled_slots_threshold=1024)
    layout = mlt.prepare_refine(g, part, params)
    assert any(S >= 1024 for (_, _, S) in layout.bucket_meta)
    out = np.asarray(mlt.refine_level_tiled(
        g, part, jnp.asarray(coords_A), jnp.asarray(r_A), 2,
        key=jax.random.PRNGKey(0), iterations=4, params=params,
        layout=layout))
    assert np.isfinite(out).all()
    d = np.linalg.norm(out - coords_A[v2a], axis=1)
    assert np.all(d <= r_A[v2a] + 1e-4)


def test_gram_batch_sliced_matches_batch(rng):
    """The sliced batch (used when a bucket's [m_b, S, S] interaction would
    out-grow its byte budget) must equal the one-shot batch, including
    ghost padding of the last slice."""
    from graph_embed.forceatlas import multilevel_tiled as MT

    x = np.zeros((MT.D_PAD, 7, 32), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, 7, 32))
    dval = rng.uniform(0, 4, (7, 32)).astype(np.float32)
    dval[:, 28:] = -1.0
    x[MT.D_PAD - 1] = dval
    x3 = jnp.asarray(x)
    want = np.asarray(MT._diff_batch_xla(x3, 1.2, 1e-5, 3))
    # force 2-aggregate slices (7 -> 4 slices with ghost padding)
    got = np.asarray(MT._diff_batch_sliced(x3, 1.2, 1e-5, 3,
                                           max_bytes=2 * 32 * 32 * 4))
    # f32 reduction order differs between batch shapes
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("S", [8, 16, 32, 64, 128])
def test_bucket_repulsion_matches_oracle(rng, S, dim):
    """Within-aggregate repulsion of one size class (diff form) against the
    numpy transcription of forceatlas.hpp:394-410 (attraction, pull and
    gravity switched off)."""
    import oracle_ml

    sizes = [S, S // 2 + 1, S - 1, S // 2 + 2]
    n = sum(sizes)
    v2a = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    perm = rng.permutation(n)
    v2a = v2a[perm]
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=jnp.float32)
    part = gt.Partition(jnp.asarray(v2a), len(sizes))
    params = MultilevelFAParams(repel=1.3, attract=0.0, pull=0.0,
                                gravity=0.0)
    layout = mlt.prepare_refine(g, part, params)
    assert {S_b for (_, _, S_b) in layout.bucket_meta} == {S}
    coords = rng.uniform(-1, 1, size=(n, dim)).astype(np.float32)
    slot = np.asarray(layout.slot_of_vertex)
    cs = np.zeros((layout.n_slots, dim), np.float32)
    cs[slot] = coords
    got = np.asarray(mlt.refine_forces(
        jnp.asarray(cs), layout, jnp.zeros_like(jnp.asarray(cs)), params,
        dim))[slot]
    deg = oracle_ml.ml_local_degrees(g, v2a)
    want = oracle_ml.ml_forces(g, v2a, coords.astype(np.float64),
                               np.zeros((len(sizes), dim)), deg, repel=1.3,
                               attract=0.0, gravity=0.0, pull=0.0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("linlog,backend,want", [
    (False, "auto", "portable"),
    (True, "auto", "portable"),
    (False, "tiled", "slots"),
    (True, "tiled", "portable"),
    (False, "portable", "portable"),
    (True, "portable", "portable"),
])
def test_refine_route(linlog, backend, want):
    """One function picks the refinement route, from the option and the
    attraction form alone -- never from the platform."""
    from graph_embed.embed.driver import refine_route

    assert refine_route(MultilevelFAParams(linlog=linlog), backend) == want


@pytest.mark.parametrize("backend,slot_calls", [("auto", 0), ("tiled", 2)])
def test_embed_follows_refine_route(rng, monkeypatch, backend, slot_calls):
    """embed() runs the route refine_route names at every level."""
    from graph_embed.forceatlas import multilevel_tiled as MT

    calls = []
    orig = MT.refine_level_tiled
    monkeypatch.setattr(MT, "refine_level_tiled",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    g, part, v2a, _ = _level(rng, n=200, m=16)
    g2 = gt.build_galerkin_chain(g, [part])
    parts2 = gt.partition_hierarchy(g2[1], 0.5).levels[:1]
    graphs = gt.build_galerkin_chain(g, [part] + parts2)
    out = gt.embed(graphs, [part] + parts2, 2, key=jax.random.PRNGKey(0),
                   base_iterations=5, refine_iterations=2,
                   refine_backend=backend)
    assert np.isfinite(np.asarray(out)).all()
    assert len(calls) == slot_calls


def test_refine_route_rejects_unknown_backend():
    from graph_embed.embed.driver import refine_route

    with pytest.raises(ValueError, match="refine_backend"):
        refine_route(MultilevelFAParams(), "pallas")


def test_giant_bucket_blocked_matches_batch(rng):
    """Row-blocked exact repulsion (giant aggregates) equals the one-shot
    diff-form batch, including ghost slots and a ragged last row block."""
    x = np.zeros((mlt.D_PAD, 3, 96), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, 3, 96))
    dval = rng.uniform(0, 4, (3, 96)).astype(np.float32)
    dval[:, 80:] = -1.0
    x[mlt.D_PAD - 1] = dval
    x3 = jnp.asarray(x)
    want = np.asarray(mlt._diff_batch_xla(x3, 1.2, 1e-5, 3))
    got = np.asarray(mlt._diff_blocked_xla(x3, 3, 1.2, 1e-5, block=40))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-6)
