"""Differential tests: per-iteration force vectors allclose vs the numpy
transcription of forceatlas.hpp:146-269 (BASELINE.md parity requirement)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas import forces as F
from graph_embed.forceatlas.flat import compute_forces, fa_step

from conftest import random_graph
import oracle


def _coords(rng, n, d):
    return rng.uniform(-1, 1, size=(n, d))


@pytest.mark.parametrize("dim", [2, 3])
def test_forces_match_oracle_defaults(rng, dim):
    g = random_graph(rng, 48)
    x = _coords(rng, g.n, dim)
    deg = oracle.degrees(g)
    want = oracle.fa_forces(g, x, deg)
    params = gt.ForceAtlasParams(repulsion="exact")
    got = compute_forces(jnp.asarray(x), g, jnp.asarray(deg), params)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("linlog,nohubs,use_weights,delta", [
    (True, False, True, 1.0),
    (False, True, True, 1.0),
    (False, False, False, 1.0),
    (False, False, True, 0.0),
    (False, False, True, 2.0),
    (True, True, True, 0.5),
])
def test_forces_match_oracle_variants(rng, linlog, nohubs, use_weights, delta):
    g = random_graph(rng, 40)
    x = _coords(rng, g.n, 2)
    deg = oracle.degrees(g, use_weights)
    want = oracle.fa_forces(g, x, deg, linlog=linlog, nohubs=nohubs,
                            use_weights=use_weights, delta=delta)
    params = gt.ForceAtlasParams(repulsion="exact", linlog=linlog,
                                 nohubs=nohubs, use_weights=use_weights,
                                 delta=delta)
    got = compute_forces(jnp.asarray(x), g, jnp.asarray(deg), params)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_full_iteration_matches_oracle(rng):
    g = random_graph(rng, 32)
    x = _coords(rng, g.n, 3)
    deg = oracle.degrees(g)
    fprev = rng.normal(size=x.shape) * 0.1
    want_x, want_f = oracle.fa_iteration(g, x, fprev, deg)
    params = gt.ForceAtlasParams(repulsion="exact")
    got_x, got_f = fa_step(jnp.asarray(x), jnp.asarray(fprev), g,
                           jnp.asarray(deg), params)
    np.testing.assert_allclose(np.asarray(got_f), want_f, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_x), want_x, rtol=1e-9, atol=1e-9)


def test_multiple_iterations_stay_close(rng):
    g = random_graph(rng, 24)
    x = _coords(rng, g.n, 2)
    deg = oracle.degrees(g)
    fprev = np.zeros_like(x)
    params = gt.ForceAtlasParams(repulsion="exact")
    jx, jf = jnp.asarray(x), jnp.asarray(fprev)
    for _ in range(5):
        x, fprev = oracle.fa_iteration(g, x, fprev, deg)
        jx, jf = fa_step(jx, jf, g, jnp.asarray(deg), params)
    np.testing.assert_allclose(np.asarray(jx), x, rtol=1e-7, atol=1e-9)


def test_gram_equals_exact(rng):
    g = random_graph(rng, 200)
    x = jnp.asarray(_coords(rng, g.n, 3))
    deg = g.degrees() + 1.0
    a = F.repulsion_exact(x, deg, 1.0, 1e-5)
    b = F.repulsion_gram(x, deg, 1.0, 1e-5)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-8)


def test_gram_blocked_equals_unblocked(rng):
    g = random_graph(rng, 300)
    x = jnp.asarray(_coords(rng, g.n, 2))
    deg = g.degrees() + 1.0
    a = F.repulsion_gram(x, deg, 1.0, 1e-5, block=4096)
    b = F.repulsion_gram(x, deg, 1.0, 1e-5, block=128)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8)


def test_sampled_repulsion_unbiased(rng):
    g = random_graph(rng, 64)
    x = jnp.asarray(_coords(rng, g.n, 2))
    deg = g.degrees() + 1.0
    exact = np.asarray(F.repulsion_exact(x, deg, 1.0, 1e-5))
    total = np.zeros_like(exact)
    K = 400
    for i in range(K):
        key = jax.random.PRNGKey(i)
        total += np.asarray(F.repulsion_sampled(x, deg, 1.0, 1e-5, key, 64))
    mean = total / K
    # Monte-Carlo mean converges to the exact sum (loose statistical tol)
    err = np.abs(mean - exact) / (np.abs(exact) + 1.0)
    assert np.median(err) < 0.15


def test_force_atlas_runs_and_finite(rng):
    g = random_graph(rng, 50)
    params = gt.ForceAtlasParams(repulsion="gram")
    coords = gt.force_atlas(g, dim=2, params=params, iterations=50,
                            key=jax.random.PRNGKey(7))
    assert coords.shape == (50, 2)
    assert np.isfinite(np.asarray(coords)).all()


def test_force_atlas_deterministic(rng):
    g = random_graph(rng, 30)
    params = gt.ForceAtlasParams(repulsion="exact")
    a = gt.force_atlas(g, 2, params=params, iterations=20,
                       key=jax.random.PRNGKey(3))
    b = gt.force_atlas(g, 2, params=params, iterations=20,
                       key=jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("repulsion", ["exact", "sampled", "centroids"])
def test_force_atlas_device_cpu_matches_default(rng, repulsion):
    """device="cpu" runs the loop on the host backend: same math, same
    threefry draws, so the layout equals the default-backend one."""
    g = random_graph(rng, 24)
    params = gt.ForceAtlasParams(repulsion=repulsion, num_negative_samples=8)
    a = gt.force_atlas(g, 2, params=params, iterations=15,
                       key=jax.random.PRNGKey(3))
    b = gt.force_atlas(g, 2, params=params, iterations=15,
                       key=jax.random.PRNGKey(3), device="cpu")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_force_atlas_rejects_unknown_device(rng):
    g = random_graph(rng, 12)
    with pytest.raises(ValueError, match="device"):
        gt.force_atlas(g, 2, iterations=1, device="auto")


def test_warm_start_respected(rng):
    g = random_graph(rng, 16)
    x0 = jnp.asarray(_coords(rng, g.n, 2))
    out = gt.force_atlas(g, 2, coords=x0, iterations=0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x0))


def test_normalize(rng):
    x = jnp.asarray(rng.normal(size=(20, 3)) * 5 + 2)
    y = np.asarray(F.normalize_coords(x))
    assert abs(y.mean(axis=0)).max() < 1e-9
    assert abs(np.linalg.norm(y, axis=1).max() - 1.0) < 1e-9


def test_centroid_repulsion_accuracy(rng):
    """Far-field monopole + exact near field approximates the exact sum well
    on spatially coherent groups (the Barnes-Hut-style mode)."""
    from graph_embed.forceatlas.farfield import centroid_repulsion

    # 8 well-separated blobs of 32 points
    k, per = 8, 32
    n = k * per
    centers = rng.uniform(-10, 10, size=(k, 2))
    coords = np.repeat(centers, per, axis=0) + rng.normal(size=(n, 2)) * 0.3
    v2g = np.repeat(np.arange(k), per).astype(np.int32)
    groups = gt.Partition(jnp.asarray(v2g), k)
    deg_p1 = jnp.asarray(rng.uniform(1, 5, size=n))

    exact = np.asarray(F.repulsion_exact(jnp.asarray(coords), deg_p1,
                                         1.0, 1e-5))
    approx = np.asarray(centroid_repulsion(jnp.asarray(coords), deg_p1,
                                           groups, 1.0, 1e-5))
    rel = np.linalg.norm(approx - exact, axis=1) / (
        np.linalg.norm(exact, axis=1) + 1e-9)
    assert np.median(rel) < 0.05
    assert rel.mean() < 0.15


def test_force_atlas_centroids_mode(rng):
    g = random_graph(rng, 200, avg_deg=5)
    params = gt.ForceAtlasParams(repulsion="centroids")
    coords = gt.force_atlas(g, 2, params=params, iterations=30,
                            key=jax.random.PRNGKey(4))
    c = np.asarray(coords)
    assert c.shape == (200, 2) and np.isfinite(c).all()
