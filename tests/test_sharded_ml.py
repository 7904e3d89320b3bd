"""Multi-chip multilevel embed (aggregate-sharded refinement) on the
8-device virtual CPU mesh: SURVEY.md SS4 (4) -- the same graph on 1 vs N
devices must agree; BASELINE.md configs 4/5 pipeline coverage."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas.multilevel import force_atlas_multilevel
from graph_embed.parallel.mesh import make_mesh
from graph_embed.parallel.sharded_ml import (prepare_refine_sharded,
                                                 refine_level_sharded)
from graph_embed.utils.params import MultilevelFAParams

from conftest import random_graph


def _level(rng, n=300, m=30, d=3, weighted=False):
    g = random_graph(rng, n, avg_deg=6, weighted=weighted)
    v2a = rng.integers(0, m, size=n).astype(np.int32)
    v2a[:m] = np.arange(m)
    part = gt.Partition(jnp.asarray(v2a), m)
    coords_A = rng.uniform(-2, 2, size=(m, d))
    r_A = rng.uniform(0.3, 1.0, size=m)
    c0 = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    return g, part, coords_A, r_A, c0


def test_refine_sharded_matches_portable_and_device_counts(rng):
    """The sharded refinement (a) matches the portable oracle path given the
    same warm start and (b) is IDENTICAL across device counts -- the
    per-aggregate arithmetic is device-count invariant by construction
    (device-major slot layout, shared bucket plan)."""
    g, part, coords_A, r_A, c0 = _level(rng)
    params = MultilevelFAParams()
    want = np.asarray(force_atlas_multilevel(
        g, part, jnp.asarray(coords_A), jnp.asarray(r_A), 3,
        key=jax.random.PRNGKey(0), iterations=4, params=params,
        coords0=jnp.asarray(c0, jnp.float64)))
    outs = {}
    for ndev in (1, 8):
        out = np.asarray(refine_level_sharded(
            g, part, coords_A, r_A, 3, mesh=make_mesh(ndev),
            key=jax.random.PRNGKey(0), iterations=4, params=params,
            coords0=c0))
        assert np.isfinite(out).all()
        # f32 sharded vs f64 portable: small absolute tolerance
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
        outs[ndev] = out
    np.testing.assert_array_equal(outs[1], outs[8])


def test_refine_sharded_weighted(rng):
    """Non-unit weights ride the bf16-packed tiles; per-edge rounding is
    device-count invariant, only tile summation order differs."""
    g, part, coords_A, r_A, c0 = _level(rng, weighted=True)
    params = MultilevelFAParams()
    outs = {}
    for ndev in (1, 4):
        out = np.asarray(refine_level_sharded(
            g, part, coords_A, r_A, 3, mesh=make_mesh(ndev),
            key=jax.random.PRNGKey(1), iterations=3, params=params,
            coords0=c0))
        assert np.isfinite(out).all()
        outs[ndev] = out
    np.testing.assert_allclose(outs[1], outs[4], rtol=1e-4, atol=1e-5)


def test_refine_sharded_layout_partitions_slots(rng):
    """Layout invariants: every vertex gets exactly one slot, slot ranges
    stay inside the owning device's block, local structure is identical
    across devices."""
    g, part, *_ = _level(rng, n=250, m=40)
    params = MultilevelFAParams()
    shl = prepare_refine_sharded(g, part, params, 8)
    sov = shl.slot_of_vertex
    assert np.unique(sov).size == g.n              # injective
    assert shl.valid_slot.sum() == g.n
    # the aggregate of each vertex's slot matches the partition
    v2a = part.vertex_to_agg_numpy()
    np.testing.assert_array_equal(shl.global_agg_of_slot[sov], v2a)
    # ghost slots carry no degree and local agg id <= m_local
    assert shl.agg_of_slot.max() <= shl.m_local
    assert (shl.deg_loc[~shl.valid_slot] == 0).all()
    assert shl.n_slots_local % 128 == 0


def test_embed_mesh_matches_across_device_counts(rng):
    """Full multilevel embed over the mesh: sharded base case + sharded
    refinement at every level; 1-device == 8-device (the BASELINE config 4
    contract, src/embed.cpp:576-796 semantics)."""
    g = random_graph(rng, 500, avg_deg=6, weighted=False)
    res = gt.partition_hierarchy(g, 0.25)
    graphs = gt.build_galerkin_chain(g, res.levels)
    outs = {}
    for ndev in (1, 8):
        out = np.asarray(gt.embed(
            graphs, res.levels, 2, key=jax.random.PRNGKey(5),
            base_iterations=30, refine_iterations=4,
            mesh=make_mesh(ndev), mesh_min_n=1))
        assert out.shape == (g.n, 2)
        assert np.isfinite(out).all()
        outs[ndev] = out
    np.testing.assert_allclose(outs[1], outs[8], rtol=1e-7, atol=1e-9)


def test_embed_mesh_small_levels_replicated(rng):
    """mesh_min_n gates the sharded paths: levels below it run the
    single-device code (replicated, DP-like) and the pipeline still works."""
    g = random_graph(rng, 300, avg_deg=5)
    res = gt.partition_hierarchy(g, 0.3)
    graphs = gt.build_galerkin_chain(g, res.levels)
    out = np.asarray(gt.embed(graphs, res.levels, 2,
                              key=jax.random.PRNGKey(2), base_iterations=20,
                              refine_iterations=3, mesh=make_mesh(8),
                              mesh_min_n=200))
    assert out.shape == (g.n, 2)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("sharding", ["replicated", "halo"])
def test_embed_mesh_sampled_buckets_device_count_invariant(rng, sharding):
    """Sampled within-aggregate repulsion (every bucket past a threshold of
    16 slots) keys its draws by the global aggregate id, so the sharded
    embed stays device-count invariant with it on."""
    from graph_embed.utils.params import MultilevelFAParams

    g = random_graph(rng, 500, avg_deg=6, weighted=False)
    res = gt.partition_hierarchy(g, 0.25)
    graphs = gt.build_galerkin_chain(g, res.levels)
    params = MultilevelFAParams(sampled_slots_threshold=16,
                                num_negative_samples=8)
    outs = [np.asarray(gt.embed(
        graphs, res.levels, 2, key=jax.random.PRNGKey(5),
        base_iterations=10, refine_iterations=4, refine_params=params,
        mesh=make_mesh(ndev), mesh_min_n=1, sharding=sharding))
        for ndev in (1, 4)]
    # same draws; only f32 sums of other shapes (per-device bucket sizes)
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-5, atol=1e-5)
