"""Boundary-aware (halo-exchange) sharding prototype tests -- SURVEY.md
SS2.2 row 3 / SS5 long-context row."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas.flat import fa_step
from graph_embed.parallel.mesh import make_mesh
from graph_embed.parallel.halo import build_halo_plan, halo_force_atlas
from graph_embed.utils.params import ForceAtlasParams

from conftest import random_graph


def test_halo_plan_invariants(rng):
    g = random_graph(rng, 150, avg_deg=5)
    for ndev in (1, 4, 8):
        p = build_halo_plan(g, ndev)
        # every edge appears exactly once, on its sender's device
        assert int((p.senders_loc < p.blk).sum()) == g.num_edges
        # boundary indices stay inside the owner's block
        assert (p.boundary_idx >= 0).all() and (p.boundary_idx < p.blk).all()
        # a 1-device plan has no boundary at all
        if ndev == 1:
            assert p.boundary_fraction == 0.0
        # receiver indices address [block | pool] only
        assert (p.recv_idx < p.blk + ndev * p.B_max).all()


def test_halo_attraction_matches_dense(rng):
    """With repel=0 the halo step is attraction+gravity only, which must
    match the single-device dense step EXACTLY -- every remote coordinate a
    force needs arrived through the boundary pool."""
    g = random_graph(rng, 192, avg_deg=5)
    c0 = rng.uniform(-1, 1, size=(g.n, 3))
    want, _ = fa_step(jnp.asarray(c0), jnp.zeros((g.n, 3)), g,
                      g.degrees(True),
                      ForceAtlasParams(repulsion="gram", repel=0.0))
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=8,
                              repel=0.0)
    for ndev in (1, 4, 8):
        out = np.asarray(halo_force_atlas(
            g, 3, mesh=make_mesh(ndev), params=params, iterations=1,
            coords0=c0, key=jax.random.PRNGKey(0)))
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_halo_sampled_runs_and_deterministic(rng):
    g = random_graph(rng, 160, avg_deg=5)
    c0 = rng.uniform(-1, 1, size=(g.n, 2))
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    mesh = make_mesh(8)
    a = np.asarray(halo_force_atlas(g, 2, mesh=mesh, params=params,
                                    iterations=5, coords0=c0,
                                    key=jax.random.PRNGKey(1)))
    b = np.asarray(halo_force_atlas(g, 2, mesh=mesh, params=params,
                                    iterations=5, coords0=c0,
                                    key=jax.random.PRNGKey(1)))
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_halo_rejects_dense_repulsion(rng):
    g = random_graph(rng, 64)
    with pytest.raises(ValueError):
        halo_force_atlas(g, 2, mesh=make_mesh(2),
                         params=ForceAtlasParams(repulsion="gram"))


def test_halo_comm_model_smaller_than_replicated():
    """On a locality-ordered mesh graph the boundary exchange moves several
    times fewer floats per step than replicating coordinates."""
    from graph_embed.graph.synth import mesh3d

    g = mesh3d(24)
    p = build_halo_plan(g, 8)
    halo = p.comm_floats_per_step(3, 256)
    repl = 2 * p.ndev * p.blk * 3
    assert halo < repl / 2
    assert p.boundary_fraction < 0.6


def test_halo_sampled_estimator_unbiased_uneven_blocks(rng):
    """The stratified repulsion estimator must stay unbiased when device
    blocks are uneven (n=20 on 4 devices -> blocks 8/8/4/0: a short stratum
    AND an empty one) and num_negative_samples is small -- a uniform
    n/(samp*ndev) weighting is ~40% off here.
    Checked statistically: mean over keys of the repel-only halo force must
    approach the exact all-pairs repulsion."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from graph_embed.parallel.halo import make_halo_fa_step
    from graph_embed.parallel.mesh import EDGE_AXIS

    n, ndev, dim = 20, 4, 2
    g = random_graph(rng, n, avg_deg=2)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64,
                              attract=0.0, gravity=0.0)
    mesh = make_mesh(ndev)
    plan = build_halo_plan(g, ndev)
    assert plan.blk * (ndev - 1) > n        # uneven + empty block for real
    c0 = rng.uniform(-1, 1, size=(n, dim))

    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P(EDGE_AXIS)))
    x = put(jnp.zeros((ndev * plan.blk, dim)).at[:n].set(jnp.asarray(c0)))
    fprev = put(jnp.zeros((ndev * plan.blk, dim)))
    args = (put(plan.senders_loc), put(plan.recv_idx),
            put(jnp.asarray(plan.weights, x.dtype)), put(plan.boundary_idx),
            put(jnp.asarray(plan.deg, x.dtype)), put(plan.n_real))
    step = make_halo_fa_step(mesh, plan, dim, params, x.dtype)

    acc = np.zeros((n, dim))
    K = 200
    for k in range(K):
        _, f = step(x, fprev, *args, jax.random.PRNGKey(k))
        acc += np.asarray(f)[:n]
    mean = acc / K

    # exact all-pairs repulsion oracle (forceatlas.hpp:151-167 semantics)
    deg_p1 = np.asarray(g.degrees(True)) + 1.0
    diff = c0[:, None, :] - c0[None, :, :]
    dist = np.maximum(np.sqrt((diff ** 2).sum(-1)), params.epsilon)
    w = deg_p1[:, None] * deg_p1[None, :] / dist ** 3
    np.fill_diagonal(w, 0.0)
    exact = (w[:, :, None] * diff).sum(axis=1)

    rel = np.linalg.norm(mean - exact) / np.linalg.norm(exact)
    assert rel < 0.12, rel


# ---- halo sharding inside the product pipeline (embed(sharding="halo")) ---

def test_embed_halo_base_matches_across_device_counts(rng):
    """embed(mesh=..., sharding='halo') must be IDENTICAL across device
    counts WITH repulsion on: attraction is exact through the boundary
    pool and the base case uses invariant sampling (shared global draws),
    so the whole halo base is device-count invariant.  The flat-only
    hierarchy (k=0) isolates it."""
    g = random_graph(rng, 400, avg_deg=5)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=16)
    outs = {}
    for ndev in (1, 8):
        out = np.asarray(gt.embed(
            [g], [], 3, key=jax.random.PRNGKey(3), base_iterations=5,
            base_params=params, mesh=make_mesh(ndev), mesh_min_n=1,
            sharding="halo"))
        assert out.shape == (g.n, 3)
        assert np.isfinite(out).all()
        outs[ndev] = out
    np.testing.assert_array_equal(outs[1], outs[8])


def test_embed_halo_full_pipeline(rng):
    """Full multilevel embed with the halo base case: compiles, runs,
    finite, deterministic, and the repulsion='gram' default is auto-switched
    to 'sampled' on the halo path."""
    g = random_graph(rng, 360, avg_deg=6)
    res = gt.partition_hierarchy(g, 0.25)
    graphs = gt.build_galerkin_chain(g, res.levels)
    kw = dict(key=jax.random.PRNGKey(7), base_iterations=6,
              refine_iterations=3, mesh=make_mesh(8), mesh_min_n=1,
              sharding="halo")
    a = np.asarray(gt.embed(graphs, res.levels, 2, **kw))
    b = np.asarray(gt.embed(graphs, res.levels, 2, **kw))
    assert a.shape == (g.n, 2)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_embed_halo_base_order_kwarg(rng):
    """embed(base_order=...) skips the halo base case's internal
    partition_order: passing the SAME permutation the internal pass would
    compute yields a bitwise-identical layout (a truncated-hierarchy
    caller gets the ordering for free from its dropped levels,
    embedder.cpp:189-200 startLevel pattern); a wrong-length order
    raises."""
    from graph_embed.graph.reorder import partition_order

    g = random_graph(rng, 300, avg_deg=5)
    kw = dict(key=jax.random.PRNGKey(9), base_iterations=4,
              base_params=ForceAtlasParams(repulsion="sampled",
                                           num_negative_samples=8),
              mesh=make_mesh(4), mesh_min_n=1, sharding="halo")
    want = np.asarray(gt.embed([g], [], 2, **kw))
    perm = partition_order(g)
    got = np.asarray(gt.embed([g], [], 2, base_order=perm, **kw))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="base_order"):
        gt.embed([g], [], 2, base_order=perm[:10], **kw)


def test_halo_invariant_sampling_device_count_identity(rng):
    """sample_mode='invariant': repulsion ON, and the layout is bitwise
    IDENTICAL across device counts -- the shared replicated key draws the
    same global sample set everywhere and a psum of exclusively-owned
    contributions assembles it exactly (the SURVEY SS5 determinism
    contract, previously only achievable at repel=0)."""
    g = random_graph(rng, 300, avg_deg=5)
    c0 = rng.uniform(-1, 1, size=(g.n, 3))
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
    outs = {}
    for ndev in (1, 4, 8):
        outs[ndev] = np.asarray(halo_force_atlas(
            g, 3, mesh=make_mesh(ndev), params=params, iterations=4,
            coords0=c0, key=jax.random.PRNGKey(2),
            sample_mode="invariant"))
        assert np.isfinite(outs[ndev]).all()
    np.testing.assert_array_equal(outs[1], outs[4])
    np.testing.assert_array_equal(outs[1], outs[8])


def test_halo_invariant_estimator_unbiased(rng):
    """The invariant estimator (uniform global draws, weight n/K) must be
    unbiased too: mean over keys of the repel-only force approaches the
    exact all-pairs repulsion."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from graph_embed.parallel.halo import make_halo_fa_step
    from graph_embed.parallel.mesh import EDGE_AXIS

    n, ndev, dim = 20, 4, 2
    g = random_graph(rng, n, avg_deg=2)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64,
                              attract=0.0, gravity=0.0)
    mesh = make_mesh(ndev)
    plan = build_halo_plan(g, ndev)
    c0 = rng.uniform(-1, 1, size=(n, dim))

    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P(EDGE_AXIS)))
    x = put(jnp.zeros((ndev * plan.blk, dim)).at[:n].set(jnp.asarray(c0)))
    fprev = put(jnp.zeros((ndev * plan.blk, dim)))
    args = (put(plan.senders_loc), put(plan.recv_idx),
            put(jnp.asarray(plan.weights, x.dtype)), put(plan.boundary_idx),
            put(jnp.asarray(plan.deg, x.dtype)), put(plan.n_real))
    step = make_halo_fa_step(mesh, plan, dim, params, x.dtype,
                             sample_mode="invariant")
    acc = np.zeros((n, dim))
    K = 200
    for k in range(K):
        _, f = step(x, fprev, *args, jax.random.PRNGKey(k))
        acc += np.asarray(f)[:n]
    mean = acc / K

    deg_p1 = np.asarray(g.degrees(True)) + 1.0
    diff = c0[:, None, :] - c0[None, :, :]
    dist = np.maximum(np.sqrt((diff ** 2).sum(-1)), params.epsilon)
    w = deg_p1[:, None] * deg_p1[None, :] / dist ** 3
    np.fill_diagonal(w, 0.0)
    exact = (w[:, :, None] * diff).sum(axis=1)
    rel = np.linalg.norm(mean - exact) / np.linalg.norm(exact)
    assert rel < 0.15, rel
