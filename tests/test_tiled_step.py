"""Transposed-layout FA step (DIA rolls + edge-list SpMV + diff-form
sampled repulsion) vs the reference flat step.

Per-edge constants are folded on the host in f32, so weighted and unit
graphs match the flat step to float32 rounding.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas import tiled as TL
from graph_embed.forceatlas.flat import fa_step
from graph_embed.utils.params import ForceAtlasParams

from conftest import random_graph


def _graph32(rng, n, weighted):
    m = n * 3
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    keep = s != r
    w = rng.uniform(0.5, 2.0, size=keep.sum()) if weighted else None
    return gt.from_edges(s[keep], r[keep], w, n=n, symmetrize=True,
                         dtype=jnp.float32)


def test_tiled_step_matches_xla_unit_weights(rng):
    g = _graph32(rng, 200, weighted=False)
    params = ForceAtlasParams(repulsion="gram")
    tfa = TL.prepare_tiled(g, 3, params)
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    deg = g.degrees(True).astype(jnp.float32)
    got_x, got_f = TL.fa_step_tiled(coords, fprev, tfa, params)
    want_x, want_f = fa_step(coords, fprev, g, deg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)


def test_tiled_step_weighted_close(rng):
    g = _graph32(rng, 150, weighted=True)
    params = ForceAtlasParams(repulsion="gram")
    tfa = TL.prepare_tiled(g, 2, params)
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 2)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    deg = g.degrees(True).astype(jnp.float32)
    got_x, _ = TL.fa_step_tiled(coords, fprev, tfa, params)
    want_x, _ = fa_step(coords, fprev, g, deg, params)
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)


def test_reorder_utilities(rng):
    from graph_embed.graph import reorder

    g = _graph32(rng, 100, weighted=False)
    perm = reorder.rcm_order(g)
    assert sorted(perm.tolist()) == list(range(g.n))
    g2, inv = reorder.apply_order(g, perm)
    # graph is isomorphic: degree multiset preserved
    np.testing.assert_allclose(
        np.sort(np.asarray(g2.degrees(False))),
        np.sort(np.asarray(g.degrees(False))))
    perm2 = reorder.partition_order(g, 0.3)
    assert sorted(perm2.tolist()) == list(range(g.n))


def test_tiled_step_linlog_matches_xla(rng):
    """linlog rides the two-endpoint edge form inside the tiled step."""
    g = _graph32(rng, 120, weighted=True)
    params = ForceAtlasParams(repulsion="gram", linlog=True)
    tfa = TL.prepare_tiled(g, 2, params)
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 2)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    deg = g.degrees(True).astype(jnp.float32)
    got_x, _ = TL.fa_step_tiled(coords, fprev, tfa, params)
    want_x, _ = fa_step(coords, fprev, g, deg, params)
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               rtol=1e-3, atol=1e-3)


def _unit_graph(rng, n):
    """Random simple graph with strictly unit weights (no duplicate pairs --
    symmetrize would sum them to 2.0)."""
    m = n * 3
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    keep = s != r
    s, r = s[keep], r[keep]
    key = np.unique(np.minimum(s, r) * n + np.maximum(s, r))
    return gt.from_edges(key // n, key % n, None, n=n, symmetrize=True,
                         dtype=jnp.float32)


def test_fused_sampled_repulsion_matches_xla(rng):
    """The transposed estimator (one fused XLA pass over [n_pad, s]) equals
    the row-major forces.repulsion_sampled and a float64 transcription on
    the same key (same sample draw); padded columns stay zero."""
    from graph_embed.forceatlas import forces as F
    from graph_embed.ops import spmv as SP

    n, d, s = 700, 3, 64
    coords = jnp.asarray(rng.uniform(-1, 1, size=(n, d)).astype(np.float32))
    deg_p1 = jnp.asarray(rng.uniform(1, 5, size=(n,)).astype(np.float32))
    key = jax.random.PRNGKey(42)
    row = np.asarray(F.repulsion_sampled(coords, deg_p1, 1.3, 1e-5, key, s))

    n_pad = 1024
    xT = SP.pad_coords_T(coords, n_pad)
    deg_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(deg_p1)
    repT = np.asarray(F.repulsion_sampled_T(xT, deg_pad, key, n=n,
                                            num_samples=s, repel=1.3,
                                            eps=1e-5, dim=d))
    np.testing.assert_allclose(repT[:d, :n].T, row, rtol=1e-6, atol=1e-6)
    assert not repT[d:].any()

    idx = np.asarray(jax.random.randint(key, (s,), 0, n))
    x64 = np.asarray(coords, np.float64)
    dg = np.asarray(deg_p1, np.float64)
    diff = x64[:, None, :] - x64[idx][None, :, :]
    dist = np.maximum(np.sqrt((diff ** 2).sum(-1)), 1e-5)
    w = dg[idx][None, :] / dist ** 3
    w[np.arange(n)[:, None] == idx[None, :]] = 0.0
    want = 1.3 * dg[:, None] * (w[:, :, None] * diff).sum(1) * (n / s)
    np.testing.assert_allclose(row, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_fa_step_tiled_T_matches_row_major(rng):
    """The transposed-state step must reproduce fa_step_tiled exactly: every
    force term is identical and the sublane reductions see exact zeros in
    rows dim..D_PAD."""
    from graph_embed.ops import spmv as SP

    g = _unit_graph(rng, 900)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
    tfa = TL.prepare_tiled(g, 3, params)
    key = jax.random.PRNGKey(7)
    coords = jnp.asarray(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    c_row, f_row = TL.fa_step_tiled(coords, fprev, tfa, params, key)

    xT = SP.pad_coords_T(coords, tfa.n_pad)
    fprevT = jnp.zeros_like(xT)
    xT2, fT = TL.fa_step_tiled_T(xT, fprevT, tfa, params, key)
    np.testing.assert_allclose(np.asarray(SP.unpad_coords_T(xT2, g.n, 3)),
                               np.asarray(c_row), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(SP.unpad_coords_T(fT, g.n, 3)),
                               np.asarray(f_row), rtol=1e-6, atol=1e-6)
    # padded columns and rows dim.. stay exactly zero (loop invariant)
    assert not np.asarray(xT2[3:, :]).any()
    assert not np.asarray(xT2[:, g.n:]).any()


def test_dia_plan_matches_dense(rng):
    """DIA + residual decomposition reproduces A @ x exactly (f32)."""
    from graph_embed.graph.synth import mesh3d
    from graph_embed.ops import dia as DIA
    from graph_embed.ops import spmv as SP

    g = mesh3d(6, extra_frac=0.2, seed=3)
    s, r, w = g.to_coo_numpy()
    n_pad = -(-g.n // 256) * 256
    plan = DIA.plan_dia(s, r, w, g.n, n_pad, min_count=32)
    assert plan is not None and len(plan.offsets) >= 6
    assert 0.5 < plan.coverage < 1.0  # random extras stay residual
    x = rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32)
    xT = SP.pad_coords_T(jnp.asarray(x), n_pad)
    y_dia = np.asarray(DIA.dia_spmv(xT, jnp.asarray(plan.weights),
                                    plan.offsets))[:3, :g.n].T
    rm = plan.residual_mask
    y_res = np.zeros_like(y_dia)
    np.add.at(y_res, s[rm], w[rm, None] * x[r[rm]])
    A = g.to_dense_numpy()
    np.testing.assert_allclose(y_dia + y_res, A @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(DIA.dia_row_sums(plan.weights))[:g.n]
        + np.bincount(s[rm], weights=w[rm], minlength=g.n),
        A.sum(axis=1), rtol=1e-6)


def test_tiled_step_dia_hybrid_matches_xla(rng):
    """Mesh + random extras: DIA absorbs the stencil, the SpMV the rest."""
    from graph_embed.graph.synth import mesh3d

    g = mesh3d(6, extra_frac=0.3, seed=5)
    params = ForceAtlasParams(repulsion="gram")
    tfa = TL.prepare_tiled(g, 3, params, dia_min_count=32)
    assert tfa.dia_offsets and tfa.edges is not None
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    deg = g.degrees(True).astype(jnp.float32)
    got_x, got_f = TL.fa_step_tiled(coords, fprev, tfa, params)
    want_x, want_f = fa_step(coords, fprev, g, deg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)


def test_tiled_step_pure_dia_matches_xla(rng):
    """Pure mesh: every edge on a diagonal -> no edge-list SpMV at all."""
    from graph_embed.graph.synth import mesh3d
    from graph_embed.ops import spmv as SP

    g = mesh3d(6)
    params = ForceAtlasParams(repulsion="gram")
    tfa = TL.prepare_tiled(g, 3, params, dia_min_count=32)
    assert tfa.edges is None and len(tfa.dia_offsets) == 6
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32))
    fprev = jnp.zeros_like(coords)
    deg = g.degrees(True).astype(jnp.float32)
    got_x, got_f = TL.fa_step_tiled(coords, fprev, tfa, params)
    want_x, want_f = fa_step(coords, fprev, g, deg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    # transposed-state step agrees too
    xT = SP.pad_coords_T(coords, tfa.n_pad)
    xT2, _ = TL.fa_step_tiled_T(xT, jnp.zeros_like(xT), tfa, params)
    np.testing.assert_allclose(np.asarray(SP.unpad_coords_T(xT2, g.n, 3)),
                               np.asarray(got_x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("repulsion", ["exact", "gram", "sampled"])
def test_tiled_step_matches_flat(rng, repulsion, weighted, dim):
    """Every repulsion option through the transposed step equals flat.fa_step
    (same key => same negative samples)."""
    g = _graph32(rng, 260, weighted=weighted)
    params = ForceAtlasParams(repulsion=repulsion, num_negative_samples=32)
    tfa = TL.prepare_tiled(g, dim, params)
    key = jax.random.PRNGKey(5)
    coords = jnp.asarray(rng.uniform(-1, 1, size=(g.n, dim)).astype(np.float32))
    fprev = jnp.asarray(rng.uniform(-1, 1, size=(g.n, dim)).astype(np.float32))
    deg = g.degrees(True).astype(jnp.float32)
    got_x, got_f = TL.fa_step_tiled(coords, fprev, tfa, params, key)
    want_x, want_f = fa_step(coords, fprev, g, deg, params, key)
    scale = np.abs(np.asarray(want_f)).max()
    np.testing.assert_allclose(np.asarray(got_f) / scale,
                               np.asarray(want_f) / scale, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)
