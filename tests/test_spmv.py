"""The attraction term on the transposed layout (ops/spmv.py edge-list SpMV,
DIA rolls, linlog edge form) against float64 scipy/numpy references."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps

import graph_embed as gt
from graph_embed.forceatlas import forces as F
from graph_embed.forceatlas import tiled as TL
from graph_embed.graph.synth import mesh3d
from graph_embed.ops import spmv as SP
from graph_embed.utils.params import ForceAtlasParams


def _graph(rng, n, weighted, *, n_total=None):
    m = n * 3
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    keep = s != r
    w = rng.uniform(0.5, 2.0, size=keep.sum()) if weighted else None
    return gt.from_edges(s[keep], r[keep], w, n=n_total or n,
                         symmetrize=True, dtype=jnp.float32)


def _case(rng, case):
    """(graph, params, prepare kwargs) per attraction case."""
    if case == "unit":
        return _graph(rng, 300, False), ForceAtlasParams(), {}
    if case == "weighted":
        return _graph(rng, 300, True), ForceAtlasParams(), {}
    if case == "linlog":
        return _graph(rng, 300, True), ForceAtlasParams(linlog=True), {}
    if case == "dia_hybrid":
        return (mesh3d(6, extra_frac=0.3, seed=5), ForceAtlasParams(),
                dict(dia_min_count=32))
    # padded: trailing isolated vertices and n far from a lane multiple
    return _graph(rng, 150, True, n_total=201), ForceAtlasParams(), {}


def _reference(g, x, params):
    """float64 attraction (forceatlas.hpp:169-203) from the COO."""
    s, r, w = g.to_coo_numpy()
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    if params.linlog:
        diff = x[r] - x[s]
        dist = np.maximum(np.sqrt((diff ** 2).sum(1)), params.epsilon)
        per = diff * (params.attract * w * np.log1p(dist) / dist)[:, None]
        out = np.zeros_like(x)
        np.add.at(out, s, per)
        return out
    A = sps.csr_matrix((w, (s, r)), (g.n, g.n))
    return params.attract * (A @ x - x * np.asarray(A.sum(axis=1)))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", ["unit", "weighted", "linlog", "dia_hybrid",
                                  "padded"])
def test_attraction_matches_scipy(rng, case, dim):
    g, params, kw = _case(rng, case)
    tfa = TL.prepare_tiled(g, dim, params, **kw)
    if case == "dia_hybrid":
        assert tfa.dia_offsets and tfa.edges is not None
    assert tfa.n_pad % TL.LANE == 0 and tfa.n_pad >= g.n
    x = rng.uniform(-1, 1, size=(g.n, dim)).astype(np.float32)
    xT = SP.pad_coords_T(jnp.asarray(x), tfa.n_pad)
    att = np.asarray(TL._attraction_T(xT, tfa, params))
    want = _reference(g, x, params)
    np.testing.assert_allclose(att[:dim, :g.n].T, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # rows dim.. and padded columns carry nothing
    assert not att[dim:].any()
    assert not att[:, g.n:].any()


@pytest.mark.parametrize("use_weights", [True, False])
@pytest.mark.parametrize("nohubs", [False, True])
@pytest.mark.parametrize("delta", [1.0, 0.0, 0.5])
def test_folded_weights_match_per_edge_form(rng, delta, nohubs, use_weights):
    """Host-folded per-edge constants reproduce forces.attraction_csr for
    every (delta, nohubs, use_weights) branch of forceatlas.hpp:187-196."""
    g = _graph(rng, 240, True)
    params = ForceAtlasParams(delta=delta, nohubs=nohubs,
                              use_weights=use_weights)
    tfa = TL.prepare_tiled(g, 3, params)
    x = jnp.asarray(rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32))
    got = np.asarray(TL._attraction_T(SP.pad_coords_T(x, tfa.n_pad), tfa,
                                      params))[:3, :g.n].T
    deg_p1 = g.degrees(use_weights).astype(jnp.float32) + 1.0
    want = np.asarray(F.attraction_csr(
        x, g.senders, g.receivers, g.weights.astype(jnp.float32), deg_p1,
        g.num_edges, attract=params.attract, eps=params.epsilon,
        linlog=False, delta=delta, nohubs=nohubs, use_weights=use_weights))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_build_edge_list_sorted_with_row_sums(rng):
    s = rng.integers(0, 50, 400)
    r = rng.integers(0, 50, 400)
    w = rng.uniform(0.5, 2.0, 400)
    el, deg_w = SP.build_edge_list(s, r, w, 64)
    es = np.asarray(el.senders)
    assert (np.diff(es) >= 0).all() and el.num_edges == 400
    np.testing.assert_allclose(deg_w, np.bincount(s, weights=w,
                                                  minlength=64), rtol=1e-6)
    # stable: the (receiver, weight) multiset of every sender is preserved
    for v in (0, 17, 49):
        got = sorted(zip(np.asarray(el.receivers)[es == v].tolist(),
                         np.asarray(el.weights)[es == v].tolist()))
        want = sorted(zip(r[s == v].tolist(),
                          np.asarray(w, np.float32)[s == v].tolist()))
        assert got == want


def test_build_edge_list_rejects_out_of_range():
    with pytest.raises(ValueError, match="n_pad"):
        SP.build_edge_list(np.array([0, 5]), np.array([1, 2]),
                           np.ones(2), 4)
