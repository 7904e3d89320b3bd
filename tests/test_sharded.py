"""Multi-chip tests on the 8-device virtual CPU mesh (SURVEY.md SS4 (4)):
the same graph on 1 device vs N devices must agree allclose."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas.flat import fa_step
from graph_embed.parallel import (make_mesh, make_sharded_fa_step,
                                      pad_graph_for_mesh)
from graph_embed.utils.params import ForceAtlasParams
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import random_graph


def _put(mesh, arr, spec):
    return jax.device_put(arr, NamedSharding(mesh, spec))


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_sharded_step_matches_single_device(rng, ndev):
    assert len(jax.devices()) >= 8
    g = random_graph(rng, 64, dtype="float64")
    dim = 3
    params = ForceAtlasParams(repulsion="gram")
    mesh = make_mesh(ndev)
    s, r, w, n_pad = pad_graph_for_mesh(g, ndev)
    coords = jnp.asarray(rng.uniform(-1, 1, size=(n_pad, dim)))
    fprev = jnp.zeros((n_pad, dim), jnp.float64)
    deg = jnp.zeros(n_pad, jnp.float64).at[: g.n].set(g.degrees(True))

    step = make_sharded_fa_step(mesh, n_pad, s.shape[0], dim, params, g.n,
                                jnp.float64)
    cs = _put(mesh, coords, P())
    fs = _put(mesh, fprev, P("x"))
    ss = _put(mesh, jnp.asarray(s), P("x"))
    rs = _put(mesh, jnp.asarray(r), P("x"))
    ws = _put(mesh, jnp.asarray(w), P("x"))
    ds = _put(mesh, deg, P())
    new_coords, _ = step(cs, fs, ss, rs, ws, ds, jax.random.PRNGKey(0))

    # single-device oracle path on the unpadded graph
    want, want_f = fa_step(coords[: g.n], fprev[: g.n], g, deg[: g.n], params)
    np.testing.assert_allclose(np.asarray(new_coords)[: g.n],
                               np.asarray(want), rtol=1e-9, atol=1e-12)


def test_sharded_multi_step_consistency(rng):
    """Two mesh sizes agree over several steps (scaling-invariance)."""
    g = random_graph(rng, 40, dtype="float64")
    dim = 2
    params = ForceAtlasParams(repulsion="gram")
    results = []
    for ndev in (2, 8):
        mesh = make_mesh(ndev)
        s, r, w, n_pad = pad_graph_for_mesh(g, ndev)
        coords0 = jnp.zeros((n_pad, dim), jnp.float64).at[: g.n].set(
            jnp.asarray(np.random.default_rng(0).uniform(
                -1, 1, size=(g.n, dim))))
        fprev = jnp.zeros((n_pad, dim), jnp.float64)
        deg = jnp.zeros(n_pad, jnp.float64).at[: g.n].set(g.degrees(True))
        step = make_sharded_fa_step(mesh, n_pad, s.shape[0], dim, params,
                                    g.n, jnp.float64)
        cs = _put(mesh, coords0, P())
        fs = _put(mesh, fprev, P("x"))
        ss = _put(mesh, jnp.asarray(s), P("x"))
        rs = _put(mesh, jnp.asarray(r), P("x"))
        ws = _put(mesh, jnp.asarray(w), P("x"))
        ds = _put(mesh, deg, P())
        for i in range(5):
            cs, fs = step(cs, fs, ss, rs, ws, ds, jax.random.PRNGKey(i))
        results.append(np.asarray(cs)[: g.n])
    np.testing.assert_allclose(results[0], results[1], rtol=1e-8)


def test_sharded_sampled_runs(rng):
    g = random_graph(rng, 128, dtype="float64")
    from graph_embed.parallel import sharded_force_atlas

    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
    mesh = make_mesh(8)
    out = sharded_force_atlas(g, 2, mesh=mesh, params=params, iterations=3)
    out = np.asarray(out)
    assert out.shape == (g.n, 2)
    assert np.isfinite(out).all()


def test_sharded_fa_auto_sampled_repulsion(rng, monkeypatch):
    """A dense-repulsion block over DENSE_D2_MAX_BYTES auto-switches
    sharded_force_atlas to the sampled estimator instead of running out of
    device memory (the default gram at embed()'s mesh_min_n=65536 scale is
    a 17.2 GB [n, n] block on one device).  The switched run is BITWISE the
    explicit repulsion='sampled' run."""
    from graph_embed.parallel import sharded as SH

    g = random_graph(rng, 96, dtype="float64")
    mesh = make_mesh(4)
    kw = dict(mesh=mesh, iterations=2, key=jax.random.PRNGKey(7))
    want = np.asarray(SH.sharded_force_atlas(
        g, 2, params=ForceAtlasParams(repulsion="sampled"), **kw))
    monkeypatch.setattr(SH, "DENSE_D2_MAX_BYTES", 64)
    got = np.asarray(SH.sharded_force_atlas(
        g, 2, params=ForceAtlasParams(repulsion="gram"), **kw))
    np.testing.assert_array_equal(got, want)


def test_multihost_helpers():
    from graph_embed.parallel import multihost

    multihost.init_distributed()  # no-op single process
    mesh = multihost.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    lo, hi = multihost.process_local_edge_slice(1024)
    assert (lo, hi) == (0, 1024)  # single process owns everything


@pytest.mark.parametrize("n_devices", [9, 16, 64])
def test_make_mesh_raises_beyond_backend(n_devices):
    """Asking for more devices than the backend has is an error; there is
    no silent swap to other devices."""
    with pytest.raises(ValueError, match="requested"):
        make_mesh(n_devices)


def test_make_mesh_uses_default_backend_devices():
    mesh = make_mesh(4)
    assert mesh.devices.size == 4
    assert all(d in jax.devices() for d in mesh.devices.flat)
