"""Checks that only mean something on the GPU (skipped elsewhere).

Run on the card: ``GRAPH_EMBED_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.
The full-size checks live in chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from graph_embed.forceatlas import flat
from graph_embed.forceatlas import tiled as TL
from graph_embed.graph.synth import rmat
from graph_embed.ops import spmv as SP
from graph_embed.utils.params import ForceAtlasParams


@pytest.mark.gpu
def test_transposed_step_on_gpu_matches_flat():
    """The bench step compiles for the card and agrees with flat.fa_step
    at any matmul precision setting (no f32 dot on the path)."""
    g = rmat(14, 8, seed=1)
    s, r, _ = g.to_coo_numpy()
    g = gt.from_edges(s, r, np.ones(s.size, np.float32), n=g.n,
                      symmetrize=False)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    tfa = TL.prepare_tiled(g, 3, params)
    x = jax.random.uniform(jax.random.PRNGKey(0), (g.n, 3), jnp.float32,
                           -1.0, 1.0)
    key = jax.random.PRNGKey(1)
    with jax.default_matmul_precision("highest"):
        _, want = flat.fa_step(x, jnp.zeros_like(x), g, g.degrees(True),
                               params, key)
    xT = SP.pad_coords_T(x, tfa.n_pad)
    _, fT = TL.fa_step_tiled_T(xT, jnp.zeros_like(xT), tfa, params, key)
    got = np.asarray(fT)[:3, :g.n].T
    want = np.asarray(want)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
