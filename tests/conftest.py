"""Test configuration: CPU backend with an 8-device virtual mesh and x64.

Multi-chip sharding is validated on a faked mesh per SURVEY.md SS4(4):
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``.
x64 is enabled so float64 parity oracles are exact; the library itself is
dtype-explicit and never relies on x64.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on the card run
them with ``GRAPH_EMBED_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``
(which leaves the default backend alone).
"""

import os

ON_GPU = os.environ.get("GRAPH_EMBED_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests without a GPU (decided per test, never at
    import, so every xdist worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (GRAPH_EMBED_TESTS_ON_GPU=1 on the "
                    "card)")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def random_graph(rng, n, avg_deg=4, weighted=True, dtype="float64"):
    """Small random symmetric graph for tests (self-loop free)."""
    m = n * avg_deg // 2
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    keep = s != r
    s, r = s[keep], r[keep]
    w = rng.uniform(0.5, 2.0, size=s.size) if weighted else None
    import graph_embed as gt
    import jax.numpy as jnp

    return gt.from_edges(s, r, w, n=n, symmetrize=True,
                         dtype=jnp.float64 if dtype == "float64" else jnp.float32)


@pytest.fixture
def small_graph(rng):
    return random_graph(rng, 64)
