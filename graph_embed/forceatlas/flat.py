"""Flat ForceAtlas2 layout: one jitted step, lax.fori_loop over iterations.

Array re-design of ``partition::forceAtlas`` (include/forceatlas.hpp:
89-312).  One reference iteration reads coords and writes coords in separate
phases, so it is a pure function (coords, forces_prev) -> (coords',
forces) -- directly a jitted step (SURVEY.md SS3.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..graph.csr import Graph
from ..utils.params import ForceAtlasParams
from . import forces as F


def compute_forces(coords, g: Graph, deg, params: ForceAtlasParams,
                   key=None, groups=None, members=None):
    """Total force vector per vertex for one iteration
    (forceatlas.hpp:146-212).  ``key`` is required for sampled repulsion;
    ``groups`` (a Partition into ~1-4k groups) for 'centroids' repulsion."""
    deg_p1 = deg + 1.0
    eps = params.epsilon
    if params.repulsion == "exact":
        rep = F.repulsion_exact(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "gram":
        rep = F.repulsion_gram(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "sampled":
        if key is None:
            raise ValueError("sampled repulsion needs a PRNG key")
        rep = F.repulsion_sampled(coords, deg_p1, params.repel, eps, key,
                                  params.num_negative_samples)
    elif params.repulsion == "centroids":
        if groups is None:
            raise ValueError("centroids repulsion needs a groups Partition")
        from .farfield import centroid_repulsion

        rep = centroid_repulsion(coords, deg_p1, groups, params.repel, eps,
                                 members=members)
    else:
        raise ValueError(f"unknown repulsion {params.repulsion!r}")
    att = F.attraction_csr(
        coords, g.senders, g.receivers, g.weights, deg_p1, g.num_edges,
        attract=params.attract, eps=eps, linlog=params.linlog,
        delta=params.delta, nohubs=params.nohubs,
        use_weights=params.use_weights)
    grav = F.gravity_force(coords, deg_p1, params.gravity)
    return rep + att + grav


def fa_step(coords, forces_prev, g: Graph, deg, params: ForceAtlasParams,
            key=None, groups=None, members=None):
    """One full iteration: forces -> swing/speed -> displacement.
    Returns (coords', forces)."""
    f = compute_forces(coords, g, deg, params, key, groups, members)
    new_coords = F.speed_update(coords, f, forces_prev, deg + 1.0,
                                ks=params.ks, ksmax=params.ksmax,
                                tolerate=params.tolerate)
    return new_coords, f


@partial(jax.jit, static_argnames=("params", "iterations"))
def _fa_loop(coords0, g: Graph, deg, key, params: ForceAtlasParams,
             iterations: int, groups=None, members=None):
    def body(it, carry):
        coords, forces_prev, key = carry
        key, sub = jax.random.split(key)
        coords, f = fa_step(coords, forces_prev, g, deg, params,
                            sub if params.repulsion == "sampled" else None,
                            groups, members)
        return coords, f, key

    forces_prev = jnp.zeros_like(coords0)
    coords, _, _ = jax.lax.fori_loop(0, iterations, body,
                                     (coords0, forces_prev, key))
    if params.normalize:
        coords = F.normalize_coords(coords)
    return coords


def force_atlas(g: Graph, dim: int = 2, *, coords=None, key=None,
                params: ForceAtlasParams | None = None,
                iterations: int | None = None, groups=None,
                device: str = "default"):
    """Flat ForceAtlas layout (forceatlas.hpp:89-312).

    ``coords`` warm-starts the layout (the reference's resume hook,
    forceatlas.hpp:118-125); otherwise random U(-1,1)^dim init.  The
    reference seeds from ``std::random_device`` (non-deterministic,
    :104-105); here an explicit PRNG key gives reproducibility
    (SURVEY.md SS7 #3).

    ``device``: "default" runs on the default backend; "cpu" runs the loop
    on the host CPU backend instead (identical math, the threefry PRNG is
    backend-invariant) and returns the result on the default device -- for
    callers that lay out many tiny graphs in one process.
    """
    params = params or ForceAtlasParams()
    if iterations is None:
        iterations = params.iterations
    if key is None:
        key = jax.random.PRNGKey(0)
    key, init_key = jax.random.split(key)
    if coords is None:
        coords = jax.random.uniform(init_key, (g.n, dim), dtype=g.dtype,
                                    minval=-1.0, maxval=1.0)
    deg = g.degrees(params.use_weights)
    members = None
    if params.repulsion == "centroids":
        if groups is None:
            from ..partition.hierarchy import partition_num_parts

            groups = partition_num_parts(g, max(32, g.n // 64))
        from .multilevel import build_member_buckets

        members = build_member_buckets(groups)
    if device not in ("default", "cpu"):
        raise ValueError(f"unknown device {device!r}; "
                         "expected 'default' or 'cpu'")
    if device == "cpu":
        default_dev = jax.devices()[0]
        cpu = jax.devices("cpu")[0]
        coords, g, deg, key, groups, members = jax.device_put(
            (coords, g, deg, key, groups, members), cpu)
        out = _fa_loop(coords, g, deg, key, params, iterations, groups,
                       members)
        return jax.device_put(out, default_dev)
    return _fa_loop(coords, g, deg, key, params, iterations, groups, members)
