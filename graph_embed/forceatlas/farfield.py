"""Deterministic far-field repulsion via partition centroids.

The reference computes repulsion either all-pairs O(n^2) (forceatlas.hpp:151)
or only within aggregates (forceatlas.hpp:394) -- its multilevel structure is
already an implicit Barnes-Hut.  This module makes that explicit as a third
repulsion mode for the flat layout:

  F_i  ~=  exact within group(i)                 (bucketed pairwise blocks)
         + sum_{g != group(i)} M_g (x_i - c_g) / d^3   (monopole far field)

with mass-weighted centroids c_g and masses M_g = sum (deg_j + 1).  The far
field is an [n, m] gram-form interaction -- two matmuls, no dynamic
scatters -- so unlike negative sampling it is deterministic and unbiased for
well-separated groups.  Groups come from the framework's own coarsener
(compose hierarchy levels until ~1-4k groups).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..partition.interpolation import Partition
from .multilevel import build_member_buckets, aggregate_repulsion


def group_moments(coords, deg_p1, groups: Partition):
    """(masses [m], centroids [m, d]): M_g = sum deg+1, c_g mass-weighted."""
    m = groups.num_aggs
    v2g = groups.vertex_to_agg
    mass = jax.ops.segment_sum(deg_p1, v2g, num_segments=m)
    wsum = jax.ops.segment_sum(coords * deg_p1[:, None], v2g, num_segments=m)
    centroids = wsum / jnp.maximum(mass, 1e-30)[:, None]
    return mass, centroids


def centroid_repulsion(coords, deg_p1, groups: Partition, repel, eps,
                       *, members=None):
    """[n, d] approximate repulsion: exact near field + monopole far field."""
    if members is None:
        members = build_member_buckets(groups)
    n, d = coords.shape
    v2g = groups.vertex_to_agg
    mass, cent = group_moments(coords, deg_p1, groups)

    # far field against ALL group monopoles (gram form)
    sq_x = jnp.sum(coords * coords, axis=1)
    sq_c = jnp.sum(cent * cent, axis=1)
    d2 = sq_x[:, None] + sq_c[None, :] - 2.0 * jnp.matmul(
        coords, cent.T, precision=jax.lax.Precision.HIGHEST)   # [n, m]; cancellation, see forces.py
    dist = jnp.maximum(jnp.sqrt(jnp.maximum(d2, 0.0)), eps)
    W = mass[None, :] / (dist * dist * dist)
    f_far = coords * jnp.sum(W, axis=1, keepdims=True) - jnp.matmul(
        W, cent, precision=jax.lax.Precision.HIGHEST)  # cancellation, see forces.py

    # remove the own-group monopole (its exact term is added below)
    c_own = cent[v2g]
    m_own = mass[v2g]
    diff_own = coords - c_own
    d_own = jnp.maximum(jnp.sqrt(jnp.sum(diff_own ** 2, axis=1)), eps)
    f_far = f_far - diff_own * (m_own / (d_own ** 3))[:, None]

    far = (repel * deg_p1)[:, None] * f_far

    # exact near field within the own group (bucketed pairwise blocks)
    near = aggregate_repulsion(coords, members, deg_p1, repel, eps)
    return far + near
