"""Stress-style coordinate-descent embedder.

Array re-design of ``embedViaMinimization`` (src/embed.cpp:341-559):
cyclic coordinate descent on
    J_i = sum_{r != i} 1/|x_i - x_r|  +  w * sum_{edges (i,r)} |x_i - x_r|^2
with w = 1e6 (:410).  For each vertex, a line search along the 2d axis unit
directions by bisection on the directional derivative dJ/dt (:415-459,
tolerance 1e-4 -> exactly 12 halvings from jump = 0.25), take the best
direction/step (:490-523).

The vertex sweep is Gauss-Seidel (each update is visible to the next vertex,
matching the reference), so it runs as a sequential ``fori_loop`` over
vertices with the 2d directions and the O(n) derivative sums vectorized
inside.  The final normalize reproduces the reference's quirk of averaging
over vertices 1..n-1 only (:531-537,546-551).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph

W_EDGE = 1.0e6          # src/embed.cpp:410
EPS_TERM = 10e-12       # src/embed.cpp:349 (note: 1e-11)
N_BISECT = 12           # jump 0.25 halved until <= 1e-4 (:417,457-459)


def _axis_dirs(d: int, dtype):
    dirs = np.zeros((2 * d, d))
    for k in range(d):
        dirs[2 * k, k] = 1.0
        dirs[2 * k + 1, k] = -1.0
    return jnp.asarray(dirs, dtype=dtype)


@partial(jax.jit, static_argnames=("iters",))
def _minimize_loop(coords0, senders, receivers, edge_valid, nbr_count,
                   dirs, iters: int):
    n, d = coords0.shape

    def vertex_update(coords, i):
        x_i = coords[i]

        def direction_search(x_s):
            u = x_s - x_i                                     # [d]

            def dJ_dt(t):
                # repulsion term over all r != i (src/embed.cpp:420-437)
                v = x_i[None, :] - coords                     # [n, d]
                z = u[None, :] * t + v
                term1 = jnp.sum(z * z, axis=1)
                term1 = jnp.maximum(term1, EPS_TERM)
                term2 = jnp.sum(z * u[None, :], axis=1)
                rep = -(term1 ** -1.5) * term2
                rep = jnp.where(jnp.arange(n) == i, 0.0, rep)
                total = jnp.sum(rep)
                # attraction over incident edges (:439-450)
                za = (1.0 - t) * x_i[None, :] + t * x_s[None, :] - coords
                e_on_i = (senders == i) & edge_valid & (receivers != i)
                za_e = za[jnp.clip(receivers, 0, n - 1)]
                att = W_EDGE * 2.0 * jnp.sum(za_e * u[None, :], axis=1)
                total = total + jnp.sum(jnp.where(e_on_i, att, 0.0))
                return total

            def bisect(k, carry):
                t, jump = carry
                g = dJ_dt(t)
                t = jnp.where(g < 0.0, t + jump, t - jump)
                return t, jump / 2.0

            t, _ = jax.lax.fori_loop(0, N_BISECT, bisect, (0.5, 0.25))

            # evaluate J at the final t (:461-489)
            v = x_i[None, :] - coords
            z = u[None, :] * t + v
            term1 = jnp.maximum(jnp.sum(z * z, axis=1), EPS_TERM)
            contrib = 1.0 / jnp.sqrt(term1)
            contrib = jnp.where(jnp.arange(n) == i, 0.0, contrib)
            J = jnp.sum(contrib)
            za = (1.0 - t) * x_i[None, :] + t * x_s[None, :] - coords
            e_on_i = (senders == i) & edge_valid & (receivers != i)
            za_e = za[jnp.clip(receivers, 0, n - 1)]
            att = W_EDGE * jnp.sum(za_e * za_e, axis=1)
            J = J + jnp.sum(jnp.where(e_on_i, att, 0.0))
            return J, t

        Js, ts = jax.vmap(direction_search)(dirs)
        s_best = jnp.argmin(Js)
        t_best = ts[s_best]
        new_x = x_i * (1.0 - t_best) + dirs[s_best] * t_best
        # vertices with no non-self neighbors are skipped (:400-406)
        has_nbrs = nbr_count[i] > 0
        new_x = jnp.where(has_nbrs, new_x, x_i)
        return coords.at[i].set(new_x)

    def sweep(_, coords):
        return jax.lax.fori_loop(
            0, n, lambda i, c: vertex_update(c, i), coords)

    coords = jax.lax.fori_loop(0, iters, sweep, coords0)

    # normalize quirk: average/max over vertices 1..n-1 only (:528-557).
    # For n == 2 the reference's max_length is exactly 0 and it divides by
    # it (NaN); clamped here -- the only intentional deviation.
    if n > 1:
        avg = jnp.sum(coords[1:], axis=0) / (n - 1)
        coords = coords - avg[None, :]
        max_len = jnp.max(jnp.sqrt(jnp.sum(coords[1:] ** 2, axis=1)))
        coords = coords / jnp.maximum(max_len, 1e-30)
    return coords


def embed_via_minimization(g: Graph, dim: int, *, coords=None,
                           iterations: int = 1000, key=None):
    """Flat minimization embedder (src/embed.cpp:341-345 overload defaults
    ITER=1000; header default is 10, embed.hpp:23)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if coords is None:
        coords = jax.random.uniform(key, (g.n, dim), dtype=g.dtype,
                                    minval=-1.0, maxval=1.0)
    nbr_count = jax.ops.segment_sum(
        jnp.where(g.edge_mask & (g.senders != g.receivers), 1, 0),
        jnp.where(g.senders < g.n, g.senders, g.n),
        num_segments=g.n + 1)[: g.n]
    dirs = _axis_dirs(dim, coords.dtype)
    return _minimize_loop(coords, g.senders, g.receivers, g.edge_mask,
                          nbr_count, dirs, iterations)
