"""ForceAtlas step on the transposed coordinate layout (the bench fast path).

Per-iteration composition (SURVEY.md SS3.3), all plain XLA:
  * attraction: DIA rolls for the edges at dominant constant index
    offsets (ops/dia.py) plus the sender-sorted edge-list SpMV for the rest
    (ops/spmv.py), F_att = attract * (A @ x - x * deg_w);
  * repulsion: the sampled estimator in diff form (forces.repulsion_sampled_T);
  * gravity/swing/speed: elementwise, fused by XLA.

The loop state is transposed, ``xT [D_PAD, n_pad]`` (rows dim.. are exact
zeros), so the reductions over the coordinate axis run over a leading
dimension.  Per-iteration semantics match ``flat.fa_step`` with the per-edge
constants folded on the host (tests/test_tiled_step.py).  linlog needs
per-edge distances and takes the two-endpoint edge form instead of the
linear SpMV.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops import dia as DIA
from ..ops import spmv as SP
from ..utils.params import ForceAtlasParams
from . import forces as F

LANE = 128    # n_pad multiple


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TiledFA:
    """Precomputed per-graph state for the transposed FA step (host-built
    once).

    ``edges`` holds the edges NOT absorbed by the DIA decomposition (None
    when the diagonals absorbed every edge); ``dia_offsets``/``dia_w`` hold
    the stencil part, applied as weighted rolls."""

    edges: object            # ops.spmv.EdgeList or None
    deg: jnp.ndarray         # [n] reference degrees (forceatlas.hpp:127-140)
    deg_w_att: jnp.ndarray   # [n_pad] row sums of the folded weights
    n: int
    dim: int
    n_pad: int
    linlog: bool = False     # two-endpoint edge form (distance magnitude)
    dia_w: object = None     # [K, n_pad] f32 or None
    dia_offsets: tuple = ()  # K static index offsets

    def tree_flatten(self):
        return ((self.edges, self.deg, self.deg_w_att, self.dia_w),
                (self.n, self.dim, self.n_pad, self.linlog,
                 self.dia_offsets))

    @classmethod
    def tree_unflatten(cls, aux, children):
        edges, deg, deg_w_att, dia_w = children
        n, dim, n_pad, linlog, dia_offsets = aux
        return cls(edges, deg, deg_w_att, n, dim, n_pad, linlog, dia_w,
                   dia_offsets)


def prepare_tiled(g: Graph, dim: int, params: ForceAtlasParams,
                  *, dia_min_count: int | None = None) -> TiledFA:
    """Fold the per-edge constants, split off the DIA stencil part and
    upload the residual edge list (host, once per graph).

    ``dia_min_count``: None picks the automatic DIA threshold (ops/dia.py);
    0 disables the decomposition."""
    s, r, w = g.to_coo_numpy()
    deg = g.degrees_numpy(params.use_weights)
    folded = np.asarray(SP.fold_edge_weights(
        w, deg[s], use_weights=params.use_weights, delta=params.delta,
        nohubs=params.nohubs), np.float32)
    n_pad = max(-(-g.n // LANE), 1) * LANE
    deg_j = jnp.asarray(deg, jnp.float32)
    if params.linlog:
        # the distance-dependent magnitude has no linear (stencil) form
        el, _ = SP.build_edge_list(s, r, folded, n_pad)
        return TiledFA(edges=el, deg=deg_j,
                       deg_w_att=jnp.zeros(n_pad, jnp.float32), n=g.n,
                       dim=dim, n_pad=n_pad, linlog=True)

    # DIA (stencil) decomposition first: edges at a dominant constant offset
    # become weighted rolls -- on mesh-family graphs this absorbs most
    # (often all) edges
    dia = None
    if dia_min_count is None or dia_min_count > 0:
        dia = DIA.plan_dia(s, r, folded, g.n, n_pad, min_count=dia_min_count)
    deg_w = np.zeros(n_pad, np.float32)
    el = None
    keep = dia.residual_mask if dia is not None else None
    if keep is None or keep.any():
        if keep is not None:
            s, r, folded = s[keep], r[keep], folded[keep]
        el, deg_w = SP.build_edge_list(s, r, folded, n_pad)
    dia_w = None
    dia_offsets = ()
    if dia is not None:
        deg_w = deg_w + DIA.dia_row_sums(dia.weights)
        dia_w = jnp.asarray(dia.weights)
        dia_offsets = dia.offsets
    return TiledFA(edges=el, deg=deg_j, deg_w_att=jnp.asarray(deg_w), n=g.n,
                   dim=dim, n_pad=n_pad, dia_w=dia_w,
                   dia_offsets=dia_offsets)


def _attraction_T(xT, tfa: TiledFA, params: ForceAtlasParams):
    """attT [D_PAD, n_pad]: the attraction term, composed from the DIA
    rolls and/or the edge-list SpMV."""
    if tfa.linlog:
        return SP.linlog_attraction_T(xT, tfa.edges, tfa.dim,
                                      attract=params.attract,
                                      eps=params.epsilon)
    y = jnp.zeros_like(xT)
    if tfa.dia_offsets:
        y = y + DIA.dia_spmv(xT, tfa.dia_w, tfa.dia_offsets)
    if tfa.edges is not None:
        y = y + SP.spmv_T(xT, tfa.edges, tfa.dim)
    return params.attract * (y - xT * tfa.deg_w_att[None, :])


def tiled_forces_T(xT, tfa: TiledFA, params: ForceAtlasParams, key=None):
    """Total force [D_PAD, n_pad] (repulsion 'sampled', or 'gram'/'exact'
    via a local relayout)."""
    n, dim = tfa.n, tfa.dim
    eps = params.epsilon
    attT = _attraction_T(xT, tfa, params)
    deg_p1_pad = jnp.zeros(tfa.n_pad, jnp.float32).at[:n].set(tfa.deg + 1.0)
    if params.repulsion == "sampled":
        repT = F.repulsion_sampled_T(
            xT, deg_p1_pad, key, n=n, num_samples=params.num_negative_samples,
            repel=params.repel, eps=eps, dim=dim)
    else:
        coords = SP.unpad_coords_T(xT, n, dim)
        if params.repulsion == "gram":
            rep = F.repulsion_gram(coords, tfa.deg + 1.0, params.repel, eps)
        else:
            rep = F.repulsion_exact(coords, tfa.deg + 1.0, params.repel, eps)
        repT = jnp.zeros_like(xT).at[:dim, :n].set(rep.T)
    # gravity on the transposed layout: rows dim.. are zero, so the column
    # norm equals the [n, d] row norm; padded columns have deg 0 -> force 0
    mag = jnp.maximum(jnp.sqrt(jnp.sum(xT * xT, axis=0)), F.TINY)
    gravT = -(xT / mag[None, :]) * (params.gravity * deg_p1_pad)[None, :]
    return repT + attT + gravT


def fa_step_tiled_T(xT, fprevT, tfa: TiledFA, params: ForceAtlasParams,
                    key=None):
    """One full iteration on transposed state; the [:dim, :n] slice of the
    result follows flat.fa_step (tests/test_tiled_step.py)."""
    fT = tiled_forces_T(xT, tfa, params, key)
    swing = jnp.sqrt(jnp.sum((fT - fprevT) ** 2, axis=0))
    speed = params.ks * params.tolerate / (
        1.0 + params.tolerate * jnp.sqrt(swing))
    total_f = jnp.sqrt(jnp.sum(fT * fT, axis=0))
    constraint = jnp.where(total_f > 0,
                           params.ksmax / jnp.maximum(total_f, F.TINY),
                           jnp.inf)
    speed = jnp.minimum(speed, constraint)
    return xT + fT * speed[None, :], fT


def fa_step_tiled(coords, forces_prev, tfa: TiledFA,
                  params: ForceAtlasParams, key=None):
    """``fa_step_tiled_T`` on row-major [n, dim] state; contract identical
    to flat.fa_step."""
    xT, fT = fa_step_tiled_T(SP.pad_coords_T(coords, tfa.n_pad),
                             SP.pad_coords_T(forces_prev, tfa.n_pad),
                             tfa, params, key)
    return (SP.unpad_coords_T(xT, tfa.n, tfa.dim),
            SP.unpad_coords_T(fT, tfa.n, tfa.dim))


@partial(jax.jit, static_argnames=("params", "iterations"))
def _tiled_loop_T(xT0, tfa: TiledFA, key, params, iterations: int):
    def body(i, carry):
        xT, fprevT, key = carry
        key, sub = jax.random.split(key)
        xT, fT = fa_step_tiled_T(xT, fprevT, tfa, params, sub)
        return xT, fT, key

    fprevT = jnp.zeros_like(xT0)
    xT, _, _ = jax.lax.fori_loop(0, iterations, body, (xT0, fprevT, key))
    coords = SP.unpad_coords_T(xT, tfa.n, tfa.dim)
    if params.normalize:
        coords = F.normalize_coords(coords)
    return coords


def force_atlas_tiled(g: Graph, dim: int = 2, *, coords=None, key=None,
                      params: ForceAtlasParams | None = None,
                      iterations: int | None = None):
    """Flat FA layout on the transposed fast path (drop-in for
    flat.force_atlas; reorder the graph first -- graph.reorder -- so more
    edges land on DIA diagonals and the gathers stay local)."""
    params = params or ForceAtlasParams(repulsion="sampled")
    if iterations is None:
        iterations = params.iterations
    if key is None:
        key = jax.random.PRNGKey(0)
    key, init_key = jax.random.split(key)
    if coords is None:
        coords = jax.random.uniform(init_key, (g.n, dim), dtype=jnp.float32,
                                    minval=-1.0, maxval=1.0)
    tfa = prepare_tiled(g, dim, params)
    xT0 = SP.pad_coords_T(jnp.asarray(coords), tfa.n_pad)
    return _tiled_loop_T(xT0, tfa, key, params, iterations)
