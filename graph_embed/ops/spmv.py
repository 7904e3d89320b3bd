"""Attraction SpMV over a sender-sorted edge list, in plain XLA.

The O(E) term of every ForceAtlas iteration is y_i = sum_j c_ij x_j over the
stored entries (i, j), with the per-edge constant c_ij folded on the host
(``fold_edge_weights``).  The edges are sorted by sender once; an iteration
gathers the receiver rows of the [n_pad, d] coordinates and reduces them
per sender with ``segment_sum(..., indices_are_sorted=True)``.  The
coordinates of a 1M-vertex graph ([n, 3] f32, 12 MB) fit a 50 MB L2 cache,
so the random receiver gather mostly hits cache.

The force terms keep coordinates transposed, ``xT [D_PAD, n_pad]``
(vertices along the minor axis, rows dim.. exactly zero); the SpMV takes
and returns that layout and gathers whole rows of ``xT[:dim].T``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

D_PAD = 8     # padded coordinate rows of the transposed layout


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Device-resident edge list, sorted by sender.

    senders/receivers: [E] int32 indices into [0, n_pad);
    weights:           [E] float32 folded per-edge constants c_ij."""

    senders: jnp.ndarray
    receivers: jnp.ndarray
    weights: jnp.ndarray
    n_pad: int

    def tree_flatten(self):
        return (self.senders, self.receivers, self.weights), (self.n_pad,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def fold_edge_weights(weights, deg_senders, *, use_weights: bool,
                      delta: float, nohubs: bool):
    """Per-edge multiplicative constant c_e of the attraction magnitude
    (forceatlas.hpp:180-196): fa = g(dist) * c_e with g = dist (or
    log1p(dist) under linlog) and
      c_e = w            (delta == 1)
      c_e = 1            (delta == 0)
      c_e = sign(w)|w|^delta  otherwise
    all divided by (deg_i + 1) when nohubs.  use_weights=False sets w = 1."""
    w = weights if use_weights else np.ones_like(weights)
    if delta == 1.0:
        c = w
    elif delta == 0.0:
        c = np.ones_like(w)
    else:
        c = np.sign(w) * np.abs(w) ** delta
    if nohubs:
        c = c / (deg_senders + 1.0)
    return c


def build_edge_list(s, r, w, n_pad: int) -> tuple[EdgeList, np.ndarray]:
    """Sort (s, r, w) by sender (stable) and put it on the device once.

    Returns (edge list, [n_pad] float32 row sums of the f32 weights -- the
    ``-x_i * sum_j c_ij`` term of the linear attraction form)."""
    s = np.asarray(s, np.int64)
    order = np.argsort(s, kind="stable")
    s = s[order]
    r = np.asarray(r, np.int64)[order]
    w = np.asarray(w, np.float32)[order]
    if s.size and (s[-1] >= n_pad or r.max() >= n_pad):
        raise ValueError(f"edge index out of range for n_pad={n_pad}")
    deg_w = np.bincount(s, weights=w.astype(np.float64),
                        minlength=n_pad).astype(np.float32)
    el = EdgeList(senders=jnp.asarray(s.astype(np.int32)),
                  receivers=jnp.asarray(r.astype(np.int32)),
                  weights=jnp.asarray(w), n_pad=int(n_pad))
    return el, deg_w


def _to_T(y_rows, d_pad: int):
    """[n_pad, dim] -> [d_pad, n_pad] with zero rows dim..d_pad."""
    dim = y_rows.shape[1]
    return jnp.pad(y_rows.T, ((0, d_pad - dim), (0, 0)))


def spmv_T(xT, el: EdgeList, dim: int):
    """y^T [D_PAD, n_pad] = (C @ x)^T over the edge list."""
    x_rows = xT[:dim].T                                   # [n_pad, dim]
    vals = x_rows[el.receivers] * el.weights[:, None]
    y = jax.ops.segment_sum(vals, el.senders, num_segments=el.n_pad,
                            indices_are_sorted=True)
    return _to_T(y, xT.shape[0])


def linlog_attraction_T(xT, el: EdgeList, dim: int, *, attract: float,
                        eps: float):
    """Linlog attraction (forceatlas.hpp:180-186) on the transposed layout:
    per edge attract * c_e * log1p(d) / d * (x_j - x_i), d = max(|x_j - x_i|,
    eps).  The magnitude depends on the distance, so this form gathers both
    endpoints instead of using the linear C @ x - x * rowsum(C)."""
    x_rows = xT[:dim].T
    diff = x_rows[el.receivers] - x_rows[el.senders]
    dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=1)), eps)
    scale = attract * el.weights * jnp.log1p(dist) / dist
    y = jax.ops.segment_sum(diff * scale[:, None], el.senders,
                            num_segments=el.n_pad, indices_are_sorted=True)
    return _to_T(y, xT.shape[0])


def pad_coords_T(coords, n_pad: int):
    """[n, d] -> transposed padded [D_PAD, n_pad] float32."""
    n, d = coords.shape
    assert d <= D_PAD
    xT = jnp.zeros((D_PAD, n_pad), jnp.float32)
    return xT.at[:d, :n].set(coords.T.astype(jnp.float32))


def unpad_coords_T(xT, n: int, d: int):
    return xT[:d, :n].T
