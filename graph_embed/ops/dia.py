"""DIA (diagonal / stencil) decomposition of the attraction SpMV.

Mesh- and grid-family graphs (the reference roster's mat_* meshes,
roadNet-*, delaunay -- /root/reference/examples/run-tests.cpp:361-400) carry
most of their edges at a handful of constant index offsets j - i: a 3D
grid in natural order has exactly six (+-1, +-L, +-L^2).  For every edge on
such a "diagonal", the neighbor gather is a pure rotation of the vertex
axis:

    y[i] = sum_k  W_k[i] * x[i + o_k]        (W_k[i] = 0 where no edge)

i.e. ``sum_k W_k * roll(x, -o_k)`` -- no gathers, no atomics, no per-edge
work at all: K passes over x.  Edges NOT on a chosen diagonal (long-range /
irregular) stay on the edge-list SpMV (ops/spmv.py); the decomposition is
exact (each edge is applied exactly once, in f32).

Wrap-around of the roll is harmless by construction: a row whose partner
i + o_k falls outside [0, n) has W_k[i] = 0, and padded columns carry zero
weight everywhere.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

#: an offset qualifies when it covers >= max(DIA_MIN_COUNT, n_pad//16)
#: edges, so each roll+fma pass over [D_PAD, n_pad] replaces many gathers
#: (the threshold is not tuned on the GPU)
DIA_MIN_COUNT = 1 << 16
MAX_OFFSETS = 32


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Host-side result of plan_dia."""

    offsets: tuple          # K static ints (j - i), descending edge count
    weights: np.ndarray     # [K, n_pad] f32, W_k[i] = w(i, i+o_k) or 0
    residual_mask: np.ndarray  # [E] bool: edges NOT absorbed by a diagonal

    @property
    def coverage(self) -> float:
        e = self.residual_mask.size
        return 1.0 - float(self.residual_mask.sum()) / max(e, 1)


def plan_dia(s, r, w, n: int, n_pad: int, *, min_count: int | None = None,
             max_offsets: int = MAX_OFFSETS) -> DiaPlan | None:
    """Pick the index offsets worth a dedicated roll pass (host, numpy).

    Returns None when no offset covers enough edges (irregular graphs --
    the edge-list SpMV keeps everything, zero overhead)."""
    s = np.asarray(s)
    r = np.asarray(r)
    w = np.asarray(w, dtype=np.float64)
    if min_count is None:
        min_count = max(DIA_MIN_COUNT, n_pad // 16)
    if s.size == 0 or min_count <= 0 or s.size < min_count:
        return None
    off = r.astype(np.int64) - s.astype(np.int64)
    vals, inv = np.unique(off, return_inverse=True)
    counts = np.bincount(inv)
    sel = np.flatnonzero(counts >= min_count)
    if sel.size == 0:
        return None
    if sel.size > max_offsets:
        sel = sel[np.argsort(counts[sel])[::-1][:max_offsets]]
    else:
        sel = sel[np.argsort(counts[sel])[::-1]]
    remap = np.full(vals.size, -1, dtype=np.int64)
    remap[sel] = np.arange(sel.size)
    k_of = remap[inv]
    is_dia = k_of >= 0
    weights = np.zeros((sel.size, n_pad), np.float32)
    # (s, offset) pairs are unique in a deduped COO: plain assignment
    weights[k_of[is_dia], s[is_dia]] = w[is_dia].astype(np.float32)
    return DiaPlan(offsets=tuple(int(v) for v in vals[sel]),
                   weights=weights, residual_mask=~is_dia)


def dia_spmv(xT, dia_w, offsets: tuple):
    """y^T [D_PAD, n_pad] = (A_dia @ x)^T as K weighted rolls.

    Pure jnp (runs on any backend); under jit each term is a fused
    slice/concat + fma -- no gathers, no kernel."""
    y = jnp.zeros_like(xT)
    for k, o in enumerate(offsets):
        y = y + dia_w[k][None, :] * jnp.roll(xT, -int(o), axis=1)
    return y


def dia_row_sums(weights: np.ndarray) -> np.ndarray:
    """[n_pad] row sums of the DIA part (host, float64 accumulation)."""
    return weights.astype(np.float64).sum(axis=0).astype(np.float32)
