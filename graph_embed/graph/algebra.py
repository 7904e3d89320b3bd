"""Sparse-matrix algebra surface.

Completes the linalgcpp operation set the reference consumes
(SURVEY.md SS2.3): ``Transpose`` (used for vertex->aggregate maps,
embed.cpp:605), general ``Mult`` SpGEMM (Galerkin products,
examples/embed.cpp:97 -- the aggregation-specific fast path lives in
ops/spgemm.py), ``ScaleRows/ScaleCols`` (embedder.cpp:176-177), and a
device-side mat-vec.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .csr import Graph, from_edges


def transpose(g: Graph) -> Graph:
    """A^T (host rebuild; swaps the COO axes)."""
    s, r, w = g.to_coo_numpy()
    return from_edges(r, s, w, n=g.n, dtype=g.dtype)


def matmul(a: Graph, b: Graph) -> Graph:
    """General sparse-sparse product A @ B (host, via scipy CSR; the
    aggregation triple product has the device-friendly fast path in
    ops.spgemm.coarsen_graph)."""
    import scipy.sparse as sp

    sa, ra, wa = a.to_coo_numpy()
    sb, rb, wb = b.to_coo_numpy()
    A = sp.csr_matrix((wa, (sa, ra)), shape=(a.n, a.n))
    B = sp.csr_matrix((wb, (sb, rb)), shape=(b.n, b.n))
    C = (A @ B).tocoo()
    return from_edges(C.row, C.col, C.data, n=a.n, dtype=a.dtype)


def scale_rows(g: Graph, v) -> Graph:
    """diag(v) @ A (linalgcpp ScaleRows)."""
    s, r, w = g.to_coo_numpy()
    v = np.asarray(v)
    return from_edges(s, r, w * v[s], n=g.n, dtype=g.dtype)


def scale_cols(g: Graph, v) -> Graph:
    """A @ diag(v) (linalgcpp ScaleCols)."""
    s, r, w = g.to_coo_numpy()
    v = np.asarray(v)
    return from_edges(s, r, w * v[r], n=g.n, dtype=g.dtype)


def matvec(g: Graph, x):
    """Device-side y = A @ x for dense [n] or [n, d] x (XLA segment path;
    the FA step's sender-sorted form is ops.spmv.spmv_T)."""
    n = g.n
    sc = jnp.clip(g.senders, 0, n - 1)
    rc = jnp.clip(g.receivers, 0, n - 1)
    w = jnp.where(g.edge_mask, g.weights, 0)
    vals = x[rc]
    if vals.ndim == 1:
        vals = vals * w
    else:
        vals = vals * w[:, None]
    seg = jnp.where(g.senders < n, g.senders, n)
    return jax.ops.segment_sum(vals, seg, num_segments=n + 1)[:n]
