"""Adjacency <-> Laplacian converters and identity.

Array equivalents of src/matrixutils.cpp: ``identity`` (:16),
``toLaplacian`` (:31), ``fromLaplacian`` (:72).  The reference does CSR index
surgery to insert/remove the diagonal; here it is a COO relabel + rebuild,
which is the array-first formulation of the same operation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .csr import Graph, from_edges


def identity(n: int, *, dtype=jnp.float32) -> Graph:
    """n x n identity (src/matrixutils.cpp:16)."""
    idx = np.arange(n, dtype=np.int64)
    return from_edges(idx, idx, np.ones(n), n=n, dtype=dtype)


def to_laplacian(g: Graph) -> Graph:
    """L = D - A with D_ii = (row sum of A incl. diagonal), matching the
    reference's convention (src/matrixutils.cpp:31-69: the inserted diagonal
    value is the *full* row sum and off-diagonals are negated; an existing
    diagonal entry of A is overwritten-by-accumulation the same way)."""
    s, r, w = g.to_coo_numpy()
    rowsum = np.zeros(g.n, dtype=w.dtype)
    np.add.at(rowsum, s, w)
    idx = np.arange(g.n, dtype=np.int64)
    # off-diagonal entries negated; diagonal = rowsum (duplicates summed)
    off = s != r
    ss = np.concatenate([s[off], idx])
    rr = np.concatenate([r[off], idx])
    ww = np.concatenate([-w[off], rowsum])
    return from_edges(ss, rr, ww, n=g.n, dtype=g.dtype)


def from_laplacian(lap: Graph) -> Graph:
    """Drop the diagonal and negate off-diagonals (src/matrixutils.cpp:72-99)."""
    s, r, w = lap.to_coo_numpy()
    off = s != r
    return from_edges(s[off], r[off], -w[off], n=lap.n, dtype=lap.dtype)
