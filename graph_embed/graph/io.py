"""Graph file readers/writers.

Re-provides the linalgcpp reader surface consumed by the reference CLI
(examples/embed.cpp:80-91): ``adjlist``, ``coolist``, ``table``, ``csr``,
``mtx`` -- plus the writers of src/export.cpp (``writePartition``,
``writeCoords``) and linalgcpp ``WriteCooList`` (run-tests.cpp:412).

Formats (documented here since linalgcpp is not vendored):
  adjlist  one edge per line: ``i j``             (weight 1.0)
  coolist  one entry per line: ``i j w``
  table    line ``i`` lists the neighbor ids of vertex ``i`` (weight 1.0)
  csr      line 1: ``rows cols nnz``; line 2: indptr; line 3: indices;
           line 4: data (whitespace separated)
  mtx      MatrixMarket coordinate format (1-based; ``symmetric`` honored)

Parsing hot path uses the optional native C++ loader
(graph_embed/native) when built, with a numpy fallback.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges

FORMATS = ("adjlist", "coolist", "table", "csr", "mtx")


def _parse_pairs(path):
    try:
        from ..native import fastload

        return fastload.parse_edges(path, 2)
    except Exception:
        data = np.loadtxt(path, dtype=np.float64, comments=("%", "#"), ndmin=2)
        return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), None


def _parse_triples(path):
    try:
        from ..native import fastload

        return fastload.parse_edges(path, 3)
    except Exception:
        data = np.loadtxt(path, dtype=np.float64, comments=("%", "#"), ndmin=2)
        if data.shape[1] < 3:
            return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), None
        return (
            data[:, 0].astype(np.int64),
            data[:, 1].astype(np.int64),
            data[:, 2],
        )


def read_adjlist(path, symmetric: bool = False, **kw) -> Graph:
    """Edge-pair list, weight 1.0 (linalgcpp ``ReadAdjList``)."""
    s, r, _ = _parse_pairs(path)
    return from_edges(s, r, None, symmetrize=symmetric, **kw)


def read_coolist(path, symmetric: bool = False, **kw) -> Graph:
    """Weighted triple list (linalgcpp ``ReadCooList``)."""
    s, r, w = _parse_triples(path)
    return from_edges(s, r, w, symmetrize=symmetric, **kw)


def read_table(path, **kw) -> Graph:
    """Per-row neighbor lists (linalgcpp ``ReadTable``)."""
    senders, receivers = [], []
    num_rows = 0
    with open(path) as f:
        for i, line in enumerate(f):
            num_rows = i + 1
            for tok in line.split():
                senders.append(i)
                receivers.append(int(tok))
    n = max(num_rows, (max(receivers) + 1) if receivers else 0)
    return from_edges(np.array(senders, dtype=np.int64),
                      np.array(receivers, dtype=np.int64), None, n=n, **kw)


def read_csr(path, **kw) -> Graph:
    """Explicit CSR dump (linalgcpp ``ReadCSR``-equivalent)."""
    with open(path) as f:
        rows, cols, nnz = (int(x) for x in f.readline().split())
        indptr = np.array(f.readline().split(), dtype=np.int64)
        indices = np.array(f.readline().split(), dtype=np.int64)
        data = np.array(f.readline().split(), dtype=np.float64)
    assert indptr.shape[0] == rows + 1 and indices.shape[0] == nnz
    senders = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    return from_edges(senders, indices, data, n=max(rows, cols), **kw)


def read_mtx(path, **kw) -> Graph:
    """MatrixMarket coordinate format (linalgcpp ``ReadMTX``-equivalent)."""
    symmetric = False
    with open(path) as f:
        header = f.readline()
        if header.startswith("%%MatrixMarket"):
            symmetric = "symmetric" in header.lower()
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(x) for x in line.split())
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.size == 0:
        s = r = np.zeros(0, dtype=np.int64)
        w = None
    else:
        s = data[:, 0].astype(np.int64) - 1
        r = data[:, 1].astype(np.int64) - 1
        w = data[:, 2] if data.shape[1] > 2 else None
    return from_edges(s, r, w, n=max(rows, cols), symmetrize=symmetric, **kw)


_READERS = {
    "adjlist": read_adjlist,
    "coolist": read_coolist,
    "table": read_table,
    "csr": read_csr,
    "mtx": read_mtx,
}


def read_graph(path, fmt: str, symmetric: bool = False, **kw) -> Graph:
    """Format-dispatched read (examples/embed.cpp:80-91)."""
    if fmt not in _READERS:
        raise ValueError(f"format must be one of {FORMATS}, got {fmt!r}")
    if fmt in ("adjlist", "coolist"):
        return _READERS[fmt](path, symmetric=symmetric, **kw)
    return _READERS[fmt](path, **kw)


# -- writers ----------------------------------------------------------------

def write_partition(vertex_to_agg, path) -> None:
    """One aggregate id per line (src/export.cpp:16-25)."""
    arr = np.asarray(vertex_to_agg).astype(np.int64)
    with open(path, "w") as f:
        f.write("\n".join(str(int(a)) for a in arr))
        f.write("\n")


def write_coords(coords, path) -> None:
    """One space-separated coordinate row per vertex (src/export.cpp:27-39)."""
    arr = np.asarray(coords)
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join(repr(float(v)) for v in row))
            f.write(" \n")


def write_coolist(g: Graph, path) -> None:
    """Edge triple dump (linalgcpp ``WriteCooList``, run-tests.cpp:412)."""
    s, r, w = g.to_coo_numpy()
    with open(path, "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{int(i)} {int(j)} {float(v)}\n")


def write_multilevel_partition(hierarchy_assignments, path) -> None:
    """The embedder pipeline's multi-level partition dump (embedder.cpp:230-267).

    ``hierarchy_assignments``: list over levels; level ``l`` is an int array
    mapping level-``l`` vertices to level-``l+1`` aggregate ids.  The file
    stores, per level, one line per aggregate listing its member vertex ids.
    """
    n = int(np.asarray(hierarchy_assignments[0]).shape[0])
    k = len(hierarchy_assignments)
    with open(path, "w") as f:
        f.write(f"{n} {k}\n")
        f.write(" ".join(str(int(np.asarray(a).max()) + 1) for a in hierarchy_assignments))
        f.write(" \n")
        for assign in hierarchy_assignments:
            assign = np.asarray(assign)
            m = int(assign.max()) + 1
            order = np.argsort(assign, kind="stable")
            counts = np.bincount(assign, minlength=m)
            start = 0
            for a in range(m):
                members = order[start:start + counts[a]]
                start += counts[a]
                f.write(" ".join(str(int(v)) for v in members))
                f.write(" \n")
