"""Core graph container: a struct of flat device arrays with static shapes.

Array replacement for the linalgcpp ``SparseMatrix<double>`` CSR container
used throughout the reference (reference: include/matrixutils.hpp:15-19 and the
``GetIndptr()/GetIndices()/GetData()`` access pattern, e.g. forceatlas.hpp:112-114).

Design: a graph is a pytree of flat arrays -- ``senders[E]``, ``receivers[E]``,
``weights[E]`` in CSR (row-major) order plus ``indptr[n+1]`` -- padded to a
static capacity so that every algorithm is a pure jitted function.  The number
of *valid* edges is a static Python int (``num_edges``); the padded tail is
masked with ``jnp.arange(E) < num_edges`` which constant-folds under jit.
Padded entries hold ``senders = receivers = n`` (an out-of-range ghost vertex,
dropped by XLA scatter) and ``weights = 0``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly weighted, symmetric) sparse adjacency matrix in flat-array form.

    Fields
    ------
    indptr:    [n+1] int32, CSR row pointers over the *valid* edge prefix.
    senders:   [E_pad] int32, CSR-expanded row ids (sorted), ghost ``n`` in pad.
    receivers: [E_pad] int32, column ids, ghost ``n`` in pad.
    weights:   [E_pad] float, zero in pad.
    n:         static int, number of vertices (rows == cols).
    num_edges: static int, number of valid (stored) entries; every stored
               direction counts, so a symmetric graph stores each undirected
               edge twice plus self loops once, exactly like the reference CSR.
    """

    indptr: jnp.ndarray
    senders: jnp.ndarray
    receivers: jnp.ndarray
    weights: jnp.ndarray
    n: int
    num_edges: int

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (
            (self.indptr, self.senders, self.receivers, self.weights),
            (self.n, self.num_edges),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, senders, receivers, weights = children
        n, num_edges = aux
        return cls(indptr, senders, receivers, weights, n, num_edges)

    # -- convenience --------------------------------------------------------
    @property
    def dtype(self):
        return self.weights.dtype

    @property
    def capacity(self) -> int:
        return int(self.senders.shape[0])

    @property
    def edge_mask(self) -> jnp.ndarray:
        """[E_pad] bool, True on valid entries.  Constant under jit."""
        return jnp.arange(self.capacity) < self.num_edges

    def row_counts(self) -> jnp.ndarray:
        """[n] number of stored entries per row (unweighted degree)."""
        return (self.indptr[1:] - self.indptr[:-1]).astype(self.dtype)

    def row_sums(self) -> jnp.ndarray:
        """[n] weighted degree = row sum incl. diagonal (forceatlas.hpp:127-135)."""
        w = jnp.where(self.edge_mask, self.weights, 0)
        return jax.ops.segment_sum(w, self.senders, num_segments=self.n + 1)[: self.n]

    def degrees(self, use_weights: bool = True) -> jnp.ndarray:
        """Degree vector per the reference semantics (forceatlas.hpp:127-140)."""
        return self.row_sums() if use_weights else self.row_counts()

    def total_weight(self) -> jnp.ndarray:
        """Sum of all stored entries (the ``T`` of modularity, partitioner.cpp:101)."""
        return jnp.sum(jnp.where(self.edge_mask, self.weights, 0))

    # -- host-side views ----------------------------------------------------
    def to_coo_numpy(self):
        """Valid (senders, receivers, weights) as numpy arrays.

        Graphs built on the host carry a cached host copy (no device->host
        readback of large arrays); pytree-reconstructed graphs fall back to a
        device pull."""
        cached = getattr(self, "_host_coo", None)
        if cached is not None:
            return cached
        e = self.num_edges
        return (
            np.asarray(self.senders)[:e],
            np.asarray(self.receivers)[:e],
            np.asarray(self.weights)[:e],
        )

    def degrees_numpy(self, use_weights: bool = True) -> np.ndarray:
        """Host-side degree vector (uses the cached COO, no device pull)."""
        s, r, w = self.to_coo_numpy()
        deg = np.zeros(self.n, dtype=np.float64)
        if use_weights:
            np.add.at(deg, s, w)
        else:
            np.add.at(deg, s, 1.0)
        return deg

    def to_dense_numpy(self) -> np.ndarray:
        s, r, w = self.to_coo_numpy()
        out = np.zeros((self.n, self.n), dtype=np.asarray(self.weights).dtype)
        np.add.at(out, (s, r), w)
        return out

    def __repr__(self):  # keep pytest output readable
        return (
            f"Graph(n={self.n}, num_edges={self.num_edges}, "
            f"capacity={self.capacity}, dtype={self.dtype})"
        )


def from_coo(
    senders,
    receivers,
    weights=None,
    *,
    n: int | None = None,
    symmetrize: bool = False,
    sum_duplicates: bool = True,
    dtype=jnp.float32,
    pad_to: int | None = None,
    pad_multiple: int = 128,
) -> Graph:
    """Build a :class:`Graph` from COO triples (host-side; numpy based).

    Replaces the linalgcpp ``CooMatrix.Add + ToSparse`` path (embed.cpp:51-66):
    duplicates are summed, rows sorted, CSR indptr built, arrays padded to a
    static capacity (multiple of ``pad_multiple``, so shapes recur).

    ``symmetrize=True`` mirrors linalgcpp's read ``symmetric`` flag: it adds the
    transpose of every off-diagonal entry.
    """
    s = np.asarray(senders, dtype=np.int64).ravel()
    r = np.asarray(receivers, dtype=np.int64).ravel()
    if weights is None:
        w = np.ones(s.shape[0], dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64).ravel()
    if not (s.shape == r.shape == w.shape):
        raise ValueError("senders/receivers/weights must have equal length")
    if n is None:
        n = int(max(s.max(initial=-1), r.max(initial=-1)) + 1)
    if s.size and (s.min() < 0 or r.min() < 0 or s.max() >= n or r.max() >= n):
        raise ValueError("vertex id out of range")

    if symmetrize:
        off = s != r
        s, r, w = (
            np.concatenate([s, r[off]]),
            np.concatenate([r, s[off][: off.sum()]]),
            np.concatenate([w, w[off]]),
        )

    return _finish_coo(s, r, w, n, symmetrize=False, sum_duplicates=sum_duplicates,
                       dtype=dtype, pad_to=pad_to, pad_multiple=pad_multiple)


_NATIVE_MIN_EDGES = 1 << 16  # below this, numpy beats the ctypes round-trip


def _finish_coo(s, r, w, n, *, symmetrize, sum_duplicates, dtype, pad_to, pad_multiple):
    indptr = None
    if sum_duplicates and s.size >= _NATIVE_MIN_EDGES:
        # hot host path: the stable sort dominates (np.argsort ~20s at 12.5M
        # edges on this 2-core host); the native radix backend is
        # bit-identical (tests/test_native_pack.py) and ~10x faster
        try:
            from ..native import pack_lib

            s, r, w, indptr = pack_lib.coo_dedup(s, r, w, n)
        except Exception:
            indptr = None
    if indptr is None and sum_duplicates and s.size:
        key = s * np.int64(n) + r
        order = np.argsort(key, kind="stable")
        key, s, r, w = key[order], s[order], r[order], w[order]
        uniq_mask = np.empty(key.shape, dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        seg = np.cumsum(uniq_mask) - 1
        w_sum = np.zeros(int(seg[-1]) + 1, dtype=w.dtype)
        np.add.at(w_sum, seg, w)
        s, r, w = s[uniq_mask], r[uniq_mask], w_sum
    elif indptr is None and s.size:
        order = np.lexsort((r, s))
        s, r, w = s[order], r[order], w[order]

    e = int(s.size)
    cap = pad_to if pad_to is not None else max(_round_up(max(e, 1), pad_multiple), pad_multiple)
    if cap < e:
        raise ValueError(f"pad_to={cap} smaller than num_edges={e}")

    if indptr is None:
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, s + 1, 1)
        indptr = np.cumsum(indptr)

    sp = np.full(cap, n, dtype=np.int32)
    rp = np.full(cap, n, dtype=np.int32)
    wp = np.zeros(cap, dtype=np.float64)
    sp[:e], rp[:e], wp[:e] = s, r, w

    g = Graph(
        indptr=jnp.asarray(indptr, dtype=jnp.int32),
        senders=jnp.asarray(sp),
        receivers=jnp.asarray(rp),
        weights=jnp.asarray(wp, dtype=dtype),
        n=int(n),
        num_edges=e,
    )
    # host copy for tiling/export paths (frozen dataclass: set via object);
    # weights are stored at the graph's dtype so host and device views agree
    object.__setattr__(
        g, "_host_coo",
        (s.copy(), r.copy(), w.astype(np.dtype(jnp.dtype(dtype).name))))
    return g


def from_edges(
    senders,
    receivers,
    weights=None,
    *,
    n: int | None = None,
    symmetrize: bool = False,
    dtype=jnp.float32,
    pad_to: int | None = None,
    pad_multiple: int = 128,
) -> Graph:
    """Build a Graph from an edge list, optionally adding the reverse direction.

    This is the canonical entry point (reference: linalgcpp ``ReadCooList``
    with ``symmetric`` flag, examples/embed.cpp:81-91).
    """
    s = np.asarray(senders, dtype=np.int64).ravel()
    r = np.asarray(receivers, dtype=np.int64).ravel()
    if weights is None:
        w = np.ones(s.shape[0], dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64).ravel()
    if n is None:
        n = int(max(s.max(initial=-1), r.max(initial=-1)) + 1) if s.size else 0
    if symmetrize:
        off = s != r
        s2 = np.concatenate([s, r[off]])
        r2 = np.concatenate([r, s[off]])
        w2 = np.concatenate([w, w[off]])
        s, r, w = s2, r2, w2
    return _finish_coo(s, r, w, n, symmetrize=False, sum_duplicates=True,
                       dtype=dtype, pad_to=pad_to, pad_multiple=pad_multiple)


def from_canonical_coo(s, r, w, n: int, *, dtype=jnp.float32,
                       pad_multiple: int = 128) -> Graph:
    """Trusted constructor: the COO is ALREADY sorted by (sender, receiver),
    deduplicated and self-loop-free -- skip the sort/dedup entirely (the
    hot host cost of from_edges; used by the synth disk cache, which stores
    exactly to_coo_numpy()'s canonical arrays)."""
    s = np.ascontiguousarray(s).ravel()
    r = np.ascontiguousarray(r).ravel()
    w = (np.ones(s.shape[0], np.float64) if w is None
         else np.asarray(w, dtype=np.float64).ravel())
    e = int(s.size)
    indptr = np.zeros(n + 1, dtype=np.int64)
    # bincount, not np.add.at (the ufunc.at path costs ~10s at 131M edges)
    indptr[1:] = np.cumsum(np.bincount(s, minlength=n)[:n])
    cap = max(_round_up(max(e, 1), pad_multiple), pad_multiple)
    sp = np.full(cap, n, dtype=np.int32)
    rp = np.full(cap, n, dtype=np.int32)
    wp = np.zeros(cap, dtype=np.float64)
    sp[:e], rp[:e], wp[:e] = s, r, w
    g = Graph(indptr=jnp.asarray(indptr, dtype=jnp.int32),
              senders=jnp.asarray(sp), receivers=jnp.asarray(rp),
              weights=jnp.asarray(wp, dtype=dtype), n=int(n), num_edges=e)
    # host cache stays int64: downstream key arithmetic (s * n + r) must
    # not overflow when a caller mixes the arrays with int32 constants
    object.__setattr__(
        g, "_host_coo",
        (s.astype(np.int64, copy=True), r.astype(np.int64, copy=True),
         w.astype(np.dtype(jnp.dtype(dtype).name))))
    return g


def from_dense(mat, *, dtype=jnp.float32, pad_multiple: int = 128) -> Graph:
    """Build a Graph from a dense adjacency matrix (host; for tests/oracles)."""
    m = np.asarray(mat)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("expected a square matrix")
    s, r = np.nonzero(m)
    return from_edges(s, r, m[s, r], n=m.shape[0], dtype=dtype, pad_multiple=pad_multiple)


def from_scipy(sp_mat, *, dtype=jnp.float32, pad_multiple: int = 128) -> Graph:
    """Build a Graph from any scipy sparse matrix (host; for tests/oracles)."""
    coo = sp_mat.tocoo()
    return from_edges(coo.row, coo.col, coo.data, n=coo.shape[0], dtype=dtype,
                      pad_multiple=pad_multiple)


def submatrix(g: Graph, vertices, *, dtype=None, pad_multiple: int = 128) -> Graph:
    """Induced subgraph on ``vertices`` (reference: linalgcpp ``GetSubMatrix``,
    used by examples/embedder.cpp:92,112).  Host-side."""
    vertices = np.asarray(vertices, dtype=np.int64)
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[vertices] = np.arange(vertices.size)
    s, r, w = g.to_coo_numpy()
    keep = (remap[s] >= 0) & (remap[r] >= 0)
    return from_edges(
        remap[s[keep]], remap[r[keep]], w[keep],
        n=int(vertices.size), dtype=dtype or g.dtype, pad_multiple=pad_multiple,
    )
