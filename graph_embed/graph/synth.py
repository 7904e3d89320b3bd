"""Synthetic graph families for the quality/capability roster.

The reference benchmarks against a roster of real SNAP/DIMACS graphs
(examples/run-tests.cpp:361-400: roadNet-*, delaunay_n24, com-lj,
com-youtube, email-Eu-core, ...).  Those files cannot be fetched in an
air-gapped environment, so the harness and capability runs use synthetic
stand-ins of the same families and sizes:

* ``mesh3d`` -- the mesh/roadnet family (regular sparse, high diameter):
  roadNet-CA/PA/TX, mat_* meshes, delaunay_n24, road_germany-osm.
* ``rmat`` -- the social/web family (power-law, low diameter): com-lj
  (scale 22 x 16), com-youtube, web-google.
* ``planted_partition`` -- ground-truth community graphs: email-Eu-core
  with its .cmty labels (run-tests.cpp:302-349 pair counting).
* ``ring_of_cliques`` -- the classic modularity sanity family.

All generators are deterministic given ``seed`` and return the same
symmetrized ``Graph`` a reader would.
"""

from __future__ import annotations

import numpy as np


def mesh3d(L: int, *, extra_frac: float = 0.0, seed: int = 0, dtype=None):
    """L^3 3D grid (6-neighborhood) + optional random long-range edges."""
    import jax.numpy as jnp

    from .csr import from_edges

    n = L ** 3
    idx = np.arange(n)
    x, y, z = idx % L, (idx // L) % L, idx // (L * L)
    ss, rr = [], []
    for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        m = (x + dx < L) & (y + dy < L) & (z + dz < L)
        ss.append(idx[m])
        rr.append(idx[m] + dx + dy * L + dz * L * L)
    if extra_frac > 0.0:
        rng = np.random.default_rng(seed)
        n_extra = int(n * extra_frac)
        ss.append(rng.integers(0, n, n_extra))
        rr.append(rng.integers(0, n, n_extra))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    return from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=dtype or jnp.float32)


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0, dtype=None,
         permute: bool = True, compact: bool = True):
    """R-MAT power-law graph (Graph500 defaults): n = 2^scale vertices,
    ~n*edge_factor directed draws, symmetrized and deduplicated.

    ``permute`` shuffles vertex ids (Graph500 style) so locality does not
    leak from the recursive construction; disable for locality studies.
    ``compact`` (default) drops isolated vertices and relabels densely --
    the shape a real SNAP/DIMACS edge file has (only edge endpoints are
    named).  R-MAT leaves ~40% of ids untouched at edge_factor 8-16, and
    isolated vertices can never merge, which starves coarsening-ratio
    crossings in the hierarchy partitioner.
    """
    import jax.numpy as jnp

    from .csr import from_edges

    n = 1 << scale
    E = n * edge_factor
    rng = np.random.default_rng(seed)
    s = np.zeros(E, dtype=np.int64)
    r = np.zeros(E, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        u = rng.random(E)
        sbit = u >= ab                              # bottom half quadrants
        rbit = ((u >= a) & (u < ab)) | (u >= abc)   # right half quadrants
        s = (s << 1) | sbit
        r = (r << 1) | rbit
    if permute:
        perm = rng.permutation(n)
        s, r = perm[s], perm[r]
    keep = s != r
    s, r = s[keep], r[keep]
    if compact:
        used = np.zeros(n, dtype=bool)
        used[s] = True
        used[r] = True
        relabel = np.cumsum(used) - 1
        s, r, n = relabel[s], relabel[r], int(used.sum())
    return from_edges(s, r, None, n=n, symmetrize=True,
                      dtype=dtype or jnp.float32)


def planted_partition(num_communities: int, size: int, *, p_in: float = 0.3,
                      p_out: float = 0.01, seed: int = 0, dtype=None):
    """Planted-partition (SBM) graph with ground-truth labels.

    Returns (graph, labels[n]) -- the synthetic stand-in for graphs with
    ``.cmty`` ground truth (run-tests.cpp:302-349)."""
    import jax.numpy as jnp

    from .csr import from_edges

    n = num_communities * size
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(num_communities), size)
    # sample intra edges per community, inter edges globally (binomial draws)
    ss, rr = [], []
    for k in range(num_communities):
        base = k * size
        m_in = rng.binomial(size * (size - 1) // 2, p_in)
        i = rng.integers(0, size, m_in)
        j = rng.integers(0, size, m_in)
        ss.append(base + i)
        rr.append(base + j)
    m_out = rng.binomial(n * (n - 1) // 2, p_out)
    i = rng.integers(0, n, m_out)
    j = rng.integers(0, n, m_out)
    keep = labels[i] != labels[j]
    ss.append(i[keep])
    rr.append(j[keep])
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                   dtype=dtype or jnp.float32)
    return g, labels


def community_rmat(num_communities: int, scale: int, edge_factor: int = 8,
                   *, inter_frac: float = 0.05, seed: int = 0, dtype=None):
    """Clustered power-law graph: ``num_communities`` independent RMAT
    blocks (power-law degrees WITHIN each community) plus uniform random
    inter-community edges (``inter_frac`` of the intra count).

    ``scale`` is the TOTAL log2 vertex count (``n = 2**scale``, matching
    ``rmat(scale, ...)`` totals); each community is an RMAT of
    ``2**(scale - log2(num_communities))`` vertices, so
    ``community_rmat(64, 20, 8)`` is 64 x 16k-vertex blocks, ~16M stored
    entries -- comparable to ``rmat(20, 8)``, not 64x it.

    Graph500 RMAT with id permutation is the WORST case for locality --
    by construction it has no community structure, which real social/web
    graphs (com-lj, com-youtube, web-google: run-tests.cpp:361-400) very
    much do.  This family models the realistic case: a partition/community
    ordering makes the adjacency block-diagonal-dominant, so windowed-SpMV
    cells inside each community block are dense.  Vertices arrive
    community-sorted (the order a partition_order pass would produce)."""
    import jax.numpy as jnp

    from .csr import from_edges

    rng = np.random.default_rng(seed)
    lg = max(num_communities.bit_length() - 1, 0)
    if (1 << lg) != num_communities:
        raise ValueError("num_communities must be a power of two")
    scale_c = scale - lg
    if scale_c < 1:
        raise ValueError(f"scale {scale} too small for "
                         f"{num_communities} communities")
    m = 1 << scale_c
    ss, rr = [], []
    E_c = m * edge_factor
    ab, abc = 0.57 + 0.19, 0.57 + 0.19 + 0.19
    for c in range(num_communities):
        s = np.zeros(E_c, dtype=np.int64)
        r = np.zeros(E_c, dtype=np.int64)
        for _ in range(scale_c):
            u = rng.random(E_c)
            s = (s << 1) | (u >= ab)
            r = (r << 1) | (((u >= 0.57) & (u < ab)) | (u >= abc))
        perm = rng.permutation(m)
        ss.append(c * m + perm[s])
        rr.append(c * m + perm[r])
    n = num_communities * m
    n_inter = int(num_communities * E_c * inter_frac)
    ss.append(rng.integers(0, n, n_inter))
    rr.append(rng.integers(0, n, n_inter))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    return from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=dtype or jnp.float32)


def _cache_path(family: str, args, kwargs, cache_dir: str | None) -> str:
    import hashlib
    import os

    if cache_dir is None:
        cache_dir = os.path.join(os.path.expanduser("~"), ".cache",
                                 "graph_embed", "synth")
    os.makedirs(cache_dir, exist_ok=True)
    sig = repr((args, sorted(kwargs.items())))
    h = hashlib.sha1(sig.encode()).hexdigest()[:12]
    argtxt = "_".join(str(a) for a in args)
    return os.path.join(cache_dir, f"{family}_{argtxt}_{h}.npz")


def cached(family: str, *args, cache_dir: str | None = None, **kwargs):
    """Disk-cached synthetic generation keyed by (family, args, kwargs)
    (rmat(23,8) generation alone takes minutes; the canonical deduped COO
    loads back in seconds via csr.from_canonical_coo, skipping the
    sort/dedup entirely).

    ``cached("rmat", 22, 8, seed=1)`` == ``rmat(22, 8, seed=1)`` (same
    Graph, host COO bit-identical).  planted_partition returns its
    ``(graph, labels)`` tuple from the cache too.  Corrupt/partial cache
    files are regenerated (atomic ``os.replace`` publication)."""
    import os

    from .csr import from_canonical_coo

    fams = {"mesh3d": mesh3d, "rmat": rmat,
            "planted_partition": planted_partition,
            "community_rmat": community_rmat,
            "ring_of_cliques": ring_of_cliques}
    if family not in fams:
        raise ValueError(f"unknown synth family {family!r}; "
                         f"one of {sorted(fams)}")
    path = _cache_path(family, args, kwargs, cache_dir)

    if os.path.exists(path):
        try:
            z = np.load(path)
            g = from_canonical_coo(z["s"], z["r"], z["w"], int(z["n"]))
            if "labels" in z:
                return g, z["labels"]
            return g
        except Exception:
            pass              # corrupt/partial -> regenerate below

    out = fams[family](*args, **kwargs)
    g, labels = out if isinstance(out, tuple) else (out, None)
    s, r, w = g.to_coo_numpy()
    # int32 ids when they fit: halves the cache file and the load time
    itype = np.int32 if g.n < (1 << 31) else np.int64
    payload = {"s": s.astype(itype), "r": r.astype(itype),
               "w": np.asarray(w), "n": np.int64(g.n)}
    if labels is not None:
        payload["labels"] = np.asarray(labels)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return out


def cached_arrays(family: str, *args, load_weights: bool = True,
                  cache_dir: str | None = None, **kwargs):
    """Like :func:`cached` but returns the raw canonical COO
    ``(s, r, w, n)`` WITHOUT constructing a Graph on a cache hit -- for
    callers that rebuild with their own weights anyway (the unweighted
    pipeline rebuild in scripts/lj_scale_run.py).  ``load_weights=False``
    skips reading the weight member (npz members load lazily)."""
    import os

    path = _cache_path(family, args, kwargs, cache_dir)
    if os.path.exists(path):
        try:
            z = np.load(path)
            w = z["w"] if load_weights else None
            return z["s"], z["r"], w, int(z["n"])
        except Exception:
            pass
    out = cached(family, *args, cache_dir=cache_dir, **kwargs)
    g = out[0] if isinstance(out, tuple) else out
    s, r, w = g.to_coo_numpy()
    return s, r, (w if load_weights else None), g.n


def ring_of_cliques(num_cliques: int, clique_size: int, *, dtype=None):
    """num_cliques K_{clique_size} cliques joined in a ring by single edges."""
    import jax.numpy as jnp

    from .csr import from_edges

    K, C = clique_size, num_cliques
    ss, rr = [], []
    i, j = np.triu_indices(K, 1)
    for c in range(C):
        base = c * K
        ss.append(base + i)
        rr.append(base + j)
        ss.append(np.array([base]))
        rr.append(np.array([((c + 1) % C) * K]))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    return from_edges(s, r, None, n=C * K, symmetrize=True,
                      dtype=dtype or jnp.float32)
