"""Differential tests: native pack.cpp backend vs the numpy reference paths.

The native radix-sort backend must be BIT-identical to the numpy
implementation it replaces (graph.csr._finish_coo sum-duplicates),
including float summation order.
"""

import numpy as np
import pytest

import graph_embed.graph.csr as csr
from graph_embed.graph import from_coo

pack_lib = pytest.importorskip("graph_embed.native.pack_lib")

try:
    pack_lib._lib()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="no native toolchain")


def _numpy_dedup(s, r, w, n):
    """Inline transcription of the numpy branch of csr._finish_coo."""
    key = s * np.int64(n) + r
    order = np.argsort(key, kind="stable")
    key, s, r, w = key[order], s[order], r[order], w[order]
    uniq = np.empty(key.shape, dtype=bool)
    uniq[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq[1:])
    seg = np.cumsum(uniq) - 1
    w_sum = np.zeros(int(seg[-1]) + 1, dtype=w.dtype)
    np.add.at(w_sum, seg, w)
    s, r, w = s[uniq], r[uniq], w_sum
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, s + 1, 1)
    return s, r, w, np.cumsum(indptr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_dedup_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 97
    m = 4000  # dense in keys -> plenty of duplicates (incl. >2 per key)
    s = rng.integers(0, n, size=m).astype(np.int64)
    r = rng.integers(0, n, size=m).astype(np.int64)
    w = rng.normal(size=m)  # signed, so summation order matters bitwise
    so, ro, wo, ip = pack_lib.coo_dedup(s, r, w, n)
    s2, r2, w2, ip2 = _numpy_dedup(s.copy(), r.copy(), w.copy(), n)
    np.testing.assert_array_equal(so, s2)
    np.testing.assert_array_equal(ro, r2)
    np.testing.assert_array_equal(ip, ip2)
    assert wo.tobytes() == w2.tobytes()  # bitwise, not allclose


def test_coo_dedup_no_duplicates_and_empty_rows():
    # unique keys + vertices with no out-edges (indptr plateaus)
    s = np.array([5, 5, 2, 9], dtype=np.int64)
    r = np.array([1, 0, 2, 9], dtype=np.int64)
    w = np.array([1.5, 2.5, -3.0, 0.25])
    so, ro, wo, ip = pack_lib.coo_dedup(s, r, w, 12)
    s2, r2, w2, ip2 = _numpy_dedup(s, r, w, 12)
    np.testing.assert_array_equal(so, s2)
    np.testing.assert_array_equal(ro, r2)
    assert wo.tobytes() == w2.tobytes()
    np.testing.assert_array_equal(ip, ip2)


def test_from_coo_native_matches_numpy(monkeypatch):
    """End-to-end: the auto-dispatched native path in from_coo equals a
    numpy-forced run on >64k edges (the dispatch threshold)."""
    rng = np.random.default_rng(7)
    n = 3000
    m = 80_000
    s = rng.integers(0, n, size=m)
    r = rng.integers(0, n, size=m)
    w = rng.normal(size=m)
    g_nat = from_coo(s, r, w, n=n)
    monkeypatch.setattr(csr, "_NATIVE_MIN_EDGES", 1 << 60)
    g_np = from_coo(s, r, w, n=n)
    for a, b in zip(g_nat._host_coo, g_np._host_coo):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(g_nat.indptr),
                                  np.asarray(g_np.indptr))
    np.testing.assert_array_equal(np.asarray(g_nat.weights),
                                  np.asarray(g_np.weights))
