"""Unit tests for the graph core (SURVEY.md SS4: kernel tests vs dense/scipy
oracles)."""

import numpy as np
import jax.numpy as jnp
import pytest

import graph_embed as gt
from conftest import random_graph


def test_from_edges_symmetrize_and_dedup():
    g = gt.from_edges([0, 1, 0], [1, 2, 1], [1.0, 2.0, 3.0], n=3,
                      symmetrize=True, dtype=jnp.float64)
    dense = g.to_dense_numpy()
    expected = np.array([[0, 4, 0], [4, 0, 2], [0, 2, 0]], dtype=np.float64)
    np.testing.assert_allclose(dense, expected)
    assert g.num_edges == 4
    assert g.capacity % 128 == 0


def test_padding_is_ghost():
    g = gt.from_edges([0], [1], [5.0], n=4, dtype=jnp.float64)
    s = np.asarray(g.senders)
    assert (s[g.num_edges:] == g.n).all()
    assert np.asarray(g.weights)[g.num_edges:].sum() == 0


def test_degrees_match_oracle(rng):
    from oracle import degrees

    g = random_graph(rng, 50)
    np.testing.assert_allclose(np.asarray(g.degrees(True)), degrees(g, True),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g.degrees(False)), degrees(g, False))


def test_self_loops_kept():
    g = gt.from_edges([0, 0], [0, 1], [2.0, 1.0], n=2, symmetrize=True,
                      dtype=jnp.float64)
    dense = g.to_dense_numpy()
    np.testing.assert_allclose(dense, [[2, 1], [1, 0]])
    # degree includes the diagonal (forceatlas.hpp:127-135)
    np.testing.assert_allclose(np.asarray(g.degrees()), [3.0, 1.0])


def test_indptr_consistent(rng):
    g = random_graph(rng, 30)
    indptr = np.asarray(g.indptr)
    s, r, w = g.to_coo_numpy()
    for i in range(g.n):
        assert (s[indptr[i]:indptr[i + 1]] == i).all()
    assert (np.diff(indptr) >= 0).all()
    assert indptr[-1] == g.num_edges


def test_submatrix(rng):
    g = random_graph(rng, 20)
    keep = np.array([3, 5, 7, 11, 13])
    sub = gt.submatrix(g, keep)
    dense = g.to_dense_numpy()
    np.testing.assert_allclose(sub.to_dense_numpy(), dense[np.ix_(keep, keep)])


def test_laplacian_roundtrip(rng):
    g = random_graph(rng, 25)
    lap = gt.to_laplacian(g)
    dense_l = lap.to_dense_numpy()
    dense_a = g.to_dense_numpy()
    # off-diagonal: -A; diagonal: full row sum of A
    np.testing.assert_allclose(dense_l - np.diag(np.diag(dense_l)),
                               -(dense_a - np.diag(np.diag(dense_a))))
    np.testing.assert_allclose(np.diag(dense_l), dense_a.sum(axis=1))
    back = gt.from_laplacian(lap)
    off = dense_a - np.diag(np.diag(dense_a))
    np.testing.assert_allclose(back.to_dense_numpy(), off)


def test_largest_component():
    # two components: triangle {0,1,2} and edge {3,4}
    g = gt.from_edges([0, 1, 2, 3], [1, 2, 0, 4], None, n=5, symmetrize=True)
    sub, verts = gt.largest_component(g)
    assert sorted(verts.tolist()) == [0, 1, 2]
    assert sub.n == 3


def test_io_roundtrip(tmp_path, rng):
    g = random_graph(rng, 20)
    s, r, w = g.to_coo_numpy()
    p = tmp_path / "g.coolist"
    with open(p, "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{i} {j} {v}\n")
    g2 = gt.read_graph(str(p), "coolist", dtype=jnp.float64)
    np.testing.assert_allclose(g2.to_dense_numpy(), g.to_dense_numpy(),
                               rtol=1e-12)


def test_io_mtx(tmp_path):
    p = tmp_path / "g.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 2\n1 2 1.5\n2 3 2.0\n")
    g = gt.read_mtx(str(p), dtype=jnp.float64)
    np.testing.assert_allclose(
        g.to_dense_numpy(),
        [[0, 1.5, 0], [1.5, 0, 2.0], [0, 2.0, 0]])


def test_io_adjlist_table_csr(tmp_path):
    p = tmp_path / "g.adjlist"
    p.write_text("0 1\n1 2\n")
    g = gt.read_adjlist(str(p), symmetric=True)
    assert g.n == 3 and g.num_edges == 4

    p2 = tmp_path / "g.table"
    p2.write_text("1 2\n0\n0\n")
    g2 = gt.read_table(str(p2))
    assert g2.n == 3 and g2.num_edges == 4

    p3 = tmp_path / "g.csr"
    p3.write_text("2 2 2\n0 1 2\n1 0\n3.0 4.0\n")
    g3 = gt.read_csr(str(p3), dtype=jnp.float64)
    np.testing.assert_allclose(g3.to_dense_numpy(), [[0, 3], [4, 0]])


def test_write_coords_partition(tmp_path):
    gt.write_coords(np.array([[1.0, 2.0], [3.0, 4.0]]), tmp_path / "c.txt")
    rows = (tmp_path / "c.txt").read_text().strip().splitlines()
    assert len(rows) == 2 and rows[0].split()[0] == "1.0"
    gt.write_partition([0, 1, 1], tmp_path / "p.txt")
    assert (tmp_path / "p.txt").read_text().split() == ["0", "1", "1"]


def test_algebra_surface(rng):
    from graph_embed.graph import algebra

    g = random_graph(rng, 20)
    A = g.to_dense_numpy()
    np.testing.assert_allclose(algebra.transpose(g).to_dense_numpy(), A.T,
                               rtol=1e-12)
    np.testing.assert_allclose(algebra.matmul(g, g).to_dense_numpy(), A @ A,
                               rtol=1e-10)
    v = rng.uniform(0.5, 2, 20)
    np.testing.assert_allclose(algebra.scale_rows(g, v).to_dense_numpy(),
                               np.diag(v) @ A, rtol=1e-12)
    np.testing.assert_allclose(algebra.scale_cols(g, v).to_dense_numpy(),
                               A @ np.diag(v), rtol=1e-12)
    x = rng.normal(size=(20, 3))
    np.testing.assert_allclose(np.asarray(algebra.matvec(g, jnp.asarray(x))),
                               A @ x, rtol=1e-10)


def test_edge_cases_small_graphs():
    # single vertex, no edges
    g1 = gt.from_edges([], [], None, n=1, dtype=jnp.float64)
    assert g1.n == 1 and g1.num_edges == 0
    import jax

    c = gt.force_atlas(g1, 2, iterations=3, key=jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(c)).all()
    # two isolated vertices partition to themselves
    g2 = gt.from_edges([], [], None, n=2, dtype=jnp.float64)
    p = gt.partition_single(g2)
    assert p.num_aggs == 2


def test_synth_families():
    from graph_embed.graph import synth

    g = synth.mesh3d(5)
    assert g.n == 125 and g.num_edges == 2 * 300  # 3*L^2*(L-1) grid edges

    g = synth.rmat(8, 4, seed=1, compact=False)
    assert g.n == 256
    g = synth.rmat(8, 4, seed=1)
    assert g.n < 256  # isolated ids dropped (compact default)
    s, r, w = g.to_coo_numpy()
    assert (s != r).all() and np.isfinite(w).all()
    deg = np.bincount(s, minlength=g.n)
    # power-law: max degree far above mean
    assert deg.max() > 4 * deg.mean()
    # deterministic given seed
    g2 = synth.rmat(8, 4, seed=1)
    s2, r2, _ = g2.to_coo_numpy()
    assert np.array_equal(s, s2) and np.array_equal(r, r2)

    g, labels = synth.planted_partition(4, 30, p_in=0.5, p_out=0.01, seed=0)
    assert g.n == 120 and labels.shape == (120,)
    s, r, _ = g.to_coo_numpy()
    intra = (labels[s] == labels[r]).mean()
    assert intra > 0.7  # communities dominate

    g = synth.ring_of_cliques(6, 5)
    assert g.n == 30 and g.num_edges == 2 * (6 * 10 + 6)

    # scale is the TOTAL log2 size (community_rmat(64, 20) must be
    # rmat(20)-comparable, NOT 64x it -- the round-2 127GB regression)
    g = synth.community_rmat(8, 12, 4, seed=1)
    assert g.n == 1 << 12
    assert g.num_edges < 2 * 4 * (1 << 12) * 1.2
    s, r, _ = g.to_coo_numpy()
    intra = ((s // 512) == (r // 512)).mean()
    assert intra > 0.8  # block-diagonal-dominant by construction
    import pytest

    with pytest.raises(ValueError):
        synth.community_rmat(6, 12)
    with pytest.raises(ValueError):
        synth.community_rmat(64, 5)


def test_synth_cached_bit_identical(tmp_path):
    """synth.cached loads the canonical COO via from_canonical_coo --
    graph must be bit-identical to a fresh generation."""
    from graph_embed.graph import synth

    g1 = synth.cached("rmat", 10, 8, seed=3, cache_dir=str(tmp_path))
    g2 = synth.cached("rmat", 10, 8, seed=3, cache_dir=str(tmp_path))
    g3 = synth.rmat(10, 8, seed=3)
    for a, b in zip(g1.to_coo_numpy(), g2.to_coo_numpy()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g1.to_coo_numpy(), g3.to_coo_numpy()):
        np.testing.assert_array_equal(a, b)
    assert g1.n == g3.n and g1.num_edges == g3.num_edges
    assert np.array_equal(np.asarray(g1.indptr), np.asarray(g3.indptr))
    # tuple-returning family round-trips labels too
    gp, lab = synth.cached("planted_partition", 6, 30, seed=1,
                           cache_dir=str(tmp_path))
    gp2, lab2 = synth.cached("planted_partition", 6, 30, seed=1,
                             cache_dir=str(tmp_path))
    np.testing.assert_array_equal(lab, lab2)
    assert gp.num_edges == gp2.num_edges
    with pytest.raises(ValueError):
        synth.cached("nosuch", 1, cache_dir=str(tmp_path))
