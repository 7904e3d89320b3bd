"""Aux subsystems: checkpoint/resume, CLI, viz, harness, native loader."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graph_embed as gt
from conftest import random_graph


def test_checkpoint_resume_matches_fresh(rng, tmp_path):
    from graph_embed.embed.checkpoint import CheckpointStore, embed_resumable

    g = random_graph(rng, 120)
    res = gt.partition_hierarchy(g, 0.25)
    graphs = gt.build_galerkin_chain(g, res.levels)
    key = jax.random.PRNGKey(42)

    fresh = np.asarray(embed_resumable(
        graphs, res.levels, 2, store=CheckpointStore(str(tmp_path / "a")),
        key=key, base_iterations=50, refine_iterations=5))

    # run again into a partially-filled store: simulate interruption by
    # copying only the base level, then resume
    store_b = CheckpointStore(str(tmp_path / "b"))
    k = len(res.levels)
    base = CheckpointStore(str(tmp_path / "a")).load_level(k)
    store_b.save_level(k, **base)
    resumed = np.asarray(embed_resumable(
        graphs, res.levels, 2, store=store_b, key=key,
        base_iterations=50, refine_iterations=5))
    np.testing.assert_allclose(resumed, fresh, rtol=1e-6, atol=1e-8)


def test_cli_embed_end_to_end(tmp_path, rng):
    from graph_embed import cli

    g = random_graph(rng, 80)
    s, r, w = g.to_coo_numpy()
    inp = tmp_path / "g.edges"
    with open(inp, "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{i} {j} {v}\n")
    out = tmp_path / "coords.txt"
    rc = cli.main(["embed", "-f", str(inp), "-format", "coolist",
                   "-o", str(out), "-dimension", "2"])
    assert rc == 0
    coords = np.loadtxt(out)
    assert coords.shape == (80, 2)
    assert np.isfinite(coords).all()


def test_cli_arg_validation(capsys):
    from graph_embed import cli

    assert cli.main(["embed", "-format", "bogus", "-f", "x", "-o", "y"]) == 1
    assert cli.main(["embed", "-o", "y", "-format", "coolist"]) == 1


def test_viz_html(tmp_path, rng):
    from graph_embed import viz

    g = random_graph(rng, 30)
    res = gt.partition_hierarchy(g, 0.3)
    coords = rng.uniform(-1, 1, size=(30, 3))
    s, r, _ = g.to_coo_numpy()
    out = tmp_path / "plot.html"
    viz.write_embedding_html(
        coords, (s, r), out,
        level_assignments=[np.asarray(p.vertex_to_agg) for p in res.levels])
    html = out.read_text()
    assert "<canvas" in html and "const V=" in html

    # scale-run layouts: beyond max_points the plot subsamples vertices
    # (and drops edges whose endpoints left), keeping the hierarchy colors
    out2 = tmp_path / "plot_sub.html"
    viz.write_embedding_html(
        coords, (s, r), out2, max_points=12,
        level_assignments=[np.asarray(p.vertex_to_agg) for p in res.levels])
    import json as _json
    import re

    html2 = out2.read_text()
    verts = _json.loads(re.search(r"const V=(\[.*?\]), E=",
                                  html2).group(1))
    assert len(verts) == 12


def test_harness_run_test(tmp_path, rng):
    from graph_embed.harness.runtests import run_test

    g = random_graph(rng, 60)
    s, r, w = g.to_coo_numpy()
    prefix = tmp_path / "toy"
    with open(str(prefix) + ".edges", "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{i} {j} {v}\n")
    import io

    buf = io.StringIO()
    rec = run_test(str(prefix), "coolist", do_heuristics=True, out=buf)
    assert rec["n"] == 60
    assert "modularity" in rec and "partition_seconds" in rec
    assert "variant_modularity" in rec
    json.loads(buf.getvalue())


def test_pair_counting_similarity():
    from graph_embed.harness.runtests import pair_counting_similarity

    a = np.array([0, 0, 1, 1])
    b = np.array([0, 0, 0, 1])
    out = pair_counting_similarity(a, b)
    # same-pairs: a has (0,1),(2,3); b has (0,1),(0,2),(1,2); both share (0,1)
    assert out["total_pairs_1"] == 2
    assert out["total_pairs_2"] == 3
    assert out["pairs_in_both"] == 1
    assert out["precision"] == pytest.approx(0.5)
    assert out["recall"] == pytest.approx(1 / 3)


def test_louvain_tree_reader(tmp_path):
    from graph_embed.harness.runtests import read_louvain_aggregates

    # two levels: 4 nodes -> 2 comms -> 1 comm
    p = tmp_path / "x.tree"
    p.write_text("0 0\n1 0\n2 1\n3 1\n0 0\n1 0\n")
    v = read_louvain_aggregates(p)
    assert v.tolist() == [0, 0, 0, 0]


def test_native_loader_fallback(tmp_path):
    # io readers must work regardless of native availability
    p = tmp_path / "g.coolist"
    p.write_text("0 1 2.0\n1 2 3.0\n")
    g = gt.read_coolist(str(p), dtype=jnp.float64)
    np.testing.assert_allclose(g.to_dense_numpy(),
                               [[0, 2, 0], [0, 0, 3], [0, 0, 0]])


def test_metrics_logger(tmp_path):
    from graph_embed.utils.timing import MetricsLogger

    path = tmp_path / "m.jsonl"
    ml = MetricsLogger(str(path))
    ml.log(phase="x", level=1)
    ml.close()
    rec = json.loads(path.read_text().strip())
    assert rec["phase"] == "x" and "t" in rec


def test_layout_stress_metric(rng):
    from graph_embed.harness.runtests import layout_stress

    # a perfect unit-length layout has zero stress at optimal scale
    g = gt.from_edges([0, 1, 2, 3], [1, 2, 3, 0], None, n=4, symmetrize=True)
    square = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
    assert layout_stress(g, square) < 1e-12
    # a collapsed layout has infinite stress
    assert layout_stress(g, np.zeros((4, 2))) == float("inf")


def test_run_embed_test(tmp_path, rng):
    from graph_embed.harness.runtests import run_embed_test
    from conftest import random_graph
    import io

    g = random_graph(rng, 60)
    s, r, w = g.to_coo_numpy()
    prefix = tmp_path / "toy"
    with open(str(prefix) + ".edges", "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{i} {j} {v}\n")
    buf = io.StringIO()
    rec = run_embed_test(str(prefix), dim=2, out=buf)
    assert rec["stress"] > 0 and np.isfinite(rec["stress"])
    assert rec["embed_seconds"] > 0


def test_cli_embedder_pipeline(tmp_path, rng):
    """The full embedder batch pipeline (largest component, hierarchy,
    Galerkin, embed, temp dumps, plot) -- examples/embedder.cpp:140-295."""
    from graph_embed import cli
    from conftest import random_graph

    g = random_graph(rng, 70)
    s, r, _ = g.to_coo_numpy()
    inp = tmp_path / "g.adjlist"
    with open(inp, "w") as f:
        for i, j in zip(s, r):
            f.write(f"{i} {j}\n")
    outdir = tmp_path / "out"
    rc = cli.main(["embedder", "-f", str(inp), "-outdir", str(outdir),
                   "-dimension", "2"])
    assert rc == 0
    assert (outdir / "coords.temp").exists()
    assert (outdir / "part.temp").exists()
    assert (outdir / "mat.temp").exists()
    assert (outdir / "plot.html").exists()
    coords = np.loadtxt(outdir / "coords.temp")
    assert coords.shape[1] == 3  # z column padded for 2D (embedder.cpp:271)
    assert np.isfinite(coords).all()


def test_timer_spans():
    from graph_embed.utils.timing import Timer, time_fn
    import jax.numpy as jnp

    t = Timer("x")
    with t():
        pass
    assert len(t.spans) == 1 and t.total >= 0
    med = time_fn(lambda v: v * 2, jnp.ones(8), iters=3, warmup=1)
    assert med >= 0


def test_multilevel_partition_dump_roundtrip(tmp_path, rng):
    """embedder part.temp format round-trip (embedder.cpp:230-267 writer vs
    the viz reader)."""
    from graph_embed.graph.io import write_multilevel_partition
    from graph_embed.viz import _read_multilevel_partition
    from conftest import random_graph

    g = random_graph(rng, 50)
    res = gt.partition_hierarchy(g, 0.3)
    assigns = [np.asarray(p.vertex_to_agg) for p in res.levels]
    p = tmp_path / "part.temp"
    write_multilevel_partition(assigns, p)
    back = _read_multilevel_partition(p)
    assert len(back) == len(assigns)
    for a, b in zip(assigns, back):
        np.testing.assert_array_equal(a, b)


def test_quality_vs_networkx_louvain(rng):
    """Partition quality within tolerance of networkx Louvain (the
    differential-oracle role of run-tests.cpp:204-227) on community-rich
    synthetic graphs."""
    from graph_embed.harness.runtests import louvain_networkx
    import graph_embed as gt

    # planted-partition family: 8 communities of 25, p_in >> p_out
    n, k = 200, 8
    size = n // k
    s_list, r_list = [], []
    for c in range(k):
        off = c * size
        for i in range(size):
            for j in range(i + 1, size):
                if rng.random() < 0.5:
                    s_list.append(off + i)
                    r_list.append(off + j)
    inter = rng.integers(0, n, size=(60, 2))
    for a, b in inter:
        if a != b:
            s_list.append(int(a))
            r_list.append(int(b))
    g = gt.from_edges(s_list, r_list, None, n=n, symmetrize=True,
                      dtype=jnp.float64)

    ours = gt.partition_single(g)
    q_ours = float(gt.modularity(g, ours))
    lv = louvain_networkx(g)
    q_lv = float(gt.modularity(g, gt.partition_from_labels(lv)))
    assert q_ours > 0.5 * q_lv  # same ballpark on an easy family
    assert q_ours > 0.3


def test_harness_synth_roster():
    """synth: specs resolve to generated graphs; planted specs carry their
    ground-truth labels through the pair-counting comparison."""
    import io

    from graph_embed.harness.runtests import run_test

    buf = io.StringIO()
    rec = run_test("synth:planted:6:30:0.5:0.01", out=buf)
    assert rec["n"] == 180
    sim = rec["ground_truth_similarity"]
    assert sim["precision"] > 0.9 and sim["recall"] > 0.9

    rec = run_test("synth:ring:5:8", out=buf)
    assert rec["n"] == 40 and rec["aggregates"] == 5


def test_two_process_distributed_smoke(tmp_path):
    """Two real OS processes bootstrap jax.distributed over a localhost
    coordinator (CPU backend, 2 virtual devices each), assemble edge-sharded
    global arrays via make_array_from_callback and run the sharded FA step;
    the result must match a single-process run on the same 4-device mesh.
    Exercises parallel/multihost.py end to end.  Skipped when the
    coordinator cannot bind or the runtime lacks multi-process CPU
    support."""
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]

    # single-process reference on an IDENTICAL 4-device mesh (1 process x 4
    # virtual devices -- same n_pad/edge split, so results match exactly up
    # to reduction order)
    ref_path = tmp_path / "ref.npz"
    ref_env = dict(env)
    ref_env["DIST_WORKER_DEVICES"] = "4"
    proc = subprocess.run(
        [sys.executable, worker, "0", "1", "0", str(ref_path)],
        env=ref_env, capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(worker))))
    if proc.returncode != 0:
        pytest.skip(f"single-process worker failed: {proc.stderr[-800:]}")
    out_path = tmp_path / "out.npz"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(worker))))
        for pid in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=240)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed workers timed out")
    if any(p.returncode != 0 for p in procs):
        errs = "\n".join(p.stderr.read()[-500:] for p in procs)
        pytest.skip(f"multi-process CPU unsupported here: {errs}")
    assert out_path.exists()
    got = np.load(out_path)["coords"]
    assert np.isfinite(got).all()
    want = np.load(ref_path)["coords"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_process_embed_pipeline(tmp_path):
    """The full PRODUCT pipeline -- partition hierarchy + Galerkin +
    multilevel embed(mesh=...) with the sharded base case and refinement --
    across 2 processes x 4 virtual devices each, vs a single-process run on
    an identical 8-device mesh.  Layouts must match exactly."""
    _run_two_process_pipeline(tmp_path, "replicated")


def test_two_process_embed_pipeline_halo(tmp_path):
    """Same, with sharding='halo': the config-5 flat design (vertex-
    partitioned base case, boundary-only exchange, invariant sampling)
    under jax.distributed -- its DCN story exercised end to end, not just
    on the single-process virtual mesh."""
    _run_two_process_pipeline(tmp_path, "halo")


def _run_two_process_pipeline(tmp_path, sharding):
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__),
                          "_dist_embed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["DIST_WORKER_SHARDING"] = sharding
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]

    ref_path = tmp_path / "ref.npz"
    ref_env = dict(env)
    ref_env["DIST_WORKER_DEVICES"] = "8"
    proc = subprocess.run(
        [sys.executable, worker, "0", "1", "0", str(ref_path)],
        env=ref_env, capture_output=True, text=True, timeout=300,
        cwd=repo_root)
    if proc.returncode != 0:
        pytest.skip(f"single-process worker failed: {proc.stderr[-800:]}")
    out_path = tmp_path / "out.npz"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo_root) for pid in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed workers timed out")
    if any(p.returncode != 0 for p in procs):
        errs = "\n".join(p.stderr.read()[-500:] for p in procs)
        pytest.skip(f"multi-process CPU unsupported here: {errs}")
    got = np.load(out_path)["coords"]
    want = np.load(ref_path)["coords"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["env_dir", "default_dir", "cpu_only",
                                  "disabled"])
def test_compilation_cache_dir(monkeypatch, tmp_path, case):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is configured; otherwise
    one fixed directory in the checkout; CPU-only and disabled processes
    stay uncached."""
    from graph_embed.utils import profiling

    updates = {}
    monkeypatch.setattr(profiling.jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    for var in ("JAX_COMPILATION_CACHE_DIR", "GRAPH_EMBED_NO_CACHE",
                "JAX_PLATFORMS"):
        monkeypatch.delenv(var, raising=False)
    fixed = str(tmp_path / "fixed")
    monkeypatch.setattr(profiling, "DEFAULT_CACHE_DIR", fixed)
    if case == "env_dir":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        assert profiling.enable_compilation_cache() == str(tmp_path / "env")
        assert updates == {}
    elif case == "default_dir":
        assert profiling.enable_compilation_cache() == fixed
        assert updates == {"jax_compilation_cache_dir": fixed}
        assert os.path.isdir(fixed)
    elif case == "cpu_only":
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert profiling.enable_compilation_cache() == ""
        assert updates == {}
    else:
        monkeypatch.setenv("GRAPH_EMBED_NO_CACHE", "1")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        assert profiling.enable_compilation_cache() == ""
        assert updates == {}


def test_default_cache_dir_is_in_checkout():
    from graph_embed.utils import profiling

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert profiling.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")


def test_chip_smoke_refuses_without_gpu(capsys):
    """On a CPU backend chip_smoke exits non-zero and prints no result."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_refuses_outside_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
