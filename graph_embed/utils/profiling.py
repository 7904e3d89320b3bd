"""Profiler integration.

Replaces the reference's ANSI Timer prints (SURVEY.md SS5 tracing row) with
``jax.profiler`` traces plus the per-phase JSONL spans of utils.timing.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a jax.profiler trace for the enclosed block (view with
    TensorBoard / xprof).  No-op when logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Named region inside a trace (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def edges_per_second(num_edges: int, iterations: int, seconds: float) -> float:
    """The north-star metric (BASELINE.md): stored entries traversed/s."""
    return num_edges * iterations / seconds


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory
    ("" when off).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is configured here.  Otherwise the cache goes to
    one fixed directory inside the checkout, ``<repo>/.jax_cache`` (the
    path is part of what makes a later process hit it).  CPU-only
    processes (tests, dry runs) stay uncached: their compiles are cheap,
    and XLA:CPU executables are specific to the machine that built them.
    ``GRAPH_EMBED_NO_CACHE=1`` disables the cache."""
    if os.environ.get("GRAPH_EMBED_NO_CACHE"):
        return ""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        return ""
    path = DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")
