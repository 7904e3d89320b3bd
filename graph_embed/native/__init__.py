"""Native (C++) host backends: lazy g++ builds + ctypes bindings.

Each backend compiles its .cpp lazily on first use and falls back to the
pure-Python/numpy implementation if the toolchain is unavailable.  Builds
go through :func:`build_shared` so concurrent processes (parallel pytest,
the two-process distributed tests) never race on a half-written .so:
g++ writes to a per-pid temp path and ``os.replace`` publishes it
atomically.
"""

from __future__ import annotations

import os
import subprocess


def build_shared(src: str, so: str, extra_flags: tuple = ()) -> str:
    """Compile ``src`` into shared library ``so`` atomically.

    Skips the build when ``so`` is newer than ``src``.  The compiler
    writes to ``so + .tmp.<pid>``; ``os.replace`` then swaps it in, so a
    concurrent process either sees the old complete file or the new
    complete file, never a torn write (two g++ invocations racing on the
    same output path).
    """
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           *extra_flags, src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return so
