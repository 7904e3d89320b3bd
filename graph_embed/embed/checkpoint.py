"""Checkpoint / resume for the multilevel embedding.

The reference has no checkpointing (SURVEY.md SS5); its nearest analogue is
the warm-start coords path (forceatlas.hpp:118-125, embed.cpp:363-371).
Here the multilevel recursion is checkpointed at its natural level
boundaries: after each level's refinement, (level index, coords, radii,
parent coords/radii, RNG key) are saved; ``embed_resumable`` restarts from
the last completed level.

Format: plain ``.npz`` per level plus a tiny JSON manifest -- no orbax
dependency needed for arrays this shape (coords are [n, d]); everything is
host numpy at the boundary, which also keeps checkpoints portable across
backends.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..graph.csr import Graph
from ..partition.interpolation import Partition


class CheckpointStore:
    """Directory-backed store: one .npz per completed level + manifest."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._manifest = os.path.join(path, "manifest.json")

    def save_level(self, level: int, **arrays):
        np.savez(os.path.join(self.path, f"level_{level}.npz"),
                 **{k: np.asarray(v) for k, v in arrays.items() if v is not None})
        state = self.read_manifest()
        state["completed"] = sorted(set(state.get("completed", []) + [level]))
        with open(self._manifest, "w") as f:
            json.dump(state, f)

    def load_level(self, level: int):
        p = os.path.join(self.path, f"level_{level}.npz")
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def read_manifest(self):
        if os.path.exists(self._manifest):
            with open(self._manifest) as f:
                return json.load(f)
        return {}

    def last_completed(self, k: int):
        """Smallest completed level index given levels run k, k-1, ..., 0
        (coarse to fine); returns None if nothing usable."""
        done = set(self.read_manifest().get("completed", []))
        # find the deepest prefix k, k-1, ... that is contiguous in `done`
        last = None
        for lvl in range(k, -1, -1):
            if lvl in done:
                last = lvl
            else:
                break
        return last


def embed_resumable(graphs: list[Graph], parts: list[Partition], dim: int = 3,
                    *, store: CheckpointStore, key=None, **embed_kw):
    """Checkpointable multilevel embed: ``driver.embed`` with a store hook.

    One recursion serves both paths (a separate copy would drift: lose the
    refinement route, metrics, final_block or warm start under resume).  All ``embed`` keywords -- refine_backend, metrics,
    final_block, coords0, mesh, ... -- work identically under resume."""
    from .driver import embed

    return embed(graphs, parts, dim, key=key, store=store, **embed_kw)
