"""Config dataclasses -- the one config surface of the framework.

The reference spreads configuration over function-default parameters
(partitioner.hpp:40-53, forceatlas.hpp:92-103,320-331), hand-rolled argv
parsing (examples/embed.cpp:47-67) and compile-time consts.  Here it is two
dataclasses mirrored 1:1 from the reference defaults (SURVEY.md SS5
config/flag-system row).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ForceAtlasParams:
    """ForceAtlas2 knobs, defaults per forceatlas.hpp:92-103.

    ``repulsion`` selects the repulsion term implementation:
      'exact'   per-pair coordinate differences (reference semantics bitwise
                up to sum order; O(n^2 d) memory) -- parity/testing
      'gram'    matmul formulation |xi-xj|^2 = |xi|^2+|xj|^2-2 xi.xj at
                full f32 precision -- the dense path (numerically equal
                within ~1e-6 rel)
      'sampled' negative-sampling estimate for large graphs (SURVEY.md SS7
                layer 3); scaled to be an unbiased estimator of the exact sum

    ``iterations`` keeps the reference's flat default (forceatlas.hpp:92)
    for direct force_atlas() calls; the multilevel embed() driver resolves
    base_iterations=None to the size-aware
    embed.driver.default_base_iterations(n) = min(iterations,
    max(10k, 12n)) instead -- at pipeline scale the flat 100k is almost all
    converged-already iterations (a 1,630-vertex coarsest level showed no
    visible layout change past ~20k iterations).
    """

    iterations: int = 100_000
    ks: float = 0.1
    ksmax: float = 1.0
    repel: float = 1.0
    attract: float = 1.0
    gravity: float = 1.0
    use_weights: bool = True
    linlog: bool = False
    nohubs: bool = False
    delta: float = 1.0
    tolerate: float = 1.0
    normalize: bool = False
    repulsion: str = "gram"
    num_negative_samples: int = 256
    epsilon: float = 1e-5  # the distance clamp of forceatlas.hpp:110


@dataclasses.dataclass(frozen=True)
class MultilevelFAParams(ForceAtlasParams):
    """forceAtlasMultilevel knobs (forceatlas.hpp:320-331).  Default
    iterations=10 per the header; the embed driver calls it with 100
    (src/embed.cpp:793)."""

    iterations: int = 10
    pull: float = 100.0  # constant cut-edge pull (forceatlas.hpp:453)
    # aggregates whose slot size-class reaches this many slots use the
    # sampled (negative-sampling) within-aggregate repulsion estimator --
    # num_negative_samples partners per member -- instead of the exact
    # O(S^2) gram.  Snowballed aggregates (bench-mesh level 1: 4k+ members)
    # otherwise dominate the whole multilevel embed; the reference's exact
    # per-aggregate loop (forceatlas.hpp:394-410) has the same blowup.
    # 0 disables (always exact).
    sampled_slots_threshold: int = 2048


@dataclasses.dataclass(frozen=True)
class PartitionParams:
    """Coarsener knobs, defaults per partitioner.hpp:40-53."""

    printing: bool = False
    positive_merging: bool = True
    stall_stop_threshold: float = 1.0
    matching_iterations: int = 2
    merge_leaves: bool = False
    # deterministic +-jitter on edge weights to break argmax ties; uniform
    # unweighted graphs otherwise snowball one aggregate through the
    # smallest-index tie-break (the reference ships the same knob as optional
    # +-eps reweighting, run-tests.cpp:162-181 / embedder.cpp:160-178)
    weight_jitter: float = 0.0
    # argmax tie-break among equal-gain partners: "hash" = salted symmetric
    # pair hash (deterministic random-edge matching; uniform-weight graphs
    # coarsen in ~5x fewer rounds and avoid the index-rule snowballing),
    # "index" = smallest partner id (the pre-hash behavior)
    tie_break: str = "hash"
    # size-penalized matching (0 = off): exclude merges whose member count
    # would exceed this cap.  Counted per level -- each snapshot's aggregates
    # restart at size 1 -- so a cap of ~4/coarseningFactor bounds imbalance
    # without stalling coarsening.  An extension over the reference (its
    # greedy matcher has the same snowballing degeneracy, mitigated only by
    # the optional +-eps reweighting, run-tests.cpp:162-181)
    max_agg_size: int = 0
    # unit of the max_agg_size cap: "level" (default -- each snapshot's
    # aggregates restart at size 1, the imbalance-bounding mode above) or
    # "original" -- sizes accumulate across levels, so the cap bounds the
    # aggregate's ORIGINAL-vertex mass (coarsening then STOPS at the cap
    # scale: the community-recovery mode, where aggregates must never
    # outgrow the expected community size; see scripts/planted_precision.py)
    cap_unit: str = "level"
    # star-absorption trigger (hierarchy path only; 0 disables): when a
    # mutual round merges less than this fraction of live vertices, run an
    # absorb round -- every vertex merges into its best partner unless it
    # receives a merge itself, so hubs contract their stars in one round.
    # Power-law graphs (RMAT/social/web) otherwise serialize at one merge
    # per hub per round and the hierarchy both crawls and truncates; mesh
    # families never trip the trigger (mutual rounds merge 30-45%).
    absorb_below: float = 0.05
    # hierarchy depth floor (hierarchy path only; 0 disables): when positive
    # merging stalls with more than this many live vertices, drop the
    # DeltaQ > 0 constraint and keep coarsening.  A modularity optimum is a
    # fine place for *community detection* to stop, but an embedding
    # hierarchy needs to reach a small coarsest level regardless (on RMAT
    # graphs Q maxes out at ~40% of the vertices and the multilevel embed
    # would face an O(n^2)-repulsion base case).  Running Q then decreases
    # by construction; community-quality callers (partition_base & friends)
    # are unaffected (no coarsening factor -> no relaxation).
    force_coarsen_to: int = 64
