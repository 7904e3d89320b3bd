"""Force terms of the ForceAtlas2 iteration, as pure array functions.

Array formulation of the per-vertex force loop of forceatlas.hpp:146-211.
Semantics notes (all verified against the code, not the header comments --
SURVEY.md SS7 #6):

* repulsion is (deg_i+1)(deg_j+1) * repel / d^2 along (x_i - x_j)/d
  (forceatlas.hpp:158; the header comment at :37 says k/d -- the code wins);
* distances are clamped below at epsilon = 1e-5 (:110,155-157);
* attraction per stored CSR entry (i, j): fa = d; linlog -> log(1+fa);
  weight handling depends on delta exactly as :187-191 (delta == 0 leaves fa
  unweighted); nohubs divides by deg_i + 1; force along (x_j - x_i)/d;
* gravity pulls toward the origin with magnitude gravity * (deg_i + 1)
  (:205-211); the division by |x_i| is unclamped in the flat reference --
  here it is guarded against exact zero only (TINY), which differs from the
  C++ only where the C++ would produce inf/nan.

Three interchangeable repulsion implementations (ForceAtlasParams.repulsion):
'exact' (per-pair differences, O(n^2 d) memory, oracle-exact), 'gram' (two
matmuls via the gram-matrix identity, row-blocked to bound memory), and
'sampled' (unbiased negative-sampling estimator in diff form, O(n s)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TINY = 1e-30


def _safe_norm(x, axis=-1):
    """Euclidean norm, safe gradient/value at 0 (returns 0)."""
    return jnp.sqrt(jnp.sum(x * x, axis=axis))


def repulsion_exact(coords, deg_p1, repel, eps):
    """O(n^2 d)-memory reference semantics: per-pair coordinate differences.

    F_i = (deg_i+1) * repel * sum_{j != i} (deg_j+1) (x_i - x_j) / d_ij^3,
    d_ij = max(|x_i - x_j|, eps)   (forceatlas.hpp:151-167).
    """
    n = coords.shape[0]
    diff = coords[:, None, :] - coords[None, :, :]            # [n, n, d]
    dist = jnp.maximum(_safe_norm(diff), eps)                 # [n, n]
    w = deg_p1[None, :] / (dist * dist * dist)                # [n, n]
    w = jnp.where(jnp.eye(n, dtype=bool), 0.0, w)
    return (repel * deg_p1)[:, None] * jnp.einsum(
        "ijk,ij->ik", diff, w, precision=jax.lax.Precision.HIGHEST)


def _repulsion_gram_block(x_blk, deg_blk, coords, deg_p1, row0, repel, eps):
    """One row-block of the gram-matrix repulsion."""
    n = coords.shape[0]
    b = x_blk.shape[0]
    sq_blk = jnp.sum(x_blk * x_blk, axis=1)
    sq_all = jnp.sum(coords * coords, axis=1)
    # HIGHEST: the gram identity cancels catastrophically; reduced-precision
    # dots (bf16, TF32) make near pairs (d ~ 0.03 at |x| ~ 1) collapse to
    # the eps clamp -> 1e15 force spikes (x64 tests mask it)
    d2 = sq_blk[:, None] + sq_all[None, :] - 2.0 * jnp.matmul(
        x_blk, coords.T, precision=jax.lax.Precision.HIGHEST)  # [b, n]
    dist = jnp.maximum(jnp.sqrt(jnp.maximum(d2, 0.0)), eps)
    w = deg_p1[None, :] / (dist * dist * dist)
    rows = row0 + jnp.arange(b)
    self_mask = rows[:, None] == jnp.arange(n)[None, :]
    w = jnp.where(self_mask, 0.0, w)
    # sum_j w_ij (x_i - x_j) = x_i * rowsum(w) - w @ x.  HIGHEST again:
    # the two terms cancel to ~w*d for near pairs, so bf16 rounding of
    # either matmul input turns into an O(w * 0.4% * |x|) force error
    f = x_blk * jnp.sum(w, axis=1, keepdims=True) - jnp.matmul(
        w, coords, precision=jax.lax.Precision.HIGHEST)
    return (repel * deg_blk)[:, None] * f


def repulsion_gram(coords, deg_p1, repel, eps, *, block: int = 1024):
    """Matmul repulsion: |xi-xj|^2 via gram matrix, scanned over row blocks.

    Numerically equal to 'exact' within cancellation error of the gram
    identity (~sqrt(ulp)*|x|^2); use 'exact' for bitwise parity tests.
    """
    n, d = coords.shape
    if n <= block:
        return _repulsion_gram_block(coords, deg_p1, coords, deg_p1, 0,
                                     repel, eps)
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.pad(coords, ((0, pad), (0, 0)))
    dp = jnp.pad(deg_p1, (0, pad))
    xb = xp.reshape(nb, block, d)
    db = dp.reshape(nb, block)

    def body(carry, inp):
        x_blk, deg_blk, i = inp
        f = _repulsion_gram_block(x_blk, deg_blk, coords, deg_p1,
                                  i * block, repel, eps)
        return carry, f

    _, fb = jax.lax.scan(body, None, (xb, db, jnp.arange(nb)))
    return fb.reshape(nb * block, d)[:n]


def sampled_repulsion_sum(xT, rows, xsT, ws, sample_rows, eps):
    """sum_j ws_j (x_i - xs_j) / max(|x_i - xs_j|, eps)^3 over a sample set,
    with pairs where ``rows[i] == sample_rows[j]`` (self pairs) masked.

    xT: [dim, b] points, xsT: [dim, s] samples, ws: [s] sample weights.
    Returns [dim, b].  Diff form: distances come from coordinate
    differences, not the gram identity |x|^2 + |y|^2 - 2 x.y, which cancels
    catastrophically for near pairs and needs full-f32 matmuls; here every
    op is elementwise or a minor-axis reduction that XLA fuses into one
    pass over the [b, s] interaction."""
    diff = xT[:, :, None] - xsT[:, None, :]                   # [dim, b, s]
    dist = jnp.maximum(jnp.sqrt(jnp.sum(diff * diff, axis=0)), eps)
    w = ws[None, :] / (dist * dist * dist)                    # [b, s]
    w = jnp.where(rows[:, None] == sample_rows[None, :], 0.0, w)
    # the barrier keeps XLA from fusing this reduction with row-major
    # [b, 3] consumers into one block-level GPU kernel: at mesh3d(128) size
    # (b = 2.1M) that kernel's [256, 4, 64] f32 tile asked for 256 KB of
    # shared memory, past the 227 KB an H100 block may use, and the whole
    # flat step failed to compile
    return jax.lax.optimization_barrier(jnp.sum(w[None] * diff, axis=-1))


def repulsion_sampled_T(xT, deg_p1, key, *, n: int, num_samples: int,
                        repel: float, eps: float, dim: int):
    """Unbiased negative-sampling estimator of the exact repulsion sum on
    the transposed layout: xT [d_pad, n_pad] (rows dim.. zero), deg_p1
    [n_pad].  Samples ``s`` vertices uniformly with replacement from the
    first ``n`` (shared across all i -- one [n_pad, s] interaction);
    self-pairs masked; scaled by n/s:
    E[(n/s) sum_samples f_ij 1[j!=i]] = sum_{j != i} f_ij.
    Returns [d_pad, n_pad] (rows dim.. zero)."""
    s = num_samples
    idx = jax.random.randint(key, (s,), 0, n)
    x = xT[:dim]
    f = sampled_repulsion_sum(x, jnp.arange(x.shape[1]), x[:, idx],
                              deg_p1[idx], idx, eps)
    f = (repel * n / s) * deg_p1[None, :] * f
    return jnp.pad(f, ((0, xT.shape[0] - dim), (0, 0)))


def repulsion_sampled(coords, deg_p1, repel, eps, key, num_samples: int):
    """``repulsion_sampled_T`` on row-major [n, d] coordinates (same key =>
    same samples => same value)."""
    n, d = coords.shape
    return repulsion_sampled_T(coords.T, deg_p1, key, n=n,
                               num_samples=num_samples, repel=repel,
                               eps=eps, dim=d).T


def attraction_fa(dist, weights, deg_p1_s, *, linlog: bool, delta: float,
                  nohubs: bool, use_weights: bool):
    """Scalar attraction magnitude fa_ij per stored entry
    (forceatlas.hpp:176-196).  ``delta`` is a static Python float so the
    three reference branches compile away."""
    fa = dist
    if linlog:
        fa = jnp.log1p(fa)
    a = weights if use_weights else jnp.ones_like(weights)
    if delta == 1.0:
        fa = fa * a
    elif delta != 0.0:
        fa = jnp.sign(a) * jnp.abs(a) ** delta * fa
    if nohubs:
        fa = fa / deg_p1_s
    return fa


def attraction_csr(coords, senders, receivers, weights, deg_p1, num_edges,
                   *, attract, eps, linlog: bool, delta: float, nohubs: bool,
                   use_weights: bool):
    """Edge-gather attraction, the SpMM-shaped term (forceatlas.hpp:169-203).

    Padded edges (sender == n) are routed to a ghost segment and dropped.
    Self-loops contribute zero force exactly as in the reference (direction
    (x_i - x_i)/eps = 0).
    """
    n = coords.shape[0]
    sc = jnp.clip(senders, 0, n - 1)
    rc = jnp.clip(receivers, 0, n - 1)
    xs, xr = coords[sc], coords[rc]
    diff = xr - xs
    dist = jnp.maximum(_safe_norm(diff), eps)
    fa = attraction_fa(dist, weights, deg_p1[sc], linlog=linlog, delta=delta,
                       nohubs=nohubs, use_weights=use_weights)
    per_edge = diff * (attract * fa / dist)[:, None]
    seg = jnp.where(senders < n, senders, n)
    return jax.ops.segment_sum(per_edge, seg, num_segments=n + 1)[:n]


def gravity_force(coords, deg_p1, gravity, *, clamp_eps: float | None = None):
    """F_g = -(x_i/|x_i|) * gravity * (deg_i+1)  (forceatlas.hpp:205-211).

    The flat reference divides by the unclamped magnitude; the multilevel one
    clamps at epsilon (forceatlas.hpp:411-414).  ``clamp_eps=None`` guards
    exact zero only."""
    mag = _safe_norm(coords)
    mag = jnp.maximum(mag, TINY if clamp_eps is None else clamp_eps)
    return -(coords / mag[:, None]) * (gravity * deg_p1)[:, None]


def speed_update(coords, forces, forces_prev, deg_p1, *, ks, ksmax, tolerate,
                 swing_clamp_eps: float | None = None):
    """Adaptive-speed displacement (forceatlas.hpp:214-261).

    The global swing/traction sums are computed then overwritten with 1.0 in
    the reference (:228,:242) -- so globalSpeed == tolerate; that behavior is
    reproduced (we skip computing the dead values entirely).
    swing_i = |F - F_prev| (clamped at eps only in the multilevel variant,
    :484); speed_i = min(ks*gS/(1+gS*sqrt(swing_i)), ksmax/|F_i|).
    """
    swing = _safe_norm(forces - forces_prev)
    if swing_clamp_eps is not None:
        swing = jnp.maximum(swing, swing_clamp_eps)
    global_speed = tolerate
    speed = ks * global_speed / (1.0 + global_speed * jnp.sqrt(swing))
    total_f = _safe_norm(forces)
    constraint = jnp.where(total_f > 0, ksmax / jnp.maximum(total_f, TINY),
                           jnp.inf)
    speed = jnp.minimum(speed, constraint)
    return coords + forces * speed[:, None]


def normalize_coords(coords, *, max_clamp_eps: float | None = None):
    """Center at the mean and scale to the unit ball
    (forceatlas.hpp:272-303; the multilevel epilogue clamps max at eps,
    :562-564)."""
    centered = coords - jnp.mean(coords, axis=0, keepdims=True)
    max_len = jnp.max(_safe_norm(centered))
    if max_clamp_eps is not None:
        max_len = jnp.maximum(max_len, max_clamp_eps)
    else:
        max_len = jnp.maximum(max_len, TINY)
    return centered / max_len
