// Native (host C++) modularity coarsener.
//
// Role: the host-runtime twin of the device coarsener
// (graph_embed/partition/coarsen.py).  The reference's partitioner is its
// largest C++ component (src/partitioner.cpp:1550-1893 hierarchy overload;
// :970-1266 single-level; :116-433 partitionTest's mutual-best rule); the
// device path re-designs it as jitted array programs, but for host-resident
// graphs the XLA compile cost of the per-capacity-class round program
// dominates wall-clock (measured: ~95% of a 262k-vertex mesh partition was
// compiles).  This file implements the SAME order-independent algorithm --
// per-edge gain eta = 2(w/T - alpha_i alpha_j) (partitioner.cpp:1715),
// salted-hash tie-break, mutual-best commit (partitionTest :252), union +
// relabel + dedup contraction, snapshot per coarsening-factor crossing
// (:1797-1815) -- over flat sorted edge arrays, so the two backends produce
// identical hierarchies (tested) and callers pick by data residency.
//
// Exposed over a C ABI and bound with ctypes (no pybind11 in the image).

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

typedef int32_t i32;
typedef int64_t i64;
typedef uint32_t u32;
typedef uint8_t u8;

// Mirrors partition/coarsen.py::_edge_hash exactly (int32/uint32 wraparound
// semantics): deterministic symmetric per-undirected-edge priority.
inline i32 pair_hash(i32 s, i32 r, i32 salt) {
  u32 lo = static_cast<u32>(s < r ? s : r);
  u32 hi = static_cast<u32>(s < r ? r : s);
  u32 h = lo * 2654435761u ^ (hi * 40503u + 0x9E3779B9u);
  h ^= static_cast<u32>(salt) * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return static_cast<i32>(h >> 1);
}

// Mirrors coarsen.py::init_state's weight_jitter hash (float32 u in [-1, 1)).
inline float jitter_u(i32 s, i32 r) {
  u32 lo = static_cast<u32>(s < r ? s : r);
  u32 hi = static_cast<u32>(s < r ? r : s);
  u32 h = lo * 2654435761u ^ (hi * 40503u + 0x9E3779B9u);
  return static_cast<float>(h >> 8) / static_cast<float>(1 << 24) * 2.0f - 1.0f;
}

// Pairwise (tree) summation in T precision -- closer to XLA's reduction
// order than a sequential loop, and exact for unit weights either way.
template <typename T>
T pairwise_sum(const T* x, i64 n) {
  if (n <= 8) {
    T s = 0;
    for (i64 i = 0; i < n; ++i) s += x[i];
    return s;
  }
  i64 h = n / 2;
  return pairwise_sum(x, h) + pairwise_sum(x + h, n - h);
}

template <typename T>
struct Coarsener {
  i64 n = 0;
  // live edge list, both directions stored, self-loops removed, sorted by
  // (s, r) (the flat-array contraction state of coarsen.py::CoarsenState)
  std::vector<i32> es, er;
  std::vector<T> ew;
  std::vector<T> alpha;        // row sums / T (partitioner.cpp:1594)
  std::vector<u8> live;
  std::vector<i32> label;      // union-find parent (id[], :1620)
  std::vector<i32> size;       // member count per representative
  i64 cap = 0;                 // max_agg_size matching cap (0 = off)
  bool cap_orig = false;       // cap counts original vertices (no reset)
  T Tsum = 0;
  double Q = 0.0;
  i64 m = 0;                   // live vertex count

  // scratch reused across rounds
  std::vector<i64> indptr;     // per-vertex edge segment starts
  std::vector<u8> notouch;
  std::vector<i32> partner;
  std::vector<T> best_eta;
  std::vector<i32> match_to;
  // sort/dedup scratch: allocated once at the first (largest) round --
  // per-round vector churn (3 x 131M x 4B mmap/munmap at rmat23) was a
  // measurable slice of the partition wall
  std::vector<i32> t_s, t_r, c_s, c_r;
  std::vector<T> t_w, c_w;

  // phase profile (GE_COARSEN_PROF=1): seconds in the radix sort, the
  // dedup compact, the best-partner scans, and everything else
  double t_sort = 0, t_dedup = 0, t_scan = 0, t_relabel = 0;
  static double now() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
  }

  // results
  std::vector<std::vector<i32>> levels;
  std::vector<i64> level_sizes;
  // optional per-snapshot coarse graphs (the Galerkin P^T A P chain,
  // examples/embed.cpp:95-98 role): the contraction state at snapshot time
  // IS the coarse adjacency; emitting it makes build_galerkin_chain's
  // per-level relabel+radix-dedup (~115s at rmat23) redundant.  diag[v]
  // accumulates merged-pair / self-loop weight -- the P^T A P diagonal.
  bool emit_graphs = false;
  std::vector<T> diag;
  std::vector<std::vector<i32>> g_s, g_r;
  std::vector<std::vector<double>> g_w;

  void init(i64 n_, const i32* s, const i32* r, const T* w, i64 e,
            double weight_jitter) {
    n = n_;
    std::vector<T> wj(w, w + e);
    if (weight_jitter > 0.0) {
      for (i64 k = 0; k < e; ++k)
        wj[k] = wj[k] * static_cast<T>(1.0 + weight_jitter * jitter_u(s[k], r[k]));
    }
    Tsum = pairwise_sum(wj.data(), e);
    alpha.assign(n, T(0));
    diag.assign(n, T(0));
    T d_sum = 0;
    i64 kept = 0;
    for (i64 k = 0; k < e; ++k) {
      alpha[s[k]] += wj[k];
      if (s[k] == r[k]) { d_sum += wj[k]; diag[s[k]] += wj[k]; }
      else ++kept;
    }
    for (i64 v = 0; v < n; ++v) alpha[v] /= Tsum;
    es.reserve(kept); er.reserve(kept); ew.reserve(kept);
    for (i64 k = 0; k < e; ++k) {
      if (s[k] != r[k] && wj[k] != T(0)) {
        es.push_back(s[k]); er.push_back(r[k]); ew.push_back(wj[k]);
      }
    }
    sort_dedup();
    live.assign(n, 1);
    size.assign(n, 1);
    label.resize(n);
    for (i64 v = 0; v < n; ++v) label[v] = static_cast<i32>(v);
    double a2 = 0.0;
    for (i64 v = 0; v < n; ++v) a2 += double(alpha[v]) * double(alpha[v]);
    Q = double(d_sum) / double(Tsum) - a2;
    m = n;
  }

  // stable sort by (s, r) + sum duplicate (s, r) runs, dropping self-loops
  // and zero slots (coarsen.py::_dedup_edges); rebuilds indptr.
  void sort_dedup() {
    const i64 e = static_cast<i64>(es.size());
    double tt = now();
    // Stable two-pass counting sort on (sender, receiver): the final order
    // equals the former stable_sort-by-(s, r) INCLUDING ties (counting
    // sort is stable, so equal (a, b) keep ascending former order and the
    // dedup below accumulates duplicates in the same sequence --
    // hierarchies stay bit-identical, tested), at O(E + n) streaming
    // passes instead of O(E log E) indirect comparisons (the contraction's
    // hot term at 65M-edge rounds).
    {
      // 11-bit digits keep the scatter buckets cache-resident (2048 slots
      // -- the native/pack.cpp recipe; a single n-bucket counting pass
      // measured SLOWER than the old stable_sort at n=2M from scatter
      // thrash).  Stable LSD by receiver digits then sender digits ==
      // stable order by (sender, receiver).
      constexpr int DB = 11;
      constexpr i64 B = i64(1) << DB;
      int bits = 0;
      while ((i64(1) << bits) < static_cast<i64>(n)) ++bits;
      t_s.resize(e); t_r.resize(e); t_w.resize(e);
      auto &ts = t_s, &tr = t_r;
      auto &tw = t_w;
      // two-thread stable radix pass (the host has 2 cores): each half
      // counts its own digit histogram; the scatter offsets interleave
      // half 0's run before half 1's per digit, so the combined order is
      // exactly the single-thread stable pass (bit-identical hierarchies,
      // tested).  Small rounds fall back to the single-thread loop.
      std::vector<i64> cnt0(B), cnt1(B), off0(B), off1(B);
      i32 *sa = es.data(), *sb = er.data(), *da = ts.data(), *db = tr.data();
      T *sw = ew.data(), *dw = tw.data();
      const bool par = e >= (i64(1) << 20);
      auto pass = [&](const i32* key, int shift) {
        const i64 mid = par ? e / 2 : e;
        auto count_half = [&](i64 lo, i64 hi, std::vector<i64>& cnt) {
          std::fill(cnt.begin(), cnt.end(), 0);
          for (i64 k = lo; k < hi; ++k) ++cnt[(key[k] >> shift) & (B - 1)];
        };
        if (par) {
          std::thread t([&]() { count_half(mid, e, cnt1); });
          count_half(0, mid, cnt0);
          t.join();
        } else {
          count_half(0, mid, cnt0);
          std::fill(cnt1.begin(), cnt1.end(), 0);
        }
        i64 run = 0;
        for (i64 d = 0; d < B; ++d) {
          off0[d] = run;
          off1[d] = run + cnt0[d];
          run += cnt0[d] + cnt1[d];
        }
        auto scatter_half = [&](i64 lo, i64 hi, std::vector<i64>& off) {
          for (i64 k = lo; k < hi; ++k) {
            const i64 p = off[(key[k] >> shift) & (B - 1)]++;
            da[p] = sa[k]; db[p] = sb[k]; dw[p] = sw[k];
          }
        };
        if (par) {
          std::thread t([&]() { scatter_half(mid, e, off1); });
          scatter_half(0, mid, off0);
          t.join();
        } else {
          scatter_half(0, mid, off0);
        }
        std::swap(sa, da); std::swap(sb, db); std::swap(sw, dw);
      };
      for (int sh = 0; sh < bits; sh += DB) pass(sb, sh);  // by receiver
      for (int sh = 0; sh < bits; sh += DB) pass(sa, sh);  // by sender
      if (sa != es.data()) {                // result landed in the temps
        std::copy(sa, sa + e, es.data());
        std::copy(sb, sb + e, er.data());
        std::copy(sw, sw + e, ew.data());
      }
    }
    t_sort += now() - tt; tt = now();
    // two-thread dedup compact: split at a (s, r)-run boundary so each
    // half's duplicate runs are self-contained; the halves compact into
    // private buffers accumulated in the SAME ascending order as the
    // single-thread scan (bit-identical sums), then concatenate.
    // raw-cursor compact (the push_back version measured 28s of an 83s
    // rmat22 partition -- per-element size checks and branchy appends):
    // write in place into preallocated buffers with a running (pa, pb)
    // duplicate key, same ascending accumulate order (bit-identical).
    auto compact = [&](i64 lo, i64 hi, i32* ns, i32* nr, T* nw) -> i64 {
      i64 w_ = 0;
      i32 pa = -1, pb = -1;
      for (i64 k = lo; k < hi; ++k) {
        const i32 a = es[k], b = er[k];
        const T w = ew[k];
        if (a == b) {
          diag[a] += w;                       // P^T A P diagonal
          continue;                           // cannot split an (a,b) run
        }
        if (w == T(0)) continue;  // run key (pa,pb) stays = last WRITTEN

        if (a == pa && b == pb) {
          nw[w_ - 1] += w;  // ascending former order = segment_sum order
        } else {
          ns[w_] = a; nr[w_] = b; nw[w_] = w;
          ++w_; pa = a; pb = b;
        }
      }
      return w_;
    };
    i64 cut = e / 2;
    while (cut > 0 && cut < e && es[cut] == es[cut - 1] &&
           er[cut] == er[cut - 1])
      ++cut;
    c_s.resize(e); c_r.resize(e); c_w.resize(e);
    auto &ns = c_s, &nr = c_r;
    auto &nw = c_w;
    i64 total;
    if (e >= (i64(1) << 20) && cut > 0 && cut < e) {
      // the cut never splits an equal-(s, r) run, so each half's duplicate
      // runs (and any (v, v) self-loop run feeding diag) live entirely in
      // one half -- the concurrent diag writes touch disjoint vertices.
      // Half 2 writes at offset `cut` (its worst case), then is packed
      // down against half 1's end.
      i64 w2 = 0;
      std::thread t([&]() {
        w2 = compact(cut, e, ns.data() + cut, nr.data() + cut,
                     nw.data() + cut);
      });
      const i64 w1 = compact(0, cut, ns.data(), nr.data(), nw.data());
      t.join();
      if (w1 != cut) {
        std::memmove(ns.data() + w1, ns.data() + cut, w2 * sizeof(i32));
        std::memmove(nr.data() + w1, nr.data() + cut, w2 * sizeof(i32));
        std::memmove(nw.data() + w1, nw.data() + cut, w2 * sizeof(T));
      }
      total = w1 + w2;
    } else {
      total = compact(0, e, ns.data(), nr.data(), nw.data());
    }
    ns.resize(total); nr.resize(total); nw.resize(total);
    es.swap(ns); er.swap(nr); ew.swap(nw);  // old buffers become scratch
    indptr.assign(n + 1, 0);
    for (i64 k = 0; k < static_cast<i64>(es.size()); ++k) indptr[es[k] + 1]++;
    for (i64 v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
    t_dedup += now() - tt;
  }

  // One matching pass (coarsen.py::_match_pass): per-vertex best partner by
  // (eta, pair-hash, -partner-id) lexicographic max, then mutual commit.
  // Returns the number of vertices removed; updates notouch/match_to/label
  // fields are deferred to the caller (round()).
  // Split an independent per-vertex loop across two host threads (the
  // partitioner.cpp:1703-1726 OpenMP axis).  Callers' bodies write only
  // their own v-slots and read arrays no other v writes, so outputs are
  // bitwise independent of the interleaving.
  template <typename F>
  static void par_for(i64 cnt, const F& fn) {
    if (cnt < (1 << 15)) {
      for (i64 v = 0; v < cnt; ++v) fn(v);
      return;
    }
    const i64 mid = cnt / 2;
    std::thread t([&]() { for (i64 v = mid; v < cnt; ++v) fn(v); });
    for (i64 v = 0; v < mid; ++v) fn(v);
    t.join();
  }

  // Per-vertex best-partner scan shared by match_pass and absorb_round:
  // writes only partner[v]/best_eta[v]; notouch is read-only here.
  void scan_best(i32 salt, bool positive, bool hash_tb, bool skip_touched) {
    struct Tick { Coarsener* c; double t0;
      ~Tick() { c->t_scan += now() - t0; } } tick{this, now()};
    const T NEG = -std::numeric_limits<T>::infinity();
    partner.assign(n, -1);
    best_eta.assign(n, NEG);
    par_for(n, [&](i64 v) {
      if (!live[v] || (skip_touched && notouch[v])) return;
      T be = NEG;
      i32 bh = -1, br = static_cast<i32>(n);
      for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
        i32 r = er[k];
        T w = ew[k];
        if (w == T(0) || notouch[r]) continue;
        if (cap > 0 && size[v] + size[r] > cap) continue;
        // NOTE exact cross-backend eta equality is impossible in general
        // (XLA CPU division is approximate, measured up to ~50 ulps off
        // IEEE); the default hash tie-break is robust to it -- ties come
        // from *identical inputs* -- and hierarchies match the device
        // backend bit-for-bit in tests.  The index tie-break depends on
        // exact equality of independently-computed gains and agrees at the
        // quality level only.
        T eta = T(2.0) * (w / Tsum - alpha[v] * alpha[r]);
        if (eta < be) continue;
        if (hash_tb) {
          i32 h = pair_hash(static_cast<i32>(v), r, salt);
          if (eta > be || h > bh || (h == bh && r < br)) {
            be = eta; bh = h; br = r;
          }
        } else {
          if (eta > be || r < br) { be = eta; br = r; }
        }
      }
      bool has = be > NEG && br < static_cast<i32>(n);
      if (positive && !(be > T(0))) has = false;
      if (has) { partner[v] = br; best_eta[v] = be; }
    });
  }

  i64 match_pass(i32 salt, bool positive, bool hash_tb,
                 std::vector<i32>* match_out, double* gain_out) {
    scan_best(salt, positive, hash_tb, /*skip_touched=*/true);
    i64 merged = 0;
    double gain = 0.0;
    for (i64 v = 0; v < n; ++v) {
      i32 p = partner[v];
      if (p < 0) continue;
      if (partner[p] == static_cast<i32>(v)) {
        notouch[v] = 1;  // mutual pair: both sides leave the pool
        if (p < static_cast<i32>(v)) {           // v removed into p
          (*match_out)[v] = p;
          ++merged;
        } else {
          gain += double(best_eta[v]);           // v is the representative
        }
      }
    }
    *gain_out = gain;
    return merged;
  }

  // One coarsening round (coarsen.py::coarsen_round; the do-loop body of
  // partitioner.cpp:1696-1838).  Returns vertices merged this round.
  i64 round(i32 rnd, int matching_iterations, bool positive, bool hash_tb) {
    notouch.assign(n, 0);
    for (i64 v = 0; v < n; ++v) notouch[v] = live[v] ? 0 : 1;
    match_to.assign(n, -1);
    i64 merged = 0;
    for (int it = 0; it < matching_iterations; ++it) {
      i32 salt = static_cast<i32>(
          static_cast<u32>(rnd) * static_cast<u32>(matching_iterations) +
          static_cast<u32>(it));
      double gain = 0.0;
      merged += match_pass(salt, positive, hash_tb, &match_to, &gain);
      Q += gain;
    }
    if (merged == 0) return 0;
    contract();
    m -= merged;
    return merged;
  }

  // Star-absorption round (coarsen.py::absorb_round): every vertex with a
  // best partner merges into it unless it receives a merge itself.  The
  // mutual rule serializes hub contraction on power-law graphs (one merge
  // per hub per round); this contracts a star in one round.  Running Q uses
  // pre-round alphas (approximate under multi-absorb, like the device side).
  i64 absorb_round(i32 salt, bool positive, bool hash_tb) {
    notouch.assign(n, 0);
    for (i64 v = 0; v < n; ++v) notouch[v] = live[v] ? 0 : 1;
    match_to.assign(n, -1);
    scan_best(salt, positive, hash_tb, /*skip_touched=*/false);
    std::vector<u8> receives(n, 0);
    for (i64 v = 0; v < n; ++v)
      if (partner[v] >= 0) receives[partner[v]] = 1;
    i64 merged = 0;
    for (i64 v = 0; v < n; ++v) {
      if (partner[v] >= 0 && !receives[v]) {
        match_to[v] = partner[v];
        Q += double(best_eta[v]);
        ++merged;
      }
    }
    if (merged) { contract(); m -= merged; }
    return merged;
  }

  // union + alpha merge + endpoint relabel + dedup (:1756-1834)
  void contract() {
    for (i64 v = 0; v < n; ++v) {
      i32 rep = match_to[v];
      if (rep >= 0) {
        label[v] = rep;
        alpha[rep] += alpha[v];
        size[rep] += size[v];
        diag[rep] += diag[v];     // intra weight rides with the merge
        diag[v] = 0;
        live[v] = 0;
      }
    }
    // endpoint relabel: per-k independent (match_to is read-only here)
    double tt = now();
    par_for(static_cast<i64>(es.size()), [&](i64 k) {
      i32 a = es[k], b = er[k];
      if (match_to[a] >= 0) es[k] = match_to[a];
      if (match_to[b] >= 0) er[k] = match_to[b];
    });
    t_relabel += now() - tt;
    sort_dedup();
  }

  // mergeLeaves pre-pass, one sweep (coarsen.py::merge_leaves_round;
  // partitioner.cpp:1642-1689).  Returns vertices merged.
  i64 leaf_round(bool positive) {
    match_to.assign(n, -1);
    std::vector<u8> ok(n, 0);
    std::vector<i32> nbr(n, -1);
    std::vector<T> gainv(n, T(0));
    for (i64 v = 0; v < n; ++v) {
      if (!live[v]) continue;
      i64 deg = 0;
      i32 nb = -1;
      T wt = 0;
      for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
        if (ew[k] == T(0)) continue;
        ++deg;
        if (er[k] > nb) { nb = er[k]; wt = ew[k]; }
      }
      if (deg != 1 || nb < 0) continue;
      T g = T(2.0) * (wt / Tsum - alpha[v] * alpha[nb]);
      if (positive && !(g > T(0))) continue;
      ok[v] = 1; nbr[v] = nb; gainv[v] = g;
    }
    i64 merged = 0;
    for (i64 v = 0; v < n; ++v) {
      if (!ok[v]) continue;
      i32 nb = nbr[v];
      bool both = ok[nb] && nbr[nb] == static_cast<i32>(v);
      if (both && static_cast<i32>(v) < nb) continue;  // smaller index survives
      match_to[v] = nb;
      Q += double(gainv[v]);
      ++merged;
    }
    if (merged) { contract(); m -= merged; }
    return merged;
  }

  // level snapshot (partitioner.cpp:1797-1815): path-compress labels, rank
  // live vertices densely, record prev-level -> new-level assignment.
  void snapshot(std::vector<i32>* prev_reps) {
    std::vector<i32> rank(n, -1);
    i32 r = 0;
    std::vector<i32> reps;
    reps.reserve(m);
    for (i64 v = 0; v < n; ++v) {
      if (live[v]) {
        rank[v] = r++;
        reps.push_back(static_cast<i32>(v));
      }
    }
    std::vector<i32> assign(prev_reps->size());
    for (size_t k = 0; k < prev_reps->size(); ++k) {
      i32 root = (*prev_reps)[k];
      while (label[root] != root) root = label[root];
      i32 v = (*prev_reps)[k];  // full path compression
      while (label[v] != root) { i32 nx = label[v]; label[v] = root; v = nx; }
      assign[k] = rank[root];
    }
    if (emit_graphs) {
      // emit the coarse adjacency A_{l+1} = P^T A P in dense level labels:
      // the contraction state es/er/ew already IS the off-diagonal part
      // (sorted by (s, r); rank is monotone in root id so relabeling
      // preserves the order), and diag[v] holds the accumulated intra
      // weight -- inserted at its sorted position within each row run.
      std::vector<i32> cs, cr;
      std::vector<double> cw;
      const i64 ecnt = static_cast<i64>(es.size());
      cs.reserve(ecnt + m); cr.reserve(ecnt + m); cw.reserve(ecnt + m);
      for (i64 v = 0; v < n; ++v) {
        if (!live[v]) continue;
        const i32 rv = rank[v];
        bool placed = diag[v] == T(0);   // no diagonal entry to insert
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
          if (!placed && er[k] > static_cast<i32>(v)) {
            cs.push_back(rv); cr.push_back(rv);
            cw.push_back(double(diag[v]));
            placed = true;
          }
          cs.push_back(rv); cr.push_back(rank[er[k]]);
          cw.push_back(double(ew[k]));
        }
        if (!placed) {
          cs.push_back(rv); cr.push_back(rv);
          cw.push_back(double(diag[v]));
        }
      }
      g_s.push_back(std::move(cs));
      g_r.push_back(std::move(cr));
      g_w.push_back(std::move(cw));
    }
    levels.push_back(std::move(assign));
    level_sizes.push_back(m);
    prev_reps->swap(reps);
  }

  void run(double coarsening_factor, i64 num_parts, int matching_iterations,
           bool positive, double stall_stop_threshold, bool merge_leaves,
           bool hash_tb, i64 max_agg_size, double absorb_below,
           i64 force_coarsen_to) {
    // negative max_agg_size = cap measured in ORIGINAL vertices (sizes are
    // never reset at level snapshots); positive = per-level super-vertices
    // (PartitionParams.cap_unit encodes the sign at the binding boundary)
    cap_orig = max_agg_size < 0;
    cap = cap_orig ? -max_agg_size : max_agg_size;
    std::vector<i32> prev_reps(n);
    for (i64 v = 0; v < n; ++v) prev_reps[v] = static_cast<i32>(v);
    level_sizes.push_back(n);

    if (merge_leaves) {
      while (leaf_round(positive) > 0) {}
    }

    i64 n_level = n;
    i32 rnd = 0;
    bool positive_now = positive;
    while (true) {
      i64 m_prev = m;
      i64 merged = round(rnd, matching_iterations, positive_now, hash_tb);
      ++rnd;
      if (coarsening_factor > 0.0 && absorb_below > 0.0 &&
          double(merged) < absorb_below * double(m_prev) && m > 1 &&
          (num_parts <= 0 || m > num_parts)) {
        // mutual-rate collapse (hub serialization): star-absorb round
        // (salt stream mirrors hierarchy.py: rnd * matching_iterations)
        absorb_round(static_cast<i32>(
            static_cast<u32>(rnd) * static_cast<u32>(matching_iterations)),
            positive_now, hash_tb);
        ++rnd;
      }
      if (coarsening_factor > 0.0 &&
          double(m) / double(n_level) <= coarsening_factor) {
        snapshot(&prev_reps);
        n_level = m;
        if (cap > 0 && !cap_orig) size.assign(n, 1);  // per-level cap unit
      }
      if (num_parts > 0 && m <= num_parts) break;
      if (m_prev == 0 ||
          double(m) / double(m_prev > 0 ? m_prev : 1) >= stall_stop_threshold) {
        // stall under an active size cap: merging often halts only because
        // every candidate pair would exceed the cap.  Treat it as a level
        // boundary (snapshot + size reset) and resume, provided the level
        // made real progress (mirrors hierarchy.py::_run_rounds)
        if (cap > 0 && coarsening_factor > 0.0 &&
            double(m) <= 0.8 * double(n_level) && m > 1) {
          snapshot(&prev_reps);
          n_level = m;
          if (!cap_orig) size.assign(n, 1);
          continue;
        }
        // positive merging exhausted (modularity optimum) while the level
        // is still large: relax DeltaQ > 0 and keep building the embedding
        // hierarchy (mirrors hierarchy.py force_coarsen_to)
        if (coarsening_factor > 0.0 && positive_now &&
            force_coarsen_to > 0 && m > force_coarsen_to && m > 1) {
          positive_now = false;
          continue;
        }
        break;
      }
      if (m <= 1) break;
      (void)merged;
    }
    // final snapshot (:1840-1853); skipped when the loop exited right after
    // a crossing snapshot (an identity level adds a no-op embed pass)
    if (levels.empty() || m < level_sizes.back()) snapshot(&prev_reps);
    if (std::getenv("GE_COARSEN_PROF"))
      std::fprintf(stderr,
                   "[coarsen prof] sort=%.1fs dedup=%.1fs scan=%.1fs "
                   "relabel=%.1fs\n", t_sort, t_dedup, t_scan, t_relabel);
  }
};

}  // namespace

extern "C" {

struct GeCoarsenResult {
  std::vector<std::vector<i32>> levels;
  std::vector<i64> level_sizes;  // [n0, n1, ...]
  double Q;
  // optional coarse graphs (one per snapshot; emit_graphs != 0)
  std::vector<std::vector<i32>> g_s, g_r;
  std::vector<std::vector<double>> g_w;
};

// Runs the full hierarchy/single-level coarsener.  w points to float32 or
// float64 data per is_f64.  coarsening_factor <= 0 disables level snapshots
// (single final snapshot only); num_parts <= 0 disables the numParts halt.
// Returns an opaque handle (free with ge_coarsen_free) and writes the number
// of snapshot levels to *num_levels_out.
void* ge_coarsen_run(i64 n, i64 e, const i32* s, const i32* r, const void* w,
                     int is_f64, double coarsening_factor, i64 num_parts,
                     int matching_iterations, int positive_merging,
                     double stall_stop_threshold, int merge_leaves,
                     int tie_break_hash, double weight_jitter,
                     i64 max_agg_size, double absorb_below,
                     i64 force_coarsen_to, int emit_graphs,
                     i64* num_levels_out, double* q_out) {
  auto* res = new GeCoarsenResult();
  if (is_f64) {
    Coarsener<double> c;
    c.init(n, s, r, static_cast<const double*>(w), e, weight_jitter);
    c.emit_graphs = emit_graphs != 0;
    c.run(coarsening_factor, num_parts, matching_iterations,
          positive_merging != 0, stall_stop_threshold, merge_leaves != 0,
          tie_break_hash != 0, max_agg_size, absorb_below,
          force_coarsen_to);
    res->levels = std::move(c.levels);
    res->level_sizes = std::move(c.level_sizes);
    res->Q = c.Q;
    res->g_s = std::move(c.g_s);
    res->g_r = std::move(c.g_r);
    res->g_w = std::move(c.g_w);
  } else {
    Coarsener<float> c;
    c.init(n, s, r, static_cast<const float*>(w), e, weight_jitter);
    c.emit_graphs = emit_graphs != 0;
    c.run(coarsening_factor, num_parts, matching_iterations,
          positive_merging != 0, stall_stop_threshold, merge_leaves != 0,
          tie_break_hash != 0, max_agg_size, absorb_below,
          force_coarsen_to);
    res->levels = std::move(c.levels);
    res->level_sizes = std::move(c.level_sizes);
    res->Q = c.Q;
    res->g_s = std::move(c.g_s);
    res->g_r = std::move(c.g_r);
    res->g_w = std::move(c.g_w);
  }
  *num_levels_out = static_cast<i64>(res->levels.size());
  *q_out = res->Q;
  return res;
}

// level_sizes has num_levels+1 entries: [n0, n1, ..., nk]
void ge_coarsen_level_sizes(void* handle, i64* out) {
  auto* res = static_cast<GeCoarsenResult*>(handle);
  for (size_t i = 0; i < res->level_sizes.size(); ++i)
    out[i] = res->level_sizes[i];
}

// assignment for snapshot lvl: maps level-lvl vertices (size level_sizes[lvl])
// to [0, level_sizes[lvl+1]) aggregate ids
void ge_coarsen_fill_assign(void* handle, i64 lvl, i32* out) {
  auto* res = static_cast<GeCoarsenResult*>(handle);
  const std::vector<i32>& a = res->levels[static_cast<size_t>(lvl)];
  memcpy(out, a.data(), a.size() * sizeof(i32));
}

// edge count of the emitted coarse graph for snapshot lvl (0 when graphs
// were not emitted)
i64 ge_coarsen_graph_edges(void* handle, i64 lvl) {
  auto* res = static_cast<GeCoarsenResult*>(handle);
  if (static_cast<size_t>(lvl) >= res->g_s.size()) return 0;
  return static_cast<i64>(res->g_s[static_cast<size_t>(lvl)].size());
}

// canonical COO of snapshot lvl's coarse graph: sorted by (s, r), duplicate
// -free, diagonal = intra-aggregate weight (the Galerkin P^T A P entries)
void ge_coarsen_fill_graph(void* handle, i64 lvl, i32* s_out, i32* r_out,
                           double* w_out) {
  auto* res = static_cast<GeCoarsenResult*>(handle);
  const auto& cs = res->g_s[static_cast<size_t>(lvl)];
  memcpy(s_out, cs.data(), cs.size() * sizeof(i32));
  memcpy(r_out, res->g_r[static_cast<size_t>(lvl)].data(),
         cs.size() * sizeof(i32));
  memcpy(w_out, res->g_w[static_cast<size_t>(lvl)].data(),
         cs.size() * sizeof(double));
}

void ge_coarsen_free(void* handle) {
  delete static_cast<GeCoarsenResult*>(handle);
}

}  // extern "C"
