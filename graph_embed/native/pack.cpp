// Native (host C++) edge-array kitchen: stable radix sort and COO dedup/CSR
// build.
//
// Role: the host-side data-preparation runtime.  The reference links
// linalgcpp's C++ CooMatrix::ToSparse (duplicate-add + CSR build, used at
// embed.cpp:51-66 and by every reader); here the equivalents are the
// hot host path of graph/csr.py::from_coo, which is vectorized numpy
// (np.lexsort dominates it).  This module replaces the sort with a stable
// LSD radix sort; results are bit-identical to the numpy implementation
// (differential tests).
//
// Exposed over a C ABI and bound with ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#endif

namespace {

// Scratch buffer on (advised) transparent huge pages.  The radix scatter's
// working set at 131M edges is ~5 GB across four streams; with 4 KB pages
// every scattered write is a TLB miss / page walk, which measured as the
// dominant cost (102 s for a ~21 GB-traffic sort on this host).  THP here
// is madvise-gated, so allocate UNTOUCHED memory, advise, then fault in at
// 2 MB granularity.
template <typename T>
struct HugeBuf {
  T* p = nullptr;
  size_t len = 0;
  explicit HugeBuf(size_t count) : len(count * sizeof(T)) {
    p = static_cast<T*>(std::malloc(len));
#if defined(__linux__) && defined(MADV_HUGEPAGE)
    if (p && len >= (size_t(2) << 20)) {
      uintptr_t a = reinterpret_cast<uintptr_t>(p);
      uintptr_t lo = (a + ((1 << 21) - 1)) & ~uintptr_t((1 << 21) - 1);
      uintptr_t hi = (a + len) & ~uintptr_t((1 << 21) - 1);
      if (hi > lo)
        madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_HUGEPAGE);
    }
#endif
  }
  ~HugeBuf() { std::free(p); }
  T* data() { return p; }
};

typedef int32_t i32;
typedef int64_t i64;
typedef uint64_t u64;
typedef uint32_t u32;

// Stable LSD radix argsort of u64 keys, 11-bit digits (2048 write streams
// stay cache/TLB-resident; 16-bit digits measured 1.7x slower at 12.5M).
// Keys are carried alongside the index permutation so every pass streams
// both arrays sequentially -- the naive keys[order[i]] gather was the
// dominant cost (random 8B reads), slower than np.argsort.  Histograms for
// ALL digit positions are taken in one linear pass (digit counts are
// permutation-invariant), and histogram + scatter are split across threads
// (per-thread bucket offsets keep the sort stable).
constexpr int kRadixBits = 11;
constexpr int kBuckets = 1 << kRadixBits;

void radix_argsort(const u64* keys_in, i64 m, i64* order,
                   u64* sorted_keys = nullptr) {
  int n_threads = (m >= (i64(1) << 20)) ? 2 : 1;
  HugeBuf<u64> kbuf_a(m), kbuf_b(m);
  HugeBuf<i64> tmp(m);
  u64* ksrc = kbuf_a.data();
  u64* kdst = kbuf_b.data();
  i64* src = order;
  i64* dst = tmp.data();
  auto chunk = [&](int t) { return m * t / n_threads; };

  // prep pass: copy keys, seed identity order, find varying bits
  u64 all_or = 0, all_and = ~u64(0);
  {
    std::vector<std::thread> ts;
    std::vector<u64> t_or(n_threads, 0), t_and(n_threads, ~u64(0));
    for (int t = 0; t < n_threads; ++t)
      ts.emplace_back([&, t] {
        u64 o = 0, a = ~u64(0);
        for (i64 i = chunk(t); i < chunk(t + 1); ++i) {
          u64 k = keys_in[i];
          ksrc[i] = k;
          src[i] = i;
          o |= k;
          a &= k;
        }
        t_or[t] = o;
        t_and[t] = a;
      });
    for (auto& th : ts) th.join();
    for (int t = 0; t < n_threads; ++t) {
      all_or |= t_or[t];
      all_and &= t_and[t];
    }
  }
  u64 varying = all_or & ~all_and;  // bits that differ between keys

  std::vector<std::vector<i64>> hist(n_threads, std::vector<i64>(kBuckets));
  for (int shift = 0; shift < 64; shift += kRadixBits) {
    if (((varying >> shift) & (kBuckets - 1)) == 0) continue;
    {  // parallel histogram of the current digit (linear key stream)
      std::vector<std::thread> ts;
      for (int t = 0; t < n_threads; ++t)
        ts.emplace_back([&, t, shift] {
          i64* h = hist[t].data();
          memset(h, 0, kBuckets * sizeof(i64));
          for (i64 i = chunk(t); i < chunk(t + 1); ++i)
            ++h[(ksrc[i] >> shift) & (kBuckets - 1)];
        });
      for (auto& th : ts) th.join();
    }
    // exclusive offsets per (bucket, thread): thread t's elements of bucket
    // b land after threads <t's, preserving chunk (= current) order
    std::vector<std::vector<i64>> off(n_threads, std::vector<i64>(kBuckets));
    i64 sum = 0;
    for (int b = 0; b < kBuckets; ++b)
      for (int t = 0; t < n_threads; ++t) {
        off[t][b] = sum;
        sum += hist[t][b];
      }
    {  // parallel stable scatter of (key, index) pairs
      std::vector<std::thread> ts;
      for (int t = 0; t < n_threads; ++t)
        ts.emplace_back([&, t, shift] {
          i64* o = off[t].data();
          for (i64 i = chunk(t); i < chunk(t + 1); ++i) {
            u64 k = ksrc[i];
            i64 pos = o[(k >> shift) & (kBuckets - 1)]++;
            kdst[pos] = k;
            dst[pos] = src[i];
          }
        });
      for (auto& th : ts) th.join();
    }
    std::swap(src, dst);
    std::swap(ksrc, kdst);
  }
  if (src != order) memcpy(order, src, m * sizeof(i64));
  if (sorted_keys) memcpy(sorted_keys, ksrc, m * sizeof(u64));
}

struct CooResult {
  std::vector<i64> s, r;
  std::vector<double> w;
  std::vector<i64> indptr;  // [n + 1]
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// COO dedup + CSR indptr (graph/csr.py::_finish_coo sum_duplicates path):
// stable sort by s*n + r, sum duplicate (s, r) weights (ascending original
// order, matching np.add.at), build indptr by row counts.
// ---------------------------------------------------------------------------

void* ge_coo_dedup(i64 m, i64 n, const i64* s, const i64* r, const double* w,
                   i64* out_count) {
  auto* res = new CooResult();
  HugeBuf<u64> keys(m);
  for (i64 i = 0; i < m; ++i)
    keys.data()[i] = static_cast<u64>(s[i]) * static_cast<u64>(n) +
                     static_cast<u64>(r[i]);
  // order/sorted are scatter destinations on alternating radix passes --
  // huge pages matter as much as for the internal buffers
  HugeBuf<i64> order(m);
  HugeBuf<u64> sorted(m);
  radix_argsort(keys.data(), m, order.data(), sorted.data());
  const u64* skeys = sorted.data();
  const i64* ord = order.data();
  res->s.reserve(m);
  res->r.reserve(m);
  res->w.reserve(m);
  // s/r are recovered from the sorted key (k = s*n + r) so the only
  // random access left is the 8B weight gather
  u64 prev = ~u64(0);
  for (i64 i = 0; i < m; ++i) {
    u64 k = skeys[i];
    if (i && k == prev) {
      res->w.back() += w[ord[i]];
    } else {
      res->s.push_back(static_cast<i64>(k / static_cast<u64>(n)));
      res->r.push_back(static_cast<i64>(k % static_cast<u64>(n)));
      res->w.push_back(w[ord[i]]);
      prev = k;
    }
  }
  res->indptr.assign(n + 1, 0);
  for (i64 v : res->s) ++res->indptr[v + 1];
  for (i64 v = 0; v < n; ++v) res->indptr[v + 1] += res->indptr[v];
  *out_count = static_cast<i64>(res->s.size());
  return res;
}

void ge_coo_fill(void* handle, i64* s, i64* r, double* w, i64* indptr) {
  auto* res = static_cast<CooResult*>(handle);
  memcpy(s, res->s.data(), res->s.size() * sizeof(i64));
  memcpy(r, res->r.data(), res->r.size() * sizeof(i64));
  memcpy(w, res->w.data(), res->w.size() * sizeof(double));
  memcpy(indptr, res->indptr.data(), res->indptr.size() * sizeof(i64));
}

void ge_coo_free(void* handle) { delete static_cast<CooResult*>(handle); }

}  // extern "C"
