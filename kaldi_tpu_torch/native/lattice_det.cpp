// Copied from kaldi_tpu/native/lattice_det.cpp.
// Native host-runtime: lattice determinization (raw state-level
// lattice -> CompactLattice arrays).
//
// Parity target: src/lat/determinize-lattice-pruned.h
// (DeterminizeLatticePruned / DeterminizeLatticePhonePrunedWrapper) —
// the reference runs this per-utterance pass in C++ right after
// GetRawLattice; so do we.  The algorithm is the same subset
// determinization the numpy/Python oracle in
// kaldi_tpu/lattice/determinize.py implements: det-state = normalized
// set of (lattice state, (graph, acoustic) residual, transition-id
// string residual); for each word leaving the subset the best residual
// continuation is kept (tropical lattice semiring).  Equivalence to
// the Python oracle is asserted path-semantically in
// tests/test_native_det.py (same word sequences and total costs).
//
// Exposed with C linkage for ctypes (no pybind11 in this image); the
// Python implementation is the oracle and fallback.
//
// Build: handled by kaldi_tpu/native/__init__.py (g++ -O3, cached).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// tid strings live in an arena of (parent, tid) nodes; -1 = empty.
struct TidArena {
  std::vector<int64_t> parent;
  std::vector<int32_t> tid;
  int64_t push(int64_t par, int32_t t) {
    parent.push_back(par);
    tid.push_back(t);
    return (int64_t)parent.size() - 1;
  }
  void materialize(int64_t node, std::vector<int32_t>* out) const {
    out->clear();
    while (node >= 0) {
      out->push_back(tid[node]);
      node = parent[node];
    }
    std::reverse(out->begin(), out->end());
  }
};

struct ClosedEntry {
  double gc, ac;
  int64_t tids;  // arena node
};

// one element of a normalized det-state
struct NormElem {
  int32_t state;
  int64_t qgc, qac;  // residual costs in micro-units (1e-6 rounding)
  std::vector<int32_t> tids;  // residual tid string
  bool operator<(const NormElem& o) const {
    if (state != o.state) return state < o.state;
    if (qgc != o.qgc) return qgc < o.qgc;
    if (qac != o.qac) return qac < o.qac;
    return tids < o.tids;
  }
  bool operator==(const NormElem& o) const {
    return state == o.state && qgc == o.qgc && qac == o.qac
        && tids == o.tids;
  }
};

struct NormKey {
  std::vector<NormElem> elems;
  bool operator==(const NormKey& o) const { return elems == o.elems; }
};

struct NormKeyHash {
  size_t operator()(const NormKey& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    for (const NormElem& e : k.elems) {
      mix((uint64_t)e.state);
      mix((uint64_t)e.qgc);
      mix((uint64_t)e.qac);
      for (int32_t t : e.tids) mix((uint64_t)(uint32_t)t);
      mix(0xabcdull);
    }
    return (size_t)h;
  }
};

inline int64_t quant(double x) {
  // Python: round(x, 6).  llround of x*1e6 matches to the rounding
  // mode on exact halves, which the semantic tests tolerate.
  return (int64_t)llround(x * 1e6);
}

struct Graph {
  int64_t n_states;
  std::vector<int64_t> row;   // CSR offsets by src (n_states+1)
  std::vector<int32_t> dst, il, ol;
  std::vector<float> gw, ac;
};

// closure over word-eps arcs (ol==0), accumulating tids/costs; keeps
// the best entry per state (lazy-decrease-key heap, correct for the
// acyclic raw lattice even with negative arc costs).
void Closure(const Graph& g, TidArena* arena,
             std::vector<std::pair<int32_t, ClosedEntry>>* items_inout) {
  struct HeapItem {
    double tot, gc, ac;
    int32_t s;
    int64_t tids;
    bool operator>(const HeapItem& o) const { return tot > o.tot; }
  };
  std::priority_queue<HeapItem, std::vector<HeapItem>,
                      std::greater<HeapItem>> heap;
  std::unordered_map<int32_t, ClosedEntry> best;
  best.reserve(items_inout->size() * 4);
  std::vector<int32_t> order;  // insertion order (Python dict order)
  for (auto& it : *items_inout)
    heap.push({it.second.gc + it.second.ac, it.second.gc, it.second.ac,
               it.first, it.second.tids});
  while (!heap.empty()) {
    HeapItem h = heap.top();
    heap.pop();
    auto f = best.find(h.s);
    if (f != best.end() && f->second.gc + f->second.ac <= h.tot) continue;
    if (f == best.end()) order.push_back(h.s);
    best[h.s] = {h.gc, h.ac, h.tids};
    for (int64_t i = g.row[h.s]; i < g.row[h.s + 1]; ++i) {
      if (g.ol[i] != 0) continue;
      int64_t ntids = g.il[i] ? arena->push(h.tids, g.il[i]) : h.tids;
      double ngc = h.gc + g.gw[i], nac = h.ac + g.ac[i];
      auto c = best.find(g.dst[i]);
      if (c == best.end() || c->second.gc + c->second.ac > ngc + nac)
        heap.push({ngc + nac, ngc, nac, g.dst[i], ntids});
    }
  }
  items_inout->clear();
  for (int32_t s : order) items_inout->push_back({s, best[s]});
}

// normalize: subtract the min-total element's (gc, ac); strip the
// common tid prefix.  Returns (base_gc, base_ac, prefix, sorted elems).
void Normalize(const TidArena& arena,
               const std::vector<std::pair<int32_t, ClosedEntry>>& closed,
               double* base_gc, double* base_ac,
               std::vector<int32_t>* prefix, NormKey* key) {
  // min-total element in insertion order (ties -> first), matching the
  // Python oracle's min() over dict items
  size_t rep = 0;
  double best = kInf;
  for (size_t i = 0; i < closed.size(); ++i) {
    double tot = closed[i].second.gc + closed[i].second.ac;
    if (tot < best) {
      best = tot;
      rep = i;
    }
  }
  *base_gc = closed[rep].second.gc;
  *base_ac = closed[rep].second.ac;
  // materialize tid strings, compute common prefix
  std::vector<std::vector<int32_t>> strs(closed.size());
  for (size_t i = 0; i < closed.size(); ++i)
    arena.materialize(closed[i].second.tids, &strs[i]);
  size_t plen = strs[0].size();
  for (size_t i = 1; i < strs.size() && plen; ++i) {
    size_t j = 0;
    while (j < plen && j < strs[i].size() && strs[0][j] == strs[i][j]) ++j;
    plen = j;
  }
  prefix->assign(strs[0].begin(), strs[0].begin() + plen);
  key->elems.clear();
  key->elems.reserve(closed.size());
  for (size_t i = 0; i < closed.size(); ++i) {
    NormElem e;
    e.state = closed[i].first;
    e.qgc = quant(closed[i].second.gc - *base_gc);
    e.qac = quant(closed[i].second.ac - *base_ac);
    e.tids.assign(strs[i].begin() + plen, strs[i].end());
    key->elems.push_back(std::move(e));
  }
  std::sort(key->elems.begin(), key->elems.end());
}

}  // namespace

extern "C" {

// Determinize a raw lattice given as arc arrays (src/dst/il/ol/gw/ac,
// n_arcs entries over n_states states, start state = `start`), finals
// as (fin_states, fin_gc, fin_ac, n_fin).
//
// Outputs a CompactLattice as arrays:
//   arcs:   out_src/out_word/out_next (i32), out_gc/out_ac (f64),
//           tid strings in out_tids (i32) delimited by out_tid_off
//           (i64, n_out_arcs+1 entries)
//   finals: out_fin_state (i32), out_fin_gc/out_fin_ac (f64), strings
//           appended to out_tids with offsets out_fin_off (i64,
//           n_out_fin+1, continuing after the arc strings)
//   counts: *n_out_arcs, *n_out_fin, *n_out_states, *out_start
// Returns 0 on success, -1 on output-capacity overflow (cap_arcs /
// cap_tids / cap_states), -3 on det-state blowup (> max_states).
// Empty input (start < 0) -> success with 0 states.
int64_t kt_determinize_lattice(
    int64_t n_states, int64_t n_arcs, int32_t start,
    const int32_t* src, const int32_t* dst,
    const int32_t* il, const int32_t* ol,
    const float* gw, const float* ac,
    const int32_t* fin_states, const float* fin_gc, const float* fin_ac,
    int64_t n_fin,
    int64_t max_states,
    int64_t cap_arcs, int64_t cap_tids, int64_t cap_states,
    int32_t* out_src, int32_t* out_word, int32_t* out_next,
    double* out_gc, double* out_ac,
    int32_t* out_tids, int64_t* out_tid_off,
    int32_t* out_fin_state, double* out_fin_gc, double* out_fin_ac,
    int64_t* out_fin_off,
    int64_t* n_out_arcs, int64_t* n_out_fin, int64_t* n_out_states,
    int32_t* out_start) {
  *n_out_arcs = 0;
  *n_out_fin = 0;
  *n_out_states = 0;
  *out_start = -1;
  if (start < 0 || n_states == 0) return 0;

  // CSR by src (counting sort; input may be level-ordered already)
  Graph g;
  g.n_states = n_states;
  g.row.assign(n_states + 1, 0);
  for (int64_t i = 0; i < n_arcs; ++i) ++g.row[src[i] + 1];
  for (int64_t s = 0; s < n_states; ++s) g.row[s + 1] += g.row[s];
  g.dst.resize(n_arcs);
  g.il.resize(n_arcs);
  g.ol.resize(n_arcs);
  g.gw.resize(n_arcs);
  g.ac.resize(n_arcs);
  {
    std::vector<int64_t> pos(g.row.begin(), g.row.end() - 1);
    for (int64_t i = 0; i < n_arcs; ++i) {
      int64_t p = pos[src[i]]++;
      g.dst[p] = dst[i];
      g.il[p] = il[i];
      g.ol[p] = ol[i];
      g.gw[p] = gw[i];
      g.ac[p] = ac[i];
    }
  }
  // finals lookup: best (gc, ac) per state
  std::unordered_map<int32_t, std::pair<float, float>> finals;
  finals.reserve(n_fin * 2 + 1);
  for (int64_t i = 0; i < n_fin; ++i) {
    auto f = finals.find(fin_states[i]);
    if (f == finals.end()
        || f->second.first + f->second.second > fin_gc[i] + fin_ac[i])
      finals[fin_states[i]] = {fin_gc[i], fin_ac[i]};
  }

  TidArena arena;
  arena.parent.reserve(n_arcs + 16);
  arena.tid.reserve(n_arcs + 16);

  std::unordered_map<NormKey, int32_t, NormKeyHash> det;
  std::vector<NormKey> det_states;  // by id, for the BFS queue
  int64_t next_id = 0;

  // output accumulators (bounded by caps)
  int64_t na = 0, nt = 0, nf = 0;
  auto emit_tids = [&](const std::vector<int32_t>& s) -> bool {
    if (nt + (int64_t)s.size() > cap_tids) return false;
    std::memcpy(out_tids + nt, s.data(), s.size() * sizeof(int32_t));
    nt += (int64_t)s.size();
    return true;
  };

  // initial closure
  std::vector<std::pair<int32_t, ClosedEntry>> items;
  items.push_back({start, {0.0, 0.0, -1}});
  Closure(g, &arena, &items);
  double gc0, ac0;
  std::vector<int32_t> pre0;
  NormKey k0;
  Normalize(arena, items, &gc0, &ac0, &pre0, &k0);
  // state 0 = start; if the initial residual is nonzero it goes onto a
  // word-eps arc start -> 1 (matching the Python oracle)
  int64_t n_out = 1;
  *out_start = 0;
  int32_t s_for_k0 = 0;
  if (gc0 != 0.0 || ac0 != 0.0 || !pre0.empty()) {
    if (n_out + 1 > cap_states || na + 1 > cap_arcs) return -1;
    out_src[na] = 0;
    out_word[na] = 0;
    out_next[na] = 1;
    out_gc[na] = gc0;
    out_ac[na] = ac0;
    out_tid_off[na] = nt;
    if (!emit_tids(pre0)) return -1;
    ++na;
    s_for_k0 = 1;
    n_out = 2;
  }
  det[k0] = s_for_k0;
  det_states.push_back(k0);
  next_id = 1;

  // finals stash: (det state, gc, ac, string) — strings must follow
  // the arc strings in out_tids, so buffer them until the end
  std::vector<int32_t> fbuf_state;
  std::vector<double> fbuf_gc, fbuf_ac;
  std::vector<std::vector<int32_t>> fbuf_tids;

  std::vector<int32_t> det_out_id;  // det id -> output state id
  det_out_id.push_back(s_for_k0);

  std::vector<int32_t> tmp_str;
  for (int64_t qi = 0; qi < (int64_t)det_states.size(); ++qi) {
    const NormKey& norm = det_states[qi];
    int32_t cur = det_out_id[qi];
    // final weight: best (residual + final) over elements
    {
      bool have = false;
      double bgc = 0, bac = 0;
      const std::vector<int32_t>* btids = nullptr;
      for (const NormElem& e : norm.elems) {
        auto f = finals.find(e.state);
        if (f == finals.end()) continue;
        double cgc = e.qgc * 1e-6 + f->second.first;
        double cac = e.qac * 1e-6 + f->second.second;
        if (!have || cgc + cac < bgc + bac) {
          have = true;
          bgc = cgc;
          bac = cac;
          btids = &e.tids;
        }
      }
      if (have) {
        fbuf_state.push_back(cur);
        fbuf_gc.push_back(bgc);
        fbuf_ac.push_back(bac);
        fbuf_tids.push_back(*btids);
      }
    }
    // group outgoing word arcs over all elements
    std::unordered_map<int32_t,
                       std::vector<std::pair<int32_t, ClosedEntry>>> by_word;
    for (const NormElem& e : norm.elems) {
      // residual tids of this element as an arena chain (built lazily
      // once per element)
      int64_t base_node = -1;
      bool built = false;
      for (int64_t i = g.row[e.state]; i < g.row[e.state + 1]; ++i) {
        if (g.ol[i] == 0) continue;
        if (!built) {
          for (int32_t t : e.tids) base_node = arena.push(base_node, t);
          built = true;
        }
        int64_t ntids =
            g.il[i] ? arena.push(base_node, g.il[i]) : base_node;
        by_word[g.ol[i]].push_back(
            {g.dst[i],
             {e.qgc * 1e-6 + g.gw[i], e.qac * 1e-6 + g.ac[i], ntids}});
      }
    }
    std::vector<int32_t> words;
    words.reserve(by_word.size());
    for (auto& kv : by_word) words.push_back(kv.first);
    std::sort(words.begin(), words.end());
    for (int32_t w : words) {
      auto& its = by_word[w];
      Closure(g, &arena, &its);
      double bgc, bac;
      std::vector<int32_t> prefix;
      NormKey nk;
      Normalize(arena, its, &bgc, &bac, &prefix, &nk);
      auto f = det.find(nk);
      int32_t dest;
      if (f == det.end()) {
        if (next_id >= max_states) return -3;
        if (n_out + 1 > cap_states) return -1;
        dest = (int32_t)n_out++;
        det.emplace(nk, dest);
        det_states.push_back(std::move(nk));
        det_out_id.push_back(dest);
        ++next_id;
      } else {
        dest = f->second;
      }
      if (na + 1 > cap_arcs) return -1;
      out_src[na] = cur;
      out_word[na] = w;
      out_next[na] = dest;
      out_gc[na] = bgc;
      out_ac[na] = bac;
      out_tid_off[na] = nt;
      if (!emit_tids(prefix)) return -1;
      ++na;
    }
  }
  out_tid_off[na] = nt;
  // append final strings
  for (size_t i = 0; i < fbuf_state.size(); ++i) {
    out_fin_state[nf] = fbuf_state[i];
    out_fin_gc[nf] = fbuf_gc[i];
    out_fin_ac[nf] = fbuf_ac[i];
    out_fin_off[nf] = nt;
    if (!emit_tids(fbuf_tids[i])) return -1;
    ++nf;
  }
  out_fin_off[nf] = nt;
  *n_out_arcs = na;
  *n_out_fin = nf;
  *n_out_states = n_out;
  return 0;
}

}  // extern "C"
