// Copied from kaldi_tpu/native/lattice_build.cpp.
// Native host-runtime: raw-lattice assembly + α/β lattice-beam pruning.
//
// Parity target: the host side of LatticeFasterDecoder::GetRawLattice +
// PruneActiveTokens (src/decoder/lattice-faster-decoder.cc) — the
// reference implements this hot per-utterance pass in C++; so do we.
// The decoder's device scan emits per-frame record tensors
// (prev-slot, dst-slot, tid, olabel, graph-cost, acoustic-cost); this
// pass assigns state ids level by level, runs exact forward/backward
// min-cost, prunes arcs outside best + lattice_beam, and compacts.
//
// Exposed with C linkage for ctypes (no Python API dependency); the
// numpy implementation in decoder/beam.py is the oracle and fallback.
//
// Build: g++ -O3 -shared -fPIC lattice_build.cpp -o liblattice_build.so
// (kaldi_tpu/native/__init__.py compiles and caches this on demand.)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr float kInf = std::numeric_limits<float>::infinity();
}

extern "C" {

// Returns the number of kept arcs, or -1 on overflow of *cap_arcs /
// -2 if no path reaches a final state.  Records arrive PACKED: the
// device decode compacts valid records to a contiguous prefix; counts
// (length T) gives how many belong to each frame, and the flat record
// arrays hold sum(counts) entries in frame order.  States are emitted
// in topological order with id 0 = the virtual start; n_states_out
// gives the compacted state count; out_final_* lists final states
// with their (graph) costs.
int64_t kt_build_lattice(
    int64_t T, int64_t K,
    const int32_t* counts,
    const int32_t* prev, const int32_t* dst,
    const int32_t* tid, const int32_t* ol,
    const float* gw, const float* ac,
    const int32_t* init_slots, const float* init_costs,
    const int32_t* init_ols, int64_t n_init,
    const float* tok_final,
    float lattice_beam,
    int64_t cap_arcs,
    int32_t* out_src, int32_t* out_dst,
    int32_t* out_il, int32_t* out_ol,
    float* out_gw, float* out_ac,
    int32_t* out_final_states, float* out_final_w, int64_t* n_finals,
    int64_t* n_states_out) {
  // -- pass 1: assign state ids level by level ------------------------
  std::vector<int64_t> cur(K, -1), nxt(K, -1);
  int64_t n_states = 1;  // 0 = virtual start
  struct Arc {
    int64_t src, dst;
    int32_t il, ol;
    float gw, ac;
  };
  std::vector<Arc> arcs;
  arcs.reserve(T * 64);
  // level 0: initial tokens (init_ols: word olabels riding the start
  // ε-closure path of a token — e.g. a 1-phone first word in a
  // triphone graph; may be sequence-encoded, expanded by the caller)
  for (int64_t i = 0; i < n_init; ++i) {
    int32_t s = init_slots[i];
    if (s < 0 || s >= K) continue;
    cur[s] = n_states++;
    arcs.push_back({0, cur[s], 0, init_ols ? init_ols[i] : 0,
                    init_costs[i], 0.0f});
  }
  int64_t off = 0;
  for (int64_t t = 0; t < T; ++t) {
    std::fill(nxt.begin(), nxt.end(), -1);
    const int64_t end = off + counts[t];
    for (int64_t j = off; j < end; ++j) {
      int32_t p = prev[j];
      if (p < 0 || p >= K || cur[p] < 0) continue;
      int32_t d = dst[j];
      if (d < 0 || d >= K) continue;
      if (nxt[d] < 0) nxt[d] = n_states++;
      arcs.push_back({cur[p], nxt[d], tid[j], ol[j], gw[j], ac[j]});
    }
    off = end;
    cur.swap(nxt);
  }
  const int64_t A = (int64_t)arcs.size();

  // -- finals ----------------------------------------------------------
  std::vector<int64_t> fin_states;
  std::vector<float> fin_w;
  for (int64_t s = 0; s < K; ++s) {
    if (cur[s] >= 0 && tok_final[s] < kInf) {
      fin_states.push_back(cur[s]);
      fin_w.push_back(tok_final[s]);
    }
  }
  if (fin_states.empty()) {
    for (int64_t s = 0; s < K; ++s)
      if (cur[s] >= 0) {
        fin_states.push_back(cur[s]);
        fin_w.push_back(0.0f);
      }
  }
  if (fin_states.empty()) return -2;

  // -- pass 2: α/β over the level-ordered DAG --------------------------
  std::vector<double> alpha(n_states, kInf), beta(n_states, kInf);
  alpha[0] = 0.0;
  for (int64_t i = 0; i < A; ++i) {
    const Arc& a = arcs[i];
    double c = alpha[a.src] + a.gw + a.ac;
    if (c < alpha[a.dst]) alpha[a.dst] = c;
  }
  double best = kInf;
  for (size_t i = 0; i < fin_states.size(); ++i) {
    if (beta[fin_states[i]] > fin_w[i]) beta[fin_states[i]] = fin_w[i];
    double c = alpha[fin_states[i]] + fin_w[i];
    if (c < best) best = c;
  }
  if (!(best < kInf)) return -2;
  for (int64_t i = A - 1; i >= 0; --i) {
    const Arc& a = arcs[i];
    double c = a.gw + a.ac + beta[a.dst];
    if (c < beta[a.src]) beta[a.src] = c;
  }
  const double bound = best + lattice_beam;

  // -- pass 3: prune + compact -----------------------------------------
  std::vector<uint8_t> keep_state(n_states, 0);
  keep_state[0] = 1;
  int64_t kept = 0;
  for (int64_t i = 0; i < A; ++i) {
    const Arc& a = arcs[i];
    if (alpha[a.src] + a.gw + a.ac + beta[a.dst] <= bound) {
      keep_state[a.src] = keep_state[a.dst] = 1;
      ++kept;
    }
  }
  if (kept > cap_arcs) return -1;
  std::vector<int64_t> remap(n_states, -1);
  int64_t ns = 0;
  for (int64_t s = 0; s < n_states; ++s)
    if (keep_state[s]) remap[s] = ns++;
  int64_t k = 0;
  for (int64_t i = 0; i < A; ++i) {
    const Arc& a = arcs[i];
    if (alpha[a.src] + a.gw + a.ac + beta[a.dst] <= bound) {
      out_src[k] = (int32_t)remap[a.src];
      out_dst[k] = (int32_t)remap[a.dst];
      out_il[k] = a.il;
      out_ol[k] = a.ol;
      out_gw[k] = a.gw;
      out_ac[k] = a.ac;
      ++k;
    }
  }
  int64_t nf = 0;
  for (size_t i = 0; i < fin_states.size(); ++i) {
    if (keep_state[fin_states[i]]
        && alpha[fin_states[i]] + fin_w[i] <= bound) {
      out_final_states[nf] = (int32_t)remap[fin_states[i]];
      out_final_w[nf] = fin_w[i];
      ++nf;
    }
  }
  *n_finals = nf;
  *n_states_out = ns;
  return k;
}

}  // extern "C"
