// Chain (LF-MMI) denominator forward-backward for Hopper (sm_90a).
//
// Replaces kaldi_tpu/am/chain.py `denominator_logprob`, which on the TPU
// is not a Pallas kernel but an XLA program: a lax.scan whose step is a
// dense (B,S) x (S,S) log-space product over the entry-transition matrix
// (the MXU's shape), differentiated by jax.grad.  At the bench graph (41
// phones, trigram phone LM: S = 1553 states, A = 65,226 arcs) that matrix
// is 2.7% dense.  The card's route is upstream Kaldi's chain-kernels.cu:
// recurse over the arcs, in linear space with a per-frame scale.
//
// Function (per sequence b, frames t < T, pdfs P):
//   alpha_0[s]  = init[s] (e_0[self(s)] + e_0[entry(s)])
//   alpha_t[d]  = sum over arcs s->d of alpha_{t-1}[s] w e_t[pdf]   (t >= 1)
//   leak:         alpha_t += c init sum(alpha_t)
//   log Z       = log sum_s alpha_{T-1}[s] final[s]
// with e_t[p] = exp(score[b,t,p] - m_t), m_t = max_p score[b,t,p], and
// alpha_t normalized to sum 1 after each frame; log Z collects
// m_t + log Z_t (Z_t the frame's sum after the leak).  A masked frame
// (t >= 1) copies alpha through and adds nothing, as in the original.
// The backward runs beta through the transposed step: beta_{T-1} = final
// / F (F = sum alpha_{T-1} final), gamma_t = beta_t + c (init . beta_t)
// (the leak's transpose), beta_{t-1}[s] = sum over arcs s->d of
// w e_t[pdf] gamma_t[d] / Z_t; the arc's occupancy alpha_{t-1}[s] w
// e_t[pdf] gamma_t[d] / Z_t is d log Z / d score[b,t,pdf] (frame 0: the
// state's init e_0 gamma_0 / Z_0, split between its self and entry pdf).
//
// What bounds it: per active frame a multiply-add per arc forward and
// about four operations per arc backward, float32 outside the tensor
// cores; at B = 128, T = 50 on the bench graph ~3.4 GFLOP against ~5 MB
// of scores, gradient and graph (tools/timing.py chain_den_bound): bound
// by operations.  What held the first version (one warp per state row,
// a chain of dependent L2 loads per row) at 0.5% of that bound was
// latency: about one L2 load in flight per warp.
//
// Design.  A block of 512 threads runs one sequence over all T frames;
// its alpha (or beta and gamma) sits in shared memory.  Each frame the
// block streams the whole arc table once, coalesced: arcs are sorted by
// their key (destination forward, source backward) and padded to a
// multiple of the block's 2048-arc step; an arc is 12 bytes (a key word:
// the key in 16 bits, scan bits above it; other state | pdf << 16;
// exp(logw)), so S and P are below 65536.  A thread takes 4 consecutive
// arcs a step as three 16-byte loads, issued a step ahead, computes each
// arc's term, and sums them by key: runs inside the thread in registers,
// runs across the warp's 128 arcs (one to four keys, ~42 arcs a key on
// the bench graph) by a segmented warp scan whose steps come with the
// arcs (sum_by_key); each piece of a run is added into shared memory
// (a_next[dst] forward, beta[src] backward) with one shared atomic, and
// into the frame's running sum.  A warp shuffles 6 times per 4 arcs.
// The backward adds each arc's occupancy into the sequence's (P,) row
// with an integer shared atomic, in fixed point (OCC_ONE); an occupancy
// that is not a number below OCC_LIMIT marks its frame, whose gradient
// row is then NaN.  The next frame's scores come in with cp.async (warp
// 0) while the current frame's arcs run, when P more floats fit.  A
// frame costs two barriers: one after the arc stream, one after the
// normalization.  The normalized alpha of every frame goes to global
// memory for the backward (B T S floats, 40 MB at B = 128, T = 50, S =
// 1553), with each frame's max score and Z_t; the backward reads
// alpha_{t-1}[src] per arc through L1 (a thread's arcs share one or two
// sources).  Float sums are taken in the order the atomics land.
//
// One sequence a block: blocks that ran 2, 4 or 8 sequences, each arc
// load serving all of them, took 1.6, 2.9 and 5.4 times as long at B =
// 128, T = 50 on the bench graph (PERF.md): the work per sequence, not
// the arc loads, sets a block's time.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

#define DEN_THREADS 512
#define DEN_WARPS (DEN_THREADS / 32)
// arcs a block streams per step, 4 a thread; ops/chain_den.py
// ARC_STRIDE pads to it
#define DEN_STRIDE (DEN_THREADS * 4)
#define FULL 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// A thread takes 4 consecutive arcs a step, so a warp takes 128.  The
// key word of a thread's first arc carries, above its key (bits 0-15),
// the steps of the warp scan over the threads' last runs (bit 16 + i:
// add the value of the lane 2^i below, which ends the same run), whether
// the lane's first run continues the lane below's last one though the
// lane holds a second key (KEY_CARRY), and whether the lane's last run
// ends in the warp there (KEY_TAIL).  The runs are the graph's, so
// ops/chain_den.py pack_arcs sets the bits once.
#define KEY_MASK 0xffffu
#define KEY_SCAN 16
#define KEY_CARRY (1u << 21)
#define KEY_TAIL (1u << 22)

// The backward sums occupancies in fixed point, 2^-30 a unit: a shared
// float atomic is a compare-and-swap loop, an integer one a single
// instruction.  A pdf's occupancy in a frame is at most 1 (they sum to
// 1), so a row never passes 2^30 of the 2^32 an unsigned holds; each add
// rounds by at most 2^-31, 65,536 of them by 3e-5 at worst.  An
// occupancy that is not below OCC_LIMIT (NaN or inf from the scores, or
// out of range) marks its frame through the barrier that ends the arc
// stream (__syncthreads_or), and the frame's gradient row is written
// NaN, as float sums would carry it.
#define OCC_ONE 1073741824.f
#define OCC_LIMIT 2.f

// The sums of a warp step's arcs by key: runs inside a thread summed in
// registers, runs across threads by a segmented warp scan (Hillis-Steele,
// steps from `bits`).  flush(key, sum) is called for each piece of a
// run; the pieces of a run add up to its sum.  Every lane takes part in
// every shuffle.
template <typename Flush>
__device__ __forceinline__ void sum_by_key(const unsigned (&k)[4],
                                           unsigned bits, const float (&v)[4],
                                           Flush&& flush) {
  float x = v[0], first = 0.f;
  bool split = false;   // the thread holds more than one key
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (k[i] != k[i - 1]) {
      if (split)
        flush(k[i - 1], x);
      else
        first = x;
      x = v[i];
      split = true;
    } else {
      x += v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float y = __shfl_up_sync(FULL, x, 1 << i);
    if ((bits >> (KEY_SCAN + i)) & 1u) x += y;
  }
  const float below = __shfl_up_sync(FULL, x, 1);
  if (split) flush(k[0], first + ((bits & KEY_CARRY) ? below : 0.f));
  if (bits & KEY_TAIL) flush(k[3], x);
}

// Each warp's sum of part into red[warp].
__device__ __forceinline__ void warp_partial(float part, float* red) {
  const float s = warp_sum(part);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
}

// The block's sum from red (after a barrier), in a fixed order.
__device__ __forceinline__ float block_total(const float* red) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < DEN_WARPS; ++w) s += red[w];
  return s;
}

// Warp 0 of the block: e[p] = exp(score[p] - m) for one frame's row, from
// the row in global memory or, with `pref`, from its copy in `raw` that
// this warp's lanes started with cp.async.  m is the row's max (found
// here and returned) when `find_max`, else `m_in`; `on` false gives e =
// 0.  Then, with `pref` and a next row, starts that row's copy.
__device__ __forceinline__ float exp_row(const float* __restrict__ row,
                                         const float* __restrict__ next,
                                         float* raw, float* e, int P,
                                         int pref, bool find_max, float m_in,
                                         bool on) {
  const int lane = threadIdx.x & 31;
  const float* src = row;
  if (pref) {
    kt::cp_async_wait<0>();
    src = raw;
  }
  float m = m_in;
  if (find_max) {
    m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, src[p]);
    m = warp_max(m);
  }
  for (int p = lane; p < P; p += 32) e[p] = on ? expf(src[p] - m) : 0.f;
  if (pref && next != nullptr) {
    for (int p = lane; p < P; p += 32) kt::cp_async4(raw + p, next + p);
    kt::cp_async_commit();
  }
  return m;
}

// Warp 0: starts the copy of `row` into `raw`.
__device__ __forceinline__ void fetch_row(const float* __restrict__ row,
                                          float* raw, int P) {
  for (int p = threadIdx.x & 31; p < P; p += 32)
    kt::cp_async4(raw + p, row + p);
  kt::cp_async_commit();
}

__global__ void __launch_bounds__(DEN_THREADS)
den_forward(const float* __restrict__ scores,           // (B, T, P)
            const unsigned char* __restrict__ mask,     // (B, T)
            const unsigned* __restrict__ in_key,        // (A) dst, scan bits
            const unsigned* __restrict__ in_op,         // (A) src | pdf << 16
            const float* __restrict__ in_w,             // (A) exp(logw)
            int A,                                      // padded to DEN_STRIDE
            const float* __restrict__ init,             // (S) exp(initial)
            const float* __restrict__ fin,              // (S) exp(final)
            const int* __restrict__ self_pdf,           // (S)
            const int* __restrict__ entry_pdf,          // (S)
            int T, int S, int P, float leak, float leak_norm, int pref,
            float* __restrict__ alpha,                  // (B, T, S)
            float* __restrict__ zt,                     // (B, T)
            float* __restrict__ mt,                     // (B, T)
            float* __restrict__ fsum,                   // (B)
            float* __restrict__ logz) {                 // (B)
  extern __shared__ float sh[];
  float* a_prev = sh;                  // [S]
  float* a_next = a_prev + S;          // [S], zero between frames
  float* e = a_next + S;               // [P]
  float* red = e + P;                  // [DEN_WARPS]
  float* mxs = red + DEN_WARPS;        // [2], by frame parity
  float* raw = mxs + 2;                // [P] with pref
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n_steps = A / DEN_STRIDE;
  const float* sc = scores + (size_t)b * T * P;   // frame t's row: sc + t P
  float* al = alpha + (size_t)b * T * S;
  double logc = 0.0;

  // frame 0
  for (int s = tid; s < S; s += DEN_THREADS) a_next[s] = 0.f;
  if (warp == 0) {
    const float m = exp_row(sc, nullptr, raw, e, P, 0, true, 0.f, true);
    if (lane == 0) mxs[0] = m;
    if (pref && T > 1) fetch_row(sc + P, raw, P);
  }
  __syncthreads();
  {
    float part = 0.f;
    for (int s = tid; s < S; s += DEN_THREADS) {
      const float v = init[s] * (e[self_pdf[s]] + e[entry_pdf[s]]);
      a_prev[s] = v;
      part += v;
    }
    warp_partial(part, red);
  }
  __syncthreads();
  {
    const float tot = block_total(red);
    const float Z = tot * leak_norm, inv = 1.f / Z, lt = leak * tot;
    for (int s = tid; s < S; s += DEN_THREADS) {
      const float v = (a_prev[s] + lt * init[s]) * inv;
      a_prev[s] = v;
      al[s] = v;
    }
    if (tid == 0) {
      logc += (double)mxs[0] + log((double)Z);
      zt[(size_t)b * T] = Z;
      mt[(size_t)b * T] = mxs[0];
    }
  }
  if (warp == 0 && T > 1) {
    const float m = exp_row(sc + P, T > 2 ? sc + 2 * (size_t)P : nullptr,
                            raw, e, P, pref, true, 0.f, true);
    if (lane == 0) mxs[1] = m;
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const bool on = mask[(size_t)b * T + t];
    // 1. the arc stream: a_next[d] += a_prev[s] w e[pdf] for every arc
    if (on) {
      float part = 0.f;
      const uint4* kq = reinterpret_cast<const uint4*>(in_key) + tid;
      const uint4* oq = reinterpret_cast<const uint4*>(in_op) + tid;
      const float4* wq = reinterpret_cast<const float4*>(in_w) + tid;
      auto flush = [&](unsigned key, float sum) {
        atomicAdd(a_next + key, sum);
        part += sum;
      };
      // the next step's arcs load while this step's are summed
      uint4 kn = __ldg(kq), on_ = __ldg(oq);
      float4 wn = __ldg(wq);
      for (int st = 0; st < n_steps; ++st) {
        const uint4 kc = kn, oc = on_;
        const float4 wc = wn;
        if (st + 1 < n_steps) {
          const int nx = (st + 1) * DEN_THREADS;
          kn = __ldg(kq + nx);
          on_ = __ldg(oq + nx);
          wn = __ldg(wq + nx);
        }
        const unsigned k[4] = {kc.x & KEY_MASK, kc.y & KEY_MASK,
                               kc.z & KEY_MASK, kc.w & KEY_MASK};
        const unsigned op[4] = {oc.x, oc.y, oc.z, oc.w};
        const float w[4] = {wc.x, wc.y, wc.z, wc.w};
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = op[i] & 0xffffu, pdf = op[i] >> 16;
          v[i] = a_prev[src] * w[i] * e[pdf];
        }
        sum_by_key(k, kc.x, v, flush);
      }
      warp_partial(part, red);
    }
    __syncthreads();
    // 2. the leak and the normalization; a masked frame keeps alpha
    {
      const float tot = block_total(red);
      const float Z = tot * leak_norm, inv = 1.f / Z, lt = leak * tot;
      float* al_t = al + (size_t)t * S;
      for (int s = tid; s < S; s += DEN_THREADS) {
        float v = a_prev[s];
        if (on) {
          v = (a_next[s] + lt * init[s]) * inv;
          a_prev[s] = v;
          a_next[s] = 0.f;
        }
        al_t[s] = v;
      }
      if (tid == 0) {
        const float mx = mxs[t & 1];
        if (on) logc += (double)mx + log((double)Z);
        zt[(size_t)b * T + t] = on ? Z : 1.f;
        mt[(size_t)b * T + t] = on ? mx : 0.f;
      }
    }
    // 3. the next frame's e (its scores arrived during the arc stream)
    if (warp == 0 && t + 1 < T) {
      const float m = exp_row(sc + (size_t)(t + 1) * P,
                              t + 2 < T ? sc + (size_t)(t + 2) * P : nullptr,
                              raw, e, P, pref, true, 0.f, true);
      if (lane == 0) mxs[(t + 1) & 1] = m;
    }
    __syncthreads();
  }

  float part = 0.f;
  for (int s = tid; s < S; s += DEN_THREADS) part += a_prev[s] * fin[s];
  warp_partial(part, red);
  __syncthreads();
  if (tid == 0) {
    const float F = block_total(red);
    fsum[b] = F;
    logz[b] = (float)(logc + log((double)F));
  }
}

__global__ void __launch_bounds__(DEN_THREADS)
den_backward(const float* __restrict__ scores,            // (B, T, P)
             const unsigned char* __restrict__ mask,      // (B, T)
             const unsigned* __restrict__ out_key,        // (A) src, scan bits
             const unsigned* __restrict__ out_op,         // (A) dst | pdf << 16
             const float* __restrict__ out_w,             // (A) exp(logw)
             int A,                                       // padded
             const float* __restrict__ init,              // (S)
             const float* __restrict__ fin,               // (S)
             const int* __restrict__ self_pdf,            // (S)
             const int* __restrict__ entry_pdf,           // (S)
             int T, int S, int P, float leak, int pref,
             const float* __restrict__ alpha,             // (B, T, S)
             const float* __restrict__ zt,                // (B, T)
             const float* __restrict__ mt,                // (B, T)
             const float* __restrict__ fsum,              // (B)
             const float* __restrict__ gout,              // (B)
             float* __restrict__ grad) {                  // (B, T, P)
  extern __shared__ float sh[];
  float* beta = sh;                    // [S]: beta_t, then beta_{t-1}'s sums
  float* gam = beta + S;               // [S]
  float* e = gam + S;                  // [P]
  float* red = e + P;                  // [DEN_WARPS]
  // [P] occupancies in fixed point, zero between frames
  unsigned* occ = reinterpret_cast<unsigned*>(red + DEN_WARPS);
  float* raw = reinterpret_cast<float*>(occ + P);   // [P] with pref
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n_steps = A / DEN_STRIDE;
  const float* sc = scores + (size_t)b * T * P;   // frame t's row: sc + t P
  const float* al = alpha + (size_t)b * T * S;
  const unsigned char* mk = mask + (size_t)b * T;
  const float* zb = zt + (size_t)b * T;
  const float* mb = mt + (size_t)b * T;
  auto active = [&](int t) { return t == 0 || mk[t] != 0; };
  // an occupancy (in [0, 1]) into the row; `out` notes one that is not
  // (its add is then garbage, and the row is written NaN)
  auto occupy = [&](int pdf, float x, bool& out) {
    atomicAdd(occ + pdf, __float2uint_rn(x * OCC_ONE));
    out |= !(x < OCC_LIMIT);
  };
  const float go = gout[b];

  // Frame t's occupancies, times gout, into the gradient (zero where
  // masked, NaN where one was out of range); the row back to zero.
  auto write_grad = [&](int t, bool flagged) {
    const bool on = active(t);
    float* gr = grad + ((size_t)b * T + t) * P;
    for (int p = tid; p < P; p += DEN_THREADS) {
      const unsigned s = occ[p];
      occ[p] = 0;
      gr[p] = !on ? 0.f : flagged ? NAN : (float)s * (go / OCC_ONE);
    }
  };

  // beta_{T-1} = final / F, its leak term, gamma_{T-1}
  {
    const float invF = 1.f / fsum[b];
    float part = 0.f;
    for (int s = tid; s < S; s += DEN_THREADS) {
      const float v = fin[s] * invF;
      beta[s] = v;
      part += init[s] * v;
    }
    warp_partial(part, red);
  }
  for (int p = tid; p < P; p += DEN_THREADS) occ[p] = 0;
  if (warp == 0) {
    exp_row(sc + (size_t)(T - 1) * P, nullptr, raw, e, P, 0, false,
            mb[T - 1], active(T - 1));
    if (pref && T > 1) fetch_row(sc + (size_t)(T - 2) * P, raw, P);
  }
  __syncthreads();
  float lb = leak * block_total(red);
  {
    const bool clear = T - 1 >= 1 && active(T - 1);
    for (int s = tid; s < S; s += DEN_THREADS) {
      gam[s] = beta[s] + lb;
      if (clear) beta[s] = 0.f;
    }
  }
  __syncthreads();

  for (int t = T - 1; t >= 1; --t) {
    const bool on = active(t);
    const float invZ = 1.f / zb[t];
    const float* ap = al + (size_t)(t - 1) * S;   // alpha_{t-1}
    // 1. the arc stream: beta_{t-1}[s] += w e[pdf] gamma[d] / Z_t, and
    //    each arc's occupancy alpha_{t-1}[s] w e[pdf] gamma[d] / Z_t
    bool out = false;   // an occupancy out of range
    if (on) {
      float part = 0.f;
      const uint4* kq = reinterpret_cast<const uint4*>(out_key) + tid;
      const uint4* oq = reinterpret_cast<const uint4*>(out_op) + tid;
      const float4* wq = reinterpret_cast<const float4*>(out_w) + tid;
      auto flush = [&](unsigned key, float sum) {
        const float bn = sum * invZ;
        atomicAdd(beta + key, bn);
        part += init[key] * bn;
      };
      uint4 kn = __ldg(kq), on_ = __ldg(oq);
      float4 wn = __ldg(wq);
      for (int st = 0; st < n_steps; ++st) {
        const uint4 kc = kn, oc = on_;
        const float4 wc = wn;
        if (st + 1 < n_steps) {
          const int nx = (st + 1) * DEN_THREADS;
          kn = __ldg(kq + nx);
          on_ = __ldg(oq + nx);
          wn = __ldg(wq + nx);
        }
        const unsigned k[4] = {kc.x & KEY_MASK, kc.y & KEY_MASK,
                               kc.z & KEY_MASK, kc.w & KEY_MASK};
        const unsigned op[4] = {oc.x, oc.y, oc.z, oc.w};
        const float w[4] = {wc.x, wc.y, wc.z, wc.w};
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dst = op[i] & 0xffffu, pdf = op[i] >> 16;
          v[i] = w[i] * e[pdf] * gam[dst];
          occupy(pdf, __ldg(ap + k[i]) * v[i] * invZ, out);
        }
        sum_by_key(k, kc.x, v, flush);
      }
      warp_partial(part, red);
    }
    const bool flagged = __syncthreads_or(out);
    // 2. frame t's gradient row; beta_{t-1}'s leak term and gamma_{t-1};
    //    a masked frame passes beta through
    write_grad(t, flagged);
    if (on) lb = leak * block_total(red);
    const bool clear = t - 1 >= 1 && active(t - 1);
    for (int s = tid; s < S; s += DEN_THREADS) {
      gam[s] = beta[s] + lb;
      if (clear) beta[s] = 0.f;
    }
    // 3. frame t-1's e (its scores arrived during the arc stream)
    if (warp == 0)
      exp_row(sc + (size_t)(t - 1) * P,
              t >= 2 ? sc + (size_t)(t - 2) * P : nullptr, raw, e, P, pref,
              false, mb[t - 1], active(t - 1));
    __syncthreads();
  }

  // frame 0: each state's init e_0 gamma_0 / Z_0, to its self and entry pdf
  {
    const float iz = 1.f / zb[0];
    bool out = false;
    for (int s = tid; s < S; s += DEN_THREADS) {
      const float c = init[s] * gam[s] * iz;
      const int sp = self_pdf[s], ep = entry_pdf[s];
      occupy(sp, c * e[sp], out);
      occupy(ep, c * e[ep], out);
    }
    write_grad(0, __syncthreads_or(out));
  }
}

// Shared memory of a block (bytes): alpha and its next frame (or beta
// and gamma), e, the block sums, the forward's max scores by parity (the
// backward's occupancy row), the prefetched scores.
extern "C" int kt_chain_den_smem_bytes(int backward, int S, int P,
                                       int pref) {
  const int per = backward ? 2 * S + 2 * P + DEN_WARPS
                           : 2 * S + P + DEN_WARPS + 2;
  return (per + (pref ? P : 0)) * (int)sizeof(float);
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Largest dynamic shared memory a block may use on this device (bytes).
extern "C" int kt_chain_den_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

static bool bad_args(int B, int T, int S, int P, int A) {
  return B <= 0 || T <= 0 || S <= 0 || S > 65535 || P <= 0 || P > 65535 ||
         A <= 0 || A % DEN_STRIDE != 0;
}

// One block a sequence; pref: the next frame's scores by cp.async; A the
// arc count padded to a multiple of DEN_STRIDE (padding arcs carry
// weight 0 and the last arc's key).
extern "C" cudaError_t kt_chain_den_forward(
    const float* scores, const unsigned char* mask,
    const unsigned* in_key, const unsigned* in_op, const float* in_w,
    int A, const float* init, const float* fin, const int* self_pdf,
    const int* entry_pdf, int B, int T, int S, int P, float leak,
    float leak_norm, int pref, float* alpha, float* zt, float* mt,
    float* fsum, float* logz, cudaStream_t stream) {
  if (bad_args(B, T, S, P, A)) return cudaErrorInvalidValue;
  const size_t smem = kt_chain_den_smem_bytes(0, S, P, pref);
  cudaError_t err = allow_smem(den_forward, smem);
  if (err != cudaSuccess) return err;
  den_forward<<<B, DEN_THREADS, smem, stream>>>(
      scores, mask, in_key, in_op, in_w, A, init, fin, self_pdf, entry_pdf,
      T, S, P, leak, leak_norm, pref, alpha, zt, mt, fsum, logz);
  return cudaGetLastError();
}

extern "C" cudaError_t kt_chain_den_backward(
    const float* scores, const unsigned char* mask,
    const unsigned* out_key, const unsigned* out_op, const float* out_w,
    int A, const float* init, const float* fin, const int* self_pdf,
    const int* entry_pdf, int B, int T, int S, int P, float leak, int pref,
    const float* alpha, const float* zt, const float* mt,
    const float* fsum, const float* gout, float* grad, cudaStream_t stream) {
  if (bad_args(B, T, S, P, A)) return cudaErrorInvalidValue;
  const size_t smem = kt_chain_den_smem_bytes(1, S, P, pref);
  cudaError_t err = allow_smem(den_backward, smem);
  if (err != cudaSuccess) return err;
  den_backward<<<B, DEN_THREADS, smem, stream>>>(
      scores, mask, out_key, out_op, out_w, A, init, fin, self_pdf,
      entry_pdf, T, S, P, leak, pref, alpha, zt, mt, fsum, gout, grad);
  return cudaGetLastError();
}
