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
// by operations.
//
// Design (first, simple version).  One block of 512 threads per sequence
// walks all T frames; alpha (forward) or beta and gamma (backward) for
// the current frame sit in shared memory, 2 S floats (12 KB at S = 1553).
// Each warp takes one destination state (forward, CSR of incoming arcs)
// or one source state (backward, CSR of outgoing arcs) at a time, its
// lanes over the row's arcs, and sums by shuffles: arc reads coalesce and
// the 0.5 MB arc table stays in L2 for every block and frame.  An arc is
// 8 bytes: (state | pdf << 16) and exp(logw), so S and P are below 65536.
// The normalized alpha of every frame goes to global memory for the
// backward (B T S floats, 40 MB at B = 128, T = 50, S = 1553), with each
// frame's max score and Z_t.  The backward scatters occupancies into a
// shared (P,) row with shared-memory atomics and writes the gradient row,
// times the incoming gradient of log Z, once per frame (zeros on masked
// frames).  At B below the SM count the card is part idle: a later
// version splits a sequence's states over a cluster.

#include <cuda_runtime.h>
#include <math.h>

#define DEN_THREADS 512
#define DEN_WARPS (DEN_THREADS / 32)
// shared floats of the block reductions (one per warp + the result)
#define DEN_RED (DEN_WARPS + 1)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (MAX = false) or max of v, returned to every thread.
// Starts with a barrier, so red[] may be reused by consecutive calls and
// shared writes made before the call are visible after it.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < DEN_WARPS ? red[lane] : (MAX ? -INFINITY : 0.f);
    x = MAX ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[DEN_WARPS] = x;
  }
  __syncthreads();
  return red[DEN_WARPS];
}

// e[p] = exp(score[p] - max) for one frame's row; returns the max.
__device__ float load_exp_scores(const float* __restrict__ row, int P,
                                 float* e, float* red) {
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < P; p += DEN_THREADS) {
    const float v = row[p];
    e[p] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce<true>(mx, red);
  for (int p = threadIdx.x; p < P; p += DEN_THREADS) e[p] = expf(e[p] - mx);
  __syncthreads();
  return mx;
}

__global__ void __launch_bounds__(DEN_THREADS)
den_forward(const float* __restrict__ scores,        // (B, T, P)
            const unsigned char* __restrict__ mask,  // (B, T)
            const int* __restrict__ in_ptr,          // (S + 1)
            const unsigned* __restrict__ in_sp,      // (A) src | pdf << 16
            const float* __restrict__ in_w,          // (A) exp(logw)
            const float* __restrict__ init,          // (S) exp(initial)
            const float* __restrict__ fin,           // (S) exp(final)
            const int* __restrict__ self_pdf,        // (S)
            const int* __restrict__ entry_pdf,       // (S)
            int T, int S, int P, float leak, float leak_norm,
            float* __restrict__ alpha,               // (B, T, S)
            float* __restrict__ zt,                  // (B, T)
            float* __restrict__ mt,                  // (B, T)
            float* __restrict__ fsum,                // (B)
            float* __restrict__ logz) {              // (B)
  extern __shared__ float sh[];
  float* a_prev = sh;
  float* a_next = sh + S;
  float* e = sh + 2 * S;
  float* red = e + P;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* sc = scores + (size_t)b * T * P;
  float* al = alpha + (size_t)b * T * S;
  double logc = 0.0;
  for (int t = 0; t < T; ++t) {
    float* al_t = al + (size_t)t * S;
    if (t > 0 && !mask[(size_t)b * T + t]) {
      for (int s = tid; s < S; s += DEN_THREADS) al_t[s] = a_prev[s];
      if (tid == 0) {
        zt[(size_t)b * T + t] = 1.f;
        mt[(size_t)b * T + t] = 0.f;
      }
      continue;
    }
    const float mx = load_exp_scores(sc + (size_t)t * P, P, e, red);
    float part = 0.f;
    if (t == 0) {
      for (int s = tid; s < S; s += DEN_THREADS) {
        const float v = init[s] * (e[self_pdf[s]] + e[entry_pdf[s]]);
        a_next[s] = v;
        part += v;
      }
    } else {
      for (int d = warp; d < S; d += DEN_WARPS) {
        float acc = 0.f;
        for (int a = in_ptr[d] + lane; a < in_ptr[d + 1]; a += 32) {
          const unsigned sp = in_sp[a];
          acc += a_prev[sp & 0xffffu] * in_w[a] * e[sp >> 16];
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          a_next[d] = acc;
          part += acc;
        }
      }
    }
    const float tot = block_reduce<false>(part, red);
    // the leak adds c init[s] tot; the frame's sum becomes tot leak_norm
    // with leak_norm = 1 + c sum(init)
    const float Z = tot * leak_norm;
    const float inv = 1.f / Z;
    const float lt = leak * tot;
    for (int s = tid; s < S; s += DEN_THREADS) {
      const float v = (a_next[s] + lt * init[s]) * inv;
      a_prev[s] = v;
      al_t[s] = v;
    }
    logc += (double)mx + log((double)Z);
    if (tid == 0) {
      zt[(size_t)b * T + t] = Z;
      mt[(size_t)b * T + t] = mx;
    }
    __syncthreads();
  }
  float part = 0.f;
  for (int s = tid; s < S; s += DEN_THREADS) part += a_prev[s] * fin[s];
  const float F = block_reduce<false>(part, red);
  if (tid == 0) {
    fsum[b] = F;
    logz[b] = (float)(logc + log((double)F));
  }
}

__global__ void __launch_bounds__(DEN_THREADS)
den_backward(const float* __restrict__ scores,        // (B, T, P)
             const unsigned char* __restrict__ mask,  // (B, T)
             const int* __restrict__ out_ptr,         // (S + 1)
             const unsigned* __restrict__ out_dp,     // (A) dst | pdf << 16
             const float* __restrict__ out_w,         // (A) exp(logw)
             const float* __restrict__ init,          // (S)
             const float* __restrict__ fin,           // (S)
             const int* __restrict__ self_pdf,        // (S)
             const int* __restrict__ entry_pdf,       // (S)
             int T, int S, int P, float leak,
             const float* __restrict__ alpha,         // (B, T, S)
             const float* __restrict__ zt,            // (B, T)
             const float* __restrict__ mt,            // (B, T)
             const float* __restrict__ fsum,          // (B)
             const float* __restrict__ gout,          // (B)
             float* __restrict__ grad) {              // (B, T, P)
  extern __shared__ float sh[];
  float* beta = sh;
  float* gam = sh + S;
  float* e = sh + 2 * S;
  float* g = e + P;
  float* red = g + P;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* sc = scores + (size_t)b * T * P;
  const float* al = alpha + (size_t)b * T * S;
  const float go = gout[b];
  const float invF = 1.f / fsum[b];
  for (int s = tid; s < S; s += DEN_THREADS) beta[s] = fin[s] * invF;
  for (int t = T - 1; t >= 0; --t) {
    float* gr = grad + ((size_t)b * T + t) * P;
    if (t > 0 && !mask[(size_t)b * T + t]) {
      for (int p = tid; p < P; p += DEN_THREADS) gr[p] = 0.f;
      continue;
    }
    float part = 0.f;
    for (int s = tid; s < S; s += DEN_THREADS) part += init[s] * beta[s];
    const float lb = leak * block_reduce<false>(part, red);
    for (int s = tid; s < S; s += DEN_THREADS) gam[s] = beta[s] + lb;
    const float m = mt[(size_t)b * T + t];
    const float* row = sc + (size_t)t * P;
    for (int p = tid; p < P; p += DEN_THREADS) {
      e[p] = expf(row[p] - m);
      g[p] = 0.f;
    }
    __syncthreads();
    const float invZ = 1.f / zt[(size_t)b * T + t];
    if (t == 0) {
      for (int s = tid; s < S; s += DEN_THREADS) {
        const float c = init[s] * gam[s] * invZ;
        atomicAdd(&g[self_pdf[s]], c * e[self_pdf[s]]);
        atomicAdd(&g[entry_pdf[s]], c * e[entry_pdf[s]]);
      }
    } else {
      const float* ap = al + (size_t)(t - 1) * S;
      for (int s = warp; s < S; s += DEN_WARPS) {
        const float as = ap[s] * invZ;
        float acc = 0.f;
        for (int a = out_ptr[s] + lane; a < out_ptr[s + 1]; a += 32) {
          const unsigned dp = out_dp[a];
          const float v = out_w[a] * e[dp >> 16] * gam[dp & 0xffffu];
          acc += v;
          atomicAdd(&g[dp >> 16], as * v);
        }
        acc = warp_sum(acc);
        // beta is read again only after the next frame's first barrier
        if (lane == 0) beta[s] = acc * invZ;
      }
    }
    __syncthreads();
    for (int p = tid; p < P; p += DEN_THREADS) gr[p] = g[p] * go;
  }
}

static size_t fwd_smem(int S, int P) {
  return (size_t)(2 * S + P + DEN_RED) * sizeof(float);
}

static size_t bwd_smem(int S, int P) {
  return (size_t)(2 * S + 2 * P + DEN_RED) * sizeof(float);
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

extern "C" cudaError_t kt_chain_den_forward(
    const float* scores, const unsigned char* mask, const int* in_ptr,
    const unsigned* in_sp, const float* in_w, const float* init,
    const float* fin, const int* self_pdf, const int* entry_pdf, int B,
    int T, int S, int P, float leak, float leak_norm, float* alpha,
    float* zt, float* mt, float* fsum, float* logz, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > 65535 || P <= 0 || P > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(S, P);
  cudaError_t err = allow_smem(den_forward, smem);
  if (err != cudaSuccess) return err;
  den_forward<<<B, DEN_THREADS, smem, stream>>>(
      scores, mask, in_ptr, in_sp, in_w, init, fin, self_pdf, entry_pdf, T,
      S, P, leak, leak_norm, alpha, zt, mt, fsum, logz);
  return cudaGetLastError();
}

extern "C" cudaError_t kt_chain_den_backward(
    const float* scores, const unsigned char* mask, const int* out_ptr,
    const unsigned* out_dp, const float* out_w, const float* init,
    const float* fin, const int* self_pdf, const int* entry_pdf, int B,
    int T, int S, int P, float leak, const float* alpha, const float* zt,
    const float* mt, const float* fsum, const float* gout, float* grad,
    cudaStream_t stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > 65535 || P <= 0 || P > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(S, P);
  cudaError_t err = allow_smem(den_backward, smem);
  if (err != cudaSuccess) return err;
  den_backward<<<B, DEN_THREADS, smem, stream>>>(
      scores, mask, out_ptr, out_dp, out_w, init, fin, self_pdf, entry_pdf,
      T, S, P, leak, alpha, zt, mt, fsum, gout, grad);
  return cudaGetLastError();
}
