// Diagonal-GMM log-likelihood kernel for Hopper (sm_90a), on the tensor
// cores through wgmma.
//
// Replaces the TPU kernel in kaldi_tpu/ops/pallas_gmm.py, `_kernel`
// (the pl.pallas_call in gmm_loglikes_pallas):
//
//   out[t, p] = logsumexp_m( g[m, p] + x_t . a[m, :, p] + x_t^2 . b[m, :, p] )
//
// with a = mu/var, b = -1/(2 var) and g the Gaussian's log-constant.
// Unused mixture slots carry g = -1e30 and vanish in the logsumexp.
//
// What bounds it: per (frame, live Gaussian) 4*D float32 operations, two
// products of depth D; at the mini_librispeech tri3b width (2500 pdfs,
// 15,000 live Gaussians, D = 40) 0.72 GFLOP at 300 frames against 7.9 MB
// of parameters, features and output: compute-bound.  The least time
// that keeps float32 accuracy is 3xTF32 on the tensor cores (165 TFLOP/s
// of float32-equivalent work, tf32x3.cuh): 0.0044 ms at 300 frames,
// 0.0596 ms at 4096.  The kernel does the padded slots' work too (25,000
// slots at that width).
//
// Design.  Stack x~ = [x | x^2] as (T x K), K = 2*Dp, Dp = D rounded up
// to 8; then slot m's two products are one matrix product x~ . W_m with
// W_m = [a_m; b_m] (K x P), taken in 3xTF32 as three wgmma per k-step of
// 8.  A block covers 128 frames x 64 pdfs with two warpgroups, 64 frames
// each; a warp's A fragments (16 frames, all k-steps, hi and lo) are
// split once into registers and serve every slot, since x~ does not
// change between slots.  W_m's tile and the slot's 64 gconsts come laid
// out and split into hi/lo on the host, once per model (ops/gmm.py
// kernel_layout), as wgmma's K-major core matrices, one contiguous 40 KB
// run per (pdf tile, slot): slot m+1's run streams into the second of two
// shared-memory buffers with cp.async while slot m computes, and both
// warpgroups read each tile straight from shared memory.  After each
// slot's products the accumulators take g and update each element's
// running (max, sum) of the online logsumexp in registers: the
// accumulator layout is the same for every slot, so each thread keeps its
// (t, p) elements across the slot loop, as the TPU kernel keeps its
// per-slot MXU products in VMEM.  The running max starts at the finite
// sentinel -1e30, never -INFINITY, so a padded slot never makes
// (-inf) - (-inf); one __expf per element and slot (the larger of the two
// terms is exp(0); its relative error, ~1e-6 at the arguments that count,
// is far inside the 1e-4 bar).  The output tile goes through shared
// memory and leaves as coalesced rows.
//
// Shaped by ptxas (chip_smoke prints its report): the A fragments (8
// registers a k-step: 80 at D = 40), 32 accumulators and 64 running
// (max, sum) values take 229 registers at D = 40 without spills, so one
// block of 8 warps fits an SM; above D = 48 the fragments spill.  Shared
// memory is 2 x 40 KB of slot buffers and 42 KB of x~ staging at D = 40.
// One warpgroup per block, two blocks per SM, ran no faster.  The same design on mma.sync moved every A and B fragment
// through the register file at each k-step and slot and ran slower;
// wgmma reads B from shared memory itself.  The next steps are TMA with
// mbarriers, so that the two warpgroups need not meet at a barrier every
// slot, and skipping padded slots (PERF.md).

#include <cuda_runtime.h>

#include "tf32x3.cuh"

#define GMM_PT 64       // pdfs per block
#define GMM_WG 2        // warpgroups per block, 64 frames each
#define GMM_TT (64 * GMM_WG)
#define GMM_THREADS (128 * GMM_WG)
#define GMM_DMAX 64     // largest feature dimension
#define GMM_OS 68       // row stride of the output tile in shared memory

// KS k-steps of 8 over x~ (Dp = 4 KS)
template <int KS>
__global__ void __launch_bounds__(GMM_THREADS) gmm_loglikes_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ out, int T, int D,
    int P, int M) {
  constexpr int Dp = 4 * KS, SX = 8 * KS + 4;
  constexpr int tile = KS * 1024;       // one slot's W tile, in floats
  constexpr int stage = tile + GMM_PT;  // + the slot's 64 gconsts
  extern __shared__ __align__(128) float smem[];
  float* wb = smem;                     // [2][stage]
  float* xs = smem + 2 * stage;         // [GMM_TT][SX] x~ staging
  const int t0 = blockIdx.x * GMM_TT, pt = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* wt = w + (size_t)pt * M * tile;
  const float* gt = g + (size_t)pt * M * GMM_PT;

  auto issue_slot = [&](int m, int buf) {
    float* dst = wb + buf * stage;
    for (int i = tid; i < stage / 4; i += GMM_THREADS) {
      const float* src = i < tile / 4
                             ? wt + (size_t)m * tile + 4 * i
                             : gt + (size_t)m * GMM_PT + 4 * (i - tile / 4);
      kt::cp_async16(dst + 4 * i, src);
    }
  };

  // 1. x rows of the tile (columns [0, D)), then slot 0's tile
  for (int i = tid; i < GMM_TT * D; i += GMM_THREADS) {
    const int r = i / D, c = i - r * D;
    if (t0 + r < T)
      kt::cp_async4(xs + r * SX + c, x + (size_t)(t0 + r) * D + c);
  }
  kt::cp_async_commit();
  issue_slot(0, 0);
  kt::cp_async_commit();
  kt::cp_async_wait<1>();
  __syncthreads();
  // x~ = [x | x^2], zero past D and past T (each thread reads only the
  // elements it writes)
  for (int i = tid; i < GMM_TT * Dp; i += GMM_THREADS) {
    const int r = i / Dp, c = i - r * Dp;
    const float v = (t0 + r < T && c < D) ? xs[r * SX + c] : 0.f;
    xs[r * SX + c] = v;
    xs[r * SX + Dp + c] = v * v;
  }
  __syncthreads();
  // 2. this warp's A fragments (16 frames), every k-step, split once
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
    kt::load_a_split(xs, SX, 16 * warp, 8 * s, lane, ah[s], al[s]);

  // 3. the slot loop: 3xTF32 products, + g, online logsumexp
  const int gid = lane >> 2, tig = lane & 3;
  float acc[32], mx[32], sm[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    mx[e] = -1e30f;
    sm[e] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    if (m + 1 < M) issue_slot(m + 1, (m + 1) & 1);
    kt::cp_async_commit();
    kt::cp_async_wait<1>();
    kt::fence_proxy_async();
    __syncthreads();
    const float* wcur = wb + (m & 1) * stage;
    kt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // per k-step the hi tile, then the lo tile, 2 KB each
      const uint64_t hi = kt::wgmma_desc(wcur + (2 * s) * 512);
      const uint64_t lo = kt::wgmma_desc(wcur + (2 * s + 1) * 512);
      kt::wgmma_m64n64k8(acc, al[s], hi, s > 0);
      kt::wgmma_m64n64k8(acc, ah[s], lo, 1);
      kt::wgmma_m64n64k8(acc, ah[s], hi, 1);
    }
    kt::wgmma_commit_and_wait();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float g0 = wcur[tile + col], g1 = wcur[tile + col + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * j + i;
        const float v = acc[e] + ((i & 1) ? g1 : g0);
        const float old = mx[e];
        const float d = __expf(-fabsf(v - old));
        const bool up = v > old;
        sm[e] = up ? fmaf(sm[e], d, 1.f) : sm[e] + d;
        mx[e] = up ? v : old;
      }
    }
    __syncthreads();   // before this buffer is refilled
  }

  // 4. the tile through shared memory, then coalesced rows
  float* os = smem;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + gid + ((i & 2) ? 8 : 0);
      const int c = 8 * j + 2 * tig + (i & 1);
      os[r * GMM_OS + c] = mx[4 * j + i] + logf(sm[4 * j + i]);
    }
  __syncthreads();
  const int p0 = pt * GMM_PT;
  if ((P & 3) == 0 && p0 + GMM_PT <= P) {
    for (int i = tid; i < GMM_TT * (GMM_PT / 4); i += GMM_THREADS) {
      const int r = i / (GMM_PT / 4), c = 4 * (i - r * (GMM_PT / 4));
      if (t0 + r < T)
        *reinterpret_cast<float4*>(out + (size_t)(t0 + r) * P + p0 + c) =
            *reinterpret_cast<const float4*>(os + r * GMM_OS + c);
    }
  } else {
    for (int i = tid; i < GMM_TT * GMM_PT; i += GMM_THREADS) {
      const int r = i / GMM_PT, c = i - r * GMM_PT;
      if (t0 + r < T && p0 + c < P)
        out[(size_t)(t0 + r) * P + p0 + c] = os[r * GMM_OS + c];
    }
  }
}

template <int KS>
static cudaError_t launch(const float* x, const float* w, const float* g,
                          float* out, int T, int D, int P, int M,
                          cudaStream_t stream) {
  const dim3 grid((T + GMM_TT - 1) / GMM_TT, (P + GMM_PT - 1) / GMM_PT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // two slot buffers, then the x~ staging; the output tile reuses them
  size_t n = (size_t)2 * (KS * 1024 + GMM_PT) + GMM_TT * (8 * KS + 4);
  if (n < (size_t)GMM_TT * GMM_OS) n = (size_t)GMM_TT * GMM_OS;
  const size_t smem = n * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_loglikes_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  gmm_loglikes_kernel<KS><<<grid, GMM_THREADS, smem, stream>>>(x, w, g, out,
                                                               T, D, P, M);
  return cudaGetLastError();
}

// x (T, D); w (ceil(P/64), M, Dp / 4 * 1024) and g (ceil(P/64), M, 64) in
// kernel_layout's order, Dp = D rounded up to 8; out (T, P); all float32,
// contiguous, on the device.  Launches on `stream` and returns the launch
// status (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" cudaError_t kt_gmm_loglikes(const float* x, const float* w,
                                       const float* g, float* out, int T,
                                       int D, int Dp, int P, int M,
                                       cudaStream_t stream) {
  if (D <= 0 || D > GMM_DMAX || Dp < D || Dp > GMM_DMAX || Dp % 8 != 0 ||
      M <= 0 || P <= 0 || T < 0)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  switch (Dp / 4) {
    case 2: return launch<2>(x, w, g, out, T, D, P, M, stream);
    case 4: return launch<4>(x, w, g, out, T, D, P, M, stream);
    case 6: return launch<6>(x, w, g, out, T, D, P, M, stream);
    case 8: return launch<8>(x, w, g, out, T, D, P, M, stream);
    case 10: return launch<10>(x, w, g, out, T, D, P, M, stream);
    case 12: return launch<12>(x, w, g, out, T, D, P, M, stream);
    case 14: return launch<14>(x, w, g, out, T, D, P, M, stream);
    case 16: return launch<16>(x, w, g, out, T, D, P, M, stream);
    default: return cudaErrorInvalidValue;
  }
}
