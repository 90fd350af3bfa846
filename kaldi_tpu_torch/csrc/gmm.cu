// Diagonal-GMM log-likelihood kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel in kaldi_tpu/ops/pallas_gmm.py, `_kernel`
// (the pl.pallas_call in gmm_loglikes_pallas):
//
//   out[t, p] = logsumexp_m( g[m, p] + x_t . a[m, :, p] + x_t^2 . b[m, :, p] )
//
// with a = mu/var, b = -1/(2 var) and g the Gaussian's log-constant, all
// laid out m-major with the pdf index fastest, (M, Dp, P) and (M, P), as
// the TPU kernel lays them out.  Unused mixture slots carry g = -1e30 and
// vanish in the logsumexp.  The layout is built once per model
// (kaldi_tpu_torch/ops/gmm.py kernel_layout), with D zero-padded to Dp, a
// multiple of 4.
//
// What bounds it: per (frame, pdf, slot) 2*D multiply-adds, two expf and
// a few compares; per frame the parameters are M*Dp*P*2 floats.  At the
// mini_librispeech tri3b width (P = 2500, M = 10 slots, D = 40) that is
// 160 FLOP per (t, p, m), 16 GFLOP at T = 4096, against 8 MB of
// parameters that stay in L2: compute-bound on the CUDA cores.
//
// Design (simple and exact first): one block per tile of GMM_TT frames x
// GMM_PT pdfs.  The tile's x and x^2 are staged in shared memory, zero
// past T and past D.  Each thread owns one pdf and keeps the tile's
// GMM_TT running (max, sum) pairs of the online logsumexp in registers,
// so each parameter read from L2 (coalesced over p) is reused GMM_TT
// times; x and x^2 are read four dimensions at a time as float4
// shared-memory broadcasts.  The slot loop runs over m at run time (any
// M).  FP32 FMA throughout: log-likelihoods at real feature scales are
// O(100) and the parity bar is 1e-4, which TF32 would not hold.  The
// running max starts at the finite sentinel -1e30, never -INFINITY, so
// s * exp(mx - new_mx) is never (-inf) - (-inf) = NaN.
//
// Left on the table: the tensor cores (the two products are a
// (T, 2*Dp) x (2*Dp, M*P) GEMM; wgmma with a 3xTF32 split would hold
// the tolerance), TMA staging of the parameter tiles, and register
// tiling over two pdfs per thread to halve the shared-memory reads.

#include <cuda_runtime.h>

#define GMM_TT 32     // frames per block
#define GMM_PT 128    // pdfs per block, one per thread
#define GMM_DMAX 64   // largest feature dimension staged in shared memory

__global__ void __launch_bounds__(GMM_PT) gmm_loglikes_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ g,
    float* __restrict__ out, int T, int D, int Dp, int P, int M) {
  __shared__ __align__(16) float xs[GMM_TT * GMM_DMAX];
  __shared__ __align__(16) float x2s[GMM_TT * GMM_DMAX];
  const int t0 = blockIdx.x * GMM_TT;
  const int p = blockIdx.y * GMM_PT + threadIdx.x;

  // 1. stage the tile's x and x^2 as (GMM_TT, Dp) rows
  for (int i = threadIdx.x; i < GMM_TT * Dp; i += blockDim.x) {
    const int f = i / Dp;
    const int d = i - f * Dp;
    float v = 0.f;
    if (t0 + f < T && d < D) v = x[(size_t)(t0 + f) * D + d];
    xs[i] = v;
    x2s[i] = v * v;
  }
  __syncthreads();
  if (p >= P) return;

  // 2. per slot: both products for the tile's frames, then the online
  //    logsumexp update
  float mx[GMM_TT];
  float s[GMM_TT];
#pragma unroll
  for (int f = 0; f < GMM_TT; ++f) {
    mx[f] = -1e30f;
    s[f] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    const float* am = a + (size_t)m * Dp * P + p;
    const float* bm = b + (size_t)m * Dp * P + p;
    float q[GMM_TT];
#pragma unroll
    for (int f = 0; f < GMM_TT; ++f) q[f] = 0.f;
    for (int d = 0; d < Dp; d += 4) {
      float ca[4], cb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ca[j] = __ldg(am + (size_t)(d + j) * P);
        cb[j] = __ldg(bm + (size_t)(d + j) * P);
      }
#pragma unroll
      for (int f = 0; f < GMM_TT; ++f) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + f * Dp + d);
        const float4 yv = *reinterpret_cast<const float4*>(x2s + f * Dp + d);
        float acc = q[f];
        acc = fmaf(xv.x, ca[0], acc);
        acc = fmaf(yv.x, cb[0], acc);
        acc = fmaf(xv.y, ca[1], acc);
        acc = fmaf(yv.y, cb[1], acc);
        acc = fmaf(xv.z, ca[2], acc);
        acc = fmaf(yv.z, cb[2], acc);
        acc = fmaf(xv.w, ca[3], acc);
        acc = fmaf(yv.w, cb[3], acc);
        q[f] = acc;
      }
    }
    const float gm = __ldg(g + (size_t)m * P + p);
#pragma unroll
    for (int f = 0; f < GMM_TT; ++f) {
      const float v = q[f] + gm;
      const float new_mx = fmaxf(mx[f], v);
      s[f] = s[f] * expf(mx[f] - new_mx) + expf(v - new_mx);
      mx[f] = new_mx;
    }
  }

  // 3. write the tile's column, coalesced over p within each frame
#pragma unroll
  for (int f = 0; f < GMM_TT; ++f)
    if (t0 + f < T) out[(size_t)(t0 + f) * P + p] = mx[f] + logf(s[f]);
}

// x (T, D); a, b (M, Dp, P); g (M, P); out (T, P); all float32,
// contiguous, on the device.  Launches on `stream` and returns the
// launch status (cudaErrorInvalidValue for a shape the kernel does not
// take).
extern "C" cudaError_t kt_gmm_loglikes(const float* x, const float* a,
                                       const float* b, const float* g,
                                       float* out, int T, int D, int Dp,
                                       int P, int M, cudaStream_t stream) {
  if (D <= 0 || D > GMM_DMAX || Dp < D || Dp > GMM_DMAX || Dp % 4 != 0 ||
      M <= 0 || P <= 0 || T < 0)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const dim3 grid((T + GMM_TT - 1) / GMM_TT, (P + GMM_PT - 1) / GMM_PT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gmm_loglikes_kernel<<<grid, GMM_PT, 0, stream>>>(x, a, b, g, out, T, D, Dp,
                                                   P, M);
  return cudaGetLastError();
}
