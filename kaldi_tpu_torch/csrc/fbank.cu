// Fused log-mel filterbank kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel in kaldi_tpu/ops/pallas_frontend.py, `_kernel`
// (the pl.pallas_call in PallasFbank.__call__): the window multiply, a
// real DFT as two products against cos/sin tables, the power
// re^2 + im^2, the mel product and log(max(., FLT_MIN)), in one pass.
// Frames arrive DC-removed and pre-emphasised (features/window.py
// preprocess_frames), so the kernel's input is (N, win) float32.
//
// What bounds it: per frame about win*n_bins*2 multiply-adds for the
// DFT (400*257*2 = 205,600 at 16 kHz / 25 ms / n_fft 512) plus
// n_bins*n_mel for the mel product (257*40 = 10,280), against about
// 1.6 KB of frame read and 160 B of output written.  Once frames are
// batched the kernel is compute-bound; the cos/sin/mel tables (about
// 0.86 MB) are shared by every block and stay in L2.
//
// Design (simple and exact first): one block per tile of FBANK_TILE
// frames.  The windowed frames are staged in shared memory.  Each
// thread owns one DFT bin and keeps the tile's re/im sums in
// registers, so each cos/sin table value read from L2 is reused for
// FBANK_TILE frames; frame samples are read four at a time, one float4
// shared-memory broadcast per frame, instead of one scalar read per
// sample.  The power spectrum goes to shared memory, then threads over
// (frame, mel bin) reduce it against the dense mel matrix.  All
// arithmetic is FP32 FMA on the CUDA cores.
//
// Left on the table: the tensor cores (wgmma; TF32 would need a 3xTF32
// split to hold the log-mel tolerance), TMA staging of the tables, and
// the mel matrix's sparsity (each DFT bin feeds at most two filters).

#include <cfloat>
#include <cuda_runtime.h>

#define FBANK_TILE 16

__global__ void __launch_bounds__(1024) fbank_logmel_kernel(
    const float* __restrict__ frames, const float* __restrict__ window,
    const float* __restrict__ cosm, const float* __restrict__ sinm,
    const float* __restrict__ mel, float* __restrict__ out, int n_frames,
    int win, int n_bins, int n_mel) {
  extern __shared__ __align__(16) float smem[];
  // frame rows padded to a multiple of 4 floats so they load as float4
  const int ws = (win + 3) & ~3;
  float* xs = smem;                      // [FBANK_TILE][ws]
  float* pw = smem + FBANK_TILE * ws;    // [FBANK_TILE][n_bins]
  const int f0 = blockIdx.x * FBANK_TILE;

  // 1. stage the windowed frames (zeros past the last frame / sample)
  for (int i = threadIdx.x; i < FBANK_TILE * ws; i += blockDim.x) {
    const int f = i / ws;
    const int n = i - f * ws;
    float v = 0.f;
    if (f0 + f < n_frames && n < win)
      v = frames[(size_t)(f0 + f) * win + n] * window[n];
    xs[i] = v;
  }
  __syncthreads();

  // 2. DFT by products: one bin per thread, the tile's sums in
  //    registers; four samples per step, read as one float4 per frame
  const int win4 = win & ~3;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[FBANK_TILE];
    float im[FBANK_TILE];
#pragma unroll
    for (int f = 0; f < FBANK_TILE; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int n = 0; n < win4; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(cosm + (size_t)(n + j) * n_bins + k);
        s[j] = __ldg(sinm + (size_t)(n + j) * n_bins + k);
      }
#pragma unroll
      for (int f = 0; f < FBANK_TILE; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(xs + f * ws + n);
        re[f] = fmaf(x.x, c[0], re[f]);
        im[f] = fmaf(x.x, s[0], im[f]);
        re[f] = fmaf(x.y, c[1], re[f]);
        im[f] = fmaf(x.y, s[1], im[f]);
        re[f] = fmaf(x.z, c[2], re[f]);
        im[f] = fmaf(x.z, s[2], im[f]);
        re[f] = fmaf(x.w, c[3], re[f]);
        im[f] = fmaf(x.w, s[3], im[f]);
      }
    }
    for (int n = win4; n < win; ++n) {
      const float c = __ldg(cosm + (size_t)n * n_bins + k);
      const float s = __ldg(sinm + (size_t)n * n_bins + k);
#pragma unroll
      for (int f = 0; f < FBANK_TILE; ++f) {
        const float x = xs[f * ws + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FBANK_TILE; ++f)
      pw[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // 3. mel product + log floor
  for (int i = threadIdx.x; i < FBANK_TILE * n_mel; i += blockDim.x) {
    const int f = i / n_mel;
    const int m = i - f * n_mel;
    if (f0 + f >= n_frames) continue;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(pw[f * n_bins + k], __ldg(mel + (size_t)k * n_mel + m), acc);
    out[(size_t)(f0 + f) * n_mel + m] = logf(fmaxf(acc, FLT_MIN));
  }
}

// frames (n_frames, win), window (win), cosm/sinm (win, n_bins),
// mel (n_bins, n_mel), out (n_frames, n_mel); all float32, contiguous,
// on the device.  Launches on `stream` and returns the launch status.
extern "C" cudaError_t kt_fbank_logmel(const float* frames,
                                       const float* window,
                                       const float* cosm, const float* sinm,
                                       const float* mel, float* out,
                                       int n_frames, int win, int n_bins,
                                       int n_mel, cudaStream_t stream) {
  if (n_frames <= 0) return cudaSuccess;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem =
      (size_t)FBANK_TILE * (((win + 3) & ~3) + n_bins) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fbank_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_frames + FBANK_TILE - 1) / FBANK_TILE;
  fbank_logmel_kernel<<<blocks, threads, smem, stream>>>(
      frames, window, cosm, sinm, mel, out, n_frames, win, n_bins, n_mel);
  return cudaGetLastError();
}
