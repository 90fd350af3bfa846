// Fused log-mel filterbank kernel for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernel in kaldi_tpu/ops/pallas_frontend.py, `_kernel`
// (the pl.pallas_call in PallasFbank.__call__): the window multiply, a
// real DFT as two products against cos/sin tables, the power
// re^2 + im^2, the mel product and log(max(., FLT_MIN)), in one pass.
// Two flags give the reference Fbank's other options: `use_power` off
// takes the magnitude sqrt(re^2 + im^2) into the mel product, and
// `use_log` off writes max(., FLT_MIN) without the log.
// Frames arrive DC-removed and pre-emphasised (features/window.py
// preprocess_frames), so the kernel's input is (N, win) float32.
//
// What bounds it: the function moves 1.6 KB of frame in and 160 B out
// per frame (16 kHz / 25 ms / 40 bins), and a real FFT of n_fft 512
// needs about 12k operations per frame (2.5 n_fft log2 n_fft) besides
// the power and the mel filters' ~2 n_bins nonzero weights: bytes-bound,
// 0.00016 ms at 300 frames and 0.0022 ms at 4096 (tools/timing.py
// fbank_bound).  This kernel does the DFT instead as a dense product,
// win * 2 * n_bins multiply-adds per frame (400 * 514, ~35x the FFT's
// work) at 3xTF32 on the tensor cores (tf32x3.cuh): one pass, no
// shuffles between butterfly stages, and the same products as the TPU
// kernel; that product alone needs 0.0008 ms at 300 frames and 0.0107
// at 4096 at 165 TFLOP/s float32-equivalent.  At the serving path's
// 300-600 frames per utterance the floor is the launch and one tile's
// latency.
//
// Design.  The DFT is a product (frames x win) . (win x 2 n_bins); its
// columns are interleaved, 2k = cos_k and 2k+1 = sin_k, so that each
// thread's accumulator pair (c0, c1) of an mma.sync m16n8k8 tile is
// (re, im) of one bin and the power forms in registers.  To fill 132 SMs
// at 300-600 frames the work is split by mel filter group as well as by
// frame tile: a block computes (16 or 32 frames) x (one group of
// filters).  It covers the group's DFT bins, the union of its filters'
// nonzero bins (contiguous), forms the power there, and writes its
// filters' outputs: no reduction across blocks, and the result does not
// depend on the launch.  Bins at a group's edge are computed by both
// neighbouring groups.  Groups balance bins, not filters (high filters
// are wider); ops/fbank.py builds the group -> bin-range table and the
// tables, split into hi/lo once, in fragment order per group.  8 groups
// at 257 bins give 152 blocks at 300 frames.
//
// The frames, the window and the group's mel weights come in with
// cp.async (16 bytes a thread for the frames), all in flight at once.
// The window multiply and the frames' hi/lo split happen as each A
// fragment is read: a pass splitting them into a second shared-memory
// copy when staged took a fifth of a block's time at 300 frames and
// doubled its shared memory, for no gain in the product loop (measured
// with clock64() stamps per phase).  Warp wn of a block takes the
// group's n-tiles wn, wn + 4, ... for every 16-frame m-tile, so each
// table fragment, read straight from L2 in fragment order as one float4
// a lane (two k-steps in flight), serves all of the block's frames.  At
// few frames the latency of one block is the time: the block then has 8
// warps and splits the k-steps in two, summing the two parts' (re, im)
// in shared memory in a fixed order.  At many frames, a block of 4 warps
// covers 32 frames.  The three products of each 3xTF32 step are issued
// pass by pass over the warp's independent tiles.  Each k-step's
// products accumulate on the tensor cores alone, and are added into
// float32 registers on the CUDA cores one k-step later: the tensor
// cores' float32 accumulation rounds more coarsely than an FMA, and
// over all 50 k-steps it cost up to half the 2e-3 log-mel bar on
// near-silent bins of the paths' audio.
//
// A group holds at most 64 bins (FB_MAX_TILES n-tiles) of one filter.  A
// bank with a wider filter (at 16 kHz, 17 mel bins or fewer) reaches the
// kernel cut into pieces of at most 64 bins (ops/fbank.py split_filters),
// one output column each: with `raw` set the kernel writes each piece's
// linear energy, with no floor and no log, and fbank_sum_pieces_kernel
// sums each filter's pieces in bin order, then floors at FLT_MIN and
// takes the log.  The floor comes after the whole filter's sum, as in
// the reference.  The second kernel moves 4 bytes per piece and frame
// in and 4 per filter out: ~0.13 MB at 4096 frames and 17 bins, a few
// microseconds beside the DFT.
//
// Shaped by ptxas (chip_smoke prints its report): 120 registers for 8
// warps x 16 frames, 160 for 4 warps x 32 frames, no spills; 64 frames a
// block took 153 registers before the per-k-step sums and ran slower.
// Shared memory is 45 KB and 54 KB at win 400.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

#define FB_MAX_TILES 16   // n-tiles (4 DFT bins each) of one mel group
#define FB_PWS 68         // row stride of the power tile in shared memory
#define FB_PS 132         // row stride of a K-part's (re, im) tile
#define FB_PF 2           // k-steps of table fragments in flight
#define FB_MELW 128       // a group's mel weights (a bin feeds <= 2 filters)

// The A fragment of frames (row0.., k0..) times the window, split.
__device__ __forceinline__ void load_a_windowed(const float* xs, const float* w,
                                                int ld, int row0, int k0,
                                                int lane, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = xs + (row0 + g) * ld + k0 + t;
  const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
  kt::split_tf32(p[0] * w0, hi[0], lo[0]);
  kt::split_tf32(p[8 * ld] * w0, hi[1], lo[1]);
  kt::split_tf32(p[4] * w1, hi[2], lo[2]);
  kt::split_tf32(p[8 * ld + 4] * w1, hi[3], lo[3]);
}

// A block: 16 * WM frames x one mel group, 4 * KQ warps; warp (wn, kq)
// takes the group's n-tiles wn + 4 i for every m-tile over the kq-th
// part of the k-steps.
template <int WM, int KQ>
__global__ void __launch_bounds__(128 * KQ) fbank_logmel_kernel(
    const float* __restrict__ frames, const float* __restrict__ window,
    const float* __restrict__ tab, const int* __restrict__ groups,
    const int* __restrict__ franges, const float* __restrict__ melw,
    float* __restrict__ out, int n_frames, int win, int kp, int n_mel,
    int vec, int use_power, int use_log, int raw) {
  constexpr int ROWS = 16 * WM, MAXI = FB_MAX_TILES / 4, NT = 128 * KQ;
  extern __shared__ __align__(16) float smem[];
  const int S = kp + 4;
  float* wsm = smem;             // [kp] the window, zero past win
  float* mw = wsm + kp;          // [FB_MELW] the group's mel weights
  float* xs = mw + FB_MELW;      // [ROWS][S] frames; then the power tile
  float* kparts = xs + ROWS * S; // [KQ][ROWS][FB_PS] (KQ > 1)
  const int f0 = blockIdx.x * ROWS;
  const int* gm = groups + 5 * blockIdx.y;
  const int k0 = gm[0], nt = gm[1], m0 = gm[2], m1 = gm[3], toff = gm[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. frames, window and the group's mel weights into shared memory,
  //    all in flight at once; zeros past the last frame and past win
  if (vec) {
    const int w4 = win / 4;
    for (int i = tid; i < ROWS * w4; i += NT) {
      const int r = i / w4, c = 4 * (i - r * w4);
      if (f0 + r < n_frames)
        kt::cp_async16(xs + r * S + c, frames + (size_t)(f0 + r) * win + c);
      else
        *reinterpret_cast<float4*>(xs + r * S + c) = make_float4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < ROWS * win; i += NT) {
      const int r = i / win, c = i - r * win;
      if (f0 + r < n_frames)
        kt::cp_async4(xs + r * S + c, frames + (size_t)(f0 + r) * win + c);
      else
        xs[r * S + c] = 0.f;
    }
  }
  for (int i = tid; i < ROWS * (kp - win); i += NT) {
    const int r = i / (kp - win);
    xs[r * S + win + (i - r * (kp - win))] = 0.f;
  }
  for (int c = tid; c < kp; c += NT) {
    if (c < win)
      kt::cp_async4(wsm + c, window + c);
    else
      wsm[c] = 0.f;
  }
  // filter m's weights over its bins [lo, hi) start at franges[3m + 2];
  // a group's are contiguous
  const int w0 = franges[3 * m0 + 2];
  const int nw = franges[3 * (m1 - 1) + 2] + franges[3 * (m1 - 1) + 1] -
                 franges[3 * (m1 - 1)] - w0;
  for (int i = tid; i < nw; i += NT) kt::cp_async4(mw + i, melw + w0 + i);
  kt::cp_async_commit();
  kt::cp_async_wait<0>();
  __syncthreads();

  // 2. the DFT over this warp's part of the k-steps; the window multiply
  //    and the hi/lo split happen as each A fragment is read
  const int wn = warp & 3, kq = warp >> 2;
  const int ks = kp / 8;
  const int s_begin = kq * ks / KQ, s_end = (kq + 1) * ks / KQ;
  // each k-step accumulates on the tensor cores into its own buffer of
  // a pair, added into `acc` in float32 on the CUDA cores while the next
  // k-step's products run: the tensor cores' accumulation rounding sees
  // only one k-step's sum, and the add waits on no product in flight
  float acc[WM][MAXI][4], pp[FB_PF][WM][MAXI][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int i = 0; i < MAXI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][i][e] = 0.f;
#pragma unroll
        for (int u = 0; u < FB_PF; ++u) pp[u][mi][i][e] = 0.f;
      }
  const float4* tb = reinterpret_cast<const float4*>(tab + toff) + lane;
  // the table fragments of k-step s + FB_PF - 1 load while step s
  // computes
  float4 bq[FB_PF][MAXI];
  auto load_b = [&](float4 (&b)[MAXI], int s) {
#pragma unroll
    for (int i = 0; i < MAXI; ++i)
      if (wn + 4 * i < nt) b[i] = __ldg(tb + (s * nt + wn + 4 * i) * 32);
  };
  auto promote = [&](float (&p)[WM][MAXI][4]) {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int i = 0; i < MAXI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][i][e] += p[mi][i][e];
          p[mi][i][e] = 0.f;
        }
  };
#pragma unroll
  for (int p = 0; p < FB_PF - 1; ++p)
    if (s_begin + p < s_end) load_b(bq[p], s_begin + p);
  for (int s0 = s_begin; s0 < s_end; s0 += FB_PF) {
#pragma unroll
    for (int u = 0; u < FB_PF; ++u) {
      const int s = s0 + u;
      if (s < s_end) {
        if (s + FB_PF - 1 < s_end)
          load_b(bq[(u + FB_PF - 1) % FB_PF], s + FB_PF - 1);
        uint32_t ah[WM][4], al[WM][4];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
          load_a_windowed(xs, wsm, S, 16 * mi, 8 * s, lane, ah[mi], al[mi]);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int i = 0; i < MAXI; ++i)
            if (wn + 4 * i < nt) {
#pragma unroll
              for (int mi = 0; mi < WM; ++mi)
                kt::mma_3xtf32_pass(pass, pp[u][mi][i], ah[mi], al[mi],
                                    bq[u][i]);
            }
      }
      promote(pp[(u + FB_PF - 1) % FB_PF]);
    }
  }
#pragma unroll
  for (int u = 0; u < FB_PF; ++u) promote(pp[u]);

  // 3. power re^2 + im^2 into shared memory (over the frames): from the
  //    registers, or from the sum of the K-parts in a fixed order
  const int gid = lane >> 2, tig = lane & 3;
  float* pw = xs;  // [ROWS][FB_PWS], group-local bins
  if (KQ == 1) {
    __syncthreads();   // every warp is done with the frames
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int i = 0; i < MAXI; ++i)
        if (wn + 4 * i < nt) {
          const float* c = acc[mi][i];
          const int r = 16 * mi + gid, k = 4 * (wn + 4 * i) + tig;
          const float p0 = c[0] * c[0] + c[1] * c[1];
          const float p1 = c[2] * c[2] + c[3] * c[3];
          pw[r * FB_PWS + k] = use_power ? p0 : sqrtf(p0);
          pw[(r + 8) * FB_PWS + k] = use_power ? p1 : sqrtf(p1);
        }
  } else {
    float* pq = kparts + kq * ROWS * FB_PS;
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int i = 0; i < MAXI; ++i)
        if (wn + 4 * i < nt) {
          const float* c = acc[mi][i];
          const int r = 16 * mi + gid, col = 8 * (wn + 4 * i) + 2 * tig;
          *reinterpret_cast<float2*>(pq + r * FB_PS + col) =
              make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(pq + (r + 8) * FB_PS + col) =
              make_float2(c[2], c[3]);
        }
    __syncthreads();
    const int nb = 4 * nt;
    for (int i = tid; i < ROWS * nb; i += NT) {
      const int r = i / nb, k = i - r * nb;
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(
            kparts + (q * ROWS + r) * FB_PS + 2 * k);
        re += v.x;
        im += v.y;
      }
      const float p = re * re + im * im;
      pw[r * FB_PWS + k] = use_power ? p : sqrtf(p);
    }
  }
  __syncthreads();

  // 4. the group's filters over their nonzero bins, then the floor and
  //    the log (or neither, for the pieces of a wide filter)
  const int nf = m1 - m0;
  for (int i = tid; i < ROWS * nf; i += NT) {
    const int r = i / nf, m = m0 + (i - r * nf);
    if (f0 + r >= n_frames) continue;
    const int lo = franges[3 * m], hi = franges[3 * m + 1];
    const float* wm_ = mw + franges[3 * m + 2] - w0 - lo;
    const float* pr = pw + r * FB_PWS - k0;
    float e = 0.f;
    for (int k = lo; k < hi; ++k) e = fmaf(pr[k], wm_[k], e);
    if (!raw) {
      e = fmaxf(e, FLT_MIN);
      if (use_log) e = logf(e);
    }
    out[(size_t)(f0 + r) * n_mel + m] = e;
  }
}

// One thread per (frame, filter): the sum of the filter's pieces in bin
// order, floored at FLT_MIN, then the log unless use_log is 0.
__global__ void fbank_sum_pieces_kernel(const float* __restrict__ parts,
                                        const int* __restrict__ piece_off,
                                        const int* __restrict__ piece_cols,
                                        float* __restrict__ out, int n_frames,
                                        int n_cols, int n_mel, int use_log) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n_frames * n_mel) return;
  const long r = i / n_mel;
  const int m = (int)(i - r * n_mel);
  const float* p = parts + r * n_cols;
  float e = 0.f;
  for (int j = piece_off[m]; j < piece_off[m + 1]; ++j) e += p[piece_cols[j]];
  e = fmaxf(e, FLT_MIN);
  out[i] = use_log ? logf(e) : e;
}

template <int WM, int KQ>
static cudaError_t launch(const float* frames, const float* window,
                          const float* tab, const int* groups,
                          const int* franges, const float* melw, float* out,
                          int n_frames, int win, int kp, int n_groups,
                          int n_mel, int vec, int use_power, int use_log,
                          int raw, cudaStream_t stream) {
  const int rows = 16 * WM;
  size_t xs = (size_t)rows * (kp + 4);
  if (xs < (size_t)rows * FB_PWS) xs = (size_t)rows * FB_PWS;
  const size_t parts = KQ > 1 ? (size_t)KQ * rows * FB_PS : 0;
  const size_t smem = (kp + FB_MELW + xs + parts) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_logmel_kernel<WM, KQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n_frames + rows - 1) / rows, n_groups);
  fbank_logmel_kernel<WM, KQ><<<grid, 128 * KQ, smem, stream>>>(
      frames, window, tab, groups, franges, melw, out, n_frames, win, kp,
      n_mel, vec, use_power, use_log, raw);
  return cudaGetLastError();
}

// frames (n_frames, win), window (win), out (n_frames, n_mel) float32;
// tab the fragment-order hi/lo DFT tables of the groups; groups
// (n_groups, 5) int32 rows (first bin, n-tiles, first filter, end
// filter, table offset in floats); franges (n_mel, 3) int32 rows (the
// filter's nonzero bins [lo, hi), offset of its weights in melw); melw
// the filters' weights over those bins, in filter order; all contiguous
// on the device.  kp is win rounded up to 8.  use_power (0: magnitude)
// and use_log (0: linear mel energies) as the reference Fbank's options
// of those names; raw (1: each column's linear energy, no floor, no log:
// the pieces of a wide filter).  Launches on `stream`;
// returns the launch status (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" cudaError_t kt_fbank_logmel(const float* frames,
                                       const float* window, const float* tab,
                                       const int* groups, const int* franges,
                                       const float* melw, float* out,
                                       int n_frames, int win, int kp,
                                       int n_groups, int n_mel,
                                       int use_power, int use_log, int raw,
                                       cudaStream_t stream) {
  if (n_frames < 0 || win <= 0 || kp < win || kp % 8 != 0 || n_groups <= 0 ||
      n_groups > 65535 || n_mel <= 0)
    return cudaErrorInvalidValue;
  if (n_frames == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return cudaGetLastError();
  const int vec =
      (win % 4 == 0) && (reinterpret_cast<uintptr_t>(frames) % 16 == 0);
  // few frames: 16 frames a block with the k-steps split in two, so that
  // more warps share a tile's latency; many: 32 frames a block, so that
  // each table fragment serves more of them
  const long tiles = (long)(n_frames + 15) / 16 * n_groups;
  if (tiles >= 4L * sms)
    return launch<2, 1>(frames, window, tab, groups, franges, melw, out,
                        n_frames, win, kp, n_groups, n_mel, vec, use_power,
                        use_log, raw, stream);
  return launch<1, 2>(frames, window, tab, groups, franges, melw, out,
                      n_frames, win, kp, n_groups, n_mel, vec, use_power,
                      use_log, raw, stream);
}

// parts (n_frames, n_cols): the pieces' linear energies that
// kt_fbank_logmel wrote with raw set; filter m's pieces are the columns
// piece_cols[piece_off[m] .. piece_off[m + 1]); out (n_frames, n_mel).
// All int32 / float32, contiguous on the device.  Launches on `stream`;
// returns the launch status.
extern "C" cudaError_t kt_fbank_sum_pieces(const float* parts,
                                           const int* piece_off,
                                           const int* piece_cols, float* out,
                                           int n_frames, int n_cols,
                                           int n_mel, int use_log,
                                           cudaStream_t stream) {
  if (n_frames < 0 || n_cols <= 0 || n_mel <= 0)
    return cudaErrorInvalidValue;
  const long n = (long)n_frames * n_mel;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  fbank_sum_pieces_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                            0, stream>>>(parts, piece_off, piece_cols, out,
                                         n_frames, n_cols, n_mel, use_log);
  return cudaGetLastError();
}
