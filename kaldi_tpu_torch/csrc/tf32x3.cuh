// 3xTF32 on Hopper's tensor cores, shared by the fbank kernel (mma.sync)
// and the GMM kernel (wgmma).
//
// A float32 value v splits into two TF32 values, hi = rna(v) and
// lo = rna(v - hi), each with an 11-bit significand; hi + lo keeps about
// 22 bits of v.  A float32 product a.b is then taken as
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (lo.lo, below float32's rounding, is dropped), three TF32 products on
// the tensor cores in place of one on the CUDA cores: 495 / 3 = 165
// TFLOP/s of float32-equivalent work on an H100 SXM, against 67 TFLOP/s
// of float32 FMA.  One TF32 product alone keeps 11 bits, which the
// kernels' tolerances (2e-3 log-mel; 1e-4 + 1e-4.|ll| at log-likelihoods
// of O(100)) do not allow (tests/test_torch_features.py and
// tests/test_torch_gmm.py show both in numpy).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for
// lane = 4 * gid + tig (gid = lane / 4, tig = lane % 4):
//   A (16 x 8, row-major): a0 (gid, tig), a1 (gid + 8, tig),
//                          a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
//   B (8 x 8, col-major):  b0 (tig, gid), b1 (tig + 4, gid)
//   C (16 x 8):            c0 (gid, 2 tig), c1 (gid, 2 tig + 1),
//                          c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
// The fbank kernel's B operand is laid out on the host in this fragment
// order, four floats per lane: (b0 hi, b1 hi, b0 lo, b1 lo), so that a
// warp reads one k-step of one n-tile as 512 contiguous bytes
// (kaldi_tpu_torch/ops/tf32.py builds the split and this order).
//
// wgmma.mma_async m64nNk8 TF32 takes A (64 x 8) from registers, each warp
// of the warpgroup holding 16 rows in the A layout above, and B (8 x N)
// from shared memory through a matrix descriptor; its accumulators
// follow the C layout above, warp w holding rows 16 w .. 16 w + 15 and
// n-tile j in d[4 j .. 4 j + 3].  TF32 B must be K-major: the GMM kernel
// stores it without swizzle as core matrices of 8 rows x 4 floats (16
// bytes a row, 128 contiguous bytes), the two along K 128 bytes apart
// and the 8-row groups along N 256 bytes apart (ops/gmm.py builds it).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kt {

// Round to TF32, to nearest with ties away from zero (cvt.rna), low 13
// bits cleared so that the value reads back as an exact float32.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a.b for one 16 x 8 x 8 TF32 tile (float32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One of the three products of d += a.b at float32 accuracy: pass 0
// a_lo.b_hi, pass 1 a_hi.b_lo, pass 2 a_hi.b_hi (the two small cross
// terms first).  `b` is one lane's fragment-order float4 (b0 hi, b1 hi,
// b0 lo, b1 lo).  The three passes of one tile depend on each other
// through d, so a kernel issues pass 0 of all its independent tiles,
// then pass 1, then pass 2: the tensor pipe never waits on one chain.
__device__ __forceinline__ void mma_3xtf32_pass(int pass, float (&d)[4],
                                                const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4],
                                                const float4& b) {
  if (pass == 0)
    mma_tf32(d, a_lo, __float_as_uint(b.x), __float_as_uint(b.y));
  else if (pass == 1)
    mma_tf32(d, a_hi, __float_as_uint(b.z), __float_as_uint(b.w));
  else
    mma_tf32(d, a_hi, __float_as_uint(b.x), __float_as_uint(b.y));
}

// The A fragment of the 16 x 8 tile at (row0, k0) of a row-major float32
// matrix in shared memory with row stride `ld`, split into hi and lo.
// With ld an odd multiple of 4 the 32 lanes hit 32 distinct banks.
__device__ __forceinline__ void load_a_split(const float* s, int ld, int row0,
                                             int k0, int lane,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (row0 + g) * ld + k0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// Asynchronous global → shared copies (cp.async; 16 bytes bypass L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The descriptor of a B tile at `p` in shared memory, K-major without
// swizzle: core matrices 128 bytes apart along K, 256 along N.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a.B for the warpgroup's 64 x 64 tile, one k-step of 8: a the
// thread's A registers, B the tile behind `desc`; accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Before a warpgroup's first wgmma on registers other code touched.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the warpgroup's wgmmas issued so far into a group, and wait for
// all of its groups to complete.
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Make this thread's writes to shared memory (cp.async included) visible
// to wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace kt
