// Helpers shared by the port's kernels: the opt-in to more than 48 KB of dynamic shared memory,
// cp.async copies into shared memory, and products on the TF32 tensor cores at f32 accuracy
// (split TF32).
//
// Split TF32. A TF32 value keeps 10 of f32's 23 mantissa bits, so one mma.sync on f32 inputs
// rounded to TF32 carries each operand to about 2^-11 relative: too coarse for kernels held to
// f32 results. Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), so that
// hi + lo carries x to about 2^-21, and a product is a_hi b_hi + a_hi b_lo + a_lo b_hi (the
// a_lo b_lo term, about 2^-22 relative, is dropped): three mma.sync for f32 accuracy ("3xTF32").
// A value that is exact in TF32 (a bf16 value: 7 mantissa bits) needs no lo term, and each
// operand without one saves one of the three products (mma_split).
//
// Fragments of mma.sync.m16n8k8 with TF32 inputs (PTX ISA), for lane = 4 g + t (g = lane / 4,
// t = lane % 4): A (16 x 8, row-major) a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4); B (8 x 8, k x n) b0 = (t, g), b1 = (t + 4, g); C and D (16 x 8)
// c0, c1 = (g, 2t), (g, 2t + 1), c2, c3 = (g + 8, 2t), (g + 8, 2t + 1). A C fragment feeds
// a later product as its A operand without passing through shared memory once the k index is
// permuted: the lane's k slots t and t + 4 are taken to mean columns 2t and 2t + 1, so a0..a3 =
// c0, c2, c1, c3, and the B operand is read in the same permuted order. The sum over k does not
// depend on the order of its terms.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Opts kKernel in to `smem` bytes of dynamic shared memory on the current device where it needs
// more than the default 48 KB. The attribute is per device, so it is set once per (kernel,
// device), before the first launch there that needs it (an eager one, never inside a graph
// capture).
template <auto kKernel>
cudaError_t allow_shared_memory(size_t smem) {
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && smem <= allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && device < kDevices) allowed[device] = smem;
  return err;
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled (src not read) unless valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// An f32 value as hi + lo, both TF32. hi is x rounded to nearest, ties away from zero: the
// rounding of cvt.rna.tf32.f32, whose sm_90a code also handles NaN and infinity, here in two
// integer operations for finite x. lo is x - hi (exact in f32) cut to TF32 toward zero, which
// carries x to about 2^-21.
__device__ __forceinline__ void tf32_parts(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// a bf16 value is exact in TF32: hi is the value, lo is 0 (and mma_split reads no lo for it)
__device__ __forceinline__ void tf32_parts(__nv_bfloat16 x, unsigned& hi, unsigned& lo) {
  hi = static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16;
  lo = 0u;
}

// d += a b on one m16n8k8 tile: TF32 inputs, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with each operand at the precision it was given in: kSplitA / kSplitB say whether that
// operand carries a lo part. Both split: 3 products (f32 x f32); one: 2; none: 1. The small
// terms go first.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const unsigned (&a_hi)[4], const unsigned (&a_lo)[4],
                                          const unsigned (&b_hi)[2], const unsigned (&b_lo)[2]) {
  if constexpr (kSplitA) mma_tf32(d, a_lo, b_hi);
  if constexpr (kSplitB) mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// acc += P B over one tile of kK rows of B. P is the 16 x kK product that mma.sync left in p (one
// accumulator block of 8 columns per entry, f32), B is [kK][kN] in shared memory with row stride
// kStride, and b points at B + 2t kStride + g (the permuted k order above: the lane's slots t and
// t + 4 are rows 2t and 2t + 1 of each block of 8). P is split into hi + lo; B into hi + lo where
// kSplitB says it needs one.
//
// A tile's products go into zeroed registers, and from there into acc with a rounded f32 add.
// mma.sync adds its products to its accumulator the tensor cores' way (aligned to the largest term
// and cut, not rounded); carried in one accumulator across the thousands of mma.sync of a catalog,
// a row split or a long row of keys, those cuts add up one way, past the f32 limits of the kernels
// that use this (K2's gradient over 3,706 items drifted by 2.5e-5 of its largest value). Summed a
// tile at a time, each tile's cuts are relative to that tile's sum, and the tiles' sums are added
// rounded. The columns go in passes of up to 8 blocks (32 more registers a lane at most), each
// block its own chain of mma.sync, so that 8 chains are in flight.
template <bool kSplitB, int kK, int kN, int kStride, typename TB>
__device__ __forceinline__ void add_tile_products(const float (&p)[kK / 8][4], const TB* b, float (&acc)[kN / 8][4]) {
  constexpr int kPass = kN / 8 < 8 ? kN / 8 : 8;  // column blocks summed at once
#pragma unroll
  for (int d0 = 0; d0 < kN / 8; d0 += kPass) {
    float part[kPass][4];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    }
#pragma unroll
    for (int kb = 0; kb < kK / 8; ++kb) {
      unsigned p_hi[4], p_lo[4];  // P's A fragment: c0, c2, c1, c3 (see above)
      tf32_parts(p[kb][0], p_hi[0], p_lo[0]);
      tf32_parts(p[kb][2], p_hi[1], p_lo[1]);
      tf32_parts(p[kb][1], p_hi[2], p_lo[2]);
      tf32_parts(p[kb][3], p_hi[3], p_lo[3]);
      const TB* row = b + kb * 8 * kStride + d0 * 8;
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        unsigned b_hi[2], b_lo[2];
        tf32_parts(row[j * 8], b_hi[0], b_lo[0]);
        tf32_parts(row[kStride + j * 8], b_hi[1], b_lo[1]);
        mma_split<true, kSplitB>(part[j], p_hi, p_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + j][e] += part[j][e];
    }
  }
}

}  // namespace
