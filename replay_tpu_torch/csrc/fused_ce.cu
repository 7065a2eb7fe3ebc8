// Kernels K1, K2, K3: the catalog log-sum-exp of CEFused and its two gradients,
// without the [N, I] logits ever reaching device memory.
//
//   K1  lse[n]   = log sum_i exp(h[n] . w[i])              replaces _lse_kernel
//   K2  dh[n]    = sum_i g[n] exp(h[n] . w[i] - lse[n]) w[i] replaces _dh_kernel
//   K3  dW[i]    = sum_n g[n] exp(h[n] . w[i] - lse[n]) h[n] replaces _dw_kernel
//
// (replay_tpu/ops/fused_ce.py: _lse_kernel :132, _dh_kernel :156, _dw_kernel :177,
// with _masked_logits :115.) Columns at or past num_valid get the finite mask
// -1e30 added, as the Pallas kernels do, so a table whose columns are all
// masked gives a finite lse near -1e30 instead of NaN; columns past the table
// (i >= items) and rows past the input (n >= rows) do not exist here: every
// load and store is bounds-checked, nothing is padded with zeros.
//
// Layout: h is contiguous [rows, dim], w contiguous [items, dim], each f32 or
// bf16 (loaded and converted to f32 before any product, as the Pallas kernels'
// astype(f32)); g and lse are f32 [rows]; dh is [rows, dim] in h's type, dW
// [items, dim] in w's type. Each kernel has two variants, two C entry points:
// "simt" multiplies with f32 FMAs on the CUDA cores; "tf32" on the TF32 tensor cores with each f32
// operand split into TF32 hi + lo (tensor_core.cuh). Either way f32 inputs keep f32 accuracy
// against the plain version. ops/fused_ce.py::_variant picks one from dim alone, the same for
// all three: "tf32" (replay_fused_lse_*_tf32, design below, after the simt kernels) for dim a
// multiple of 8 up to 128, "simt" for any other dim.
//
// Work split of the simt kernels. A block of 256 threads owns a 64 x 64 tile of (rows x items)
// logits at a time, each thread 4 x 4 of them (rows ty + 16a, items tx + 16b),
// computed by sweeping dim in chunks of 32 staged in shared memory. So a block
// needs 33 KB of shared memory whatever dim is: the Pallas kernels' VMEM guard,
// which shrinks the item tile for large embeddings, has nothing to do here.
//  - K1: one block per 64-row tile walks every item tile, keeping a running
//    max and sum per (thread, row) (online softmax); the 16 threads of a row
//    merge theirs by shuffle at the end.
//  - K2: one block per (64-row tile, 64-column slice of dim) walks every item
//    tile: weights P = g exp(logit - lse) go to shared memory, then dh += P W.
//  - K3 "simt": one block per (64-item tile, 64-column slice, split of the rows)
//    walks the row tiles of its split: dW += P^T h.
// The TPU kernels accumulate dh and dW across the inner grid axis, which is
// right only because a TPU grid runs in order. CUDA blocks run in no order, so
// here each output element has one owner thread that sums in a fixed order,
// and no float atomics are used: the result is the same from run to run. K3 at
// a small catalog has too few item tiles to fill the card, so the rows are cut
// into `splits` parts, each summed into its own f32 partial, and a second pass
// adds the partials in split order. `splits` is a function of the shapes only.
// A dim above 64 takes several column slices, each recomputing the logits.
//
// What bounds them on an H100: at N = 25,600 rows, E = 64, I = 3,706 items K1
// does 2NEI = 12.1 GFLOP against 7.6 MB of inputs, K2 and K3 4NEI = 24.3 GFLOP
// each: all three are bound by operations, not by memory. In f32 the card does
// them at f32 accuracy fastest as 3xTF32 on the tensor cores (495 / 3 TFLOP/s:
// 0.15 ms for K3), against 67 TFLOP/s for f32 FMAs on the CUDA cores (0.36 ms).
// The simt variants read their operands from shared memory for every FMA pair;
// the tf32 variants run on mma.sync; wgmma with TMA is later work.
//
// C interface, bound from Python with ctypes: each function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 when the launches were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 64;      // rows and items of a logits tile
constexpr int kChunk = 32;     // embedding columns staged per step of the logits product
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSlice = 64;     // output columns of dh / dW a block owns
constexpr int kPad = kTile + 1;  // odd row stride: staging writes and reads hit distinct banks
constexpr float kMask = -1e30f;  // the Pallas kernels' _MASK
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shared {
  float a[kChunk][kPad];  // a chunk of the tile's rows, transposed: [column][row]
  float b[kChunk][kPad];  // a chunk of the tile's items, transposed: [column][item]
  float p[kTile][kPad];   // the tile's softmax weights: [row][item]
};
static_assert(sizeof(float) * 2 * kChunk * kPad >= sizeof(float) * kTile * kPad,
              "a and b together hold one [kTile][kPad] operand slice");

// The [kTile][kPad] operand slice of K2 / K3 reuses a and b once the logits are done.
__device__ __forceinline__ float (*slice_of(Shared& sh))[kPad] {
  return reinterpret_cast<float (*)[kPad]>(&sh.a[0][0]);
}

// acc[a][b] = h[n0 + ty + 16a] . w[i0 + tx + 16b] over all of dim, f32 FMA.
// Entries past rows or items come out 0 (their operands are staged as 0).
// Starts with a barrier, so the caller may reuse shared memory up to the call.
template <typename TH, typename TW>
__device__ __forceinline__ void logits_tile(const TH* __restrict__ h, const TW* __restrict__ w,
                                            int n0, int i0, int rows, int items, int dim,
                                            Shared& sh, float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int e0 = 0; e0 < dim; e0 += kChunk) {
    __syncthreads();  // every thread is done with the shared memory this overwrites
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int c = idx - r * kChunk;  // fastest: a warp reads 32 neighbouring columns
      const int e = e0 + c;
      const int n = n0 + r;
      const int i = i0 + r;
      sh.a[c][r] = (n < rows && e < dim) ? to_f32(h[static_cast<size_t>(n) * dim + e]) : 0.f;
      sh.b[c][r] = (i < items && e < dim) ? to_f32(w[static_cast<size_t>(i) * dim + e]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sh.a[c][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sh.b[c][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

// The logit of item i with the catalog mask: columns at or past num_valid get
// -1e30 added (finite), as _masked_logits does.
__device__ __forceinline__ float masked(float logit, int i, int num_valid) {
  return i < num_valid ? logit : logit + kMask;
}

// Writes the tile's softmax weights g[n] exp(logit - lse[n]) to sh.p; zero for
// rows past `rows` and items past `items`, which then add nothing.
__device__ __forceinline__ void weights_tile(const float acc[4][4], const float* __restrict__ g,
                                             const float* __restrict__ lse, int n0, int i0,
                                             int rows, int items, int num_valid, Shared& sh) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int n = n0 + r;
    const float g_n = n < rows ? g[n] : 0.f;
    const float lse_n = n < rows ? lse[n] : 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + tx + 16 * b;
      sh.p[r][tx + 16 * b] =
          (n < rows && i < items) ? expf(masked(acc[a][b], i, num_valid) - lse_n) * g_n : 0.f;
    }
  }
}

// K1. Grid: (row tiles). The running max starts at -inf and is only updated
// from a tile in which the thread has at least one column, whose max is
// finite for finite inputs, so no -inf - (-inf) is formed.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
lse_forward(const TH* __restrict__ h, const TW* __restrict__ w, float* __restrict__ lse,
            int rows, int items, int dim, int num_valid) {
  __shared__ Shared sh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  float run_max[4], run_sum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    run_max[a] = -CUDART_INF_F;
    run_sum[a] = 0.f;
  }
  float acc[4][4];
  for (int i0 = 0; i0 < items; i0 += kTile) {
    logits_tile(h, w, n0, i0, rows, items, dim, sh, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float v[4];
      float tile_max = -CUDART_INF_F;
      bool any = false;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + tx + 16 * b;
        v[b] = masked(acc[a][b], i, num_valid);
        if (i < items) {
          any = true;
          tile_max = fmaxf(tile_max, v[b]);
        }
      }
      // no column of this tile is the thread's (a NaN logit is not skipped:
      // fmaxf drops it from the max, but the sum below carries it to lse)
      if (!any) continue;
      const float new_max = fmaxf(run_max[a], tile_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (i0 + tx + 16 * b < items) tile_sum += expf(v[b] - new_max);
      }
      run_sum[a] = run_sum[a] * expf(run_max[a] - new_max) + tile_sum;
      run_max[a] = new_max;
    }
  }
  // merge the 16 threads of each row (lanes tx = 0..15 of one half-warp)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float m = run_max[a];
    float s = run_sum[a];
#pragma unroll
    for (int offset = 8; offset > 0; offset >>= 1) {
      const float m_other = __shfl_xor_sync(kFull, m, offset);
      const float s_other = __shfl_xor_sync(kFull, s, offset);
      const float merged = fmaxf(m, m_other);
      if (merged != -CUDART_INF_F) {  // a thread with no column at all has max -inf, sum 0
        s = (m == -CUDART_INF_F ? 0.f : s * expf(m - merged)) +
            (m_other == -CUDART_INF_F ? 0.f : s_other * expf(m_other - merged));
        m = merged;
      }
    }
    const int n = n0 + ty + 16 * a;
    if (tx == 0 && n < rows) lse[n] = m + logf(s);
  }
}

// K2. Grid: (row tiles, column slices). Thread (ty, tx) owns dh rows ty + 16a
// and columns c0 + tx + 16j, summed over items in order.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
lse_grad_hidden(const TH* __restrict__ h, const TW* __restrict__ w, const float* __restrict__ g,
                const float* __restrict__ lse, TH* __restrict__ dh, int rows, int items, int dim,
                int num_valid) {
  __shared__ Shared sh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kSlice;
  float (*w_slice)[kPad] = slice_of(sh);  // [item][column]
  float out[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[a][j] = 0.f;
  float acc[4][4];
  for (int i0 = 0; i0 < items; i0 += kTile) {
    logits_tile(h, w, n0, i0, rows, items, dim, sh, acc);
    weights_tile(acc, g, lse, n0, i0, rows, items, num_valid, sh);
    __syncthreads();  // the logits chunks are consumed; P is complete
    for (int idx = threadIdx.x; idx < kTile * kSlice; idx += kThreads) {
      const int r = idx / kSlice;
      const int c = idx - r * kSlice;
      const int i = i0 + r;
      const int e = c0 + c;
      w_slice[r][c] = (i < items && e < dim) ? to_f32(w[static_cast<size_t>(i) * dim + e]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_slice[r][tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sh.p[ty + 16 * a][r];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[a][j] = fmaf(p, wv[j], out[a][j]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = n0 + ty + 16 * a;
    if (n >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = c0 + tx + 16 * j;
      if (e < dim) store(dh + static_cast<size_t>(n) * dim + e, out[a][j]);
    }
  }
}

// K3. Grid: (item tiles, column slices, row splits). Thread (ty, tx) owns dW
// items ty + 16a and columns c0 + tx + 16j, summed over the split's rows in
// order. With one split the result goes to dw in w's type; otherwise to the
// split's f32 partial [items, dim], which add_partials sums.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
lse_grad_table(const TH* __restrict__ h, const TW* __restrict__ w, const float* __restrict__ g,
               const float* __restrict__ lse, TW* __restrict__ dw, float* __restrict__ partial,
               int rows, int items, int dim, int num_valid, int rows_per_split) {
  __shared__ Shared sh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kSlice;
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(rows, row_begin + rows_per_split);
  float (*h_slice)[kPad] = slice_of(sh);  // [row][column]
  float out[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[a][j] = 0.f;
  float acc[4][4];
  for (int n0 = row_begin; n0 < row_end; n0 += kTile) {
    logits_tile(h, w, n0, i0, row_end, items, dim, sh, acc);
    weights_tile(acc, g, lse, n0, i0, row_end, items, num_valid, sh);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kSlice; idx += kThreads) {
      const int r = idx / kSlice;
      const int c = idx - r * kSlice;
      const int n = n0 + r;
      const int e = c0 + c;
      h_slice[r][c] = (n < row_end && e < dim) ? to_f32(h[static_cast<size_t>(n) * dim + e]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = h_slice[r][tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sh.p[r][ty + 16 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[a][j] = fmaf(p, hv[j], out[a][j]);
      }
    }
  }
  float* split_out = partial == nullptr
                         ? nullptr
                         : partial + static_cast<size_t>(blockIdx.z) * items * dim;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= items) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = c0 + tx + 16 * j;
      if (e >= dim) continue;
      const size_t at = static_cast<size_t>(i) * dim + e;
      if (split_out == nullptr) {
        store(dw + at, out[a][j]);
      } else {
        split_out[at] = out[a][j];
      }
    }
  }
}

// K3's second pass: dw = sum of the splits' partials, in split order.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
add_partials(const float* __restrict__ partial, TW* __restrict__ dw, size_t count, int splits) {
  const size_t at = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= count) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partial[static_cast<size_t>(s) * count + at];
  store(dw + at, total);
}

unsigned tiles(int extent) { return static_cast<unsigned>((extent + kTile - 1) / kTile); }
unsigned slices(int dim) { return static_cast<unsigned>((dim + kSlice - 1) / kSlice); }

template <typename TH, typename TW>
cudaError_t run_forward(const void* h, const void* w, float* lse, int rows, int items, int dim,
                        int num_valid, cudaStream_t stream) {
  lse_forward<TH, TW><<<tiles(rows), kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), lse, rows, items, dim, num_valid);
  return cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t run_grad_hidden(const void* h, const void* w, const float* g, const float* lse,
                            void* dh, int rows, int items, int dim, int num_valid,
                            cudaStream_t stream) {
  const dim3 grid(tiles(rows), slices(dim));
  lse_grad_hidden<TH, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), g, lse, static_cast<TH*>(dh), rows,
      items, dim, num_valid);
  return cudaGetLastError();
}

// After a K3 launch: its error, or with several splits, add_partials' launch into dw.
template <typename TW>
cudaError_t finish_partials(const float* partial, void* dw, int items, int dim, int splits,
                            cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = static_cast<size_t>(items) * dim;
  const unsigned blocks = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  add_partials<TW><<<blocks, kThreads, 0, stream>>>(partial, static_cast<TW*>(dw), count, splits);
  return cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t run_grad_table(const void* h, const void* w, const float* g, const float* lse,
                           void* dw, float* partial, int rows, int items, int dim, int num_valid,
                           int splits, int rows_per_split, cudaStream_t stream) {
  const dim3 grid(tiles(items), slices(dim), static_cast<unsigned>(splits));
  lse_grad_table<TH, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), g, lse, static_cast<TW*>(dw),
      splits > 1 ? partial : nullptr, rows, items, dim, num_valid, rows_per_split);
  return finish_partials<TW>(partial, dw, items, dim, splits, stream);
}

// ----------------------------------------------------------------------------------------------
// The "tf32" variants of K1, K2 and K3: dim a multiple of 8 up to 128, on the TF32 tensor cores
// ----------------------------------------------------------------------------------------------
//
// One skeleton serves all three. A block of 4 warps keeps a 64-row tile of one operand in shared
// memory for its life, split once into TF32 hi and lo (the "resident" tile), and streams tiles of
// the other operand through a cp.async double buffer, split in registers as each warp reads them
// (the "streamed" tiles). Per streamed tile each warp computes the logits of its 16 resident rows
// against the tile on mma.sync m16n8k8 (k over dim) and uses them in registers:
//  - K1 (lse_forward_tf32): h resident, W streamed. A running max and sum per row (online
//    softmax), merged over the lane quad of the row at the end: lse = m + log s.
//  - K2 (lse_grad_hidden_tf32): h resident, W streamed. P = g exp(S + mask - lse), then
//    dh += P W with P's accumulator registers as the A fragment (W's rows read in the permuted
//    order of tensor_core.cuh), each item tile's products summed apart and added rounded
//    (add_tile_products); dh [64, dim] stays in registers, a warp 16 rows, a lane (dim / 8) x 4
//    f32, and is written once at the end.
//  - K3 (lse_grad_table_tf32): W resident, h streamed with its g and lse. P^T = g exp(S^T + mask
//    - lse), then dW += P^T h, a row tile at a time as K2's. A block per (64-item tile, row split); the splits' f32 partials are
//    added in split order by add_partials.
// So the logits of a (row tile, item tile) pair are computed once, whatever dim is, and every
// output element has one owner that sums in a fixed order: the same bits from run to run. Each
// product takes as many TF32 terms as its operands need for f32 accuracy (tensor_core.cuh): an
// f32 operand hi + lo, a bf16 one (exact in TF32) hi alone. So, logits + weighted sum: K1 f32 h
// and W 3, bf16 h against f32 W 2, bf16 both 1; K2 3 + 3, 2 + 3, 1 + 2; K3 3 + 3, 2 + 2, 1 + 2
// (P is f32). Shared memory rows are padded so that every fragment read hits 32 distinct banks.
//
// Occupancy. K1 and K2 stream 64 items a tile unless the resident h (hi + lo for f32) and two
// stages of W then leave one block an SM: f32 h and W at dim 128 (132 KB) stream 32 items a tile
// (99 KB, two blocks an SM). The summation order over items is the same either way.

constexpr int kTileTF = 64;         // resident rows of a block; streamed rows of a tile, at most
constexpr int kThreadsTF = 128;     // 4 warps, 16 resident rows each
constexpr int kMaxDimTF = 128;      // K2's dh and K3's dW tile in registers: 64 f32 a lane at dim = 128
constexpr int kStagesTF = 2;        // streamed tiles in flight
constexpr size_t kTwoBlocksTF = 113 * 1024;  // the most shared memory a block may take for two to fit an SM

template <typename T>
__host__ __device__ constexpr bool needs_lo() { return sizeof(T) == sizeof(float); }  // f32: hi + lo; bf16: exact in TF32

// words (TF32 bits) per resident row, elements per streamed row: f32 rows 4 words past a multiple of 32
template <int kDim>
__host__ __device__ constexpr int resident_stride() { return kDim + 4; }
template <typename T, int kDim>
__host__ __device__ constexpr int streamed_stride() { return kDim + (sizeof(T) == sizeof(float) ? 4 : 8); }

template <typename TR, int kDim>
__host__ __device__ constexpr size_t resident_bytes() {
  return sizeof(unsigned) * kTileTF * resident_stride<kDim>() * (needs_lo<TR>() ? 2 : 1);
}
template <typename TS, int kDim, int kRows>
__host__ __device__ constexpr size_t streamed_bytes() {
  return sizeof(TS) * kStagesTF * kRows * streamed_stride<TS, kDim>();
}

// K1, K2: W rows per streamed tile, 64 unless that leaves one block an SM
template <typename TH, typename TW, int kDim>
__host__ __device__ constexpr int item_rows() {
  return resident_bytes<TH, kDim>() + streamed_bytes<TW, kDim, kTileTF>() <= kTwoBlocksTF ? kTileTF : kTileTF / 2;
}
template <typename TH, typename TW, int kDim>
constexpr size_t row_tile_tf32_bytes() {
  return resident_bytes<TH, kDim>() + streamed_bytes<TW, kDim, item_rows<TH, TW, kDim>()>();
}
template <typename TH, typename TW, int kDim>
constexpr size_t grad_table_tf32_bytes() {  // + the stages' g and lse
  return resident_bytes<TW, kDim>() + streamed_bytes<TH, kDim, kTileTF>() + sizeof(float) * 2 * kStagesTF * kTileTF;
}

// The resident tile: rows r0 .. r0 + 63 of x [extent, dim] in f32, split once into TF32 hi (and lo
// where TR needs one); rows past extent and columns past dim are 0.
template <typename TR, int kDim>
__device__ __forceinline__ void load_resident(const TR* __restrict__ x, int r0, int extent, int dim,
                                              unsigned* hi, unsigned* lo) {
  constexpr int kR = resident_stride<kDim>();
  for (int idx = threadIdx.x; idx < kTileTF * kDim; idx += kThreadsTF) {
    const int r = idx / kDim;
    const int c = idx - r * kDim;
    const float v = (r0 + r < extent && c < dim) ? to_f32(x[static_cast<size_t>(r0 + r) * dim + c]) : 0.f;
    unsigned part;
    tf32_parts(v, hi[r * kR + c], part);
    if constexpr (needs_lo<TR>()) lo[r * kR + c] = part;
  }
}

// A streamed tile: rows r0 .. r0 + kRows - 1 of x [extent, dim], copied as they are by cp.async
// (16 bytes each: x on a 16-byte boundary, dim a multiple of 8); rows past extent and columns past
// dim are zero-filled. The caller commits the group.
template <typename TS, int kDim, int kRows>
__device__ __forceinline__ void load_streamed(const TS* __restrict__ x, int r0, int extent, int dim, TS* tile) {
  constexpr int kS = streamed_stride<TS, kDim>();
  constexpr int kChunk = 16 / sizeof(TS);  // elements per 16-byte copy
  for (int idx = threadIdx.x; idx < kRows * (kDim / kChunk); idx += kThreadsTF) {
    const int r = idx / (kDim / kChunk);
    const int c = (idx % (kDim / kChunk)) * kChunk;
    const bool valid = r0 + r < extent && c < dim;
    cp_async_16(tile + r * kS + c, x + (valid ? static_cast<size_t>(r0 + r) * dim + c : 0), valid);
  }
}

// The logits of the warp's 16 resident rows (r_hi / r_lo from its first row) against a streamed
// tile of kRows rows: s[nb] is the 16 x 8 block of streamed rows nb * 8 .. nb * 8 + 7. Lane
// (fr, fc) holds resident rows fr, fr + 8 and streamed rows nb * 8 + 2 fc, nb * 8 + 2 fc + 1.
template <typename TR, typename TS, int kDim, int kRows>
__device__ __forceinline__ void logits_tile_tf32(const unsigned* r_hi, const unsigned* r_lo, const TS* tile,
                                                 int fr, int fc, float (&s)[kRows / 8][4]) {
  constexpr int kR = resident_stride<kDim>();
  constexpr int kS = streamed_stride<TS, kDim>();
#pragma unroll
  for (int nb = 0; nb < kRows / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kDim / 8; ++kk) {
    const int at = fr * kR + kk * 8 + fc;
    const unsigned a_hi[4] = {r_hi[at], r_hi[at + 8 * kR], r_hi[at + 4], r_hi[at + 8 * kR + 4]};
    unsigned a_lo[4] = {0u, 0u, 0u, 0u};
    if constexpr (needs_lo<TR>()) {
      a_lo[0] = r_lo[at];
      a_lo[1] = r_lo[at + 8 * kR];
      a_lo[2] = r_lo[at + 4];
      a_lo[3] = r_lo[at + 8 * kR + 4];
    }
#pragma unroll
    for (int nb = 0; nb < kRows / 8; ++nb) {
      const TS* row = tile + (nb * 8 + fr) * kS + kk * 8 + fc;  // B = tile^T: row nb * 8 + fr, columns fc, fc + 4
      unsigned b_hi[2], b_lo[2];
      tf32_parts(row[0], b_hi[0], b_lo[0]);
      tf32_parts(row[4], b_hi[1], b_lo[1]);
      mma_split<needs_lo<TR>(), needs_lo<TS>()>(s[nb], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Writes acc, rows r and r + 8 of out [extent, dim] as add_tile_products leaves them, past extent
// and dim nothing.
template <typename T, int kDim>
__device__ __forceinline__ void store_rows(const float (&acc)[kDim / 8][4], T* out, int r, int extent, int dim,
                                           int fc) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (r + hh * 8 >= extent) continue;
#pragma unroll
    for (int dn = 0; dn < kDim / 8; ++dn) {
      const int c = dn * 8 + 2 * fc;
      if (c < dim) store_pair(out + static_cast<size_t>(r + hh * 8) * dim + c, acc[dn][2 * hh], acc[dn][2 * hh + 1]);
    }
  }
}

// K1, "tf32". Grid: (row tiles). A lane keeps a running max and sum for its rows fr, fr + 8 over
// its columns of each tile; the running max starts at -inf and is only updated from a tile in
// which the lane has a column, as in lse_forward.
template <typename TH, typename TW, int kDim>
__global__ void __launch_bounds__(kThreadsTF)
lse_forward_tf32(const TH* __restrict__ h, const TW* __restrict__ w, float* __restrict__ lse, int rows, int items,
                 int dim, int num_valid) {
  constexpr int kItems = item_rows<TH, TW, kDim>();
  constexpr int kR = resident_stride<kDim>();
  constexpr int kItemTile = kItems * streamed_stride<TW, kDim>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* h_hi = reinterpret_cast<unsigned*>(smem_raw);                        // [kTileTF][kR], TF32 bits
  unsigned* h_lo = h_hi + kTileTF * kR;                                          // [kTileTF][kR] if h needs a lo part
  TW* w_s = reinterpret_cast<TW*>(h_lo + (needs_lo<TH>() ? kTileTF * kR : 0));  // [kStagesTF][kItems][kS]

  const int n0 = blockIdx.x * kTileTF;
  const int warp = threadIdx.x >> 5;
  const int fr = (threadIdx.x & 31) >> 2;  // fragment row: rows fr, fr + 8 of the warp's 16
  const int fc = threadIdx.x & 3;
  const int row = n0 + warp * 16 + fr;

  // the first item tile flies while the h tile is read, converted and split
  load_streamed<TW, kDim, kItems>(w, 0, items, dim, w_s);
  cp_async_commit();
  load_resident<TH, kDim>(h, n0, rows, dim, h_hi, h_lo);

  float run_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float run_sum[2] = {0.f, 0.f};
  int stage = 0;
  for (int i0 = 0; i0 < items; i0 += kItems) {
    if (i0 + kItems < items) load_streamed<TW, kDim, kItems>(w, i0 + kItems, items, dim, w_s + (stage ^ 1) * kItemTile);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this item tile has landed
    __syncthreads();     // ... for every thread; on the first pass the h tile is written too
    float s[kItems / 8][4];
    logits_tile_tf32<TH, TW, kDim, kItems>(h_hi + warp * 16 * kR, h_lo + warp * 16 * kR, w_s + stage * kItemTile,
                                           fr, fc, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tile_max = -CUDART_INF_F;
      bool any = false;
#pragma unroll
      for (int nb = 0; nb < kItems / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = i0 + nb * 8 + 2 * fc + j;
          s[nb][2 * hh + j] = masked(s[nb][2 * hh + j], i, num_valid);
          if (i < items) {
            any = true;
            tile_max = fmaxf(tile_max, s[nb][2 * hh + j]);
          }
        }
      }
      // no column of this tile is the lane's (a NaN logit is not skipped: fmaxf drops it from
      // the max, but the sum below carries it to lse)
      if (!any) continue;
      const float new_max = fmaxf(run_max[hh], tile_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kItems / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (i0 + nb * 8 + 2 * fc + j < items) tile_sum += expf(s[nb][2 * hh + j] - new_max);
        }
      }
      run_sum[hh] = run_sum[hh] * expf(run_max[hh] - new_max) + tile_sum;
      run_max[hh] = new_max;
    }
    __syncthreads();  // this stage is consumed before the next pass refills it
    stage ^= 1;
  }
  // merge the 4 lanes of each row (fc = 0..3 of one lane quad)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = run_max[hh];
    float sum = run_sum[hh];
#pragma unroll
    for (int offset = 2; offset > 0; offset >>= 1) {
      const float m_other = __shfl_xor_sync(kFull, m, offset);
      const float s_other = __shfl_xor_sync(kFull, sum, offset);
      const float merged = fmaxf(m, m_other);
      if (merged != -CUDART_INF_F) {  // a lane with no column at all has max -inf, sum 0
        sum = (m == -CUDART_INF_F ? 0.f : sum * expf(m - merged)) +
              (m_other == -CUDART_INF_F ? 0.f : s_other * expf(m_other - merged));
        m = merged;
      }
    }
    const int n = row + hh * 8;
    if (fc == 0 && n < rows) lse[n] = m + logf(sum);
  }
}

// K2, "tf32". Grid: (row tiles).
template <typename TH, typename TW, int kDim>
__global__ void __launch_bounds__(kThreadsTF)
lse_grad_hidden_tf32(const TH* __restrict__ h, const TW* __restrict__ w, const float* __restrict__ g,
                     const float* __restrict__ lse, TH* __restrict__ dh, int rows, int items, int dim,
                     int num_valid) {
  constexpr int kItems = item_rows<TH, TW, kDim>();
  constexpr int kR = resident_stride<kDim>();
  constexpr int kItemTile = kItems * streamed_stride<TW, kDim>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* h_hi = reinterpret_cast<unsigned*>(smem_raw);                        // [kTileTF][kR], TF32 bits
  unsigned* h_lo = h_hi + kTileTF * kR;                                          // [kTileTF][kR] if h needs a lo part
  TW* w_s = reinterpret_cast<TW*>(h_lo + (needs_lo<TH>() ? kTileTF * kR : 0));  // [kStagesTF][kItems][kS]

  const int n0 = blockIdx.x * kTileTF;
  const int warp = threadIdx.x >> 5;
  const int fr = (threadIdx.x & 31) >> 2;  // fragment row: rows fr, fr + 8 of the warp's 16
  const int fc = threadIdx.x & 3;
  const int row = n0 + warp * 16 + fr;

  load_streamed<TW, kDim, kItems>(w, 0, items, dim, w_s);
  cp_async_commit();
  load_resident<TH, kDim>(h, n0, rows, dim, h_hi, h_lo);
  float g_r[2], lse_r[2];  // rows past the input get weight 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = row + hh * 8;
    g_r[hh] = n < rows ? g[n] : 0.f;
    lse_r[hh] = n < rows ? lse[n] : 0.f;
  }

  float acc[kDim / 8][4];
#pragma unroll
  for (int dn = 0; dn < kDim / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }
  int stage = 0;
  for (int i0 = 0; i0 < items; i0 += kItems) {
    if (i0 + kItems < items) load_streamed<TW, kDim, kItems>(w, i0 + kItems, items, dim, w_s + (stage ^ 1) * kItemTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const TW* ws = w_s + stage * kItemTile;
    float s[kItems / 8][4];
    logits_tile_tf32<TH, TW, kDim, kItems>(h_hi + warp * 16 * kR, h_lo + warp * 16 * kR, ws, fr, fc, s);
    // P = g exp(S + mask - lse); 0 for items past the table (and, by g, rows past the input)
#pragma unroll
    for (int nb = 0; nb < kItems / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + nb * 8 + 2 * fc + (e & 1);
        s[nb][e] = i < items ? expf(masked(s[nb][e], i, num_valid) - lse_r[e >> 1]) * g_r[e >> 1] : 0.f;
      }
    }
    add_tile_products<needs_lo<TW>(), kItems, kDim, streamed_stride<TW, kDim>()>(
        s, ws + 2 * fc * streamed_stride<TW, kDim>() + fr, acc);
    __syncthreads();
    stage ^= 1;
  }
  store_rows<TH, kDim>(acc, dh, row, rows, dim, fc);
}

// K3, "tf32". Grid: (item tiles, row splits). With one split the result goes to dw in w's type;
// otherwise to the split's f32 partial [items, dim], which add_partials sums.
template <typename TH, typename TW, int kDim>
__global__ void __launch_bounds__(kThreadsTF)
lse_grad_table_tf32(const TH* __restrict__ h, const TW* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ lse, TW* __restrict__ dw, float* __restrict__ partial,
                    int rows, int items, int dim, int num_valid, int rows_per_split) {
  constexpr int kW = resident_stride<kDim>();
  constexpr int kRowTile = kTileTF * streamed_stride<TH, kDim>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* w_hi = reinterpret_cast<unsigned*>(smem_raw);  // [kTileTF][kW], TF32 bits
  unsigned* w_lo = w_hi + kTileTF * kW;                    // [kTileTF][kW] if W needs a lo part
  TH* h_s = reinterpret_cast<TH*>(w_lo + (needs_lo<TW>() ? kTileTF * kW : 0));  // [kStagesTF][kTileTF][kH]
  float* g_s = reinterpret_cast<float*>(h_s + kStagesTF * kRowTile);            // [kStagesTF][kTileTF]
  float* lse_s = g_s + kStagesTF * kTileTF;                                       // [kStagesTF][kTileTF]

  const int i0 = blockIdx.x * kTileTF;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(rows, row_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int fr = (tid & 31) >> 2;  // fragment row: items fr, fr + 8 of the warp's 16
  const int fc = tid & 3;
  const int item0 = i0 + warp * 16 + fr;

  auto load_rows = [&](int n0, int stage) {
    load_streamed<TH, kDim, kTileTF>(h, n0, row_end, dim, h_s + stage * kRowTile);
    if (tid < kTileTF) {
      const int n = n0 + tid;
      const bool valid = n < row_end;
      cp_async_4(g_s + stage * kTileTF + tid, g + (valid ? n : 0), valid);
      cp_async_4(lse_s + stage * kTileTF + tid, lse + (valid ? n : 0), valid);
    }
  };

  // the first row tile flies while the W tile is read, converted and split
  if (row_begin < row_end) load_rows(row_begin, 0);
  cp_async_commit();
  load_resident<TW, kDim>(w, i0, items, dim, w_hi, w_lo);

  float acc[kDim / 8][4];
#pragma unroll
  for (int dn = 0; dn < kDim / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }
  int stage = 0;
  for (int n0 = row_begin; n0 < row_end; n0 += kTileTF) {
    if (n0 + kTileTF < row_end) load_rows(n0 + kTileTF, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this row tile has landed
    __syncthreads();     // ... for every thread; on the first pass the W tile is written too
    const TH* hs = h_s + stage * kRowTile;
    const float* gs = g_s + stage * kTileTF;
    const float* ls = lse_s + stage * kTileTF;

    float s[kTileTF / 8][4];
    logits_tile_tf32<TW, TH, kDim, kTileTF>(w_hi + warp * 16 * kW, w_lo + warp * 16 * kW, hs, fr, fc, s);
    // P^T = g exp(S^T + mask - lse); 0 for items past the table and rows past the split
#pragma unroll
    for (int nb = 0; nb < kTileTF / 8; ++nb) {
      const int r = nb * 8 + 2 * fc;
      const float2 g2 = *reinterpret_cast<const float2*>(gs + r);
      const float2 lse2 = *reinterpret_cast<const float2*>(ls + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = item0 + (e >> 1) * 8;
        const int n = n0 + r + (e & 1);
        const float g_n = (e & 1) ? g2.y : g2.x;
        const float lse_n = (e & 1) ? lse2.y : lse2.x;
        s[nb][e] = (i < items && n < row_end) ? expf(masked(s[nb][e], i, num_valid) - lse_n) * g_n : 0.f;
      }
    }
    add_tile_products<needs_lo<TH>(), kTileTF, kDim, streamed_stride<TH, kDim>()>(
        s, hs + 2 * fc * streamed_stride<TH, kDim>() + fr, acc);
    __syncthreads();  // this stage is consumed before the next pass refills it
    stage ^= 1;
  }
  cp_async_wait<0>();  // the first tile's copies, if the split had no row

  if (partial == nullptr) {
    store_rows<TW, kDim>(acc, dw, item0, items, dim, fc);
  } else {
    store_rows<float, kDim>(acc, partial + static_cast<size_t>(blockIdx.y) * items * dim, item0, items, dim, fc);
  }
}

// Runs kKernel with `smem` bytes of dynamic shared memory, once opted in to them.
template <auto kKernel, typename... Args>
cudaError_t launch_tf32(dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_shared_memory<kKernel>(smem);
  if (err != cudaSuccess) return err;
  kKernel<<<grid, kThreadsTF, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename TH, typename TW, int kDim>
cudaError_t run_forward_tf32(const void* h, const void* w, float* lse, int rows, int items, int dim, int num_valid,
                             cudaStream_t stream) {
  return launch_tf32<lse_forward_tf32<TH, TW, kDim>>(
      dim3(tiles(rows)), row_tile_tf32_bytes<TH, TW, kDim>(), stream, static_cast<const TH*>(h),
      static_cast<const TW*>(w), lse, rows, items, dim, num_valid);
}

template <typename TH, typename TW, int kDim>
cudaError_t run_grad_hidden_tf32(const void* h, const void* w, const float* g, const float* lse, void* dh, int rows,
                                 int items, int dim, int num_valid, cudaStream_t stream) {
  return launch_tf32<lse_grad_hidden_tf32<TH, TW, kDim>>(
      dim3(tiles(rows)), row_tile_tf32_bytes<TH, TW, kDim>(), stream, static_cast<const TH*>(h),
      static_cast<const TW*>(w), g, lse, static_cast<TH*>(dh), rows, items, dim, num_valid);
}

template <typename TH, typename TW, int kDim>
cudaError_t run_grad_table_tf32(const void* h, const void* w, const float* g, const float* lse, void* dw,
                                float* partial, int rows, int items, int dim, int num_valid, int splits,
                                int rows_per_split, cudaStream_t stream) {
  const cudaError_t err = launch_tf32<lse_grad_table_tf32<TH, TW, kDim>>(
      dim3(tiles(items), static_cast<unsigned>(splits)), grad_table_tf32_bytes<TH, TW, kDim>(), stream,
      static_cast<const TH*>(h), static_cast<const TW*>(w), g, lse, static_cast<TW*>(dw),
      splits > 1 ? partial : nullptr, rows, items, dim, num_valid, rows_per_split);
  if (err != cudaSuccess) return err;
  return finish_partials<TW>(partial, dw, items, dim, splits, stream);
}

// run(TH{}, TW{}) with the element types the flags name
template <typename Run>
cudaError_t by_types(int h_bf16, int w_bf16, Run&& run) {
  if (h_bf16) return w_bf16 ? run(__nv_bfloat16{}, __nv_bfloat16{}) : run(__nv_bfloat16{}, 0.f);
  return w_bf16 ? run(0.f, __nv_bfloat16{}) : run(0.f, 0.f);
}

// run(std::integral_constant<int, kDim>{}) with the tf32 kernels' smallest kDim of 32, 64, 128 that holds dim
template <typename Run>
cudaError_t by_dim(int dim, Run&& run) {
  if (dim <= 32) return run(std::integral_constant<int, 32>{});
  if (dim <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, kMaxDimTF>{});
}

bool bad_shape(int rows, int items, int dim) {
  return rows < 1 || items < 1 || dim < 1 || slices(dim) > 65535u;
}

// what the tf32 variants refuse besides: dim not a multiple of 8 in 8 .. 128, or the streamed
// operand off a 16-byte boundary
int bad_tf32(int dim, const void* streamed) {
  if (dim < 8 || dim > kMaxDimTF || dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<size_t>(streamed) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

// what both K3 variants refuse in their row split
bool bad_split(int rows, int items, int dim, const void* partial, int splits, int rows_per_split) {
  return bad_shape(rows, items, dim) || splits < 1 || splits > 65535 || rows_per_split < 1 ||
         rows_per_split % kTile != 0 || static_cast<long long>(splits) * rows_per_split < rows ||
         (splits > 1 && partial == nullptr);
}

}  // namespace

extern "C" int replay_fused_lse_forward(const void* h, const void* w, void* lse, int rows,
                                        int items, int dim, int num_valid, int h_bf16,
                                        int w_bf16, void* stream) {
  if (bad_shape(rows, items, dim)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return run_forward<decltype(th), decltype(tw)>(h, w, static_cast<float*>(lse), rows, items, dim, num_valid,
                                                   static_cast<cudaStream_t>(stream));
  }));
}

// K1's "tf32" variant: as replay_fused_lse_forward, for dim a multiple of 8 up to 128 and w on a
// 16-byte boundary
extern "C" int replay_fused_lse_forward_tf32(const void* h, const void* w, void* lse, int rows, int items, int dim,
                                             int num_valid, int h_bf16, int w_bf16, void* stream) {
  if (bad_shape(rows, items, dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = bad_tf32(dim, w)) return err;
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return by_dim(dim, [&](auto d) {
      return run_forward_tf32<decltype(th), decltype(tw), decltype(d)::value>(
          h, w, static_cast<float*>(lse), rows, items, dim, num_valid, static_cast<cudaStream_t>(stream));
    });
  }));
}

extern "C" int replay_fused_lse_grad_hidden(const void* h, const void* w, const void* g,
                                            const void* lse, void* dh, int rows, int items,
                                            int dim, int num_valid, int h_bf16, int w_bf16,
                                            void* stream) {
  if (bad_shape(rows, items, dim)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return run_grad_hidden<decltype(th), decltype(tw)>(h, w, static_cast<const float*>(g),
                                                       static_cast<const float*>(lse), dh, rows, items, dim,
                                                       num_valid, static_cast<cudaStream_t>(stream));
  }));
}

// K2's "tf32" variant: as replay_fused_lse_grad_hidden, for dim a multiple of 8 up to 128 and w on
// a 16-byte boundary
extern "C" int replay_fused_lse_grad_hidden_tf32(const void* h, const void* w, const void* g, const void* lse,
                                                 void* dh, int rows, int items, int dim, int num_valid, int h_bf16,
                                                 int w_bf16, void* stream) {
  if (bad_shape(rows, items, dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = bad_tf32(dim, w)) return err;
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return by_dim(dim, [&](auto d) {
      return run_grad_hidden_tf32<decltype(th), decltype(tw), decltype(d)::value>(
          h, w, static_cast<const float*>(g), static_cast<const float*>(lse), dh, rows, items, dim, num_valid,
          static_cast<cudaStream_t>(stream));
    });
  }));
}

extern "C" int replay_fused_lse_grad_table(const void* h, const void* w, const void* g,
                                           const void* lse, void* dw, void* partial, int rows,
                                           int items, int dim, int num_valid, int splits,
                                           int rows_per_split, int h_bf16, int w_bf16,
                                           void* stream) {
  if (bad_split(rows, items, dim, partial, splits, rows_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return run_grad_table<decltype(th), decltype(tw)>(
        h, w, static_cast<const float*>(g), static_cast<const float*>(lse), dw, static_cast<float*>(partial), rows,
        items, dim, num_valid, splits, rows_per_split, static_cast<cudaStream_t>(stream));
  }));
}

// K3's "tf32" variant: as replay_fused_lse_grad_table, for dim a multiple of 8 up to 128 and h on
// a 16-byte boundary
extern "C" int replay_fused_lse_grad_table_tf32(const void* h, const void* w, const void* g,
                                                const void* lse, void* dw, void* partial, int rows,
                                                int items, int dim, int num_valid, int splits,
                                                int rows_per_split, int h_bf16, int w_bf16,
                                                void* stream) {
  if (bad_split(rows, items, dim, partial, splits, rows_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int err = bad_tf32(dim, h)) return err;
  return static_cast<int>(by_types(h_bf16, w_bf16, [&](auto th, auto tw) {
    return by_dim(dim, [&](auto d) {
      return run_grad_table_tf32<decltype(th), decltype(tw), decltype(d)::value>(
          h, w, static_cast<const float*>(g), static_cast<const float*>(lse), dw, static_cast<float*>(partial),
          rows, items, dim, num_valid, splits, rows_per_split, static_cast<cudaStream_t>(stream));
    });
  }));
}
