// Fused masked softmax attention, forward only: out = softmax(Q K^T / sqrt(D) + bias) V.
//
// Replaces replay_tpu/ops/flash_attention.py::_attention_kernel (the Pallas kernel
// behind SasRec(use_flash=True)). The TPU kernel keeps one whole [L, L] score
// block per (batch, head) in VMEM; a Hopper block has at most 227 KB of shared
// memory and L = 1024 in f32 is 4 MB, so this kernel is one block per
// (query tile, head, batch) that walks the keys in tiles of 32 with a running
// max and sum in f32 (online softmax). Nothing O(L^2) is held on chip.
//
// Layout: q, k, v, out are contiguous [B, H, L, D] (f32 or bf16, all one type);
// bias is contiguous f32 [B, bias_heads, L, L] with bias_heads 1 or H. A bias
// with one head is read at head 0 for every head, never broadcast in memory.
//
// Work split: a block has kWarps warps and owns kBlockQ = kWarps * kRowsPerWarp
// query rows. For each key tile the block stages K and V in shared memory as
// f32; then every warp takes its rows one by one, lane j scoring key j of the
// tile (a D-long dot product), and the 32 probabilities are broadcast by shuffle
// into the output accumulator, where lane j owns columns j, j + 32, ...
//
// Masks: -inf entries (the training mask) give probability exactly 0; a row is
// skipped until it meets its first finite score, so no inf - inf is formed.
// finfo.min and -1e30 entries stay finite through the subtraction of the row
// max, and a row whose every entry is -1e30 gives the mean of V, as the Pallas
// kernel does. The denominator is clamped at 1e-30 like the Pallas kernel's.
//
// C interface, bound from Python with ctypes: replay_flash_attention_forward
// launches on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kMaxDim = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, offset));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(kFull, x, offset);
  return x;
}

// kChunks = ceil(D / 32): the output columns one lane accumulates.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kWarps * 32)
attention_forward(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, T* __restrict__ out, int heads, int length,
                  int dim, int bias_heads, float scale) {
  extern __shared__ float smem[];
  const int k_stride = dim + 1;  // odd row stride: lane j reading key row j hits bank (j + c) % 32
  float* q_tile = smem;                          // [kBlockQ][dim]
  float* k_tile = q_tile + kBlockQ * dim;        // [kBlockK][dim + 1]
  float* v_tile = k_tile + kBlockK * k_stride;   // [kBlockK][dim]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_base = (static_cast<size_t>(b) * heads + h) * length * dim;
  const float* bias_bh =
      bias + (static_cast<size_t>(b) * bias_heads + (bias_heads > 1 ? h : 0)) * length * length;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < kBlockQ * dim; e += blockDim.x) {
    const int r = e / dim;
    const int row = q0 + r;
    q_tile[e] = row < length ? load_f32(q + head_base + static_cast<size_t>(row) * dim + (e - r * dim)) : 0.f;
  }

  float row_max[kRowsPerWarp];
  float row_sum[kRowsPerWarp];
  float acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_max[i] = -CUDART_INF_F;
    row_sum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < length; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (first pass: nothing to wait for)
    for (int e = threadIdx.x; e < kBlockK * dim; e += blockDim.x) {
      const int r = e / dim;
      const int c = e - r * dim;
      const int key = k0 + r;
      const size_t g = head_base + static_cast<size_t>(key) * dim + c;
      k_tile[r * k_stride + c] = key < length ? load_f32(k + g) : 0.f;
      v_tile[e] = key < length ? load_f32(v + g) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int row = q0 + r;
      if (row >= length) break;  // uniform across the warp

      float s = -CUDART_INF_F;
      if (key < length) {
        const float* q_row = q_tile + r * dim;
        const float* k_row = k_tile + lane * k_stride;
        float dot = 0.f;
        for (int c = 0; c < dim; ++c) dot = fmaf(q_row[c], k_row[c], dot);
        s = dot * scale + bias_bh[static_cast<size_t>(row) * length + key];
      }
      const float new_max = fmaxf(row_max[i], warp_max(s));
      if (new_max == -CUDART_INF_F) continue;  // no attendable key yet; uniform across the warp
      const float correction = expf(row_max[i] - new_max);
      const float p = expf(s - new_max);
      row_sum[i] = row_sum[i] * correction + warp_sum(p);
      row_max[i] = new_max;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[i][c] *= correction;
      for (int j = 0; j < kBlockK; ++j) {
        const float p_j = __shfl_sync(kFull, p, j);
        const float* v_row = v_tile + j * dim;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int d = lane + 32 * c;
          if (d < dim) acc[i][c] = fmaf(p_j, v_row[d], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    if (row >= length) break;
    const float inv = 1.f / fmaxf(row_sum[i], 1e-30f);
    T* out_row = out + head_base + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) store_f32(out_row + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int batch, int heads, int length, int dim, int bias_heads, cudaStream_t stream) {
  const size_t smem_bytes =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * dim + kBlockK * (dim + 1) + kBlockK * dim);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_forward<T, kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((length + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_forward<T, kChunks><<<grid, kWarps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), heads, length, dim, bias_heads, 1.f / sqrtf(static_cast<float>(dim)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias, void* out,
                     int batch, int heads, int length, int dim, int bias_heads,
                     cudaStream_t stream) {
  switch ((dim + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 2: return launch<T, 2>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 3: return launch<T, 3>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 4: return launch<T, 4>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 5: return launch<T, 5>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 6: return launch<T, 6>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 7: return launch<T, 7>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    case 8: return launch<T, 8>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int replay_flash_attention_forward(const void* q, const void* k, const void* v,
                                              const void* bias, void* out, int batch, int heads,
                                              int length, int dim, int bias_heads, int is_bf16,
                                              void* stream) {
  if (batch < 1 || heads < 1 || length < 1 || dim < 1 || dim > kMaxDim || batch > 65535 ||
      heads > 65535 || (bias_heads != 1 && bias_heads != heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bias_f32 = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, bias_f32, out, batch, heads, length, dim, bias_heads, s)
              : dispatch<float>(q, k, v, bias_f32, out, batch, heads, length, dim, bias_heads, s);
  return static_cast<int>(err);
}
