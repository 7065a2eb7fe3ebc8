// Fused masked softmax attention, forward only: out = softmax(Q K^T / sqrt(D) + bias) V.
//
// Replaces replay_tpu/ops/flash_attention.py::_attention_kernel (the Pallas kernel
// behind SasRec(use_flash=True)). The TPU kernel keeps one whole [L, L] score
// block per (batch, head) in VMEM, one exact softmax pass. Here one block owns
// (a tile of query rows, head, batch). When the whole key range fits in shared
// memory (K and V of L keys in f32 within about 100 KB: L <= 192 at D = 64, which
// covers SASRec's serving and training windows), the block stages every key once
// and runs the same single exact pass. Beyond that it walks 64-key tiles with a
// running max and sum in f32 (online softmax). Nothing O(L^2) is held on chip.
//
// Layout: q, k, v, out are contiguous [B, H, L, D] (f32 or bf16, all one type,
// arithmetic in f32 either way); bias is contiguous f32 [B, bias_heads, L, L] with
// bias_heads 1 or H. A bias with one head is read at head 0 for every head, never
// broadcast in memory.
//
// What bounds it at the serving shape, B=64, H=1, L=50, D=64, f32: it moves 3.3 MB
// of q/k/v/out and 0.64 MB of bias, about 1.2 us at 3.35 TB/s, and does
// 4 B H L^2 D = 41 MFLOP, 0.6 us at 67 TFLOP/s of f32 on the CUDA cores. So below a
// few us its time is latency: a launch, one round of global loads, and the longest
// chain of dependent instructions in a block. The design shortens that chain:
//  - staging: K, V, Q as f32 in shared memory with 16-byte loads (8 bytes for bf16),
//    all issued before the one barrier; the block's bias rows, one contiguous span
//    of the [L, L] matrix on the one-pass path, read with 16-byte loads too;
//  - scores: a warp owns kRowsPerWarp query rows and a lane kKeys keys (lane + 32 j),
//    every (row, key) an independent accumulator fed by float4 reads of Q (broadcast)
//    and K (row stride an odd count of 16-byte units: conflict-free);
//  - softmax: row max and sum by shuffle, the warp's rows reduced together;
//  - P V: probabilities written once to shared memory; a lane accumulates
//    kRowsPerWarp rows x D/32 contiguous columns from vector V reads, four keys per
//    float4 read of P, with no shuffle-broadcast chain;
//  - rows per block: 16, or 4 when 16 would leave fewer blocks than the card has
//    SMs (the serving bucket B=1 gets 13 blocks, not 4).
// Warps touch only their own rows after the barrier, so a one-pass block has one
// block-wide barrier. No tensor cores: the products are too small to feed them.
//
// Masks: -inf entries (the training mask) give probability exactly 0; a row is
// skipped until it meets its first finite score, so no inf - inf is formed.
// finfo.min and -1e30 entries stay finite through the subtraction of the row
// max, and a row whose every entry is -1e30 gives the mean of V, as the Pallas
// kernel does. The denominator is clamped at 1e-30 like the Pallas kernel's; the
// one-pass path divides the probabilities by it before the product, as the Pallas
// kernel does, the tiled path divides the output at the end.
//
// C interface, bound from Python with ctypes: replay_flash_attention_forward
// launches on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted). q, k, v and out
// must start on a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 256;
constexpr int kOnlineTile = 64;                   // keys per tile on the tiled path
constexpr int kMaxOnePass = 192;                  // keys the one-pass path holds: 6 a lane
constexpr size_t kOnePassBytes = 100 * 1024;      // K and V of the one-pass path, shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// four consecutive elements as f32, one vector load (16 bytes f32, 8 bytes bf16)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// columns c .. c + 3 of a row of `dim` elements, zero past dim; `vec`: dim % 4 == 0, so the
// four lie on a vector boundary
template <typename T>
__device__ __forceinline__ float4 load_chunk(const T* row, int c, int dim, bool vec) {
  if (vec) return load4(row + c);
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = c + i < dim ? load_f32(row + c + i) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// kN consecutive floats of shared memory (kN * 4 bytes aligned, 16 at most)
template <int kN>
__device__ __forceinline__ void load_run(const float* p, float (&x)[kN]) {
  if constexpr (kN == 1) {
    x[0] = p[0];
  } else if constexpr (kN == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      x[i] = a.x;
      x[i + 1] = a.y;
      x[i + 2] = a.z;
      x[i + 3] = a.w;
    }
  }
}

// kN consecutive outputs; one vector store when f32, whole and aligned
template <int kN>
__device__ __forceinline__ void store_run(float* p, const float (&x)[kN], int valid, bool vec) {
  if (vec && valid >= kN && kN >= 2) {
    if constexpr (kN == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else if constexpr (kN >= 4) {
#pragma unroll
      for (int i = 0; i < kN; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i < valid) p[i] = x[i];
  }
}

template <int kN>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&x)[kN], int valid, bool) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i < valid) store_f32(p + i, x[i]);
  }
}

size_t shared_bytes(int dim_cap, int rows, int tile_len, int bias_len) {
  const size_t floats = static_cast<size_t>(tile_len) * (dim_cap + 4)  // K
                        + static_cast<size_t>(tile_len) * dim_cap      // V
                        + static_cast<size_t>(rows) * dim_cap          // Q
                        + static_cast<size_t>(rows) * tile_len         // probabilities
                        + (bias_len ? static_cast<size_t>(rows) * bias_len + 4 : 0);  // bias rows
  return floats * sizeof(float);
}

// kChunks: output columns a lane owns (D rounded up to 32 kChunks); kKeys: keys a lane
// scores per tile; kRowsPerWarp: query rows a warp owns. tile_len (a multiple of 32, at most
// 32 kKeys) >= length means one exact pass over every key.
template <typename T, int kChunks, int kKeys, int kRowsPerWarp>
__global__ void __launch_bounds__(kThreads)
attention_forward(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, T* __restrict__ out, int heads, int length,
                  int dim, int bias_heads, float scale, int tile_len) {
  constexpr int kDimCap = 32 * kChunks;
  constexpr int kRows = kWarps * kRowsPerWarp;
  constexpr int kKStride = kDimCap + 4;  // an odd count of 16-byte units
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                            // [tile_len][kKStride]
  float* v_s = k_s + tile_len * kKStride;       // [tile_len][kDimCap]
  float* q_s = v_s + tile_len * kDimCap;        // [kRows][kDimCap]
  float* p_s = q_s + kRows * kDimCap;           // [kRows][tile_len]
  float* bias_s = p_s + kRows * tile_len;       // one pass: the block's bias rows

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_base = (static_cast<size_t>(b) * heads + h) * length * dim;
  const float* bias_bh =
      bias + (static_cast<size_t>(b) * bias_heads + (bias_heads > 1 ? h : 0)) * length * length;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRowsPerWarp;  // the warp's first row in the block
  const bool vec = dim % 4 == 0;
  const int dim4 = (dim + 3) & ~3;
  const bool one_pass = tile_len >= length;

  for (int e = tid; e < kRows * kDimCap / 4; e += kThreads) {
    const int r = e / (kDimCap / 4);
    const int c = e % (kDimCap / 4) * 4;
    const int row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < length && c < dim) x = load_chunk(q + head_base + static_cast<size_t>(row) * dim, c, dim, vec);
    *reinterpret_cast<float4*>(q_s + r * kDimCap + c) = x;
  }

  // one pass: the block's bias rows are one contiguous span of the [L, L] matrix;
  // span[i] goes to bias_s[pad + i], pad chosen so that both sides share their 16-byte phase
  int pad = 0;
  if (one_pass) {
    const float* span = bias_bh + static_cast<size_t>(q0) * length;
    const int n = min(kRows, length - q0) * length;
    pad = static_cast<int>(reinterpret_cast<size_t>(span) / sizeof(float) % 4);
    const int head = min(n, (4 - pad) % 4);  // scalars up to the first 16-byte boundary
    const int n_vec = (n - head) / 4;
    for (int i = tid; i < head; i += kThreads) bias_s[pad + i] = span[i];
    for (int i = tid; i < n_vec; i += kThreads) {
      *reinterpret_cast<float4*>(bias_s + pad + head + 4 * i) = *reinterpret_cast<const float4*>(span + head + 4 * i);
    }
    for (int i = head + 4 * n_vec + tid; i < n; i += kThreads) bias_s[pad + i] = span[i];
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

  for (int k0 = 0; k0 < length; k0 += tile_len) {
    if (k0 > 0) __syncthreads();  // the previous tile's K and V are consumed
    for (int e = tid; e < tile_len * kDimCap / 4; e += kThreads) {
      const int r = e / (kDimCap / 4);
      const int c = e % (kDimCap / 4) * 4;
      const int key = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (key < length && c < dim) {
        const size_t at = head_base + static_cast<size_t>(key) * dim;
        kx = load_chunk(k + at, c, dim, vec);
        vx = load_chunk(v + at, c, dim, vec);
      }
      *reinterpret_cast<float4*>(k_s + r * kKStride + c) = kx;
      *reinterpret_cast<float4*>(v_s + r * kDimCap + c) = vx;
    }
    __syncthreads();
    const int n_keys = min(tile_len, length - k0);
    const int lane_keys = (n_keys + 31) / 32;  // a lane scores keys lane + 32 j, j < lane_keys

    // scores: every (row, key) of the lane an independent accumulator
    float s[kRowsPerWarp][kKeys];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < dim4; c += 4) {
      float4 kv[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (j < lane_keys) kv[j] = *reinterpret_cast<const float4*>(k_s + (lane + 32 * j) * kKStride + c);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + i) * kDimCap + c);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          if (j < lane_keys) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
    }

    // scale and bias; keys and rows past L get -inf (probability 0)
    float tile_max[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = q0 + r0 + i;
      tile_max[i] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + lane + 32 * j;
        float x = -CUDART_INF_F;
        if (j < lane_keys && key < length && row < length) {
          const float add = one_pass ? bias_s[pad + (r0 + i) * length + key]
                                     : bias_bh[static_cast<size_t>(row) * length + key];
          x = s[i][j] * scale + add;
        }
        s[i][j] = x;
        tile_max[i] = fmaxf(tile_max[i], x);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(kFull, tile_max[i], offset));
    }
    float correction[kRowsPerWarp];
    float total[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float m_new = fmaxf(row_max[i], tile_max[i]);
      total[i] = 0.f;
      if (m_new == -CUDART_INF_F) {  // no finite score yet: nothing to add, uniform across the warp
        correction[i] = 1.f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
      } else {
        correction[i] = expf(row_max[i] - m_new);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          total[i] += s[i][j];
        }
      }
      row_max[i] = m_new;
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) total[i] += __shfl_xor_sync(kFull, total[i], offset);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      row_sum[i] = row_sum[i] * correction[i] + total[i];
      // one pass: probabilities / denominator before the product, as the Pallas kernel
      const float denom = one_pass ? fmaxf(row_sum[i], 1e-30f) : 1.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (j < lane_keys) p_s[(r0 + i) * tile_len + lane + 32 * j] = one_pass ? s[i][j] / denom : s[i][j];
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[i][c] *= correction[i];
    }
    __syncwarp();

    // out += P V over the tile's keys, four at a time (P is 0 and V is 0 past L)
    const float* v_lane = v_s + lane * kChunks;
    for (int kk = 0; kk < n_keys; kk += 4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) p4[i] = *reinterpret_cast<const float4*>(p_s + (r0 + i) * tile_len + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kChunks];
        load_run(v_lane + (kk + u) * kDimCap, vv);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  const int col = lane * kChunks;
  const bool vec_out = dim % (kChunks < 4 ? kChunks : 4) == 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + r0 + i;
    if (row >= length || col >= dim) continue;
    const float inv = one_pass ? 1.f : 1.f / fmaxf(row_sum[i], 1e-30f);
    float x[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) x[c] = acc[i][c] * inv;
    store_run(out + head_base + static_cast<size_t>(row) * dim + col, x, dim - col, vec_out);
  }
}

template <typename T, int kChunks, int kKeys, int kRowsPerWarp>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int batch, int heads, int length, int dim, int bias_heads, int tile_len,
                   cudaStream_t stream) {
  constexpr int kRows = kWarps * kRowsPerWarp;
  const size_t smem = shared_bytes(32 * kChunks, kRows, tile_len, tile_len >= length ? length : 0);
  const cudaError_t err = allow_shared_memory<attention_forward<T, kChunks, kKeys, kRowsPerWarp>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((length + kRows - 1) / kRows, heads, batch);
  attention_forward<T, kChunks, kKeys, kRowsPerWarp><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), heads, length, dim, bias_heads, 1.f / sqrtf(static_cast<float>(dim)), tile_len);
  return cudaGetLastError();
}

// the current device's SM count, asked once per device (the first call is eager, never
// inside a graph capture)
cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (!known[device]) err = cudaDeviceGetAttribute(&known[device], cudaDevAttrMultiProcessorCount, device);
  *sms = known[device];
  return err;
}

// the tile and the rows per block, from L, D and the block count
template <typename T, int kChunks>
cudaError_t by_shape(const void* q, const void* k, const void* v, const float* bias, void* out,
                     int batch, int heads, int length, int dim, int bias_heads, cudaStream_t stream) {
  const int whole = (length + 31) / 32 * 32;
  const bool one_pass =
      whole <= kMaxOnePass && static_cast<size_t>(whole) * (64 * kChunks + 4) * sizeof(float) <= kOnePassBytes;
  const int tile_len = one_pass ? whole : kOnlineTile;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const bool wide = static_cast<long long>(batch) * heads * ((length + 15) / 16) >= sms;  // 16 rows a block
  if (tile_len > 64) {
    return wide ? launch<T, kChunks, 6, 4>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, tile_len, stream)
                : launch<T, kChunks, 6, 1>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, tile_len, stream);
  }
  return wide ? launch<T, kChunks, 2, 4>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, tile_len, stream)
              : launch<T, kChunks, 2, 1>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, tile_len, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias, void* out,
                     int batch, int heads, int length, int dim, int bias_heads,
                     cudaStream_t stream) {
  if (dim <= 32) return by_shape<T, 1>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
  if (dim <= 64) return by_shape<T, 2>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
  if (dim <= 128) return by_shape<T, 4>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
  return by_shape<T, 8>(q, k, v, bias, out, batch, heads, length, dim, bias_heads, stream);
}

bool aligned_16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

extern "C" int replay_flash_attention_forward(const void* q, const void* k, const void* v,
                                              const void* bias, void* out, int batch, int heads,
                                              int length, int dim, int bias_heads, int is_bf16,
                                              void* stream) {
  if (batch < 1 || heads < 1 || length < 1 || dim < 1 || dim > kMaxDim || batch > 65535 ||
      heads > 65535 || (bias_heads != 1 && bias_heads != heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned_16(q) || !aligned_16(k) || !aligned_16(v) || !aligned_16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* bias_f32 = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, bias_f32, out, batch, heads, length, dim, bias_heads, s)
              : dispatch<float>(q, k, v, bias_f32, out, batch, heads, length, dim, bias_heads, s);
  return static_cast<int>(err);
}
