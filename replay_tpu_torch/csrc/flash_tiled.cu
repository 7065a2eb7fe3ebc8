// Length-tiled flash attention, forward: out = softmax(Q K^T / sqrt(D) + kv_bias) V, and the
// row log-sum-exp, with an optional causal mask built from indices.
//
// Replaces replay_tpu/ops/flash_tiled.py::_kernel (the Pallas kernel behind
// SasRec(use_flash="tiled")). The TPU kernel runs a grid (B, H, q_blocks, kv_blocks) whose
// innermost kv axis is sequential, carrying the running max, running sum and output
// accumulator in VMEM from one grid step to the next. Hopper blocks run in parallel and in
// no order, so here one block owns one (query tile, head, batch) and loops over the key
// tiles itself, keeping that state in shared memory (max, sum) and registers (accumulator).
// Nothing O(L^2) exists: the causal mask comes from indices, padding from a per-key bias row.
//
// Semantics, as the Pallas kernel's, in f32 whatever the input type:
// - s = (q . k) * scale + kv_bias[key]; causal: s = NEG_INF where key > row (replaced);
// - a score at or below NEG_INF / 2 gets probability exactly 0, and a running max at or
//   below it gets correction 0, so no inf - inf and no exp of a huge difference is formed;
// - out = acc / max(l, 1e-30); lse = NEG_INF if the row met no valid key, else m + log(that).
//   A fully masked row (a left-padded position, or a row with no valid key) gives out 0 and
//   lse NEG_INF.
// Key tiles wholly above the diagonal are never visited (the Pallas kernel's pl.when skip):
// at L = 1024 causal, half the work. Nor are key tiles whose every key is padding (bias at
// NEG_INF, as padding_mask_bias writes it): such a tile leaves max, sum and accumulator as
// they were (its probabilities are 0 and its correction 1, or 0 on a row still empty), as
// long as |q . k| / sqrt(D) stays below 3.7e22, under which NEG_INF absorbs the score in f32.
// Left-padded rows thus cost about what their real keys need. Keys and rows past L are
// bounds-checked, never padded.
//
// Layout: q, k, v, out contiguous [B, H, L, D], f32 or bf16, all one type; kv_bias
// contiguous f32 [B, L]; lse f32 [B, H, L]. Any D <= 256.
//
// Design. A block has 4 warps and owns 64 query rows; key tiles are 64 keys. Q, K and V
// tiles are staged in shared memory as f32 (odd row strides for Q and K, so the column
// walk of the score product hits 16 distinct banks). Per key tile, three phases:
//   1. scores: each thread a register tile of 8 rows x 4 keys, summed over D;
//   2. online softmax: each warp 16 rows, a lane two keys, the row max and sum by shuffle;
//   3. out += P V: each thread 4 rows x D/8 columns of the accumulator, in registers.
// Blocks are ordered longest-first (the last query tile walks the most causal key tiles).
//
// What bounds it at the slice's shape, B=32, H=2, L=1024, D=64, causal, bf16, no padding:
// the causal product is 4 B H D L(L+1)/2 = 8.6 GFLOP, 0.13 ms at the 67 TFLOP/s of f32 on the
// CUDA cores or 0.009 ms at the 989 TFLOP/s of bf16 tensor cores; q, k, v and out are 34 MB,
// 0.010 ms at 3.35 TB/s. So on the CUDA cores it is bound by operations, and the design
// spends them on FMAs from shared memory (12 shared loads per 32 FMAs in both products),
// reads each input once per query tile that needs it, and writes out and lse once. It uses
// no tensor cores (mma/wgmma) and no TMA: those, and a backward kernel, are later work.
// Its time on the card is in PERF.md, measured by chip_smoke.py.
//
// C interface, bound from Python with ctypes: replay_flash_tiled_forward launches on the
// given stream, does not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 when the launch was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per tile
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
constexpr float kMasked = kNegInf / 2;  // scores at or below it are masked
constexpr unsigned kFull = 0xffffffffu;

// phase 1: a thread scores rows s_ty + 8 i (i < 8) against keys s_tx + 16 j (j < 4)
constexpr int kScoreRows = 8;
constexpr int kScoreKeys = 4;
// phase 3: a thread accumulates rows o_ty + 16 i (i < 4), columns o_tx + 8 j
constexpr int kOutRows = 4;
constexpr int kOutColThreads = 8;
static_assert(kScoreRows * kScoreKeys * kThreads == kBlockQ * kBlockK, "phase 1 covers the tile");
static_assert(kOutRows * (kThreads / kOutColThreads) == kBlockQ, "phase 3 covers the rows");
static_assert(kBlockK == 64, "phase 2 gives each lane two keys");

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

size_t shared_bytes(int dim) {
  const size_t floats = static_cast<size_t>(kBlockQ) * (dim + 1)  // q tile
                        + static_cast<size_t>(kBlockK) * (dim + 1)  // k tile
                        + static_cast<size_t>(kBlockK) * dim        // v tile
                        + static_cast<size_t>(kBlockQ) * (kBlockK + 1)  // scores, then probabilities
                        + kBlockK                                    // the tile's bias row
                        + 3 * kBlockQ;                               // running max, sum, correction
  return floats * sizeof(float);
}

// kDimCap: D rounded up to 32, 64, 128 or 256; a thread holds kDimCap / 8 output columns.
template <typename T, int kDimCap>
__global__ void __launch_bounds__(kThreads)
tiled_forward(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,
              int heads, int length, int dim, int causal, float scale) {
  constexpr int kOutCols = kDimCap / kOutColThreads;
  extern __shared__ float smem[];
  const int row_stride = dim + 1;
  constexpr int p_stride = kBlockK + 1;
  float* q_tile = smem;                               // [kBlockQ][dim + 1]
  float* k_tile = q_tile + kBlockQ * row_stride;      // [kBlockK][dim + 1]
  float* v_tile = k_tile + kBlockK * row_stride;      // [kBlockK][dim]
  float* p_tile = v_tile + kBlockK * dim;             // [kBlockQ][kBlockK + 1]
  float* bias_tile = p_tile + kBlockQ * p_stride;     // [kBlockK]
  float* row_max = bias_tile + kBlockK;               // [kBlockQ]
  float* row_sum = row_max + kBlockQ;                 // [kBlockQ]
  float* row_scale = row_sum + kBlockQ;               // [kBlockQ]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest causal walk first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_base = (static_cast<size_t>(b) * heads + h) * length * dim;
  const float* bias_b = kv_bias + static_cast<size_t>(b) * length;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s_ty = tid >> 4, s_tx = tid & 15;
  const int o_ty = tid / kOutColThreads, o_tx = tid % kOutColThreads;

  for (int e = tid; e < kBlockQ * dim; e += kThreads) {
    const int r = e / dim;
    const int c = e - r * dim;
    const int row = q0 + r;
    q_tile[r * row_stride + c] = row < length ? load_f32(q + head_base + static_cast<size_t>(row) * dim + c) : 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    row_max[r] = kNegInf;
    row_sum[r] = 0.f;
  }

  float acc[kOutRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  // causal: key tiles starting past the block's last row see only masked scores
  const int k_end = causal ? min(length, q0 + kBlockQ) : length;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed; on the first pass, q and the row state are written
    int live = 0;
    for (int r = tid; r < kBlockK; r += kThreads) {
      const int key = k0 + r;
      const float bias = key < length ? bias_b[key] : kNegInf;
      bias_tile[r] = bias;
      live |= bias > kNegInf;
    }
    if (!__syncthreads_or(live)) continue;  // every key of the tile is padding
    for (int e = tid; e < kBlockK * dim; e += kThreads) {
      const int r = e / dim;
      const int c = e - r * dim;
      const int key = k0 + r;
      const size_t g = head_base + static_cast<size_t>(key) * dim + c;
      const bool valid = key < length;
      k_tile[r * row_stride + c] = valid ? load_f32(k + g) : 0.f;
      v_tile[e] = valid ? load_f32(v + g) : 0.f;
    }
    __syncthreads();

    // phase 1: scores, masked, into p_tile
    float s[kScoreRows][kScoreKeys];
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) {
#pragma unroll
      for (int j = 0; j < kScoreKeys; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < dim; ++c) {
      float qv[kScoreRows];
      float kv[kScoreKeys];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) qv[i] = q_tile[(s_ty + 8 * i) * row_stride + c];
#pragma unroll
      for (int j = 0; j < kScoreKeys; ++j) kv[j] = k_tile[(s_tx + 16 * j) * row_stride + c];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
#pragma unroll
        for (int j = 0; j < kScoreKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) {
      const int r = s_ty + 8 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < kScoreKeys; ++j) {
        const int col = s_tx + 16 * j;
        const int key = k0 + col;
        float x = s[i][j] * scale + bias_tile[col];
        if (key >= length || (causal && key > row)) x = kNegInf;
        p_tile[r * p_stride + col] = x;
      }
    }
    __syncthreads();

    // phase 2: online softmax over the tile, scores replaced by probabilities in place
    for (int i = 0; i < kBlockQ / kWarps; ++i) {
      const int r = warp * (kBlockQ / kWarps) + i;
      float* p_row = p_tile + r * p_stride;
      const float s0 = p_row[lane];
      const float s1 = p_row[lane + 32];
      const float m_prev = row_max[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 <= kMasked ? 0.f : expf(s0 - m_new);
      const float p1 = s1 <= kMasked ? 0.f : expf(s1 - m_new);
      const float correction = m_prev <= kMasked ? 0.f : expf(m_prev - m_new);
      const float total = warp_sum(p0 + p1);
      p_row[lane] = p0;
      p_row[lane + 32] = p1;
      if (lane == 0) {
        row_sum[r] = row_sum[r] * correction + total;
        row_max[r] = m_new;
        row_scale[r] = correction;
      }
    }
    __syncthreads();

    // phase 3: rescale the accumulator, then add this tile's P V
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const float correction = row_scale[o_ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= correction;
    }
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kOutRows];
      float vv[kOutCols];
#pragma unroll
      for (int i = 0; i < kOutRows; ++i) pv[i] = p_tile[(o_ty + 16 * i) * p_stride + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const int d = o_tx + kOutColThreads * j;
        vv[j] = d < dim ? v_tile[kk * dim + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kOutRows; ++i) {
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  // finalize (row_sum and row_max were last written before the final barrier of the loop)
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int r = o_ty + 16 * i;
    const int row = q0 + r;
    if (row >= length) continue;
    const float denom = fmaxf(row_sum[r], 1e-30f);
    T* out_row = out + head_base + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int d = o_tx + kOutColThreads * j;
      if (d < dim) store_f32(out_row + d, acc[i][j] / denom);
    }
    if (o_tx == 0) {
      const float m = row_max[r];
      lse[(static_cast<size_t>(b) * heads + h) * length + row] = m <= kMasked ? kNegInf : m + logf(denom);
    }
  }
}

template <typename T, int kDimCap>
cudaError_t launch(const void* q, const void* k, const void* v, const float* kv_bias, void* out,
                   float* lse, int batch, int heads, int length, int dim, int causal,
                   cudaStream_t stream) {
  const size_t smem = shared_bytes(dim);
  // raised once per instantiation, before any launch that needs it (never inside a graph capture
  // that follows an eager call of the same shape)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_forward<T, kDimCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((length + kBlockQ - 1) / kBlockQ, heads, batch);
  tiled_forward<T, kDimCap><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_bias,
      static_cast<T*>(out), lse, heads, length, dim, causal, 1.f / sqrtf(static_cast<float>(dim)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* kv_bias, void* out,
                     float* lse, int batch, int heads, int length, int dim, int causal,
                     cudaStream_t stream) {
  if (dim <= 32) return launch<T, 32>(q, k, v, kv_bias, out, lse, batch, heads, length, dim, causal, stream);
  if (dim <= 64) return launch<T, 64>(q, k, v, kv_bias, out, lse, batch, heads, length, dim, causal, stream);
  if (dim <= 128) return launch<T, 128>(q, k, v, kv_bias, out, lse, batch, heads, length, dim, causal, stream);
  return launch<T, 256>(q, k, v, kv_bias, out, lse, batch, heads, length, dim, causal, stream);
}

}  // namespace

extern "C" int replay_flash_tiled_forward(const void* q, const void* k, const void* v,
                                          const void* kv_bias, void* out, void* lse, int batch,
                                          int heads, int length, int dim, int causal, int is_bf16,
                                          void* stream) {
  if (batch < 1 || heads < 1 || length < 1 || dim < 1 || dim > kMaxDim || batch > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bias_f32 = static_cast<const float*>(kv_bias);
  float* lse_f32 = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s)
              : dispatch<float>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  return static_cast<int>(err);
}
