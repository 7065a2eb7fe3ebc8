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
// contiguous f32 [B, L]; lse f32 [B, H, L].
//
// Three variants, three C entry points; ops/flash_tiled.py::_variant picks one from the dtype
// and D alone (never from a failed build or launch):
//   "mma"    (replay_flash_tiled_forward_mma): bf16 with D a multiple of 8 up to 128, on the
//            bf16 tensor cores;
//   "tf32x3" (replay_flash_tiled_forward_tf32x3): f32 with D a multiple of 8 up to 128, on the
//            TF32 tensor cores at f32 accuracy (split TF32, tensor_core.cuh);
//   "simt"   (replay_flash_tiled_forward): any other D up to 256, f32 or bf16, on the CUDA cores.
// All walk the same tiles in the same order under the same semantics.
//
// What bounds it at the slice's shape, B=32, H=2, L=1024, D=64, causal, no padding: the causal
// product is 4 B H D L(L+1)/2 = 8.6 GFLOP, 0.13 ms at the 67 TFLOP/s of f32 on the CUDA cores or
// 0.009 ms at the 989 TFLOP/s of bf16 tensor cores; q, k, v and out are 34 MB in bf16, 0.010 ms
// at 3.35 TB/s. P is f32 (the Pallas kernel's), and bf16 V is exact in bf16, so P V takes one
// bf16 product per bf16 part of P: two where P is kept as a bf16 hi + lo pair, as the "mma"
// variant keeps it (989 / 2 TFLOP/s), three for all of f32's 24 bits (989 / 3, faster than two
// TF32 products at 495 / 2). With S = Q K^T at 989, the bf16 call takes at least 0.013 ms at the
// "mma" variant's accuracy. In f32 both products take three TF32 products at f32 accuracy
// (495 / 3 TFLOP/s, as fast as six bf16 ones): 0.052 ms, against 0.13 ms for f32 FMAs on the
// CUDA cores (67 TFLOP/s). So every variant is bound by operations. Times on the card are in
// PERF.md, measured by chip_smoke.py.
//
// "simt" design. A block has 4 warps and owns 64 query rows; key tiles are 64 keys. Q, K and V
// tiles are staged in shared memory as f32 (odd row strides for Q and K, so the column walk of
// the score product hits 16 distinct banks). Per key tile, three phases:
//   1. scores: each thread a register tile of 8 rows x 4 keys, summed over D;
//   2. online softmax: each warp 16 rows, a lane two keys, the row max and sum by shuffle;
//   3. out += P V: each thread 4 rows x D/8 columns of the accumulator, in registers.
// It spends 12 shared loads per 32 FMAs in both products and three barriers a key tile.
//
// "mma" design (FlashAttention-2's shape on mma.sync). A block has 4 warps and owns 64 query
// rows, a warp 16 of them. Q is loaded once into registers as m16n8k16 A fragments (ldmatrix
// from a shared tile whose rows are padded by 16 bytes, so the eight rows of an 8x8 matrix hit
// distinct banks). K and V tiles of 64 keys x D bf16 are double-buffered in shared memory with
// cp.async (16-byte chunks, zero-filled past L and past D), so tile j+1 loads while tile j
// computes; two barriers a tile. S = Q K^T runs on mma.sync bf16 -> f32; scale, bias, causal
// mask and the online softmax run on the f32 accumulator fragments in registers, the row max
// reduced over the 4 lanes that share a row by shuffle, the row sum kept per lane and reduced
// once at the end. O += P V runs on the tensor cores with P kept at f32 precision: the Pallas
// kernel multiplies f32 probabilities by V, so P = P_hi + P_lo with P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), two mma against the same bf16 V fragments (ldmatrix.trans). V is exact
// in bf16, so the product carries P to about 2^-16 relative, for twice the P V tensor work.
// The output is divided by the row sum once at the end, staged through the Q tile and written
// as bf16 with 16-byte stores; lse as f32. D is rounded up to 32, 64 or 128 with zero columns;
// the scale uses the real D. The live-tile set (tiles holding a key with bias above NEG_INF) is
// a bit mask in shared memory, built once per block, so a padding tile is never loaded.
// Not yet: wgmma, TMA and warp specialisation.
//
// "tf32x3" design: the "mma" variant's block, pipeline, tile walk and online softmax, on f32
// tiles (K/V stages of 64 x (D + 8) and 64 x (D + 4) floats, double-buffered with cp.async),
// with both products on mma.sync m16n8k8 TF32 -> f32, three products per tile product: each f32
// operand is split at fragment load into TF32 hi + lo and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi,
// which keeps about 2^-21 relative where one TF32 product keeps 2^-11. The k index of both
// products is permuted so that a lane's two k slots are two neighbouring columns: Q and K
// fragments are float2 reads, and P's S-accumulator registers are its A fragment for P V as they
// lie (V's rows are read in the same order). Q's hi and lo fragments stay in registers for
// D <= 64 and are read from shared memory for each key tile at D = 128. The output is written as
// f32 pairs from the accumulator registers.
//
// C interface, bound from Python with ctypes: each entry point launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError() (0 when the launch
// was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

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
  const cudaError_t err = allow_shared_memory<tiled_forward<T, kDimCap>>(smem);
  if (err != cudaSuccess) return err;
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

// ----------------------------------------------------------------------------------------------
// The "mma" variant: bf16, D a multiple of 8 up to 128, on the tensor cores
// ----------------------------------------------------------------------------------------------

constexpr int kStages = 2;  // K/V tiles in flight

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_address(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_address(p)));
}

// d += a b on one m16n8k16 tile: bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&pair);
}

// (x0, x1) as bf16 pairs: hi = bf16(x), lo = bf16(x - hi); hi + lo carries x to ~2^-16 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(x0, x1);
  const float2 rounded = __bfloat1622float2(pair);
  hi = *reinterpret_cast<unsigned*>(&pair);
  lo = pack_bf16(x0 - rounded.x, x1 - rounded.y);
}

// the first live tile at or after `from`, or n_tiles
__device__ __forceinline__ int next_live(const unsigned* bits, int from, int n_tiles) {
  while (from < n_tiles) {
    const unsigned word = bits[from >> 5] >> (from & 31);
    if (word) return from + __ffs(word) - 1;
    from = (from | 31) + 1;
  }
  return n_tiles;
}

int live_words(int length) { return ((length + kBlockK - 1) / kBlockK + 31) / 32; }

// Sets bit j of `bits` when key tile j (of the n_tiles covering keys 0 .. k_end - 1) holds a key
// whose bias is above NEG_INF. Called by the whole block; ends with a barrier.
__device__ __forceinline__ void scan_live_tiles(const float* __restrict__ bias_b, int k_end, int n_tiles,
                                                unsigned* bits) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < (n_tiles + 31) / 32; i += kThreads) bits[i] = 0;
  __syncthreads();
  // a warp reads 32 keys of one tile a step, kScan steps' loads in flight at once
  constexpr int kScan = 8;
  for (int first = warp * 32; first < n_tiles * kBlockK; first += kScan * kThreads) {
    bool live[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int key = first + u * kThreads + lane;
      live[u] = key < k_end && bias_b[key] > kNegInf;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int base = first + u * kThreads;
      const unsigned any = __ballot_sync(kFull, live[u]);  // base is uniform across the warp
      if (lane == 0 && any) atomicOr(bits + base / kBlockK / 32, 1u << (base / kBlockK % 32));
    }
  }
  __syncthreads();
}

// One key tile's online-softmax step on a warp's m16n8 score fragments, shared by the "mma" and
// "tf32x3" variants, whose accumulators lie alike: a lane holds rows row0 and row0 + 8, columns
// 2 t4 and 2 t4 + 1 of each 8-key block. Scales the scores, adds the tile's bias row `bs` (keys
// k0 ..), masks keys past L and (causal) past the row; takes the tile's row max over the 4 lanes
// that share a row; corrects the running max m, the lane's share l of the running sum, and the
// accumulator o; and turns s into P in place, adding P to l.
template <int kD>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[kD / 8][4], const float* bs, int k0, int row0,
                                             int length, int causal, float scale, int t4) {
  float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nb * 8 + 2 * t4 + (e & 1);
      const int key = k0 + col;
      const int row = row0 + (e >> 1) * 8;
      float x = fmaf(s[nb][e], scale, bs[col]);
      if (key >= length || (causal && key > row)) x = kNegInf;
      s[nb][e] = x;
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
    }
  }
  float correction[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(kFull, tile_max[hh], 1));
    tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(kFull, tile_max[hh], 2));
    const float m_new = fmaxf(m[hh], tile_max[hh]);
    correction[hh] = m[hh] <= kMasked ? 0.f : __expf(m[hh] - m_new);
    m[hh] = m_new;
    l[hh] *= correction[hh];
  }
#pragma unroll
  for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[nb][e] <= kMasked ? 0.f : __expf(s[nb][e] - m[e >> 1]);
      s[nb][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    o[dn][0] *= correction[0];
    o[dn][1] *= correction[0];
    o[dn][2] *= correction[1];
    o[dn][3] *= correction[1];
  }
}

// The end of the walk for rows row0 and row0 + 8 (same layout): adds the quad's shares of each
// row sum, writes lse (`lse_rows` is the head's [L]) for rows below L, and returns in inv the
// factor 1 / max(l, 1e-30) by which the accumulator becomes the output.
__device__ __forceinline__ void finish_rows(float (&l)[2], const float (&m)[2], float (&inv)[2],
                                            float* __restrict__ lse_rows, int row0, int length, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
    const float denom = fmaxf(l[hh], 1e-30f);
    inv[hh] = 1.f / denom;
    const int row = row0 + hh * 8;
    if (t4 == 0 && row < length) lse_rows[row] = m[hh] <= kMasked ? kNegInf : m[hh] + logf(denom);
  }
}

size_t mma_shared_bytes(int dim_cap, int length) {
  const size_t row_bytes = static_cast<size_t>(dim_cap + 8) * sizeof(__nv_bfloat16);
  return row_bytes * (kBlockQ + 2 * kStages * kBlockK)  // q tile, K and V stages
         + sizeof(float) * kStages * kBlockK             // bias stages
         + sizeof(unsigned) * live_words(length);        // live-tile bits
}

// kD: D rounded up to 32, 64 or 128
template <int kD>
__global__ void __launch_bounds__(kThreads)
tiled_forward_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ kv_bias,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads, int length,
                  int dim, int causal, float scale) {
  constexpr int kStride = kD + 8;           // bf16 per shared row: 16 bytes of padding
  constexpr int kChunks = kD / 8;           // 16-byte chunks per row
  constexpr int kTile = kBlockK * kStride;  // bf16 of one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockQ][kStride]
  __nv_bfloat16* k_s = q_s + kBlockQ * kStride;                      // [kStages][kBlockK][kStride]
  __nv_bfloat16* v_s = k_s + kStages * kTile;                        // [kStages][kBlockK][kStride]
  float* bias_s = reinterpret_cast<float*>(v_s + kStages * kTile);   // [kStages][kBlockK]
  unsigned* live_bits = reinterpret_cast<unsigned*>(bias_s + kStages * kBlockK);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;  // longest causal walk first
  const size_t head_base = (static_cast<size_t>(b) * heads + h) * length * dim;
  const float* bias_b = kv_bias + static_cast<size_t>(b) * length;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t4 = lane & 3;  // its column pair within an 8-wide block
  const int warp_row0 = q0 + warp * 16;

  // Q: the block's 64 rows, in the first group of copies
  for (int idx = tid; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = q0 + r;
    const bool valid = row < length && c < dim;
    cp_async_16(q_s + r * kStride + c, q + (valid ? head_base + static_cast<size_t>(row) * dim + c : 0), valid);
  }

  // the key tiles holding a real key (causal: up to the block's last row)
  const int k_end = causal ? min(length, q0 + kBlockQ) : length;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  scan_live_tiles(bias_b, k_end, n_tiles, live_bits);

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    __nv_bfloat16* ks = k_s + stage * kTile;
    __nv_bfloat16* vs = v_s + stage * kTile;
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const int key = k0 + r;
      const bool valid = key < length && c < dim;
      const size_t at = valid ? head_base + static_cast<size_t>(key) * dim + c : 0;
      cp_async_16(ks + r * kStride + c, k + at, valid);
      cp_async_16(vs + r * kStride + c, v + at, valid);
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      cp_async_4(bias_s + stage * kBlockK + tid, bias_b + (key < length ? key : 0), key < length);
    }
  };

  unsigned qa[kD / 16][4];  // Q as A fragments, one per 16 columns
  float o[kD / 8][4];       // the output accumulator: rows g, g + 8 x 8-column blocks
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of their running sums

  int tile = next_live(live_bits, 0, n_tiles);
  if (tile < n_tiles) load_tile(tile, 0);
  cp_async_commit();
  bool have_q = false;
  int stage = 0;
  while (tile < n_tiles) {  // uniform across the block: the bits are shared
    const int next = next_live(live_bits, tile + 1, n_tiles);
    if (next < n_tiles) load_tile(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile (and Q) have landed
    __syncthreads();
    if (!have_q) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        ldmatrix_x4(qa[kk], q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + kk * 16 + (lane >> 4) * 8);
      }
      have_q = true;
    }
    const __nv_bfloat16* ks = k_s + stage * kTile;
    const __nv_bfloat16* vs = v_s + stage * kTile;
    const float* bs = bias_s + stage * kBlockK;
    const int k0 = tile * kBlockK;

    // S = Q K^T: 16 rows x 64 keys a warp, as 8 accumulator blocks of 16 x 8
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockK / 16; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    softmax_tile<kD>(s, m, l, o, bs, k0, warp_row0 + g, length, causal, scale, t4);

    // O += P V, 16 keys at a time: P's accumulator blocks 2j, 2j + 1 are the A fragment of
    // keys 16j .. 16j + 15, split into bf16 hi and lo parts
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      unsigned p_hi[4], p_lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], p_hi[0], p_lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], p_hi[1], p_lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], p_hi[2], p_lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], p_hi, bv[0], bv[1]);
        mma_bf16(o[2 * dp], p_lo, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], p_hi, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], p_lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();  // Q's copies, if no tile was live
  __syncthreads();

  // finalize: out = acc / max(l, 1e-30), lse
  float inv[2];
  finish_rows(l, m, inv, lse + (static_cast<size_t>(b) * heads + h) * length, warp_row0 + g, length, t4);
  // the warp's 16 rows staged as bf16 in its own rows of the Q tile, then 16-byte stores
  __nv_bfloat16* rows_s = q_s + warp * 16 * kStride;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = dn * 8 + 2 * t4;
    *reinterpret_cast<unsigned*>(rows_s + g * kStride + c) = pack_bf16(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    *reinterpret_cast<unsigned*>(rows_s + (g + 8) * kStride + c) = pack_bf16(o[dn][2] * inv[1], o[dn][3] * inv[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = warp_row0 + r;
    if (row < length && c < dim) {
      *reinterpret_cast<uint4*>(out + head_base + static_cast<size_t>(row) * dim + c) =
          *reinterpret_cast<const uint4*>(rows_s + r * kStride + c);
    }
  }
}

template <int kD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* kv_bias, void* out,
                       float* lse, int batch, int heads, int length, int dim, int causal,
                       cudaStream_t stream) {
  const size_t smem = mma_shared_bytes(kD, length);
  const cudaError_t err = allow_shared_memory<tiled_forward_mma<kD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, (length + kBlockQ - 1) / kBlockQ);
  tiled_forward_mma<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_bias, static_cast<__nv_bfloat16*>(out), lse, heads,
      length, dim, causal, 1.f / sqrtf(static_cast<float>(dim)));
  return cudaGetLastError();
}

// ----------------------------------------------------------------------------------------------
// The "tf32x3" variant: f32, D a multiple of 8 up to 128, on the TF32 tensor cores at f32 accuracy
// ----------------------------------------------------------------------------------------------

size_t tf32x3_shared_bytes(int dim_cap, int length) {
  const size_t qk_row = static_cast<size_t>(dim_cap + 8) * sizeof(float);
  const size_t v_row = static_cast<size_t>(dim_cap + 4) * sizeof(float);
  return qk_row * (kBlockQ + kStages * kBlockK)  // q tile, K stages
         + v_row * kStages * kBlockK             // V stages
         + sizeof(float) * kStages * kBlockK     // bias stages
         + sizeof(unsigned) * live_words(length);
}

// kD: D rounded up to 32, 64 or 128
template <int kD>
__global__ void __launch_bounds__(kThreads)
tiled_forward_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ kv_bias, float* __restrict__ out, float* __restrict__ lse,
                     int heads, int length, int dim, int causal, float scale) {
  constexpr int kQKStride = kD + 8;  // floats per Q and K row (= 8 mod 32): float2 fragment reads hit distinct banks
  constexpr int kVStride = kD + 4;   // floats per V row (= 4 mod 32): P V's column reads hit distinct banks
  constexpr int kChunks = kD / 4;    // 16-byte chunks per row
  constexpr int kKTile = kBlockK * kQKStride;
  constexpr int kVTile = kBlockK * kVStride;
  constexpr bool kQInRegisters = kD <= 64;  // Q's hi and lo fragments: 2 kD / 2 registers a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);        // [kBlockQ][kQKStride]
  float* k_s = q_s + kBlockQ * kQKStride;                 // [kStages][kBlockK][kQKStride]
  float* v_s = k_s + kStages * kKTile;                    // [kStages][kBlockK][kVStride]
  float* bias_s = v_s + kStages * kVTile;                 // [kStages][kBlockK]
  unsigned* live_bits = reinterpret_cast<unsigned*>(bias_s + kStages * kBlockK);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;  // longest causal walk first
  const size_t head_base = (static_cast<size_t>(b) * heads + h) * length * dim;
  const float* bias_b = kv_bias + static_cast<size_t>(b) * length;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t4 = lane & 3;  // its k slots t4, t4 + 4, which stand for columns 2 t4, 2 t4 + 1
  const int warp_row0 = q0 + warp * 16;

  // Q: the block's 64 rows, in the first group of copies
  for (int idx = tid; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int row = q0 + r;
    const bool valid = row < length && c < dim;
    cp_async_16(q_s + r * kQKStride + c, q + (valid ? head_base + static_cast<size_t>(row) * dim + c : 0), valid);
  }

  const int k_end = causal ? min(length, q0 + kBlockQ) : length;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  scan_live_tiles(bias_b, k_end, n_tiles, live_bits);

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    float* ks = k_s + stage * kKTile;
    float* vs = v_s + stage * kVTile;
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 4;
      const int key = k0 + r;
      const bool valid = key < length && c < dim;
      const size_t at = valid ? head_base + static_cast<size_t>(key) * dim + c : 0;
      cp_async_16(ks + r * kQKStride + c, k + at, valid);
      cp_async_16(vs + r * kVStride + c, v + at, valid);
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      cp_async_4(bias_s + stage * kBlockK + tid, bias_b + (key < length ? key : 0), key < length);
    }
  };

  // the warp's A fragment of Q for columns 8 kk .. 8 kk + 7, split into hi and lo
  auto q_fragment = [&](int kk, unsigned (&hi)[4], unsigned (&lo)[4]) {
    const float* top = q_s + (warp * 16 + g) * kQKStride + kk * 8 + 2 * t4;
    const float2 r0 = *reinterpret_cast<const float2*>(top);
    const float2 r8 = *reinterpret_cast<const float2*>(top + 8 * kQKStride);
    tf32_parts(r0.x, hi[0], lo[0]);
    tf32_parts(r8.x, hi[1], lo[1]);
    tf32_parts(r0.y, hi[2], lo[2]);
    tf32_parts(r8.y, hi[3], lo[3]);
  };

  unsigned q_hi[kQInRegisters ? kD / 8 : 1][4], q_lo[kQInRegisters ? kD / 8 : 1][4];
  float o[kD / 8][4];  // the output accumulator: rows g, g + 8 x 8-column blocks
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of their running sums

  int tile = next_live(live_bits, 0, n_tiles);
  if (tile < n_tiles) load_tile(tile, 0);
  cp_async_commit();
  bool have_q = false;
  int stage = 0;
  while (tile < n_tiles) {  // uniform across the block: the bits are shared
    const int next = next_live(live_bits, tile + 1, n_tiles);
    if (next < n_tiles) load_tile(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile (and Q) have landed
    __syncthreads();
    if constexpr (kQInRegisters) {
      if (!have_q) {
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) q_fragment(kk, q_hi[kk], q_lo[kk]);
        have_q = true;
      }
    }
    const float* ks = k_s + stage * kKTile;
    const float* vs = v_s + stage * kVTile;
    const float* bs = bias_s + stage * kBlockK;
    const int k0 = tile * kBlockK;

    // S = Q K^T: 16 rows x 64 keys a warp, as 8 accumulator blocks of 16 x 8, 3xTF32
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      unsigned a_hi[4], a_lo[4];
      if constexpr (kQInRegisters) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_hi[e] = q_hi[kk][e];
          a_lo[e] = q_lo[kk][e];
        }
      } else {
        q_fragment(kk, a_hi, a_lo);
      }
#pragma unroll
      for (int nb = 0; nb < kBlockK / 8; ++nb) {
        // B = K^T: key nb * 8 + g, columns 8 kk + 2 t4 and + 1 in slots t4 and t4 + 4
        const float2 kv = *reinterpret_cast<const float2*>(ks + (nb * 8 + g) * kQKStride + kk * 8 + 2 * t4);
        unsigned b_hi[2], b_lo[2];
        tf32_parts(kv.x, b_hi[0], b_lo[0]);
        tf32_parts(kv.y, b_hi[1], b_lo[1]);
        mma_split<true, true>(s[nb], a_hi, a_lo, b_hi, b_lo);
      }
    }

    softmax_tile<kD>(s, m, l, o, bs, k0, warp_row0 + g, length, causal, scale, t4);

    // O += P V, 3xTF32: P's accumulator block nb is the A fragment of keys nb * 8 + 2 t4 (slot
    // t4) and + 1 (slot t4 + 4); V's rows are read in that order; the tile's products are summed
    // apart and added to O rounded
    add_tile_products<true, kBlockK, kD, kVStride>(s, vs + 2 * t4 * kVStride + g, o);
    __syncthreads();  // this stage is consumed before the next iteration refills it
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();  // Q's copies, if no tile was live

  // finalize: out = acc / max(l, 1e-30), lse; f32 pairs stored as they lie
  float inv[2];
  finish_rows(l, m, inv, lse + (static_cast<size_t>(b) * heads + h) * length, warp_row0 + g, length, t4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp_row0 + g + hh * 8;
    if (row >= length) continue;
    float* out_row = out + head_base + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int c = dn * 8 + 2 * t4;
      if (c < dim) {
        *reinterpret_cast<float2*>(out_row + c) = make_float2(o[dn][2 * hh] * inv[hh], o[dn][2 * hh + 1] * inv[hh]);
      }
    }
  }
}

template <int kD>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, const float* kv_bias, void* out,
                          float* lse, int batch, int heads, int length, int dim, int causal,
                          cudaStream_t stream) {
  const size_t smem = tf32x3_shared_bytes(kD, length);
  const cudaError_t err = allow_shared_memory<tiled_forward_tf32x3<kD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, (length + kBlockQ - 1) / kBlockQ);
  tiled_forward_tf32x3<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), kv_bias,
      static_cast<float*>(out), lse, heads, length, dim, causal, 1.f / sqrtf(static_cast<float>(dim)));
  return cudaGetLastError();
}

// what the tensor-core variants refuse: shapes outside their range, pointers off a 16-byte boundary
int refuse_tensor_core(const void* q, const void* k, const void* v, const void* out, int batch, int heads,
                       int length, int dim) {
  if (batch < 1 || heads < 1 || length < 1 || dim < 8 || dim > 128 || dim % 8 != 0 ||
      batch > 65535 || (length + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned_16 = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  if (!aligned_16(q) || !aligned_16(k) || !aligned_16(v) || !aligned_16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return 0;
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

extern "C" int replay_flash_tiled_forward_mma(const void* q, const void* k, const void* v,
                                              const void* kv_bias, void* out, void* lse, int batch,
                                              int heads, int length, int dim, int causal,
                                              void* stream) {
  if (const int refused = refuse_tensor_core(q, k, v, out, batch, heads, length, dim)) return refused;
  const float* bias_f32 = static_cast<const float*>(kv_bias);
  float* lse_f32 = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dim <= 32) {
    err = launch_mma<32>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  } else if (dim <= 64) {
    err = launch_mma<64>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  } else {
    err = launch_mma<128>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  }
  return static_cast<int>(err);
}

extern "C" int replay_flash_tiled_forward_tf32x3(const void* q, const void* k, const void* v,
                                                 const void* kv_bias, void* out, void* lse, int batch,
                                                 int heads, int length, int dim, int causal,
                                                 void* stream) {
  if (const int refused = refuse_tensor_core(q, k, v, out, batch, heads, length, dim)) return refused;
  const float* bias_f32 = static_cast<const float*>(kv_bias);
  float* lse_f32 = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dim <= 32) {
    err = launch_tf32x3<32>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  } else if (dim <= 64) {
    err = launch_tf32x3<64>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  } else {
    err = launch_tf32x3<128>(q, k, v, bias_f32, out, lse_f32, batch, heads, length, dim, causal, s);
  }
  return static_cast<int>(err);
}
