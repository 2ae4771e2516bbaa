// Flash attention, forward, non-causal, with a key mask: the conformer's self-attention on Hopper.
//
// Replaces the Pallas TPU kernel behind some_tpu/ops/attention.py::_flash_attention_bhtd
// (JAX's TPU flash_attention with SegmentIds). It computes, for q, k, v of shape [B, H, T, D],
//     out = softmax(where(key_mask, q k^T * scale, -1e9)) v
// with the semantics of _xla_attention in the JAX package: a masked key gets the finite score
// -1e9, so a row whose keys are all masked (a batch-padding row) averages v and stays finite;
// scores and the softmax are f32; the probabilities are rounded to the input dtype before the
// product with v; sums are f32 and the output is in the input dtype. [T, T] is never stored.
//
// Bound: operations once T is long (4 * B * H * T^2 * D flops against 4 * B * H * T * D
// elements moved). In f32 both kernels do their products as f32 FMAs on the CUDA cores, so they
// run far from that bound, in true f32 (no TF32). In bf16 both run on the tensor cores (below).
//
// Design on the CUDA cores (f32): a block owns 64 queries of one (batch, head) and 128 threads.
// Q stays in shared memory; the block walks the keys in tiles of 64, staging K (transposed) and V
// in shared memory, and keeps the running max, the running sum and the output rows in f32
// registers (the online softmax). Each thread holds a 4 x 8 block of the score tile and a 4 x D/8
// block of the output, so each value read from shared memory feeds 4 or 8 FMAs. Keys past T (the
// ragged last tile) score -inf and drop out; queries past T are computed and not stored. Inputs
// are read through their strides, so q, k and v may be views into the projections' [B, T, H, D]
// outputs.
//
// Training forward (some_flash_attention_fwd_stats): the same function plus the row statistics the
// backward needs, m (the row max of the scores) and l (the sum of exp(score - m), taken from the
// probabilities before they are rounded), as f32 [B, H, T, 2]. It makes two passes over the keys:
// the first finds m and l, the second multiplies v with p = round(exp(score - m) / l), the
// normalized probability rounded to the input dtype, exactly as the plain version rounds its
// softmax. So the dk/dv kernel (flash_attention_bwd.cu) rebuilds bit for bit the P this kernel
// multiplied with v. One log-sum-exp per row would not do: in a batch-padding row m is -1e9 and
// -1e9 + log(T) rounds back to -1e9 in f32, which would turn the uniform 1/T into 1. The second
// pass costs one more Q K^T product than the inference kernel; the inference path does not pay it.
//
// In bf16 both forwards run on the tensor cores (attention_mma.cuh): the inference forward is
// flash_fwd_mma_kernel, the one pass of online softmax, the training forward
// flash_fwd_stats_mma_kernel, the same two passes. Both take the score arithmetic above on Q K^T
// tiles from mma.sync (masked_scores; exp on the special-function unit), and pack p rounded to
// bf16 in pairs as the A fragment of the P.V product: the rounding the semantics ask for is the
// operand format the tensor core takes. The inference forward rounds p = exp(score - m_running)
// unnormalised and divides by l at the store, as the f32 kernel does; the training forward
// rounds the normalized p. Both skip a key tile whose keys are all masked or past T, but only in
// a batch row with a real key, where exp(-1e9 - m) is exactly 0; in an all-masked row the masked
// keys carry the uniform average, so every tile is walked. The bf16 dq kernel forms S with
// masked_scores (flash_common.cuh) and the bf16 dk/dv kernel sums S^T = K Q^T with the same
// products in the same k16 steps, so both rebuild the training forward's P bit for bit.
#include <type_traits>

#include "attention_mma.cuh"
#include "flash_common.cuh"

namespace {

using namespace some_flash;

constexpr int kQStride = kVecStride;  // rows of Q^T and P^T: 16-byte aligned for float4 access
constexpr int kKStride = kOddStride;  // rows of K^T: odd, so the transposing stores spread over banks

template <int D>
constexpr int smem_floats() {
  return D * kQStride + D * kKStride + kBK * D + kBK * kQStride + kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ out, int t_len,
                 Strides qs, Strides ks, Strides vs_, Strides os, float scale) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kQStride]  Q^T
  float* kt = qt + D * kQStride;         // [D][kKStride]  K^T
  float* vt = kt + D * kKStride;         // [kBK][D]       V
  float* pt = vt + kBK * D;              // [kBK][kQStride] P^T
  int* key_code = reinterpret_cast<int*>(pt + kBK * kQStride);  // 0 real, 1 masked, 2 past T

  const int tid = threadIdx.x;
  const int tq = tid >> 3;  // query rows 4 * tq .. 4 * tq + 3
  const int tk = tid & 7;   // key columns and output columns tk + 8 * j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  T* ob = out + b * os.b + h * os.h;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * t_len : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    qt[d * kQStride + r] = t < t_len ? to_float(qb[t * qs.t + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles = (t_len + kBK - 1) / kBK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of K, V and P are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool in_range = t < t_len;
      kt[d * kKStride + r] = in_range ? to_float(kb[t * ks.t + d]) : 0.0f;
      vt[r * D + d] = in_range ? to_float(vb[t * vs_.t + d]) : 0.0f;
    }
    for (int r = tid; r < kBK; r += kThreads) {
      const int t = k0 + r;
      key_code[r] = t >= t_len ? 2 : (mb != nullptr && mb[t] == 0 ? 1 : 0);
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * kQStride + 4 * tq]);
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kt[d * kKStride + tk + 8 * j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[0][j] = fmaf(qv.x, kv[j], s[0][j]);
        s[1][j] = fmaf(qv.y, kv[j], s[1][j]);
        s[2][j] = fmaf(qv.z, kv[j], s[2][j]);
        s[3][j] = fmaf(qv.w, kv[j], s[3][j]);
      }
    }

    float tile_max[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float score = s[i][j] * scale;
        if (code == 1) score = kMaskedScore;
        if (code == 2) score = -INFINITY;
        s[i][j] = score;
        tile_max[i] = fmaxf(tile_max[i], score);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the 8 threads that share a query row are adjacent lanes of one warp
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], offset));
      // every tile holds at least one key below T, so m_new is finite
      const float m_new = fmaxf(m[i], tile_max[i]);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile, where m[i] is -inf
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kDT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        s[i][j] = round_to<T>(p);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&pt[(tk + 8 * j) * kQStride + 4 * tq]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[kk * kQStride + 4 * tq]);
      float vv[kDT];
#pragma unroll
      for (int j = 0; j < kDT; ++j) vv[j] = vt[kk * D + tk + 8 * j];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[0][j] = fmaf(pv.x, vv[j], acc[0][j]);
        acc[1][j] = fmaf(pv.y, vv[j], acc[1][j]);
        acc[2][j] = fmaf(pv.z, vv[j], acc[2][j]);
        acc[3][j] = fmaf(pv.w, vv[j], acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int offset = 1; offset < 8; offset <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], offset);
    const int t = q0 + 4 * tq + i;
    if (t < t_len) {
#pragma unroll
      for (int j = 0; j < kDT; ++j) ob[t * os.t + tk + 8 * j] = from_float<T>(acc[i][j] / l[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       float* __restrict__ stats, int t_len, Strides qs, Strides ks, Strides vs_,
                       Strides os, float scale) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kQStride]  Q^T
  float* kt = qt + D * kQStride;         // [D][kKStride]  K^T
  float* vt = kt + D * kKStride;         // [kBK][D]       V
  float* pt = vt + kBK * D;              // [kBK][kQStride] P^T
  int* key_code = reinterpret_cast<int*>(pt + kBK * kQStride);

  const int tid = threadIdx.x;
  const int tq = tid >> 3;  // query rows 4 * tq .. 4 * tq + 3
  const int tk = tid & 7;   // key columns and output columns tk + 8 * j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  T* ob = out + b * os.b + h * os.h;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * t_len : nullptr;
  const int n_tiles = (t_len + kBK - 1) / kBK;

  stage_transposed<T, D>(qt, kQStride, qb, qs.t, q0, t_len);

  // pass 1: the row max m and l = sum exp(score - m), online over the key tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();
    stage_transposed<T, D>(kt, kKStride, kb, ks.t, k0, t_len);
    stage_key_codes(key_code, mb, k0, t_len);
    __syncthreads();
    float s[4][8] = {};
    tile_dot<D>(qt, 4 * tq, kt, tk, s);
    float tile_max[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = masked_score(s[i][j], code, scale);
        tile_max[i] = fmaxf(tile_max[i], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], offset));
      const float m_new = fmaxf(m[i], tile_max[i]);  // finite: every tile has a key below T
      l[i] *= expf(m[i] - m_new);                    // 0 on the first tile
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) l[i] += expf(__fsub_rn(s[i][j], m_new));
    }
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int offset = 1; offset < 8; offset <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], offset);
    inv_l[i] = 1.0f / l[i];
  }

  // pass 2: out = sum round(p) v with p normalized
  float acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc[i][j] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of K, V and P are done
    stage_transposed<T, D>(kt, kKStride, kb, ks.t, k0, t_len);
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      vt[r * D + d] = t < t_len ? to_float(vb[t * vs_.t + d]) : 0.0f;
    }
    stage_key_codes(key_code, mb, k0, t_len);
    __syncthreads();
    float s[4][8] = {};
    tile_dot<D>(qt, 4 * tq, kt, tk, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = round_to<T>(prob(masked_score(s[i][j], code, scale), m[i], inv_l[i]));
      *reinterpret_cast<float4*>(&pt[(tk + 8 * j) * kQStride + 4 * tq]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[kk * kQStride + 4 * tq]);
      float vv[kDT];
#pragma unroll
      for (int j = 0; j < kDT; ++j) vv[j] = vt[kk * D + tk + 8 * j];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[0][j] = fmaf(pv.x, vv[j], acc[0][j]);
        acc[1][j] = fmaf(pv.y, vv[j], acc[1][j]);
        acc[2][j] = fmaf(pv.z, vv[j], acc[2][j]);
        acc[3][j] = fmaf(pv.w, vv[j], acc[3][j]);
      }
    }
  }

  const size_t row0 = (static_cast<size_t>(b) * gridDim.y + h) * t_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * tq + i;
    if (t < t_len) {
#pragma unroll
      for (int j = 0; j < kDT; ++j) ob[t * os.t + tk + 8 * j] = from_float<T>(acc[i][j]);
      if (tk == 0) {
        stats[(row0 + t) * 2] = m[i];
        stats[(row0 + t) * 2 + 1] = l[i];
      }
    }
  }
}

// The walk over a row's key tiles of the bf16 forwards: the tiles with a real key; in a row with
// none (a batch-padding row, whose masked keys carry the uniform average), every tile. Fills the
// bitmaps; called by the whole block.
__device__ __forceinline__ some_mma::TileFilter key_tile_filter(const some_mma::Smem& sm,
                                                                const uint8_t* mb, int t_len) {
  some_mma::TileFilter filter{nullptr, nullptr, false, true};
  if (mb != nullptr && some_mma::tile_segments(sm, mb, t_len)) {
    filter.seg0 = sm.seg0;
    filter.seg1 = sm.seg1;
  }
  return filter;
}

// The bf16 inference forward on the tensor cores: flash_fwd_kernel's one pass of online softmax
// on the tile of attention_mma.cuh. Per key tile, the row max m grows to m_new; the row's output
// accumulators and l are scaled by alpha = exp(m - m_new); l adds the f32 p = exp(score - m_new)
// before p is rounded; bf16(p), unnormalised, packed in pairs, is the A fragment of P.V. The
// output is divided by l at the store. Key tiles are skipped as in the training forward.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int t_len, Strides qs, Strides ks,
                     Strides vs_, Strides os, float scale) {
  namespace mma = some_mma;
  using L = mma::Layout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const mma::Smem sm = mma::carve_smem<D>(mma_smem, t_len);
  const int q0 = blockIdx.x * mma::kRows;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(blockIdx.z) * t_len : nullptr;

  mma::stage_q<D>(sm, mma::head_slice(q, qs), qs.t, q0, t_len);
  const mma::TileFilter filter = key_tile_filter(sm, mb, t_len);
  uint32_t qf[L::kKSteps][4];
  mma::load_q_fragments<D>(qf, sm);

  // row i's scores are s[n][2 i] and s[n][2 i + 1]; register 2 h + i of a P fragment holds row
  // i's pair of score tile 2 ks + h
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[L::kOutTiles][4] = {};
  mma::walk_tiles<D, true>(
      sm, filter, mma::head_slice(k, ks), ks.t, mma::head_slice(v, vs_), vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16* v_tile, uint64_t real) {
        float s[8][4];
        masked_scores<D>(s, qf, k_tile, j, real, t_len, scale);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tile_max = -INFINITY;
#pragma unroll
          for (int n = 0; n < 8; ++n) tile_max = fmaxf(tile_max, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
          // finite: a walked tile has a key below T
          const float m_new = fmaxf(m[i], mma::quad_max(tile_max));
          const float alpha = mma::exp_(m[i] - m_new);  // 0 on the first tile
          m[i] = m_new;
          l[i] *= alpha;
#pragma unroll
          for (int n = 0; n < L::kOutTiles; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
          }
        }
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t pf[1][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float* x = s[2 * kstep + hh] + 2 * i;
              const float p0 = mma::exp_(__fsub_rn(x[0], m[i]));
              const float p1 = mma::exp_(__fsub_rn(x[1], m[i]));
              l[i] += p0;
              l[i] += p1;
              pf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(p0, p1));
            }
          mma::pv_step<D, 1>(o, pf, v_tile, kstep);
        }
      });

  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv_l[i] = 1.0f / mma::quad_sum(l[i]);
  mma::store_output<D>(mma::head_slice(out, os), os.t, q0, t_len, o, inv_l);
}

// The bf16 training forward on the tensor cores: flash_fwd_stats_kernel's two passes and
// arithmetic (see the note at the top) on the tile of attention_mma.cuh. Warp w owns query rows
// 16 w .. 16 w + 15; a thread holds rows g and g + 8 (lane = 4 g + c) of each score and output
// tile, so a row's statistics combine over the 4 lanes of a quad.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
flash_fwd_stats_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_len,
                           Strides qs, Strides ks, Strides vs_, Strides os, float scale) {
  namespace mma = some_mma;
  using L = mma::Layout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const mma::Smem sm = mma::carve_smem<D>(mma_smem, t_len);
  const int q0 = blockIdx.x * mma::kRows;
  const bf16* kb = mma::head_slice(k, ks);
  const bf16* vb = mma::head_slice(v, vs_);
  const uint8_t* mb = mask ? mask + static_cast<size_t>(blockIdx.z) * t_len : nullptr;

  mma::stage_q<D>(sm, mma::head_slice(q, qs), qs.t, q0, t_len);
  const mma::TileFilter filter = key_tile_filter(sm, mb, t_len);
  uint32_t qf[L::kKSteps][4];
  mma::load_q_fragments<D>(qf, sm);

  // pass 1: the row max m and l = sum exp(score - m), online over the key tiles; row i's scores
  // are s[n][2 i] and s[n][2 i + 1]
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mma::walk_tiles<D, false>(
      sm, filter, kb, ks.t, vb, vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16*, uint64_t real) {
        float s[8][4];
        masked_scores<D>(s, qf, k_tile, j, real, t_len, scale);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tile_max = -INFINITY;
#pragma unroll
          for (int n = 0; n < 8; ++n) tile_max = fmaxf(tile_max, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
          // finite: a walked tile has a key below T
          const float m_new = fmaxf(m[i], mma::quad_max(tile_max));
          l[i] *= mma::exp_(m[i] - m_new);  // 0 on the first tile
          m[i] = m_new;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            l[i] += mma::exp_(__fsub_rn(s[n][2 * i], m_new));
            l[i] += mma::exp_(__fsub_rn(s[n][2 * i + 1], m_new));
          }
        }
      });
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = mma::quad_sum(l[i]);
    inv_l[i] = 1.0f / l[i];
  }

  // pass 2: out = sum round(p) v with p normalized; P goes to P.V in registers, 16 keys a step:
  // register 2 h + i of the A fragment holds row i's pair of score tile 2 ks + h
  float o[L::kOutTiles][4] = {};
  mma::walk_tiles<D, true>(
      sm, filter, kb, ks.t, vb, vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16* v_tile, uint64_t real) {
        float s[8][4];
        masked_scores<D>(s, qf, k_tile, j, real, t_len, scale);
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t pf[1][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float* x = s[2 * kstep + hh] + 2 * i;
              pf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(
                  __fmul_rn(mma::exp_(__fsub_rn(x[0], m[i])), inv_l[i]),
                  __fmul_rn(mma::exp_(__fsub_rn(x[1], m[i])), inv_l[i])));
            }
          mma::pv_step<D, 1>(o, pf, v_tile, kstep);
        }
      });

  mma::store_output<D>(mma::head_slice(out, os), os.t, q0, t_len, o, {1.0f, 1.0f});
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + mma::thread_row(i);
    if (t < t_len && (threadIdx.x & 3) == 0) {
      stats[(row0 + t) * 2] = m[i];
      stats[(row0 + t) * 2 + 1] = l[i];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* stats, int batch, int heads, int t_len, Strides qs, Strides ks,
                   Strides vs_, Strides os, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    if (stats == nullptr)
      return some_mma::launch_blocks<D>(flash_fwd_mma_kernel<D>, batch, heads, t_len, stream, qp,
                                        kp, vp, mp, op, t_len, qs, ks, vs_, os, scale);
    return some_mma::launch_blocks<D>(flash_fwd_stats_mma_kernel<D>, batch, heads, t_len, stream,
                                      qp, kp, vp, mp, op, stats, t_len, qs, ks, vs_, os, scale);
  } else {
    const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
    const dim3 grid((t_len + kBQ - 1) / kBQ, heads, batch);
    cudaError_t err;
    if (stats == nullptr) {
      err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(qp, kp, vp, mp, op, t_len, qs, ks,
                                                              vs_, os, scale);
    } else {
      err = cudaFuncSetAttribute(flash_fwd_stats_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      flash_fwd_stats_kernel<T, D><<<grid, kThreads, smem, stream>>>(qp, kp, vp, mp, op, stats,
                                                                    t_len, qs, ks, vs_, os, scale);
    }
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* mask, void* out, float* stats, int batch, int heads,
                              int t_len, Strides qs, Strides ks, Strides vs_, Strides os,
                              float scale, cudaStream_t stream) {
  if (head_dim == 64)
    return launch<T, 64>(q, k, v, mask, out, stats, batch, heads, t_len, qs, ks, vs_, os, scale,
                         stream);
  if (head_dim == 32)
    return launch<T, 32>(q, k, v, mask, out, stats, batch, heads, t_len, qs, ks, vs_, os, scale,
                         stream);
  return cudaErrorInvalidValue;
}

int forward(const void* q, const void* k, const void* v, const void* mask, void* out,
            float* stats, int batch, int heads, int t_len, int head_dim,
            const long long* q_strides, const long long* k_strides, const long long* v_strides,
            const long long* o_strides, float scale, int dtype, void* stream) {
  if (batch < 0 || heads < 0 || t_len < 0 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || heads == 0 || t_len == 0) return cudaSuccess;
  const Strides qs = strides_of(q_strides), ks = strides_of(k_strides);
  const Strides vs_ = strides_of(v_strides), os = strides_of(o_strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(head_dim, q, k, v, mask, out, stats, batch, heads, t_len, qs,
                                    ks, vs_, os, scale, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, mask, out, stats, batch, heads,
                                            t_len, qs, ks, vs_, os, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: [batch, heads, t_len, head_dim] of one dtype (0 = float32, 1 = bfloat16), the
// last dimension contiguous, the others given as element strides {batch, head, time}.
// mask: [batch, t_len] bytes (1 = real key), contiguous, or null for no mask.
// head_dim is 32 or 64. Launches on `stream` and returns cudaGetLastError() (0 on success);
// it does not synchronise.
extern "C" int some_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int batch, int heads,
                                        int t_len, int head_dim, const long long* q_strides,
                                        const long long* k_strides, const long long* v_strides,
                                        const long long* o_strides, float scale, int dtype,
                                        void* stream) {
  return forward(q, k, v, mask, out, nullptr, batch, heads, t_len, head_dim, q_strides,
                 k_strides, v_strides, o_strides, scale, dtype, stream);
}

// The training forward: as some_flash_attention_fwd, and writes the row statistics (m, l) of
// every query to stats, f32 [batch, heads, t_len, 2] contiguous (see the note at the top).
extern "C" int some_flash_attention_fwd_stats(const void* q, const void* k, const void* v,
                                              const void* mask, void* out, float* stats,
                                              int batch, int heads, int t_len, int head_dim,
                                              const long long* q_strides,
                                              const long long* k_strides,
                                              const long long* v_strides,
                                              const long long* o_strides, float scale, int dtype,
                                              void* stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  return forward(q, k, v, mask, out, stats, batch, heads, t_len, head_dim, q_strides, k_strides,
                 v_strides, o_strides, scale, dtype, stream);
}
