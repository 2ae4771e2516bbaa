// Pieces shared by the flash attention kernels (flash_attention.cu, flash_attention_bwd.cu).
//
// The training forward and both backward kernels rebuild one score tile with the same
// arithmetic, so a probability the backward recomputes is bit for bit the one the forward
// multiplied with v: s = sum_d q[d] * k[d] as f32 fused multiply-adds in ascending d from 0,
// score = s * scale rounded once (no contraction with what follows), masked keys -1e9, keys past
// T -inf, and p = exp(score - m) * (1 / l) with the row statistics (m, l) the forward stored.
// That holds in f32. In bf16 all three run on the tensor cores (attention_mma.cuh): the training
// forward and the dq kernel take masked_scores below, the dk/dv kernel forms S^T with the same
// products and k16 steps, and all three agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace some_flash {

constexpr int kBQ = 64;        // queries per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 32 groups of 4 rows x 8 lanes
constexpr int kVecStride = 68; // rows of a tile read as float4 over 4 neighbours: 16-byte aligned
constexpr int kOddStride = 65; // rows of a tile read one entry per lane: odd, so the transposing
                               // stores of the staging loops spread over the banks
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The probabilities in the input dtype, as f32 for the product with v.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

struct Strides {
  long long b, h, t;
};

// Key codes of a tile: 0 real, 1 masked (score -1e9), 2 past T (score -inf).
__device__ __forceinline__ void stage_key_codes(int* codes, const uint8_t* mb, int k0,
                                                int t_len) {
  for (int r = threadIdx.x; r < kBK; r += kThreads) {
    const int t = k0 + r;
    codes[r] = t >= t_len ? 2 : (mb != nullptr && mb[t] == 0 ? 1 : 0);
  }
}

// dst[d * stride + r] = src[(t0 + r) * ts + d] for the 64 rows of a tile, zeros past T.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, int stride, const T* src,
                                                 long long ts, int t0, int t_len) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[d * stride + r] = t < t_len ? to_float(src[t * ts + d]) : 0.0f;
  }
}

// s[i][j] += sum_d a[d * kVecStride + a0 + i] * b[d * kOddStride + b0 + 8 * j], d ascending:
// rows a0 .. a0 + 3 of one operand against rows b0 + 8 j of the other, both stored transposed.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, int a0, const float* b, int b0,
                                         float s[4][8]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = *reinterpret_cast<const float4*>(&a[d * kVecStride + a0]);
    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b[d * kOddStride + b0 + 8 * j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[0][j] = fmaf(av.x, bv[j], s[0][j]);
      s[1][j] = fmaf(av.y, bv[j], s[1][j]);
      s[2][j] = fmaf(av.z, bv[j], s[2][j]);
      s[3][j] = fmaf(av.w, bv[j], s[3][j]);
    }
  }
}

__device__ __forceinline__ float masked_score(float s, int code, float scale) {
  if (code == 1) return kMaskedScore;
  if (code == 2) return -INFINITY;
  return __fmul_rn(s, scale);
}

// The normalized probability of a score, from its row's max m and 1 / (sum of exp(score - m)).
__device__ __forceinline__ float prob(float score, float m, float inv_l) {
  return __fmul_rn(expf(__fsub_rn(score, m)), inv_l);
}

inline Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

// The scores of key tile j on the tensor cores (attention_mma.cuh), as flash_fwd_stats_kernel
// forms them: s = Q K^T summed over d in k16 steps, then s * scale rounded once, masked keys
// -1e9, keys past T -inf. real is the tile's real_bits. The training forward and the dq kernel
// (flash_attention_bwd.cu) call it; the dk/dv kernel forms S^T with the same products, k16 steps
// and arithmetic, so all three rebuild one P bit for bit.
template <int D>
__device__ __forceinline__ void masked_scores(float (&s)[8][4],
                                              const uint32_t (&qf)[some_mma::Layout<D>::kKSteps][4],
                                              const __nv_bfloat16* k_tile, int j, uint64_t real,
                                              int t_len, float scale) {
  namespace mma = some_mma;
  mma::score_tile<D>(s, qf, k_tile);
  if (real == ~0ull) {  // every key real: nothing to mask
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
    return;
  }
  const uint32_t is_real = mma::thread_columns(real);
  const uint32_t below_t = mma::thread_columns(mma::below_t_bits(j * mma::kRows, t_len));
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 2 * n + (e & 1);
      s[n][e] = ((is_real >> bit) & 1u) ? __fmul_rn(s[n][e], scale)
                                        : (((below_t >> bit) & 1u) ? kMaskedScore : -INFINITY);
    }
}

}  // namespace some_flash
