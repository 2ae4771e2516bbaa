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
// elements moved). This first kernel does its products as f32 FMAs on the CUDA cores, not on
// the tensor cores, so it runs far from that bound; f32 inputs stay in true f32 (no TF32).
//
// Design: a block owns 64 queries of one (batch, head) and 128 threads. Q stays in shared
// memory; the block walks the keys in tiles of 64, staging K (transposed) and V in shared
// memory, and keeps the running max, the running sum and the output rows in f32 registers
// (the online softmax). Each thread holds a 4 x 8 block of the score tile and a 4 x D/8 block of
// the output, so each value read from shared memory feeds 4 or 8 FMAs. Keys past T (the ragged
// last tile) score -inf and drop out; queries past T are computed and not stored. Inputs are
// read through their strides, so q, k and v may be views into the projections' [B, T, H, D]
// outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kQStride = kBQ + 4;  // rows of Q^T and P^T: 16-byte aligned for float4 access
constexpr int kKStride = kBK + 1;  // rows of K^T: odd, so the transposing stores spread over banks
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

template <int D>
constexpr int smem_floats() {
  return D * kQStride + D * kKStride + kBK * D + kBK * kQStride + kBK;
}

struct Strides {
  long long b, h, t;
};

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
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int batch, int heads, int t_len, Strides qs, Strides ks, Strides vs_,
                   Strides os, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), t_len, qs, ks, vs_, os, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* mask, void* out, int batch, int heads, int t_len,
                              Strides qs, Strides ks, Strides vs_, Strides os, float scale,
                              cudaStream_t stream) {
  if (head_dim == 64)
    return launch<T, 64>(q, k, v, mask, out, batch, heads, t_len, qs, ks, vs_, os, scale, stream);
  if (head_dim == 32)
    return launch<T, 32>(q, k, v, mask, out, batch, heads, t_len, qs, ks, vs_, os, scale, stream);
  return cudaErrorInvalidValue;
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

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
  if (batch < 0 || heads < 0 || t_len < 0 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || heads == 0 || t_len == 0) return cudaSuccess;
  const Strides qs = strides_of(q_strides), ks = strides_of(k_strides);
  const Strides vs_ = strides_of(v_strides), os = strides_of(o_strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(head_dim, q, k, v, mask, out, batch, heads, t_len, qs, ks,
                                    vs_, os, scale, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, mask, out, batch, heads, t_len,
                                            qs, ks, vs_, os, scale, s);
  return cudaErrorInvalidValue;
}
