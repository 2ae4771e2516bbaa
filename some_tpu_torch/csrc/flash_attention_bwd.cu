// Flash attention, backward: the gradients of the conformer's masked self-attention on Hopper.
//
// Replaces the Pallas TPU kernels JAX's flash_attention runs under jax.grad for
// some_tpu/ops/attention.py::_flash_attention_bhtd: _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/flash_attention.py). With
// P = softmax(where(key_mask, q k^T * scale, -1e9)) rebuilt from the forward's row statistics
// (m, l) exactly as the forward built it (flash_common.cuh), dO the output's cotangent and
// delta = rowsum(dO * O) (computed by the caller, as JAX computes it outside the kernel):
//     dV = round(P)^T dO                 (the rounded P the forward multiplied with V)
//     dS = P * (dO V^T - delta), and 0 at a masked key or a key past T
//     dK = scale * dS^T Q,   dQ = scale * dS K
// A masked key's score is a constant in the forward (where / masked_fill), so it carries no
// gradient: dS is exactly 0 there. That matters in a batch-padding row, where every key is
// masked and P is uniform (1/T, not 0): dV still gets P^T dO there, while dQ and dK stay 0.
//
// Bound: operations (the five T x T x D products below against 8 * T * D elements moved per
// (batch, head)). Like the forward, this first version does its products as f32 FMAs on the
// CUDA cores (no tensor cores, no TF32), with f32 accumulators.
//
// Design: two kernels, each with 128 threads and one tile of 64 rows, and no atomics, so two
// runs give the same bits.
//   * dkv: a block owns 64 keys of one (batch, head), keeps K^T and V^T in shared memory and its
//     dK and dV rows in registers, and walks the query tiles, staging Q^T, dO^T and the rows'
//     (m, 1/l, delta). Each thread holds 4 keys x 8 queries of the S^T and dP^T tiles.
//   * dq: a block owns 64 queries, keeps Q^T and dO^T in shared memory and its dQ rows in
//     registers, and walks the key tiles. Each thread holds 4 queries x 8 keys.
// Both recompute S and dP (two of the five products each); the P of the dkv kernel is the one the
// forward rounded, bit for bit. Inputs are read, and dQ, dK, dV written, through their strides,
// so all may be [B, H, T, D] views of [B, T, H, D] storage.
#include "flash_common.cuh"

namespace {

using namespace some_flash;

template <int D>
constexpr int dkv_smem_floats() {
  // K^T, V^T (vector stride); Q^T, dO^T (odd stride); P, dS as [query][key]; m, 1/l, delta
  return 2 * D * kVecStride + 2 * D * kOddStride + 2 * kBQ * kVecStride + 3 * kBQ + kBK;
}

template <int D>
constexpr int dq_smem_floats() {
  // Q^T, dO^T (vector stride); K^T, V^T (odd stride); dS as [key][query]; key codes
  return 2 * D * kVecStride + 2 * D * kOddStride + kBK * kVecStride + kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, Strides qs, Strides ks,
                     Strides vs_, Strides dos, Strides dks, Strides dvs, float scale) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                           // [D][kVecStride] K^T of this block's keys
  float* vt = kt + D * kVecStride;            // [D][kVecStride] V^T
  float* qt = vt + D * kVecStride;            // [D][kOddStride] Q^T of the query tile
  float* dot = qt + D * kOddStride;           // [D][kOddStride] dO^T
  float* pt = dot + D * kOddStride;           // [kBQ][kVecStride] round(P), [query][key]
  float* dst = pt + kBQ * kVecStride;         // [kBQ][kVecStride] dS, [query][key]
  float* row_m = dst + kBQ * kVecStride;      // [kBQ]
  float* row_inv_l = row_m + kBQ;             // [kBQ]
  float* row_delta = row_inv_l + kBQ;         // [kBQ]
  int* key_code = reinterpret_cast<int*>(row_delta + kBQ);  // [kBK]

  const int tid = threadIdx.x;
  const int tq = tid >> 3;  // keys 4 * tq .. 4 * tq + 3 of the block
  const int tk = tid & 7;   // queries tk + 8 * j of a tile, and output columns tk + 8 * j
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * t_len : nullptr;
  const size_t row0 = (static_cast<size_t>(b) * gridDim.y + h) * t_len;

  stage_transposed<T, D>(kt, kVecStride, kb, ks.t, k0, t_len);
  stage_transposed<T, D>(vt, kVecStride, vb, vs_.t, k0, t_len);
  stage_key_codes(key_code, mb, k0, t_len);
  __syncthreads();
  int code[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) code[i] = key_code[4 * tq + i];

  float acc_dk[4][kDT], acc_dv[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  const int n_tiles = (t_len + kBQ - 1) / kBQ;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kBQ;
    __syncthreads();  // the previous tile's reads are done
    stage_transposed<T, D>(qt, kOddStride, qb, qs.t, q0, t_len);
    stage_transposed<T, D>(dot, kOddStride, dob, dos.t, q0, t_len);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      // a query past T has q = dO = 0 and 1/l = 0, so its P and dS are 0
      row_m[r] = t < t_len ? stats[(row0 + t) * 2] : 0.0f;
      row_inv_l[r] = t < t_len ? 1.0f / stats[(row0 + t) * 2 + 1] : 0.0f;
      row_delta[r] = t < t_len ? delta[row0 + t] : 0.0f;
    }
    __syncthreads();

    float s[4][8] = {}, dp[4][8] = {};
    tile_dot<D>(kt, 4 * tq, qt, tk, s);    // S^T:  keys x queries
    tile_dot<D>(vt, 4 * tq, dot, tk, dp);  // dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tk + 8 * j;
      const float m = row_m[r], inv_l = row_inv_l[r], dl = row_delta[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = prob(masked_score(s[i][j], code[i], scale), m, inv_l);
        s[i][j] = round_to<T>(p);
        dp[i][j] = code[i] != 0 ? 0.0f : p * (dp[i][j] - dl);
      }
      *reinterpret_cast<float4*>(&pt[r * kVecStride + 4 * tq]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&dst[r * kVecStride + 4 * tq]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[qq * kVecStride + 4 * tq]);
      const float4 sv = *reinterpret_cast<const float4*>(&dst[qq * kVecStride + 4 * tq]);
      float dov[kDT], qv[kDT];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        dov[j] = dot[(tk + 8 * j) * kOddStride + qq];
        qv[j] = qt[(tk + 8 * j) * kOddStride + qq];
      }
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc_dv[0][j] = fmaf(pv.x, dov[j], acc_dv[0][j]);
        acc_dv[1][j] = fmaf(pv.y, dov[j], acc_dv[1][j]);
        acc_dv[2][j] = fmaf(pv.z, dov[j], acc_dv[2][j]);
        acc_dv[3][j] = fmaf(pv.w, dov[j], acc_dv[3][j]);
        acc_dk[0][j] = fmaf(sv.x, qv[j], acc_dk[0][j]);
        acc_dk[1][j] = fmaf(sv.y, qv[j], acc_dk[1][j]);
        acc_dk[2][j] = fmaf(sv.z, qv[j], acc_dk[2][j]);
        acc_dk[3][j] = fmaf(sv.w, qv[j], acc_dk[3][j]);
      }
    }
  }

  T* dkb = dk + b * dks.b + h * dks.h;
  T* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + 4 * tq + i;
    if (t < t_len) {
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        dkb[t * dks.t + tk + 8 * j] = from_float<T>(acc_dk[i][j] * scale);
        dvb[t * dvs.t + tk + 8 * j] = from_float<T>(acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ stats,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    T* __restrict__ dq, int t_len, Strides qs, Strides ks, Strides vs_,
                    Strides dos, Strides dqs, float scale) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                           // [D][kVecStride] Q^T of this block's queries
  float* dot = qt + D * kVecStride;           // [D][kVecStride] dO^T
  float* kt = dot + D * kVecStride;           // [D][kOddStride] K^T of the key tile
  float* vt = kt + D * kOddStride;            // [D][kOddStride] V^T
  float* dst = vt + D * kOddStride;           // [kBK][kVecStride] dS, [key][query]
  int* key_code = reinterpret_cast<int*>(dst + kBK * kVecStride);  // [kBK]

  const int tid = threadIdx.x;
  const int tq = tid >> 3;  // queries 4 * tq .. 4 * tq + 3 of the block
  const int tk = tid & 7;   // keys tk + 8 * j of a tile, and output columns tk + 8 * j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * t_len : nullptr;
  const size_t row0 = (static_cast<size_t>(b) * gridDim.y + h) * t_len;

  stage_transposed<T, D>(qt, kVecStride, qb, qs.t, q0, t_len);
  stage_transposed<T, D>(dot, kVecStride, dob, dos.t, q0, t_len);
  float m[4], inv_l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * tq + i;
    m[i] = t < t_len ? stats[(row0 + t) * 2] : 0.0f;
    inv_l[i] = t < t_len ? 1.0f / stats[(row0 + t) * 2 + 1] : 0.0f;
    dl[i] = t < t_len ? delta[row0 + t] : 0.0f;
  }

  float acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc[i][j] = 0.0f;

  const int n_tiles = (t_len + kBK - 1) / kBK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads are done
    stage_transposed<T, D>(kt, kOddStride, kb, ks.t, k0, t_len);
    stage_transposed<T, D>(vt, kOddStride, vb, vs_.t, k0, t_len);
    stage_key_codes(key_code, mb, k0, t_len);
    __syncthreads();

    float s[4][8] = {}, dp[4][8] = {};
    tile_dot<D>(qt, 4 * tq, kt, tk, s);    // S:  queries x keys
    tile_dot<D>(dot, 4 * tq, vt, tk, dp);  // dP: queries x keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = prob(masked_score(s[i][j], code, scale), m[i], inv_l[i]);
        dp[i][j] = code != 0 ? 0.0f : p * (dp[i][j] - dl[i]);
      }
      *reinterpret_cast<float4*>(&dst[(tk + 8 * j) * kVecStride + 4 * tq]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 sv = *reinterpret_cast<const float4*>(&dst[kk * kVecStride + 4 * tq]);
      float kv[kDT];
#pragma unroll
      for (int j = 0; j < kDT; ++j) kv[j] = kt[(tk + 8 * j) * kOddStride + kk];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[0][j] = fmaf(sv.x, kv[j], acc[0][j]);
        acc[1][j] = fmaf(sv.y, kv[j], acc[1][j]);
        acc[2][j] = fmaf(sv.z, kv[j], acc[2][j]);
        acc[3][j] = fmaf(sv.w, kv[j], acc[3][j]);
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * tq + i;
    if (t < t_len) {
#pragma unroll
      for (int j = 0; j < kDT; ++j) dqb[t * dqs.t + tk + 8 * j] = from_float<T>(acc[i][j] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *stats, *delta;
  const void* mask;
  void *dq, *dk, *dv;
  int batch, heads, t_len;
  Strides qs, ks, vs_, dos, dqs, dks, dvs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kBK - 1) / kBK, a.heads, a.batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.stats, a.delta, static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks,
      a.dvs, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.stats, a.delta, static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.dq), a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dqs, a.scale);
  return cudaGetLastError();
}

// which: 0 = dkv, 1 = dq
template <typename T, int D>
cudaError_t launch_one(int which, const Args& a) {
  return which == 0 ? launch_dkv<T, D>(a) : launch_dq<T, D>(a);
}

int backward(int which, int head_dim, int dtype, const Args& a) {
  if (a.batch < 0 || a.heads < 0 || a.t_len < 0 || a.batch > 65535 || a.heads > 65535)
    return cudaErrorInvalidValue;
  if (a.batch == 0 || a.heads == 0 || a.t_len == 0) return cudaSuccess;
  if (dtype == 0 && head_dim == 64) return launch_one<float, 64>(which, a);
  if (dtype == 0 && head_dim == 32) return launch_one<float, 32>(which, a);
  if (dtype == 1 && head_dim == 64) return launch_one<__nv_bfloat16, 64>(which, a);
  if (dtype == 1 && head_dim == 32) return launch_one<__nv_bfloat16, 32>(which, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout and the gradients: [batch, heads, t_len, head_dim] of one dtype (0 = float32,
// 1 = bfloat16), the last dimension contiguous, the others given as element strides {batch,
// head, time}. stats: the forward's f32 [batch, heads, t_len, 2] (m, l); delta: f32 [batch,
// heads, t_len] = rowsum(dout * out); mask: [batch, t_len] bytes (1 = real key) or null; all
// three contiguous. head_dim is 32 or 64. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); neither synchronises.
extern "C" int some_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* stats,
    const float* delta, const void* mask, void* dk, void* dv, int batch, int heads, int t_len,
    int head_dim, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dk_strides,
    const long long* dv_strides, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, stats, delta, mask, nullptr, dk, dv, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), Strides{0, 0, 0}, strides_of(dk_strides),
         strides_of(dv_strides), scale, static_cast<cudaStream_t>(stream)};
  return backward(0, head_dim, dtype, a);
}

extern "C" int some_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* stats,
    const float* delta, const void* mask, void* dq, int batch, int heads, int t_len,
    int head_dim, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dq_strides,
    float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, stats, delta, mask, dq, nullptr, nullptr, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), strides_of(dq_strides), Strides{0, 0, 0}, Strides{0, 0, 0},
         scale, static_cast<cudaStream_t>(stream)};
  return backward(1, head_dim, dtype, a);
}
