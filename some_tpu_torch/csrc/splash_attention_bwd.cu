// Splash attention, backward: the gradients of attention_impl 'splash' on Hopper.
//
// Replaces the Pallas TPU kernels JAX's splash attention runs under jax.grad for
// some_tpu/ops/attention.py::_splash_attention_bhtd (jax/experimental/pallas/ops/tpu/
// splash_attention/splash_attention_kernel.py): _flash_attention_dkv_kernel (:1669, pallas_call
// :2196) and _flash_attention_dq_kernel (:1307, pallas_call :1635; splash runs it as a kernel of
// its own, use_fused_bwd_kernel being false). With q pre-scaled, P = exp(score - lse) rebuilt from
// the forward's f32 log-sum-exp and scores (splash_common.cuh), dO the output's cotangent and
// di = rowsum(O * dO) (computed by the caller, as JAX computes it in XLA, :2285):
//     dV = round(P)^T dO                 (P rounded to dO's dtype, :1788)
//     dP = dO V^T,  dS = (dP - di) * P    (f32)
//     dK = round(dS)^T q,  dQ = round(dS) K   (dS rounded to the input dtype, :1804, :1395)
// with f32 sums and the gradients cast to the input dtype. dQ is the gradient of the pre-scaled q;
// the caller's autograd carries it through the pre-scale. A key in another segment has P exactly
// 0 (exp of the mask value minus a real log-sum-exp underflows), so its dS is exactly 0 and no
// gradient crosses segments.
//
// Bound: operations (the five T x T x D products below against 8 * T * D elements moved per
// (batch, head)). Like the forward, this first version does its products as f32 FMAs on the CUDA
// cores (no tensor cores, no TF32), with f32 accumulators.
//
// Design: the flash backward kernels' (flash_attention_bwd.cu), with the same tiles and no
// atomics, so two runs give the same bits.
//   * dkv: a block owns 64 keys of one (batch, head), keeps K^T and V^T in shared memory and its
//     dK and dV rows in registers, and walks the query tiles, staging Q^T, dO^T and the rows'
//     (lse, di, segment). Each thread holds 4 keys x 8 queries of the S^T and dP^T tiles.
//   * dq: a block owns 64 queries, keeps Q^T and dO^T in shared memory and its dQ rows in
//     registers, and walks the key tiles. Each thread holds 4 queries x 8 keys.
// A query past T gets lse = +inf, so its P is 0. Inputs are read, and dQ, dK, dV written, through
// their strides, so all may be [B, H, T, D] views of [B, T, H, D] storage.
#include "splash_common.cuh"

namespace {

using namespace some_splash;

template <int D>
constexpr int dkv_smem_floats() {
  // K^T, V^T (vector stride); Q^T, dO^T (odd stride); round(P), round(dS) as [query][key];
  // lse, di, segment per query; key codes
  return 2 * D * kVecStride + 2 * D * kOddStride + 2 * kBQ * kVecStride + 3 * kBQ + kBK;
}

template <int D>
constexpr int dq_smem_floats() {
  // Q^T, dO^T (vector stride); K^T, V^T (odd stride); round(dS) as [key][query]; key codes
  return 2 * D * kVecStride + 2 * D * kOddStride + kBK * kVecStride + kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ di, const uint8_t* __restrict__ mask,
                      T* __restrict__ dk, T* __restrict__ dv, int t_len, Strides qs, Strides ks,
                      Strides vs_, Strides dos, Strides dks, Strides dvs) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                           // [D][kVecStride] K^T of this block's keys
  float* vt = kt + D * kVecStride;            // [D][kVecStride] V^T
  float* qt = vt + D * kVecStride;            // [D][kOddStride] Q^T of the query tile
  float* dot = qt + D * kOddStride;           // [D][kOddStride] dO^T
  float* pt = dot + D * kOddStride;           // [kBQ][kVecStride] round(P), [query][key]
  float* dst = pt + kBQ * kVecStride;         // [kBQ][kVecStride] round(dS), [query][key]
  float* row_lse = dst + kBQ * kVecStride;    // [kBQ]
  float* row_di = row_lse + kBQ;              // [kBQ]
  int* row_seg = reinterpret_cast<int*>(row_di + kBQ);  // [kBQ]
  int* key_code = row_seg + kBQ;                         // [kBK]

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
  stage_segment_codes(key_code, mb, k0, t_len);
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
      row_lse[r] = t < t_len ? lse[row0 + t] : INFINITY;  // past T: P = 0
      row_di[r] = t < t_len ? di[row0 + t] : 0.0f;
      row_seg[r] = segment_of(mb, t, t_len);
    }
    __syncthreads();

    float s[4][8] = {}, dp[4][8] = {};
    tile_dot<D>(kt, 4 * tq, qt, tk, s);    // S^T:  keys x queries
    tile_dot<D>(vt, 4 * tq, dot, tk, dp);  // dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tk + 8 * j;
      const float row_l = row_lse[r], dl = row_di[r];
      const int seg = row_seg[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(__fsub_rn(splash_score(s[i][j], code[i], seg), row_l));
        s[i][j] = round_to<T>(p);
        dp[i][j] = round_to<T>(__fmul_rn(__fsub_rn(dp[i][j], dl), p));
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
        dkb[t * dks.t + tk + 8 * j] = from_float<T>(acc_dk[i][j]);
        dvb[t * dvs.t + tk + 8 * j] = from_float<T>(acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, const uint8_t* __restrict__ mask,
                     T* __restrict__ dq, int t_len, Strides qs, Strides ks, Strides vs_,
                     Strides dos, Strides dqs) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                           // [D][kVecStride] Q^T of this block's queries
  float* dot = qt + D * kVecStride;           // [D][kVecStride] dO^T
  float* kt = dot + D * kVecStride;           // [D][kOddStride] K^T of the key tile
  float* vt = kt + D * kOddStride;            // [D][kOddStride] V^T
  float* dst = vt + D * kOddStride;           // [kBK][kVecStride] round(dS), [key][query]
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
  float row_l[4], dl[4];
  int seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * tq + i;
    row_l[i] = t < t_len ? lse[row0 + t] : INFINITY;
    dl[i] = t < t_len ? di[row0 + t] : 0.0f;
    seg[i] = segment_of(mb, t, t_len);
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
    stage_segment_codes(key_code, mb, k0, t_len);
    __syncthreads();

    float s[4][8] = {}, dp[4][8] = {};
    tile_dot<D>(qt, 4 * tq, kt, tk, s);    // S:  queries x keys
    tile_dot<D>(dot, 4 * tq, vt, tk, dp);  // dP: queries x keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(__fsub_rn(splash_score(s[i][j], code, seg[i]), row_l[i]));
        dp[i][j] = round_to<T>(__fmul_rn(__fsub_rn(dp[i][j], dl[i]), p));
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
      for (int j = 0; j < kDT; ++j) dqb[t * dqs.t + tk + 8 * j] = from_float<T>(acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  const void* mask;
  void *dq, *dk, *dv;
  int batch, heads, t_len;
  Strides qs, ks, vs_, dos, dqs, dks, dvs;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(splash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kBK - 1) / kBK, a.heads, a.batch);
  splash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks,
      a.dvs);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(splash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kBQ - 1) / kBQ, a.heads, a.batch);
  splash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.dq), a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dqs);
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

// q (pre-scaled), k, v, dout and the gradients: [batch, heads, t_len, head_dim] of one dtype
// (0 = float32, 1 = bfloat16), the last dimension contiguous, the others given as element strides
// {batch, head, time}. lse: the forward's f32 [batch, heads, t_len]; di: f32 [batch, heads,
// t_len] = rowsum(out * dout); mask: [batch, t_len] bytes (a frame's segment) or null; all three
// contiguous. head_dim is 32 or 64. Each launches on `stream` and returns cudaGetLastError() (0 on
// success); neither synchronises.
extern "C" int some_splash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* di, const void* mask, void* dk, void* dv, int batch, int heads, int t_len,
    int head_dim, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dk_strides,
    const long long* dv_strides, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, di, mask, nullptr, dk, dv, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), Strides{0, 0, 0}, strides_of(dk_strides),
         strides_of(dv_strides), static_cast<cudaStream_t>(stream)};
  return backward(0, head_dim, dtype, a);
}

extern "C" int some_splash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* di, const void* mask, void* dq, int batch, int heads, int t_len, int head_dim,
    const long long* q_strides, const long long* k_strides, const long long* v_strides,
    const long long* do_strides, const long long* dq_strides, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, di, mask, dq, nullptr, nullptr, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), strides_of(dq_strides), Strides{0, 0, 0}, Strides{0, 0, 0},
         static_cast<cudaStream_t>(stream)};
  return backward(1, head_dim, dtype, a);
}
