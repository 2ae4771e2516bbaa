// Flash attention, backward: the gradients of the conformer's masked self-attention on Hopper.
//
// Replaces the Pallas TPU kernels JAX's flash_attention runs under jax.grad for
// some_tpu/ops/attention.py::_flash_attention_bhtd: _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/flash_attention.py). With
// P = softmax(where(key_mask, q k^T * scale, -1e9)) rebuilt from the forward's row statistics
// (m, l) exactly as the forward built it (flash_common.cuh), dO the output's cotangent and
// delta = rowsum(P * dP) (the dq kernel's, from the caller's rowsum(dO * O); below):
//     dV = round(P)^T dO                 (the rounded P the forward multiplied with V)
//     dS = P * (dO V^T - delta), and 0 at a masked key or a key past T
//     dK = scale * dS^T Q,   dQ = scale * dS K
// A masked key's score is a constant in the forward (where / masked_fill), so it carries no
// gradient: dS is exactly 0 there. That matters in a batch-padding row, where every key is
// masked and P is uniform (1/T, not 0): dV still gets P^T dO there, while dQ and dK stay 0.
//
// Bound: operations (the five T x T x D products below against 8 * T * D elements moved per
// (batch, head)). f32 does its products as f32 FMAs on the CUDA cores (no TF32), with f32
// accumulators; the bf16 dk/dv and dq kernels run on the tensor cores (below).
//
// Design: two kernels, each with 128 threads and one tile of 64 rows, and no atomics, so two
// runs give the same bits.
//   * dkv: a block owns 64 keys of one (batch, head), keeps its dK and dV rows in registers, and
//     walks the query tiles. In f32 (flash_bwd_dkv_kernel) K^T and V^T stay in shared memory and
//     each thread holds 4 keys x 8 queries of the S^T and dP^T tiles. In bf16
//     (flash_bwd_dkv_mma_kernel) it is the tile of attention_mma.cuh with the sides swapped: K and
//     V are A fragments (warp w owns keys 16 w .. 16 w + 15), the ring carries Q and dO where a
//     forward's carries K and V, and each query tile's (m, l, delta) is copied beside them. S^T =
//     K Q^T and dP^T = V dO^T come from mma.sync, dP in f32. S^T sums the products of the
//     forward's S = Q K^T in the same k16 steps, and P = exp(score - m) * (1 / l) takes the
//     forward's score arithmetic, so P is the bf16 training forward's bit for bit (GPU test).
//     round(P^T) packed in pairs is the A fragment of dV += P^T dO. dS^T = P^T (dP^T - delta)
//     times the scale goes into dK += dS^T Q as hi + lo, two bf16 A fragments and two mma into
//     one f32 accumulator (as splash keeps P f32), not rounded to bf16 as JAX's kernel rounds it
//     (ds * sm_scale, then astype): that one rounding takes dK past 2 ulp + 0.02 RMS of the f32
//     gradient at a point of the GPU test grid (PERF.md). In a row with a real key, a block whose
//     keys are all masked or past T writes dK = dV = 0 and returns: exactly what walking gives.
//   * dq: a block owns 64 queries, keeps its dQ rows in registers, and walks the key tiles. The
//     caller's delta = rowsum(dO * O), as JAX takes it, has O as the forward stored it, rounded
//     to bf16, and the sum of dS over a row cancels to its error; where P is peaked, that error
//     times sum P K reaches the whole dQ row at once and took it past 2 ulp + 0.02 RMS of the f32
//     gradient (PERF.md). So the walk also sums r = sum P (dP - delta) and P K over the real
//     keys, and dQ = scale (sum dS K - r sum P K): the dQ of delta = sum P dP in f32, the plain
//     autograd's delta, at the cost of a fourth product. The kernel writes that delta + r, and
//     the dk/dv kernel, launched after it, takes it: the caller's delta took dK past the same
//     bound on some random draws. In f32 (flash_bwd_dq_kernel) Q^T and dO^T stay in shared
//     memory and each thread holds 4 queries x 8 keys. In bf16 (flash_bwd_dq_mma_kernel) it is
//     the training forward's tile with dO beside Q: Q and dO are A fragments (warp w owns queries
//     16 w .. 16 w + 15), the ring carries K and V. S = Q K^T comes from masked_scores, the
//     forward's, so P = exp(s - m) * (1 / l) is the forward's bit for bit; dP = dO V^T in f32.
//     dS = P (dP - delta), 0 at a masked key, times the scale goes into dQ += dS K as hi + lo
//     (two mma, as the dk/dv kernel takes dS for dK), and round(P) into sum P K, both with K as
//     the B operand in V's layout from one read of the tile (pv_step2). Key tiles with no real
//     key add exactly 0 to all three sums and are skipped; a row with no real key walks none and
//     keeps dQ = 0 and its delta.
// Inputs are read, and dQ, dK, dV written, through their strides, so all may be [B, H, T, D]
// views of [B, T, H, D] storage; the bf16 kernels copy rows with cp.async, so their wrappers
// raise on rows that are not 16-byte aligned.
#include <type_traits>

#include "attention_mma.cuh"
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
  // Q^T, dO^T (vector stride); K^T, V^T (odd stride); dS, P as [key][query]; key codes
  return 2 * D * kVecStride + 2 * D * kOddStride + 2 * kBK * kVecStride + kBK;
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

// The bf16 dk/dv kernel on the tensor cores: flash_bwd_dkv_kernel's function on the tile of
// attention_mma.cuh with the sides swapped (see the note at the top). Warp w owns keys
// 16 w .. 16 w + 15 of the block, held as A fragments of K and V; a thread holds keys g and g + 8
// (lane = 4 g + c) of each S^T and dP^T tile, against queries 8 n + 2 c, 8 n + 2 c + 1.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                         const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int t_len, Strides qs, Strides ks, Strides vs_, Strides dos,
                         Strides dks, Strides dvs, float scale) {
  namespace mma = some_mma;
  using L = mma::Layout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const mma::Smem sm = mma::carve_smem_kv<D>(mma_smem, t_len);
  const int k0 = blockIdx.x * mma::kRows;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(blockIdx.z) * t_len : nullptr;
  bf16* const dkb = mma::head_slice(dk, dks);
  bf16* const dvb = mma::head_slice(dv, dvs);
  float o_dk[L::kOutTiles][4] = {}, o_dv[L::kOutTiles][4] = {};

  // exact skipping: in a row with a real key, a block of keys that are all masked or past T has
  // P = 0 (exp(-1e9 - m) is 0) and dS = 0, so dK = dV = 0, as walking every query tile gives
  const int t = k0 + static_cast<int>(threadIdx.x);
  const bool real_here = threadIdx.x < mma::kRows && t < t_len && (mb == nullptr || mb[t] != 0);
  if (!__syncthreads_or(real_here)) {
    int row_real = 0;  // mb is not null here: without a mask every key below T is real
    for (int i = threadIdx.x; i < t_len && !row_real; i += mma::kThreads) row_real = mb[i] != 0;
    if (__syncthreads_or(row_real)) {
      mma::store_output<D>(dkb, dks.t, k0, t_len, o_dk, {0.0f, 0.0f});
      mma::store_output<D>(dvb, dvs.t, k0, t_len, o_dv, {0.0f, 0.0f});
      return;
    }
  }

  mma::load_tile<D>(sm.q_tile, mma::head_slice(k, ks), ks.t, k0, t_len);
  mma::load_tile<D>(sm.v_tile, mma::head_slice(v, vs_), vs_.t, k0, t_len);
  mma::cp_async_commit();
  // the codes of the thread's two keys: 0 real, 1 masked (score -1e9), 2 past T (score -inf)
  int code[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + mma::thread_row(i);
    code[i] = key >= t_len ? 2 : (mb != nullptr && mb[key] == 0 ? 1 : 0);
  }
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
  mma::cp_async_wait_all();
  __syncthreads();
  uint32_t kf[L::kKSteps][4], vf[L::kKSteps][4];
  mma::load_a_fragments<D>(kf, sm.q_tile);
  mma::load_a_fragments<D>(vf, sm.v_tile);

  // (m, l) and delta of query tile j go to row_vals[j & 1] beside its Q and dO copies: there is
  // no tile filter, so tile j + 1 is always the next one and never shares j's slot. A query past
  // T reads zeros: m = 0, l = 0 (taken as 1 / l = 0) and delta = 0, so its P and dS are 0.
  float2* const ml_ring = reinterpret_cast<float2*>(sm.row_vals);
  float* const delta_ring = sm.row_vals + 4 * mma::kRows;
  auto stage_rows = [&](int j, int) {
    const int r = threadIdx.x & (mma::kRows - 1);
    const int tq = j * mma::kRows + r;
    const bool valid = tq < t_len;
    const size_t at = row0 + (valid ? tq : 0);
    if (threadIdx.x < mma::kRows)
      mma::cp_async_8(ml_ring + (j & 1) * mma::kRows + r, stats + 2 * at, valid);
    else
      mma::cp_async_4(delta_ring + (j & 1) * mma::kRows + r, delta + at, valid);
  };

  const int c = threadIdx.x & 3;
  mma::walk_tiles<D, true>(
      sm, mma::TileFilter{nullptr, nullptr, false, true}, mma::head_slice(q, qs), qs.t,
      mma::head_slice(dout, dos), dos.t, nullptr, t_len,
      [&](int j, const bf16* q_tile, const bf16* do_tile, uint64_t) {
        float s[8][4], dp[8][4];
        mma::score_tile<D>(s, kf, q_tile);    // S^T: the warp's 16 keys x the tile's 64 queries
        mma::score_tile<D>(dp, vf, do_tile);  // dP^T, f32
        const float2* ml = ml_ring + (j & 1) * mma::kRows;
        const float* dl = delta_ring + (j & 1) * mma::kRows;
        // 16 queries a step: register 2 h + i of a fragment holds key i's pair of tile 2 ks + h
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t pf[1][4], sf[2][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int n = 2 * kstep + hh, col = 8 * n + 2 * c;
            const float2 ml0 = ml[col], ml1 = ml[col + 1];
            const float inv_l0 = ml0.y > 0.0f ? __frcp_rn(ml0.y) : 0.0f;
            const float inv_l1 = ml1.y > 0.0f ? __frcp_rn(ml1.y) : 0.0f;
            const float dl0 = dl[col], dl1 = dl[col + 1];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              // the forward's score arithmetic (masked_scores), then P as its pass 2 forms it
              float x0 = __fmul_rn(s[n][2 * i], scale), x1 = __fmul_rn(s[n][2 * i + 1], scale);
              if (code[i] != 0) x0 = x1 = code[i] == 1 ? kMaskedScore : -INFINITY;
              const float p0 = __fmul_rn(mma::exp_(__fsub_rn(x0, ml0.x)), inv_l0);
              const float p1 = __fmul_rn(mma::exp_(__fsub_rn(x1, ml1.x)), inv_l1);
              pf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(p0, p1));
              // dS = P (dP - delta), 0 at a masked key; times the scale, as hi + lo
              const float ds0 = code[i] != 0 ? 0.0f : p0 * (dp[n][2 * i] - dl0);
              const float ds1 = code[i] != 0 ? 0.0f : p1 * (dp[n][2 * i + 1] - dl1);
              mma::split_bf16(ds0 * scale, ds1 * scale, sf[0][2 * hh + i], sf[1][2 * hh + i]);
            }
          }
          mma::pv_step<D, 1>(o_dv, pf, do_tile, kstep);  // dV += round(P)^T dO
          mma::pv_step<D, 2>(o_dk, sf, q_tile, kstep);   // dK += (dS scale)^T Q
        }
      },
      stage_rows);

  mma::store_output<D>(dkb, dks.t, k0, t_len, o_dk, {1.0f, 1.0f});
  mma::store_output<D>(dvb, dvs.t, k0, t_len, o_dv, {1.0f, 1.0f});
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ stats,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    T* __restrict__ dq, float* __restrict__ delta_out, int t_len, Strides qs,
                    Strides ks, Strides vs_, Strides dos, Strides dqs, float scale) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                           // [D][kVecStride] Q^T of this block's queries
  float* dot = qt + D * kVecStride;           // [D][kVecStride] dO^T
  float* kt = dot + D * kVecStride;           // [D][kOddStride] K^T of the key tile
  float* vt = kt + D * kOddStride;            // [D][kOddStride] V^T
  float* dst = vt + D * kOddStride;           // [kBK][kVecStride] dS, [key][query]
  float* pst = dst + kBK * kVecStride;        // [kBK][kVecStride] P, 0 at a masked key
  int* key_code = reinterpret_cast<int*>(pst + kBK * kVecStride);  // [kBK]

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

  // acc = sum_k dS K with the caller's delta; acc_p = sum_k P K and resid = sum_k dS (this
  // thread's keys) over the real keys, for the correction at the end
  float acc[4][kDT], acc_p[4][kDT], resid[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc[i][j] = acc_p[i][j] = 0.0f;

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
        const float p = code != 0 ? 0.0f : prob(masked_score(s[i][j], code, scale), m[i], inv_l[i]);
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl[i]);
        resid[i] += dp[i][j];
      }
      *reinterpret_cast<float4*>(&dst[(tk + 8 * j) * kVecStride + 4 * tq]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      *reinterpret_cast<float4*>(&pst[(tk + 8 * j) * kVecStride + 4 * tq]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 sv = *reinterpret_cast<const float4*>(&dst[kk * kVecStride + 4 * tq]);
      const float4 pv = *reinterpret_cast<const float4*>(&pst[kk * kVecStride + 4 * tq]);
      float kv[kDT];
#pragma unroll
      for (int j = 0; j < kDT; ++j) kv[j] = kt[(tk + 8 * j) * kOddStride + kk];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[0][j] = fmaf(sv.x, kv[j], acc[0][j]);
        acc[1][j] = fmaf(sv.y, kv[j], acc[1][j]);
        acc[2][j] = fmaf(sv.z, kv[j], acc[2][j]);
        acc[3][j] = fmaf(sv.w, kv[j], acc[3][j]);
        acc_p[0][j] = fmaf(pv.x, kv[j], acc_p[0][j]);
        acc_p[1][j] = fmaf(pv.y, kv[j], acc_p[1][j]);
        acc_p[2][j] = fmaf(pv.z, kv[j], acc_p[2][j]);
        acc_p[3][j] = fmaf(pv.w, kv[j], acc_p[3][j]);
      }
    }
  }

  // sum P (dP - delta) over the row's real keys: the 8 lanes tk of a group hold its parts
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) resid[i] += __shfl_xor_sync(0xffffffffu, resid[i], off);

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * tq + i;
    if (t < t_len) {
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        dqb[t * dqs.t + tk + 8 * j] =
            from_float<T>(fmaf(-resid[i], acc_p[i][j], acc[i][j]) * scale);
      if (tk == 0) delta_out[row0 + t] = dl[i] + resid[i];
    }
  }
}

// The bf16 dq kernel on the tensor cores: flash_bwd_dq_kernel's function, delta correction
// included, on the tile of attention_mma.cuh (see the note at the top). Warp w owns query rows
// 16 w .. 16 w + 15 of the block, held as A fragments of Q and dO; a thread holds rows g and g + 8
// (lane = 4 g + c) of each S and dP tile, against keys 8 n + 2 c, 8 n + 2 c + 1.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ stats, const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                        float* __restrict__ delta_out, int t_len, Strides qs, Strides ks,
                        Strides vs_, Strides dos, Strides dqs, float scale) {
  namespace mma = some_mma;
  using L = mma::Layout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const mma::Smem sm = mma::carve_smem<D>(mma_smem, t_len, 2);
  const int q0 = blockIdx.x * mma::kRows;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(blockIdx.z) * t_len : nullptr;

  mma::load_tile<D>(sm.q_tile, mma::head_slice(q, qs), qs.t, q0, t_len);
  mma::load_tile<D>(sm.v_tile, mma::head_slice(dout, dos), dos.t, q0, t_len);
  mma::cp_async_commit();
  // exact skipping: a key tile with no real key adds exactly 0 to dS K, to r and to the real keys'
  // P K (dS and P are taken as 0 at a masked key), so only tiles with a real key are walked; a
  // row with none walks no tile and keeps dq = 0 and its delta
  mma::TileFilter filter{nullptr, nullptr, false, true};
  if (mb != nullptr) {
    mma::tile_segments(sm, mb, t_len);
    filter = mma::TileFilter{sm.seg0, sm.seg1, false, true};
  }
  // the thread's two query rows: m, 1 / l and the caller's delta; past T all 0, never stored
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
  float m[2], inv_l[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + mma::thread_row(i);
    const bool valid = t < t_len;
    m[i] = valid ? stats[(row0 + t) * 2] : 0.0f;
    inv_l[i] = valid ? 1.0f / stats[(row0 + t) * 2 + 1] : 0.0f;
    dl[i] = valid ? delta[row0 + t] : 0.0f;
  }
  uint32_t qf[L::kKSteps][4], dof[L::kKSteps][4];
  mma::load_q_fragments<D>(qf, sm);
  mma::load_a_fragments<D>(dof, sm.v_tile);

  // o_ds = sum (dS scale) K with the caller's delta, o_pk = sum round(P) K and r = sum dS over the
  // real keys (this thread's columns), for the correction at the end
  float o_ds[L::kOutTiles][4] = {}, o_pk[L::kOutTiles][4] = {};
  float r[2] = {0.0f, 0.0f};
  mma::walk_tiles<D, true>(
      sm, filter, mma::head_slice(k, ks), ks.t, mma::head_slice(v, vs_), vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16* v_tile, uint64_t real) {
        float s[8][4], dp[8][4];
        masked_scores<D>(s, qf, k_tile, j, real, t_len, scale);  // S, the forward's arithmetic
        mma::score_tile<D>(dp, dof, v_tile);                      // dP = dO V^T, f32
        const uint32_t is_real = mma::thread_columns(real);
        // 16 keys a step: register 2 hh + i of a fragment holds row i's pair of tile 2 ks + hh
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t sf[2][4], pf[1][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int n = 2 * kstep + hh;
            const bool real0 = (is_real >> (2 * n)) & 1u, real1 = (is_real >> (2 * n + 1)) & 1u;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              // P as the training forward's pass 2 forms it, then 0 at a masked key
              float p0 = __fmul_rn(mma::exp_(__fsub_rn(s[n][2 * i], m[i])), inv_l[i]);
              float p1 = __fmul_rn(mma::exp_(__fsub_rn(s[n][2 * i + 1], m[i])), inv_l[i]);
              p0 = real0 ? p0 : 0.0f;
              p1 = real1 ? p1 : 0.0f;
              const float ds0 = p0 * (dp[n][2 * i] - dl[i]);
              const float ds1 = p1 * (dp[n][2 * i + 1] - dl[i]);
              r[i] += ds0;
              r[i] += ds1;
              mma::split_bf16(ds0 * scale, ds1 * scale, sf[0][2 * hh + i], sf[1][2 * hh + i]);
              pf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(p0, p1));
            }
          }
          // K is the B operand in V's layout: dQ += (dS scale) K as hi + lo, and round(P) K
          mma::pv_step2<D, 2, 1>(o_ds, sf, o_pk, pf, k_tile, kstep);
        }
      });

  // dq = scale (sum dS K - r sum P K): the dq of delta + r = rowsum(P dP) over the real keys
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = mma::quad_sum(r[i]);
    const float rs = -r[i] * scale;
#pragma unroll
    for (int n = 0; n < L::kOutTiles; ++n) {
      o_ds[n][2 * i] = fmaf(rs, o_pk[n][2 * i], o_ds[n][2 * i]);
      o_ds[n][2 * i + 1] = fmaf(rs, o_pk[n][2 * i + 1], o_ds[n][2 * i + 1]);
    }
  }
  mma::store_output<D>(mma::head_slice(dq, dqs), dqs.t, q0, t_len, o_ds, {1.0f, 1.0f});
  if ((threadIdx.x & 3) != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + mma::thread_row(i);
    if (t < t_len) delta_out[row0 + t] = dl[i] + r[i];
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *stats, *delta;
  const void* mask;
  void *dq, *dk, *dv;
  float* delta_out;
  int batch, heads, t_len;
  Strides qs, ks, vs_, dos, dqs, dks, dvs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    return some_mma::launch_grid(flash_bwd_dkv_mma_kernel<D>,
                                 some_mma::smem_bytes_kv<D>((a.t_len + kBK - 1) / kBK), a.batch,
                                 a.heads, a.t_len, a.stream, q, k, v, dout, a.stats, a.delta, mask,
                                 dk, dv, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks, a.dvs, a.scale);
  } else {
    const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t_len + kBK - 1) / kBK, a.heads, a.batch);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, a.stats, a.delta, mask, dk, dv, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks,
        a.dvs, a.scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  T* dq = static_cast<T*>(a.dq);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    return some_mma::launch_blocks<D, 2>(flash_bwd_dq_mma_kernel<D>, a.batch, a.heads, a.t_len,
                                         a.stream, q, k, v, dout, a.stats, a.delta, mask, dq,
                                         a.delta_out, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dqs,
                                         a.scale);
  } else {
    const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t_len + kBQ - 1) / kBQ, a.heads, a.batch);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, a.stats, a.delta, mask, dq, a.delta_out, a.t_len, a.qs, a.ks, a.vs_,
        a.dos, a.dqs, a.scale);
    return cudaGetLastError();
  }
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
// three contiguous. The dq kernel also writes delta_out (f32 [batch, heads, t_len], contiguous),
// the rowsum of P dP it found, for the dk/dv kernel that follows. head_dim is 32 or 64. Each
// launches on `stream` and returns cudaGetLastError() (0 on success); neither synchronises.
extern "C" int some_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* stats,
    const float* delta, const void* mask, void* dk, void* dv, int batch, int heads, int t_len,
    int head_dim, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dk_strides,
    const long long* dv_strides, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, stats, delta, mask, nullptr, dk, dv, nullptr, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), Strides{0, 0, 0}, strides_of(dk_strides),
         strides_of(dv_strides), scale, static_cast<cudaStream_t>(stream)};
  return backward(0, head_dim, dtype, a);
}

extern "C" int some_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* stats,
    const float* delta, const void* mask, void* dq, float* delta_out, int batch, int heads,
    int t_len, int head_dim, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dq_strides,
    float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, stats, delta, mask, dq, nullptr, nullptr, delta_out, batch, heads, t_len,
         strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
         strides_of(do_strides), strides_of(dq_strides), Strides{0, 0, 0}, Strides{0, 0, 0},
         scale, static_cast<cudaStream_t>(stream)};
  return backward(1, head_dim, dtype, a);
}
