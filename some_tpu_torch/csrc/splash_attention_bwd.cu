// Splash attention, backward: the gradients of attention_impl 'splash' on Hopper.
//
// Replaces the Pallas TPU kernels JAX's splash attention runs under jax.grad for
// some_tpu/ops/attention.py::_splash_attention_bhtd (jax/experimental/pallas/ops/tpu/
// splash_attention/splash_attention_kernel.py): _flash_attention_dkv_kernel (:1669, pallas_call
// :2196) and _flash_attention_dq_kernel (:1307, pallas_call :1635; splash runs it as a kernel of
// its own, use_fused_bwd_kernel being false). With q pre-scaled, P = exp(score - lse) rebuilt from
// the forward's f32 log-sum-exp and scores (splash_common.cuh), dO the output's cotangent and
// di = rowsum(O * dO) (computed by the caller, as JAX computes it in XLA, :2285, but with O the
// bf16 output plus the rounding residual the training forward stores beside it; below):
//     dV = round(P)^T dO                 (P rounded to dO's dtype, :1788)
//     dP = dO V^T,  dS = (dP - di) * P    (f32)
//     dK = round(dS)^T q,  dQ = round(dS) K   (dS rounded to the input dtype, :1804, :1395)
// with f32 sums and the gradients cast to the input dtype. dQ is the gradient of the pre-scaled q;
// the caller's autograd carries it through the pre-scale. A key in another segment has P exactly
// 0 (exp of the mask value minus a real log-sum-exp underflows), so its dS is exactly 0 and no
// gradient crosses segments.
//
// Why di takes the residual: JAX's di has O rounded to bf16, an error of about 2^-9 that moves
// every dS = (dP - di) P of the row before dS is rounded to bf16. A rounding that lands on the
// other side of a bf16 step differs by a whole bf16 ulp of dS, and such flips over the keys of a
// row took the bf16 dq and dk past 2 ulp + 0.02 RMS of splash's function in f32 (the f32
// reference of tests/test_torch_kernels_gpu.py). Correcting di afterwards, as K2's dq kernel does
// (flash_attention_bwd.cu), fixes dk but not dq: the flips have happened (PERF.md). With O to
// about 2^-16 the flips are rare enough.
//
// Bound: operations (the five T x T x D products below against 8 * T * D elements moved per
// (batch, head)). f32 does its products as f32 FMAs on the CUDA cores (no TF32), with f32
// accumulators; the bf16 dk/dv and dq kernels run on the tensor cores (below).
//
// Design: the flash backward kernels' (flash_attention_bwd.cu), with the same tiles and no
// atomics, so two runs give the same bits.
//   * dkv: a block owns 64 keys of one (batch, head), keeps its dK and dV rows in registers, and
//     walks the query tiles. In f32 (splash_bwd_dkv_kernel) K^T and V^T stay in shared memory,
//     each query tile's Q^T, dO^T and (lse, di, segment) are staged, and each thread holds 4 keys
//     x 8 queries of the S^T and dP^T tiles. In bf16 (splash_bwd_dkv_mma_kernel) it is the tile of
//     attention_mma.cuh with the sides swapped, as K2's dk/dv kernel: K and V are A fragments
//     (warp w owns keys 16 w .. 16 w + 15), the ring carries qs and dO with each query tile's
//     (lse, di) beside them, and the queries' segments come from the walk's mask bits. S^T =
//     K qs^T sums the products of the forward's S = qs K^T in the same k16 steps, then
//     splash_score and P = exp(s - lse); round(P^T) packed in pairs is the A fragment of
//     dV += P^T dO; dS^T = (dP^T - di) P^T with dP^T = V dO^T in f32, rounded to bf16 once as
//     splash rounds it, is the A fragment of dK += dS^T qs. A query tile with no query of a
//     segment the block's keys have adds exactly 0 (P = 0 across segments) and is skipped, as the
//     forward skips key tiles: real keys never walk padded query tiles, and the reverse.
//   * dq: a block owns 64 queries, keeps its dQ rows in registers, and walks the key tiles. In
//     f32 (splash_bwd_dq_kernel) Q^T and dO^T stay in shared memory and each thread holds 4
//     queries x 8 keys. In bf16 (splash_bwd_dq_mma_kernel) it is K2's dq tile with splash's
//     scores: qs and dO are A fragments (warp w owns queries 16 w .. 16 w + 15), the ring carries
//     K and V, and each row reads its lse, di and segment once. S = qs K^T sums the same products
//     in the same k16 steps as the forward's S and the dk/dv kernel's S^T, and splash_score and
//     P = exp(s - lse) are the dk/dv kernel's, so its P and dS are the transposes of what dk/dv
//     forms, bit for bit. dS = (dP - di) P with dP = dO V^T in f32, rounded to bf16 once, is
//     the A fragment of dQ += dS K, K the B operand in V's layout: three products a tile, no
//     hi + lo and no correction (di is exact already, above). Key tiles with no key of a
//     segment the block's queries have add exactly 0 and are skipped, as the forward skips them.
// In the f32 kernels a query past T gets lse = +inf, in the bf16 dk/dv kernel a score of -inf, so
// its P is 0; the bf16 dq kernel never stores a query past T. Inputs are read, and dQ, dK, dV
// written, through their strides, so all may be [B, H, T, D] views of [B, T, H, D] storage; the
// bf16 kernels copy rows with cp.async, so their wrappers raise on rows that are not 16-byte
// aligned.
#include <type_traits>

#include "attention_mma.cuh"
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

// The bf16 dk/dv kernel on the tensor cores: splash_bwd_dkv_kernel's function on the tile of
// attention_mma.cuh with the sides swapped (see the note at the top). Warp w owns keys
// 16 w .. 16 w + 15 of the block, held as A fragments of K and V; a thread holds keys g and g + 8
// (lane = 4 g + c) of each S^T and dP^T tile, against queries 8 n + 2 c, 8 n + 2 c + 1.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
splash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, const uint8_t* __restrict__ mask,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int t_len, Strides qs, Strides ks, Strides vs_, Strides dos,
                          Strides dks, Strides dvs) {
  namespace mma = some_mma;
  using L = mma::Layout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const mma::Smem sm = mma::carve_smem_kv<D>(mma_smem, t_len);
  const int k0 = blockIdx.x * mma::kRows;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(blockIdx.z) * t_len : nullptr;

  mma::load_tile<D>(sm.q_tile, mma::head_slice(k, ks), ks.t, k0, t_len);
  mma::load_tile<D>(sm.v_tile, mma::head_slice(v, vs_), vs_.t, k0, t_len);
  mma::cp_async_commit();
  // exact skipping: walk the query tiles that hold a query of a segment a key of this block has;
  // in any other, every (query, key) pair is across segments, P = exp(mask value - lse) is exactly
  // 0 and so is dS. The block's own tile is always walked.
  mma::TileFilter filter{nullptr, nullptr, false, true};
  if (mb != nullptr) {
    mma::tile_segments(sm, mb, t_len);
    const uint32_t bit = 1u << (blockIdx.x & 31);
    filter = mma::TileFilter{sm.seg0, sm.seg1, (sm.seg0[blockIdx.x >> 5] & bit) != 0u,
                             (sm.seg1[blockIdx.x >> 5] & bit) != 0u};
  }
  // the codes of the thread's two keys: the key's segment, or kPastT
  int code[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + mma::thread_row(i);
    code[i] = key >= t_len ? kPastT : segment_of(mb, key, t_len);
  }
  const bool all_real_keys = code[0] == 1 && code[1] == 1;
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
  mma::cp_async_wait_all();
  __syncthreads();
  uint32_t kf[L::kKSteps][4], vf[L::kKSteps][4];
  mma::load_a_fragments<D>(kf, sm.q_tile);
  mma::load_a_fragments<D>(vf, sm.v_tile);

  // lse and di of a walked query tile go to the ring slot of its Q and dO copies (zeros past T,
  // where P is set to 0); the query's segment comes from the walk's mask bits
  float* const lse_ring = sm.row_vals;
  float* const di_ring = sm.row_vals + 2 * mma::kRows;
  auto stage_rows = [&](int j, int buf) {
    const int r = threadIdx.x & (mma::kRows - 1);
    const int tq = j * mma::kRows + r;
    const bool valid = tq < t_len;
    const size_t at = row0 + (valid ? tq : 0);
    if (threadIdx.x < mma::kRows)
      mma::cp_async_4(lse_ring + buf * mma::kRows + r, lse + at, valid);
    else
      mma::cp_async_4(di_ring + buf * mma::kRows + r, di + at, valid);
  };

  float o_dk[L::kOutTiles][4] = {}, o_dv[L::kOutTiles][4] = {};
  const int c = threadIdx.x & 3;
  mma::walk_tiles<D, true>(
      sm, filter, mma::head_slice(q, qs), qs.t, mma::head_slice(dout, dos), dos.t, mb, t_len,
      [&](int j, const bf16* q_tile, const bf16* do_tile, uint64_t real) {
        const int buf = static_cast<int>(q_tile - sm.k_ring) / L::kTile;
        float s[8][4], dp[8][4];
        mma::score_tile<D>(s, kf, q_tile);    // S^T: the warp's 16 keys x the tile's 64 queries
        mma::score_tile<D>(dp, vf, do_tile);  // dP^T, f32
        // splash's scores: a query past T or in another segment than the key, and a key past T,
        // score as splash_score says; nothing to do where every key and query is real
        if (!(real == ~0ull && all_real_keys)) {
          const uint32_t segment = mma::thread_columns(real);
          const uint32_t below_t = mma::thread_columns(mma::below_t_bits(j * mma::kRows, t_len));
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int bit = 2 * n + (e & 1);
              s[n][e] = ((below_t >> bit) & 1u)
                            ? splash_score(s[n][e], code[e >> 1],
                                           static_cast<int>((segment >> bit) & 1u))
                            : -INFINITY;
            }
        }
        const float* lse_t = lse_ring + buf * mma::kRows;
        const float* di_t = di_ring + buf * mma::kRows;
        // 16 queries a step: register 2 hh + i of a fragment holds key i's pair of tile 2 ks + hh
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t pf[1][4], sf[1][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int n = 2 * kstep + hh, col = 8 * n + 2 * c;
            const float lse0 = lse_t[col], lse1 = lse_t[col + 1];
            const float di0 = di_t[col], di1 = di_t[col + 1];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float p0 = mma::exp_(__fsub_rn(s[n][2 * i], lse0));
              const float p1 = mma::exp_(__fsub_rn(s[n][2 * i + 1], lse1));
              pf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(p0, p1));
              // dS = (dP - di) P in f32, rounded to bf16 once, as splash rounds it
              sf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(
                  __fmul_rn(__fsub_rn(dp[n][2 * i], di0), p0),
                  __fmul_rn(__fsub_rn(dp[n][2 * i + 1], di1), p1)));
            }
          }
          mma::pv_step<D, 1>(o_dv, pf, do_tile, kstep);  // dV += round(P)^T dO
          mma::pv_step<D, 1>(o_dk, sf, q_tile, kstep);   // dK += round(dS)^T qs
        }
      },
      stage_rows);

  mma::store_output<D>(mma::head_slice(dk, dks), dks.t, k0, t_len, o_dk, {1.0f, 1.0f});
  mma::store_output<D>(mma::head_slice(dv, dvs), dvs.t, k0, t_len, o_dv, {1.0f, 1.0f});
}

// The bf16 dq kernel on the tensor cores: splash_bwd_dq_kernel's function on the tile of
// attention_mma.cuh (see the note at the top). Warp w owns query rows 16 w .. 16 w + 15 of the
// block, held as A fragments of qs and dO; a thread holds rows g and g + 8 (lane = 4 g + c) of
// each S and dP tile, against keys 8 n + 2 c, 8 n + 2 c + 1.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
splash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ dq, int t_len, Strides qs, Strides ks,
                         Strides vs_, Strides dos, Strides dqs) {
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
  // exact skipping, as the forward: walk the key tiles that hold a key of a segment a query of
  // this block has; in any other, every (query, key) pair is across segments, P is exactly 0 and
  // so is dS
  mma::TileFilter filter{nullptr, nullptr, false, true};
  if (mb != nullptr) {
    mma::tile_segments(sm, mb, t_len);
    const uint32_t bit = 1u << (blockIdx.x & 31);
    filter = mma::TileFilter{sm.seg0, sm.seg1, (sm.seg0[blockIdx.x >> 5] & bit) != 0u,
                             (sm.seg1[blockIdx.x >> 5] & bit) != 0u};
  }
  // the thread's two query rows: segment, lse and di, read once; past T never stored
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
  int q_seg[2];
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + mma::thread_row(i);
    const bool valid = t < t_len;
    q_seg[i] = segment_of(mb, t, t_len);
    row_lse[i] = valid ? lse[row0 + t] : 0.0f;
    row_di[i] = valid ? di[row0 + t] : 0.0f;
  }
  uint32_t qf[L::kKSteps][4], dof[L::kKSteps][4];
  mma::load_q_fragments<D>(qf, sm);
  mma::load_a_fragments<D>(dof, sm.v_tile);

  float o_dq[L::kOutTiles][4] = {};
  mma::walk_tiles<D, true>(
      sm, filter, mma::head_slice(k, ks), ks.t, mma::head_slice(v, vs_), vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16* v_tile, uint64_t real) {
        float s[8][4], dp[8][4];
        mma::score_tile<D>(s, qf, k_tile);    // S: the forward's sums, the dk/dv kernel's S^T
        mma::score_tile<D>(dp, dof, v_tile);  // dP = dO V^T, f32
        // splash's scores, as the forward and the dk/dv kernel give them
        if (!(real == ~0ull && q_seg[0] == 1 && q_seg[1] == 1)) {
          const uint32_t segment = mma::thread_columns(real);
          const uint32_t below_t = mma::thread_columns(mma::below_t_bits(j * mma::kRows, t_len));
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int bit = 2 * n + (e & 1);
              s[n][e] = splash_score(
                  s[n][e], ((below_t >> bit) & 1u) ? static_cast<int>((segment >> bit) & 1u) : kPastT,
                  q_seg[e >> 1]);
            }
        }
        // 16 keys a step: register 2 hh + i of a fragment holds row i's pair of tile 2 ks + hh
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t sf[1][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int n = 2 * kstep + hh;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float p0 = mma::exp_(__fsub_rn(s[n][2 * i], row_lse[i]));
              const float p1 = mma::exp_(__fsub_rn(s[n][2 * i + 1], row_lse[i]));
              // dS = (dP - di) P in f32, rounded to bf16 once, as splash rounds it
              sf[0][2 * hh + i] = mma::pack_bf16(__floats2bfloat162_rn(
                  __fmul_rn(__fsub_rn(dp[n][2 * i], row_di[i]), p0),
                  __fmul_rn(__fsub_rn(dp[n][2 * i + 1], row_di[i]), p1)));
            }
          }
          mma::pv_step<D, 1>(o_dq, sf, k_tile, kstep);  // dQ += round(dS) K, K in V's layout
        }
      });

  mma::store_output<D>(mma::head_slice(dq, dqs), dqs.t, q0, t_len, o_dq, {1.0f, 1.0f});
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
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    return some_mma::launch_grid(splash_bwd_dkv_mma_kernel<D>,
                                 some_mma::smem_bytes_kv<D>((a.t_len + kBK - 1) / kBK), a.batch,
                                 a.heads, a.t_len, a.stream, q, k, v, dout, a.lse, a.di, mask, dk,
                                 dv, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks, a.dvs);
  } else {
    const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(splash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t_len + kBK - 1) / kBK, a.heads, a.batch);
    splash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, mask, dk, dv, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dks,
        a.dvs);
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
    return some_mma::launch_blocks<D, 2>(splash_bwd_dq_mma_kernel<D>, a.batch, a.heads, a.t_len,
                                         a.stream, q, k, v, dout, a.lse, a.di, mask, dq, a.t_len,
                                         a.qs, a.ks, a.vs_, a.dos, a.dqs);
  } else {
    const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(splash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t_len + kBQ - 1) / kBQ, a.heads, a.batch);
    splash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, mask, dq, a.t_len, a.qs, a.ks, a.vs_, a.dos, a.dqs);
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
