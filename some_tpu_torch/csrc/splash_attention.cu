// Splash attention, forward, non-causal, with segment ids: attention_impl 'splash' on Hopper.
//
// Replaces the Pallas TPU kernel that some_tpu/ops/attention.py::_splash_attention_bhtd runs:
// flash_attention_kernel of jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py (pallas_call at :1137), with its log-sum-exp residual (:842) for
// training. For q (pre-scaled by the caller, in its dtype), k, v of shape [B, H, T, D]:
//     out = softmax(where(seg_q == seg_k, q k^T, -0.7 * FLT_MAX)) v
// with splash's arithmetic: f32 scores, an online softmax over key tiles whose P stays f32 in the
// product with v (v upcast), the output multiplied once by 1 / l at the end and cast to the input
// dtype, and on request lse = log(l) + m per query row in f32. Segments: splash_common.cuh.
//
// Bound: operations once T is long (4 * B * H * T^2 * D flops against 4 * B * H * T * D
// elements moved). f32 inputs stay in true f32 (no TF32) on the CUDA cores; bf16 inputs go to
// splash_fwd_mma_kernel on the tensor cores (below).
//
// f32 design: the flash inference kernel's (flash_attention.cu): a block owns 64 queries of one
// (batch, head) and 128 threads, keeps Q^T in shared memory and walks the keys in tiles of 64,
// staging K^T, V and the keys' segment codes; each thread holds a 4 x 8 block of the score tile
// and a 4 x D/8 block of the output in f32 registers with the running max and sum. Any T: keys
// past T score -inf and drop out, queries past T are computed and not stored. Inputs are read and
// the output written through their strides, so all may be [B, H, T, D] views of [B, T, H, D]
// storage.
//
// bf16 design: the same single pass on the tensor-core tile of attention_mma.cuh. P stays f32 in
// P.V, as splash keeps it: each p is split into hi (p cut to bf16) and lo = bf16(p - hi), and two
// mma.sync into one f32 accumulator multiply both with v, within about 2^-16 |p| of the f32
// product, where rounding P to bf16 alone would change the semantics. A key tile is skipped when
// no key of it shares a segment with a query of the block: its contributions would be multiplied
// by an alpha that is exactly 0, or are exp(mask value - m) = 0. With and without lse it is one
// template, so the two outputs stay bit for bit equal. The training forward also stores out_lo,
// what rounding the output to bf16 left of its f32 value, rounded to bf16: the backward's di =
// rowsum(O * dO) takes O = out + out_lo, to about 2^-16 (splash_attention_bwd.cu says why).
#include <type_traits>

#include "attention_mma.cuh"
#include "launch_counts.cuh"
#include "splash_common.cuh"

// variant dtype
SOME_LAUNCH_COUNTS(splash_attention, "splash_fwd_kernel", "splash_fwd_mma_kernel")

namespace {

using namespace some_splash;

constexpr int kQStride = kVecStride;  // rows of Q^T and P^T: 16-byte aligned for float4 access
constexpr int kKStride = kOddStride;  // rows of K^T: odd, so the transposing stores spread over banks

template <int D>
constexpr int smem_floats() {
  return D * kQStride + D * kKStride + kBK * D + kBK * kQStride + kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                  int t_len, Strides qs, Strides ks, Strides vs_, Strides os) {
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kQStride]  Q^T
  float* kt = qt + D * kQStride;         // [D][kKStride]  K^T
  float* vt = kt + D * kKStride;         // [kBK][D]       V
  float* pt = vt + kBK * D;              // [kBK][kQStride] P^T
  int* key_code = reinterpret_cast<int*>(pt + kBK * kQStride);  // segment, or kPastT

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

  stage_transposed<T, D>(qt, kQStride, qb, qs.t, q0, t_len);
  int q_seg[4];
  float m[4], l[4], acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q_seg[i] = segment_of(mb, q0 + 4 * tq + i, t_len);
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles = (t_len + kBK - 1) / kBK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of K, V and P are done
    stage_transposed<T, D>(kt, kKStride, kb, ks.t, k0, t_len);
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      vt[r * D + d] = t < t_len ? to_float(vb[t * vs_.t + d]) : 0.0f;
    }
    stage_segment_codes(key_code, mb, k0, t_len);
    __syncthreads();

    float s[4][8] = {};
    tile_dot<D>(qt, 4 * tq, kt, tk, s);
    float tile_max[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = key_code[tk + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = splash_score(s[i][j], code, q_seg[i]);
        tile_max[i] = fmaxf(tile_max[i], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the 8 threads that share a query row are adjacent lanes of one warp
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], offset));
      // every tile holds a key below T, so m_new is finite (the mask value at worst, until a key
      // of the query's own segment arrives and alpha = 0 drops what came before)
      const float m_new = fmaxf(m[i], tile_max[i]);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile, where m[i] is -inf
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kDT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        l[i] += p;
        s[i][j] = p;  // f32 into P.V, as splash keeps it
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

  const size_t row0 = (static_cast<size_t>(b) * gridDim.y + h) * t_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int offset = 1; offset < 8; offset <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], offset);
    const int t = q0 + 4 * tq + i;
    if (t < t_len) {
      const float inv_l = 1.0f / l[i];
#pragma unroll
      for (int j = 0; j < kDT; ++j) ob[t * os.t + tk + 8 * j] = from_float<T>(acc[i][j] * inv_l);
      if (lse != nullptr && tk == 0) lse[row0 + t] = logf(l[i]) + m[i];
    }
  }
}

// The bf16 forward on the tensor cores: splash_fwd_kernel's arithmetic (see the note at the top)
// on the tile of attention_mma.cuh. Warp w owns query rows 16 w .. 16 w + 15; a thread holds rows
// g and g + 8 (lane = 4 g + c) of each score and output tile.
template <int D>
__global__ void __launch_bounds__(some_mma::kThreads)
splash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      __nv_bfloat16* __restrict__ out_lo, int t_len, Strides qs, Strides ks,
                      Strides vs_, Strides os) {
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
  // walk the tiles holding a key of a segment that a query of this block (tile blockIdx.x) has
  mma::TileFilter filter{nullptr, nullptr, false, true};
  if (mb != nullptr) {
    mma::tile_segments(sm, mb, t_len);
    const uint32_t bit = 1u << (blockIdx.x & 31);
    filter = mma::TileFilter{sm.seg0, sm.seg1, (sm.seg0[blockIdx.x >> 5] & bit) != 0u,
                             (sm.seg1[blockIdx.x >> 5] & bit) != 0u};
  }
  const int q_seg[2] = {segment_of(mb, q0 + mma::thread_row(0), t_len),
                        segment_of(mb, q0 + mma::thread_row(1), t_len)};
  uint32_t qf[L::kKSteps][4];
  mma::load_q_fragments<D>(qf, sm);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[L::kOutTiles][4] = {};
  mma::walk_tiles<D, true>(
      sm, filter, kb, ks.t, vb, vs_.t, mb, t_len,
      [&](int j, const bf16* k_tile, const bf16* v_tile, uint64_t real) {
        float s[8][4];
        mma::score_tile<D>(s, qf, k_tile);
        // the scores stay as they are where every key is real and both rows are real queries
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
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tile_max = -INFINITY;
#pragma unroll
          for (int n = 0; n < 8; ++n) tile_max = fmaxf(tile_max, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
          // finite: a walked tile holds a key below T (the mask value at worst, until a key of
          // the query's own segment arrives and alpha = 0 drops what came before)
          const float m_new = fmaxf(m[i], mma::quad_max(tile_max));
          const float alpha = mma::exp_(m[i] - m_new);  // 0 on the first tile, where m is -inf
          m[i] = m_new;
          l[i] *= alpha;
#pragma unroll
          for (int n = 0; n < L::kOutTiles; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
          }
        }
        // P f32 into P.V, as splash keeps it: p = hi + lo, two bf16 A fragments, 16 keys a step;
        // register 2 hh + i holds row i's pair of score tile 2 kstep + hh
#pragma unroll
        for (int kstep = 0; kstep < 4; ++kstep) {
          uint32_t pf[2][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float* x = s[2 * kstep + hh] + 2 * i;
              const float p0 = mma::exp_(__fsub_rn(x[0], m[i]));
              const float p1 = mma::exp_(__fsub_rn(x[1], m[i]));
              l[i] += p0;
              l[i] += p1;
              mma::split_bf16(p0, p1, pf[0][2 * hh + i], pf[1][2 * hh + i]);
            }
          mma::pv_step<D, 2>(o, pf, v_tile, kstep);
        }
      });

  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = mma::quad_sum(l[i]);
    inv_l[i] = 1.0f / l[i];
  }
  mma::store_output<D>(mma::head_slice(out, os), os.t, q0, t_len, o, inv_l);
  if (out_lo != nullptr)
    mma::store_output<D, true>(mma::head_slice(out_lo, os), os.t, q0, t_len, o, inv_l);
  if (lse == nullptr || (threadIdx.x & 3) != 0) return;
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * t_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + mma::thread_row(i);
    if (t < t_len) lse[row0 + t] = logf(l[i]) + m[i];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, void* out_lo, int batch, int heads, int t_len, Strides qs,
                   Strides ks, Strides vs_, Strides os, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    return some_mma::launch_blocks<D>(splash_fwd_mma_kernel<D>, batch, heads, t_len, stream, qp,
                                      kp, vp, mp, op, lse, static_cast<T*>(out_lo), t_len, qs, ks,
                                      vs_, os);
  } else {
    if (out_lo != nullptr) return cudaErrorInvalidValue;  // an f32 output is exact already
    const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        splash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_len + kBQ - 1) / kBQ, heads, batch);
    splash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(qp, kp, vp, mp, op, lse, t_len, qs,
                                                             ks, vs_, os);
    return cudaGetLastError();
  }
}

}  // namespace

// q (pre-scaled), k, v, out: [batch, heads, t_len, head_dim] of one dtype (0 = float32,
// 1 = bfloat16), the last dimension contiguous, the others given as element strides {batch, head,
// time}. mask: [batch, t_len] bytes (a frame's segment: 1 real, 0 padding), contiguous, or null
// for one segment. lse: f32 [batch, heads, t_len] contiguous, or null for the inference forward.
// out_lo: bf16 only, null or a tensor with out's strides that gets what rounding the output to
// bf16 left of each value, rounded to bf16 (the backward's di = rowsum((out + out_lo) * dout)).
// head_dim is 32 or 64. Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int some_splash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, float* lse, void* out_lo,
                                         int batch, int heads, int t_len, int head_dim,
                                         const long long* q_strides, const long long* k_strides,
                                         const long long* v_strides, const long long* o_strides,
                                         int dtype, void* stream) {
  if (batch < 0 || heads < 0 || t_len < 0 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || heads == 0 || t_len == 0) return cudaSuccess;
  const Strides qs = strides_of(q_strides), ks = strides_of(k_strides);
  const Strides vs_ = strides_of(v_strides), os = strides_of(o_strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return some_counts::counted(0, launch<float, 64>(q, k, v, mask, out, lse, out_lo, batch,
                                                     heads, t_len, qs, ks, vs_, os, s));
  if (dtype == 0 && head_dim == 32)
    return some_counts::counted(0, launch<float, 32>(q, k, v, mask, out, lse, out_lo, batch,
                                                     heads, t_len, qs, ks, vs_, os, s));
  if (dtype == 1 && head_dim == 64)
    return some_counts::counted(1, launch<__nv_bfloat16, 64>(q, k, v, mask, out, lse, out_lo,
                                                             batch, heads, t_len, qs, ks, vs_,
                                                             os, s));
  if (dtype == 1 && head_dim == 32)
    return some_counts::counted(1, launch<__nv_bfloat16, 32>(q, k, v, mask, out, lse, out_lo,
                                                             batch, heads, t_len, qs, ks, vs_,
                                                             os, s));
  return cudaErrorInvalidValue;
}
