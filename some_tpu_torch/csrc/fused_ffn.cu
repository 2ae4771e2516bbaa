// Fused LayerNorm -> FFN -> scaled residual, the conformer's macaron FFN at inference, on Hopper.
//
// Replaces the Pallas TPU kernel some_tpu/ops/fused_ffn.py::_ffn_kernel (pallas_call at :65),
// which the JAX conformer runs for both macaron FFNs of every block when fuse_ffn is on and the
// model is deterministic. For rows x of width D, hidden width H = 4 D:
//     ln  = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * gamma + beta          (f32)
//     h   = SiLU(round(ln) W1 + b1)                                              (f32 sums)
//     out = round((round(h) W2 + b2) * res_scale + x)
// where round() is a rounding to the input dtype, the products take W1 and W2 in the input dtype,
// and every sum, bias, SiLU and the residual are f32: the JAX kernel's arithmetic step for step.
//
// Bound: operations (4 N D H flops against about 2 N D elements of activations and 2 D H weights
// moved). This first version does both products as f32 FMAs on the CUDA cores, in both dtypes (no
// tensor cores, no TF32), so it runs far from the bf16 tensor-core bound.
//
// Design: a block owns 32 rows and 256 threads (8 warps). Each warp takes the LayerNorm of 4 rows
// (f32 statistics by warp shuffles) and writes them, rounded to the dtype, into shared memory,
// where they stay for the whole block. The block then walks the hidden columns in chunks of 128:
//   * h = ln W1[:, chunk]: W1 in slices of 32 inputs x 128 columns through shared memory; each
//     thread holds 4 rows x 4 columns of the chunk in registers; + b1, SiLU, rounded to the dtype
//     into a [32 x 128] tile in shared memory;
//   * y += h W2[chunk, :]: W2 in slices of 8 hidden rows x D through shared memory; each thread
//     holds 4 rows x D/32 columns of y in f32 registers for the whole kernel.
// Both sums run in ascending order over their inputs. The weights are read in their [out, in]
// storage (torch's Linear layout), 2 MiB in bf16 at D = 512, which every block rereads from L2.
// The [N, H] hidden activations never reach device memory. Any N: rows past N are zeros and are not
// stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;      // rows per block
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 4 w .. 4 w + 3
constexpr int kChunk = 128;    // hidden columns per chunk: lane l owns columns l + 32 j
constexpr int kSlice1 = 32;    // inputs per W1 slice
constexpr int kSlice2 = 8;     // hidden rows per W2 slice
constexpr int kW1Stride = kChunk + 1;  // odd: the transposing stores spread over the banks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <int D>
constexpr int smem_floats() {
  // the rows' LayerNorm, the hidden tile, and one weight slice (W1's and W2's share the space)
  return kRows * D + kRows * kChunk +
         (kSlice1 * kW1Stride > kSlice2 * (D + 1) ? kSlice1 * kW1Stride : kSlice2 * (D + 1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_ffn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ w1t,
                 const float* __restrict__ b1, const T* __restrict__ w2t,
                 const float* __restrict__ b2, T* __restrict__ out, int n_rows, int hidden,
                 float eps, float res_scale) {
  constexpr int kPerLane = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* ln = smem;                    // [kRows][D]      round(LayerNorm(x))
  float* hs = ln + kRows * D;          // [kRows][kChunk] round(SiLU(h))
  float* ws = hs + kRows * kChunk;     // W1 slice [kSlice1][kW1Stride] or W2 slice [kSlice2][D+1]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  // LayerNorm: f32 statistics, the variance as mean((x - mean)^2)
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * warp + i;
    const long long row = row0 + r;
    float vals[kPerLane];
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      vals[c] = row < n_rows ? to_float(x[row * D + lane + 32 * c]) : 0.0f;
      sum += vals[c];
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const float d = __fsub_rn(vals[c], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rstd = rsqrtf(__fadd_rn(warp_sum(sq) / D, eps));
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int col = lane + 32 * c;
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(vals[c], mean), rstd), gamma[col]),
                                beta[col]);
      ln[r * D + col] = row < n_rows ? round_to<T>(y) : 0.0f;
    }
  }

  float y[4][kPerLane];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) y[i][c] = 0.0f;

  for (int c0 = 0; c0 < hidden; c0 += kChunk) {
    // h[rows, chunk] = ln W1[:, chunk], W1 read as w1t[hidden][D]
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += kSlice1) {
      __syncthreads();  // ln is written (first pass) and the previous slice's reads are done
      for (int e = threadIdx.x; e < kSlice1 * kChunk; e += kThreads) {
        const int d = e % kSlice1, j = e / kSlice1;
        ws[d * kW1Stride + j] = to_float(w1t[static_cast<long long>(c0 + j) * D + d0 + d]);
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlice1; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ln[(4 * warp + i) * D + d0 + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[d * kW1Stride + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      const float bias = b1[c0 + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = __fadd_rn(acc[i][j], bias);
        const float silu = __fmul_rn(h, 1.0f / __fadd_rn(1.0f, expf(-h)));
        hs[(4 * warp + i) * kChunk + col] = round_to<T>(silu);
      }
    }

    // y[rows, :] += h W2[chunk, :], W2 read as w2t[D][hidden]
    for (int j0 = 0; j0 < kChunk; j0 += kSlice2) {
      __syncthreads();  // hs is written and the previous slice's reads (W1's too) are done
      for (int e = threadIdx.x; e < kSlice2 * D; e += kThreads) {
        const int j = e % kSlice2, c = e / kSlice2;
        ws[j * (D + 1) + c] = to_float(w2t[static_cast<long long>(c) * hidden + c0 + j0 + j]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kSlice2; ++j) {
        float hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = hs[(4 * warp + i) * kChunk + j0 + j];
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) {
          const float w = ws[j * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i][c] = fmaf(hv[i], w, y[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + 4 * warp + i;
    if (row < n_rows) {
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        const int col = lane + 32 * c;
        const float r = __fmul_rn(__fadd_rn(y[i][c], b2[col]), res_scale);
        out[row * D + col] = from_float<T>(__fadd_rn(r, to_float(x[row * D + col])));
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const void* w1t,
                   const float* b1, const void* w2t, const float* b2, void* out, int n_rows,
                   int hidden, float eps, float res_scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rows + kRows - 1) / kRows;
  fused_ffn_kernel<T, D><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1t), b1,
      static_cast<const T*>(w2t), b2, static_cast<T*>(out), n_rows, hidden, eps, res_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(int dim, const void* x, const float* gamma, const float* beta,
                           const void* w1t, const float* b1, const void* w2t, const float* b2,
                           void* out, int n_rows, int hidden, float eps, float res_scale,
                           cudaStream_t stream) {
  if (dim == 512)
    return launch<T, 512>(x, gamma, beta, w1t, b1, w2t, b2, out, n_rows, hidden, eps, res_scale,
                          stream);
  if (dim == 64)
    return launch<T, 64>(x, gamma, beta, w1t, b1, w2t, b2, out, n_rows, hidden, eps, res_scale,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: [n_rows, dim] contiguous, of one dtype (0 = float32, 1 = bfloat16); w1t: [hidden, dim]
// and w2t: [dim, hidden] contiguous in that dtype (torch's Linear weights, [out, in]); gamma, beta,
// b2: f32 [dim]; b1: f32 [hidden]. (dim, hidden) is (512, 2048) or (64, 256). Launches on `stream`
// and returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int some_fused_ln_ffn_residual(const void* x, const float* gamma, const float* beta,
                                          const void* w1t, const float* b1, const void* w2t,
                                          const float* b2, void* out, int n_rows, int dim,
                                          int hidden, float eps, float res_scale, int dtype,
                                          void* stream) {
  if (n_rows < 0 || hidden != 4 * dim || hidden % kChunk != 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_width<float>(dim, x, gamma, beta, w1t, b1, w2t, b2, out, n_rows, hidden, eps,
                                 res_scale, s);
  if (dtype == 1)
    return dispatch_width<__nv_bfloat16>(dim, x, gamma, beta, w1t, b1, w2t, b2, out, n_rows,
                                         hidden, eps, res_scale, s);
  return cudaErrorInvalidValue;
}
