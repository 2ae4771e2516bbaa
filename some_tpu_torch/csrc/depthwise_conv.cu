// Depthwise temporal convolution, forward and weight gradient: the conformer's k=31 'SAME' conv
// on Hopper.
//
// Replaces the Pallas TPU kernel some_tpu/ops/depthwise.py::_dw_kernel (launched by
// _pallas_depthwise_strided). It computes
//     y[b, t, c] = sum_{tap < K} x[b, t + tap - (K - 1) / 2, c] * w[tap, c]
// with zero padding in time, channels last, f32 accumulation and the output in x's dtype.
// The bias is added by the caller, as in the JAX package.
//
// Bound: device memory. Each output costs 2K flops against one element read and one written,
// far below the card's ratio of compute to bandwidth, so the least time is
// 2 * B * T * C * sizeof(dtype) / 3.35 TB/s.
//
// Design: a block covers 64 time rows x 256 channels of one batch row. It stages the
// (64 + K - 1)-row window of x in shared memory; the halo rows outside [0, T) and the channels
// past C are zero-filled there, so x is never padded in device memory and any T and C work.
// Each thread owns two channels with their K taps in registers and computes 8 output rows
// from 8 + K - 1 staged values held in registers, so a staged value is read from shared memory
// (8 + K - 1) / 8 times instead of K times.
//
// Every product and every sum is rounded on its own (no fused multiply-add), in tap order:
// that is the arithmetic of the plain PyTorch version in some_tpu_torch/ops/depthwise.py, so
// the two agree bit for bit. The input gradient is this same kernel on the output's cotangent
// with the taps flipped in time, as the JAX package's custom VJP does (depthwise.py:126).
//
// Weight gradient (some_depthwise_conv1d_dw), the XLA reduction of the JAX custom VJP
// (some_tpu/ops/depthwise.py:127-135):
//     dw[tap, c] = sum_{b, t} x[b, t + tap - (K - 1) / 2, c] * g[b, t, c]
// in f32, cast to the input dtype. Bound: device memory (2 K flops per element of x and g read).
// Pass 1: a block covers 128 time rows x 128 channels of one batch row, stages the
// (128 + K - 1)-row window of x in shared memory (zero halo, as the forward), and each thread
// keeps the K f32 partial sums of its channel in registers, walking its rows in order with the
// same 8-row register window as the forward; it writes them to a partials buffer
// [B * ceil(T / 128), K, C]. Pass 2 sums the partials of each (tap, channel) in a fixed order.
// No atomics, so two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 64;
constexpr int kChunkC = 256;
constexpr int kThreads = 128;
constexpr int kRows = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
depthwise_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     int t_len, int channels) {
  constexpr int kHalf = (K - 1) / 2;
  constexpr int kStaged = kTileT + K - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);

  const int t0 = blockIdx.x * kTileT;
  const int c0 = blockIdx.y * kChunkC;
  const size_t batch_offset = static_cast<size_t>(blockIdx.z) * t_len * channels;
  const T* xb = x + batch_offset;
  T* yb = y + batch_offset;

  for (int i = threadIdx.x; i < kStaged * kChunkC; i += kThreads) {
    const int t = t0 - kHalf + i / kChunkC;
    const int c = c0 + i % kChunkC;
    T value = from_float<T>(0.0f);
    if (t >= 0 && t < t_len && c < channels) value = xb[static_cast<size_t>(t) * channels + c];
    tile[i] = value;
  }
  __syncthreads();

#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int cc = threadIdx.x + part * kThreads;
    const int c = c0 + cc;
    if (c >= channels) continue;
    float taps[K];
#pragma unroll
    for (int k = 0; k < K; ++k) taps[k] = to_float(w[static_cast<size_t>(k) * channels + c]);
    for (int r0 = 0; r0 < kTileT && t0 + r0 < t_len; r0 += kRows) {
      float window[kRows + K - 1];
#pragma unroll
      for (int i = 0; i < kRows + K - 1; ++i) window[i] = to_float(tile[(r0 + i) * kChunkC + cc]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(window[r + k], taps[k]));
        const int t = t0 + r0 + r;
        if (t < t_len) yb[static_cast<size_t>(t) * channels + c] = from_float<T>(acc);
      }
    }
  }
}

constexpr int kTileDW = 128;
constexpr int kChunkDW = 128;

template <typename T, int K>
__global__ void __launch_bounds__(kChunkDW)
depthwise_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            float* __restrict__ partial, int t_len, int channels) {
  constexpr int kHalf = (K - 1) / 2;
  constexpr int kStaged = kTileDW + K - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);

  const int t0 = blockIdx.x * kTileDW;
  const int c0 = blockIdx.y * kChunkDW;
  const size_t batch_offset = static_cast<size_t>(blockIdx.z) * t_len * channels;
  const T* xb = x + batch_offset;
  const T* gb = g + batch_offset;

  for (int i = threadIdx.x; i < kStaged * kChunkDW; i += kChunkDW) {
    const int t = t0 - kHalf + i / kChunkDW;
    const int c = c0 + i % kChunkDW;
    T value = from_float<T>(0.0f);
    if (t >= 0 && t < t_len && c < channels) value = xb[static_cast<size_t>(t) * channels + c];
    tile[i] = value;
  }
  __syncthreads();

  const int cc = threadIdx.x;
  const int c = c0 + cc;
  if (c >= channels) return;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int r0 = 0; r0 < kTileDW && t0 + r0 < t_len; r0 += kRows) {
    float window[kRows + K - 1];
#pragma unroll
    for (int i = 0; i < kRows + K - 1; ++i) window[i] = to_float(tile[(r0 + i) * kChunkDW + cc]);
    float gv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r0 + r;
      gv[r] = t < t_len ? to_float(gb[static_cast<size_t>(t) * channels + c]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(window[r + k], gv[r], acc[k]);
  }
  const size_t part = static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x;
  float* out = partial + part * K * channels;
#pragma unroll
  for (int k = 0; k < K; ++k) out[static_cast<size_t>(k) * channels + c] = acc[k];
}

template <typename T>
__global__ void depthwise_dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                           int n_parts, int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float sum = 0.0f;
  for (int p = 0; p < n_parts; ++p) sum += partial[static_cast<size_t>(p) * n_out + i];
  dw[i] = from_float<T>(sum);
}

template <typename T, int K>
cudaError_t launch_dw(const void* x, const void* g, float* partial, void* dw, int batch,
                      int t_len, int channels, cudaStream_t stream) {
  const int smem = (kTileDW + K - 1) * kChunkDW * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(depthwise_dw_partial_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (t_len + kTileDW - 1) / kTileDW;
  const dim3 grid(n_tiles, (channels + kChunkDW - 1) / kChunkDW, batch);
  depthwise_dw_partial_kernel<T, K><<<grid, kChunkDW, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, t_len, channels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = K * channels;
  depthwise_dw_reduce_kernel<T><<<(n_out + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<T*>(dw), batch * n_tiles, n_out);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, void* y, int batch, int t_len, int channels,
                   cudaStream_t stream) {
  const int smem = (kTileT + K - 1) * kChunkC * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(depthwise_fwd_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kTileT - 1) / kTileT, (channels + kChunkC - 1) / kChunkC, batch);
  depthwise_fwd_kernel<T, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), t_len, channels);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_taps_dw(int taps, const void* x, const void* g, float* partial, void* dw,
                             int batch, int t_len, int channels, cudaStream_t stream) {
  switch (taps) {
#define SOME_DW_CASE(K) \
  case K:               \
    return launch_dw<T, K>(x, g, partial, dw, batch, t_len, channels, stream);
    SOME_DW_CASE(7) SOME_DW_CASE(31)
#undef SOME_DW_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_taps(int taps, const void* x, const void* w, void* y, int batch, int t_len,
                          int channels, cudaStream_t stream) {
  switch (taps) {
#define SOME_DW_CASE(K) \
  case K:               \
    return launch<T, K>(x, w, y, batch, t_len, channels, stream);
    SOME_DW_CASE(7) SOME_DW_CASE(31)
#undef SOME_DW_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [batch, t_len, channels] contiguous; w: [taps, channels] contiguous, all of one dtype
// (0 = float32, 1 = bfloat16). taps is 31 (every config's kernel_size) or 7. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int some_depthwise_conv1d_fwd(const void* x, const void* w, void* y, int batch,
                                         int t_len, int channels, int taps, int dtype,
                                         void* stream) {
  if (batch < 0 || t_len < 0 || channels < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || channels == 0) return cudaSuccess;
  if ((channels + kChunkC - 1) / kChunkC > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_taps<float>(taps, x, w, y, batch, t_len, channels, s);
  if (dtype == 1) return dispatch_taps<__nv_bfloat16>(taps, x, w, y, batch, t_len, channels, s);
  return cudaErrorInvalidValue;
}

// The weight gradient. x, g: [batch, t_len, channels] contiguous, of one dtype (0 = float32,
// 1 = bfloat16); dw: [taps, channels] of that dtype; partial: f32 scratch of
// batch * ceil(t_len / 128) * taps * channels elements. taps is 31 or 7. Launches two kernels
// on `stream` and returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int some_depthwise_conv1d_dw(const void* x, const void* g, float* partial, void* dw,
                                        int batch, int t_len, int channels, int taps, int dtype,
                                        void* stream) {
  if (batch < 0 || t_len < 0 || channels < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || channels == 0) return cudaErrorInvalidValue;
  if ((channels + kChunkDW - 1) / kChunkDW > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_taps_dw<float>(taps, x, g, partial, dw, batch, t_len, channels, s);
  if (dtype == 1)
    return dispatch_taps_dw<__nv_bfloat16>(taps, x, g, partial, dw, batch, t_len, channels, s);
  return cudaErrorInvalidValue;
}
