// Depthwise temporal convolution, forward (and input gradient) and weight gradient: the
// conformer's k=31 'SAME' conv on Hopper.
//
// Replaces the Pallas TPU kernel some_tpu/ops/depthwise.py::_dw_kernel (launched by
// _pallas_depthwise_strided). It computes
//     y[b, t, c] = sum_{tap < K} x[b, t + tap - (K - 1) / 2, c] * w[tap, c]
// with zero padding in time, channels last, f32 accumulation and the output in x's dtype.
// The bias is added by the caller, as in the JAX package. The input gradient is the same
// kernel on the output's cotangent with the taps read in reverse order (the `flip` argument),
// as the JAX package's custom VJP does with w[::-1] (depthwise.py:126), without a copy of w.
//
// Bound: each output costs 2K flops against one element read and one written, so device
// memory gives 2 * B * T * C * sizeof(dtype) / 3.35 TB/s. But every product and every sum is
// rounded on its own (no fused multiply-add), in tap order: that is the arithmetic of the
// plain PyTorch version in some_tpu_torch/ops/depthwise.py, so the two agree bit for bit. It
// costs two FP32 instructions a tap and output, an instruction floor of 2 K B T C over
// 132 SMs x 128 lanes, which at K = 31 lies above the bytes bound and is the real limit.
//
// Design (the Pallas kernel's block t / block t+1 pipeline as a loop inside a block):
// - A block owns 64 channels of one batch row (two adjacent channels a lane, one warp across)
//   and walks a span of successive time tiles (16 rows a warp: 128-row tiles of 8 warps in
//   bf16, 64-row tiles of 4 warps in f32). The launch picks the span so that the grid fills
//   every SM to its occupancy at any (B, T); the arithmetic does not depend on it.
// - x crosses from device memory once, in 16-byte cp.async pieces, into a ring of four
//   stages in shared memory: staged tile j holds x rows [L j + H, L (j + 1) + H) of the span
//   (L the tile's rows, H = (K - 1) / 2), so output tile j reads the last 2H rows of stage
//   j - 1 (its halo, kept from the previous step) and stage j. Two stages are in flight while
//   a tile is computed; rows outside [0, T) and channels past C are zero-filled in the ring,
//   so x is never padded in device memory. A piece that is not 16-byte aligned (odd C, a view
//   at an odd offset) or that crosses C is copied element by element, masked, in the same
//   loop.
// - The taps sit in shared memory as f32 (reversed for dx). Each warp computes 16 rows x 2
//   channels: 32 independent sums; at tap k it reads one new staged row as one 4-byte
//   bf16x2 (or 8-byte float2) word, bank-conflict free, and the taps' pair. The tap loop is
//   unrolled whole; what bounds it on the card is the issue rate of the separate FMUL and
//   FADD whose multiplier (the lane's tap) is a register, not device memory.
// - Outputs go out as one bf16x2 (float2) store a lane and row, 128 (256) contiguous bytes
//   a warp; masked at C and where the row is not aligned.
//
// Weight gradient (some_depthwise_conv1d_dw), the XLA reduction of the JAX custom VJP
// (some_tpu/ops/depthwise.py:127-135):
//     dw[tap, c] = sum_{b, t} x[b, t + tap - (K - 1) / 2, c] * g[b, t, c]
// in f32, cast to the input dtype. Bound: device memory (K fused multiply-adds per element of
// x and g read). Pass 1 stages x exactly as the forward (32-row tiles) and g in a second
// ring, one commit group for both; each lane keeps the K f32 sums of its two channels in
// registers for the whole span (8 rows a warp and tile); the four warps' sums are added in a
// fixed order in shared memory and the block writes one partial [K, 64] to a buffer
// [parts, K, C] of a few MB, which fits in L2. Pass 2 (the reduce kernel, 64 outputs x 4 partial groups a
// block, K * C / 64 blocks) sums the partials in a fixed order. No atomic adds, so two runs give
// the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 64;          // channels of one block: two a lane of a warp
constexpr int kSlots = 4;           // stages of the ring (a power of two)
constexpr int kAhead = kSlots - 2;  // stages in flight while a tile is computed
constexpr int kRowsFwd = 16;        // output rows a warp and tile (forward)
constexpr int kWarpsDw = 4;
constexpr int kRowsDw = 8;          // rows a warp and tile (weight gradient)
constexpr int kTileDw = kWarpsDw * kRowsDw;

// Warps of a forward block: 8 in bf16 (128-row tiles, 3 blocks of 72 KB an SM), 4 in f32,
// whose rows are twice as wide (64-row tiles, 3 blocks an SM).
template <typename T> __host__ __device__ constexpr int fwd_warps() {
  return sizeof(T) == 2 ? 8 : 4;
}
template <typename T> __host__ __device__ constexpr int fwd_tile() {
  return fwd_warps<T>() * kRowsFwd;
}
constexpr int kReduceOut = 64;     // outputs of one reduce block
constexpr int kReduceGroups = 4;   // partial groups of one reduce block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The two channels of lane `lane` in a staged row, as f32.
__device__ __forceinline__ float2 load_pair(const float* row, int lane) {
  return reinterpret_cast<const float2*>(row)[lane];
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int lane) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[lane]);
}

// Channels c and c + 1 of one output row: one 4-byte (bf16) or 8-byte (f32) store where both
// exist and the address allows it, else one masked store each.
__device__ __forceinline__ void store_pair(float* row, int c, int channels, float a, float b) {
  float* p = row + c;
  if (c + 1 < channels && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (c < channels) p[0] = a;
    if (c + 1 < channels) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int channels, float a,
                                           float b) {
  __nv_bfloat16* p = row + c;
  if (c + 1 < channels && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (c < channels) p[0] = __float2bfloat16_rn(a);
    if (c + 1 < channels) p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [t0, t0 + n_rows) of one batch row's 64-channel chunk into the ring, starting at
// ring row `ring_row0` (modulo kRing): 16-byte cp.async pieces where a piece is inside C and
// aligned, element by element otherwise, zeros outside [0, T) and past C.
template <typename T, int kRing>
__device__ __forceinline__ void stage_rows(T* ring, int ring_row0, const T* src, int t0,
                                           int n_rows, int t_len, int channels, int c0) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements of a piece
  constexpr int kPieces = kChunk / kPer;                   // pieces of a row
  for (int i = threadIdx.x; i < n_rows * kPieces; i += blockDim.x) {
    const int r = i / kPieces;
    const int c = c0 + (i % kPieces) * kPer;
    const int t = t0 + r;
    T* dst = ring + ((ring_row0 + r) & (kRing - 1)) * kChunk + (c - c0);
    if (t < 0 || t >= t_len || c >= channels) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* piece = src + static_cast<size_t>(t) * channels + c;
    if (c + kPer <= channels && (reinterpret_cast<uintptr_t>(piece) & 15) == 0) {
      cp_async_16(dst, piece);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[e] = c + e < channels ? piece[e] : from_float<T>(0.0f);
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * fwd_warps<T>(), 16 / fwd_warps<T>())
depthwise_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     int t_len, int channels, int tiles_per_span, int flip) {
  constexpr int kHalf = (K - 1) / 2;
  constexpr int kTile = fwd_tile<T>();
  constexpr int kRows = kRowsFwd;
  constexpr int kRing = kSlots * kTile;
  static_assert(kTile >= 2 * kHalf, "a stage must hold the next tile's halo");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* taps = reinterpret_cast<float*>(smem_raw + kRing * kChunk * sizeof(T));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kChunk;
  const int tile0 = blockIdx.x * tiles_per_span;
  const int n_tiles = min(tiles_per_span, (t_len + kTile - 1) / kTile - tile0);
  const size_t batch_offset = static_cast<size_t>(blockIdx.z) * t_len * channels;
  const T* xb = x + batch_offset;
  T* yb = y + batch_offset;
  // x row of ring row 0: staged tile j sits at ring row (j + 1) * kTile
  const int base = tile0 * kTile + kHalf - kTile;

  for (int i = threadIdx.x; i < K * kChunk; i += blockDim.x) {
    const int k = i / kChunk;
    const int c = c0 + i % kChunk;
    const int tap = flip ? K - 1 - k : k;
    taps[i] = c < channels ? to_float(w[static_cast<size_t>(tap) * channels + c]) : 0.0f;
  }
  // the halo of tile 0 (the last 2H rows of stage -1), then stages 0 .. kAhead - 1
  stage_rows<T, kRing>(ring, kTile - 2 * kHalf, xb, base + kTile - 2 * kHalf, 2 * kHalf, t_len,
                       channels, c0);
  cp_async_commit();
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_tiles)
      stage_rows<T, kRing>(ring, (j + 1) * kTile, xb, base + (j + 1) * kTile, kTile, t_len,
                           channels, c0);
    cp_async_commit();
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // stage j is in (later ones may still be in flight)
    __syncthreads();  // ... for every thread, and tile j - 1 is done with stage j - 2
    if (j + kAhead < n_tiles)
      stage_rows<T, kRing>(ring, (j + kAhead + 1) * kTile, xb, base + (j + kAhead + 1) * kTile,
                           kTile, t_len, channels, c0);
    cp_async_commit();

    const int o0 = (tile0 + j) * kTile + warp * kRows;
    if (o0 >= t_len) continue;
    const int q = (j + 1) * kTile - 2 * kHalf + warp * kRows;  // ring row of x row o0 - H
    float acc0[kRows], acc1[kRows];
    float2 xv[kRows + K - 1];  // the staged rows o0 - H ..., one new row a tap
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0.0f;
#pragma unroll
    for (int m = 0; m < kRows - 1; ++m)
      xv[m] = load_pair(ring + ((q + m) & (kRing - 1)) * kChunk, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xv[k + kRows - 1] = load_pair(ring + ((q + k + kRows - 1) & (kRing - 1)) * kChunk, lane);
      const float2 wk = reinterpret_cast<const float2*>(taps + k * kChunk)[lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc0[r] = __fadd_rn(acc0[r], __fmul_rn(xv[r + k].x, wk.x));
        acc1[r] = __fadd_rn(acc1[r], __fmul_rn(xv[r + k].y, wk.y));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (o0 + r < t_len)
        store_pair(yb + static_cast<size_t>(o0 + r) * channels, c0 + 2 * lane, channels, acc0[r],
                   acc1[r]);
  }
}

// One warp's rows of one tile into the K sums of its lane's two channels; kFull: all kRowsDw
// rows lie inside T (else only the first `valid`: a row past T adds nothing, not 0 * x).
template <int K, bool kFull, typename T, int kRing>
__device__ __forceinline__ void dw_accumulate(const T* ring_x, int q, const float2 (&gv)[kRowsDw],
                                              int valid, int lane, float (&acc0)[K],
                                              float (&acc1)[K]) {
  constexpr int kRows = kRowsDw;
  float2 xv[kRows + K - 1];
#pragma unroll
  for (int m = 0; m < kRows - 1; ++m)
    xv[m] = load_pair(ring_x + ((q + m) & (kRing - 1)) * kChunk, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xv[k + kRows - 1] = load_pair(ring_x + ((q + k + kRows - 1) & (kRing - 1)) * kChunk, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kFull || r < valid) {
        acc0[k] = fmaf(xv[r + k].x, gv[r].x, acc0[k]);
        acc1[k] = fmaf(xv[r + k].y, gv[r].y, acc1[k]);
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * kWarpsDw, 4)
depthwise_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            float* __restrict__ partial, int t_len, int channels,
                            int tiles_per_span) {
  constexpr int kHalf = (K - 1) / 2;
  constexpr int kTile = kTileDw;
  constexpr int kRows = kRowsDw;
  constexpr int kRing = kSlots * kTile;
  static_assert(kTile >= 2 * kHalf, "a stage must hold the next tile's halo");
  static_assert(kWarpsDw * K * kChunk * sizeof(float) <= 2 * kRing * kChunk * sizeof(T),
                "the warps' sums are added in the rings' memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring_x = reinterpret_cast<T*>(smem_raw);
  T* ring_g = ring_x + kRing * kChunk;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kChunk;
  const int tile0 = blockIdx.x * tiles_per_span;
  const int n_tiles = min(tiles_per_span, (t_len + kTile - 1) / kTile - tile0);
  const size_t batch_offset = static_cast<size_t>(blockIdx.z) * t_len * channels;
  const T* xb = x + batch_offset;
  const T* gb = g + batch_offset;
  const int base = tile0 * kTile + kHalf - kTile;

  // stage j: x rows [base + (j + 1) kTile, + kTile) and g rows of tile j, one commit group
  auto stage = [&](int j) {
    stage_rows<T, kRing>(ring_x, (j + 1) * kTile, xb, base + (j + 1) * kTile, kTile, t_len,
                         channels, c0);
    stage_rows<T, kRing>(ring_g, j * kTile, gb, (tile0 + j) * kTile, kTile, t_len, channels, c0);
  };
  stage_rows<T, kRing>(ring_x, kTile - 2 * kHalf, xb, base + kTile - 2 * kHalf, 2 * kHalf, t_len,
                       channels, c0);
  cp_async_commit();
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }

  float acc0[K], acc1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc0[k] = acc1[k] = 0.0f;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (j + kAhead < n_tiles) stage(j + kAhead);
    cp_async_commit();

    const int o0 = (tile0 + j) * kTile + warp * kRows;
    if (o0 >= t_len) continue;
    const int q = (j + 1) * kTile - 2 * kHalf + warp * kRows;
    const T* g_rows = ring_g + (((j & (kSlots - 1)) * kTile + warp * kRows) * kChunk);
    float2 gv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) gv[r] = load_pair(g_rows + r * kChunk, lane);
    const int valid = t_len - o0;
    if (valid >= kRows)
      dw_accumulate<K, true, T, kRing>(ring_x, q, gv, valid, lane, acc0, acc1);
    else
      dw_accumulate<K, false, T, kRing>(ring_x, q, gv, valid, lane, acc0, acc1);
  }

  // the four warps' sums in a fixed order, then one partial [K, 64] for the block
  cp_async_wait<0>();
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int k = 0; k < K; ++k)
    reinterpret_cast<float2*>(sums + (warp * K + k) * kChunk)[lane] = make_float2(acc0[k], acc1[k]);
  __syncthreads();
  const size_t part = static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x;
  float* out = partial + part * K * channels;
  for (int i = threadIdx.x; i < K * kChunk; i += blockDim.x) {
    const int k = i / kChunk;
    const int c = c0 + i % kChunk;
    if (c >= channels) continue;
    float s = sums[i];
#pragma unroll
    for (int w = 1; w < kWarpsDw; ++w) s += sums[w * K * kChunk + i];
    out[static_cast<size_t>(k) * channels + c] = s;
  }
}

// dw[i] for 64 outputs i = tap * C + c a block: group g of four sums partials g, g + 4, ...
// in order, then ((s0 + s1) + s2) + s3.
template <typename T>
__global__ void __launch_bounds__(kReduceOut * kReduceGroups)
depthwise_dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int n_parts,
                           int n_out) {
  __shared__ float sums[kReduceGroups][kReduceOut];
  const int o = threadIdx.x % kReduceOut;
  const int group = threadIdx.x / kReduceOut;
  const int i = blockIdx.x * kReduceOut + o;
  float s = 0.0f;
  if (i < n_out) {
#pragma unroll 4
    for (int p = group; p < n_parts; p += kReduceGroups)
      s += partial[static_cast<size_t>(p) * n_out + i];
  }
  sums[group][o] = s;
  __syncthreads();
  if (group == 0 && i < n_out) {
    float total = sums[0][o];
#pragma unroll
    for (int k = 1; k < kReduceGroups; ++k) total += sums[k][o];
    dw[i] = from_float<T>(total);
  }
}

template <typename T, int K> constexpr int fwd_smem() {
  return kSlots * fwd_tile<T>() * kChunk * static_cast<int>(sizeof(T)) + K * kChunk * 4;
}
template <typename T> constexpr int dw_smem() {
  return 2 * kSlots * kTileDw * kChunk * static_cast<int>(sizeof(T));
}

// Blocks of one kernel instance that fill every SM of the current device to its occupancy.
// Found on the instance's first launch on a device, which also raises its shared-memory
// limit, and kept: later launches read it without a CUDA call beyond cudaGetDevice.
constexpr int kMaxDevices = 64;
struct Residency {
  std::atomic<int> blocks[kMaxDevices];  // 0: not found yet on that device
};

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, Residency* cache, int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = cache->blocks[device].load(std::memory_order_relaxed);
  if (blocks == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0, occupancy = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (occupancy < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * occupancy;
    cache->blocks[device].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return cudaSuccess;
}

// Spans of one (batch row, channel chunk): as many as give the grid `resident` blocks, at
// most one a tile; `per` tiles a span.
struct Plan {
  int spans;
  int per;
};

Plan plan(int resident, int tile, int batch, int t_len, int chunks) {
  const long long tiles = (t_len + tile - 1) / tile;
  const long long columns = static_cast<long long>(batch) * chunks;
  long long spans = (resident + columns - 1) / columns;
  spans = spans < 1 ? 1 : (spans > tiles ? tiles : spans);
  const long long per = (tiles + spans - 1) / spans;
  return {static_cast<int>((tiles + per - 1) / per), static_cast<int>(per)};
}

int chunks_of(int channels) { return (channels + kChunk - 1) / kChunk; }

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, void* y, int batch, int t_len, int channels,
                   int flip, cudaStream_t stream) {
  constexpr int smem = fwd_smem<T, K>();
  static Residency cache;
  int resident = 0;
  cudaError_t err =
      resident_blocks(depthwise_fwd_kernel<T, K>, 32 * fwd_warps<T>(), smem, &cache, &resident);
  if (err != cudaSuccess) return err;
  const Plan p = plan(resident, fwd_tile<T>(), batch, t_len, chunks_of(channels));
  const dim3 grid(p.spans, chunks_of(channels), batch);
  depthwise_fwd_kernel<T, K><<<grid, 32 * fwd_warps<T>(), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), t_len, channels,
      p.per, flip);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dw_plan(int batch, int t_len, int channels, Plan* p) {
  static Residency cache;
  int resident = 0;
  cudaError_t err = resident_blocks(depthwise_dw_partial_kernel<T, K>, 32 * kWarpsDw,
                                    dw_smem<T>(), &cache, &resident);
  if (err != cudaSuccess) return err;
  *p = plan(resident, kTileDw, batch, t_len, chunks_of(channels));
  return cudaSuccess;
}

template <typename T, int K>
cudaError_t launch_dw(const void* x, const void* g, float* partial, void* dw, int batch,
                      int t_len, int channels, int n_parts, cudaStream_t stream) {
  Plan p;
  cudaError_t err = dw_plan<T, K>(batch, t_len, channels, &p);
  if (err != cudaSuccess) return err;
  if (n_parts != batch * p.spans) return cudaErrorInvalidValue;
  const dim3 grid(p.spans, chunks_of(channels), batch);
  depthwise_dw_partial_kernel<T, K><<<grid, 32 * kWarpsDw, dw_smem<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, t_len, channels, p.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = K * channels;
  depthwise_dw_reduce_kernel<T><<<(n_out + kReduceOut - 1) / kReduceOut,
                                  kReduceOut * kReduceGroups, 0, stream>>>(
      partial, static_cast<T*>(dw), n_parts, n_out);
  return cudaGetLastError();
}

int check_shape(int batch, int t_len, int channels) {
  if (batch < 0 || t_len < 0 || channels < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (chunks_of(channels) > 65535) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// CALL(T, K) for the dtype code (0 = float32, 1 = bfloat16) and tap count the kernels are built
// for; cudaErrorInvalidValue for any other.
#define SOME_DW_DISPATCH(dtype, taps, CALL)                           \
  do {                                                                \
    if ((dtype) == 0 && (taps) == 7) return CALL(float, 7);           \
    if ((dtype) == 0 && (taps) == 31) return CALL(float, 31);         \
    if ((dtype) == 1 && (taps) == 7) return CALL(__nv_bfloat16, 7);   \
    if ((dtype) == 1 && (taps) == 31) return CALL(__nv_bfloat16, 31); \
    return cudaErrorInvalidValue;                                     \
  } while (0)

cudaError_t dw_parts(int dtype, int taps, int batch, int t_len, int channels, Plan* p) {
#define SOME_DW_PLAN(T, K) dw_plan<T, K>(batch, t_len, channels, p)
  SOME_DW_DISPATCH(dtype, taps, SOME_DW_PLAN);
#undef SOME_DW_PLAN
}

}  // namespace

// x, y: [batch, t_len, channels] contiguous; w: [taps, channels] contiguous, all of one dtype
// (0 = float32, 1 = bfloat16). taps is 31 (every config's kernel_size) or 7. flip != 0 reads
// the taps in reverse order (the input gradient). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int some_depthwise_conv1d_fwd(const void* x, const void* w, void* y, int batch,
                                         int t_len, int channels, int taps, int dtype, int flip,
                                         void* stream) {
  if (int err = check_shape(batch, t_len, channels)) return err;
  if (batch == 0 || t_len == 0 || channels == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOME_DW_FWD(T, K) launch<T, K>(x, w, y, batch, t_len, channels, flip, s)
  SOME_DW_DISPATCH(dtype, taps, SOME_DW_FWD);
#undef SOME_DW_FWD
}

// How many partials [taps, channels] of f32 some_depthwise_conv1d_dw writes for this shape on
// the current device (the blocks of its first pass); minus a CUDA error code on failure.
extern "C" int some_depthwise_conv1d_dw_parts(int batch, int t_len, int channels, int taps,
                                              int dtype) {
  if (int err = check_shape(batch, t_len, channels)) return -err;
  if (batch == 0 || t_len == 0 || channels == 0) return -cudaErrorInvalidValue;
  Plan p;
  if (cudaError_t err = dw_parts(dtype, taps, batch, t_len, channels, &p)) return -err;
  return batch * p.spans;
}

// The weight gradient. x, g: [batch, t_len, channels] contiguous, of one dtype (0 = float32,
// 1 = bfloat16); dw: [taps, channels] of that dtype; partial: f32 scratch of
// n_parts * taps * channels elements, n_parts from some_depthwise_conv1d_dw_parts. taps is 31
// or 7. Launches two kernels on `stream` and returns cudaGetLastError() (0 on success); it does
// not synchronise.
extern "C" int some_depthwise_conv1d_dw(const void* x, const void* g, float* partial, void* dw,
                                        int batch, int t_len, int channels, int taps, int dtype,
                                        int n_parts, void* stream) {
  if (int err = check_shape(batch, t_len, channels)) return err;
  if (batch == 0 || t_len == 0 || channels == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOME_DW_BWD(T, K) launch_dw<T, K>(x, g, partial, dw, batch, t_len, channels, n_parts, s)
  SOME_DW_DISPATCH(dtype, taps, SOME_DW_BWD);
#undef SOME_DW_BWD
}
