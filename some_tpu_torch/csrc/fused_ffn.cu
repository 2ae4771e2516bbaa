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
// The weights are read in their [out, in] storage (torch's Linear layout): w1t [H, D], w2t [D, H].
// The [N, H] hidden activations never reach device memory. Any N: rows past N are zeros and are
// not stored.
//
// Bound: operations (4 N D H flops against about 2 N D elements of activations and 2 D H weights
// moved). Two kernels, the dtype picks one:
//   * f32 (fused_ffn_kernel): both products as f32 FMAs on the CUDA cores (true f32, no TF32). A
//     block owns 32 rows and 256 threads; each warp takes the LayerNorm of 4 rows into shared
//     memory, then the block walks the hidden columns in chunks of 128: h = ln W1[:, chunk] with
//     W1 in slices of 32 inputs x 128 columns through shared memory (each thread 4 rows x 4
//     columns), + b1, SiLU, into a [32 x 128] tile; y += h W2[chunk, :] with W2 in slices of 8
//     hidden rows x D (each thread 4 rows x D/32 columns of y, in registers for the whole kernel).
//   * bf16 (fused_ffn_mma_kernel): both products on the tensor cores with Hopper's wgmma (bf16
//     operands, f32 sums), both operands read by the tensor cores from shared memory, every tile
//     loaded by TMA. A block owns 64 rows and two warpgroups. TMA brings its rows of x (zeros past
//     N), and each warp takes the LayerNorm of 8 of them in place: f32 statistics, round(ln) to
//     bf16, the A operand of product 1. The block then walks the hidden columns in chunks of 128:
//       - product 1, h[64 x 128] = ln W1[chunk]^T over D: warpgroup g takes hidden columns
//         64 g .. 64 g + 63 (m64n64k16, 32 f32 a thread); then + b1, SiLU in f32, rounded to
//         bf16 into a [64 x 128] tile, the A operand of product 2, which both warpgroups read;
//       - product 2, y[64 x D] += h W2[:, chunk]^T: warpgroup g takes output columns
//         g D / 2 .. (g + 1) D / 2 - 1, 128 at a time (m64n128k16; 128 f32 a thread at D = 512,
//         in registers for the whole kernel).
//     Both weights are already B operands as wgmma reads them, K-major: [out, in] with the
//     reduction dimension contiguous. Each warpgroup streams its own part of them (its 64 rows of
//     W1, its D / 2 rows of W2) through its own ring of two 32 KB slices (W1: 64 hidden rows x
//     256 inputs; W2: 128 output rows x the chunk's 128 inputs): one thread of it loads a slice
//     with TMA onto an mbarrier, the warpgroup waits on that barrier and multiplies, and the
//     thread refills the buffer as soon as the warpgroup's products of it have completed. Neither
//     warpgroup waits for the other except at the hidden tile, so one's products fill the tensor
//     cores while the other waits. Two slices of 32 KB ran faster than four of 16 KB (three in
//     flight): what was short was the work a slice gives, not the depth. Every tile is in the
//     128-byte swizzle that both TMA and wgmma speak, so the LayerNorm and the hidden tile's
//     stores also run without bank conflicts.
//     Shared memory: the LayerNorm tile 64 KB, the hidden tile 16 KB and the two rings, 208 KB at
//     D = 512: one block per SM. Every block reads all 4 MiB of bf16 weights (D = 512) from L2:
//     512 MiB at N = 8192 (128 blocks on 132 SMs). 128-row blocks would halve that, but product
//     2 would need 256 f32 accumulators a thread, so the block stays at 64 rows. A version on
//     mma.sync (ldmatrix fragments, 8 warps, cp.async) was slower: each warp reloaded the A and
//     B fragments it shares with others (256 bytes of shared memory a product in the first
//     product), and with two warps a scheduler the loads were not hidden. TMA needs 16-byte
//     aligned rows, so the wrapper raises on bf16 rows that are not.
#include <cuda.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kRows = 32;      // rows per block
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 4 w .. 4 w + 3
constexpr int kChunk = 128;    // hidden columns per chunk: lane l owns columns l + 32 j
constexpr int kSlice1 = 32;    // inputs per W1 slice
constexpr int kSlice2 = 8;     // hidden rows per W2 slice
constexpr int kW1Stride = kChunk + 1;  // odd: the transposing stores spread over the banks

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

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

// ---- the bf16 kernel on the tensor cores ----

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // rows per block
constexpr int kThreads = 256;    // two warpgroups
constexpr int kChunk = 128;      // hidden columns per chunk
constexpr int kRing = 2;         // weight slices of each warpgroup in shared memory at once
constexpr int kK1Max = 256;      // inputs of a W1 slice (all D when D is smaller)
constexpr int kK2 = 128;         // hidden inputs of a W2 slice: the whole chunk
constexpr int kN2Max = 128;      // output columns of a product-2 step
constexpr int kBlockK = 64;      // inputs of a TMA box: 128 bytes, the swizzle's span

// The operands' shared-memory layout, wgmma's K-major one with the 128-byte swizzle, which is also
// what a TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of R rows x K bf16 is stored as
// K / 64 blocks of R rows x 64 inputs, a row of a block in 128 contiguous bytes whose eight
// 16-byte pieces are permuted by the row's index mod 8 (piece p at p ^ (r & 7)). Eight rows of a
// block (1 KB, 1 KB aligned) are one swizzle atom. Element (r, k) of a tile R rows tall sits at
// this offset.
template <int R>
__device__ __forceinline__ int swizzled(int r, int k) {
  return (k >> 6) * R * 64 + r * 64 + ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// The descriptor of a swizzled tile: the start address (the tensor cores apply the swizzle from
// the address bits), atoms of 8 rows 1024 bytes apart (stride byte offset), 128-byte swizzle.
__device__ __forceinline__ uint64_t descriptor(const bf16* tile) {
  const uint32_t addr = some_mma::smem_u32(tile);
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The descriptor of the 16 inputs from k (a multiple of 16) of a tile R rows tall: the start
// address moves by whole 64-input blocks and, within one, by 32 bytes (unswizzled).
template <int R>
__device__ __forceinline__ uint64_t at_input(uint64_t desc, int k) {
  return desc + static_cast<uint64_t>(((k >> 6) * R * 128 + (k & 63) * 2) >> 4);
}

template <int D>
struct Shape {
  static constexpr int kCols2 = D / 2;                   // product 2: columns of a warpgroup
  static constexpr int kN2 = kCols2 < kN2Max ? kCols2 : kN2Max;  // ... kN2 at a time
  static constexpr int kPieces2 = kCols2 / kN2;
  static constexpr int kK1 = D < kK1Max ? D : kK1Max;    // inputs of a W1 slice
  static constexpr int kSlices1 = D / kK1;               // a warpgroup's W1 slices a chunk
  static constexpr int kSlices2 = kChunk / kK2 * kPieces2;  // ... and W2 slices
  static constexpr int kSlicesPerChunk = kSlices1 + kSlices2;
  static constexpr int kSlices = 4 * D / kChunk * kSlicesPerChunk;  // a warpgroup's, in all
  static constexpr int kBytes1 = 64 * kK1 * 2;           // a W1 slice: 64 hidden rows x kK1
  static constexpr int kBytes2 = kN2 * kK2 * 2;          // a W2 slice: kN2 output rows x kK2
  static constexpr int kSlice = (kBytes1 > kBytes2 ? kBytes1 : kBytes2) / 2;  // bf16
  static constexpr int kSmemBytes =
      (kRows * D + kRows * kChunk + 2 * kRing * kSlice) * static_cast<int>(sizeof(bf16)) +
      (1 + 2 * kRing) * static_cast<int>(sizeof(uint64_t));
};

// ---- mbarriers, TMA, named barriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(some_mma::smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Arrives and sets the bytes the barrier's phase also waits for (the loads of one slice).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   some_mma::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of this parity has completed. A phase that never completes
// would hang the card, so after about ten seconds the kernel traps instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(some_mma::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// One TMA box of the 2-D tensor map into shared memory, completing on `bar`: inputs from k and
// rows from r (the map's inner and outer coordinates).
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap& map, int k, int r,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(some_mma::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(k), "r"(r), "r"(some_mma::smem_u32(bar))
      : "memory");
}

// Synchronises `threads` threads (both warpgroups, or one) on named barrier `id` (0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Makes this thread's shared-memory stores visible to the tensor cores' reads (the async proxy);
// a barrier after it publishes them to the other warpgroup.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until this warpgroup's committed products have completed.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving an accumulator across the asynchronous products.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B^T for a 64 x 32 tile over 16 inputs: A, B from shared memory (descriptors)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B^T for a 64 x 64 tile over 16 inputs: A, B from shared memory (descriptors)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B^T for a 64 x 128 tile over 16 inputs: A, B from shared memory (descriptors)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 128) wgmma_n128(d, a, b);
  else if constexpr (N == 64) wgmma_n64(d, a, b);
  else wgmma_n32(d, a, b);
}

}  // namespace tc

// The bf16 kernel on the tensor cores (see the note at the top). Warpgroup g (warps 4 g ..
// 4 g + 3) multiplies with wgmma, both operands read from shared memory by the tensor cores;
// warpgroup 2 loads with TMA. A warpgroup's accumulators hold, as mma.sync's do, rows 16 w + q and
// 16 w + q + 8 of its warp w (lane = 4 q + c) at columns 8 j + 2 c, 8 j + 2 c + 1 of each
// 8-column group j: registers 4 j .. 4 j + 3.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
fused_ffn_mma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w1_map,
                     const __grid_constant__ CUtensorMap w2_map,
                     const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ b1,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int n_rows,
                     float eps, float res_scale) {
  using S = tc::Shape<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char ffn_smem[];
  bf16* const ln = reinterpret_cast<bf16*>(ffn_smem);  // [64 x D]: x, then round(LN(x))
  bf16* const hs = ln + tc::kRows * D;                  // [64 x 128]: round(SiLU(h)) of a chunk
  bf16* const ring = hs + tc::kRows * tc::kChunk;       // warpgroup g's slices at g kRing ..
  uint64_t* const x_full = reinterpret_cast<uint64_t*>(ring + 2 * tc::kRing * S::kSlice);
  uint64_t* const full = x_full + 1;  // [2][kRing]: a warpgroup's slice has landed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, q = lane >> 2, c = lane & 3;
  const int row_w = 16 * (warp & 3) + q;  // the thread's first accumulator row
  const bool leader = (threadIdx.x & 127) == 0;  // loads its warpgroup's slices
  const long long row0 = static_cast<long long>(blockIdx.x) * tc::kRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * tc::kRing; ++i) tc::mbar_init(x_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each warpgroup has its own ring of kRing slices; its leader loads slice v into buffer
  // v % kRing with TMA, the first kRing at once, then slice u + kRing as soon as the warpgroup's
  // products of slice u have completed.
  auto issue = [&](int v) {
    if (v >= S::kSlices) return;
    const int chunk = v / S::kSlicesPerChunk, s = v % S::kSlicesPerChunk;
    const int b = wg * tc::kRing + v % tc::kRing;
    bf16* const dst = ring + b * S::kSlice;
    if (s < S::kSlices1) {  // W1: the chunk's hidden rows 64 g .., inputs s kK1 ..
      tc::mbar_expect(full + b, S::kBytes1);
      for (int j = 0; j < S::kK1 / tc::kBlockK; ++j)
        tc::tma_load(dst + j * 64 * tc::kBlockK, w1_map, s * S::kK1 + j * tc::kBlockK,
                     chunk * tc::kChunk + 64 * wg, full + b);
    } else {  // W2: output rows g D / 2 + kN2 p .., the chunk's hidden inputs kK2 kb ..
      const int t = s - S::kSlices1, kb = t / S::kPieces2, piece = t % S::kPieces2;
      tc::mbar_expect(full + b, S::kBytes2);
      for (int j = 0; j < tc::kK2 / tc::kBlockK; ++j)
        tc::tma_load(dst + j * S::kN2 * tc::kBlockK, w2_map,
                     chunk * tc::kChunk + kb * tc::kK2 + j * tc::kBlockK,
                     wg * S::kCols2 + piece * S::kN2, full + b);
    }
  };
  if (threadIdx.x == 0) {  // x's rows, zeros past N
    tc::mbar_expect(x_full, tc::kRows * D * 2);
    for (int kb = 0; kb < D / tc::kBlockK; ++kb)
      tc::tma_load(ln + kb * tc::kRows * tc::kBlockK, x_map, kb * tc::kBlockK,
                   static_cast<int>(row0), x_full);
  }
  if (leader)
    for (int v = 0; v < tc::kRing; ++v) issue(v);
  __syncwarp();

  // LayerNorm in place, f32 statistics, the variance as mean((x - mean)^2): warp w takes rows
  // 8 w .. 8 w + 7 (one swizzle atom), lane l row 8 w + (l & 7) and its 16-byte pieces
  // (l >> 3) + 4 m, so a quarter-warp reads one piece of 8 rows on distinct banks; the 4 lanes of
  // a row combine their sums by shuffles
  tc::mbar_wait(x_full, 0);
  {
    const int r = 8 * warp + (lane & 7);
    constexpr int kPieces = D / 32;  // a lane's pieces of its row
    auto piece = [&](int m) {
      return reinterpret_cast<uint4*>(ln + tc::swizzled<tc::kRows>(r, 8 * (4 * m + (lane >> 3))));
    };
    auto quad_rows = [](float v) {
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      return v + __shfl_xor_sync(0xffffffffu, v, 16);
    };
    float sum = 0.0f;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const uint4 v = *piece(m);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        sum += f.x;
        sum += f.y;
      }
    }
    const float mean = quad_rows(sum) / D;
    float sq = 0.0f;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const uint4 v = *piece(m);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float d0 = __fsub_rn(f.x, mean), d1 = __fsub_rn(f.y, mean);
        sq = __fadd_rn(sq, __fmul_rn(d0, d0));
        sq = __fadd_rn(sq, __fmul_rn(d1, d1));
      }
    }
    const float rstd = rsqrtf(__fadd_rn(quad_rows(sq) / D, eps));
    const bool valid = row0 + r < n_rows;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      uint4 v = *piece(m);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
      const int col = 8 * (4 * m + (lane >> 3));
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
      const float4 t0 = *reinterpret_cast<const float4*>(beta + col);
      const float4 t1 = *reinterpret_cast<const float4*>(beta + col + 4);
      const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bt[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float y0 =
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), gm[2 * e]), bt[2 * e]);
        const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), gm[2 * e + 1]),
                                   bt[2 * e + 1]);
        h2[e] = __floats2bfloat162_rn(valid ? y0 : 0.0f, valid ? y1 : 0.0f);
      }
      *piece(m) = v;
    }
  }
  tc::fence_async_shared();
  tc::named_sync(1, 2 * 128);  // both warpgroups' LayerNorm rows reach the tensor cores

  // Slice u of this warpgroup sits in buffer u % kRing of its ring once full[] has completed its
  // (u / kRing)-th phase. Once all four warps' products of it have completed, the leader refills
  // the buffer with slice u + kRing.
  int u = 0;
  auto acquire = [&]() -> const bf16* {
    const int b = wg * tc::kRing + u % tc::kRing;
    tc::mbar_wait(full + b, (u / tc::kRing) & 1);
    return ring + b * S::kSlice;
  };
  auto release = [&]() {
    tc::named_sync(2 + wg, 128);
    if (leader) issue(u + tc::kRing);
    __syncwarp();
    ++u;
  };

  const uint64_t ln_desc = tc::descriptor(ln), hs_desc = tc::descriptor(hs);
  float y[S::kPieces2][S::kN2 / 2] = {};  // product 2: 64 rows x the warpgroup's D / 2 columns
  for (int chunk = 0; chunk < 4 * D / tc::kChunk; ++chunk) {
    // h = round(ln) W1[chunk]^T: warpgroup g takes hidden columns 64 g .. 64 g + 63 of the chunk
    float h[32] = {};
    for (int s = 0; s < S::kSlices1; ++s) {
      const uint64_t w = tc::descriptor(acquire());
      tc::hold(h);
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < S::kK1 / 16; ++ks)
        tc::wgmma<64>(h, tc::at_input<tc::kRows>(ln_desc, s * S::kK1 + 16 * ks),
                      tc::at_input<64>(w, 16 * ks));
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::hold(h);
      release();
    }
    // + b1 and SiLU in f32 (exp and the division on the special-function unit, about 2 f32 ulp,
    // far below the bf16 rounding that follows), rounded to bf16 into the hidden tile once the
    // other warpgroup's products of the last chunk have read it
    tc::named_sync(4, 2 * 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * wg + 8 * j + 2 * c;
      const float2 bias = *reinterpret_cast<const float2*>(b1 + chunk * tc::kChunk + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float h0 = __fadd_rn(h[4 * j + 2 * i], bias.x);
        const float h1 = __fadd_rn(h[4 * j + 2 * i + 1], bias.y);
        *reinterpret_cast<__nv_bfloat162*>(hs + tc::swizzled<tc::kRows>(row_w + 8 * i, col)) =
            __floats2bfloat162_rn(__fdividef(h0, __fadd_rn(1.0f, __expf(-h0))),
                                  __fdividef(h1, __fadd_rn(1.0f, __expf(-h1))));
      }
    }
    tc::fence_async_shared();
    tc::named_sync(5, 2 * 128);  // the whole hidden tile reaches the tensor cores
    // y += round(h) W2[:, chunk]^T: warpgroup g takes output columns g D / 2 .. (g + 1) D / 2 - 1,
    // kN2 at a time, over the chunk's inputs kK2 at a time
#pragma unroll
    for (int t = 0; t < S::kSlices2; ++t) {
      const int kb = t / S::kPieces2, piece = t % S::kPieces2;
      const uint64_t w = tc::descriptor(acquire());
      tc::hold(y[piece]);
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < tc::kK2 / 16; ++ks)
        tc::wgmma<S::kN2>(y[piece], tc::at_input<tc::kRows>(hs_desc, kb * tc::kK2 + 16 * ks),
                          tc::at_input<S::kN2>(w, 16 * ks));
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::hold(y[piece]);
      release();
    }
  }

  // out = round((y + b2) * res_scale + x), x read again from global memory
#pragma unroll
  for (int piece = 0; piece < S::kPieces2; ++piece)
#pragma unroll
    for (int j = 0; j < S::kN2 / 8; ++j) {
      const int col = S::kCols2 * wg + S::kN2 * piece + 8 * j + 2 * c;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long row = row0 + row_w + 8 * i;
        if (row >= n_rows) continue;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + row * D + col));
        const float r0 = __fmul_rn(__fadd_rn(y[piece][4 * j + 2 * i], bias.x), res_scale);
        const float r1 = __fmul_rn(__fadd_rn(y[piece][4 * j + 2 * i + 1], bias.y), res_scale);
        *reinterpret_cast<__nv_bfloat162*>(out + row * D + col) =
            __floats2bfloat162_rn(__fadd_rn(r0, xv.x), __fadd_rn(r1, xv.y));
      }
    }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) ==
                   cudaSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 matrix of `rows` rows of `cols` (contiguous, rows `stride` apart), in
// boxes of box_rows rows x 64 columns with the 128-byte swizzle; reads past an edge give zeros.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int stride,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {tc::kBlockK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_mma(const __nv_bfloat16* x, const float* gamma, const float* beta,
                       const __nv_bfloat16* w1t, const float* b1, const __nv_bfloat16* w2t,
                       const float* b2, __nv_bfloat16* out, int n_rows, float eps,
                       float res_scale, cudaStream_t stream) {
  using S = tc::Shape<D>;
  CUtensorMap x_map, w1_map, w2_map;
  if (!tensor_map(&x_map, x, n_rows, D, D, tc::kRows) ||
      !tensor_map(&w1_map, w1t, 4 * D, D, D, 64) ||
      !tensor_map(&w2_map, w2t, D, 4 * D, 4 * D, S::kN2))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  fused_ffn_mma_kernel<D><<<(n_rows + tc::kRows - 1) / tc::kRows, tc::kThreads, S::kSmemBytes,
                            stream>>>(x_map, w1_map, w2_map, x, gamma, beta, b1, b2, out, n_rows,
                                      eps, res_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const void* w1t,
                   const float* b1, const void* w2t, const float* b2, void* out, int n_rows,
                   int hidden, float eps, float res_scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16 runs on the tensor cores; f32 stays on the CUDA cores (true f32)
    return launch_mma<D>(static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1t), b1,
                         static_cast<const T*>(w2t), b2, static_cast<T*>(out), n_rows, eps,
                         res_scale, stream);
  } else {
    const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        fused_ffn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    fused_ffn_kernel<T, D><<<(n_rows + kRows - 1) / kRows, kThreads, smem, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1t), b1,
        static_cast<const T*>(w2t), b2, static_cast<T*>(out), n_rows, hidden, eps, res_scale);
  }
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
