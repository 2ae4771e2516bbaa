// The tensor-core tile of the bf16 attention kernels on Hopper (flash_attention.cu's inference and
// training forwards, flash_attention_bwd.cu's dk/dv and dq kernels, splash_attention.cu's forward,
// splash_attention_bwd.cu's dk/dv and dq kernels): bf16 tiles copied with cp.async into a double-buffered
// ring in shared memory, read with ldmatrix, multiplied with mma.sync.m16n8k16 (bf16 operands,
// f32 sums).
//
// A forward's block owns 64 queries of one (batch, head) and 4 warps; warp w owns query rows
// 16 w .. 16 w + 15. Q is copied once and kept in registers as A fragments. K and V come in tiles
// of 64 keys: while the warps multiply one tile, the copies of the next are in flight, and each
// tile costs one barrier. Rows past T are zero-filled by the copy itself (cp.async's src-size 0),
// so the ragged edge needs no branch. The dq kernel's block owns queries too, with Q and dO as A
// fragments (carve_smem with two A tiles); K, the B operand of dQ += dS K, sits in the ring in
// V's layout, so pv_step2 multiplies it with dS and with P from one read. A dk/dv kernel swaps the
// sides: its block owns 64 keys, K and V are its A fragments (carve_smem_kv), and the ring carries
// Q and dO.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + c. The f32 accumulator of a
// 16 x 8 tile holds rows g (registers 0, 1) and g + 8 (2, 3) at columns 2 c, 2 c + 1. The A
// fragment of a 16 x 16 tile holds the same rows at columns 2 c, 2 c + 1 (registers 0, 1) and
// 2 c + 8, 2 c + 9 (2, 3), two bf16 to a register. So the accumulators of two adjacent 8-column
// score tiles, rounded to bf16 and packed in pairs, are the A fragment of P (or of P^T and dS^T
// in a dk/dv kernel) for those 16 columns: P goes from the scores into the next product in
// registers, with no trip through shared memory. A row's max and sum combine over the 4 lanes of
// its quad.
//
// Shared-memory rows are D + 8 bf16 long: 16 bytes of padding put the eight 16-byte rows that
// one ldmatrix phase reads on distinct banks, and keep every row 16-byte aligned for cp.async.
// So the global rows must be 16-byte aligned too: the wrappers check pointers and strides.
//
// Key tiles that add exactly nothing are skipped (TileFilter), as splash's block mask does on
// the TPU: the result is bit for bit that of walking them.
//
// A kernel on this tile keeps only its score arithmetic and its softmax: the carving of shared
// memory (carve_smem, carve_smem_kv), the A tile's copy and fragments (stage_q, load_q_fragments,
// load_a_fragments), the walk over the tiles (walk_tiles), the output store (store_output) and
// the launch (launch_grid, launch_blocks) are here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace some_mma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // queries per block, keys per tile
constexpr int kWarps = 4;  // warp w owns query rows 16 w .. 16 w + 15
constexpr int kThreads = 32 * kWarps;

// The query row (within the block) of a thread's row i: lane = 4 g + c holds rows g (i = 0) and
// g + 8 (i = 1) of its warp's 16.
__device__ __forceinline__ int thread_row(int i) {
  return 16 * static_cast<int>(threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * i;
}

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;          // bf16 per shared-memory row
  static constexpr int kTile = kRows * kStride;  // bf16 per tile
  static constexpr int kKSteps = D / 16;         // k16 steps of Q K^T
  static constexpr int kOutTiles = D / 8;        // n8 tiles of a warp's output rows
};

// Dynamic shared memory of a block that owns queries: its A-operand tiles (Q; Q and dO in the dq
// kernel), the K and V rings of two tiles each, and the two tile bitmaps of TileFilter.
template <int D>
inline int smem_bytes(int n_tiles, int a_tiles = 1) {
  return (a_tiles + 4) * Layout<D>::kTile * static_cast<int>(sizeof(bf16)) +
         2 * ((n_tiles + 31) / 32) * static_cast<int>(sizeof(uint32_t));
}

// Dynamic shared memory of a dk/dv kernel, which swaps the sides: the block's K and V tiles (A
// operands, as Q is in a forward), the Q and dO rings of two tiles each, the three f32 values
// of the 64 queries of two query tiles ((m, l, delta) in K2's, (lse, di) in K4's) and the two
// tile bitmaps (K4's, which skips query tiles).
template <int D>
inline int smem_bytes_kv(int n_tiles) {
  return 6 * Layout<D>::kTile * static_cast<int>(sizeof(bf16)) +
         2 * 3 * kRows * static_cast<int>(sizeof(float)) +
         2 * ((n_tiles + 31) / 32) * static_cast<int>(sizeof(uint32_t));
}

// A block's dynamic shared memory, carved as smem_bytes or smem_bytes_kv counts it.
struct Smem {
  bf16* q_tile;    // the block's A-operand tile: Q (forwards, dq kernel), K (dk/dv kernels)
  bf16* v_tile;    // the second A-operand tile: dO in the dq kernel, V in a dk/dv kernel
  bf16* k_ring;    // the walked tiles: K in a forward, Q in a dk/dv kernel
  bf16* v_ring;    // V in a forward, dO in a dk/dv kernel
  uint32_t* seg0;  // TileFilter's bitmaps, n_words each
  uint32_t* seg1;
  float* row_vals;  // a dk/dv kernel's per-query values of two query tiles: 3 x 2 x 64 floats
  int n_tiles;  // tiles of 64 below T
  int n_words;
};

template <int D>
__device__ __forceinline__ Smem carve_smem(unsigned char* base, int t_len, int a_tiles = 1) {
  Smem s;
  s.q_tile = reinterpret_cast<bf16*>(base);
  s.v_tile = a_tiles == 2 ? s.q_tile + Layout<D>::kTile : nullptr;
  s.k_ring = s.q_tile + a_tiles * Layout<D>::kTile;
  s.v_ring = s.k_ring + 2 * Layout<D>::kTile;
  s.n_tiles = (t_len + kRows - 1) / kRows;
  s.n_words = (s.n_tiles + 31) / 32;
  s.seg0 = reinterpret_cast<uint32_t*>(s.v_ring + 2 * Layout<D>::kTile);
  s.seg1 = s.seg0 + s.n_words;
  s.row_vals = nullptr;
  return s;
}

template <int D>
__device__ __forceinline__ Smem carve_smem_kv(unsigned char* base, int t_len) {
  Smem s;
  s.q_tile = reinterpret_cast<bf16*>(base);
  s.v_tile = s.q_tile + Layout<D>::kTile;
  s.k_ring = s.v_tile + Layout<D>::kTile;
  s.v_ring = s.k_ring + 2 * Layout<D>::kTile;
  s.n_tiles = (t_len + kRows - 1) / kRows;
  s.n_words = (s.n_tiles + 31) / 32;
  s.row_vals = reinterpret_cast<float*>(s.v_ring + 2 * Layout<D>::kTile);
  s.seg0 = reinterpret_cast<uint32_t*>(s.row_vals + 2 * 3 * kRows);
  s.seg1 = s.seg0 + s.n_words;
  return s;
}

// The block's (batch, head) slice of a [B, H, T, D] tensor with element strides s.b, s.h.
template <typename P, typename S>
__device__ __forceinline__ P* head_slice(P* p, const S& s) {
  return p + static_cast<long long>(blockIdx.z) * s.b + static_cast<long long>(blockIdx.y) * s.h;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with valid false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 8 or 4 bytes global -> shared through L1 (cp.async.ca), zeros where valid is false.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b for one 16 x 8 tile: a the 16 x 16 A fragment, (b0, b1) the 16 x 8 B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest bf16, the first in the low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A pair of f32 as two bf16 pairs for two mma into one f32 accumulator, x = hi + lo: hi cut to
// its bf16 bits (the high halves, packed by one byte permute), lo the exact rest x - hi rounded to
// bf16. hi + lo is within about 2^-16 |x|, where one bf16 rounds by up to 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                       x1 - __uint_as_float(u1 & 0xffff0000u)));
}

// exp(x) as 2^(x log2 e) on the special-function unit (ex2.approx, about 2 ulp where the
// probabilities matter; results below 2^-126 flush to 0, as exp(-inf) and exp(-1e9 - m) give 0).
__device__ __forceinline__ float exp_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dst[r][d] = src[(t0 + r) * ts + d] for the 64 rows of a tile, zeros past T, by cp.async. A
// thread copies the 16-byte piece c of rows r0, r0 + kRowStep, ...; a row past T reads nothing
// and points at row t0, which exists.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ts, int t0,
                                          int t_len) {
  constexpr int kChunks = D / 8;                 // 16-byte pieces of a row
  constexpr int kRowStep = kThreads / kChunks;  // rows between a thread's copies
  const int r0 = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  const bf16* first = src + t0 * ts + 8 * c;
  const bf16* row = first + r0 * ts;
  bf16* to = dst + r0 * Layout<D>::kStride + 8 * c;
#pragma unroll
  for (int it = 0; it < kRows / kRowStep; ++it) {
    const bool valid = t0 + r0 + it * kRowStep < t_len;
    cp_async_16(to + it * kRowStep * Layout<D>::kStride, valid ? row + it * kRowStep * ts : first,
                valid);
  }
}

// Starts the copy of the block's 64 queries (from q0, zeros past T) into the Q tile; the block
// can set up other state while it is in flight.
template <int D>
__device__ __forceinline__ void stage_q(const Smem& sm, const bf16* qb, long long qts, int q0,
                                        int t_len) {
  load_tile<D>(sm.q_tile, qb, qts, q0, t_len);
  cp_async_commit();
}

// Reads the warp's 16 rows of a staged tile as A fragments, one per k16 step.
template <int D>
__device__ __forceinline__ void load_a_fragments(uint32_t (&f)[Layout<D>::kKSteps][4],
                                                 const bf16* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* row = tile + (16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               Layout<D>::kStride + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < Layout<D>::kKSteps; ++kk) ldmatrix_x4(f[kk], row + 16 * kk);
}

// Waits for stage_q's copy and reads the warp's 16 query rows of the Q tile as A fragments.
template <int D>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[Layout<D>::kKSteps][4],
                                                 const Smem& sm) {
  cp_async_wait_all();
  __syncthreads();
  load_a_fragments<D>(qf, sm.q_tile);
}

// s[n] = Q K^T for the warp's 16 rows against keys 8 n .. 8 n + 7 of a staged K tile, summed
// over d in k16 steps from d = 0.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[8][4],
                                           const uint32_t (&qf)[Layout<D>::kKSteps][4],
                                           const bf16* k_tile) {
  const int lane = threadIdx.x & 31;
  const bf16* base = k_tile + ((lane & 7) + ((lane >> 4) << 3)) * Layout<D>::kStride +
                     (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < Layout<D>::kKSteps; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];  // B fragments of keys 16 p .. 16 p + 7 and 16 p + 8 .. 16 p + 15
      ldmatrix_x4(b, base + 16 * p * Layout<D>::kStride + 16 * kk);
      mma_bf16(s[2 * p], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * p + 1], qf[kk], b[2], b[3]);
    }
  }
}

// o += sum over the NP fragments of P V for keys 16 ks .. 16 ks + 15 of a staged V tile: pf[i]
// is an A fragment of the warp's probabilities for those keys.
template <int D, int NP>
__device__ __forceinline__ void pv_step(float (&o)[Layout<D>::kOutTiles][4],
                                        const uint32_t (&pf)[NP][4], const bf16* v_tile, int ks) {
  const int lane = threadIdx.x & 31;
  const bf16* base = v_tile + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                  Layout<D>::kStride + ((lane >> 4) << 3);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];  // B fragments of columns 16 dp .. 16 dp + 7 and 16 dp + 8 .. 16 dp + 15
    ldmatrix_x4_trans(b, base + 16 * dp);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      mma_bf16(o[2 * dp], pf[i], b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pf[i], b[2], b[3]);
    }
  }
}

// pv_step into two accumulators from one read of the staged tile: o1 += sum of the NP1 products
// pf1[i] V, o2 += sum of the NP2 products pf2[i] V.
template <int D, int NP1, int NP2>
__device__ __forceinline__ void pv_step2(float (&o1)[Layout<D>::kOutTiles][4],
                                         const uint32_t (&pf1)[NP1][4],
                                         float (&o2)[Layout<D>::kOutTiles][4],
                                         const uint32_t (&pf2)[NP2][4], const bf16* v_tile,
                                         int ks) {
  const int lane = threadIdx.x & 31;
  const bf16* base = v_tile + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                  Layout<D>::kStride + ((lane >> 4) << 3);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, base + 16 * dp);
#pragma unroll
    for (int i = 0; i < NP1; ++i) {
      mma_bf16(o1[2 * dp], pf1[i], b[0], b[1]);
      mma_bf16(o1[2 * dp + 1], pf1[i], b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < NP2; ++i) {
      mma_bf16(o2[2 * dp], pf2[i], b[0], b[1]);
      mma_bf16(o2[2 * dp + 1], pf2[i], b[2], b[3]);
    }
  }
}

// A lane's two mask bytes of the tile at key k0 (keys k0 + lane, k0 + 32 + lane): the byte, 1
// without a mask, 0 past T. Loaded a tile ahead and turned into bits by real_bits.
__device__ __forceinline__ uint2 load_key_bytes(const uint8_t* mb, int k0, int t_len) {
  const int t = k0 + (threadIdx.x & 31);
  uint2 raw = make_uint2(0u, 0u);
  if (t < t_len) raw.x = mb != nullptr ? mb[t] : 1u;
  if (t + 32 < t_len) raw.y = mb != nullptr ? mb[t + 32] : 1u;
  return raw;
}

// Bit c set where key k0 + c is below T and real (segment 1).
__device__ __forceinline__ uint64_t real_bits(uint2 raw) {
  const uint32_t lo = __ballot_sync(0xffffffffu, raw.x != 0u);
  const uint32_t hi = __ballot_sync(0xffffffffu, raw.y != 0u);
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

// Bit c set where key k0 + c is below T.
__device__ __forceinline__ uint64_t below_t_bits(int k0, int t_len) {
  const int n = t_len - k0;
  return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// A thread's 16 score columns of a 64-bit key mask: bit 2 n + e is column 8 n + 2 c + e.
__device__ __forceinline__ uint32_t thread_columns(uint64_t bits) {
  const int c = threadIdx.x & 3;
  uint32_t out = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    out |= static_cast<uint32_t>((bits >> (8 * n + 2 * c)) & 3ull) << (2 * n);
  return out;
}

// Which key tiles a block walks. seg0 / seg1 hold one bit per tile: it has a key below T of
// segment 0 (mask byte 0) / segment 1. A tile is walked when it has a key of a wanted segment;
// with no bitmaps, every tile is walked.
struct TileFilter {
  const uint32_t* seg0;
  const uint32_t* seg1;
  bool want0, want1;

  __device__ __forceinline__ bool keep(int j) const {
    if (seg1 == nullptr) return true;
    const uint32_t bit = 1u << (j & 31);
    return (want1 && (seg1[j >> 5] & bit) != 0u) || (want0 && (seg0[j >> 5] & bit) != 0u);
  }
  // The first walked tile after j, or n_tiles.
  __device__ __forceinline__ int next(int j, int n_tiles) const {
    for (++j; j < n_tiles && !keep(j); ++j) {
    }
    return j;
  }
};

// Fills the bitmaps sm.seg0 and sm.seg1 from a row's mask bytes; returns, to every thread,
// whether the row holds a key of segment 1. Called by the whole block; ends on a barrier.
__device__ __forceinline__ bool tile_segments(const Smem& sm, const uint8_t* mb, int t_len) {
  uint32_t* seg0 = sm.seg0;
  uint32_t* seg1 = sm.seg1;
  for (int i = threadIdx.x; i < sm.n_words; i += kThreads) seg0[i] = seg1[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (t_len + 31) / 32;  // 32 keys each, two to a tile
  int any_real = 0;
  for (int c0 = 4 * warp; c0 < n_chunks; c0 += 4 * kWarps) {
    int code[4];  // 0 past T, 1 segment 0, 2 segment 1; four loads in flight at once
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = 32 * (c0 + u) + lane;
      code[u] = t < t_len ? (mb[t] != 0 ? 2 : 1) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t real = __ballot_sync(0xffffffffu, code[u] == 2);
      const uint32_t pad = __ballot_sync(0xffffffffu, code[u] == 1);
      const int tile = (c0 + u) >> 1;
      if (lane == 0 && real != 0u) atomicOr(&seg1[tile >> 5], 1u << (tile & 31));
      if (lane == 0 && pad != 0u) atomicOr(&seg0[tile >> 5], 1u << (tile & 31));
      any_real |= real != 0u;
    }
  }
  return __syncthreads_or(any_real) != 0;
}

// Walks the kept tiles through the double-buffered ring. The copies of a tile (K, and V with kV;
// in a dk/dv kernel Q and dO) and its mask bytes are issued one tile ahead, with whatever
// extra(j, buf) copies beside them, so they are in flight while body(j, k_tile, v_tile, real)
// computes on tile j, real being its real_bits. One barrier per tile: a buffer is refilled only
// after every warp has passed the barrier that follows its last read.
template <int D, bool kV, typename Body, typename Extra>
__device__ __forceinline__ void walk_tiles(const Smem& sm, const TileFilter& filter,
                                           const bf16* kb, long long kts, const bf16* vb,
                                           long long vts, const uint8_t* mb, int t_len,
                                           Body&& body, Extra&& extra) {
  constexpr int kTile = Layout<D>::kTile;
  bf16* const k_ring = sm.k_ring;
  bf16* const v_ring = sm.v_ring;
  const int n_tiles = sm.n_tiles;
  auto issue = [&](int j, int buf) {
    load_tile<D>(k_ring + buf * kTile, kb, kts, j * kRows, t_len);
    if (kV) load_tile<D>(v_ring + buf * kTile, vb, vts, j * kRows, t_len);
    extra(j, buf);
    cp_async_commit();
  };
  __syncthreads();  // an earlier walk's reads of the ring are done
  int j = filter.next(-1, n_tiles);
  if (j >= n_tiles) return;
  issue(j, 0);
  uint2 raw = load_key_bytes(mb, j * kRows, t_len);
  for (int buf = 0; j < n_tiles; buf ^= 1) {
    cp_async_wait_all();  // tile j's copies have landed
    __syncthreads();
    const uint64_t real = real_bits(raw);
    const int next = filter.next(j, n_tiles);
    if (next < n_tiles) {
      issue(next, buf ^ 1);
      raw = load_key_bytes(mb, next * kRows, t_len);
    }
    body(j, k_ring + buf * kTile, v_ring + buf * kTile, real);
    j = next;
  }
}

template <int D, bool kV, typename Body>
__device__ __forceinline__ void walk_tiles(const Smem& sm, const TileFilter& filter,
                                           const bf16* kb, long long kts, const bf16* vb,
                                           long long vts, const uint8_t* mb, int t_len,
                                           Body&& body) {
  walk_tiles<D, kV>(sm, filter, kb, kts, vb, vts, mb, t_len, body, [](int, int) {});
}

// Writes the warp's output rows below T, row i times row_scale[i], as bf16 pairs through the
// time stride ots; with kResidual, what rounding to bf16 left of each value, itself rounded to bf16
// (x - bf16(x)), so that the two stores together carry x to about 2^-16 |x|.
template <int D, bool kResidual = false>
__device__ __forceinline__ void store_output(bf16* ob, long long ots, int q0, int t_len,
                                             const float (&o)[Layout<D>::kOutTiles][4],
                                             const float (&row_scale)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + thread_row(i);
    if (t >= t_len) continue;
    bf16* orow = ob + t * ots + 2 * c;
#pragma unroll
    for (int n = 0; n < Layout<D>::kOutTiles; ++n) {
      const float x0 = o[n][2 * i] * row_scale[i], x1 = o[n][2 * i + 1] * row_scale[i];
      __nv_bfloat162 y = __floats2bfloat162_rn(x0, x1);
      if (kResidual)
        y = __floats2bfloat162_rn(x0 - __low2float(y), x1 - __high2float(y));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = y;
    }
  }
}

// Launches kernel on the grid (ceil(T / 64), heads, batch) of kThreads-thread blocks with smem
// bytes of dynamic shared memory; returns cudaGetLastError().
template <typename... Params, typename... Args>
cudaError_t launch_grid(void (*kernel)(Params...), int smem, int batch, int heads, int t_len,
                        cudaStream_t stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((t_len + kRows - 1) / kRows, heads, batch), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// launch_grid with the shared memory of a block that owns queries (smem_bytes), a_tiles A tiles.
template <int D, int a_tiles = 1, typename... Params, typename... Args>
cudaError_t launch_blocks(void (*kernel)(Params...), int batch, int heads, int t_len,
                          cudaStream_t stream, Args... args) {
  return launch_grid(kernel, smem_bytes<D>((t_len + kRows - 1) / kRows, a_tiles), batch, heads,
                     t_len, stream, args...);
}

}  // namespace some_mma
