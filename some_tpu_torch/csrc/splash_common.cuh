// Pieces shared by the splash attention kernels (splash_attention.cu, splash_attention_bwd.cu),
// on top of the flash kernels' tiles and score arithmetic (flash_common.cuh).
//
// Splash's masking is by segment ids: a query attends only the keys of its own segment. The port
// passes padding as a [B, T] byte mask, so a frame's segment is its mask byte (0 padding, 1 real),
// and every frame is segment 1 when there is no mask. A key in another segment scores splash's
// DEFAULT_MASK_VALUE, -0.7 * FLT_MAX, a key past T scores -inf. Every query sees at least its own
// segment (itself), so its row max is a real score and exp(mask value - max) is exactly 0.
// q arrives pre-scaled, so the score is the f32 dot product itself (tile_dot's FMA order), and the
// backward kernels rebuild the forward's scores bit for bit.
#pragma once

#include "flash_common.cuh"

namespace some_splash {

using namespace some_flash;

// splash_attention_kernel.py's DEFAULT_MASK_VALUE (a double there), rounded once to f32
constexpr float kSplashMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr int kPastT = 2;

// The segment of frame t: its mask byte, or 1 without a mask or past T (never stored).
__device__ __forceinline__ int segment_of(const uint8_t* mb, int t, int t_len) {
  return (mb == nullptr || t >= t_len) ? 1 : (mb[t] != 0 ? 1 : 0);
}

// Key codes of a tile of kBK keys: the key's segment, or kPastT.
__device__ __forceinline__ void stage_segment_codes(int* codes, const uint8_t* mb, int k0,
                                                    int t_len) {
  for (int r = threadIdx.x; r < kBK; r += kThreads) {
    const int t = k0 + r;
    codes[r] = t >= t_len ? kPastT : segment_of(mb, t, t_len);
  }
}

__device__ __forceinline__ float splash_score(float s, int key_code, int query_segment) {
  if (key_code == kPastT) return -INFINITY;
  return key_code == query_segment ? s : kSplashMaskValue;
}

}  // namespace some_splash
