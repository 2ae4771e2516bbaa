// Launch counts by kernel variant, one table a library.
//
// A library names the kernel variants it launches with SOME_LAUNCH_COUNTS(<library>, "name",
// ...) at file scope, in the order of their indices. That defines its table and two C entry
// points: some_<library>_variant(i), the name of variant i (null past the last), and
// some_<library>_variant_launches(i), its launches so far (-1 past the last). A launcher hands
// its result to some_counts::counted(i, err), which counts variant i when err is cudaSuccess; a
// launch inside a CUDA graph capture counts once, at the capture, as the Python wrappers'
// counters do. ops/_build.py variant_launches() reads the tables: which variant a call ran is
// the library's own record, with no profiler in between.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

#define SOME_LAUNCH_COUNTS(LIB, ...)                                                       \
  namespace some_counts {                                                                  \
  namespace {                                                                              \
  constexpr const char* kNames[] = {__VA_ARGS__};                                          \
  constexpr int kVariants = static_cast<int>(sizeof(kNames) / sizeof(kNames[0]));          \
  std::atomic<long long> launches[kVariants];                                              \
  inline cudaError_t counted(int variant, cudaError_t err) {                               \
    if (err == cudaSuccess) launches[variant].fetch_add(1, std::memory_order_relaxed);     \
    return err;                                                                            \
  }                                                                                        \
  }                                                                                        \
  }                                                                                        \
  extern "C" const char* some_##LIB##_variant(int i) {                                     \
    return i >= 0 && i < some_counts::kVariants ? some_counts::kNames[i] : nullptr;        \
  }                                                                                        \
  extern "C" long long some_##LIB##_variant_launches(int i) {                              \
    return i >= 0 && i < some_counts::kVariants                                            \
               ? some_counts::launches[i].load(std::memory_order_relaxed)                  \
               : -1;                                                                       \
  }
