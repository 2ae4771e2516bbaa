// The cross-replica max of int8 serving on a mesh: at every int8 site of a forward, each of the
// N engine replicas of a serving mesh hands in max|x| of its shard and gets back the max over
// all N shards (ops/replica_max.py).
//
// Replaces no TPU kernel. It is the counterpart of the all-reduce that GSPMD makes of
// jnp.max(jnp.abs(xf)) in some_tpu/ops/quant.py (quantize_activation) under the JAX engine's
// `data` mesh: one activation scale for the whole bucket, every shard and padding row together.
//
// Why a kernel: each replica replays its own CUDA graph per shard bucket, and two replicas may
// share one card. An event recorded in one capture cannot be waited on in another, and NCCL
// holds no two ranks on one card; a kernel that reads and writes fixed buffers is captured in
// each replica's graph like any other.
//
// Design. A slot table of 2 x N 64-bit words in mapped pinned host memory (cudaHostAlloc,
// Mapped | Portable): every card reads and writes it through its UVA address, with no peer
// access. Each replica keeps a sequence counter on its own device, which the kernel advances,
// so a replay advances it as an eager launch does and the replicas stay in step. Exchange g of
// replica r writes (g << 32 | bits of its amax) into slot r of parity g % 2 with one release
// store at system scope, then spins with acquire loads until all N slots of that parity carry
// g, and takes the max of their low words (the bits of non-negative floats order as unsigned
// integers, NaN above inf, so a NaN amax propagates as torch.amax's does). Two parities are
// enough: no replica writes exchange g + 2 before every replica has written g + 1, which each
// does only after it has read exchange g.
//
// Bound: latency, not bytes or operations. An exchange reads 4 bytes and writes 4 a replica,
// plus one store and N loads of 8 bytes across the host link. It runs as one thread. Its bound
// is measured, not computed: replica_max_touch_kernel makes the same store and loads with no
// wait, and its time in a replayed graph is the least an exchange can take.
//
// A missing peer never hangs the card: the spin reads %globaltimer, and past bound_ns it prints
// the replica, the peer and the sequence, and traps (the context is lost and the host's next
// synchronize raises). ops/replica_max.py keeps lone replicas from getting that far.
#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>

#include "launch_counts.cuh"

SOME_LAUNCH_COUNTS(replica_max, "replica_max_kernel")

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void replica_max_kernel(const float* __restrict__ amax, float* __restrict__ out,
                                   unsigned long long* __restrict__ seq,
                                   unsigned long long* table, int replicas, int rank,
                                   unsigned long long bound_ns) {
  const unsigned long long g = *seq + 1;
  *seq = g;
  const unsigned long long tag = (g & 0xffffffffull) << 32;
  unsigned long long* slots = table + (g & 1ull) * replicas;
  store_release_sys(slots + rank, tag | __float_as_uint(*amax));
  unsigned best = 0;
  const unsigned long long start = global_ns();
  for (int r = 0; r < replicas; ++r) {
    unsigned long long v = load_acquire_sys(slots + r);
    while ((v & 0xffffffff00000000ull) != tag) {
      if (global_ns() - start > bound_ns) {
        printf("replica_max: replica %d of %d waited %llu ns for replica %d at exchange %llu\n",
               rank, replicas, bound_ns, r, g);
        __trap();
      }
      __nanosleep(64);
      v = load_acquire_sys(slots + r);
    }
    best = max(best, static_cast<unsigned>(v & 0xffffffffull));
  }
  *out = __uint_as_float(best);
}

// The exchange's traffic with no wait and no counter: the release store of this replica's slot
// and one acquire load of each slot, as in an exchange whose peers have all written. Timed in a
// graph, it is the exchange's latency bound (ops/replica_max.py, chip_smoke's check_replica_max).
__global__ void replica_max_touch_kernel(unsigned long long* table, int replicas, int rank,
                                         float* out) {
  store_release_sys(table + rank, 0ull);
  unsigned best = 0;
  for (int r = 0; r < replicas; ++r) {
    best = max(best, static_cast<unsigned>(load_acquire_sys(table + r) & 0xffffffffull));
  }
  *out = __uint_as_float(best);
}

}  // namespace

// A zeroed slot table of `words` 64-bit words in mapped, portable pinned host memory; its
// address is the one every card uses (UVA). Null on failure.
extern "C" void* some_replica_max_table(int words) {
  void* table = nullptr;
  if (words <= 0 ||
      cudaHostAlloc(&table, sizeof(unsigned long long) * words,
                    cudaHostAllocMapped | cudaHostAllocPortable) != cudaSuccess) {
    return nullptr;
  }
  memset(table, 0, sizeof(unsigned long long) * words);
  return table;
}

// A stream of the current device made for one replica alone (non-blocking, so the legacy
// default stream never orders it), written to *stream; returns the CUDA error code.
extern "C" int some_replica_max_stream(void** stream) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = s;
  return err;
}

// One exchange of replica `rank` of `replicas`: amax and out are 0-d float32 on the replica's
// device, seq its int64 counter there, table the group's slot table (2 x replicas words).
// Launches one thread on `stream` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int some_replica_max(const float* amax, float* out, unsigned long long* seq,
                                unsigned long long* table, int replicas, int rank,
                                unsigned long long bound_ns, void* stream) {
  if (replicas < 1 || rank < 0 || rank >= replicas || table == nullptr) {
    return cudaErrorInvalidValue;
  }
  replica_max_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(amax, out, seq, table,
                                                                      replicas, rank, bound_ns);
  return some_counts::counted(0, cudaGetLastError());
}

// One launch of the bare traffic of an exchange (replica_max_touch_kernel) on `stream`, into a
// table of its own (not a group's); not counted. Returns cudaGetLastError().
extern "C" int some_replica_max_touch(unsigned long long* table, int replicas, int rank,
                                      float* out, void* stream) {
  if (replicas < 1 || rank < 0 || rank >= replicas || table == nullptr) {
    return cudaErrorInvalidValue;
  }
  replica_max_touch_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(table, replicas, rank,
                                                                            out);
  return cudaGetLastError();
}
