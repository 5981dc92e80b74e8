// Device time stamps for the tracer (utils/trace.py), through ops/stamp.py.
//
// trace_stamp launches one thread that writes %globaltimer (nanoseconds)
// into ring[(*cursor % rows) * slots + slot] and, with `advance`, writes the
// row's sequence number *cursor into its last slot and moves *cursor to the
// next row. The ring and the cursor are device memory that a
// CUDA graph captures by address, so a replayed stamp writes a new row at
// each replay while the graph's inputs stay as they were.
//
// trace_ticks launches one thread that reads %globaltimer until it has seen
// `n` changes and writes each change's size: the timer's resolution.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* ring, long long* cursor, int rows, int slots, int slot,
                             int advance) {
  const long long c = *cursor;
  long long* row = ring + (c % rows) * slots;
  row[slot] = global_ns();
  if (advance) {
    row[slots - 1] = c;
    *cursor = c + 1;
  }
}

__global__ void ticks_kernel(long long* out, int n) {
  long long prev = global_ns();
  for (int i = 0; i < n; ++i) {
    long long t = prev;
    // bounded: a timer that stops leaves a 0 here, never a hang
    for (int spin = 0; spin < (1 << 22) && t == prev; ++spin) t = global_ns();
    out[i] = t - prev;
    prev = t;
  }
}

}  // namespace

extern "C" int trace_stamp(void* ring, void* cursor, int rows, int slots, int slot, int advance,
                           void* stream) {
  if (rows <= 0 || slot < 0 || slot >= slots - 1) return cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(cursor), rows, slots, slot,
      advance);
  return cudaGetLastError();
}

extern "C" int trace_ticks(void* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  ticks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out), n);
  return cudaGetLastError();
}
