// Deterministic segment sums on the card: SegmentPlan.sum (ops/scatter.py)
// through ops/segsum_cuda.py.
//
// Replaces no TPU kernel. The JAX package sums by segment with
// jax.ops.segment_sum (an XLA scatter-add); the port, to sum in the same
// order on every run, sorts the ids stably once per plan and, before this
// kernel, gathered the rows into sorted order and called
// torch.segment_reduce. That reduce gives each (segment, column) to one
// thread, which walks the segment with one load from device memory in
// flight: the BA's sums have a few segments of about 2,000 narrow rows
// (plan_v: 17 segments of 6 floats; plan_b: 257 of 36), so a handful of
// threads waited on thousands of loads each while the card idled, about 1%
// of the bandwidth bound, and a permuted copy of every row was written
// first.
//
// The order of summation is fixed by the plan: each column of a segment is
// added in its dtype from 0, one row after another in the plan's sorted
// order, with no atomics. So two calls give the same bits, in or out of a
// CUDA graph, and they are the bits of segment_reduce on the CPU, which adds
// in that order, and on the card for rows of more than one element (1-D
// rows it sums by CUB's tree, in another order, so SegmentPlan.sum leaves
// those to it: the BA's solves carry a change of order far).
//
// What bounds it on the H100: bytes. A sum reads each kept row once and the
// plan (8 bytes of order a row, the run offsets) and writes (num_segments, D)
// once, with one add per element read. A serial chain of adds cannot reach
// that bound for a 2,000-row segment (one add, about 4 cycles, per row), but
// it need not wait on memory. The design:
//  - a block takes a run of whole segments (`spb` of them, from the segment
//    count) and their sorted rows, read through the plan where they lie
//    (vals[order[r]]): no permuted copy, and the dropped rows (the plan's
//    last segment) are never read;
//  - the block's rows go through shared memory in tiles: all 256 threads
//    load a tile, each a vector of V columns of a row at a time (16-byte
//    loads where the width allows) with LOADS independent loads in flight,
//    so a long segment is read by eight warps in parallel, not by the few
//    threads that add it;
//  - then one thread per (segment, column vector) adds its segment's rows
//    of the tile in order from shared memory; its running sum stays in a
//    register across tiles;
//  - rows wider than 256 vectors take more than one block in y, each a
//    range of columns.
// Everything follows from (n, num_segments, D, dtype): no option, no host
// read, so a call can be captured into a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;               // threads per block
constexpr int SMEM_BYTES = 32768;        // a tile of rows in shared memory
constexpr int TILE_MAX = 1024;           // rows a tile
constexpr int LOADS = 8;                 // loads a thread has in flight
constexpr int TARGET_BLOCKS = 132 * 4;   // blocks wanted: four an SM

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> add(const Pack<T, V>& a, const Pack<T, V>& b) {
  Pack<T, V> x;
#pragma unroll
  for (int i = 0; i < V; ++i) x.v[i] = a.v[i] + b.v[i];
  return x;
}

template <typename T, int V>
__global__ void __launch_bounds__(BLOCK)
segsum_kernel(const T* __restrict__ vals, const long long* __restrict__ order,
              const long long* __restrict__ offsets, T* __restrict__ out, int S, int Dv,
              int cols, int spb, int tile) {
  using P = Pack<T, V>;
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  P* buf = reinterpret_cast<P*>(smem);
  const int s0 = blockIdx.x * spb;
  const int s1 = min(s0 + spb, S);
  const int c0 = blockIdx.y * cols;          // the block's first column vector
  const int nc = min(cols, Dv - c0);         // and its count
  const long long D = (long long)Dv * V;
  const long long r0 = offsets[s0], r1 = offsets[s1];
  // this thread's (segment, column vector), if it has one
  const bool adder = threadIdx.x < (s1 - s0) * nc;
  const int seg = s0 + (adder ? threadIdx.x / nc : 0);
  const int col = adder ? threadIdx.x % nc : 0;
  long long a = 0, b = 0;
  if (adder) {
    a = offsets[seg];
    b = offsets[seg + 1];
  }
  P acc;
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = T(0);
  for (long long t0 = r0; t0 < r1; t0 += tile) {
    const int items = (int)min((long long)tile, r1 - t0) * nc;
    for (int q0 = threadIdx.x; q0 < items; q0 += BLOCK * LOADS) {
      long long src[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int q = q0 + k * BLOCK;
        src[k] = q < items ? order[t0 + q / nc] : 0;
      }
      P x[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int q = q0 + k * BLOCK;
        if (q < items) x[k] = load<T, V>(vals + src[k] * D + (long long)(c0 + q % nc) * V);
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int q = q0 + k * BLOCK;
        if (q < items) buf[q] = x[k];
      }
    }
    __syncthreads();
    if (adder) {
      const long long hi = min(b, t0 + tile);
#pragma unroll 8
      for (long long r = max(a, t0); r < hi; ++r) acc = add(acc, buf[(r - t0) * nc + col]);
    }
    __syncthreads();
  }
  if (adder) store<T, V>(out + seg * D + (long long)(c0 + col) * V, acc);
}

template <typename T, int V>
int launch(const void* vals, const void* order, const void* offsets, void* out, int S, int D,
           cudaStream_t st) {
  const int Dv = D / V;
  const int cols = Dv < BLOCK ? Dv : BLOCK;
  int spb = (S + TARGET_BLOCKS - 1) / TARGET_BLOCKS;
  if (spb > BLOCK / cols) spb = BLOCK / cols;
  if (spb < 1) spb = 1;
  int tile = SMEM_BYTES / (cols * V * (int)sizeof(T));
  if (tile > TILE_MAX) tile = TILE_MAX;
  const dim3 grid((S + spb - 1) / spb, (Dv + cols - 1) / cols);
  segsum_kernel<T, V><<<grid, BLOCK, 0, st>>>(
      static_cast<const T*>(vals), static_cast<const long long*>(order),
      static_cast<const long long*>(offsets), static_cast<T*>(out), S, Dv, cols, spb, tile);
  return cudaGetLastError();
}

}  // namespace

// out (S, D) = per-segment sums of vals (n, D) in the plan's order: order
// (n,) int64 sorted row -> row, offsets (S + 1,) int64 the first sorted row
// of each segment and of the dropped rows. dtype 0 float32, 1 float64. vals
// and out 16-byte aligned.
extern "C" int segment_sum_forward(const void* vals, const void* order, const void* offsets,
                                   void* out, int S, int D, int dtype, void* stream) {
  if (S <= 0 || D <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4 == 0) return launch<float, 4>(vals, order, offsets, out, S, D, st);
    if (D % 2 == 0) return launch<float, 2>(vals, order, offsets, out, S, D, st);
    return launch<float, 1>(vals, order, offsets, out, S, D, st);
  }
  if (D % 2 == 0) return launch<double, 2>(vals, order, offsets, out, S, D, st);
  return launch<double, 1>(vals, order, offsets, out, S, D, st);
}
