// Flash attention forward for the DINOv2 ViT-S/14 blocks (bf16, head dim 64),
// reading q, k and v straight from the packed qkv projection.
//
// Replaces the TPU kernel reached from
// cdvslam_tpu/models/dinov2.py::Attention.__call__ (its TPU branch calls the
// library Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention).
// It computes softmax(q k^T * scale) v per (batch, head), non-causal, with
// f32 softmax and accumulation. Input: qkv (B, L, 3, h, 64) bf16, the
// nn.Linear output as it is; output: (B, L, h, 64) bf16, i.e. (B, L, C).
//
// What bounds it on the H100: tensor-core operations. One call at the
// main-path shape (6 heads, L = 1891, d = 64) does 4 L^2 d h = 5.5 GFLOP on
// 5.8 MB of inputs and outputs, far above the card's flop-per-byte balance,
// so the design keeps the L x L logits and every intermediate on chip:
//  - one CTA per (64-query tile, head, batch) = 30 x 6 = 180 CTAs of one
//    128-thread warpgroup and 56 KB of shared memory, so all of them are
//    resident in one wave;
//  - Q and a 3-stage ring of 64-key K/V tiles come in by TMA (one 4-D
//    tensor map over the packed qkv, strides 128 B per head slot and
//    3 * C * 2 B per token, 128-byte swizzle, zero fill past L), one
//    mbarrier per tile; thread 0 refills a stage as soon as the warpgroup
//    has finished with it, two tiles ahead of the compute;
//  - S = Q K^T is four wgmma.m64n64k16 with both operands K-major in shared
//    memory; S stays in registers;
//  - the online softmax runs on the register fragment in the log2 domain
//    (row max and row sum over the four threads of a quad; keys >= L masked
//    to -inf in the last tile);
//  - O += P V is four wgmma.m64n64k16 with P packed to bf16 in registers as
//    the A operand and V read MN-major from shared memory (transpose flag);
//  - Q K^T of tile t and P V of tile t - 1 are issued together, so the
//    softmax of tile t overlaps P V of tile t - 1; P alternates between two
//    register sets (the loop is unrolled by two), because P V reads its P
//    from registers while it runs. O is rescaled in registers and divided
//    by the row sum at the end. No S, P or O goes through shared memory.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                       // head dim: one 128-byte row per token
constexpr int BQ = 64;                       // queries per CTA
constexpr int BK = 64;                       // keys per tile
constexpr int STAGES = 3;                    // K/V ring depth
constexpr int THREADS = 128;                 // one warpgroup
constexpr uint32_t TILE_BYTES = BQ * HD * 2; // 8 KB, 1024-byte aligned tiles
constexpr uint32_t OFF_K = TILE_BYTES;
constexpr uint32_t OFF_V = OFF_K + STAGES * TILE_BYTES;
constexpr uint32_t OFF_BAR = OFF_V + STAGES * TILE_BYTES;
constexpr uint32_t SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 64-row x 128-byte tile of the packed qkv: head slot `slot`, rows row0..
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int slot, int row0, int b) {
  mbar_expect_tx(bar, TILE_BYTES);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(slot), "r"(row0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define D32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define R32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) += A (64x16, smem, K-major) * B (16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : D32(d)
               : "l"(a), "l"(b));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : D32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// 2^x on the special-function unit (inputs <= 0 here; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online-softmax bookkeeping of one 64-key tile held in the wgmma
// accumulator layout: s[4j + e] is row r0 (e < 2) or r0 + 8 (e >= 2), key
// 8j + 2 (lane % 4) + (e & 1). Masks keys >= L to -inf, moves the running
// max m (log2 domain) to the tile's, rescales the (per-thread partial) sum
// l and returns the rescale factor of the old O in alpha.
__device__ __forceinline__ void online_max(float (&s)[32], int k0, int L, float scale_log2,
                                           float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  const int lane = threadIdx.x % 32;
  if (k0 + BK > L) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      if (key >= L) s[i] = -CUDART_INF_F;
    }
  }
  float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[4 * j], s[4 * j + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float mn = fmaxf(m[r], tmax[r] * scale_log2);
    alpha[r] = exp2_approx(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
}

// The online softmax of one tile: online_max, then P as the bf16 A
// fragments of the four k16 steps of P V.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int k0, int L, float scale_log2,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint32_t (&p)[4][4]) {
  online_max(s, k0, L, scale_log2, m, l, alpha);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2_approx(fmaf(s[4 * j], scale_log2, -m[0]));
    const float p1 = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -m[0]));
    const float p2 = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -m[1]));
    const float p3 = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -m[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    p[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_qkv_kernel(const __grid_constant__ CUtensorMap qkv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int L, int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles need 1024-byte alignment
  const uint32_t sQ = base, sK = base + OFF_K, sV = base + OFF_V;
  const uint32_t barQ = base + OFF_BAR;
  const uint32_t barK = barQ + 8, barV = barK + 8 * STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int nt = (L + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(barQ);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(barK + 8 * s);
      mbar_init(barV + 8 * s);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_tile(sQ, &qkv, barQ, head, q0, b);
    for (int t = 0; t < STAGES && t < nt; ++t) {
      tma_tile(sK + t * TILE_BYTES, &qkv, barK + 8 * t, H + head, t * BK, b);
      tma_tile(sV + t * TILE_BYTES, &qkv, barV + 8 * t, 2 * H + head, t * BK, b);
    }
  }

  // Q, K: K-major, 8-row groups 1024 B apart, k16 steps 32 B apart.
  // V: MN-major (keys are K), 8-key groups 1024 B apart, k16 steps 2048 B.
  float o[32], s[32];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[4][4], p2[4][4];   // P of alternate tiles
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  uint64_t dq[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) dq[kk] = desc_b128(sQ + 32 * kk, 16, 1024);

  mbar_wait(barQ, 0);
  mbar_wait(barK, 0);
  {
    uint64_t dk[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      asm volatile("" : "+l"(dq[kk]));
      dk[kk] = desc_b128(sK + 32 * kk, 16, 1024);
      asm volatile("" : "+l"(dk[kk]));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(s, dq[kk], dk[kk]);
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  softmax_tile(s, 0, L, scale_log2, m, l, alpha, p);

  // One tile of the main loop. P V of tile t - 1 reads its A operand (pin)
  // from registers while it runs, so the softmax of tile t writes the other
  // register set (pout): the loop is unrolled by two and alternates them.
  auto step = [&](int t, uint32_t (&pin)[4][4], uint32_t (&pout)[4][4]) {
    const int st = t % STAGES, sp = (t - 1) % STAGES;
    mbar_wait(barK + 8 * st, (t / STAGES) & 1);
    mbar_wait(barV + 8 * sp, ((t - 1) / STAGES) & 1);
    // every input of the two products is ready before the warpgroup
    // fence, so that ptxas keeps them asynchronous
    uint64_t dk[HD / 16], dv[BK / 16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dk[kk] = desc_b128(sK + st * TILE_BYTES + 32 * kk, 16, 1024);
      dv[kk] = desc_b128(sV + sp * TILE_BYTES + 2048 * kk, TILE_BYTES, 1024);
      asm volatile("" : "+l"(dk[kk]), "+l"(dv[kk]), "+l"(dq[kk]));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    reg_fence(o);
    reg_fence(pin);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(s, dq[kk], dk[kk]);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pin[kk], dv[kk]);
    wg_commit();
    wg_wait<1>();  // S of tile t is ready; P V of tile t - 1 may still run
    reg_fence(s);
    softmax_tile(s, t * BK, L, scale_log2, m, l, alpha, pout);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pin);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    __syncthreads();  // the warpgroup is done with stage sp: refill it
    if (tid == 0 && t - 1 + STAGES < nt) {
      const int tn = t - 1 + STAGES;
      tma_tile(sK + sp * TILE_BYTES, &qkv, barK + 8 * sp, H + head, tn * BK, b);
      tma_tile(sV + sp * TILE_BYTES, &qkv, barV + 8 * sp, 2 * H + head, tn * BK, b);
    }
  };
  // P V of the last tile, whose P is in pl
  auto last = [&](uint32_t (&pl)[4][4]) {
    const int sl = (nt - 1) % STAGES;
    mbar_wait(barV + 8 * sl, ((nt - 1) / STAGES) & 1);
    uint64_t dv[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      dv[kk] = desc_b128(sV + sl * TILE_BYTES + 2048 * kk, TILE_BYTES, 1024);
      asm volatile("" : "+l"(dv[kk]));
    }
    reg_fence(o);
    reg_fence(pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pl[kk], dv[kk]);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
  };

  for (int t = 1; t < nt; t += 2) {
    step(t, p, p2);
    if (t + 1 < nt) step(t + 1, p2, p);
  }
  if (nt % 2)
    last(p);
  else
    last(p2);

  const int warp = tid / 32, lane = tid % 32;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16 + lane / 4;
  const size_t C = static_cast<size_t>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * L + row) * C + head * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
  // training: the natural log of each row's softmax denominator, from the
  // log2-domain max and the f32 row sum (one thread of the quad writes)
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < L)
        lse[(static_cast<size_t>(b) * H + head) * L + row] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}


// the 4-D map {64 head dims, slots, L, B} over a bf16 tensor laid out (B, L,
// slots, 64): the packed qkv (slots 3 H) or out / dout (slots H); 64-row
// boxes of one slot, 128-byte swizzle, zero fill past L
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int slots, int L, int B) {
  const cuuint64_t row = static_cast<cuuint64_t>(slots) * HD * 2;  // bytes per token
  const cuuint64_t dims[4] = {HD, (cuuint64_t)slots, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, row, row * L};
  const cuuint32_t box[4] = {HD, 1, BK, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 3-D map {inner, rows, planes} over float32 planes of (rows, inner)
// floats: boxes of 32 floats (128 bytes) x 64 rows, 128-byte swizzle
bool encode_f32_map(EncodeTiled encode, CUtensorMap* map, const void* base, int inner, int rows,
                    int planes) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)inner * rows * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Training: the float32 forward and the backward (bf16 and float32).
//
// Replace the library Pallas kernels the JAX trainer differentiates through
// (jax.experimental.pallas.ops.tpu.flash_attention): the forward
// _flash_attention_impl, which also saves the softmax statistics, and the
// two backward kernels _flash_attention_bwd_dkv and _flash_attention_bwd_dq.
//
// What bounds them on the H100: operations. Forward 4 L^2 d h per batch
// element; the backward 10 L^2 d h as one function, 14 L^2 d h as split
// here (dQ: S, dP and dQ; dK/dV: S, dP, dK and dV). One kernel would form S
// and dP once but would have to sum dQ across the CTAs of the key tiles,
// with atomics (not repeatable) or ordered semaphores, so the split stays.
//
// The float32 forward runs on the tensor cores in three TF32 passes, as
// CUTLASS's OpMultiplyAddFastF32 (the float32 path of PyTorch's SDPA) does:
// each float32 operand x is split into x_hi = tf32(x) and x_lo = tf32(x -
// x_hi) (cvt.rna, low 13 bits cleared, so wgmma reads both exactly), and
// each product is x_lo y_hi + x_hi y_lo + x_hi y_hi, summed in float32 by
// wgmma.m64n64k8.f32.tf32.tf32 (the dropped x_lo y_lo is about 2^-22 of
// the product, so the result matches float32 to about 1e-6 of its scale;
// a single TF32 pass keeps about three digits). Two launches per call:
//  - flash_f32_split, a pre-pass over the packed qkv, writes Q and K split
//    (hi, lo) and V transposed and split into scratch the wrapper
//    allocates: V^T because a tf32 B operand must be K-major (no transpose
//    flag), with each group of 8 keys permuted (slot t holds key 2t, slot
//    t + 4 key 2t + 1), the order in which the S accumulator fragment holds
//    a thread's keys, so that P is the A operand of P V straight from
//    registers, with no shuffle. Done once per call here, not once per
//    query tile (26 times at L 1,611) in every CTA.
//  - flash_f32_kernel: one CTA per (128-query tile, head, batch): two
//    consumer warpgroups of 64 query rows share each key tile, and one
//    thread of a producer warpgroup (which hands its registers to the
//    consumers by setmaxnreg) keeps two rings by TMA, K (hi, lo) and V^T
//    (hi, lo), two stages each, with full and empty mbarriers (128-byte
//    swizzle; a 16 KB tile is two boxes of 32 floats). K runs one tile
//    ahead of V, because each warpgroup queues P V of tile t and S of tile
//    t + 1 together (the softmax of one warpgroup runs under the other's
//    products). S = Q K^T is 24 wgmma with both operands K-major in shared
//    memory; the online softmax runs on the fragment in the log2 domain
//    (keys >= L masked: their zero rows give S = 0, not -inf); P is split
//    in registers; O += P V is 24 wgmma with P as the register A operand,
//    into an accumulator of its own, and O = O alpha + (P V) runs in
//    float32 on the fragment: the tensor cores round their sums toward
//    zero, and one accumulator over all key tiles put O 1.2e-5 of max |O|
//    from float64 at L 1,891, leaning toward zero by as much
//    (kernel_ab.py flash_attn_f32; NVIDIA H100 80GB HBM3, 700 W). Query
//    rows past L are never written. 192 KB of shared memory: one CTA per
//    SM.
//
// Both backward kernels, in both types: dQ runs one CTA per (query tile,
// head, batch) and loops over the key tiles; its prologue computes
// D = rowsum(dO * O) for its rows and stores it for the dK/dV kernel, which
// the stream runs after it. dK/dV runs one CTA per (key tile, head, batch)
// and loops over the query tiles. Both recompute P = exp(q k^T * scale -
// LSE) and write their slots of the packed dqkv (B, L, 3, H, 64) directly.
// Query rows at or past L get LSE = +inf, so P = 0; keys at or past L are
// masked in dQ (their zero-filled rows give S = 0, not -inf) and never
// written in dK/dV. No atomics: every output element is summed by wgmma
// accumulators (in float32, each tile's added to the sum by one thread) in
// a fixed order, so two calls on the same inputs are bitwise equal.
//
// bf16: the tensor cores, with the forward's operand patterns. One
// warpgroup per CTA; its two own tiles and a 3-stage ring of the streamed
// ones come in by TMA (the forward's map over the packed qkv, and one over
// dout), 128-byte swizzle, zero fill past L; thread 0 refills a stage as
// soon as the warpgroup is done with it, two tiles ahead.
//  - dQ: S = Q K^T and dP = dO V^T, four wgmma.m64n64k16 each with both
//    operands K-major; P = exp2(S * scale * log2 e - LSE * log2 e) and
//    dS = P (dP - D) in float32 on the fragment; dS packed to bf16 in
//    registers is the A operand of dQ += dS K, K read MN-major (the
//    forward's P V pattern).
//  - dK/dV: K and V stay resident; S^T = K Q^T and dP^T = V dO^T; P^T
//    packed to bf16 feeds dV += P^T dO while dS^T = P^T (dP^T - D) is
//    formed, then dK += dS^T Q (dO and Q MN-major). The per-query LSE and D
//    of the next tile are loaded under this tile's products (two buffers).
//  - The next tile's S and dP are issued right behind the dQ (or dK, dV)
//    products, so the tensor cores have both queued while the warpgroup
//    waits; no wgmma is in flight across a loop iteration. The elementwise
//    work of one CTA overlaps the products of the other CTAs on its SM.
//  P and dS are rounded to bf16 only as wgmma operands, where the TPU kernel
//  rounds them (p.T.astype(do.dtype), ds.astype(k.dtype)); S, dP and every
//  accumulator stay float32.
//
// float32: three TF32 passes on wgmma, as the float32 forward. A TF32
// operand in shared memory must be K-major (wgmma's transpose bits exist
// only for 16-bit types), and the three products that sum over tokens (dQ
// = dS K over keys, dK = dS^T Q and dV = P^T dO over queries) need their
// shared-memory operand token-contiguous. So a pre-pass, flash_bwd_f32_split
// (a third launch, in the dQ entry point), writes Q, K, V and dO split into
// TF32 hi and lo parts row-major, and K^T, Q^T and dO^T split and permuted
// by slot_key (as the forward's V^T), into scratch the wrapper allocates;
// P or dS then feeds those products from the accumulator's registers. Each
// product is lo hi + hi lo + hi hi, smallest pass first, into an
// accumulator of its own per tile, added to dQ (dK, dV) in float32 (the
// tensor cores round their sums toward zero). Both kernels run a producer
// warpgroup (setmaxnreg 40; TMA, full and empty mbarriers) and two
// consumer warpgroups (232):
//  - dQ: 128 queries per CTA, 64 per consumer warpgroup; Q in shared
//    memory, dO as register A fragments; a two-stage ring of K and V, one
//    stage of K^T; 224 KB of shared memory.
//  - dK/dV: 64 keys per CTA; warpgroup 0 holds K in registers and forms
//    S^T, P^T and dV, warpgroup 1 holds V and forms dP^T, dS^T and dK, P^T
//    going from one to the other through shared memory; two-stage rings of
//    Q and dO, with each query tile's LSE and D beside them, one stage each
//    of dO^T and Q^T; 225 KB.
// Every product but dQ's S = Q K^T takes its A operand from registers, so
// its wgmma reads only the B tile from shared memory: at N = 64 a TF32
// wgmma with both operands there reads 4 KB in the 32 cycles the tensor
// cores take for it, all of the SM's 128 bytes a cycle. At the training
// shape (B 15, L 1,611): pre-pass 0.266 ms, dQ 0.758 (72% of its
// three-pass bound), dK/dV 1.078 (67%), 2.14 ms for the pair against the
// FP32-FMA pair's 6.66 and SDPA's float32 backward's 4.72; dqkv within
// 1.5e-6 of max |float64| (kernel_ab.py flash_attn_bwd; NVIDIA H100 80GB
// HBM3, 700 W). Neither kernel waits on L2: with the loads removed they
// take as long. Clusters of two CTAs sharing each streamed tile by TMA
// multicast were slower (4.23 ms for the pair): the two CTAs' rings wait
// on each other.
// ---------------------------------------------------------------------------

constexpr int FT = 64;          // rows per tile
constexpr int FTHREADS = 256;   // the float32 pre-passes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- float32 forward: three TF32 passes on wgmma ----------------------------

// The scratch of one call, Lp = L rounded up to F_ROWS (rows past L zero):
// qk holds the planes [Q hi, Q lo, K hi, K lo] x [B H] of (Lp, 64) floats,
// vt the planes [V^T hi, V^T lo] x [B H] of (64, Lp) floats.
constexpr int F_ROWS = 2 * BQ;                  // query rows per CTA: two warpgroups
constexpr int F_STAGES = 2;                     // depth of the K ring and of the V ring
constexpr int F_THREADS = 3 * THREADS;          // + the producer warpgroup
constexpr uint32_t F_TILE = FT * HD * 4;        // 16 KB: two 8 KB halves of 32 floats a row
constexpr uint32_t F_HALF = F_TILE / 2;
constexpr uint32_t F_OFF_K = 4 * F_TILE;        // after Q hi, Q lo of each warpgroup
constexpr uint32_t F_OFF_V = F_OFF_K + 2 * F_STAGES * F_TILE;
constexpr uint32_t F_OFF_BAR = F_OFF_V + 2 * F_STAGES * F_TILE;
constexpr uint32_t F_SMEM = F_OFF_BAR + 8 * (1 + 4 * F_STAGES) + 1024;   // + alignment slack

// x rounded to TF32 (10 mantissa bits, ties away from zero), the 13 bits
// TF32 ignores cleared, so that wgmma reads exactly this value
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xFFFFE000u);
}

// x ~ hi + lo with both TF32 values (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// the key that slot c of a V^T row holds: in each group of 8, slot t holds
// key 2t and slot t + 4 key 2t + 1
__device__ __forceinline__ int slot_key(int c) {
  const int e = c & 7;
  return (c & ~7) + (e < 4 ? 2 * e : 2 * e - 7);
}

// The pre-pass: rows r0..r0+63 of one (batch, head) of the packed qkv into
// the scratch planes (Q and K split; V transposed, permuted and split).
__global__ void __launch_bounds__(FTHREADS)
flash_f32_split(const float* __restrict__ qkv, float* __restrict__ qk, float* __restrict__ vt,
                int L, int H, int Lp) {
  __shared__ float sv[FT][HD + 1];
  const int r0 = blockIdx.x * FT, bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / H, h = bh % H;
  const size_t rs = static_cast<size_t>(3) * H * HD, plane = static_cast<size_t>(Lp) * HD;
  const float* src = qkv + static_cast<size_t>(b) * L * rs + h * HD;
  for (int i = threadIdx.x; i < FT * HD / 4; i += FTHREADS) {
    const int r = i >> 4, c = 4 * (i & 15), row = r0 + r;
    float4 x[3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
      x[p] = row < L ? *reinterpret_cast<const float4*>(src + row * rs + p * H * HD + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t off = static_cast<size_t>(row) * HD + c;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float4 hi, lo;
      split_tf32(x[p].x, hi.x, lo.x);
      split_tf32(x[p].y, hi.y, lo.y);
      split_tf32(x[p].z, hi.z, lo.z);
      split_tf32(x[p].w, hi.w, lo.w);
      *reinterpret_cast<float4*>(qk + (2 * p * BH + bh) * plane + off) = hi;
      *reinterpret_cast<float4*>(qk + ((2 * p + 1) * BH + bh) * plane + off) = lo;
    }
    sv[r][c] = x[2].x;
    sv[r][c + 1] = x[2].y;
    sv[r][c + 2] = x[2].z;
    sv[r][c + 3] = x[2].w;
  }
  __syncthreads();
  // V^T: a warp writes 32 consecutive slots of one head dim n
  for (int i = threadIdx.x; i < FT * HD; i += FTHREADS) {
    const int n = i >> 6, c = i & 63;
    float hi, lo;
    split_tf32(sv[slot_key(c)][n], hi, lo);
    const size_t off = static_cast<size_t>(n) * Lp + r0 + c;
    vt[bh * plane + off] = hi;
    vt[(BH + bh) * plane + off] = lo;
  }
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the registers of each thread of this warpgroup, from here on: the
// producer gives up what the consumers take (40 x 128 + 232 x 256 fit the
// SM's 65,536 as 384 threads at 168 registers do)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one 16 KB tile of a 3-D float32 map as its two boxes of 32 floats x 64
// rows, at {inner0, row0, plane} and {inner0 + 32, row0, plane}
__device__ __forceinline__ void tma_tile_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int inner0, int row0, int plane) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + half * F_HALF),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner0 + 32 * half), "r"(row0),
        "r"(plane)
        : "memory");
}

// d (64x64 f32) += A (64x8 tf32, smem, K-major) * B (8x64 tf32, smem, K-major)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
               ", %32, %33, p, 1, 1;\n}\n"
               : D32(d)
               : "l"(a), "l"(b));
}

// d (64x64 f32) += A (64x8 tf32, registers) * B (8x64 tf32, smem, K-major)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : D32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// descriptor offset (16-byte units) of k8 step kk in a tile of two halves
__device__ __forceinline__ uint64_t kstep(int kk) {
  return ((kk >> 2) * F_HALF + 32 * (kk & 3)) >> 4;
}

// The three passes of a product, smallest first: every lo hi, then every
// hi lo, then every hi hi k8 step. The tensor cores round each sum toward
// zero at the scale of its largest term, so the small passes are summed
// while the accumulator is still small, and only the eight hi hi steps
// round at the full scale. At L 1,891, O is within 9.7e-7 of max |O| from
// float64 and leans toward zero by 3.1e-7 of the mean |O|; interleaved
// per k8 step (all 24 steps rounding at the full scale), 2.4e-6 and
// 7.6e-7 (kernel_ab.py flash_attn_f32; NVIDIA H100 80GB HBM3, 700 W).

// s += Q K^T over the 64 head dims; the descriptors are of the tiles' bases
__device__ __forceinline__ void wgmma_s_tf32(float (&s)[32], uint64_t qh, uint64_t ql, uint64_t kh,
                                             uint64_t kl) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_tf32_ss(s, ql + kstep(kk), kh + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_tf32_ss(s, qh + kstep(kk), kl + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_tf32_ss(s, qh + kstep(kk), kh + kstep(kk));
}

// o += P V over the 64 keys of a tile: P (hi, lo) the register A operand of
// each k8 step, V^T (hi, lo) K-major
__device__ __forceinline__ void wgmma_pv_tf32(float (&o)[32], const uint32_t (&ph)[8][4],
                                              const uint32_t (&pl)[8][4], uint64_t vh,
                                              uint64_t vl) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) wgmma_tf32_rs(o, pl[j], vh + kstep(j));
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) wgmma_tf32_rs(o, ph[j], vl + kstep(j));
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) wgmma_tf32_rs(o, ph[j], vh + kstep(j));
}

__device__ __forceinline__ void reg_fence(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// The softmax of one tile (online_max, then P) with P split into the TF32
// A fragments of the eight k8 steps of P V. Step j holds (row g, slot t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4): by the slot order of V^T the keys
// 8j + 2t, 2t, 2t + 1, 2t + 1, i.e. the accumulator's s[4j], s[4j + 2],
// s[4j + 1], s[4j + 3].
__device__ __forceinline__ void softmax_tf32(float (&s)[32], int k0, int L, float scale_log2,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint32_t (&ph)[8][4], uint32_t (&pl)[8][4]) {
  online_max(s, k0, L, scale_log2, m, l, alpha);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p[4] = {exp2_approx(fmaf(s[4 * j], scale_log2, -m[0])),
                        exp2_approx(fmaf(s[4 * j + 2], scale_log2, -m[1])),
                        exp2_approx(fmaf(s[4 * j + 1], scale_log2, -m[0])),
                        exp2_approx(fmaf(s[4 * j + 3], scale_log2, -m[1]))};
    l[0] += p[0] + p[2];
    l[1] += p[1] + p[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hi, lo;
      split_tf32(p[i], hi, lo);
      ph[j][i] = __float_as_uint(hi);
      pl[j][i] = __float_as_uint(lo);
    }
  }
}

// o = o alpha + ot, in float32 on the fragment: the tensor cores sum each
// tile's P V alone (their accumulation rounds toward zero, which over all
// of L's key tiles drifts past 1e-5 of |O|)
__device__ __forceinline__ void rescale_add(float (&o)[32], const float (&alpha)[2],
                                            const float (&ot)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] = fmaf(o[4 * j], alpha[0], ot[4 * j]);
    o[4 * j + 1] = fmaf(o[4 * j + 1], alpha[0], ot[4 * j + 1]);
    o[4 * j + 2] = fmaf(o[4 * j + 2], alpha[1], ot[4 * j + 2]);
    o[4 * j + 3] = fmaf(o[4 * j + 3], alpha[1], ot[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap qk, const __grid_constant__ CUtensorMap vt,
                 float* __restrict__ out, float* __restrict__ lse, int L, int H,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + F_OFF_K, sV = base + F_OFF_V;   // stage s: hi at 2s, lo at 2s + 1
  const uint32_t barQ = base + F_OFF_BAR;
  const uint32_t fullK = barQ + 8, emptyK = fullK + 8 * F_STAGES;
  const uint32_t fullV = emptyK + 8 * F_STAGES, emptyV = fullV + 8 * F_STAGES;
  const int tid = threadIdx.x, wg = tid / THREADS;
  const int q0 = blockIdx.x * F_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int BH = gridDim.y * gridDim.z, bh = b * gridDim.y + head;
  const int nt = (L + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(barQ);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(fullK + 8 * s);
      mbar_init(fullV + 8 * s);
      mbar_init_count(emptyK + 8 * s, 8);   // one arrival per consumer warp
      mbar_init_count(emptyV + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: Q, then K(j) and V(j - 1) in turn, each into its ring
    // once both warpgroups are done with the tile two before it
    setmaxnreg_dec<40>();
    if (tid == 2 * THREADS) {
      mbar_expect_tx(barQ, 4 * F_TILE);
      for (int w = 0; w < 2; ++w)
        for (int part = 0; part < 2; ++part)
          tma_tile_f32(base + (2 * w + part) * F_TILE, &qk, barQ, 0, q0 + BQ * w,
                       part * BH + bh);
      for (int j = 0; j <= nt; ++j) {
        if (j < nt) {
          const int st = j % F_STAGES;
          if (j >= F_STAGES) mbar_wait(emptyK + 8 * st, (j / F_STAGES - 1) & 1);
          mbar_expect_tx(fullK + 8 * st, 2 * F_TILE);
          tma_tile_f32(sK + 2 * st * F_TILE, &qk, fullK + 8 * st, 0, j * BK, 2 * BH + bh);
          tma_tile_f32(sK + (2 * st + 1) * F_TILE, &qk, fullK + 8 * st, 0, j * BK,
                       3 * BH + bh);
        }
        if (j >= 1) {
          const int v = j - 1, st = v % F_STAGES;
          if (v >= F_STAGES) mbar_wait(emptyV + 8 * st, (v / F_STAGES - 1) & 1);
          mbar_expect_tx(fullV + 8 * st, 2 * F_TILE);
          tma_tile_f32(sV + 2 * st * F_TILE, &vt, fullV + 8 * st, v * BK, 0, bh);
          tma_tile_f32(sV + (2 * st + 1) * F_TILE, &vt, fullV + 8 * st, v * BK, 0, BH + bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int warp = (tid % THREADS) / 32, lane = tid % 32;
  float o[32], ot[32], s[32];   // O, this tile's P V, S
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t ph[8][4], pl[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint64_t dqh = desc_b128(base + 2 * wg * F_TILE, 16, 1024);
  uint64_t dql = desc_b128(base + (2 * wg + 1) * F_TILE, 16, 1024);
  // the hi (part 0) or lo (part 1) tile of K(t) or V(t)
  auto dk = [&](int t, int part) {
    return desc_b128(sK + (2 * (t % F_STAGES) + part) * F_TILE, 16, 1024);
  };
  auto dv = [&](int t, int part) {
    return desc_b128(sV + (2 * (t % F_STAGES) + part) * F_TILE, 16, 1024);
  };
  // lane 0 of each consumer warp frees a stage once its warpgroup's
  // products on it are complete
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  mbar_wait(barQ, 0);
  mbar_wait(fullK, 0);
  {
    uint64_t kh = dk(0, 0), kl = dk(0, 1);
    asm volatile("" : "+l"(dqh), "+l"(dql), "+l"(kh), "+l"(kl));
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wg_fence();
    wgmma_s_tf32(s, dqh, dql, kh, kl);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
  }
  release(emptyK);

  // Tile t: the softmax of S(t), then P V of tile t (into ot) and S of
  // tile t + 1 in one batch; no wgmma is in flight across a loop iteration
  for (int t = 0; t < nt - 1; ++t) {
    softmax_tf32(s, t * BK, L, scale_log2, m, l, alpha, ph, pl);
    mbar_wait(fullV + 8 * (t % F_STAGES), (t / F_STAGES) & 1);
    mbar_wait(fullK + 8 * ((t + 1) % F_STAGES), ((t + 1) / F_STAGES) & 1);
    uint64_t vh = dv(t, 0), vl = dv(t, 1), kh = dk(t + 1, 0), kl = dk(t + 1, 1);
    asm volatile("" : "+l"(vh), "+l"(vl), "+l"(kh), "+l"(kl), "+l"(dqh), "+l"(dql));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      ot[i] = 0.f;
      s[i] = 0.f;
    }
    reg_fence(ot);
    reg_fence(s);
    reg_fence(ph);
    reg_fence(pl);
    wg_fence();
    wgmma_pv_tf32(ot, ph, pl, vh, vl);
    wg_commit();
    wgmma_s_tf32(s, dqh, dql, kh, kl);
    wg_commit();
    wg_wait<0>();
    reg_fence(ot);
    reg_fence(s);
    reg_fence(ph);
    reg_fence(pl);
    release(emptyV + 8 * (t % F_STAGES));
    release(emptyK + 8 * ((t + 1) % F_STAGES));
    rescale_add(o, alpha, ot);
  }
  {
    const int t = nt - 1;
    softmax_tf32(s, t * BK, L, scale_log2, m, l, alpha, ph, pl);
    mbar_wait(fullV + 8 * (t % F_STAGES), (t / F_STAGES) & 1);
    uint64_t vh = dv(t, 0), vl = dv(t, 1);
    asm volatile("" : "+l"(vh), "+l"(vl));
#pragma unroll
    for (int i = 0; i < 32; ++i) ot[i] = 0.f;
    reg_fence(ot);
    reg_fence(ph);
    reg_fence(pl);
    wg_fence();
    wgmma_pv_tf32(ot, ph, pl, vh, vl);
    wg_commit();
    wg_wait<0>();
    reg_fence(ot);
    rescale_add(o, alpha, ot);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + BQ * wg + warp * 16 + lane / 4;
  const size_t C = static_cast<size_t>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + (static_cast<size_t>(b) * L + row) * C + head * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
  // one thread of the quad writes each row's log-sum-exp
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < L)
        lse[(static_cast<size_t>(b) * H + head) * L + row] = (m[r] + log2f(l[r])) * LN2;
    }
  }
}

// ---- bf16 backward -----------------------------------------------------------

// shared memory of both bf16 backward kernels, from the 1024-aligned base:
// the CTA's two own tiles (dQ: Q, dO; dK/dV: K, V), two rings of STAGES
// streamed tiles (dQ: K, V; dK/dV: Q, dO), one mbarrier per tile, then the
// per-row statistics (dQ: D of its rows; dK/dV: LSE and D of a query tile,
// two buffers)
constexpr uint32_t BW_OFF_RING1 = 2 * TILE_BYTES;
constexpr uint32_t BW_OFF_RING2 = BW_OFF_RING1 + STAGES * TILE_BYTES;
constexpr uint32_t BW_OFF_BAR = BW_OFF_RING2 + STAGES * TILE_BYTES;
constexpr uint32_t BW_OFF_STAT = BW_OFF_BAR + 8 * (2 + 2 * STAGES);
constexpr uint32_t BW_SMEM = BW_OFF_STAT + 2 * 2 * FT * 4 + 1024;   // + alignment slack

// k16 step kk of a tile whose rows are the M (or N) index and whose 64 head
// dims are the K index (K-major), and of a tile whose rows are the K index
// and whose head dims are the N index (MN-major, read with the transpose flag)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_b128(tile + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_b128(tile + 2048 * kk, TILE_BYTES, 1024);
}

// s = A1 B1^T and t = A2 B2^T (64 x 64 each) from four K-major tiles, one
// commit group
__device__ __forceinline__ void issue_two_ss(float (&s)[32], float (&t)[32], uint32_t a1,
                                             uint32_t b1, uint32_t a2, uint32_t b2) {
  uint64_t da1[HD / 16], db1[HD / 16], da2[HD / 16], db2[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    da1[kk] = desc_kmajor(a1, kk);
    db1[kk] = desc_kmajor(b1, kk);
    da2[kk] = desc_kmajor(a2, kk);
    db2[kk] = desc_kmajor(b2, kk);
    asm volatile("" : "+l"(da1[kk]), "+l"(db1[kk]), "+l"(da2[kk]), "+l"(db2[kk]));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    t[i] = 0.f;
  }
  reg_fence(s);
  reg_fence(t);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(s, da1[kk], db1[kk]);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(t, da2[kk], db2[kk]);
  wg_commit();
}

// d += A B, A (64 x 64 bf16) in registers, B an MN-major tile; one commit group
__device__ __forceinline__ void issue_rs(float (&d)[32], uint32_t (&a)[4][4], uint32_t b) {
  uint64_t db[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    db[kk] = desc_mnmajor(b, kk);
    asm volatile("" : "+l"(db[kk]));
  }
  reg_fence(d);
  reg_fence(a);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(d, a[kk], db[kk]);
  wg_commit();
}

// a 64 x 64 float fragment in the accumulator layout as the bf16 A operand
// of four k16 steps (the accumulator's columns are the K index)
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][2 * (j % 2)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// dQ for one (query tile, head, batch), and D = rowsum(dO * O) for its rows
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qkv, const __grid_constant__ CUtensorMap dom,
                  const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ Dbuf,
                  __nv_bfloat16* __restrict__ dqkv, int L, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE_BYTES;
  const uint32_t sK = base + BW_OFF_RING1, sV = base + BW_OFF_RING2;
  const uint32_t barQ = base + BW_OFF_BAR, barO = barQ + 8;
  const uint32_t barK = barO + 8, barV = barK + 8 * STAGES;
  float* sD = reinterpret_cast<float*>(smem_raw + (base - raw) + BW_OFF_STAT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int nt = (L + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(barQ);
    mbar_init(barO);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(barK + 8 * s);
      mbar_init(barV + 8 * s);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_tile(sQ, &qkv, barQ, head, q0, b);
    tma_tile(sdO, &dom, barO, head, q0, b);
    for (int t = 0; t < STAGES && t < nt; ++t) {
      tma_tile(sK + t * TILE_BYTES, &qkv, barK + 8 * t, H + head, t * BK, b);
      tma_tile(sV + t * TILE_BYTES, &qkv, barV + 8 * t, 2 * H + head, t * BK, b);
    }
  }
  const size_t C = static_cast<size_t>(H) * HD;
  const size_t stat = (static_cast<size_t>(b) * H + head) * L;
  {
    // D = rowsum(dO * O) from device memory while the tiles come in: two
    // threads per row, 32 products each
    const int r = tid >> 1, row = q0 + r;
    float acc = 0.f;
    if (row < L) {
      const size_t off = (static_cast<size_t>(b) * L + row) * C + head * HD + 32 * (tid & 1);
      const uint4* po = reinterpret_cast<const uint4*>(out + off);
      const uint4* pg = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint4 a = po[v], g = pg[v];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
          acc = fmaf(y.x, x.x, acc);
          acc = fmaf(y.y, x.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      sD[r] = acc;
      if (row < L) Dbuf[stat + row] = acc;
    }
  }
  __syncthreads();
  // this thread's fragment rows r0 and r0 + 8: D and LSE (log2 domain)
  const int r0 = warp * 16 + lane / 4;
  float dd[2], ll[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    dd[r] = sD[r0 + 8 * r];
    ll[r] = row < L ? lse[stat + row] * LOG2E : CUDART_INF_F;   // padded rows: P = 0
  }
  const float sl2 = scale * LOG2E;

  float dq[32], s[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(barQ, 0);
  mbar_wait(barO, 0);
  mbar_wait(barK, 0);
  mbar_wait(barV, 0);
  issue_two_ss(s, dp, sQ, sK, sdO, sV);
  wg_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  for (int t = 0; t < nt; ++t) {
    const int st = t % STAGES;
    __syncthreads();   // every warp is done with stage (t - 1) % STAGES: refill it
    if (tid == 0 && t >= 1 && t - 1 + STAGES < nt) {
      const int sp = (t - 1) % STAGES, tn = t - 1 + STAGES;
      tma_tile(sK + sp * TILE_BYTES, &qkv, barK + 8 * sp, H + head, tn * BK, b);
      tma_tile(sV + sp * TILE_BYTES, &qkv, barV + 8 * sp, 2 * H + head, tn * BK, b);
    }
    // dS = P (dP - D) in place of S; s[4 j + e] is row r0 + 8 (e >> 1), key
    // 8 j + 2 (lane % 4) + (e & 1)
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], sl2, -ll[r]));
      if (k0 + BK > L && k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= L) p = 0.f;
      s[i] = p * (dp[i] - dd[r]);
    }
    pack_a(s, da);
    issue_rs(dq, da, sK + st * TILE_BYTES);
    if (t + 1 < nt) {
      const int sn = (t + 1) % STAGES;
      mbar_wait(barK + 8 * sn, ((t + 1) / STAGES) & 1);
      mbar_wait(barV + 8 * sn, ((t + 1) / STAGES) & 1);
      issue_two_ss(s, dp, sQ, sK + sn * TILE_BYTES, sdO, sV + sn * TILE_BYTES);
    }
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dq);
    reg_fence(da);
  }
  const size_t rs = 3 * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* dst =
        dqkv + (static_cast<size_t>(b) * L + row) * rs + head * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * scale, dq[4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV for one (key tile, head, batch); reads D from the dQ kernel
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap qkv, const __grid_constant__ CUtensorMap dom,
                   const float* __restrict__ lse, const float* __restrict__ Dbuf,
                   __nv_bfloat16* __restrict__ dqkv, int L, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TILE_BYTES;
  const uint32_t sQ = base + BW_OFF_RING1, sdO = base + BW_OFF_RING2;
  const uint32_t barK = base + BW_OFF_BAR, barV = barK + 8;
  const uint32_t barQ = barV + 8, barO = barQ + 8 * STAGES;
  // [buffer][LSE * log2 e of the tile's 64 queries, then their D]
  float* sStat = reinterpret_cast<float*>(smem_raw + (base - raw) + BW_OFF_STAT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, head = blockIdx.y, b = blockIdx.z;
  const int nq = (L + BQ - 1) / BQ;
  const size_t stat = (static_cast<size_t>(b) * H + head) * L;
  if (tid == 0) {
    mbar_init(barK);
    mbar_init(barV);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(barQ + 8 * s);
      mbar_init(barO + 8 * s);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // thread tid holds entry tid of a tile's statistics: LSE (tid < 64; +inf
  // past L, so P = 0) or D (0 past L)
  auto stat_of = [&](int t) {
    const int row = t * BQ + (tid & 63);
    if (tid < 64) return row < L ? lse[stat + row] * LOG2E : CUDART_INF_F;
    return row < L ? Dbuf[stat + row] : 0.f;
  };
  sStat[tid] = stat_of(0);
  __syncthreads();
  if (tid == 0) {
    tma_tile(sK, &qkv, barK, H + head, k0, b);
    tma_tile(sV, &qkv, barV, 2 * H + head, k0, b);
    for (int t = 0; t < STAGES && t < nq; ++t) {
      tma_tile(sQ + t * TILE_BYTES, &qkv, barQ + 8 * t, head, t * BQ, b);
      tma_tile(sdO + t * TILE_BYTES, &dom, barO + 8 * t, head, t * BQ, b);
    }
  }
  const float sl2 = scale * LOG2E;
  float dk[32], dv[32], st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  mbar_wait(barK, 0);
  mbar_wait(barV, 0);
  mbar_wait(barQ, 0);
  mbar_wait(barO, 0);
  issue_two_ss(st, dpt, sK, sQ, sV, sdO);
  wg_wait<0>();
  reg_fence(st);
  reg_fence(dpt);
  for (int t = 0; t < nq; ++t) {
    const int sb = t % STAGES;
    const float next = t + 1 < nq ? stat_of(t + 1) : 0.f;   // lands under this tile's work
    __syncthreads();   // stage (t - 1) % STAGES and statistics buffer (t + 1) % 2 are free
    if (tid == 0 && t >= 1 && t - 1 + STAGES < nq) {
      const int sp = (t - 1) % STAGES, tn = t - 1 + STAGES;
      tma_tile(sQ + sp * TILE_BYTES, &qkv, barQ + 8 * sp, head, tn * BQ, b);
      tma_tile(sdO + sp * TILE_BYTES, &dom, barO + 8 * sp, head, tn * BQ, b);
    }
    if (t + 1 < nq) sStat[((t + 1) & 1) * 2 * BQ + tid] = next;
    // st[4 j + e] is key r0 + 8 (e >> 1), query 8 j + 2 (lane % 4) + (e & 1)
    const float* sl = sStat + (t & 1) * 2 * BQ + 2 * (lane % 4);
    const float* sd = sl + BQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j);
      st[4 * j] = exp2_approx(fmaf(st[4 * j], sl2, -l2.x));
      st[4 * j + 1] = exp2_approx(fmaf(st[4 * j + 1], sl2, -l2.y));
      st[4 * j + 2] = exp2_approx(fmaf(st[4 * j + 2], sl2, -l2.x));
      st[4 * j + 3] = exp2_approx(fmaf(st[4 * j + 3], sl2, -l2.y));
    }
    pack_a(st, pa);
    issue_rs(dv, pa, sdO + sb * TILE_BYTES);   // dV += P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j);
      st[4 * j] *= dpt[4 * j] - d2.x;
      st[4 * j + 1] *= dpt[4 * j + 1] - d2.y;
      st[4 * j + 2] *= dpt[4 * j + 2] - d2.x;
      st[4 * j + 3] *= dpt[4 * j + 3] - d2.y;
    }
    pack_a(st, da);
    issue_rs(dk, da, sQ + sb * TILE_BYTES);    // dK += dS^T Q
    if (t + 1 < nq) {
      const int sn = (t + 1) % STAGES;
      mbar_wait(barQ + 8 * sn, ((t + 1) / STAGES) & 1);
      mbar_wait(barO + 8 * sn, ((t + 1) / STAGES) & 1);
      issue_two_ss(st, dpt, sK, sQ + sn * TILE_BYTES, sV, sdO + sn * TILE_BYTES);
    }
    wg_wait<0>();
    reg_fence(st);
    reg_fence(dpt);
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
  }
  const int r0 = warp * 16 + lane / 4;
  const size_t rs = static_cast<size_t>(3) * H * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* dst = dqkv + (static_cast<size_t>(b) * L + row) * rs + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (H + head) * HD + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r] * scale, dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dst + (2 * H + head) * HD + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---- float32 backward: three TF32 passes on wgmma ----------------------------

// The scratch of one float32 backward call, Lp = flash_attn_f32_rows(L)
// rows (past L zero), planes of Lp x 64 floats: rm holds [Q hi, Q lo, K hi,
// K lo, V hi, V lo, dO hi, dO lo] x [B H] row-major, tr holds [Q^T hi, Q^T
// lo, K^T hi, K^T lo, dO^T hi, dO^T lo] x [B H] as 64 rows (head dims) of
// Lp token slots, each group of 8 slots permuted by slot_key.
constexpr int RM_PLANES = 8, TR_PLANES = 6;
enum { OP_Q = 0, OP_K = 1, OP_V = 2, OP_DO = 3 };   // rm operands
enum { TR_Q = 0, TR_K = 1, TR_DO = 2 };             // tr operands

// The pre-pass: rows r0..r0+63 of one (batch, head) of operand op (Q, K and
// V from the packed qkv, dO from dout) into its row-major planes, and for
// Q, K and dO into its transposed, permuted planes.
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_f32_split(const float* __restrict__ qkv, const float* __restrict__ dout,
                    float* __restrict__ rm, float* __restrict__ tr, int L, int H, int Lp) {
  __shared__ float sv[FT][HD + 1];
  const int r0 = blockIdx.x * FT, bh = blockIdx.y, BH = gridDim.y, op = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const size_t plane = static_cast<size_t>(Lp) * HD;
  const size_t rs = static_cast<size_t>(op == OP_DO ? 1 : 3) * H * HD;
  const float* src = op == OP_DO ? dout + static_cast<size_t>(b) * L * rs + h * HD
                                 : qkv + static_cast<size_t>(b) * L * rs + (op * H + h) * HD;
  for (int i = threadIdx.x; i < FT * HD / 4; i += FTHREADS) {
    const int r = i >> 4, c = 4 * (i & 15), row = r0 + r;
    const float4 x = row < L ? *reinterpret_cast<const float4*>(src + row * rs + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    const size_t off = static_cast<size_t>(row) * HD + c;
    *reinterpret_cast<float4*>(rm + (2 * op * BH + bh) * plane + off) = hi;
    *reinterpret_cast<float4*>(rm + ((2 * op + 1) * BH + bh) * plane + off) = lo;
    sv[r][c] = x.x;
    sv[r][c + 1] = x.y;
    sv[r][c + 2] = x.z;
    sv[r][c + 3] = x.w;
  }
  if (op == OP_V) return;   // V is only ever a row-major operand
  const int tp = op == OP_DO ? TR_DO : op;
  __syncthreads();
  // a warp writes 32 consecutive slots of one head dim n
  for (int i = threadIdx.x; i < FT * HD; i += FTHREADS) {
    const int n = i >> 6, c = i & 63;
    float hi, lo;
    split_tf32(sv[slot_key(c)][n], hi, lo);
    const size_t off = static_cast<size_t>(n) * Lp + r0 + c;
    tr[(2 * tp * BH + bh) * plane + off] = hi;
    tr[((2 * tp + 1) * BH + bh) * plane + off] = lo;
  }
}

// The rows of a 64 x 64 operand as the TF32 A fragments (hi, lo) of the
// eight k8 steps over its 64 columns, read from device memory and split in
// registers: register a of step kk holds row 16 warp + lane / 4 + 8 (a & 1),
// column 8 kk + lane % 4 + 4 (a >> 1) of the warpgroup's 64 rows; rows at
// or past L are zero. x points at row 0's first column, rows `stride` apart.
__device__ __forceinline__ void load_a_tf32(const float* __restrict__ x, size_t stride, int row0,
                                            int L, uint32_t (&ah)[8][4], uint32_t (&al)[8][4]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % THREADS) / 32;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + 16 * warp + lane / 4 + 8 * (a & 1);
      const float v = row < L ? x[row * stride + 8 * kk + lane % 4 + 4 * (a >> 1)] : 0.f;
      float hi, lo;
      split_tf32(v, hi, lo);
      ah[kk][a] = __float_as_uint(hi);
      al[kk][a] = __float_as_uint(lo);
    }
  }
}

// Accumulator element s[4 j + e] (row + 8 (e >> 1), column 8 j + 2 (lane % 4)
// + (e & 1)) is register ((e & 1) << 1 | e >> 1) of k8 step j of an A
// fragment over the same 64 columns in slot_key order (see softmax_tf32).
__device__ __forceinline__ void split_to_a(float x, int i, uint32_t (&ah)[8][4],
                                           uint32_t (&al)[8][4]) {
  const int j = i >> 2, e = i & 3, a = ((e & 1) << 1) | (e >> 1);
  float hi, lo;
  split_tf32(x, hi, lo);
  ah[j][a] = __float_as_uint(hi);
  al[j][a] = __float_as_uint(lo);
}

__device__ __forceinline__ void add_to(float (&d)[32], const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += x[i];
}

// shared memory of the float32 dQ kernel, from the 1024-aligned base: Q
// (hi, lo) of each consumer warpgroup, a two-stage ring of K and V (hi, lo
// each), one stage of K^T (hi, lo), then the mbarriers
constexpr uint32_t DQ_OFF_KV = 4 * F_TILE;
constexpr uint32_t DQ_OFF_KT = DQ_OFF_KV + 2 * 4 * F_TILE;
constexpr uint32_t DQ_OFF_BAR = DQ_OFF_KT + 2 * F_TILE;
constexpr uint32_t DQ_F32_SMEM = DQ_OFF_BAR + 8 * 7 + 1024;   // + alignment slack

// dQ for one (128-query tile, head, batch), and D = rowsum(dO * O) for its
// rows. Each consumer warpgroup holds 64 query rows: Q (hi, lo) in shared
// memory, dO (hi, lo) as register A fragments. Per key tile: S = Q K^T
// (both operands in shared memory) and dP = dO V^T, one batch of 48 wgmma;
// dS = P (dP - D) split into the A fragments of dQ_t = dS K (K^T from the
// pre-pass), 24 wgmma into an accumulator of its own; dQ += dQ_t in float32.
__global__ void __launch_bounds__(F_THREADS, 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap rm, const __grid_constant__ CUtensorMap tr,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ Dbuf,
                 float* __restrict__ dqkv, int L, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = base + DQ_OFF_KV, sKT = base + DQ_OFF_KT;
  const uint32_t barQ = base + DQ_OFF_BAR;
  const uint32_t fullKV = barQ + 8, emptyKV = fullKV + 16, fullKT = emptyKV + 16;
  const uint32_t emptyKT = fullKT + 8;
  const int tid = threadIdx.x, wg = tid / THREADS;
  const int q0 = blockIdx.x * F_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int BH = gridDim.y * gridDim.z, bh = b * gridDim.y + head;
  const int nt = (L + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(barQ);
    for (int s = 0; s < 2; ++s) {
      mbar_init(fullKV + 8 * s);
      mbar_init_count(emptyKV + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(fullKT);
    mbar_init_count(emptyKT, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: Q, then K and V of tile j and K^T of tile j in turn
    setmaxnreg_dec<40>();
    if (tid == 2 * THREADS) {
      mbar_expect_tx(barQ, 4 * F_TILE);
      for (int w = 0; w < 2; ++w)
        for (int part = 0; part < 2; ++part)
          tma_tile_f32(base + (2 * w + part) * F_TILE, &rm, barQ, 0, q0 + BQ * w,
                       (2 * OP_Q + part) * BH + bh);
      for (int j = 0; j < nt; ++j) {
        const int st = j % 2;
        if (j >= 2) mbar_wait(emptyKV + 8 * st, (j / 2 - 1) & 1);
        mbar_expect_tx(fullKV + 8 * st, 4 * F_TILE);
        for (int i = 0; i < 4; ++i)   // K hi, K lo, V hi, V lo
          tma_tile_f32(sKV + (4 * st + i) * F_TILE, &rm, fullKV + 8 * st, 0, j * BK,
                       (2 * OP_K + i) * BH + bh);
        if (j >= 1) mbar_wait(emptyKT, (j - 1) & 1);
        mbar_expect_tx(fullKT, 2 * F_TILE);
        for (int part = 0; part < 2; ++part)
          tma_tile_f32(sKT + part * F_TILE, &tr, fullKT, j * BK, 0, (2 * TR_K + part) * BH + bh);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int warp = (tid % THREADS) / 32, lane = tid % 32;
  const int r0 = q0 + BQ * wg + 16 * warp + lane / 4;   // this thread's rows r0, r0 + 8
  const size_t C = static_cast<size_t>(H) * HD;
  const size_t stat = (static_cast<size_t>(b) * H + head) * L;
  const float* obase = out + static_cast<size_t>(b) * L * C + head * HD;
  const float* gbase = dout + static_cast<size_t>(b) * L * C + head * HD;
  uint32_t oh[8][4], ol[8][4];   // dO (hi, lo): the A operand of dP = dO V^T
  load_a_tf32(gbase, C, q0 + BQ * wg, L, oh, ol);
  float dd[2], ll[2];
  {
    // D = rowsum(dO * O): this thread's 16 columns of each row, then the quad
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = r0 + 8 * (a & 1);
        if (row < L) {
          const size_t off = row * C + 8 * kk + lane % 4 + 4 * (a >> 1);
          acc[a & 1] = fmaf(gbase[off], obase[off], acc[a & 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      const int row = r0 + 8 * r;
      dd[r] = acc[r];
      ll[r] = row < L ? lse[stat + row] * LOG2E : CUDART_INF_F;   // padded rows: P = 0
      if (row < L && lane % 4 == 0) Dbuf[stat + row] = acc[r];
    }
  }
  const float sl2 = scale * LOG2E;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float dq[32], dqt[32], s[32], dp[32];
  uint32_t sh[8][4], sl[8][4];   // dS (hi, lo): the A operand of dQ_t = dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint64_t dqh = desc_b128(base + 2 * wg * F_TILE, 16, 1024);
  uint64_t dql = desc_b128(base + (2 * wg + 1) * F_TILE, 16, 1024);
  mbar_wait(barQ, 0);
  for (int t = 0; t < nt; ++t) {
    const int st = t % 2;
    mbar_wait(fullKV + 8 * st, (t / 2) & 1);
    uint64_t kh = desc_b128(sKV + 4 * st * F_TILE, 16, 1024);
    uint64_t kl = desc_b128(sKV + (4 * st + 1) * F_TILE, 16, 1024);
    uint64_t vh = desc_b128(sKV + (4 * st + 2) * F_TILE, 16, 1024);
    uint64_t vl = desc_b128(sKV + (4 * st + 3) * F_TILE, 16, 1024);
    asm volatile("" : "+l"(kh), "+l"(kl), "+l"(vh), "+l"(vl), "+l"(dqh), "+l"(dql));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    reg_fence(s);
    reg_fence(dp);
    reg_fence(oh);
    reg_fence(ol);
    wg_fence();
    wgmma_s_tf32(s, dqh, dql, kh, kl);
    wgmma_pv_tf32(dp, oh, ol, vh, vl);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    reg_fence(oh);
    reg_fence(ol);
    release(emptyKV + 8 * st);
    // dS = P (dP - D); keys at or past L: their zero rows give S = 0, so P is masked
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], sl2, -ll[r]));
      if (k0 + BK > L && k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= L) p = 0.f;
      split_to_a(p * (dp[i] - dd[r]), i, sh, sl);
    }
    mbar_wait(fullKT, t & 1);
    uint64_t th = desc_b128(sKT, 16, 1024), tl = desc_b128(sKT + F_TILE, 16, 1024);
    asm volatile("" : "+l"(th), "+l"(tl));
#pragma unroll
    for (int i = 0; i < 32; ++i) dqt[i] = 0.f;
    reg_fence(dqt);
    reg_fence(sh);
    reg_fence(sl);
    wg_fence();
    wgmma_pv_tf32(dqt, sh, sl, th, tl);
    wg_commit();
    wg_wait<0>();
    reg_fence(dqt);
    reg_fence(sh);
    reg_fence(sl);
    release(emptyKT);
    add_to(dq, dqt);
  }
  const size_t rs = 3 * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= L) continue;
    float* dst = dqkv + (static_cast<size_t>(b) * L + row) * rs + head * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(dq[4 * j + 2 * r] * scale, dq[4 * j + 2 * r + 1] * scale);
  }
}

// shared memory of the float32 dK/dV kernel: two-stage rings of Q and dO,
// one stage each of dO^T and Q^T (each tile hi, lo), two P^T hand-over
// buffers (64 x 64 floats each, in the accumulator's thread order), the
// per-query statistics of each stage of the two rings (LSE log2 e beside
// Q, D beside dO), then the mbarriers
constexpr uint32_t DKV_OFF_DO = 2 * 2 * F_TILE;
constexpr uint32_t DKV_OFF_QT = DKV_OFF_DO + 2 * 2 * F_TILE;
constexpr uint32_t DKV_OFF_DOT = DKV_OFF_QT + 2 * F_TILE;
constexpr uint32_t DKV_OFF_X = DKV_OFF_DOT + 2 * F_TILE;
constexpr uint32_t DKV_OFF_STAT = DKV_OFF_X + 2 * F_TILE;
constexpr uint32_t DKV_OFF_BAR = DKV_OFF_STAT + 2 * 2 * BQ * 4;
constexpr uint32_t DKV_F32_SMEM = DKV_OFF_BAR + 8 * 12 + 1024;   // + alignment slack

// named barriers of the P^T hand-over (0 is __syncthreads): buffer b is
// full at 1 + b and free again at 3 + b, each met by both consumer
// warpgroups (warpgroup 0 arrives on "full" and waits on "free")
constexpr int XFULL_BAR = 1, XFREE_BAR = 3;
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * THREADS) : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * THREADS) : "memory");
}

// dK and dV for one (64-key tile, head, batch); reads D from the dQ kernel.
// The two consumer warpgroups split the products: warpgroup 0 holds K (hi,
// lo) as register A fragments and per query tile forms S^T = K Q^T, P^T =
// exp2(S^T scale log2 e - LSE log2 e), hands P^T to warpgroup 1 through
// shared memory and sums dV_t = P^T dO (dO^T from the pre-pass); warpgroup
// 1 holds V and forms dP^T = V dO^T, dS^T = P^T (dP^T - D) and dK_t =
// dS^T Q (Q^T from the pre-pass). Every product has its A operand in
// registers; dK += dK_t and dV += dV_t in float32. Two hand-over buffers
// and one producer thread for each warpgroup's rings let warpgroup 0 run
// up to two query tiles ahead, so each warpgroup's elementwise work runs
// under the other's products (with one buffer both waited together each
// tile: 3% slower).
__global__ void __launch_bounds__(F_THREADS, 1)
flash_bwd_dkv_f32(const __grid_constant__ CUtensorMap rm, const __grid_constant__ CUtensorMap tr,
                  const float* __restrict__ qkv, const float* __restrict__ lse,
                  const float* __restrict__ Dbuf, float* __restrict__ dqkv, int L, int H,
                  float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + DKV_OFF_DO, sQT = base + DKV_OFF_QT;
  const uint32_t sdOT = base + DKV_OFF_DOT;
  float* sX = reinterpret_cast<float*>(smem_raw + (base - raw) + DKV_OFF_X);
  float* sStat = reinterpret_cast<float*>(smem_raw + (base - raw) + DKV_OFF_STAT);
  const uint32_t fullQ = base + DKV_OFF_BAR, emptyQ = fullQ + 16, fulldO = emptyQ + 16;
  const uint32_t emptydO = fulldO + 16, fullQT = emptydO + 16, emptyQT = fullQT + 8;
  const uint32_t fulldOT = emptyQT + 8, emptydOT = fulldOT + 8;
  const int tid = threadIdx.x, wg = tid / THREADS;
  const int k0 = blockIdx.x * BK, head = blockIdx.y, b = blockIdx.z;
  const int BH = gridDim.y * gridDim.z, bh = b * gridDim.y + head;
  const int nq = (L + BQ - 1) / BQ;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      // the TMA's and the 32 lanes that write the stage's statistics
      mbar_init_count(fullQ + 8 * s, 1 + 32);
      mbar_init_count(fulldO + 8 * s, 1 + 32);
      mbar_init_count(emptyQ + 8 * s, 4);    // the warps of the warpgroup that reads it
      mbar_init_count(emptydO + 8 * s, 4);
    }
    mbar_init(fullQT);
    mbar_init(fulldOT);
    mbar_init_count(emptyQT, 4);
    mbar_init_count(emptydOT, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: warp 0 keeps warpgroup 0's rings (Q with the tile's
    // LSE log2 e, +inf past L so that P = 0; dO^T), warp 1 warpgroup 1's
    // (dO with D, 0 past L; Q^T); per query tile j the two-stage ring's
    // stage, then the single stage. The statistics come through shared
    // memory: read from device memory in each consumer thread, their
    // latency cost 0.7 of 1.8 ms.
    setmaxnreg_dec<40>();
    const int w = (tid - 2 * THREADS) / 32, lane = tid % 32;
    if (w < 2) {
      const uint32_t ring = w == 0 ? sQ : sdO, single = w == 0 ? sdOT : sQT;
      const uint32_t full = w == 0 ? fullQ : fulldO, empty = w == 0 ? emptyQ : emptydO;
      const uint32_t full1 = w == 0 ? fulldOT : fullQT, empty1 = w == 0 ? emptydOT : emptyQT;
      const int rop = w == 0 ? OP_Q : OP_DO, top = w == 0 ? TR_DO : TR_Q;
      const float* src = (w == 0 ? lse : Dbuf) + (static_cast<size_t>(b) * H + head) * L;
      const float mul = w == 0 ? LOG2E : 1.f, pad = w == 0 ? CUDART_INF_F : 0.f;
      for (int j = 0; j < nq; ++j) {
        const int st = j % 2;
        if (j >= 2) mbar_wait(empty + 8 * st, (j / 2 - 1) & 1);
        float* stats = sStat + (2 * w + st) * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int q = j * BQ + r;
          stats[r] = q < L ? src[q] * mul : pad;
        }
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * F_TILE);
          for (int part = 0; part < 2; ++part)
            tma_tile_f32(ring + (2 * st + part) * F_TILE, &rm, full + 8 * st, 0, j * BQ,
                         (2 * rop + part) * BH + bh);
        }
        mbar_arrive(full + 8 * st);
        if (lane == 0) {
          if (j >= 1) mbar_wait(empty1, (j - 1) & 1);
          mbar_expect_tx(full1, 2 * F_TILE);
          for (int part = 0; part < 2; ++part)
            tma_tile_f32(single + part * F_TILE, &tr, full1, j * BQ, 0,
                         (2 * top + part) * BH + bh);
        }
        __syncwarp();
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int warp = (tid % THREADS) / 32, lane = tid % 32, ltid = tid % THREADS;
  const size_t C = static_cast<size_t>(H) * HD, rs = 3 * C;
  const float sl2 = scale * LOG2E;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // K (warpgroup 0) or V (warpgroup 1) of this CTA's keys, hi and lo
  uint32_t ah[8][4], al[8][4];
  load_a_tf32(qkv + static_cast<size_t>(b) * L * rs + ((1 + wg) * H + head) * HD, rs, k0, L, ah,
              al);
  float acc[32], part[32], x[32], stq[16];   // dV or dK, this tile's share, S^T or dP^T
  uint32_t xh[8][4], xl[8][4];                // P^T or dS^T (hi, lo)
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < nq; ++t) {
    const int st = t % 2;
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    const uint32_t ring = wg == 0 ? sQ : sdO;
    const uint32_t full = wg == 0 ? fullQ : fulldO, empty = wg == 0 ? emptyQ : emptydO;
    mbar_wait(full + 8 * st, (t / 2) & 1);
    uint64_t bh_ = desc_b128(ring + 2 * st * F_TILE, 16, 1024);
    uint64_t bl_ = desc_b128(ring + (2 * st + 1) * F_TILE, 16, 1024);
    asm volatile("" : "+l"(bh_), "+l"(bl_));
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    reg_fence(x);
    reg_fence(ah);
    reg_fence(al);
    wg_fence();
    wgmma_pv_tf32(x, ah, al, bh_, bl_);
    wg_commit();
    wg_wait<0>();
    reg_fence(x);
    reg_fence(ah);
    reg_fence(al);
    // the stage's statistics at this thread's query columns 8 j + 2 (lane % 4) + e
    const float* sst = sStat + (2 * wg + st) * BQ + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(sst + 8 * j);
      stq[2 * j] = v.x;
      stq[2 * j + 1] = v.y;
    }
    release(empty + 8 * st);
    uint32_t bt;   // the transposed tile of this warpgroup's second product
    float* xb = sX + (t & 1) * 32 * THREADS;   // this tile's hand-over buffer
    if (wg == 0) {
      if (t >= 2) named_sync(XFREE_BAR + (t & 1));
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2_approx(fmaf(x[i], sl2, -stq[2 * (i >> 2) + (i & 1)]));
        xb[i * THREADS + ltid] = p;
        split_to_a(p, i, xh, xl);
      }
      named_arrive(XFULL_BAR + (t & 1));
      mbar_wait(fulldOT, t & 1);
      bt = sdOT;
    } else {
      named_sync(XFULL_BAR + (t & 1));
#pragma unroll
      for (int i = 0; i < 32; ++i)
        split_to_a(xb[i * THREADS + ltid] * (x[i] - stq[2 * (i >> 2) + (i & 1)]), i, xh, xl);
      if (t + 2 < nq) named_arrive(XFREE_BAR + (t & 1));
      mbar_wait(fullQT, t & 1);
      bt = sQT;
    }
    // dV_t = P^T dO (warpgroup 0) or dK_t = dS^T Q (warpgroup 1)
    uint64_t th = desc_b128(bt, 16, 1024), tl = desc_b128(bt + F_TILE, 16, 1024);
    asm volatile("" : "+l"(th), "+l"(tl));
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    reg_fence(part);
    reg_fence(xh);
    reg_fence(xl);
    wg_fence();
    wgmma_pv_tf32(part, xh, xl, th, tl);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(xh);
    reg_fence(xl);
    release(wg == 0 ? emptydOT : emptyQT);
    add_to(acc, part);
  }
  // warpgroup 0 writes dV, warpgroup 1 dK (times the scale); keys at or
  // past L are never written
  const float s = wg == 0 ? 1.f : scale;
  const int slot = (wg == 0 ? 2 : 1) * H + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= L) continue;
    float* dst = dqkv + (static_cast<size_t>(b) * L + row) * rs + slot * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * r] * s, acc[4 * j + 2 * r + 1] * s);
  }
}

// dynamic shared memory up to `bytes`, and all of the SM's unified memory
// as shared memory (several CTAs per SM)
template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

int launch_bf16(const void* qkv, void* out, float* lse, int B, int L, int H, float scale,
                void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  if (!encode_map(encode, &map, qkv, 3 * H, L, B)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_qkv_kernel, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_qkv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<__nv_bfloat16*>(out), lse, L, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the tensor maps of the bf16 backward: the packed qkv and dout
int backward_maps(const void* qkv, const void* dout, int B, int L, int H, CUtensorMap* mq,
                  CUtensorMap* mo) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (!encode_map(encode, mq, qkv, 3 * H, L, B) || !encode_map(encode, mo, dout, H, L, B))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launch, or the
// error that kept it from launching. Layouts: qkv (B, L, 3, H, 64) and
// dqkv the same; out and dout (B, L, H, 64); lse and D (B, H, L) float32.
// All contiguous; the bf16 forward needs qkv 16-byte aligned, the backward
// qkv, out and dout.

// the serving call: bf16, no statistics
extern "C" int flash_attn_qkv_forward(const void* qkv, void* out, int B, int L, int H,
                                      float scale, void* stream) {
  return launch_bf16(qkv, out, nullptr, B, L, H, scale, stream);
}

// bf16 with the per-row log-sum-exp, for training
extern "C" int flash_attn_qkv_forward_lse(const void* qkv, void* out, void* lse, int B, int L,
                                          int H, float scale, void* stream) {
  return launch_bf16(qkv, out, static_cast<float*>(lse), B, L, H, scale, stream);
}

// rows of each scratch plane of the float32 forward: L rounded up to 128
extern "C" int flash_attn_f32_rows(int L) { return (L + F_ROWS - 1) / F_ROWS * F_ROWS; }

// float32, three TF32 passes; lse may be null; ws: scratch of
// 6 B H flash_attn_f32_rows(L) 64 floats, 16-byte aligned
extern "C" int flash_attn_qkv_forward_f32(const void* qkv, void* out, void* lse, void* ws, int B,
                                          int L, int H, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int Lp = flash_attn_f32_rows(L), BH = B * H;
  float* qk = static_cast<float*>(ws);
  float* vt = qk + static_cast<size_t>(4) * BH * Lp * HD;
  CUtensorMap mqk, mvt;
  if (!encode_f32_map(encode, &mqk, qk, HD, Lp, 4 * BH) ||
      !encode_f32_map(encode, &mvt, vt, Lp, HD, 2 * BH))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_f32_kernel, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_f32_split<<<dim3(Lp / FT, BH), FTHREADS, 0, s>>>(static_cast<const float*>(qkv), qk, vt,
                                                         L, H, Lp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_f32_kernel<<<dim3(Lp / F_ROWS, H, B), F_THREADS, F_SMEM, s>>>(
      mqk, mvt, static_cast<float*>(out), static_cast<float*>(lse), L, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

// rows of each scratch plane of the float32 backward: L rounded up to 128
extern "C" int flash_attn_bwd_f32_rows(int L) { return flash_attn_f32_rows(L); }

namespace {
// the tensor maps of the float32 backward's scratch (see RM_PLANES): the
// row-major planes and the transposed ones, boxes of 32 floats x 64 rows
int bwd_f32_maps(void* ws, int BH, int Lp, CUtensorMap* mrm, CUtensorMap* mtr) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  float* rm = static_cast<float*>(ws);
  float* tr = rm + static_cast<size_t>(RM_PLANES) * BH * Lp * HD;
  if (!encode_f32_map(encode, mrm, rm, HD, Lp, RM_PLANES * BH) ||
      !encode_f32_map(encode, mtr, tr, Lp, HD, TR_PLANES * BH))
    return (int)cudaErrorInvalidValue;
  return 0;
}
}  // namespace

// dQ into dqkv's q slots and D = rowsum(dO * O) into D; dtype 0: float32,
// 1: bf16 (qkv, out, dout and dqkv). float32 takes ws, a scratch of
// 14 B H flash_attn_bwd_f32_rows(L) 64 floats, 16-byte aligned, which the
// call's pre-pass fills and the dK/dV call reads; bf16 ignores it.
extern "C" int flash_attn_qkv_backward_dq(const void* qkv, const void* out, const void* dout,
                                          const void* lse, void* D, void* dqkv, void* ws, int B,
                                          int L, int H, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    const int Lp = flash_attn_bwd_f32_rows(L), BH = B * H;
    CUtensorMap mrm, mtr;
    int e = bwd_f32_maps(ws, BH, Lp, &mrm, &mtr);
    if (e != 0) return e;
    cudaError_t err = prepare(flash_bwd_dq_f32, (int)DQ_F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    float* rm = static_cast<float*>(ws);
    flash_bwd_f32_split<<<dim3(Lp / FT, BH, 4), FTHREADS, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), rm,
        rm + static_cast<size_t>(RM_PLANES) * BH * Lp * HD, L, H, Lp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32<<<dim3(Lp / F_ROWS, H, B), F_THREADS, DQ_F32_SMEM, s>>>(
        mrm, mtr, static_cast<const float*>(out), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dqkv), L, H, scale);
    return (int)cudaGetLastError();
  }
  const dim3 grid((L + FT - 1) / FT, H, B);
  CUtensorMap mq, mo;
  int e = backward_maps(qkv, dout, B, L, H, &mq, &mo);
  if (e != 0) return e;
  cudaError_t err = prepare(flash_bwd_dq_bf16, (int)BW_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16<<<grid, THREADS, BW_SMEM, s>>>(
      mq, mo, static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), l,
      d, static_cast<__nv_bfloat16*>(dqkv), L, H, scale);
  return (int)cudaGetLastError();
}

// dK and dV into dqkv's k and v slots; D (and in float32 the scratch ws)
// from flash_attn_qkv_backward_dq
extern "C" int flash_attn_qkv_backward_dkv(const void* qkv, const void* dout, const void* lse,
                                           const void* D, void* dqkv, void* ws, int B, int L,
                                           int H, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + FT - 1) / FT, H, B);
  if (dtype == 0) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    CUtensorMap mrm, mtr;
    int e = bwd_f32_maps(ws, B * H, flash_attn_bwd_f32_rows(L), &mrm, &mtr);
    if (e != 0) return e;
    cudaError_t err = prepare(flash_bwd_dkv_f32, (int)DKV_F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32<<<grid, F_THREADS, DKV_F32_SMEM, s>>>(
        mrm, mtr, static_cast<const float*>(qkv), l, d, static_cast<float*>(dqkv), L, H, scale);
    return (int)cudaGetLastError();
  }
  CUtensorMap mq, mo;
  int e = backward_maps(qkv, dout, B, L, H, &mq, &mo);
  if (e != 0) return e;
  cudaError_t err = prepare(flash_bwd_dkv_bf16, (int)BW_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_bf16<<<grid, THREADS, BW_SMEM, s>>>(mq, mo, l, d,
                                                    static_cast<__nv_bfloat16*>(dqkv), L, H,
                                                    scale);
  return (int)cudaGetLastError();
}
