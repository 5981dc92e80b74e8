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

// Online softmax of one 64-key tile held in the wgmma accumulator layout:
// s[4j + e] is row r0 (e < 2) or r0 + 8 (e >= 2), key 8j + 2 (lane % 4) + (e & 1).
// Updates the running max m and (per-thread partial) sum l, returns the
// rescale factor of the old O in alpha and P as the bf16 A fragments of the
// four k16 steps of P V.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int k0, int L, float scale_log2,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint32_t (&p)[4][4]) {
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
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    mn[r] = fmaxf(m[r], tmax[r] * scale_log2);
    alpha[r] = exp2_approx(m[r] - mn[r]);
    m[r] = mn[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2_approx(fmaf(s[4 * j], scale_log2, -mn[0]));
    const float p1 = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -mn[0]));
    const float p2 = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -mn[1]));
    const float p3 = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -mn[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    p[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_qkv_kernel(const __grid_constant__ CUtensorMap qkv, __nv_bfloat16* __restrict__ out,
                 int L, int H, float scale_log2) {
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

}  // namespace

// qkv: (B, L, 3, H, 64) contiguous bf16, 16-byte aligned; out: (B, L, H, 64)
// bf16. Returns cudaGetLastError() after the launch, or the error that kept
// it from launching.
extern "C" int flash_attn_qkv_forward(const void* qkv, void* out, int B, int L, int H,
                                      float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t row = 3ull * H * HD * 2;  // bytes per token
  const cuuint64_t dims[4] = {HD, 3ull * H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, row, row * L};
  const cuuint32_t box[4] = {HD, 1, BK, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(qkv), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  // all of the SM's unified memory as shared memory: several CTAs per SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_qkv_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_qkv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<__nv_bfloat16*>(out), L, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
