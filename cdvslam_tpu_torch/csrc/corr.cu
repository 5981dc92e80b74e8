// Patch correlation for the CDV odometry update at both pyramid levels in
// one launch, forward (bf16 or f32).
//
// Replaces the TPU kernel cdvslam_tpu/ops/corr_pallas.py::_corr_pallas_planned
// (kernel body _corr_kernel_v9, entered through corr_pallas_padded and
// corr_pallas from cdvslam_tpu/slam/kernels.py::corr_op, run once per level
// by corr_features). It computes what ops/corr.py::corr_pyramid_plain
// computes: for edge e, level l (coords / 4 at level 2) and patch pixel p,
// the C-channel dot of gmap[ii[e]][:, p] with fmap_l[jj[e]] over an 8x8
// window of integer taps starting at floor(coords) - 3 (taps outside the
// image read zero), then a 4-tap bilinear blend with frac(x), frac(y) down
// to 7x7. Output (E, 7, 7, 3, 3, 2): x offset first, level innermost.
//
// What bounds it on the H100: memory. Per edge and level it reads a window
// of C = 24 channels (48 contiguous bytes per tap in the channels-last
// (NF, H, W, C) pyramid) and writes 441 outputs, against 9 * 64 * C * 2 =
// 27.6k flops: far below the card's flop-per-byte balance. The first design
// (one 576-thread block per edge and level, each thread one dot, three
// block barriers) ran at about a tenth of that bound, held back by
// per-block fixed cost, and it read the 9 overlapping 8x8 windows of a
// patch separately. This design:
//  - one launch for both levels: each edge's gmap column, indices and
//    coordinates are staged once and serve both; level 2 takes coords / 4
//    (exact in f32);
//  - one warp per edge at a time, 8 warps per CTA, no block barriers: with
//    13.5 KB of shared memory per warp (bf16), two CTAs (16 warps) fit on
//    an SM, 2,112 warps on the card. The grid is one wave of resident CTAs
//    and each warp walks the edges with that stride, requesting the next
//    edge's indices, coordinates and gmap row before it computes the
//    current one, so that the first dependent load leaves each edge's
//    critical path;
//  - tap reuse: the union box of a patch's 9 windows (about 10 x 10 taps at
//    level 1 and 8 x 8 at level 2 on the main path, against 9 x 64 = 576
//    separate taps) is staged once per level when it fits a 12 x 12 tile,
//    clipped to the image with zeros outside, by coalesced 16-byte cp.async
//    copies. The dots of all 9 pixels with every box tap are then
//    tensor-core products (mma.sync m16n8k16, f32 accumulation: gmap
//    column x 8 taps per instruction, two per tile), which removes the
//    bf16 unpacking and the 13.8k FMAs per edge and level that bound a
//    CUDA-core version of this design. A stretched or scattered patch
//    whose box does not fit, and every f32 call (f32 is held to the plain
//    version in tests; the main path runs bf16), reads its taps from
//    global memory with FMAs as the first design did;
//  - floor() and the fractions in f32, the dots accumulated in f32; the
//    dot volume of one level stays in shared memory, level 1's blended
//    outputs wait in registers, and the blend writes each edge's 882
//    outputs as one contiguous run, both levels of an offset in one store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int C = 24;                // channels (DIMF of the update operator)
constexpr int PP = 9;                // 3 x 3 patch pixels
constexpr int R = 3;
constexpr int D = 2 * R + 2;         // 8 integer taps per axis
constexpr int DO = D - 1;            // 7 blended offsets per axis
constexpr int NOUT = DO * DO * PP;   // 441 outputs per edge and level
constexpr int BOX = 12;              // staged box side, in taps
constexpr int VP = 148;              // volume pitch per pixel: >= BOX * BOX, bank spread
constexpr int WARPS = 8;             // edges per CTA
constexpr int NQ = 2 * DO;          // blended outputs per lane and level
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct __align__(16) WarpSmem {
  T box[sizeof(T) == 2 ? BOX * BOX * C : 8];  // bf16: staged taps, (y, x, c), pitch BOX
  float g[PP][C];        // gmap column, f32
  float vol[PP * VP];    // tap dots of the current level: pixel p's window
                         // tap (i, j) at p * VP + base[p] + i * BOX + j
  float fx[2][PP], fy[2][PP];
  int ix[2][PP], iy[2][PP];  // floor of the coordinates per level
  int base[2][PP];
};

// one pyramid level of one edge: the frame's feature map and the union box
// of the 9 windows
template <typename T>
struct Level {
  const T* fb;
  int H, W, xmin, ymin, bx, by;
  bool fits;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc += the 16 bytes of raw (4 f32 or 8 bf16 channels) times g[0..)
__device__ __forceinline__ void acc16(float& acc, const uint4& raw, const float* g, float) {
  acc = fmaf(__uint_as_float(raw.x), g[0], acc);
  acc = fmaf(__uint_as_float(raw.y), g[1], acc);
  acc = fmaf(__uint_as_float(raw.z), g[2], acc);
  acc = fmaf(__uint_as_float(raw.w), g[3], acc);
}
__device__ __forceinline__ void acc16(float& acc, const uint4& raw, const float* g,
                                      __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc = fmaf(__uint_as_float(w[k] << 16), g[2 * k], acc);
    acc = fmaf(__uint_as_float(w[k] & 0xffff0000u), g[2 * k + 1], acc);
  }
}

// dot of one tap's C channels (16-byte aligned, in global memory) with the
// gmap column g, in f32
template <typename T>
__device__ __forceinline__ float dot_tap(const T* f, const float (&g)[C]) {
  constexpr int V = 16 / sizeof(T);
  const uint4* f16 = reinterpret_cast<const uint4*>(f);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C / V; ++c) acc16(acc, __ldg(f16 + c), g + c * V, T());
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_pyramid_kernel(const T* __restrict__ gmap,     // (K, C, 3, 3)
                    const T* __restrict__ fmap1,    // (NF, H1, W1, C)
                    const T* __restrict__ fmap2,    // (NF, H2, W2, C)
                    const float* __restrict__ coords,  // (E, 2, 3, 3), level 1
                    const int* __restrict__ ii, const int* __restrict__ jj,
                    T* __restrict__ out,            // (E, 7, 7, 3, 3, 2)
                    int E, int K, int NF, int H1, int W1, int H2, int W2) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  WarpSmem<T>& s = reinterpret_cast<WarpSmem<T>*>(smem)[warp];
  // each warp walks the edges e, e + stride, ...; the next edge's indices,
  // coordinates and gmap row (C x 9 values, 16-byte chunks) are requested
  // before the current edge is computed
  const int stride = gridDim.x * WARPS;
  int e = blockIdx.x * WARPS + warp;
  if (e >= E) return;  // warps are independent: no block barrier below
  constexpr int GV = 16 / sizeof(T);           // values per chunk
  constexpr int GCH = C * PP / GV;             // chunks per gmap row
  constexpr int GPL = (GCH + 31) / 32;         // chunks per lane
  auto fetch = [&](int ef, int& fj, float& x, float& y, uint4 (&graw)[GPL]) {
    const int gi = min(max(__ldg(ii + ef), 0), K - 1);
    fj = min(max(__ldg(jj + ef), 0), NF - 1);
    if (lane < PP) {
      x = __ldg(coords + static_cast<size_t>(ef) * 2 * PP + lane);
      y = __ldg(coords + static_cast<size_t>(ef) * 2 * PP + PP + lane);
    }
    const uint4* gsrc =
        reinterpret_cast<const uint4*>(gmap + static_cast<size_t>(gi) * C * PP);
#pragma unroll
    for (int h = 0; h < GPL; ++h)
      if (lane + 32 * h < GCH) graw[h] = __ldg(gsrc + lane + 32 * h);
  };
  int fj = 0;
  float x = 0.f, y = 0.f;
  uint4 graw[GPL] = {};
  fetch(e, fj, x, y, graw);

  for (; e < E; e += stride) {
    int fjn = 0;
    float xn = 0.f, yn = 0.f;
    uint4 gn[GPL] = {};
    if (e + stride < E) fetch(e + stride, fjn, xn, yn, gn);

    // bf16: the gmap column as the A operand (16 pixel rows, 9 used; 32
    // channels, 24 used) of the tensor-core dots, for both levels
    uint32_t ga[2][4] = {};

    // both levels' windows first, so that level 2's box can be copied
    // while level 1 is blended
    Level<T> lv[2];
  #pragma unroll
    for (int l = 0; l < 2; ++l) {
      lv[l].H = l ? H2 : H1;
      lv[l].W = l ? W2 : W1;
      lv[l].fb = (l ? fmap2 : fmap1) + static_cast<size_t>(fj) * lv[l].H * lv[l].W * C;
      const float xs = l ? x * 0.25f : x, ys = l ? y * 0.25f : y;
      const float x0 = floorf(xs), y0 = floorf(ys);
      // clamped so that the box arithmetic cannot overflow: such a window
      // lies outside the image either way
      const int ix = static_cast<int>(fminf(fmaxf(x0, -1048576.f), 1048576.f));
      const int iy = static_cast<int>(fminf(fmaxf(y0, -1048576.f), 1048576.f));
      lv[l].xmin = __reduce_min_sync(FULL, lane < PP ? ix : INT_MAX);
      lv[l].ymin = __reduce_min_sync(FULL, lane < PP ? iy : INT_MAX);
      lv[l].bx = __reduce_max_sync(FULL, lane < PP ? ix : INT_MIN) - lv[l].xmin + D;
      lv[l].by = __reduce_max_sync(FULL, lane < PP ? iy : INT_MIN) - lv[l].ymin + D;
      lv[l].fits = lv[l].bx <= BOX && lv[l].by <= BOX;
      if (lane < PP) {
        s.fx[l][lane] = xs - x0;
        s.fy[l][lane] = ys - y0;
        s.ix[l][lane] = ix;
        s.iy[l][lane] = iy;
        s.base[l][lane] = BF16 && lv[l].fits ? (iy - lv[l].ymin) * BOX + ix - lv[l].xmin : 0;
      }
    }
    __syncwarp();

    // copy the box [ymin - R, ymin - R + by) x [xmin - R, xmin - R + bx) of a
    // level that fits, zeros outside the image; completes at cp.async.wait_all
    auto stage = [&](const Level<T>& L) {
      constexpr int CPT = C * sizeof(T) / 16;   // 16-byte chunks per tap
      constexpr int V = 16 / sizeof(T);
      for (int k = lane; k < L.bx * CPT; k += 32) {
        const int v = k / CPT, ch = k - v * CPT;
        const int xx = L.xmin - R + v;
        const bool xin = xx >= 0 && xx < L.W;
        for (int u = 0; u < L.by; ++u) {
          const int yy = L.ymin - R + u;
          const bool in = xin && yy >= 0 && yy < L.H;
          const T* src = in ? L.fb + (static_cast<size_t>(yy) * L.W + xx) * C + ch * V : L.fb;
          cp_async16(&s.box[(u * BOX + v) * C + ch * V], src, in);
        }
      }
    };

    // the tap dots of level l into s.vol
    auto dots = [&](const Level<T>& L, int l) {
      if (BF16 && L.fits) {
        // every (pixel, box tap) dot, 8 taps per mma: rows = pixels,
        // columns = taps. Taps past the staged bx x by box hold stale
        // values; their columns are never read.
        const int ntiles = (L.by * BOX + 7) / 8;
        const int mat = lane / 8;                        // channels 0-7, 8-15, 16-23, 16-23
        const T* row = s.box + (lane % 8) * C + min(mat, 2) * 8;
        const int r = lane / 4, c = 2 * (lane % 4);
  #pragma unroll 3
        for (int nt = 0; nt < ntiles; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, row + nt * 8 * C);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, ga[0], b[0], b[1]);
          mma_bf16(d, ga[1], b[2], b[3]);   // channels 24-31 of ga are zero
          *reinterpret_cast<float2*>(&s.vol[r * VP + nt * 8 + c]) = make_float2(d[0], d[1]);
          if (r == 0)
            *reinterpret_cast<float2*>(&s.vol[8 * VP + nt * 8 + c]) = make_float2(d[2], d[3]);
        }
        return;
      }
      // f32, or a bf16 box that does not fit: every tap from global memory
  #pragma unroll 1
      for (int p = 0; p < PP; ++p) {
        float g[C];
  #pragma unroll
        for (int c = 0; c < C; ++c) g[c] = s.g[p][c];
        const int wy = s.iy[l][p] - R, wx = s.ix[l][p] - R;
  #pragma unroll
        for (int h = 0; h < D * D / 32; ++h) {
          const int t = lane + 32 * h, i = t / D, j = t % D;
          const int yy = wy + i, xx = wx + j;
          float acc = 0.f;
          if (yy >= 0 && yy < L.H && xx >= 0 && xx < L.W)
            acc = dot_tap(L.fb + (static_cast<size_t>(yy) * L.W + xx) * C, g);
          s.vol[p * VP + i * BOX + j] = acc;
        }
      }
    };

    // the bilinear blend of level l's volume. Lane m < 63 (and m + 32) owns
    // the pair (x offset a, pixel p) = (m / 9, m % 9): its four weights once,
    // then the 7 y offsets, each row of taps read once for two outputs.
    auto blend = [&](int l, float (&res)[NQ]) {
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = lane + 32 * h;
        if (m >= DO * PP) break;
        const int a = m / PP, p = m % PP;
        const float dx = s.fx[l][p], dy = s.fy[l][p];
        const float w00 = (1.f - dx) * (1.f - dy), w01 = dx * (1.f - dy);
        const float w10 = (1.f - dx) * dy, w11 = dx * dy;
        const float* v = s.vol + p * VP + s.base[l][p] + a;
        float v0 = v[0], v1 = v[1];
  #pragma unroll
        for (int b = 0; b < DO; ++b) {
          const float u0 = v[(b + 1) * BOX], u1 = v[(b + 1) * BOX + 1];
          res[h * DO + b] = w00 * v0 + w01 * v1 + w10 * u0 + w11 * u1;
          v0 = u0;
          v1 = u1;
        }
      }
    };

    float res1[NQ], res2[NQ];  // blended outputs of level 1 and level 2
    if (BF16 && lv[0].fits) stage(lv[0]);

    // the gmap column, (c, p) -> s.g[p][c] in f32, while the box is copied
  #pragma unroll
    for (int h = 0; h < GPL; ++h) {
      const int k0 = (lane + 32 * h) * GV;
      if (k0 >= C * PP) break;
      const T* v = reinterpret_cast<const T*>(&graw[h]);
  #pragma unroll
      for (int i = 0; i < GV; ++i) s.g[(k0 + i) % PP][(k0 + i) / PP] = to_f(v[i]);
    }
    __syncwarp();
    if (BF16) {
      const int r = lane / 4, c = 2 * (lane % 4);
      ga[0][0] = pack_bf16(s.g[r][c], s.g[r][c + 1]);
      ga[0][2] = pack_bf16(s.g[r][c + 8], s.g[r][c + 9]);
      ga[1][0] = pack_bf16(s.g[r][c + 16], s.g[r][c + 17]);
      if (r == 0) {  // row 8: the ninth pixel
        ga[0][1] = pack_bf16(s.g[8][c], s.g[8][c + 1]);
        ga[0][3] = pack_bf16(s.g[8][c + 8], s.g[8][c + 9]);
        ga[1][1] = pack_bf16(s.g[8][c + 16], s.g[8][c + 17]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    dots(lv[0], 0);
    __syncwarp();              // the box is free, level 1's volume written
    if (BF16 && lv[1].fits) stage(lv[1]);
    blend(0, res1);            // while level 2's box is in flight
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();              // level 2's box landed, level 1's volume read
    dots(lv[1], 1);
    __syncwarp();
    blend(1, res2);

    // output (a, b, p, level) of the edge: index ((a * 7 + b) * 9 + p) * 2 + level
    T* o = out + static_cast<size_t>(e) * NOUT * 2;
  #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = lane + 32 * h;
      if (m >= DO * PP) break;
      const int a = m / PP, p = m % PP;
  #pragma unroll
      for (int b = 0; b < DO; ++b)
        store2(o + 2 * ((a * DO + b) * PP + p), res1[h * DO + b], res2[h * DO + b]);
    }
    __syncwarp();  // the next edge reuses this warp's shared memory
    fj = fjn;
    x = xn;
    y = yn;
#pragma unroll
    for (int h = 0; h < GPL; ++h) graw[h] = gn[h];
  }
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2, const void* coords,
           const void* ii, const void* jj, void* out, int E, int K, int NF, int H1, int W1,
           int H2, int W2, cudaStream_t stream) {
  const int smem = WARPS * static_cast<int>(sizeof(WarpSmem<T>));
  cudaError_t err = cudaFuncSetAttribute(corr_pyramid_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's unified memory as shared memory: two CTAs per SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(corr_pyramid_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  // one wave of resident CTAs; each warp walks several edges
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corr_pyramid_kernel<T>,
                                                        WARPS * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min((E + WARPS - 1) / WARPS, max(per_sm, 1) * sms);
  corr_pyramid_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1), static_cast<const T*>(fmap2),
      static_cast<const float*>(coords), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<T*>(out), E, K, NF, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Needs C == 24 and a 16-byte aligned
// gmap and fmaps (cudaErrorInvalidValue otherwise). Returns cudaGetLastError() after
// the launch.
extern "C" int corr_pyramid_forward(const void* gmap, const void* fmap1, const void* fmap2,
                                    const void* coords, const void* ii, const void* jj,
                                    void* out, int E, int K, int NF, int Cin, int H1, int W1,
                                    int H2, int W2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || Cin != C || reinterpret_cast<uintptr_t>(gmap) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fmap1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fmap2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (E <= 0) return (int)cudaGetLastError();
  return dtype == 0 ? launch<float>(gmap, fmap1, fmap2, coords, ii, jj, out, E, K, NF, H1, W1,
                                    H2, W2, s)
                    : launch<__nv_bfloat16>(gmap, fmap1, fmap2, coords, ii, jj, out, E, K, NF,
                                            H1, W1, H2, W2, s);
}
