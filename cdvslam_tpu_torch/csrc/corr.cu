// Patch correlation for the odometry update at both pyramid levels in one
// launch, forward (bf16 or f32), for C = 24 channels (CDV's XFeat features)
// and C = 128 (DPVO's BasicEncoder4 features).
//
// Replaces the TPU kernel cdvslam_tpu/ops/corr_pallas.py::_corr_pallas_planned
// (kernel body _corr_kernel_v9, entered through corr_pallas_padded and
// corr_pallas from cdvslam_tpu/slam/kernels.py::corr_op, run once per level
// by corr_features; it takes any C that is a multiple of 8). It computes
// what ops/corr.py::corr_pyramid_plain computes: for edge e, level l
// (coords / 4 at level 2) and patch pixel p, the C-channel dot of
// gmap[ii[e]][:, p] with fmap_l[jj[e]] over an 8x8 window of integer taps
// starting at floor(coords) - 3 (taps outside the image read zero), then a
// 4-tap bilinear blend with frac(x), frac(y) down to 7x7. Output
// (E, 7, 7, 3, 3, 2): x offset first, level innermost.
//
// What bounds it on the H100: memory. Per edge and level it reads a window
// of C channels (2C contiguous bytes per tap in the channels-last
// (NF, H, W, C) pyramid: 48 at C = 24, 256 at C = 128) and writes 441
// outputs, against 9 * 64 * C * 2 flops (27.6k at C = 24, 147k at C = 128):
// far below the card's flop-per-byte balance. The first design (one
// 576-thread block per edge and level, each thread one dot, three block
// barriers) ran at about a tenth of that bound, held back by per-block
// fixed cost, and it read the 9 overlapping 8x8 windows of a patch
// separately. This design:
//  - one launch for both levels: each edge's gmap column, indices and
//    coordinates are staged once and serve both; level 2 takes coords / 4
//    (exact in f32);
//  - one warp per edge at a time, no block barriers; the grid is one wave
//    of resident CTAs and each warp walks the edges with that stride,
//    requesting the next edge's indices and coordinates (and at C = 24 its
//    gmap row) before it computes the current one, so that the first
//    dependent load leaves each edge's critical path;
//  - tap reuse: the union box of a patch's 9 windows (about 10 x 10 taps at
//    level 1 and 8 x 8 at level 2 on the main path, against 9 x 64 = 576
//    separate taps) is staged once per level when it fits a 12 x 12 tile,
//    clipped to the image with zeros outside, by coalesced 16-byte cp.async
//    copies. The dots of all 9 pixels with every box tap are then
//    tensor-core products (mma.sync m16n8k16, f32 accumulation: gmap
//    column x 8 taps per instruction), which removes the bf16 unpacking
//    and the FMAs that bound a CUDA-core version of this design. A
//    stretched or scattered patch whose box does not fit, and every f32
//    call (f32 is held to the plain version in tests; the main paths run
//    bf16), reads its taps from global memory with FMAs as the first
//    design did;
//  - floor() and the fractions in f32, the dots accumulated in f32; the
//    dot volume of one level stays in shared memory, level 1's blended
//    outputs wait in registers, and the blend writes each edge's 882
//    outputs as one contiguous run, both levels of an offset in one store.
//
// C = 24 (corr_pyramid_kernel): the whole box (12 x 12 taps x 24 channels,
// 6.9 KB in bf16), the f32 gmap column and the volume take 13.5 KB per
// warp, so 8 warps per CTA and two CTAs (16 warps) fit on an SM. The gmap
// column is the A operand of two k-steps (channels 24-31 zero).
//
// C = 128 (corr_pyramid_kernel_wide): the whole box would take 36.9 KB per
// warp, so it is staged in channel chunks of 32 (9.2 KB in bf16), two
// chunks double-buffered by cp.async: chunk c + 1 (or level 2's first
// chunk) is in flight while chunk c is dotted, and the mma accumulators of
// all 18 tap tiles stay in registers across the 4 chunks of a level, so
// the dot volume is written once per level. A chunk's tap rows are 64
// bytes apart; their four 16-byte units are XOR-swizzled by the tap index
// so that ldmatrix reads them without bank conflicts. The gmap row is
// copied to shared memory by cp.async as it lies in global memory,
// (c, p), and the A fragments of each k-step are read from it. 26.4 KB
// per warp: 4 warps per CTA and two CTAs (8 warps) per SM, half the
// resident warps of C = 24, so each warp's per-edge latency (8 chunk
// stages, 144 mma pairs) is what bounds it; tuning that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int C = 24;                // channels of corr_pyramid_kernel (CDV's DIMF)
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

constexpr int CW = 128;              // channels of corr_pyramid_kernel_wide (DPVO's DIMF)
constexpr int CK = 32;               // channels per staged chunk
constexpr int NCH = CW / CK;         // chunks per level (even: chunk c uses buffer c % 2)
constexpr int NT = BOX * BOX / 8;    // tap tiles of 8 in a box
constexpr int WARPS_W = 4;           // edges per CTA of the wide kernel

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

template <typename T>
struct __align__(16) WideSmem {
  T box[sizeof(T) == 2 ? 2 * BOX * BOX * CK : 8];  // bf16: two chunk buffers, (y, x, c)
                                                   // pitch BOX, units swizzled (swz)
  T g[CW * PP];          // gmap row as it lies in global memory, (c, p)
  float vol[PP * VP];    // as WarpSmem::vol
  float fx[2][PP], fy[2][PP];
  int ix[2][PP], iy[2][PP];
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

// the 16 bytes of raw as 4 f32 or 8 bf16 channels, widened to f32
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// dot of one tap's CW channels (16-byte aligned, in global memory) with
// pixel p of the gmap row g (shared memory, (c, p)), in f32
template <typename T>
__device__ __forceinline__ float dot_tap_wide(const T* f, const T* g, int p) {
  constexpr int V = 16 / sizeof(T);
  const uint4* f16 = reinterpret_cast<const uint4*>(f);
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < CW / V; ++c) {
    float v[V];
    unpack16(__ldg(f16 + c), v);
#pragma unroll
    for (int k = 0; k < V; ++k) acc = fmaf(v[k], to_f(g[(c * V + k) * PP + p]), acc);
  }
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// channels c and c + 1 of pixel p of a bf16 gmap row laid out (c, p), as
// the two halves of one A-fragment register (channel c low)
__device__ __forceinline__ uint32_t gpair(const __nv_bfloat16* g, int p, int c) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(g);
  return static_cast<uint32_t>(h[c * PP + p]) | (static_cast<uint32_t>(h[(c + 1) * PP + p]) << 16);
}

// element offset of 16-byte unit u (channels 8u..8u+7 of a chunk) of box
// tap t in a chunk buffer: the unit index is XORed with bits 1-2 of t, so
// the 8 rows of an ldmatrix matrix (taps 8n..8n+7, one unit) fall in 8
// distinct bank groups
__device__ __forceinline__ int swz(int t, int u) { return t * CK + ((u ^ ((t >> 1) & 3)) << 3); }

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// both levels' windows of one edge with CC channels per tap: the union
// boxes in lv, and per pixel the floors, fractions and (bf16, box fits)
// volume bases in s. Every lane computes lv; lanes < PP write s.
template <int CC, typename T, class S>
__device__ __forceinline__ void setup_levels(S& s, Level<T> (&lv)[2], const T* fmap1,
                                             const T* fmap2, int fj, float x, float y, int H1,
                                             int W1, int H2, int W2, int lane) {
  constexpr bool BF16 = sizeof(T) == 2;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    lv[l].H = l ? H2 : H1;
    lv[l].W = l ? W2 : W1;
    lv[l].fb = (l ? fmap2 : fmap1) + static_cast<size_t>(fj) * lv[l].H * lv[l].W * CC;
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
}

// the bilinear blend of level l's volume. Lane m < 63 (and m + 32) owns
// the pair (x offset a, pixel p) = (m / 9, m % 9): its four weights once,
// then the 7 y offsets, each row of taps read once for two outputs.
template <class S>
__device__ __forceinline__ void blend_level(const S& s, int l, int lane, float (&res)[NQ]) {
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
}

// output (a, b, p, level) of edge e: index ((a * 7 + b) * 9 + p) * 2 + level
template <typename T>
__device__ __forceinline__ void store_edge(T* out, int e, int lane, const float (&res1)[NQ],
                                           const float (&res2)[NQ]) {
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
    setup_levels<C>(s, lv, fmap1, fmap2, fj, x, y, H1, W1, H2, W2, lane);
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
    cp_async_wait_all();
    __syncwarp();
    dots(lv[0], 0);
    __syncwarp();              // the box is free, level 1's volume written
    if (BF16 && lv[1].fits) stage(lv[1]);
    blend_level(s, 0, lane, res1);   // while level 2's box is in flight
    cp_async_wait_all();
    __syncwarp();              // level 2's box landed, level 1's volume read
    dots(lv[1], 1);
    __syncwarp();
    blend_level(s, 1, lane, res2);

    store_edge(out, e, lane, res1, res2);
    __syncwarp();  // the next edge reuses this warp's shared memory
    fj = fjn;
    x = xn;
    y = yn;
#pragma unroll
    for (int h = 0; h < GPL; ++h) graw[h] = gn[h];
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS_W * 32)
corr_pyramid_kernel_wide(const T* __restrict__ gmap,     // (K, CW, 3, 3)
                         const T* __restrict__ fmap1,    // (NF, H1, W1, CW)
                         const T* __restrict__ fmap2,    // (NF, H2, W2, CW)
                         const float* __restrict__ coords,  // (E, 2, 3, 3), level 1
                         const int* __restrict__ ii, const int* __restrict__ jj,
                         T* __restrict__ out,            // (E, 7, 7, 3, 3, 2)
                         int E, int K, int NF, int H1, int W1, int H2, int W2) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int CHUNK = BOX * BOX * CK;   // elements of one chunk buffer
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  WideSmem<T>& s = reinterpret_cast<WideSmem<T>*>(smem)[warp];
  const int stride = gridDim.x * WARPS_W;
  int e = blockIdx.x * WARPS_W + warp;
  if (e >= E) return;  // warps are independent: no block barrier below
  // the next edge's gmap row index, frame and coordinates are requested
  // before the current edge is computed
  auto fetch = [&](int ef, int& gi, int& fj, float& x, float& y) {
    gi = min(max(__ldg(ii + ef), 0), K - 1);
    fj = min(max(__ldg(jj + ef), 0), NF - 1);
    if (lane < PP) {
      x = __ldg(coords + static_cast<size_t>(ef) * 2 * PP + lane);
      y = __ldg(coords + static_cast<size_t>(ef) * 2 * PP + PP + lane);
    }
  };
  int gi = 0, fj = 0;
  float x = 0.f, y = 0.f;
  fetch(e, gi, fj, x, y);

  for (; e < E; e += stride) {
    int gin = 0, fjn = 0;
    float xn = 0.f, yn = 0.f;
    if (e + stride < E) fetch(e + stride, gin, fjn, xn, yn);

    Level<T> lv[2];
    setup_levels<CW>(s, lv, fmap1, fmap2, fj, x, y, H1, W1, H2, W2, lane);
    __syncwarp();

    // channels [c * CK, (c + 1) * CK) of the box [ymin - R, ymin - R + by) x
    // [xmin - R, xmin - R + bx) of level L into chunk buffer b (bf16 only),
    // zeros outside the image
    auto stage_chunk = [&](const Level<T>& L, int c, int b) {
      constexpr int UPT = CK * sizeof(T) / 16;   // 16-byte units per tap and chunk
      T* buf = s.box + b * CHUNK;
      for (int k = lane; k < L.bx * UPT; k += 32) {
        const int v = k / UPT, u = k - v * UPT;
        const int xx = L.xmin - R + v;
        const bool xin = xx >= 0 && xx < L.W;
        for (int r = 0; r < L.by; ++r) {
          const int yy = L.ymin - R + r;
          const bool in = xin && yy >= 0 && yy < L.H;
          const T* src =
              in ? L.fb + (static_cast<size_t>(yy) * L.W + xx) * CW + c * CK + u * 8 : L.fb;
          cp_async16(buf + swz(r * BOX + v, u), src, in);
        }
      }
    };

    // the gmap row, as it lies in global memory, with level 1's first chunk
    {
      constexpr int V = 16 / sizeof(T);
      const T* src = gmap + static_cast<size_t>(gi) * CW * PP;
      for (int k = lane; k < CW * PP / V; k += 32) cp_async16(s.g + k * V, src + k * V, true);
    }
    if (BF16 && lv[0].fits) stage_chunk(lv[0], 0, 0);
    cp_async_commit();

    // the tap dots of level l into s.vol
    auto dots = [&](int l) {
      const Level<T>& L = lv[l];
      if constexpr (BF16) {
        if (L.fits) {
          if (l == 1 && !lv[0].fits) {   // level 1 did not prefetch this chunk
            stage_chunk(L, 0, 0);
            cp_async_commit();
          }
          // every (pixel, box tap) dot, 8 taps per mma: rows = pixels,
          // columns = taps, accumulated over the chunks in registers. Taps
          // past the staged bx x by box hold stale values; their columns
          // are never read.
          const int ntiles = (L.by * BOX + 7) / 8;
          float acc[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
          const int r = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            if (c + 1 < NCH)
              stage_chunk(L, c + 1, (c + 1) % 2);
            else if (l == 0 && lv[1].fits)
              stage_chunk(lv[1], 0, 0);          // level 2's first chunk
            cp_async_commit();
            cp_async_wait_prior();               // chunk c (and the gmap row) landed
            __syncwarp();
            // A: the gmap column, 16 pixel rows (9 used) x 16 channels, for
            // the chunk's two k-steps
            uint32_t a[2][4];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int ch = c * CK + 16 * k + c2;
              a[k][0] = gpair(s.g, r, ch);
              a[k][2] = gpair(s.g, r, ch + 8);
              a[k][1] = r == 0 ? gpair(s.g, 8, ch) : 0u;   // row 8: the ninth pixel
              a[k][3] = r == 0 ? gpair(s.g, 8, ch + 8) : 0u;
            }
            const T* buf = s.box + (c % 2) * CHUNK;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (nt < ntiles) {
                uint32_t b[4];   // channels 0-7, 8-15, 16-23, 24-31 of 8 taps
                ldsm_x4(b, buf + swz(nt * 8 + lane % 8, lane / 8));
                mma_bf16(acc[nt], a[0], b[0], b[1]);
                mma_bf16(acc[nt], a[1], b[2], b[3]);
              }
            }
            __syncwarp();                        // buffer c % 2 may be refilled
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt < ntiles) {
              *reinterpret_cast<float2*>(&s.vol[r * VP + nt * 8 + c2]) =
                  make_float2(acc[nt][0], acc[nt][1]);
              if (r == 0)
                *reinterpret_cast<float2*>(&s.vol[8 * VP + nt * 8 + c2]) =
                    make_float2(acc[nt][2], acc[nt][3]);
            }
          }
          return;
        }
      }
      // f32, or a bf16 box that does not fit: every tap from global memory
      cp_async_wait_all();                       // the gmap row
      __syncwarp();
#pragma unroll 1
      for (int p = 0; p < PP; ++p) {
        const int wy = s.iy[l][p] - R, wx = s.ix[l][p] - R;
#pragma unroll
        for (int h = 0; h < D * D / 32; ++h) {
          const int t = lane + 32 * h, i = t / D, j = t % D;
          const int yy = wy + i, xx = wx + j;
          float acc = 0.f;
          if (yy >= 0 && yy < L.H && xx >= 0 && xx < L.W)
            acc = dot_tap_wide(L.fb + (static_cast<size_t>(yy) * L.W + xx) * CW, s.g, p);
          s.vol[p * VP + i * BOX + j] = acc;
        }
      }
    };

    float res1[NQ], res2[NQ];  // blended outputs of level 1 and level 2
    dots(0);
    __syncwarp();              // level 1's volume written
    blend_level(s, 0, lane, res1);   // while level 2's first chunk is in flight
    dots(1);                   // its first barrier follows the blend's reads
    __syncwarp();
    blend_level(s, 1, lane, res2);

    store_edge(out, e, lane, res1, res2);
    cp_async_wait_all();
    __syncwarp();  // the next edge reuses this warp's shared memory
    gi = gin;
    fj = fjn;
    x = xn;
    y = yn;
  }
}

// one wave of resident CTAs of kernel (WARPS_PER_CTA warps, smem bytes of
// dynamic shared memory each); each warp walks several edges
template <typename T, typename Kernel>
int launch(Kernel kernel, int warps_per_cta, int smem, const void* gmap, const void* fmap1,
           const void* fmap2, const void* coords, const void* ii, const void* jj, void* out,
           int E, int K, int NF, int H1, int W1, int H2, int W2, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's unified memory as shared memory: two CTAs per SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps_per_cta * 32,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min((E + warps_per_cta - 1) / warps_per_cta, max(per_sm, 1) * sms);
  kernel<<<grid, warps_per_cta * 32, smem, stream>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1), static_cast<const T*>(fmap2),
      static_cast<const float*>(coords), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<T*>(out), E, K, NF, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(int Cin, const void* gmap, const void* fmap1, const void* fmap2, const void* coords,
             const void* ii, const void* jj, void* out, int E, int K, int NF, int H1, int W1,
             int H2, int W2, cudaStream_t stream) {
  if (Cin == C)
    return launch<T>(corr_pyramid_kernel<T>, WARPS,
                     WARPS * static_cast<int>(sizeof(WarpSmem<T>)), gmap, fmap1, fmap2, coords,
                     ii, jj, out, E, K, NF, H1, W1, H2, W2, stream);
  return launch<T>(corr_pyramid_kernel_wide<T>, WARPS_W,
                   WARPS_W * static_cast<int>(sizeof(WideSmem<T>)), gmap, fmap1, fmap2, coords,
                   ii, jj, out, E, K, NF, H1, W1, H2, W2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Needs C == 24 or C == 128 and a 16-byte
// aligned gmap and fmaps (cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError() after the launch.
extern "C" int corr_pyramid_forward(const void* gmap, const void* fmap1, const void* fmap2,
                                    const void* coords, const void* ii, const void* jj,
                                    void* out, int E, int K, int NF, int Cin, int H1, int W1,
                                    int H2, int W2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (Cin != C && Cin != CW) ||
      reinterpret_cast<uintptr_t>(gmap) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fmap1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fmap2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (E <= 0) return (int)cudaGetLastError();
  return dtype == 0 ? launch_c<float>(Cin, gmap, fmap1, fmap2, coords, ii, jj, out, E, K, NF, H1,
                                      W1, H2, W2, s)
                    : launch_c<__nv_bfloat16>(Cin, gmap, fmap1, fmap2, coords, ii, jj, out, E, K,
                                              NF, H1, W1, H2, W2, s);
}
