// The bundle adjustment's Gauss-Newton iteration on the card: ba/ba.py's
// ba_solve through ops/ba_cuda.py.
//
// Replaces no TPU kernel. The JAX package leaves each iteration to XLA,
// which fuses its elementwise chains; the port wrote them as plain torch,
// and on the card each of its ~300 small tensor operations an iteration
// was a kernel of its own: about 2.4 us each inside the frame's graph
// replay, for arithmetic on a few hundred kilobytes. Two kernels take their
// place:
//  - ba_linearize, one thread an edge: the edge's reprojection, residual,
//    Jacobians and gate (ba.py's _edge_terms and _validity), its weight,
//    and every row the iteration's sums read, written where the plans read
//    them: the (4E, 36) pose-pose blocks [Bii, Bjj, -Bij, -Bij^T], the
//    (2E, 6) pose-depth rows [ei, ej] and gradient rows [vi, vj], and the
//    two (E,) rows of C and u;
//  - ba_update, one thread a patch or a pose row: the depth step with the
//    inference clamps and the retraction Exp(dX) * G of the window's poses,
//    into new buffers.
// The sums, the Schur complement and the Cholesky solve between them stay
// where they were (the segment-sum kernel, segment_reduce, cuBLAS, cuSOLVER).
//
// The BA's solves carry a difference in the last bit far (a reassociated
// sum moved the poses by 0.69 of the step), so both kernels reproduce the
// plain chain's rounding operation by operation, not only its mathematics:
// each torch kernel rounds its result, so each product, sum and quotient is
// an intrinsic that rounds once (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), which the compiler never merges into a fused multiply-add,
// in torch's order of evaluation (left to right; a Python scalar in float32;
// a division by a Python scalar as torch's multiply by its float32
// reciprocal). Fused multiply-adds appear only where the torch kernel
// replaced contracts on the card: linalg.cross's a*b - c*d, the k = 2 and
// k = 3 products of cuBLAS's batched matrix products behind the einsums and
// the 3 x 3 matrix products, and the order of the reductions over 2 or 3
// elements (sum_2, sum_3). sinf, cosf and the division are the functions
// torch's elementwise kernels call.
//
// What bounds them on the H100: bytes, far below the launches they replace.
// ba_linearize reads about 90 bytes an edge and writes 680 (the rows); at
// E 10,240 that is 7.8 MB, 2.3 us at 3.35 TB/s. ba_update reads and writes
// the patch window and the pose buffer once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LIN_BLOCK = 128;
constexpr int UPD_BLOCK = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// What the torch kernels that the chain runs compute, as measured on the card
// (torch 2.11, CUDA 12.8, H100) against every order of evaluation:
//  - linalg.cross's a*b - c*d is fma(a, b, -(c*d)) (its kernel contracts);
//  - cuBLAS's batched products: the einsum's (6 x 2) @ (2 x 6) blocks are
//    fma(a1, b1, fma(a0, b0, 0)), its (1 x 2) @ (2 x 6) rows two products
//    added from 0, (0 + a0 b0) + a1 b1; the 3 x 3 products of
//    so3_left_jacobian fma(a2, b2, fma(a1, b1, fma(a0, b0, 0))) and its
//    (3 x 3) @ (3 x 1) fma(a1, b1, fma(a0, b0, 0)) + a2 b2;
//  - torch.sum over a last dimension of 2 is (0 + a0) + a1, of 3
//    ((0 + a0) + a2) + a1 (two threads: a0 and a2 on one);
//  - sinf, cosf, sqrtf and the division are correctly rounded where torch's
//    are (their bits agree), and a division by a Python scalar is a product
//    with its float32 reciprocal.
// Each sum "from 0" reads +0 where the plain chain's would read -0.
__device__ __forceinline__ float fma0(float a, float b) { return __fmaf_rn(a, b, 0.0f); }

__device__ __forceinline__ float xterm(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}

// (6 x 2) @ (2 x 6) and (1 x 2) @ (2 x 6) entries
__device__ __forceinline__ float dot2_block(float a0, float b0, float a1, float b1) {
  return __fmaf_rn(a1, b1, fma0(a0, b0));
}
__device__ __forceinline__ float dot2_row(float a0, float b0, float a1, float b1) {
  return add(add(0.0f, mul(a0, b0)), mul(a1, b1));
}

// (3 x 3) @ (3 x 3) and (3 x 3) @ (3 x 1) entries
__device__ __forceinline__ float dot3_mat(float a0, float b0, float a1, float b1, float a2,
                                          float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, fma0(a0, b0)));
}
__device__ __forceinline__ float dot3_vec(float a0, float b0, float a1, float b1, float a2,
                                          float b2) {
  return add(__fmaf_rn(a1, b1, fma0(a0, b0)), fma0(a2, b2));
}

__device__ __forceinline__ float sum_2(float a0, float a1) { return add(add(0.0f, a0), a1); }
__device__ __forceinline__ float sum_3(float a0, float a1, float a2) {
  return add(add(add(0.0f, a0), a2), a1);
}

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {xterm(a.y, b.z, a.z, b.y), xterm(a.z, b.x, a.x, b.z), xterm(a.x, b.y, a.y, b.x)};
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }

__device__ __forceinline__ Q4 qconj(Q4 q) { return {-q.x, -q.y, -q.z, q.w}; }

// quaternion.qmul: each product and sum rounded, left to right
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {sub(add(add(mul(a.w, b.x), mul(a.x, b.w)), mul(a.y, b.z)), mul(a.z, b.y)),
          sub(add(add(mul(a.w, b.y), mul(a.y, b.w)), mul(a.z, b.x)), mul(a.x, b.z)),
          sub(add(add(mul(a.w, b.z), mul(a.z, b.w)), mul(a.x, b.y)), mul(a.y, b.x)),
          sub(sub(sub(mul(a.w, b.w), mul(a.x, b.x)), mul(a.y, b.y)), mul(a.z, b.z))};
}

// quaternion.qrot: p + qw * uv + cross(qv, uv), uv = 2 cross(qv, p)
__device__ __forceinline__ V3 qrot(Q4 q, V3 p) {
  const V3 qv = {q.x, q.y, q.z};
  const V3 c = cross(qv, p);
  const V3 uv = {mul(2.0f, c.x), mul(2.0f, c.y), mul(2.0f, c.z)};
  const V3 c2 = cross(qv, uv);
  return {add(add(p.x, mul(q.w, uv.x)), c2.x), add(add(p.y, mul(q.w, uv.y)), c2.y),
          add(add(p.z, mul(q.w, uv.z)), c2.z)};
}

__device__ __forceinline__ void store36(float* dst, const float (&m)[36]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 9; ++q) d[q] = make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
}

__device__ __forceinline__ void store6(float* dst, const float (&v)[6]) {
  float2* d = reinterpret_cast<float2*>(dst);
#pragma unroll
  for (int q = 0; q < 3; ++q) d[q] = make_float2(v[2 * q], v[2 * q + 1]);
}

// torch.einsum("er,eri,erj->eij", w, Ja, Jb): w * Ja, then cuBLAS's k = 2
// product with Jb. neg: the block's negation (-blk), trans: its transpose
__device__ __forceinline__ void block(const float (&w)[2], const float (&Ja)[2][6],
                                      const float (&Jb)[2][6], bool neg, bool trans,
                                      float* dst) {
  float m[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float a0 = mul(w[0], Ja[0][i]), a1 = mul(w[1], Ja[1][i]);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float v = dot2_block(a0, Jb[0][j], a1, Jb[1][j]);
      m[trans ? 6 * j + i : 6 * i + j] = neg ? -v : v;
    }
  }
  store36(dst, m);
}

// ba.py's _edge_terms, _validity and the iteration's rows, edge e
__global__ void __launch_bounds__(LIN_BLOCK)
ba_linearize_kernel(const float* __restrict__ poses, const float* __restrict__ patches,
                    const float* __restrict__ intr, const float* __restrict__ target,
                    const float* __restrict__ weight, const long long* __restrict__ ii,
                    const long long* __restrict__ jj, const long long* __restrict__ kk,
                    const bool* __restrict__ mask, int E, int P, float z_min, float res_thresh,
                    float margin, float* __restrict__ rows_b, float* __restrict__ rows_e,
                    float* __restrict__ rows_v, float* __restrict__ row_c,
                    float* __restrict__ row_u) {
  const int e = blockIdx.x * LIN_BLOCK + threadIdx.x;
  if (e >= E) return;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const float* gi = poses + ii[e] * 7;
  const float* gj = poses + jj[e] * 7;
  const V3 ti = {gi[0], gi[1], gi[2]}, tj = {gj[0], gj[1], gj[2]};
  const Q4 qi = {gi[3], gi[4], gi[5], gi[6]}, qj = {gj[3], gj[4], gj[5], gj[6]};
  const Q4 qij = qmul(qj, qconj(qi));
  const V3 tij = sub3(tj, qrot(qij, ti));

  const long long plane = (long long)P * P;
  const float* pc = patches + kk[e] * 3 * plane + (P / 2) * P + P / 2;
  const float xn = dvd(sub(pc[0], cx), fx);
  const float yn = dvd(sub(pc[plane], cy), fy);
  const float d0 = pc[2 * plane];
  const V3 rX = qrot(qij, {xn, yn, 1.0f});
  const float X = add(rX.x, mul(d0, tij.x));
  const float Y = add(rX.y, mul(d0, tij.y));
  const float Z = add(rX.z, mul(d0, tij.z));
  const float W = d0;

  const float Zs = fabsf(Z) > 1e-8f ? Z : 1e-8f;
  // 1.0 / Z_safe: torch's reciprocal, then times 1.0
  const float d = Z >= z_min ? mul(dvd(1.0f, Zs), 1.0f) : 0.0f;
  const float d2 = mul(d, d);
  const float x1 = add(mul(fx, dvd(X, Zs)), cx);
  const float y1 = add(mul(fy, dvd(Y, Zs)), cy);
  const float r0 = sub(target[2 * e], x1), r1 = sub(target[2 * e + 1], y1);

  const float nfx = -fx, nfy = -fy;
  float Jj[2][6], Ji[2][6];
  Jj[0][0] = mul(mul(fx, W), d);
  Jj[0][1] = 0.0f;
  Jj[0][2] = mul(mul(mul(nfx, X), W), d2);
  Jj[0][3] = mul(mul(mul(nfx, X), Y), d2);
  Jj[0][4] = mul(fx, add(mul(mul(X, X), d2), 1.0f));
  Jj[0][5] = mul(mul(nfx, Y), d);
  Jj[1][0] = 0.0f;
  Jj[1][1] = mul(mul(fy, W), d);
  Jj[1][2] = mul(mul(mul(nfy, Y), W), d2);
  Jj[1][3] = mul(nfy, add(mul(mul(Y, Y), d2), 1.0f));
  Jj[1][4] = mul(mul(mul(fy, X), Y), d2);
  Jj[1][5] = mul(mul(fy, X), d);
  const float Jz[2] = {mul(fx, sub(mul(tij.x, d), mul(mul(tij.z, X), d2))),
                       mul(fy, sub(mul(tij.y, d), mul(mul(tij.z, Y), d2)))};
  // se3_adjT((tij, qij), Jj) per row: [R^T a_t ; R^T (a_phi - t x a_t)]
  const Q4 qinv = qconj(qij);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const V3 at = {Jj[r][0], Jj[r][1], Jj[r][2]}, aphi = {Jj[r][3], Jj[r][4], Jj[r][5]};
    const V3 top = qrot(qinv, at);
    const V3 bot = qrot(qinv, sub3(aphi, cross(tij, at)));
    Ji[r][0] = top.x, Ji[r][1] = top.y, Ji[r][2] = top.z;
    Ji[r][3] = bot.x, Ji[r][4] = bot.y, Ji[r][5] = bot.z;
  }

  // _validity (inference): the residual's norm, the depth, the margin
  const float rn = __fsqrt_rn(sum_2(mul(r0, r0), mul(r1, r1)));
  const float xmax = add(mul(2.0f, cx), margin), ymax = add(mul(2.0f, cy), margin);
  const bool ok = rn < res_thresh && Z > z_min && x1 > -margin && y1 > -margin && x1 < xmax &&
                  y1 < ymax && mask[e];
  const float okf = ok ? 1.0f : 0.0f;
  const float w[2] = {mul(weight[2 * e], okf), mul(weight[2 * e + 1], okf)};
  const float rm[2] = {ok ? r0 : 0.0f, ok ? r1 : 0.0f};

  block(w, Ji, Ji, false, false, rows_b + (long long)e * 36);
  block(w, Jj, Jj, false, false, rows_b + ((long long)E + e) * 36);
  block(w, Ji, Jj, true, false, rows_b + (2LL * E + e) * 36);
  block(w, Ji, Jj, true, true, rows_b + (3LL * E + e) * 36);

  // einsum("er,eri,er->ei", w, J, Jz): w * J, then the k = 2 product with Jz;
  // einsum("er,eri->ei", w * r, J): the k = 2 product of w * r with J
  const float wr[2] = {mul(w[0], rm[0]), mul(w[1], rm[1])};
  float ei[6], ej[6], vi[6], vj[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    ei[i] = -dot2_row(Jz[0], mul(w[0], Ji[0][i]), Jz[1], mul(w[1], Ji[1][i]));
    ej[i] = dot2_row(Jz[0], mul(w[0], Jj[0][i]), Jz[1], mul(w[1], Jj[1][i]));
    vi[i] = -dot2_row(wr[0], Ji[0][i], wr[1], Ji[1][i]);
    vj[i] = dot2_row(wr[0], Jj[0][i], wr[1], Jj[1][i]);
  }
  store6(rows_e + (long long)e * 6, ei);
  store6(rows_e + ((long long)E + e) * 6, ej);
  store6(rows_v + (long long)e * 6, vi);
  store6(rows_v + ((long long)E + e) * 6, vj);
  row_c[e] = sum_2(mul(mul(w[0], Jz[0]), Jz[0]), mul(mul(w[1], Jz[1]), Jz[1]));
  row_u[e] = sum_2(mul(wr[0], Jz[0]), mul(wr[1], Jz[1]));
}

// lie.se3_retr(g, xi) = se3_mul(se3_exp(xi), g) in the plain chain's order
__device__ void se3_retr(const float* g, const float* xi, float* out) {
  const float EPS2 = (float)(1e-6 * 1e-6);
  const V3 tau = {xi[0], xi[1], xi[2]};
  const float a = xi[3], b = xi[4], c = xi[5];
  const float th2 = sum_3(mul(a, a), mul(b, b), mul(c, c));
  const bool small = th2 < EPS2;
  const float th = __fsqrt_rn(small ? 1.0f : th2);
  // quat_exp
  const float th4 = mul(th2, th2);
  const float half = mul(th, 0.5f);
  const float imag = small ? add(sub(0.5f, mul(th2, (float)(1.0 / 48.0))),
                                 mul(th4, (float)(1.0 / 3840.0)))
                           : dvd(sinf(half), th);
  const float real = small ? add(sub(1.0f, mul(th2, (float)(1.0 / 8.0))),
                                 mul(th4, (float)(1.0 / 384.0)))
                           : cosf(half);
  const Q4 q = {mul(imag, a), mul(imag, b), mul(imag, c), real};
  // so3_left_jacobian: eye + coef1 Phi + coef2 Phi @ Phi
  const float coef1 = small ? sub(0.5f, mul(th2, 1.0f / 24.0f))
                            : dvd(sub(1.0f, cosf(th)), small ? 1.0f : th2);
  const float coef2 = small ? sub((float)(1.0 / 6.0), mul(th2, 1.0f / 120.0f))
                            : dvd(sub(th, sinf(th)), small ? 1.0f : mul(th2, th));
  const float Phi[3][3] = {{0.0f, -c, b}, {c, 0.0f, -a}, {-b, a, 0.0f}};
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float pp = dot3_mat(Phi[i][0], Phi[0][j], Phi[i][1], Phi[1][j], Phi[i][2],
                                       Phi[2][j]);
      J[i][j] = add(add(i == j ? 1.0f : 0.0f, mul(coef1, Phi[i][j])), mul(coef2, pp));
    }
  }
  const V3 t = {dot3_vec(J[0][0], tau.x, J[0][1], tau.y, J[0][2], tau.z),
                dot3_vec(J[1][0], tau.x, J[1][1], tau.y, J[1][2], tau.z),
                dot3_vec(J[2][0], tau.x, J[2][1], tau.y, J[2][2], tau.z)};
  // se3_mul((t, q), g)
  const V3 tg = {g[0], g[1], g[2]};
  const Q4 qg = {g[3], g[4], g[5], g[6]};
  const V3 tn = add3(t, qrot(q, tg));
  const Q4 qn = qmul(q, qg);
  out[0] = tn.x, out[1] = tn.y, out[2] = tn.z;
  out[3] = qn.x, out[4] = qn.y, out[5] = qn.z, out[6] = qn.w;
}

// threads [0, K): patch t, its depth step (reset above 20, floor 1e-4 where
// touched) into every pixel of channel 2, channels 0 and 1 copied;
// threads [K, K + NP) with dX: pose row p, the retraction of window row
// p - win_rows[0] when it lies in the window, else a copy
__global__ void __launch_bounds__(UPD_BLOCK)
ba_update_kernel(const float* __restrict__ poses, const float* __restrict__ patches,
                 const float* __restrict__ dX, const float* __restrict__ dZ,
                 const bool* __restrict__ touched, const long long* __restrict__ win_rows,
                 int NP, int N, int K, int plane, float* __restrict__ poses_out,
                 float* __restrict__ patches_out) {
  const long long t = (long long)blockIdx.x * UPD_BLOCK + threadIdx.x;
  if (t < K) {
    const float* src = patches + t * 3 * plane;
    float* dst = patches_out + t * 3 * plane;
    for (int q = 0; q < 2 * plane; ++q) dst[q] = src[q];
    const float d_old = src[2 * plane];
    float dn = add(d_old, dZ[t]);
    dn = dn > 20.0f ? 1.0f : dn;
    const float lo = isnan(dn) ? dn : fmaxf(dn, 1e-4f);
    dn = touched[t] ? lo : d_old;
    for (int q = 0; q < plane; ++q) dst[2 * plane + q] = dn;
    return;
  }
  if (dX == nullptr || t >= (long long)K + NP) return;
  const int p = (int)(t - K);
  const long long s = win_rows[0];
  const float* g = poses + (long long)p * 7;
  float* o = poses_out + (long long)p * 7;
  if (s < NP && p >= s && p - s < N) {
    se3_retr(g, dX + (p - s) * 6, o);
  } else {
#pragma unroll
    for (int q = 0; q < 7; ++q) o[q] = g[q];
  }
}

}  // namespace

// One edge a thread: poses (NP, 7), patches (K, 3, P, P), intr (4,), target
// and weight (E, 2) float32; ii, jj, kk (E,) int64 in range; mask (E,) bool.
// Writes rows_b (4E, 36), rows_e (2E, 6), rows_v (2E, 6), row_c and row_u
// (E,), all contiguous and 16-byte aligned.
extern "C" int ba_linearize_forward(const void* poses, const void* patches, const void* intr,
                                    const void* target, const void* weight, const void* ii,
                                    const void* jj, const void* kk, const void* mask, int E,
                                    int P, float z_min, float res_thresh, float margin,
                                    void* rows_b, void* rows_e, void* rows_v, void* row_c,
                                    void* row_u, void* stream) {
  if (E <= 0 || P <= 0) return cudaErrorInvalidValue;
  ba_linearize_kernel<<<(E + LIN_BLOCK - 1) / LIN_BLOCK, LIN_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses), static_cast<const float*>(patches),
      static_cast<const float*>(intr), static_cast<const float*>(target),
      static_cast<const float*>(weight), static_cast<const long long*>(ii),
      static_cast<const long long*>(jj), static_cast<const long long*>(kk),
      static_cast<const bool*>(mask), E, P, z_min, res_thresh, margin,
      static_cast<float*>(rows_b), static_cast<float*>(rows_e), static_cast<float*>(rows_v),
      static_cast<float*>(row_c), static_cast<float*>(row_u));
  return cudaGetLastError();
}

// The iteration's update: dX (6N,) or null (depths alone: poses_out is not
// written), dZ (K,), touched (K,) bool, win_rows (N,) int64 (the window's
// rows, NP where past the buffer); poses_out (NP, 7) and patches_out
// (K, 3, P, P) contiguous.
extern "C" int ba_update_forward(const void* poses, const void* patches, const void* dX,
                                 const void* dZ, const void* touched, const void* win_rows,
                                 int NP, int N, int K, int P, void* poses_out,
                                 void* patches_out, void* stream) {
  if (NP <= 0 || N <= 0 || K < 0 || P <= 0) return cudaErrorInvalidValue;
  const long long threads = (long long)K + (dX != nullptr ? NP : 0);
  if (threads == 0) return cudaSuccess;
  ba_update_kernel<<<(unsigned)((threads + UPD_BLOCK - 1) / UPD_BLOCK), UPD_BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses), static_cast<const float*>(patches),
      static_cast<const float*>(dX), static_cast<const float*>(dZ),
      static_cast<const bool*>(touched), static_cast<const long long*>(win_rows), NP, N, K,
      P * P, static_cast<float*>(poses_out), static_cast<float*>(patches_out));
  return cudaGetLastError();
}
