// Schur-complement preparation for bundle adjustment: everything that is
// per observation or per point in one LM build, in one kernel.
//
// Replaces the Pallas TPU kernel optim/ba_pallas.py::_prep_kernel of the JAX
// package (launched by prep_terms). Per observation slot: gather the observing
// pose, quaternion transform, stereo / mono reprojection residual, chi2, Huber
// weight and robust cost, the Jacobians Jc (3x6, pose twist) and Jp (3x3,
// point). Per point: Hpp = sum_m Jp^T w Jp and bp = -sum_m Jp^T w r, Hpp
// damped by (1 + lambda) + 1e-8 on the diagonal and inverted as a symmetric
// 3x3. Then per slot again: Wb = Jc^T w Jp, Y = Wb Hpp^-1, Ht = Jc^T w Jc,
// bt = -Jc^T w r, Ybp = Y bp. The same kernel is the cost-only evaluator of
// the LM accept test (mode cost_only: residual, chi2 and robust cost, nothing
// else computed or written).
//
// What bounds it on an H100: bytes, and how they are written. An active slot
// reads 21 bytes and writes 71 floats, against about 600 float operations.
// The work is sparse: a local BA's map lists about 2,000 of the P = 32768
// points, with one or two of the M = 24 slots each. A thread per point over
// all P (the first design, kept below as ba_prep_launch_v1) leaves most
// blocks without work and runs each point's slots in a serial chain: on such
// a map it is bound by that chain. On a dense or random mask both that design
// and one that writes only the active slots are bound by partial 32-byte
// sectors (a row of a point holds a few active slots among 24), which the
// memory system writes at a fraction of its rate.
//
// The design:
// - The points that have at least one active slot are listed once per solve
//   (ba_prep_compact below, one block), ascending, with their count in device
//   memory; the launch is persistent (a fixed grid: the SM count times the
//   blocks an SM holds), its warps stride over the list up to that count, so
//   no launch shape depends on the host.
// - One warp per listed point, lane m = slot m (M <= 32). For M <= 16 the
//   warp carries 32 / seg points, seg = the power of two >= M lanes each
//   (measured: four points a warp beat one at M = 8). Each lane requests its
//   slot's inputs before testing its flag, evaluates the slot once and keeps
//   the residual, the weight and the Jacobians in registers.
// - Hpp (6 values) and bp (3) are summed over the point's lanes by one fixed
//   tree (shuffle down, lane 0 ends with the sum) and broadcast from lane 0,
//   so every lane holds the same bits and two launches agree bit for bit.
//   Every lane then inverts the damped 3x3 block itself.
// - Arrays are point-major, [*, P, M], the problem's own layout: each of the
//   71 stores of a point is one contiguous run of M floats, and the assembly
//   reads them without a copy.
// - A listed point writes whole rows: every one of its M slots, zeros where
//   a slot is inactive for the solve or behind the camera at this iterate
//   (its cost is then 0 too; chi2 is that of the slot when it is active).
//   Neighbouring listed points then fill whole lines, and all lanes run one
//   store path (values are selected, not branched on). Points without an
//   active slot are never written: the wrapper zero-fills the outputs once
//   per solve. Only the 21 upper-triangle entries of the symmetric Ht are
//   written. lambda is read from device memory, so the LM loop never waits
//   for the host. No atomics.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsV1 = 128;     // thread-per-point kernels
constexpr int kWarpBlock = 256;     // warp-per-point kernels: 8 warps a block
constexpr int kWarpBlocksPerSm = 3;
constexpr int kMaxSlots = 32;       // one lane per slot
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf, d2m, d2s;
  int use_huber;
};

// One slot's residual, weight and the projection Jacobian rows.
struct Obs {
  float X, Y, Z;        // camera-frame point
  float r[3];           // residual (row 2 zero for mono)
  float chi2, w, rho;   // rho already multiplied by `active`
  float A[3][3];        // -dproj/dpc
  float R[9];           // rotation of the observing pose
  bool active;
};

__device__ __forceinline__ void eval_obs(const float* __restrict__ qt, int kf,
                                         float px, float py, float pz,
                                         float ou, float ov, float our,
                                         float isig, bool stereo,
                                         const Cam& c, bool want_jac, Obs& o) {
  const float* g = qt + 7 * kf;
  const float qw = __ldg(g), qx = __ldg(g + 1), qy = __ldg(g + 2),
              qz = __ldg(g + 3);
  const float cx1 = 2.0f * (qy * pz - qz * py);
  const float cy1 = 2.0f * (qz * px - qx * pz);
  const float cz1 = 2.0f * (qx * py - qy * px);
  o.X = px + qw * cx1 + (qy * cz1 - qz * cy1) + __ldg(g + 4);
  o.Y = py + qw * cy1 + (qz * cx1 - qx * cz1) + __ldg(g + 5);
  o.Z = pz + qw * cz1 + (qx * cy1 - qy * cx1) + __ldg(g + 6);
  o.active = o.Z > 0.01f;
  const float z = fmaxf(o.Z, 1e-6f);
  const float iz = 1.0f / z;
  const float u = c.fx * o.X * iz + c.cx;
  const float v = c.fy * o.Y * iz + c.cy;
  const float ur = u - c.bf * iz;
  o.r[0] = ou - u;
  o.r[1] = ov - v;
  o.r[2] = stereo ? our - ur : 0.0f;
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * isig;
  const float act = o.active ? 1.0f : 0.0f;
  float w_rob = 1.0f, rho = o.chi2;
  if (c.use_huber) {
    const float d2 = stereo ? c.d2s : c.d2m;
    const float cl = fmaxf(o.chi2, 1e-12f);
    w_rob = fminf(1.0f, sqrtf(d2 / cl));
    rho = o.chi2 <= d2 ? o.chi2 : 2.0f * sqrtf(d2) * sqrtf(cl) - d2;
  }
  o.w = isig * w_rob * act;
  o.rho = rho * act;
  if (!want_jac) return;
  const float iz2 = iz * iz;
  o.A[0][0] = -c.fx * iz; o.A[0][1] = 0.0f; o.A[0][2] = c.fx * o.X * iz2;
  o.A[1][0] = 0.0f; o.A[1][1] = -c.fy * iz; o.A[1][2] = c.fy * o.Y * iz2;
  o.A[2][0] = stereo ? -c.fx * iz : 0.0f;
  o.A[2][1] = 0.0f;
  o.A[2][2] = stereo ? c.fx * o.X * iz2 - c.bf * iz2 : 0.0f;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  o.R[0] = 1.0f - 2.0f * (yy + zz); o.R[1] = 2.0f * (xy - wz);
  o.R[2] = 2.0f * (xz + wy);        o.R[3] = 2.0f * (xy + wz);
  o.R[4] = 1.0f - 2.0f * (xx + zz); o.R[5] = 2.0f * (yz - wx);
  o.R[6] = 2.0f * (xz - wy);        o.R[7] = 2.0f * (yz + wx);
  o.R[8] = 1.0f - 2.0f * (xx + yy);
}

// Jp = A R (3x3)
__device__ __forceinline__ void point_jac(const Obs& o, float (&Jp)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Jp[r][c] = o.A[r][0] * o.R[c] + o.A[r][1] * o.R[3 + c] +
                 o.A[r][2] * o.R[6 + c];
  }
}

// Jc = A [I | -hat(pc)] (3x6)
__device__ __forceinline__ void pose_jac(const Obs& o, float (&Jc)[3][6]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float a0 = o.A[r][0], a1 = o.A[r][1], a2 = o.A[r][2];
    Jc[r][0] = a0; Jc[r][1] = a1; Jc[r][2] = a2;
    Jc[r][3] = a2 * o.Y - a1 * o.Z;
    Jc[r][4] = a0 * o.Z - a2 * o.X;
    Jc[r][5] = a1 * o.X - a0 * o.Y;
  }
}

// The point block's 6 Hpp and 3 bp contributions of one slot.
__device__ __forceinline__ void point_terms(const Obs& o,
                                            const float (&Jp)[3][3],
                                            float (&s)[9]) {
  s[0] = (Jp[0][0] * Jp[0][0] + Jp[1][0] * Jp[1][0] + Jp[2][0] * Jp[2][0]) * o.w;
  s[1] = (Jp[0][0] * Jp[0][1] + Jp[1][0] * Jp[1][1] + Jp[2][0] * Jp[2][1]) * o.w;
  s[2] = (Jp[0][0] * Jp[0][2] + Jp[1][0] * Jp[1][2] + Jp[2][0] * Jp[2][2]) * o.w;
  s[3] = (Jp[0][1] * Jp[0][1] + Jp[1][1] * Jp[1][1] + Jp[2][1] * Jp[2][1]) * o.w;
  s[4] = (Jp[0][1] * Jp[0][2] + Jp[1][1] * Jp[1][2] + Jp[2][1] * Jp[2][2]) * o.w;
  s[5] = (Jp[0][2] * Jp[0][2] + Jp[1][2] * Jp[1][2] + Jp[2][2] * Jp[2][2]) * o.w;
#pragma unroll
  for (int b = 0; b < 3; ++b)
    s[6 + b] = -(Jp[0][b] * o.r[0] + Jp[1][b] * o.r[1] + Jp[2][b] * o.r[2]) * o.w;
}

// Damped symmetric 3x3 inverse of the summed h (00, 01, 02, 11, 12, 22).
__device__ __forceinline__ void damped_inverse(const float* h, float lam,
                                               float (&Hi)[3][3]) {
  const float h00 = h[0] * (1.0f + lam) + 1e-8f, h01 = h[1], h02 = h[2];
  const float h11 = h[3] * (1.0f + lam) + 1e-8f, h12 = h[4];
  const float h22 = h[5] * (1.0f + lam) + 1e-8f;
  const float c00 = h11 * h22 - h12 * h12;
  const float c01 = h02 * h12 - h01 * h22;
  const float c02 = h01 * h12 - h02 * h11;
  const float c11 = h00 * h22 - h02 * h02;
  const float c12 = h01 * h02 - h00 * h12;
  const float c22 = h00 * h11 - h01 * h01;
  const float det = h00 * c00 + h01 * c01 + h02 * c02;
  const float idet = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  Hi[0][0] = c00 * idet; Hi[0][1] = c01 * idet; Hi[0][2] = c02 * idet;
  Hi[1][0] = Hi[0][1];   Hi[1][1] = c11 * idet; Hi[1][2] = c12 * idet;
  Hi[2][0] = Hi[0][2];   Hi[2][1] = Hi[1][2];   Hi[2][2] = c22 * idet;
}

// The 69 per-slot terms of a slot, row i of each array at element e + i * E
// (rows c * 6 + a of Wb and Y; diag rows 0..20 the upper triangle of Ht in
// row-major (a, b >= a) order, 21..26 bt, 27..32 Ybp). A slot that is not
// live (behind the camera, or written only to complete a row) stores zeros:
// every value is selected, so all lanes of a warp run one path.
__device__ __forceinline__ void slot_terms(const Obs& o,
                                           const float (&Jp)[3][3],
                                           const float (&Hi)[3][3],
                                           const float* bp, bool live,
                                           size_t e, size_t E,
                                           float* __restrict__ Wb,
                                           float* __restrict__ Yo,
                                           float* __restrict__ diag) {
  float Jc[3][6];
  pose_jac(o, Jc);
  // Wb[(c, a)] = sum_r Jc[r][a] Jp[r][c] w; Y[(c, a)] = sum_k Wb[(k, a)]
  // Hinv[k][c]; Ybp[a] = sum_c Y[(c, a)] bp[c]
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float W[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      W[c] = (Jc[0][a] * Jp[0][c] + Jc[1][a] * Jp[1][c] +
              Jc[2][a] * Jp[2][c]) * o.w;
      Wb[(size_t)(c * 6 + a) * E + e] = live ? W[c] : 0.0f;
    }
    float ybp = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float y = W[0] * Hi[0][c] + W[1] * Hi[1][c] + W[2] * Hi[2][c];
      Yo[(size_t)(c * 6 + a) * E + e] = live ? y : 0.0f;
      ybp += y * bp[c];
    }
    diag[(size_t)(27 + a) * E + e] = live ? ybp : 0.0f;
  }
  int row = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      const float h =
          (Jc[0][a] * Jc[0][b] + Jc[1][a] * Jc[1][b] + Jc[2][a] * Jc[2][b]) *
          o.w;
      diag[(size_t)row * E + e] = live ? h : 0.0f;
      ++row;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float g =
        -(Jc[0][a] * o.r[0] + Jc[1][a] * o.r[1] + Jc[2][a] * o.r[2]) * o.w;
    diag[(size_t)(21 + a) * E + e] = live ? g : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Thread per point, two passes over its slots (the first design; slot-major).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void thread_point(
    int p, const float* __restrict__ qt, const float* __restrict__ pw,
    const int* __restrict__ kf, const float* __restrict__ uvr,
    const float* __restrict__ isig, const uint8_t* __restrict__ flags,
    const float* __restrict__ lam_ptr, float* __restrict__ Wb,
    float* __restrict__ Yo, float* __restrict__ diag,
    float* __restrict__ hinv6, float* __restrict__ bp_out,
    float* __restrict__ cost, float* __restrict__ chi2, int P, int M,
    const Cam& cam, int cost_only) {
  const size_t E = (size_t)M * (size_t)P;
  const float px = pw[3 * p], py = pw[3 * p + 1], pz = pw[3 * p + 2];

  // pass 1: cost, chi2 and the point block
  float h[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int m = 0; m < M; ++m) {
    const size_t e = (size_t)m * P + p;
    const uint8_t f = flags[e];
    if (!(f & 1)) continue;
    Obs o;
    eval_obs(qt, kf[e], px, py, pz, uvr[e], uvr[E + e], uvr[2 * E + e],
             isig[e], (f & 2) != 0, cam, !cost_only, o);
    cost[e] = o.rho;
    chi2[e] = o.chi2;
    if (cost_only || !o.active) continue;
    float Jp[3][3], s[9];
    point_jac(o, Jp);
    point_terms(o, Jp, s);
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] += s[k];
  }
  if (cost_only) return;

  float Hi[3][3];
  damped_inverse(h, *lam_ptr, Hi);
  hinv6[p] = Hi[0][0];
  hinv6[P + p] = Hi[0][1];
  hinv6[2 * P + p] = Hi[0][2];
  hinv6[3 * P + p] = Hi[1][1];
  hinv6[4 * P + p] = Hi[1][2];
  hinv6[5 * P + p] = Hi[2][2];
  bp_out[p] = h[6];
  bp_out[P + p] = h[7];
  bp_out[2 * P + p] = h[8];

  // pass 2: the per-slot terms
  for (int m = 0; m < M; ++m) {
    const size_t e = (size_t)m * P + p;
    const uint8_t f = flags[e];
    if (!(f & 1)) continue;
    Obs o;
    eval_obs(qt, kf[e], px, py, pz, uvr[e], uvr[E + e], uvr[2 * E + e],
             isig[e], (f & 2) != 0, cam, true, o);
    float Jp[3][3];
    point_jac(o, Jp);
    slot_terms(o, Jp, Hi, h + 6, o.active, e, E, Wb, Yo, diag);
  }
}

#define PREP_KERNEL_ARGS                                                     \
  const float *__restrict__ qt, const float *__restrict__ pw,                \
      const int *__restrict__ kf, const float *__restrict__ uvr,             \
      const float *__restrict__ isig, const uint8_t *__restrict__ flags,     \
      const int *__restrict__ points, const int *__restrict__ n_points,      \
      const float *__restrict__ lam_ptr, float *__restrict__ Wb,             \
      float *__restrict__ Yo, float *__restrict__ diag,                      \
      float *__restrict__ hinv6, float *__restrict__ bp_out,                 \
      float *__restrict__ cost, float *__restrict__ chi2, int P, int M,      \
      Cam cam, int cost_only

// The first design: one thread for every one of the P points.
__global__ void __launch_bounds__(kThreadsV1)
ba_prep_kernel_v1(PREP_KERNEL_ARGS) {
  const int p = blockIdx.x * kThreadsV1 + threadIdx.x;
  if (p >= P) return;
  thread_point(p, qt, pw, kf, uvr, isig, flags, lam_ptr, Wb, Yo, diag, hinv6,
               bp_out, cost, chi2, P, M, cam, cost_only);
}

// ---------------------------------------------------------------------------
// Warp per listed point (the present design).
// ---------------------------------------------------------------------------

// Sum over the `seg` lanes of a segment by one fixed tree, broadcast from the
// segment's first lane: every lane of the segment gets the same bits.
__device__ __forceinline__ float segment_sum(float v, int seg) {
  for (int off = seg >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off, seg);
  return __shfl_sync(kFull, v, 0, seg);
}

__device__ __forceinline__ float pick9(int k, const float (&v)[9]) {
  float r = v[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) r = k == j ? v[j] : r;
  return r;
}

// seg: lanes a point takes (the power of two >= M; 32 / seg points a warp).
// Three blocks an SM (at most 85 registers a thread, no spill): 24 warps an
// SM, 3168 on an H100, one pass over a local BA's 1,200-2,250 listed points;
// left free, ptxas takes 108 registers and two blocks fit, 2112 warps.
__global__ void __launch_bounds__(kWarpBlock, kWarpBlocksPerSm)
ba_prep_kernel_warp(PREP_KERNEL_ARGS, int seg) {
  const size_t E = (size_t)M * (size_t)P;
  const int lane = threadIdx.x & 31;
  const int sub = lane / seg;             // which point of the warp
  const int m = lane - sub * seg;         // which slot of that point
  const int per_warp = 32 / seg;
  const int n = __ldg(n_points);
  const int warp = (blockIdx.x * kWarpBlock + threadIdx.x) >> 5;
  const int stride = ((gridDim.x * kWarpBlock) >> 5) * per_warp;
  const float lam = cost_only ? 0.0f : __ldg(lam_ptr);

  // the loop bound is the same for every lane of a warp: all of them reach
  // the shuffles
  for (int base = warp * per_warp; base < n; base += stride) {
    const int i = base + sub;
    const bool listed = i < n;
    const int p = listed ? __ldg(points + i) : 0;
    const size_t e = (size_t)p * M + m;
    const bool in_point = listed && m < M;
    // the slot's inputs, all requested before its flag is tested
    uint8_t f = 0;
    int kfe = 0;
    float ou = 0.0f, ov = 0.0f, our = 0.0f, is = 0.0f;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (in_point) {
      f = flags[e];
      kfe = kf[e];
      ou = uvr[3 * e];
      ov = uvr[3 * e + 1];
      our = uvr[3 * e + 2];
      is = isig[e];
      px = pw[3 * p];
      py = pw[3 * p + 1];
      pz = pw[3 * p + 2];
    }
    const bool slot = f & 1;
    Obs o = {};
    if (slot)
      eval_obs(qt, kfe, px, py, pz, ou, ov, our, is, (f & 2) != 0, cam,
               !cost_only, o);
    // every slot of a listed point is written, zeros where inactive
    if (in_point) {
      cost[e] = slot ? o.rho : 0.0f;
      chi2[e] = slot ? o.chi2 : 0.0f;
    }
    if (cost_only) continue;

    float Jp[3][3] = {};
    float s[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (o.active) {               // o.active implies slot
      point_jac(o, Jp);
      point_terms(o, Jp, s);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = segment_sum(s[k], seg);
    float Hi[3][3];
    damped_inverse(s, lam, Hi);
    if (listed) {
      const float out[9] = {Hi[0][0], Hi[0][1], Hi[0][2], Hi[1][1], Hi[1][2],
                            Hi[2][2], s[6], s[7], s[8]};
      for (int k = m; k < 9; k += seg)
        (k < 6 ? hinv6 + (size_t)k * P : bp_out + (size_t)(k - 6) * P)[p] =
            pick9(k, out);
    }
    if (in_point)
      slot_terms(o, Jp, Hi, s + 6, o.active, e, E, Wb, Yo, diag);
  }
}

// The listed points of a solve: the ascending indices p < P with has[p] != 0,
// then zeros up to P, and their count in n_points. One block; a pass takes
// 32 points a thread as a bit mask (two 16-byte loads), a block-wide scan of
// the masks' counts gives each thread its place.
constexpr int kCompactThreads = 1024;
constexpr int kCompactTile = 32 * kCompactThreads;

__device__ __forceinline__ unsigned has_bits(const uint8_t* __restrict__ has,
                                             int p0, int P) {
  unsigned bits = 0;
  if (p0 + 32 <= P && !(reinterpret_cast<uintptr_t>(has + p0) & 15)) {
    const uint4* v = reinterpret_cast<const uint4*>(has + p0);
    const uint4 a = v[0], b = v[1];
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned x = __vcmpne4(w[k], 0u) & 0x01010101u;
      bits |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) |
               ((x >> 21) & 8u)) << (4 * k);
    }
  } else {
    for (int j = 0; j < 32 && p0 + j < P; ++j)
      bits |= (has[p0 + j] != 0 ? 1u : 0u) << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kCompactThreads)
ba_prep_compact_kernel(const uint8_t* __restrict__ has, int P,
                       int* __restrict__ points, int* __restrict__ n_points) {
  __shared__ int warp_total[kCompactThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int base = 0;                       // points listed by earlier passes
  for (int tile = 0; tile < P; tile += kCompactTile) {
    const int p0 = tile + 32 * t;
    unsigned bits = p0 < P ? has_bits(has, p0, P) : 0u;
    const int count = __popc(bits);
    int x = count;                    // inclusive scan over the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_total[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_total[lane] = w;
    }
    __syncthreads();
    int at = base + x - count + (warp > 0 ? warp_total[warp - 1] : 0);
    for (; bits; bits &= bits - 1) points[at++] = p0 + __ffs(bits) - 1;
    base += warp_total[kCompactThreads / 32 - 1];
    __syncthreads();                  // warp_total is the next pass's
  }
  for (int j = base + t; j < P; j += kCompactThreads) points[j] = 0;
  if (t == 0) *n_points = base;
}

// Lanes a point takes: the power of two >= M.
int segment_for(int M) {
  int seg = 1;
  while (seg < M) seg <<= 1;
  return seg;
}

// Persistent grid: every block the SMs hold at once, found once.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, int* cache) {
  if (*cache > 0) return *cache;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess) {
    const int err = (int)cudaGetLastError();
    return err ? -err : -1;
  }
  *cache = sms * (per_sm > 0 ? per_sm : 1);
  return *cache;
}

int grid_blocks = 0;

// v1: the first design (slot-major arrays, every point) instead of the
// present one.
int launch(PREP_KERNEL_ARGS, bool v1, cudaStream_t stream) {
  if (P <= 0 || M <= 0 || M > kMaxSlots) return -1;
  if (v1) {
    ba_prep_kernel_v1<<<(P + kThreadsV1 - 1) / kThreadsV1, kThreadsV1, 0,
                        stream>>>(qt, pw, kf, uvr, isig, flags, points,
                                  n_points, lam_ptr, Wb, Yo, diag, hinv6,
                                  bp_out, cost, chi2, P, M, cam, cost_only);
  } else {
    const int blocks =
        persistent_blocks(ba_prep_kernel_warp, kWarpBlock, &grid_blocks);
    if (blocks < 0) return blocks == -1 ? -1 : -blocks;
    ba_prep_kernel_warp<<<blocks, kWarpBlock, 0, stream>>>(
        qt, pw, kf, uvr, isig, flags, points, n_points, lam_ptr, Wb, Yo, diag,
        hinv6, bp_out, cost, chi2, P, M, cam, cost_only, segment_for(M));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qt [K, 7] float32 (qw qx qy qz tx ty tz); pw [P, 3] float32;
// kf [P, M] int32, every entry in [0, K); uvr [P, M, 3], isig [P, M]
// float32; flags [P, M] bytes (bit 0: slot takes part in this solve, bit 1:
// stereo); points [P] int32: the points with a bit-0 slot, ascending, their
// count in n_points (one int32 in device memory); lam: one float32 in device
// memory. Wb, Y [18, P, M]; diag [33, P, M]; hinv6 [6, P]; bp [3, P]; cost,
// chi2 [P, M]. Only the listed points are written, every slot of them (zeros
// where flag bit 0 is clear). With cost_only != 0 only cost and chi2 are
// written (Wb, Y, diag, hinv6, bp and lam may be null). M <= 32. Returns
// cudaGetLastError() after the launch, or -1 for a shape it refuses.
int ba_prep_launch(const void* qt, const void* pw, const void* kf,
                   const void* uvr, const void* isig, const void* flags,
                   const void* points, const void* n_points, const void* lam,
                   void* Wb, void* Y, void* diag, void* hinv6, void* bp,
                   void* cost, void* chi2, int P, int M, float fx, float fy,
                   float cx, float cy, float bf, float d2m, float d2s,
                   int use_huber, int cost_only, void* stream) {
  return launch((const float*)qt, (const float*)pw, (const int*)kf,
                (const float*)uvr, (const float*)isig, (const uint8_t*)flags,
                (const int*)points, (const int*)n_points, (const float*)lam,
                (float*)Wb, (float*)Y, (float*)diag, (float*)hinv6,
                (float*)bp, (float*)cost, (float*)chi2, P, M,
                Cam{fx, fy, cx, cy, bf, d2m, d2s, use_huber}, cost_only, false,
                (cudaStream_t)stream);
}

// The first design (one thread per point over all P, two passes), for
// timing beside the present one. The same arguments, but every array that
// is per observation is slot-major: kf, isig, flags, cost, chi2 [M, P], uvr
// [3, M, P], Wb, Y [18, M, P], diag [33, M, P]; points and n_points are not
// read, and every point is written.
int ba_prep_launch_v1(const void* qt, const void* pw, const void* kf,
                      const void* uvr, const void* isig, const void* flags,
                      const void* points, const void* n_points,
                      const void* lam, void* Wb, void* Y, void* diag,
                      void* hinv6, void* bp, void* cost, void* chi2, int P,
                      int M, float fx, float fy, float cx, float cy, float bf,
                      float d2m, float d2s, int use_huber, int cost_only,
                      void* stream) {
  return launch((const float*)qt, (const float*)pw, (const int*)kf,
                (const float*)uvr, (const float*)isig, (const uint8_t*)flags,
                (const int*)points, (const int*)n_points, (const float*)lam,
                (float*)Wb, (float*)Y, (float*)diag, (float*)hinv6,
                (float*)bp, (float*)cost, (float*)chi2, P, M,
                Cam{fx, fy, cx, cy, bf, d2m, d2s, use_huber}, cost_only, true,
                (cudaStream_t)stream);
}

// The listed points from has [P] (bytes, nonzero: the point has a slot
// active in the solve): points [P] int32 ascending, then zeros; n_points one
// int32. One block of 1024 threads.
int ba_prep_compact(const void* has, int P, void* points, void* n_points,
                    void* stream) {
  if (P <= 0) return -1;
  ba_prep_compact_kernel<<<1, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)has, P, (int*)points, (int*)n_points);
  return (int)cudaGetLastError();
}

// The most slots a point may have (one lane each).
int ba_prep_max_slots() { return kMaxSlots; }

// Blocks of the persistent grid of the present design (after a launch; 0
// before the first).
int ba_prep_grid_blocks() { return grid_blocks; }

}  // extern "C"
