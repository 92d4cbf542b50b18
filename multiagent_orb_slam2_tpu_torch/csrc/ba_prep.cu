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
// What bounds it on an H100: bytes. A slot reads 21 bytes and writes 71
// floats, against about 600 float operations, so the write stream decides.
// The design: one thread per point, looping twice over the point's M slots
// (first pass sums Hpp and bp in registers, then the inverse, second pass
// recomputes the slot's Jacobians and emits its terms, which is cheaper than
// keeping M Jacobians live). Arrays are slot-major, [*, M, P], so the 32
// threads of a warp read and write 32 neighbouring floats at every step. The
// kernel gathers the pose by itself from the [K, 7] table, and it reads
// lambda from device memory, so the LM loop never waits for the host. Slots
// that are inactive for the whole solve (flag bit 0 clear) are skipped
// without a write: the wrapper zero-fills the outputs once per solve. A slot
// that is active but behind the camera at this iterate writes zeros. Only the
// 21 upper-triangle entries of the symmetric Ht are written. No atomics:
// every sum has a fixed order, so two launches agree bit for bit.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
ba_prep_kernel(const float* __restrict__ qt, const float* __restrict__ pw,
               const int* __restrict__ kf, const float* __restrict__ uvr,
               const float* __restrict__ isig,
               const uint8_t* __restrict__ flags,
               const float* __restrict__ lam_ptr, float* __restrict__ Wb,
               float* __restrict__ Yo, float* __restrict__ diag,
               float* __restrict__ hinv6, float* __restrict__ bp_out,
               float* __restrict__ cost, float* __restrict__ chi2, int P,
               int M, Cam cam, int cost_only) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t E = (size_t)M * (size_t)P;
  const float px = pw[3 * p], py = pw[3 * p + 1], pz = pw[3 * p + 2];

  // pass 1: cost, chi2 and the point block
  float h[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bp[3] = {0.0f, 0.0f, 0.0f};
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
    float Jp[3][3];
    point_jac(o, Jp);
    h[0] += (Jp[0][0] * Jp[0][0] + Jp[1][0] * Jp[1][0] + Jp[2][0] * Jp[2][0]) * o.w;
    h[1] += (Jp[0][0] * Jp[0][1] + Jp[1][0] * Jp[1][1] + Jp[2][0] * Jp[2][1]) * o.w;
    h[2] += (Jp[0][0] * Jp[0][2] + Jp[1][0] * Jp[1][2] + Jp[2][0] * Jp[2][2]) * o.w;
    h[3] += (Jp[0][1] * Jp[0][1] + Jp[1][1] * Jp[1][1] + Jp[2][1] * Jp[2][1]) * o.w;
    h[4] += (Jp[0][1] * Jp[0][2] + Jp[1][1] * Jp[1][2] + Jp[2][1] * Jp[2][2]) * o.w;
    h[5] += (Jp[0][2] * Jp[0][2] + Jp[1][2] * Jp[1][2] + Jp[2][2] * Jp[2][2]) * o.w;
#pragma unroll
    for (int b = 0; b < 3; ++b)
      bp[b] -= (Jp[0][b] * o.r[0] + Jp[1][b] * o.r[1] + Jp[2][b] * o.r[2]) * o.w;
  }
  if (cost_only) return;

  // damped symmetric 3x3 inverse
  const float lam = *lam_ptr;
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
  float Hi[3][3];
  Hi[0][0] = c00 * idet; Hi[0][1] = c01 * idet; Hi[0][2] = c02 * idet;
  Hi[1][0] = Hi[0][1];   Hi[1][1] = c11 * idet; Hi[1][2] = c12 * idet;
  Hi[2][0] = Hi[0][2];   Hi[2][1] = Hi[1][2];   Hi[2][2] = c22 * idet;
  hinv6[p] = Hi[0][0];
  hinv6[P + p] = Hi[0][1];
  hinv6[2 * P + p] = Hi[0][2];
  hinv6[3 * P + p] = Hi[1][1];
  hinv6[4 * P + p] = Hi[1][2];
  hinv6[5 * P + p] = Hi[2][2];
  bp_out[p] = bp[0];
  bp_out[P + p] = bp[1];
  bp_out[2 * P + p] = bp[2];

  // pass 2: the per-slot terms
  for (int m = 0; m < M; ++m) {
    const size_t e = (size_t)m * P + p;
    const uint8_t f = flags[e];
    if (!(f & 1)) continue;
    Obs o;
    eval_obs(qt, kf[e], px, py, pz, uvr[e], uvr[E + e], uvr[2 * E + e],
             isig[e], (f & 2) != 0, cam, true, o);
    if (!o.active) {
      for (int i = 0; i < 18; ++i) {
        Wb[(size_t)i * E + e] = 0.0f;
        Yo[(size_t)i * E + e] = 0.0f;
      }
      for (int i = 0; i < 33; ++i) diag[(size_t)i * E + e] = 0.0f;
      continue;
    }
    float Jp[3][3], Jc[3][6];
    point_jac(o, Jp);
    pose_jac(o, Jc);
    // Wb[(c, a)] = sum_r Jc[r][a] Jp[r][c] w, rows c-major
    float W[3][6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        W[c][a] = (Jc[0][a] * Jp[0][c] + Jc[1][a] * Jp[1][c] +
                   Jc[2][a] * Jp[2][c]) * o.w;
        Wb[(size_t)(c * 6 + a) * E + e] = W[c][a];
      }
    }
    // Y[(c, a)] = sum_k Wb[(k, a)] Hinv[k][c]; Ybp[a] = sum_c Y[(c, a)] bp[c]
    float ybp[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float y = W[0][a] * Hi[0][c] + W[1][a] * Hi[1][c] +
                        W[2][a] * Hi[2][c];
        Yo[(size_t)(c * 6 + a) * E + e] = y;
        ybp[a] += y * bp[c];
      }
    }
    // diag rows 0..20: upper triangle of Ht = Jc^T w Jc, (a, b >= a) in
    // row-major order; rows 21..26: bt = -Jc^T w r; rows 27..32: Ybp
    int row = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        diag[(size_t)row * E + e] =
            (Jc[0][a] * Jc[0][b] + Jc[1][a] * Jc[1][b] + Jc[2][a] * Jc[2][b]) *
            o.w;
        ++row;
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      diag[(size_t)(21 + a) * E + e] =
          -(Jc[0][a] * o.r[0] + Jc[1][a] * o.r[1] + Jc[2][a] * o.r[2]) * o.w;
      diag[(size_t)(27 + a) * E + e] = ybp[a];
    }
  }
}

}  // namespace

extern "C" {

// qt [K, 7] float32 (qw qx qy qz tx ty tz); pw [P, 3] float32;
// kf [M, P] int32, every entry in [0, K); uvr [3, M, P], isig [M, P] float32;
// flags [M, P] bytes (bit 0: slot takes part in this solve, bit 1: stereo);
// lam: one float32 in device memory.
// Wb, Y [18, M, P]; diag [33, M, P]; hinv6 [6, P]; bp [3, P]; cost, chi2
// [M, P]. Slots with flag bit 0 clear are not written. With cost_only != 0
// only cost and chi2 are written (Wb, Y, diag, hinv6, bp may be null).
// Returns cudaGetLastError() after the launch, or -1 for a shape it refuses.
int ba_prep_launch(const void* qt, const void* pw, const void* kf,
                   const void* uvr, const void* isig, const void* flags,
                   const void* lam, void* Wb, void* Y, void* diag, void* hinv6,
                   void* bp, void* cost, void* chi2, int P, int M, float fx,
                   float fy, float cx, float cy, float bf, float d2m, float d2s,
                   int use_huber, int cost_only, void* stream) {
  if (P <= 0 || M <= 0) return -1;
  Cam cam{fx, fy, cx, cy, bf, d2m, d2s, use_huber};
  const int blocks = (P + kThreads - 1) / kThreads;
  ba_prep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)qt, (const float*)pw, (const int*)kf, (const float*)uvr,
      (const float*)isig, (const uint8_t*)flags, (const float*)lam, (float*)Wb,
      (float*)Y, (float*)diag, (float*)hinv6, (float*)bp, (float*)cost,
      (float*)chi2, P, M, cam, cost_only);
  return (int)cudaGetLastError();
}

}  // extern "C"
