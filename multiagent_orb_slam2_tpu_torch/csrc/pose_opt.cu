// Pose-only Levenberg-Marquardt optimizer: the whole schedule in one kernel.
//
// Replaces the Pallas TPU kernel optim/pose_opt_pallas.py::_pose_kernel of
// the JAX package (reference Optimizer::PoseOptimization): `rounds` rounds of
// `iters` LM iterations on one 6-DoF world-to-camera pose against fixed map
// points; each iteration is one residual/Jacobian pass (21 sums of H, 6 of b,
// the robust cost), H(1+lambda)+1e-9 damping on the diagonal, a 6x6 Cholesky
// solve, an SE3 exp-compose-normalise update, a second cost-only pass and an
// accept/reject with lambda x0.5 / x4 clipped to [1e-8, 1e6]. After every
// round the inliers are relabelled by chi2 and depth; the last round runs
// without the Huber kernel.
//
// What bounds it on an H100: not bytes (each observation is 9 floats, read
// once: 72 KB at N = 2048) and not arithmetic (about 26 MFLOP), but the
// serial chain of 2 x rounds x iters block-wide reductions, each followed by
// scalar work that the next pass depends on. The design keeps that chain
// short: one thread block per problem (grid = batch), every thread keeps its
// observations in registers for the whole schedule, a pass reduces with warp
// shuffles plus one fixed-order sum over the warps in shared memory (one
// __syncthreads per pass, two alternating buffers), and every thread then
// runs the 6x6 solve and the pose update redundantly in registers, so no
// second barrier or broadcast is needed. No float atomics anywhere: the sums
// are bit-identical from run to run, which matters because `cost1 < cost0`
// decides accept/reject.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 28;  // 21 upper-triangle entries of H, 6 of b, cost

struct Params {
  float fx, fy, cx, cy, bf, d2m, d2s;
  int rounds, iters;
};

struct Pose {
  float qw, qx, qy, qz, tx, ty, tz;
};

// Sum v[0..NV) over the block; every thread returns with the same totals.
// Fixed order: xor-butterfly inside a warp (commutative pairs, so all lanes
// agree bit for bit), then warps 0..7 in order.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* buf) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) buf[warp * kTerms + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = buf[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += buf[w * kTerms + i];
    v[i] = s;
  }
}

// Damped 6x6 Cholesky solve, same clamps as the Pallas body.
__device__ __forceinline__ void chol_solve6(const float (&H)[6][6],
                                            const float (&b)[6],
                                            float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    const float ljj = sqrtf(fmaxf(d, 1e-12f));
    L[j][j] = ljj;
    const float inv = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s * inv;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// T_new = exp(dx) * T with dx = (rho, phi); quaternion renormalised and kept
// on the w >= 0 hemisphere.
__device__ __forceinline__ Pose se3_update(const float (&dx)[6], const Pose& p) {
  const float r0 = dx[0], r1 = dx[1], r2 = dx[2];
  const float px = dx[3], py = dx[4], pz = dx[5];
  const float t2 = px * px + py * py + pz * pz;
  const float th = sqrtf(fmaxf(t2, 1e-24f));
  const bool small = t2 < 1e-8f;
  const float half = 0.5f * th;
  const float k = small ? (0.5f - t2 / 48.0f) : (sinf(half) / th);
  const float dqw = cosf(half);
  const float dqx = k * px, dqy = k * py, dqz = k * pz;
  const float A = small ? (0.5f - t2 / 24.0f) : ((1.0f - cosf(th)) / t2);
  const float B = small ? (1.0f / 6.0f - t2 / 120.0f)
                        : ((th - sinf(th)) / fmaxf(t2 * th, 1e-24f));
  const float h1x = py * r2 - pz * r1;
  const float h1y = pz * r0 - px * r2;
  const float h1z = px * r1 - py * r0;
  const float h2x = py * h1z - pz * h1y;
  const float h2y = pz * h1x - px * h1z;
  const float h2z = px * h1y - py * h1x;
  const float dtx = r0 + A * h1x + B * h2x;
  const float dty = r1 + A * h1y + B * h2y;
  const float dtz = r2 + A * h1z + B * h2z;
  const float nw = dqw * p.qw - dqx * p.qx - dqy * p.qy - dqz * p.qz;
  const float nx = dqw * p.qx + dqx * p.qw + dqy * p.qz - dqz * p.qy;
  const float ny = dqw * p.qy - dqx * p.qz + dqy * p.qw + dqz * p.qx;
  const float nz = dqw * p.qz + dqx * p.qy - dqy * p.qx + dqz * p.qw;
  const float uvx = dqy * p.tz - dqz * p.ty;
  const float uvy = dqz * p.tx - dqx * p.tz;
  const float uvz = dqx * p.ty - dqy * p.tx;
  const float uux = dqy * uvz - dqz * uvy;
  const float uuy = dqz * uvx - dqx * uvz;
  const float uuz = dqx * uvy - dqy * uvx;
  Pose o;
  o.tx = p.tx + 2.0f * (dqw * uvx + uux) + dtx;
  o.ty = p.ty + 2.0f * (dqw * uvy + uuy) + dty;
  o.tz = p.tz + 2.0f * (dqw * uvz + uuz) + dtz;
  const float inv =
      1.0f / sqrtf(fmaxf(nw * nw + nx * nx + ny * ny + nz * nz, 1e-24f));
  const float sgn = nw < 0.0f ? -inv : inv;
  o.qw = nw * sgn;
  o.qx = nx * sgn;
  o.qy = ny * sgn;
  o.qz = nz * sgn;
  return o;
}

// One observation, held in registers for the whole schedule.
struct Obs {
  float pwx, pwy, pwz, ou, ov, our, isig;
  float stf;     // 1 stereo, 0 mono
  float mask;    // 1 valid observation
  float d2;      // Huber delta^2 == chi2 gate of this observation's type
};

struct Resid {
  float X, Y, Z, iz, r0, r1, r2, chi2, zok;
};

__device__ __forceinline__ Resid residual(const Params& P, const Pose& p,
                                          const Obs& o) {
  Resid r;
  const float cx1 = 2.0f * (p.qy * o.pwz - p.qz * o.pwy);
  const float cy1 = 2.0f * (p.qz * o.pwx - p.qx * o.pwz);
  const float cz1 = 2.0f * (p.qx * o.pwy - p.qy * o.pwx);
  r.X = o.pwx + p.qw * cx1 + (p.qy * cz1 - p.qz * cy1) + p.tx;
  r.Y = o.pwy + p.qw * cy1 + (p.qz * cx1 - p.qx * cz1) + p.ty;
  r.Z = o.pwz + p.qw * cz1 + (p.qx * cy1 - p.qy * cx1) + p.tz;
  r.zok = r.Z > 0.01f ? 1.0f : 0.0f;
  r.iz = 1.0f / fmaxf(r.Z, 1e-6f);
  const float u = P.fx * r.X * r.iz + P.cx;
  const float v = P.fy * r.Y * r.iz + P.cy;
  r.r0 = o.ou - u;
  r.r1 = o.ov - v;
  r.r2 = (o.our - (u - P.bf * r.iz)) * o.stf;
  r.chi2 = (r.r0 * r.r0 + r.r1 * r.r1 + r.r2 * r.r2) * o.isig;
  return r;
}

__device__ __forceinline__ float robust_cost(const Resid& r, const Obs& o,
                                             bool huber) {
  return (huber && r.chi2 > o.d2)
             ? 2.0f * sqrtf(o.d2) * sqrtf(fmaxf(r.chi2, 1e-12f)) - o.d2
             : r.chi2;
}

template <int OPT>
__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ qt0, const float* __restrict__ pw,
                const float* __restrict__ ob, const float* __restrict__ isig,
                const uint8_t* __restrict__ stereo,
                const uint8_t* __restrict__ mask, float* __restrict__ qt_out,
                uint8_t* __restrict__ inlier_out, int N, Params P) {
  __shared__ float red[2][kWarps * kTerms];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N;

  Obs o[OPT];
  float inl[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int i = tid + j * kThreads;
    if (i < N) {
      const float* p3 = pw + (base + i) * 3;
      const float* o3 = ob + (base + i) * 3;
      o[j].pwx = p3[0]; o[j].pwy = p3[1]; o[j].pwz = p3[2];
      o[j].ou = o3[0];  o[j].ov = o3[1];  o[j].our = o3[2];
      o[j].isig = isig[base + i];
      o[j].stf = stereo[base + i] ? 1.0f : 0.0f;
      o[j].mask = mask[base + i] ? 1.0f : 0.0f;
    } else {
      o[j].pwx = o[j].pwy = 0.0f; o[j].pwz = 1.0f;
      o[j].ou = o[j].ov = o[j].our = 0.0f;
      o[j].isig = 0.0f; o[j].stf = 0.0f; o[j].mask = 0.0f;
    }
    o[j].d2 = P.d2s * o[j].stf + P.d2m * (1.0f - o[j].stf);
    inl[j] = o[j].mask;
  }

  Pose pose;
  {
    const float* q = qt0 + (size_t)b * 8;
    pose.qw = q[0]; pose.qx = q[1]; pose.qy = q[2]; pose.qz = q[3];
    pose.tx = q[4]; pose.ty = q[5]; pose.tz = q[6];
  }

  int phase = 0;
  for (int rnd = 0; rnd < P.rounds; ++rnd) {
    const bool huber = rnd < P.rounds - 1;
    float lam = 1e-3f;
    for (int it = 0; it < P.iters; ++it) {
      // pass 1: normal equations and cost at the current pose
      float acc[kTerms];
#pragma unroll
      for (int i = 0; i < kTerms; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const Resid r = residual(P, pose, o[j]);
        const float w_rob =
            huber ? fminf(1.0f, sqrtf(o[j].d2 / fmaxf(r.chi2, 1e-12f))) : 1.0f;
        const float w = o[j].isig * w_rob * inl[j] * r.zok;
        acc[27] += robust_cost(r, o[j], huber) * inl[j] * r.zok;
        const float iz2 = r.iz * r.iz;
        // rows of J = A [I | -hat(pc)], A = -dproj/dpc
        float J[3][6];
        const float a00 = -P.fx * r.iz, a02 = P.fx * r.X * iz2;
        const float a11 = -P.fy * r.iz, a12 = P.fy * r.Y * iz2;
        const float a20 = a00 * o[j].stf;
        const float a22 = (P.fx * r.X * iz2 - P.bf * iz2) * o[j].stf;
        J[0][0] = a00;  J[0][1] = 0.0f; J[0][2] = a02;
        J[0][3] = a02 * r.Y;            J[0][4] = a00 * r.Z - a02 * r.X;
        J[0][5] = -a00 * r.Y;
        J[1][0] = 0.0f; J[1][1] = a11;  J[1][2] = a12;
        J[1][3] = a12 * r.Y - a11 * r.Z; J[1][4] = -a12 * r.X;
        J[1][5] = a11 * r.X;
        J[2][0] = a20;  J[2][1] = 0.0f; J[2][2] = a22;
        J[2][3] = a22 * r.Y;            J[2][4] = a20 * r.Z - a22 * r.X;
        J[2][5] = -a20 * r.Y;
        int t = 0;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
#pragma unroll
          for (int kk = jj; kk < 6; ++kk) {
            acc[t++] += (J[0][jj] * J[0][kk] + J[1][jj] * J[1][kk] +
                         J[2][jj] * J[2][kk]) * w;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 6; ++jj)
          acc[21 + jj] -=
              (J[0][jj] * r.r0 + J[1][jj] * r.r1 + J[2][jj] * r.r2) * w;
      }
      block_sum<kTerms>(acc, red[phase]);
      phase ^= 1;

      float H[6][6], bv[6], dx[6];
      {
        int t = 0;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
#pragma unroll
          for (int kk = jj; kk < 6; ++kk) {
            H[jj][kk] = acc[t];
            H[kk][jj] = acc[t];
            ++t;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          H[jj][jj] = H[jj][jj] * (1.0f + lam) + 1e-9f;
          bv[jj] = acc[21 + jj];
        }
      }
      const float cost0 = acc[27];
      chol_solve6(H, bv, dx);
      const Pose cand = se3_update(dx, pose);

      // pass 2: cost only at the candidate pose
      float c1[1] = {0.0f};
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const Resid r = residual(P, cand, o[j]);
        c1[0] += robust_cost(r, o[j], huber) * inl[j] * r.zok;
      }
      block_sum<1>(c1, red[phase]);
      phase ^= 1;

      const bool accept = c1[0] < cost0;
      if (accept) pose = cand;
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
    }
    // relabel by chi2 and depth at the current pose (re-admits improved obs)
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const Resid r = residual(P, pose, o[j]);
      inl[j] = o[j].mask * (r.chi2 <= o[j].d2 ? 1.0f : 0.0f) * r.zok;
    }
  }

  float n_in[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    n_in[0] += inl[j];
    const int i = tid + j * kThreads;
    if (i < N) inlier_out[base + i] = inl[j] > 0.5f ? 1 : 0;
  }
  block_sum<1>(n_in, red[phase]);
  if (tid == 0) {
    float* q = qt_out + (size_t)b * 8;
    q[0] = pose.qw; q[1] = pose.qx; q[2] = pose.qy; q[3] = pose.qz;
    q[4] = pose.tx; q[5] = pose.ty; q[6] = pose.tz; q[7] = n_in[0];
  }
}

// A chain of `n` dependent block-wide reductions of kTerms values, each
// followed by the 6x6 solve: the serial skeleton of the optimizer without
// its per-observation arithmetic. Timed to reckon the kernel's floor.
__global__ void __launch_bounds__(kThreads)
reduce_chain_kernel(float* out, int n, int with_solve) {
  __shared__ float red[2][kWarps * kTerms];
  float carry = 1.0f + 1e-3f * (float)threadIdx.x;
  int phase = 0;
  for (int it = 0; it < n; ++it) {
    float acc[kTerms];
#pragma unroll
    for (int i = 0; i < kTerms; ++i) acc[i] = carry * (1.0f + 0.01f * (float)i);
    block_sum<kTerms>(acc, red[phase]);
    phase ^= 1;
    if (with_solve) {
      float H[6][6], bv[6], dx[6];
      int t = 0;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
#pragma unroll
        for (int kk = jj; kk < 6; ++kk) {
          H[jj][kk] = jj == kk ? acc[t] + 1e4f : acc[t] * 1e-3f;
          H[kk][jj] = H[jj][kk];
          ++t;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) bv[jj] = acc[21 + jj];
      chol_solve6(H, bv, dx);
      carry = 1.0f + 1e-6f * (dx[0] + dx[5]) + 1e-3f * (float)threadIdx.x;
    } else {
      carry = 1.0f + 1e-9f * acc[27] + 1e-3f * (float)threadIdx.x;
    }
  }
  if (threadIdx.x == 0) out[0] = carry;
}

template <int OPT>
int launch(const float* qt0, const float* pw, const float* ob,
           const float* isig, const uint8_t* stereo, const uint8_t* mask,
           float* qt_out, uint8_t* inlier, int B, int N, const Params& P,
           cudaStream_t stream) {
  pose_opt_kernel<OPT><<<B, kThreads, 0, stream>>>(
      qt0, pw, ob, isig, stereo, mask, qt_out, inlier, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N one block takes: 8 observations per thread in registers.
int pose_opt_max_obs() { return 8 * kThreads; }

// qt0, qt_out: [B, 8] float32 (qw qx qy qz tx ty tz, then unused / n_inliers)
// pw, ob: [B, N, 3] float32; isig: [B, N] float32
// stereo, mask, inlier: [B, N] bytes (0 / 1)
// Returns cudaGetLastError() after the launch, or -1 for a shape it refuses.
int pose_opt_launch(const void* qt0, const void* pw, const void* ob,
                    const void* isig, const void* stereo, const void* mask,
                    void* qt_out, void* inlier, int B, int N, float fx,
                    float fy, float cx, float cy, float bf, float d2m,
                    float d2s, int rounds, int iters, void* stream) {
  if (B <= 0 || N <= 0 || N > 8 * kThreads) return -1;
  Params P{fx, fy, cx, cy, bf, d2m, d2s, rounds, iters};
  cudaStream_t s = (cudaStream_t)stream;
  const float* a0 = (const float*)qt0;
  const float* a1 = (const float*)pw;
  const float* a2 = (const float*)ob;
  const float* a3 = (const float*)isig;
  const uint8_t* a4 = (const uint8_t*)stereo;
  const uint8_t* a5 = (const uint8_t*)mask;
  float* o0 = (float*)qt_out;
  uint8_t* o1 = (uint8_t*)inlier;
  const int per_thread = (N + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch<1>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, P, s);
  if (per_thread <= 2) return launch<2>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, P, s);
  if (per_thread <= 4) return launch<4>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, P, s);
  return launch<8>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, P, s);
}

// out: [1] float32. Runs n dependent block-wide reductions in one block.
int pose_opt_reduce_chain(void* out, int n, int with_solve, void* stream) {
  reduce_chain_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, with_solve);
  return (int)cudaGetLastError();
}

}  // extern "C"
