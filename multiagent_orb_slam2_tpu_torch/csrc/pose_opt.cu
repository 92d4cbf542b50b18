// Pose-only Levenberg-Marquardt optimizer: the whole schedule in one kernel.
//
// Replaces the Pallas TPU kernel optim/pose_opt_pallas.py::_pose_kernel of
// the JAX package (reference Optimizer::PoseOptimization): `rounds` rounds of
// `iters` LM iterations on one 6-DoF world-to-camera pose against fixed map
// points; each iteration solves the damped normal equations (21 sums of H, 6
// of b; H(1+lambda)+1e-9 on the diagonal, 6x6 Cholesky), applies an SE3
// exp-compose-normalise update and accepts the candidate when its robust cost
// is lower, with lambda x0.5 / x4 clipped to [1e-8, 1e6]. After every round
// the inliers are relabelled by chi2 and depth; the last round runs without
// the Huber kernel.
//
// What bounds it on an H100: not bytes (an observation is 9 floats, read
// once: 72 KB at N = 2048) and not the card's arithmetic rate (about 25
// MFLOP), but a serial chain: every LM iteration ends in a block-wide
// reduction of 28 sums that the next iteration's pose depends on, and between
// two reductions one SM does all the per-observation arithmetic of a pose.
// The design shortens both:
//
//  - one pass and one reduction per iteration. The normal equations are
//    evaluated together with the cost AT THE CANDIDATE pose. When the
//    candidate is accepted they are the next iteration's H, b and cost (the
//    same observations at the same pose in the same summation order, so
//    `cost1 < cost0` compares bit-identical sums); when it is rejected the
//    stored H, b and cost stay and only lambda changes. A fresh pass is needed
//    only where a round starts (Huber flag and inlier labels change there; it
//    also does the relabelling). rounds x (iters + 1) reductions, not
//    2 x rounds x iters;
//  - only valid observations do work. They are compacted once at load (warp
//    ballots, a fixed-order scan over the warps: stable and deterministic)
//    into structure-of-arrays shared memory, and a pass loops over
//    ceil(n_valid / threads) of them. `inlier_out` is still written for all N
//    slots in their original order;
//  - the reduction itself is cheap: a transposing butterfly leaves lane l of a
//    warp with the warp's total of term l after 31 shuffles (not 28 x 5), one
//    barrier, lane l sums term l over the warps in a fixed order, and 28
//    broadcasts give every thread all totals; every thread then runs the 6x6
//    solve and the pose update redundantly in registers, so no second barrier
//    is needed;
//  - a pose gets a thread-block cluster of 4 blocks: each block compacts all
//    observations into its own shared memory and works on every 4th chunk of
//    them; a warp sends its 28 partials into every block's shared memory with
//    asynchronous remote stores that are counted on the receiver's mbarrier,
//    so a block waits on its own barrier and no cluster barrier is in the
//    loop; all blocks sum the same partials in the same order and stay in
//    lockstep bit for bit. Against one block per pose this costs 0.3 us a
//    pass and saves the arithmetic of three quarters of the observations:
//    even at the 170-980 valid slots of this system's frames (of 2048), and
//    twice as fast where most slots are valid.
//
// No float atomics anywhere: two launches are bit-identical.
//
// The first design of this kernel (one block per pose, observations in
// registers, a normal-equation pass and a cost-only pass per iteration) is
// kept under pose_opt_launch_v1 so that a script can time old and new in one
// process on one card.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTerms = 28;    // 21 upper-triangle entries of H, 6 of b, cost
constexpr int kMaxObs = 2048; // observations one pose may have

struct Params {
  float fx, fy, cx, cy, bf, d2m, d2s;
  int rounds, iters;
};

struct Pose {
  float qw, qx, qy, qz, tx, ty, tz;
};

// Damped 6x6 Cholesky solve, same clamps as the Pallas body. The two
// substitutions divide by the diagonal of L; with kRecip they multiply by its
// reciprocal, which the factorisation has already (12 IEEE divisions fewer on
// the serial chain, results within an ulp per step).
template <bool kRecip>
__device__ __forceinline__ void chol_solve6(const float (&H)[6][6],
                                            const float (&b)[6],
                                            float (&x)[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    const float ljj = sqrtf(fmaxf(d, 1e-12f));
    L[j][j] = ljj;
    inv[j] = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = kRecip ? s * inv[i] : s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = kRecip ? s * inv[i] : s / L[i][i];
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

// Adds one observation's J^T w J (upper triangle), -J^T w r and robust cost
// to acc[0..21), acc[21..27), acc[27].
template <int NACC>
__device__ __forceinline__ void accumulate(const Params& P, const Resid& r,
                                           float stf, float w, float cost,
                                           float (&acc)[NACC]) {
  acc[27] += cost;
  const float iz2 = r.iz * r.iz;
  // rows of J = A [I | -hat(pc)], A = -dproj/dpc
  float J[3][6];
  const float a00 = -P.fx * r.iz, a02 = P.fx * r.X * iz2;
  const float a11 = -P.fy * r.iz, a12 = P.fy * r.Y * iz2;
  const float a20 = a00 * stf;
  const float a22 = (P.fx * r.X * iz2 - P.bf * iz2) * stf;
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
    acc[21 + jj] -= (J[0][jj] * r.r0 + J[1][jj] * r.r1 + J[2][jj] * r.r2) * w;
}

// Damped system from the 28 reduced terms, its solve and the candidate pose.
template <bool kRecip, int NACC>
__device__ __forceinline__ Pose lm_step(const float (&acc)[NACC], float lam,
                                        const Pose& pose) {
  float H[6][6], bv[6], dx[6];
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
  chol_solve6<kRecip>(H, bv, dx);
  return se3_update(dx, pose);
}

__device__ __forceinline__ float next_lambda(float lam, bool accept) {
  return fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
}

// ---------------------------------------------------------------------------
// The kernel: one pass per iteration, compacted observations, optional cluster
// ---------------------------------------------------------------------------

constexpr int kAcc = 32;        // the 28 terms padded to a warp's width
constexpr int kObsFields = 10;  // pw 3, obs 3, isig, stereo, inlier, slot

// One step of the transposing butterfly: the lane whose bit OFF is clear keeps
// v[0..OFF) and hands v[OFF..2 OFF) to its partner, which keeps those.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[kAcc], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sum v[0..kTerms] (the 28 terms and the inlier count) over the T threads of
// each of the C blocks that work on one pose; every thread of every block
// returns with the same totals, bit for bit. `part` is this block's
// [2][C * T / 32][kAcc] buffer and `xch` counts the calls: they alternate
// between the two halves, because a warp may write its next partials while a
// slower one still reads these. One wait: the block's barrier or, in a
// cluster, the block's own mbarrier of that half (`bars`, armed by
// arm_exchange), on which the asynchronous remote stores of all blocks'
// warps are counted; a half is armed again as soon as its wait is over, which
// is before this block sends what lets a peer go on to that half's next use.
template <int T, int C>
__device__ __forceinline__ void reduce_terms(float (&v)[kAcc], float* part,
                                             unsigned bars, unsigned xch,
                                             int rank) {
  constexpr int W = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);   // lane l now holds the warp's total of term l
  part += (xch & 1u) * (C * W * kAcc);
  const int slot = (rank * W + warp) * kAcc + lane;
  if constexpr (C == 1) {
    part[slot] = v[0];
    __syncthreads();
  } else {
    const unsigned bar = bars + 8u * (xch & 1u);
    const unsigned dst = smem_u32(part + slot);
#pragma unroll
    for (int c = 0; c < C; ++c)
      st_async(peer_u32(dst, c), v[0], peer_u32(bar, c));
    mbar_wait(bar, (xch >> 1) & 1u);
    if (threadIdx.x == 0) mbar_expect(bar, 4u * C * W * kAcc);
  }
  float s = part[lane];
#pragma unroll
  for (int j = 1; j < C * W; ++j) s += part[j * kAcc + lane];
#pragma unroll
  for (int i = 0; i <= kTerms; ++i) v[i] = __shfl_sync(0xffffffffu, s, i);
}

// The two mbarriers of reduce_terms in a cluster: made and armed for their
// first use by one thread; a cluster barrier must follow before any block
// stores into another.
template <int T, int C>
__device__ __forceinline__ unsigned arm_exchange(unsigned long long* bars) {
  const unsigned b = smem_u32(bars);
  if (C > 1 && threadIdx.x == 0) {
    mbar_init(b, 1);
    mbar_init(b + 8u, 1);
    mbar_fence_init();
    mbar_expect(b, 4u * C * (T / 32) * kAcc);
    mbar_expect(b + 8u, 4u * C * (T / 32) * kAcc);
  }
  return b;
}

// Observation c of the compacted structure-of-arrays set so[field][cap].
__device__ __forceinline__ Obs load_obs(const Params& P, const float* so,
                                        int cap, int c) {
  Obs o;
  o.pwx = so[0 * cap + c]; o.pwy = so[1 * cap + c]; o.pwz = so[2 * cap + c];
  o.ou = so[3 * cap + c];  o.ov = so[4 * cap + c];  o.our = so[5 * cap + c];
  o.isig = so[6 * cap + c];
  o.stf = so[7 * cap + c];
  o.mask = 1.0f;
  o.d2 = P.d2s * o.stf + P.d2m * (1.0f - o.stf);
  return o;
}

template <int T, int C>
__host__ __device__ constexpr int part_floats() { return 2 * C * (T / 32) * kAcc; }

// kCompact false keeps every slot (masked ones with zero information): the
// one-pass schedule without the compaction, for timing each step on its own.
template <int T, bool kCompact, int C>
__global__ void __launch_bounds__(T)
pose_opt_kernel(const float* __restrict__ qt0, const float* __restrict__ pw,
                const float* __restrict__ ob, const float* __restrict__ isig,
                const uint8_t* __restrict__ stereo,
                const uint8_t* __restrict__ mask, float* __restrict__ qt_out,
                uint8_t* __restrict__ inlier_out, int N, Params P) {
  extern __shared__ __align__(16) float smem[];
  constexpr int W = T / 32;
  constexpr int kBal = kMaxObs / T;   // ballots of one warp's range of slots
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / C;
  const size_t base = (size_t)b * N;
  const int cap = (N + 31) & ~31;
  float* so = smem;                          // [kObsFields][cap]
  float* part = smem + kObsFields * cap;     // [2][C * W][kAcc]
  int* wcount = reinterpret_cast<int*>(part + part_floats<T, C>());   // [W]
  __shared__ __align__(8) unsigned long long bar_mem[2];
  const unsigned bars = arm_exchange<T, C>(bar_mem);

  // compact the valid observations, in slot order: warp w takes slots
  // [w * per, (w + 1) * per), counts them by ballot, and starts writing after
  // the counts of the warps before it
  const int per = (((N + W - 1) / W) + 31) & ~31;
  unsigned bal[kBal];
  int count = 0;
#pragma unroll
  for (int k = 0; k < kBal; ++k) {
    const int i = warp * per + k * 32 + lane;
    const bool in_range = k * 32 < per && i < N;
    const bool take = in_range && (!kCompact || mask[base + i] != 0);
    bal[k] = __ballot_sync(0xffffffffu, take);
    count += __popc(bal[k]);
  }
  if (lane == 0) wcount[warp] = count;
  __syncthreads();
  int start = 0, n_valid = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = wcount[w];
    if (w < warp) start += c;
    n_valid += c;
  }
#pragma unroll
  for (int k = 0; k < kBal; ++k) {
    const int i = warp * per + k * 32 + lane;
    if ((bal[k] >> lane) & 1u) {
      const int c = start + __popc(bal[k] & ((1u << lane) - 1u));
      const float* p3 = pw + (base + i) * 3;
      const float* o3 = ob + (base + i) * 3;
      so[0 * cap + c] = p3[0]; so[1 * cap + c] = p3[1]; so[2 * cap + c] = p3[2];
      so[3 * cap + c] = o3[0]; so[4 * cap + c] = o3[1]; so[5 * cap + c] = o3[2];
      so[6 * cap + c] =
          (kCompact || mask[base + i] != 0) ? isig[base + i] : 0.0f;
      so[7 * cap + c] = stereo[base + i] ? 1.0f : 0.0f;
      so[8 * cap + c] = (kCompact || mask[base + i] != 0) ? 1.0f : 0.0f;
      so[9 * cap + c] = __int_as_float(i);
    } else if (rank == 0 && k * 32 < per && i < N) {
      inlier_out[base + i] = 0;
    }
    start += __popc(bal[k]);
  }
  // every block of a cluster must run before its shared memory is written
  if constexpr (C == 1) __syncthreads(); else cg::this_cluster().sync();

  const float sq_s = sqrtf(P.d2s), sq_m = sqrtf(P.d2m);

  Pose pose;
  {
    const float* q = qt0 + (size_t)b * 8;
    pose.qw = q[0]; pose.qx = q[1]; pose.qy = q[2]; pose.qz = q[3];
    pose.tx = q[4]; pose.ty = q[5]; pose.tz = q[6];
  }

  // The schedule as one loop with one pass, one reduction and one solve in
  // its body (a kernel's code is fetched cold at every launch, so what is
  // written once is also fetched once): step (rnd, it) evaluates the 28
  // terms at the round's starting pose (it == 0: a fresh pass, which after
  // the first round also relabels the inliers there) or at the candidate of
  // iteration it - 1; one more step after the last round relabels at the
  // final pose and counts the inliers (term 28 of every pass).
  const int per_round = P.iters + 1;
  const int n_steps = P.rounds * per_round;
  Pose cand = pose;
  float lam = 1e-3f;
  float cur[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) cur[i] = 0.0f;
  float n_inliers = 0.0f;
  for (int step = 0; step <= n_steps; ++step) {
    const int rnd = step / per_round;
    const int it = step - rnd * per_round;
    const bool fresh = it == 0;
    const bool huber = rnd < P.rounds - 1;
    const bool relabel = fresh && step > 0;
    const Pose at = fresh ? pose : cand;

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int c = rank * T + tid; c < n_valid; c += C * T) {
      const Obs o = load_obs(P, so, cap, c);
      const Resid r = residual(P, at, o);
      float inl = so[8 * cap + c];
      if (relabel) {
        inl = (r.chi2 <= o.d2 ? 1.0f : 0.0f) * r.zok;
        if (!kCompact && o.isig <= 0.0f) inl = 0.0f;   // a masked slot
        so[8 * cap + c] = inl;
      }
      const float w_rob =
          huber ? fminf(1.0f, sqrtf(o.d2 / fmaxf(r.chi2, 1e-12f))) : 1.0f;
      const float w = o.isig * w_rob * inl * r.zok;
      // sqrt(d2) is one of two values, taken out of the loop
      const float sd2 = o.stf > 0.5f ? sq_s : sq_m;
      const float rho = (huber && r.chi2 > o.d2)
          ? 2.0f * sd2 * sqrtf(fmaxf(r.chi2, 1e-12f)) - o.d2 : r.chi2;
      accumulate(P, r, o.stf, w, rho * inl * r.zok, acc);
      acc[kTerms] += inl;
    }
    reduce_terms<T, C>(acc, part, bars, (unsigned)step, rank);
    n_inliers = acc[kTerms];
    if (step == n_steps) break;

    // a fresh pass opens the round; a candidate's pass is taken over when its
    // cost is lower: its sums are then the next iteration's H, b and cost
    const bool accept = fresh || acc[27] < cur[27];
    if (accept) {
      pose = at;
#pragma unroll
      for (int i = 0; i < kTerms; ++i) cur[i] = acc[i];
    }
    lam = fresh ? 1e-3f : next_lambda(lam, accept);
    if (it < P.iters) cand = lm_step<true>(cur, lam, pose);
  }

  // the labels, in the slots' original places
  for (int c = rank * T + tid; c < n_valid; c += C * T) {
    const int i = __float_as_int(so[9 * cap + c]);
    inlier_out[base + i] = so[8 * cap + c] > 0.5f ? 1 : 0;
  }
  if (tid == 0 && rank == 0) {
    float* q = qt_out + (size_t)b * 8;
    q[0] = pose.qw; q[1] = pose.qx; q[2] = pose.qy; q[3] = pose.qz;
    q[4] = pose.tx; q[5] = pose.ty; q[6] = pose.tz; q[7] = n_inliers;
  }
  // a block stays until no peer can still store into its shared memory
  if constexpr (C > 1) cg::this_cluster().sync();
}

// The kernel's serial skeleton without its per-observation arithmetic: a
// chain of `n` dependent reductions of the 28 terms over the same threads and
// blocks, each followed (with_solve) by the 6x6 solve and the pose update.
// Timed to reckon the kernel's floor.
template <int T, int C>
__global__ void __launch_bounds__(T)
reduce_chain_kernel(float* out, int n, int with_solve) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar_mem[2];
  const unsigned bars = arm_exchange<T, C>(bar_mem);
  int rank = 0;
  if constexpr (C > 1) {
    rank = (int)cg::this_cluster().block_rank();
    cg::this_cluster().sync();
  }
  Pose pose{1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float carry = 1.0f + 1e-3f * (float)threadIdx.x;
  for (int it = 0; it < n; ++it) {
    float acc[kAcc];
    int t = 0;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) {
#pragma unroll
      for (int kk = jj; kk < 6; ++kk)
        acc[t++] = jj == kk ? carry * 10.0f : carry * 1e-3f;
    }
#pragma unroll
    for (int i = 21; i < kAcc; ++i)
      acc[i] = i < kTerms ? carry * 1e-3f * (float)(i - 20) : 0.0f;
    reduce_terms<T, C>(acc, smem, bars, (unsigned)it, rank);
    if (with_solve) {
      pose = lm_step<true>(acc, 1e-3f, pose);
      carry = 1.0f + 1e-3f * pose.tx + 1e-3f * (float)threadIdx.x;
    } else {
      carry = 1.0f + 1e-9f * acc[27] + 1e-3f * (float)threadIdx.x;
    }
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = carry + pose.qw;
  if constexpr (C > 1) cg::this_cluster().sync();
}

// Launch `blocks` blocks in clusters of `cluster` (1: a plain launch) with
// `smem` bytes of dynamic shared memory.
template <typename... KArgs, typename... Args>
int launch_ex(void (*kern)(KArgs...), int blocks, int threads, int cluster,
              size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

struct Buffers {
  const float *qt0, *pw, *ob, *isig;
  const uint8_t *stereo, *mask;
  float* qt_out;
  uint8_t* inlier;
};

template <int T, bool kCompact, int C>
int launch(const Buffers& a, int B, int N, const Params& P, cudaStream_t s) {
  const int cap = (N + 31) & ~31;
  const size_t smem =
      (size_t)(kObsFields * cap + part_floats<T, C>() + T / 32) * 4;
  return launch_ex(pose_opt_kernel<T, kCompact, C>, B * C, T, C, smem, s,
                   a.qt0, a.pw, a.ob, a.isig, a.stereo, a.mask, a.qt_out,
                   a.inlier, N, P);
}

template <int T, int C>
int launch_chain(float* out, int n, int with_solve, cudaStream_t s) {
  return launch_ex(reduce_chain_kernel<T, C>, C, T, C,
                   (size_t)part_floats<T, C>() * 4, s, out, n, with_solve);
}

// What pose_opt_launch runs.
constexpr int kThreads = 256;
constexpr int kCluster = 4;

// ---------------------------------------------------------------------------
// The first design, kept for timing beside the present one
// ---------------------------------------------------------------------------

constexpr int kThreadsV1 = 256;
constexpr int kWarpsV1 = kThreadsV1 / 32;

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
    for (int w = 1; w < kWarpsV1; ++w) s += buf[w * kTerms + i];
    v[i] = s;
  }
}

template <int OPT>
__global__ void __launch_bounds__(kThreadsV1)
pose_opt_kernel_v1(const float* __restrict__ qt0, const float* __restrict__ pw,
                const float* __restrict__ ob, const float* __restrict__ isig,
                const uint8_t* __restrict__ stereo,
                const uint8_t* __restrict__ mask, float* __restrict__ qt_out,
                uint8_t* __restrict__ inlier_out, int N, Params P) {
  __shared__ float red[2][kWarpsV1 * kTerms];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N;

  Obs o[OPT];
  float inl[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int i = tid + j * kThreadsV1;
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
        accumulate(P, r, o[j].stf, w,
                   robust_cost(r, o[j], huber) * inl[j] * r.zok, acc);
      }
      block_sum<kTerms>(acc, red[phase]);
      phase ^= 1;

      const float cost0 = acc[27];
      const Pose cand = lm_step<false>(acc, lam, pose);

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
      lam = next_lambda(lam, accept);
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
    const int i = tid + j * kThreadsV1;
    if (i < N) inlier_out[base + i] = inl[j] > 0.5f ? 1 : 0;
  }
  block_sum<1>(n_in, red[phase]);
  if (tid == 0) {
    float* q = qt_out + (size_t)b * 8;
    q[0] = pose.qw; q[1] = pose.qx; q[2] = pose.qy; q[3] = pose.qz;
    q[4] = pose.tx; q[5] = pose.ty; q[6] = pose.tz; q[7] = n_in[0];
  }
}

template <int OPT>
int launch_v1(const Buffers& a, int B, int N, const Params& P,
              cudaStream_t s) {
  pose_opt_kernel_v1<OPT><<<B, kThreadsV1, 0, s>>>(
      a.qt0, a.pw, a.ob, a.isig, a.stereo, a.mask, a.qt_out, a.inlier, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N a pose may have (80 KB of shared memory at 10 floats each).
int pose_opt_max_obs() { return kMaxObs; }

// qt0, qt_out: [B, 8] float32 (qw qx qy qz tx ty tz, then unused / n_inliers)
// pw, ob: [B, N, 3] float32; isig: [B, N] float32
// stereo, mask, inlier: [B, N] bytes (0 / 1)
// Returns the CUDA error of the launch (0 on success), or -1 for a shape it
// refuses.
int pose_opt_launch(const void* qt0, const void* pw, const void* ob,
                    const void* isig, const void* stereo, const void* mask,
                    void* qt_out, void* inlier, int B, int N, float fx,
                    float fy, float cx, float cy, float bf, float d2m,
                    float d2s, int rounds, int iters, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxObs) return -1;
  const Params P{fx, fy, cx, cy, bf, d2m, d2s, rounds, iters};
  const Buffers a{(const float*)qt0, (const float*)pw, (const float*)ob,
                  (const float*)isig, (const uint8_t*)stereo,
                  (const uint8_t*)mask, (float*)qt_out, (uint8_t*)inlier};
  return launch<kThreads, true, kCluster>(a, B, N, P, (cudaStream_t)stream);
}

// The same function by the steps of the design, for timing each on its own:
// compact 0 keeps every slot in the loop, cluster is the number of blocks a
// pose gets. Returns -1 for a combination that is not built.
int pose_opt_launch_variant(const void* qt0, const void* pw, const void* ob,
                            const void* isig, const void* stereo,
                            const void* mask, void* qt_out, void* inlier,
                            int B, int N, float fx, float fy, float cx,
                            float cy, float bf, float d2m, float d2s,
                            int rounds, int iters, void* stream, int threads,
                            int compact, int cluster) {
  if (B <= 0 || N <= 0 || N > kMaxObs) return -1;
  const Params P{fx, fy, cx, cy, bf, d2m, d2s, rounds, iters};
  const Buffers a{(const float*)qt0, (const float*)pw, (const float*)ob,
                  (const float*)isig, (const uint8_t*)stereo,
                  (const uint8_t*)mask, (float*)qt_out, (uint8_t*)inlier};
  cudaStream_t s = (cudaStream_t)stream;
#define POSE_OPT_VARIANT(T, K, C)                              \
  if (threads == T && (compact != 0) == K && cluster == C)     \
    return launch<T, K, C>(a, B, N, P, s);
  POSE_OPT_VARIANT(256, false, 1)
  POSE_OPT_VARIANT(256, true, 1)
  POSE_OPT_VARIANT(256, true, 4)
#undef POSE_OPT_VARIANT
  return -1;
}

// The first design (N <= 2048): one block per pose, two passes an iteration.
int pose_opt_launch_v1(const void* qt0, const void* pw, const void* ob,
                       const void* isig, const void* stereo, const void* mask,
                       void* qt_out, void* inlier, int B, int N, float fx,
                       float fy, float cx, float cy, float bf, float d2m,
                       float d2s, int rounds, int iters, void* stream) {
  if (B <= 0 || N <= 0 || N > 8 * kThreadsV1) return -1;
  const Params P{fx, fy, cx, cy, bf, d2m, d2s, rounds, iters};
  const Buffers a{(const float*)qt0, (const float*)pw, (const float*)ob,
                  (const float*)isig, (const uint8_t*)stereo,
                  (const uint8_t*)mask, (float*)qt_out, (uint8_t*)inlier};
  cudaStream_t s = (cudaStream_t)stream;
  const int per_thread = (N + kThreadsV1 - 1) / kThreadsV1;
  if (per_thread <= 1) return launch_v1<1>(a, B, N, P, s);
  if (per_thread <= 2) return launch_v1<2>(a, B, N, P, s);
  if (per_thread <= 4) return launch_v1<4>(a, B, N, P, s);
  return launch_v1<8>(a, B, N, P, s);
}

// out: [1] float32. Runs n dependent reductions (with_solve: each followed by
// the solve and the pose update) on the threads of one pose of the variant
// (threads, cluster). Returns -1 for a combination that is not built.
int pose_opt_reduce_chain(void* out, int n, int with_solve, int threads,
                          int cluster, void* stream) {
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define POSE_OPT_CHAIN(T, C) \
  if (threads == T && cluster == C) return launch_chain<T, C>(o, n, with_solve, s);
  POSE_OPT_CHAIN(256, 1)
  POSE_OPT_CHAIN(256, 4)
#undef POSE_OPT_CHAIN
  return -1;
}

// Threads per block and blocks per pose of pose_opt_launch.
int pose_opt_threads() { return kThreads; }
int pose_opt_cluster() { return kCluster; }

}  // extern "C"
