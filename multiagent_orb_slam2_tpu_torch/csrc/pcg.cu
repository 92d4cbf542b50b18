// Block-Jacobi preconditioned conjugate gradients on the dense reduced camera
// system of bundle adjustment: the whole solve on the device, no host read.
//
// Replaces the Pallas TPU kernel optim/ba_kernels.py::pcg_solve_pallas (inner
// `kernel`) of the JAX package: a fixed number of CG iterations on S x = rhs
// with S [D, D] symmetric positive definite, D = 6K, preconditioned by the
// inverses Dinv [K, 6, 6] of S's diagonal pose blocks; a warm start x0 is
// folded into the right-hand side (r0 = rhs - S x0), the iteration starts
// from zero and the result is x + x0; the denominators of alpha and beta are
// guarded at 1e-30. Operands and recurrences are float32.
//
// What bounds it on an H100: the function reads S once (D = 3072: 37.7 MB,
// 0.011 ms at the memory rate); every iteration's product reads it again from
// wherever a design keeps it, and two barriers an iteration set a serial floor
// of about 1 us each. Most of a bundle adjustment's system does not move:
// every fixed or invalid pose has an identity diagonal block, exactly zero
// coupling to the others, rhs 0 and a warm start of 0, and a local BA at the
// default capacities (K = 512) moves some tens of its poses. Such a pose is
// INERT: its six rows of S are zero outside its own 6x6 block and its block of
// r0 is zero. Then its r, z and p stay exactly 0 in every iteration, its terms
// add exact zeros to every other row and to both dot products, and its x is x0
// bit for bit. So CG on the live rows and columns alone is the same function,
// and a solve is:
//
//  1. pcg_live_rows_kernel: a warp a row reads S once (the function's one read
//     of it) and forms r0 = rhs - S x0 and whether the row couples its pose to
//     another; the test is on structure and r0, never on a caller's mask, so it
//     holds for any input;
//  2. pcg_live_compact_kernel: one block lists the live poses ascending with
//     their count (a fixed-order scan, no atomics) and writes x0 into the rows
//     of the inert poses;
//  3. the solve of the live system, DL = 6 x the count, on the path DL selects.
//     The host reads nothing: it queues every path that a DL <= D could take,
//     and a kernel that reads from device memory a DL that is not its case
//     returns at once:
//     - cluster path, DL <= 924 (600 where rows sum in float64: above it
//       the grid was faster): the live rows S[live, live] are gathered
//       straight from S (a pose's six columns are 24 contiguous bytes,
//       three 8-byte loads) into the shared memory of one thread-block
//       cluster, about 4 poses a block up to 8 blocks (16 above DL = 660),
//       and the loop touches no global memory: each block owns the rows of
//       a contiguous run of poses for the product AND for the update of x,
//       r and z = Dinv r, and what the other blocks need (the partials of
//       p.Ap and r.z, each block's slice of z) goes through distributed
//       shared memory, as asynchronous remote stores counted on the
//       receiver's mbarrier: two exchanges an iteration, no cluster
//       barrier;
//     - resident grid, up to what the grid's shared memory holds
//       (pcg_resident_cap: 2,376 with K = 512 on 132 SMs): a persistent
//       cooperative grid of one block per SM, the live poses dealt to the
//       blocks in contiguous runs; a block gathers its poses' rows once and
//       every product reads them from its own shared memory, and it owns
//       those poses' x, r and z there too. Only each block's slice of z and
//       the partials go through global memory (every block reads all of z
//       back to form p): two grid barriers an iteration;
//     - streaming grid, larger DL: the same loop with the own rows gathered
//       from L2 in every product, as the earlier design streamed all of S.
//     DL = 0 leaves x = x0 (the plain version's alpha is 0 / guard there).
//
// Row arithmetic follows the full system's size D, not DL: where D > 924
// (global and local BAs at the default capacities) every row of S p is summed
// in float64 and rounded once, whichever path the live system takes; a
// float32 row sum, whose rounding depends on the summation order, moved the
// early iterates of such an ill-conditioned system further from the plain
// version than reordering the plain version's poses does. For D <= 924 rows
// are summed in float32.
//
// pcg_launch_grid (the earlier design: all D rows streamed from L2 by a
// cooperative grid, a warp a row) and pcg_launch_cluster (all K poses on the
// cluster path) stay for timing scripts, which hold the present design
// against them in the same process.
//
// The dot products are reduced without atomics: per-block partials, then
// every block sums them in block order, so all blocks hold bit-identical alpha
// and beta and two launches agree bit for bit.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;     // partial-sum slots the scratch provides
constexpr int kCompactThreads = 1024;
constexpr int kRowF64From = 925;     // D from which rows of S p sum in float64
// Poses a block of the cluster gets at least on the live path: a small live
// system takes fewer blocks than the 8 a cluster may have (4 was as fast as
// one block a pose and faster than 8 or 16 from 40 live poses on; H100).
constexpr int kClusterMinPoses = 4;
// The largest live dimension the cluster path takes where rows sum in
// float64 (D > 924); larger live systems go to the grid, which was as fast
// at DL = 600 and faster at 900 (H100).
constexpr int kClusterMaxWide = 600;
constexpr size_t kSmemPerBlock = 232448;  // dynamic shared memory of one block

// Sum v over the block in a fixed order; every thread returns the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();               // red may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// Sum of the grid's n partials, read past L1 (other blocks wrote them).
__device__ __forceinline__ float grid_sum(const float* part, int n,
                                          float* red) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += __ldcg(part + i);
  return block_sum(acc, red);
}

__device__ __forceinline__ float guard(float v) {
  return fabsf(v) < 1e-30f ? 1e-30f : v;
}

// z = Dk r for one pose (Dk its 6x6 preconditioner block, read-only); returns
// r . z.
__device__ __forceinline__ float precondition(const float* __restrict__ Dk,
                                              const float rk[6], float* zk) {
  float rz = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float zi = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) zi += __ldg(Dk + 6 * i + j) * rk[j];
    zk[i] = zi;
    rz += rk[i] * zi;
  }
  return rz;
}

// Row stride of resident rows: a multiple of 4 floats, so that every row
// starts on a 16-byte boundary and a warp reads it as consecutive float4.
__host__ __device__ inline int row_stride(int D) { return (D + 3) & ~3; }

// First item of part b when n items are dealt to nb parts in contiguous runs
// whose lengths differ by at most one (the longer runs first).
__host__ __device__ inline int first_of(int n, int nb, int b) {
  const int base = n / nb, rem = n % nb;
  return b * base + (b < rem ? b : rem);
}

// ---------------------------------------------------------------------------
// The live poses: r0 and the coupling test in one read of S, then the list
// ---------------------------------------------------------------------------

// A warp a row: r0[row] = rhs[row] - (S x0)[row] (the row summed in Acc and
// rounded once; r0 = rhs without a warm start) and row_live[row] = 1 where
// the row has a nonzero entry outside its pose's diagonal block or r0 is not
// zero.
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
pcg_live_rows_kernel(const float* __restrict__ S,
                     const float* __restrict__ rhs,
                     const float* __restrict__ x0, float* __restrict__ r0,
                     int* __restrict__ row_live, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= D) return;                       // the whole warp
  const float* srow = S + (size_t)row * D;
  const unsigned d0 = (unsigned)(row - row % 6);
  Acc acc = 0;
  bool off = false;
  if ((D & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const float4* x4 = reinterpret_cast<const float4*>(x0);
#pragma unroll 4
    for (int c = lane; c < D / 4; c += 32) {
      const float4 a = __ldg(s4 + c);
      const unsigned col = 4u * c;
      off |= (a.x != 0.0f && col - d0 >= 6u) |
             (a.y != 0.0f && col + 1u - d0 >= 6u) |
             (a.z != 0.0f && col + 2u - d0 >= 6u) |
             (a.w != 0.0f && col + 3u - d0 >= 6u);
      if (x0 != nullptr) {
        const float4 b = __ldg(x4 + c);
        acc += (Acc)a.x * b.x + (Acc)a.y * b.y + (Acc)a.z * b.z
            + (Acc)a.w * b.w;
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float a = __ldg(srow + c);
      off |= a != 0.0f && (unsigned)c - d0 >= 6u;
      if (x0 != nullptr) acc += (Acc)a * __ldg(x0 + c);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  off = __any_sync(0xffffffffu, off);
  if (lane == 0) {
    float r = rhs[row];
    if (x0 != nullptr) r -= (float)acc;
    r0[row] = r;
    row_live[row] = (off || r != 0.0f) ? 1 : 0;
  }
}

// One block: live [K] the live poses ascending, then zeros; n_live [1] their
// count; x_out's rows of every inert pose = x0 (0 without a warm start).
__global__ void __launch_bounds__(kCompactThreads)
pcg_live_compact_kernel(const int* __restrict__ row_live,
                        const float* __restrict__ x0,
                        float* __restrict__ x_out, int* __restrict__ live,
                        int* __restrict__ n_live, int K) {
  __shared__ int warp_total[kCompactThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int base = 0;                       // poses listed by earlier passes
  for (int k0 = 0; k0 < K; k0 += kCompactThreads) {
    const int k = k0 + t;
    int f = 0;
    if (k < K) {
#pragma unroll
      for (int i = 0; i < 6; ++i) f |= row_live[6 * k + i];
      if (!f) {
#pragma unroll
        for (int i = 0; i < 6; ++i)
          x_out[6 * k + i] = x0 != nullptr ? x0[6 * k + i] : 0.0f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, f != 0);
    const int before = __popc(mask & ((1u << lane) - 1u));
    if (lane == 0) warp_total[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      int w = warp_total[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_total[lane] = w;           // inclusive
    }
    __syncthreads();
    if (f) live[base + (warp > 0 ? warp_total[warp - 1] : 0) + before] = k;
    base += warp_total[kCompactThreads / 32 - 1];
    __syncthreads();                  // warp_total is the next pass's
  }
  for (int j = base + t; j < K; j += kCompactThreads) live[j] = 0;
  if (t == 0) *n_live = base;
}

// ---------------------------------------------------------------------------
// Cluster path: the (live) rows resident in the shared memory of one cluster
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 16;          // blocks a cluster may have
constexpr int kPortableCluster = 8;      // largest size every launch may ask

// Floats of shared memory a block of an nb-block cluster needs for a system
// of dimension D; wide: rows summed in float64, p held in float64 (each of
// its float32 values exactly) so that a product converts only S's entries.
__host__ __device__ inline size_t cluster_smem_floats(int D, int nb,
                                                      bool wide = false) {
  const int ld = row_stride(D);
  const int poses = (D / 6 + nb - 1) / nb;
  const int rows = 6 * poses;
  const int rows4 = (rows + 3) & ~3;
  // S rows, p, z of all blocks, Ap / r / x / z of the own rows (each padded
  // to 4 floats), Dinv of the own poses, block_sum's buffer, the two dot
  // products' partials
  return (size_t)rows * ld + (wide ? 3 : 2) * (size_t)ld +
         4 * (size_t)rows4 + 36 * (size_t)poses + kWarps + 2 * kMaxCluster;
}

// Blocks of the cluster that holds dimension D, or 0 if none does: 8 (the
// largest portable size) where they hold S, else 16.
__host__ __device__ inline int cluster_blocks(int D, bool wide = false) {
  if (cluster_smem_floats(D, kPortableCluster, wide) * 4 <= kSmemPerBlock)
    return kPortableCluster;
  if (cluster_smem_floats(D, kMaxCluster, wide) * 4 <= kSmemPerBlock)
    return kMaxCluster;
  return 0;
}

// Blocks of an nb-block cluster launch that solve a live system of dimension
// DL: at least min_poses poses a block where the cluster holds the rows with
// fewer blocks, never fewer than the rows need, never more than nb; 0 where
// the launch cannot hold DL (another path's case, or DL = 0).
__host__ __device__ inline int cluster_active_blocks(int DL, int nb,
                                                     int min_poses,
                                                     bool wide) {
  const int need = DL > 0 ? cluster_blocks(DL, wide) : 0;
  if (need == 0 || need > nb) return 0;
  const int KL = DL / 6;
  int use = (KL + min_poses - 1) / min_poses;
  if (use > nb) use = nb;
  while (use < nb && cluster_smem_floats(DL, use, wide) * 4 > kSmemPerBlock)
    ++use;
  return use;
}

// The cluster path. kLive: the system is S[live, live] of the list the
// compaction left (r_init holds r0 = rhs - S x0 over whole rows), solved by
// the cluster's first cluster_active_blocks blocks; else all K poses, the
// warm start's product formed here, on every block of the cluster.
template <bool kLive, typename Acc>
__global__ void __launch_bounds__(kThreads)
pcg_cluster_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
                   const float* __restrict__ Dinv,
                   const float* __restrict__ x0, float* __restrict__ x_out,
                   const float* __restrict__ r_init,
                   const int* __restrict__ live,
                   const int* __restrict__ n_live, int D, int K, int n_iters,
                   int min_poses, int dl_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const int KL = kLive ? __ldg(n_live) : K;
  const int DL = 6 * KL;
  if (kLive && DL > dl_max) return;       // every block: the grid's case
  constexpr bool kWide = sizeof(Acc) == 8;
  const int nb = kLive ? cluster_active_blocks(DL, (int)cluster.num_blocks(),
                                               min_poses, kWide)
                       : (int)cluster.num_blocks();
  if (nb == 0) return;                    // every block: not this path's case
  const int rank = (int)cluster.block_rank();
  if (rank >= nb) {                       // a block the live system leaves idle
    cluster.sync();
    cluster.sync();
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_stride(DL);
  const int poses_max = (KL + nb - 1) / nb;
  const int rows_max = 6 * poses_max;
  const int k0 = first_of(KL, nb, rank);
  const int n_poses = first_of(KL, nb, rank + 1) - k0;
  const int r0 = 6 * k0;
  const int n_rows = 6 * n_poses;
  // the pose of S that row j of the (live) system is
  auto pose_of = [&](int k) { return kLive ? __ldg(live + k) : k; };

  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;                        // [rows_max][ld] own rows of S
  // [ld] search direction, all of it, in the row sums' type (its values are
  // float32's)
  Acc* p = reinterpret_cast<Acc*>(Ss + (size_t)rows_max * ld);
  float* zf = reinterpret_cast<float*>(p + ld);   // [ld] every block's z
  const int rows4 = (rows_max + 3) & ~3;
  float* zo = zf + ld;                     // [rows4] own z, before it is sent
  float* Apo = zo + rows4;                 // [rows4] own rows of S p
  float* ro = Apo + rows4;                 // [rows4] own residual
  float* xo = ro + rows4;                  // [rows4] own solution
  float* Dv = xo + rows4;                  // [poses_max][36] own Dinv blocks
  float* red = Dv + 36 * poses_max;        // [kWarps]
  float* part_pap = red + kWarps;          // [kMaxCluster] partials of p.Ap
  float* part_rz = part_pap + kMaxCluster; // [kMaxCluster] partials of r.z

  // An exchange is asynchronous remote stores counted on the
  // receiver's mbarrier (one barrier for p.Ap, one for z and r.z). A barrier
  // is armed for its next phase as soon as the last one is complete, which is
  // before this block sends anything that could make a peer send for that
  // phase; a peer's stores for a phase reach a block only after the block has
  // read what the phase before brought, so one buffer per exchange is enough.
  __shared__ __align__(8) unsigned long long bars[2];
  const unsigned bar_pap = smem_u32(&bars[0]);
  const unsigned bar_z = smem_u32(&bars[1]);
  const unsigned bytes_pap = 4u * nb, bytes_z = 4u * (DL + nb);
  unsigned phase_pap = 0, phase_z = 0;
  if (tid == 0) {
    mbar_init(bar_pap, 1);
    mbar_init(bar_z, 1);
    mbar_fence_init();
    mbar_expect(bar_pap, bytes_pap);
    mbar_expect(bar_z, bytes_z);
  }

  // the own rows of S, once
  if (kLive) {
    // row j, live pose c: S[6 live[k0 + j / 6] + j % 6, 6 live[c] + 0..5],
    // three 8-byte loads (D = 6K is even, so every pose block is 8-aligned)
    const int per_row = 3 * KL;
    for (int i = tid; i < n_rows * per_row; i += kThreads) {
      const int j = i / per_row, rem = i - j * per_row;
      const int c = rem / 3, h = rem - 3 * c;
      const size_t src = (size_t)(6 * pose_of(k0 + j / 6) + j % 6) * D +
                         6 * pose_of(c) + 2 * h;
      *reinterpret_cast<float2*>(Ss + (size_t)j * ld + 6 * c + 2 * h) =
          __ldg(reinterpret_cast<const float2*>(S + src));
    }
    for (int i = tid; i < n_rows * (ld - DL); i += kThreads)
      Ss[(size_t)(i / (ld - DL)) * ld + DL + i % (ld - DL)] = 0.0f;
  } else if ((D & 3) == 0) {
    const float4* src = reinterpret_cast<const float4*>(S + (size_t)r0 * D);
    float4* dst = reinterpret_cast<float4*>(Ss);
    const int n4 = n_rows * (D / 4);
#pragma unroll 4
    for (int i = tid; i < n4; i += kThreads) dst[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < n_rows * ld; i += kThreads) {
      const int row = i / ld, col = i - row * ld;
      Ss[i] = col < D ? __ldg(S + (size_t)(r0 + row) * D + col) : 0.0f;
    }
  }
  for (int i = tid; i < 36 * n_poses; i += kThreads)
    Dv[i] = __ldg(Dinv + 36 * pose_of(k0 + i / 36) + i % 36);
  for (int i = tid; i < ld; i += kThreads)
    p[i] = (!kLive && x0 != nullptr && i < D) ? x0[i] : 0.0f;
  // every block of the cluster must run before its shared memory is written
  cluster.sync();

  // Apo[j] = S[r0 + j, :] . p for the own rows, eight lanes to a row (a
  // quarter-warp reads 128 consecutive bytes of its row: no bank conflict
  // whatever the stride), each row summed in Acc and rounded once; returns,
  // in every lane of such a group, the group's sum of p[r0 + j] * Apo[j]
  auto matvec_own = [&]() {
    float vov = 0.0f;
    const int grp = tid >> 3, gl = tid & 7;
    for (int j0 = 0; j0 < n_rows; j0 += kThreads / 8) {
      const int j = j0 + grp;
      Acc acc0 = 0, acc1 = 0;
      if (j < n_rows) {
        const float4* s4 = reinterpret_cast<const float4*>(Ss + (size_t)j * ld);
#pragma unroll 4
        for (int c = gl; c < ld / 4; c += 8) {
          const float4 a = s4[c];
          if constexpr (kWide) {
            const double2 b0 = reinterpret_cast<const double2*>(p)[2 * c];
            const double2 b1 = reinterpret_cast<const double2*>(p)[2 * c + 1];
            acc0 += (double)a.x * b0.x + (double)a.y * b0.y;
            acc1 += (double)a.z * b1.x + (double)a.w * b1.y;
          } else {
            const float4 b = reinterpret_cast<const float4*>(p)[c];
            acc0 += a.x * b.x + a.y * b.y;
            acc1 += a.z * b.z + a.w * b.w;
          }
        }
      }
      Acc acc = acc0 + acc1;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const float accf = (float)acc;
      if (j < n_rows) {
        if (gl == 0) Apo[j] = accf;
        vov += (float)p[r0 + j] * accf;
      }
    }
    return vov;
  };

  // owners (one thread a pose): r -= alpha Ap (first: r = r0), x += alpha p,
  // z = Dinv r into zo; returns this thread's part of r . z
  auto update_own = [&](float alpha, bool first) {
    float rz_part = 0.0f;
    for (int k = tid; k < n_poses; k += kThreads) {
      const int g = 6 * pose_of(k0 + k);
      float rk[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int j = 6 * k + i;
        if (first) {
          if (kLive) {
            rk[i] = r_init[g + i];
          } else {
            rk[i] = rhs[r0 + j];
            if (x0 != nullptr) rk[i] -= Apo[j];
          }
          xo[j] = 0.0f;
        } else {
          xo[j] += alpha * (float)p[r0 + j];
          rk[i] = ro[j] - alpha * Apo[j];
        }
        ro[j] = rk[i];
      }
      const float* Dk = Dv + 36 * k;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float zi = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) zi += Dk[6 * i + j] * rk[j];
        zo[6 * k + i] = zi;
        rz_part += rk[i] * zi;
      }
    }
    return rz_part;
  };

  // send the own slice of z and the own partial of r . z to every block, wait
  // for everybody's, and return r . z summed in block order
  auto exchange_z = [&](float rz_part) {
    rz_part = block_sum(rz_part, red);       // its barriers also publish zo
    const bool by4 = ((r0 | n_rows) & 3) == 0;
    for (int c = warp; c < nb; c += kWarps) {   // a warp to a receiving block
      const unsigned dst = peer_u32(smem_u32(zf + r0), c);
      const unsigned bar = peer_u32(bar_z, c);
      if (by4) {
        for (int j = lane; j < n_rows / 4; j += 32)
          st_async4(dst + 16 * j, reinterpret_cast<const float4*>(zo)[j], bar);
      } else {
        for (int j = lane; j < n_rows; j += 32)
          st_async(dst + 4 * j, zo[j], bar);
      }
    }
    if (tid < nb)
      st_async(peer_u32(smem_u32(part_rz + rank), tid), rz_part,
               peer_u32(bar_z, tid));
    mbar_wait(bar_z, phase_z & 1u);
    ++phase_z;
    if (tid == 0) mbar_expect(bar_z, bytes_z);
    float rz = part_rz[0];
    for (int c = 1; c < nb; ++c) rz += part_rz[c];
    return rz;
  };

  // warm start on all poses: r0 = rhs - S x0 (p holds x0; own rows only, no
  // barrier); the live path was handed r0
  if (!kLive && x0 != nullptr) {
    matvec_own();
    __syncthreads();
  }
  float rz = exchange_z(update_own(0.0f, true));
  for (int i = tid; i < DL; i += kThreads) p[i] = zf[i];
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // Ap = S p on the own rows and p . Ap over the cluster
    float pap = matvec_own();
    pap = block_sum((tid & 7) == 0 ? pap : 0.0f, red);
    if (tid < nb)
      st_async(peer_u32(smem_u32(part_pap + rank), tid), pap,
               peer_u32(bar_pap, tid));
    mbar_wait(bar_pap, phase_pap & 1u);
    ++phase_pap;
    if (tid == 0) mbar_expect(bar_pap, bytes_pap);
    float pap_all = part_pap[0];
    for (int c = 1; c < nb; ++c) pap_all += part_pap[c];
    const float alpha = rz / guard(pap_all);

    const float rz_new = exchange_z(update_own(alpha, false));
    const float beta = rz_new / guard(rz);
    rz = rz_new;
    for (int i = tid; i < DL; i += kThreads)
      p[i] = zf[i] + beta * (float)p[i];
    __syncthreads();
  }

  for (int j = tid; j < n_rows; j += kThreads) {
    const int g = 6 * pose_of(k0 + j / 6) + j % 6;
    x_out[g] = xo[j] + (x0 != nullptr ? x0[g] : 0.0f);
  }
  // a block stays until no peer can still store into its shared memory
  cluster.sync();
}

// The cluster path's serial skeleton alone: n iterations of two block sums,
// two partials sent to every block, two waits for everybody's and two sums
// over the blocks, no matrix.
__global__ void __launch_bounds__(kThreads)
cluster_chain_kernel(float* out, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  __shared__ float red[kWarps];
  __shared__ float part[2][kMaxCluster];
  __shared__ __align__(8) unsigned long long bars[2];
  const unsigned bar[2] = {smem_u32(&bars[0]), smem_u32(&bars[1])};
  unsigned phase[2] = {0, 0};
  if (threadIdx.x == 0) {
    mbar_init(bar[0], 1);
    mbar_init(bar[1], 1);
    mbar_fence_init();
    mbar_expect(bar[0], 4u * nb);
    mbar_expect(bar[1], 4u * nb);
  }
  float carry = 1.0f + 1e-3f * (float)threadIdx.x;
  cluster.sync();
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = block_sum(carry, red);
      if (threadIdx.x < nb)
        st_async(peer_u32(smem_u32(&part[half][rank]), threadIdx.x), s,
                 peer_u32(bar[half], threadIdx.x));
      mbar_wait(bar[half], phase[half] & 1u);
      ++phase[half];
      if (threadIdx.x == 0) mbar_expect(bar[half], 4u * nb);
      float all = part[half][0];
      for (int c = 1; c < nb; ++c) all += part[half][c];
      carry = 1.0f + 1e-9f * all;
    }
  }
  // a block must stay until no peer can still store into it
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) out[0] = carry;
}

// Launch one cluster of nb blocks of `kern` with `smem` bytes each.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), int nb, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && nb > kPortableCluster)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Grid paths: a persistent cooperative grid
// ---------------------------------------------------------------------------

// out[row] = S[row, :] . v for this block's rows; returns, in every lane of a
// warp, that warp's sum of v[row] * out[row]. Each row's products are summed
// in Acc and rounded once (float64 on the grid path; Acc = float is the
// earlier float32-row design, kept for timing, pcg_launch_grid_f32rows).
template <typename Acc>
__device__ __forceinline__ float matvec_rows(const float* __restrict__ S,
                                             const float* v, float* out,
                                             int D) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int total = gridDim.x * kWarps;
  float vov = 0.0f;
  for (int row = gwarp; row < D; row += total) {
    const float* srow = S + (size_t)row * D;
    Acc acc = 0;
    if ((D & 3) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(srow);
      const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 4
      for (int c = lane; c < D / 4; c += 32) {
        const float4 a = __ldg(s4 + c);
        const float4 b = v4[c];
        acc += (Acc)a.x * b.x + (Acc)a.y * b.y + (Acc)a.z * b.z
            + (Acc)a.w * b.w;
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < D; c += 32)
        acc += (Acc)__ldg(srow + c) * v[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float accf = (float)acc;
    if (lane == 0) out[row] = accf;
    vov += v[row] * accf;
  }
  return vov;
}

// The earlier design: every row of S streamed from L2, all K poses, the warm
// start's product formed here. Kept for timing (pcg_launch_grid).
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
pcg_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
           const float* __restrict__ Dinv, const float* __restrict__ x0,
           float* __restrict__ x_out, float* Ap, float* r, float* z, float* x,
           float* part, int D, int K, int n_iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* p = smem;                         // [D] search direction
  float* red = smem + ((D + 3) & ~3);      // [kWarps]
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float* part_pap = part;
  float* part_rz = part + kMaxBlocks;

  // warm start: r0 = rhs - S x0
  if (x0 != nullptr) {
    for (int i = tid; i < D; i += kThreads) p[i] = x0[i];
    __syncthreads();
    matvec_rows<Acc>(S, p, Ap, D);
    grid.sync();
  }
  // owners: r0, z0 = Dinv r0, x = 0, partial r0 . z0
  float rz_part = 0.0f;
  for (int k = blockIdx.x + nb * tid; k < K; k += nb * kThreads) {
    float rk[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      rk[i] = rhs[6 * k + i];
      if (x0 != nullptr) rk[i] -= __ldcg(Ap + 6 * k + i);
      r[6 * k + i] = rk[i];
      x[6 * k + i] = 0.0f;
    }
    rz_part += precondition(Dinv + 36 * k, rk, z + 6 * k);
  }
  rz_part = block_sum(rz_part, red);
  if (tid == 0) part_rz[blockIdx.x] = rz_part;
  grid.sync();
  float rz = grid_sum(part_rz, nb, red);
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) p[i] = __ldcg(z + i);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // Ap = S p and p . Ap
    float pap = matvec_rows<Acc>(S, p, Ap, D);
    pap = block_sum(lane == 0 ? pap : 0.0f, red);
    if (tid == 0) part_pap[blockIdx.x] = pap;
    grid.sync();
    const float alpha = rz / guard(grid_sum(part_pap, nb, red));

    // owners: x += alpha p, r -= alpha Ap, z = Dinv r, partial r . z
    rz_part = 0.0f;
    for (int k = blockIdx.x + nb * tid; k < K; k += nb * kThreads) {
      float rk[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int e = 6 * k + i;
        x[e] += alpha * p[e];
        rk[i] = r[e] - alpha * __ldcg(Ap + e);
        r[e] = rk[i];
      }
      rz_part += precondition(Dinv + 36 * k, rk, z + 6 * k);
    }
    rz_part = block_sum(rz_part, red);
    if (tid == 0) part_rz[blockIdx.x] = rz_part;
    grid.sync();
    const float rz_new = grid_sum(part_rz, nb, red);
    const float beta = rz_new / guard(rz);
    rz = rz_new;
    __syncthreads();
    for (int i = tid; i < D; i += kThreads) p[i] = __ldcg(z + i) + beta * p[i];
    __syncthreads();
  }

  for (int k = blockIdx.x + nb * tid; k < K; k += nb * kThreads) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int e = 6 * k + i;
      x_out[e] = x[e] + (x0 != nullptr ? x0[e] : 0.0f);
    }
  }
}

// Floats of shared memory a block of a live grid needs for a live system of
// dimension DL in a system of K poses when it owns `poses` of them: p (float64,
// 2 ld), the list [K], Ap / r / x / z of the own rows, Dinv of the own poses,
// block_sum's buffer and, resident, the own rows of S [6 poses][ld].
__host__ __device__ inline size_t live_grid_smem_floats(int DL, int K,
                                                        int poses,
                                                        bool resident) {
  const int ld = row_stride(DL);
  const int rows = 6 * poses;
  const int rows4 = (rows + 3) & ~3;
  return 2 * (size_t)ld + (size_t)((K + 3) & ~3) + 4 * (size_t)rows4 +
         36 * (size_t)poses + kWarps +
         (resident ? (size_t)rows * ld : 0);
}

// The grid paths of the live system (rows of S p in float64, as D > 924
// asks). The live poses are dealt to the blocks in contiguous runs; a block
// owns their rows for the product AND for the update of x, r and
// z = Dinv r, which stay in its shared memory; only its slice of z and the
// two partials go through global memory, and every block reads all of z
// back to form p: two grid barriers an iteration. Resident (DL <= dl_res):
// the own rows of S are gathered into shared memory once and every product
// reads them there, a warp a row (float4); streaming (larger DL): every
// product gathers them from L2, a warp a row, lanes over consecutive 8-byte
// pieces of the live columns. p is held in float64 (its values are
// float32's), so a product converts only S's entries. The kernel runs only
// where DL > dl_lo (the cluster's case below) and returns at once elsewhere.
__global__ void __launch_bounds__(kThreads)
pcg_live_grid_kernel(const float* __restrict__ S,
                     const float* __restrict__ Dinv,
                     const float* __restrict__ x0, float* __restrict__ x_out,
                     const float* __restrict__ r_init,
                     const int* __restrict__ live,
                     const int* __restrict__ n_live, float* z, float* part,
                     int D, int K, int n_iters, int dl_lo, int dl_res) {
  const int KL = __ldg(n_live);
  const int DL = 6 * KL;
  if (DL <= dl_lo) return;                 // every block: the cluster's case
  const bool resident = DL <= dl_res;
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_stride(DL);
  const int poses_max = (KL + nb - 1) / nb;
  const int rows4 = (6 * poses_max + 3) & ~3;
  const int k0 = first_of(KL, nb, blockIdx.x);
  const int n_poses = first_of(KL, nb, blockIdx.x + 1) - k0;
  const int r0 = 6 * k0;
  const int n_rows = 6 * n_poses;
  float* part_pap = part;
  float* part_rz = part + kMaxBlocks;

  extern __shared__ __align__(16) float smem[];
  double* p = reinterpret_cast<double*>(smem);        // [ld] all of p
  int* lst = reinterpret_cast<int*>(smem + 2 * ld);   // [KL] live poses
  float* Apo = smem + 2 * ld + ((K + 3) & ~3);        // [rows4] own rows
  float* ro = Apo + rows4;
  float* xo = ro + rows4;
  float* zo = xo + rows4;
  float* Dv = zo + rows4;                             // [poses_max][36]
  float* red = Dv + 36 * poses_max;                   // [kWarps]
  float* Ss = red + kWarps;                           // [6 poses_max][ld]

  for (int i = tid; i < KL; i += kThreads) lst[i] = __ldg(live + i);
  for (int i = tid; i < ld; i += kThreads) p[i] = 0.0;
  __syncthreads();
  // the row of S that row j of the live system is
  auto grow = [&](int j) { return 6 * lst[j / 6] + j % 6; };
  for (int i = tid; i < 36 * n_poses; i += kThreads)
    Dv[i] = __ldg(Dinv + 36 * lst[k0 + i / 36] + i % 36);
  if (resident) {
    // row j, live pose c: three 8-byte loads (D = 6K is even, so every pose
    // block is 8-aligned)
    const int per_row = 3 * KL;
    for (int i = tid; i < n_rows * per_row; i += kThreads) {
      const int j = i / per_row, u = i - j * per_row;
      const int c = u / 3;
      const size_t src =
          (size_t)grow(r0 + j) * D + 6 * lst[c] + 2 * (u - 3 * c);
      *reinterpret_cast<float2*>(Ss + (size_t)j * ld + 2 * u) =
          __ldg(reinterpret_cast<const float2*>(S + src));
    }
    for (int i = tid; i < n_rows * (ld - DL); i += kThreads)
      Ss[(size_t)(i / (ld - DL)) * ld + DL + i % (ld - DL)] = 0.0f;
  }
  __syncthreads();

  // Apo[j] = S[r0 + j, live] . p for the own rows, each summed in float64
  // and rounded once; returns, in lane 0 of each warp, that warp's sum of
  // p[r0 + j] * Apo[j]
  auto matvec_own = [&]() {
    float vov = 0.0f;
    for (int j = warp; j < n_rows; j += kWarps) {
      double acc = 0.0;
      if (resident) {
        const float4* s4 = reinterpret_cast<const float4*>(Ss + (size_t)j * ld);
        const double2* p2 = reinterpret_cast<const double2*>(p);
#pragma unroll 4
        for (int c = lane; c < ld / 4; c += 32) {
          const float4 a = s4[c];
          const double2 b0 = p2[2 * c], b1 = p2[2 * c + 1];
          acc += (double)a.x * b0.x + (double)a.y * b0.y +
                 (double)a.z * b1.x + (double)a.w * b1.y;
        }
      } else {
        const float* srow = S + (size_t)grow(r0 + j) * D;
        const double2* p2 = reinterpret_cast<const double2*>(p);
#pragma unroll 4
        for (int u = lane; u < 3 * KL; u += 32) {
          const int c = u / 3;
          const float2 a = __ldg(reinterpret_cast<const float2*>(
              srow + 6 * lst[c] + 2 * (u - 3 * c)));
          const double2 b = p2[u];
          acc += (double)a.x * b.x + (double)a.y * b.y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const float accf = (float)acc;
      if (lane == 0) Apo[j] = accf;
      vov += (float)p[r0 + j] * accf;
    }
    return vov;
  };

  // owners (one thread a pose): r -= alpha Ap (first: r = r0), x += alpha p,
  // z = Dinv r into zo and the global z; returns this thread's part of r . z
  auto update_own = [&](float alpha, bool first) {
    float rz_part = 0.0f;
    for (int k = tid; k < n_poses; k += kThreads) {
      const int g = 6 * lst[k0 + k];
      float rk[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int j = 6 * k + i;
        if (first) {
          rk[i] = r_init[g + i];
          xo[j] = 0.0f;
        } else {
          xo[j] += alpha * (float)p[r0 + j];
          rk[i] = ro[j] - alpha * Apo[j];
        }
        ro[j] = rk[i];
      }
      const float* Dk = Dv + 36 * k;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float zi = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) zi += Dk[6 * i + j] * rk[j];
        zo[6 * k + i] = zi;
        z[r0 + 6 * k + i] = zi;
        rz_part += rk[i] * zi;
      }
    }
    return rz_part;
  };

  float rz_part = block_sum(update_own(0.0f, true), red);
  if (tid == 0) part_rz[blockIdx.x] = rz_part;
  grid.sync();
  float rz = grid_sum(part_rz, nb, red);
  __syncthreads();
  for (int i = tid; i < DL; i += kThreads) p[i] = __ldcg(z + i);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    float pap = matvec_own();
    pap = block_sum(lane == 0 ? pap : 0.0f, red);
    if (tid == 0) part_pap[blockIdx.x] = pap;
    grid.sync();
    const float alpha = rz / guard(grid_sum(part_pap, nb, red));

    rz_part = block_sum(update_own(alpha, false), red);
    if (tid == 0) part_rz[blockIdx.x] = rz_part;
    grid.sync();
    const float rz_new = grid_sum(part_rz, nb, red);
    const float beta = rz_new / guard(rz);
    rz = rz_new;
    __syncthreads();
    for (int i = tid; i < DL; i += kThreads)
      p[i] = __ldcg(z + i) + beta * (float)p[i];
    __syncthreads();
  }

  for (int j = tid; j < n_rows; j += kThreads) {
    const int g = grow(r0 + j);
    x_out[g] = xo[j] + (x0 != nullptr ? x0[g] : 0.0f);
  }
}

// The solver's serial skeleton alone: n iterations of two block sums, two
// partial writes, two grid barriers and two grid-wide sums, no matrix.
__global__ void __launch_bounds__(kThreads)
barrier_chain_kernel(float* part, float* out, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[kWarps];
  const int nb = gridDim.x;
  float carry = 1.0f + 1e-3f * (float)threadIdx.x;
  for (int it = 0; it < n; ++it) {
    for (int half = 0; half < 2; ++half) {
      float* slot = part + half * kMaxBlocks;
      const float s = block_sum(carry, red);
      if (threadIdx.x == 0) slot[blockIdx.x] = s;
      grid.sync();
      carry = 1.0f + 1e-9f * grid_sum(slot, nb, red);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = carry;
}

size_t smem_bytes(int D) { return (size_t)(((D + 3) & ~3) + kWarps) * 4; }

// Blocks of a cooperative launch of `kern` with `smem` bytes a block: `want`
// where the card holds that many at once, else as many as are co-resident
// (at most kMaxBlocks).
int coop_blocks(const void* kern, size_t smem, int want, int* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  *err = (int)e;
  if (e != cudaSuccess) return 0;
  int blocks = want;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks;
}

// Blocks of the earlier grid design for dimension D: a warp a row.
int grid_blocks(int D, int* err,
                const void* kern = (const void*)pcg_kernel<double>) {
  return coop_blocks(kern, smem_bytes(D), (D + kWarps - 1) / kWarps, err);
}

// The live grid: one block of the whole shared memory on every SM.
int resident_blocks(int* err) {
  return coop_blocks((const void*)pcg_live_grid_kernel, kSmemPerBlock,
                     kMaxBlocks, err);
}

// Shared memory of a resident block for the live system of dimension DL
// (K poses, nb blocks).
size_t resident_smem_bytes(int DL, int K, int nb) {
  return live_grid_smem_floats(DL, K, (DL / 6 + nb - 1) / nb, true) * 4;
}

// The largest live dimension the resident grid of nb blocks holds in a
// system of K poses.
int resident_cap(int K, int nb) {
  int cap = 0;
  for (int dl = 6; dl <= 6 * K && nb > 0; dl += 6) {
    if (resident_smem_bytes(dl, K, nb) > kSmemPerBlock) break;
    cap = dl;
  }
  return cap;
}

// Whether a solve of dimension D sums its rows in float64.
bool wide_rows(int D) { return D >= kRowF64From; }

// The largest live dimension an nb-block cluster launch of a solve of
// dimension D holds.
int cluster_cap(int D, int nb) {
  int cap = 0;
  for (int dl = 6; dl <= D; dl += 6) {
    const int need = cluster_blocks(dl, wide_rows(D));
    if (need == 0 || need > nb) break;
    cap = dl;
  }
  return cap;
}

// Blocks of the cluster a live solve of dimension D launches: enough for
// any live system of D's size the cluster can hold.
int live_cluster_launch(int D) {
  const int need = cluster_blocks(D, wide_rows(D));
  return need > 0 ? need : kMaxCluster;
}

// The largest live dimension the cluster path takes in a solve of dimension
// D: what its launch holds, where D > 924 at most cluster_max.
int cluster_dl_max(int D, int cluster_max) {
  const int cap = cluster_cap(D, live_cluster_launch(D));
  return wide_rows(D) && cluster_max < cap ? cluster_max : cap;
}

// Bytes of dynamic shared memory an nb-block launch asks for: the most any
// live system up to dimension dl_max needs.
size_t live_cluster_smem(int D, int nb, int min_poses, int dl_max) {
  size_t most = 0;
  const bool wide = wide_rows(D);
  for (int dl = 6; dl <= dl_max; dl += 6) {
    const size_t need = cluster_smem_floats(
        dl, cluster_active_blocks(dl, nb, min_poses, wide), wide) * 4;
    if (need > most) most = need;
  }
  return most;
}

int launch_grid(const void* kern, const void* S, const void* rhs,
                const void* Dinv, const void* x0, void* x_out, void* scratch,
                int D, int K, int n_iters, void* stream) {
  if (K <= 0 || D != 6 * K || n_iters < 0) return -1;
  int err = 0;
  const int blocks = grid_blocks(D, &err, kern);
  if (err != 0) return err;
  if (blocks <= 0) return -1;
  float* sc = (float*)scratch;
  float* Ap = sc;
  float* r = sc + D;
  float* z = sc + 2 * D;
  float* x = sc + 3 * D;
  float* part = sc + 4 * D;
  void* args[] = {(void*)&S, (void*)&rhs, (void*)&Dinv, (void*)&x0,
                  (void*)&x_out, (void*)&Ap, (void*)&r, (void*)&z, (void*)&x,
                  (void*)&part, (void*)&D, (void*)&K, (void*)&n_iters};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kern, dim3(blocks), dim3(kThreads), args, smem_bytes(D),
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Scratch layout (floats): Ap, r, z, x [D each] (the earlier grid design's;
// the live grids use z), the partials [2 kMaxBlocks], r0 [D], the rows'
// flags [D] (int), the live list [K] (int), its count [1] (int).
int scratch_live_offset(int D) { return 4 * D + 2 * kMaxBlocks + 2 * D; }

// scratch as for pcg_launch_grid, out [1] float32. Runs the barrier skeleton
// of n iterations on `blocks` blocks of a cooperative grid.
int barrier_chain(void* scratch, void* out, int D, int n, int blocks,
                  void* stream) {
  float* part = (float*)scratch + 4 * D;
  float* o = (float*)out;
  void* args[] = {(void*)&part, (void*)&o, (void*)&n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)barrier_chain_kernel, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the caller provides for dimension D.
int pcg_scratch_floats(int D) {
  return scratch_live_offset(D) + D / 6 + 4;
}

// Where the live list starts in the scratch (floats; the list is K int32,
// then their count, one int32).
int pcg_live_offset(int D) { return scratch_live_offset(D); }

// Blocks the earlier grid design's launch for dimension D uses (0 if the
// query failed).
int pcg_grid_blocks(int D) {
  int err = 0;
  return grid_blocks(D, &err);
}

// Blocks of the resident grid (0 if the query failed).
int pcg_resident_blocks() {
  int err = 0;
  return resident_blocks(&err);
}

// The largest live dimension the resident grid holds in a system of K poses.
int pcg_resident_cap(int K) {
  int err = 0;
  const int nb = resident_blocks(&err);
  return err != 0 ? 0 : resident_cap(K, nb);
}

// Blocks of the cluster that holds dimension D, or 0 where D is too large
// for the cluster path.
int pcg_cluster_blocks(int D) { return cluster_blocks(D); }

// Blocks of its cluster that a solve of dimension D puts to work on a live
// system of dimension DL, where that system takes the cluster path (0
// elsewhere).
int pcg_live_cluster_blocks(int D, int DL) {
  if (DL > cluster_dl_max(D, kClusterMaxWide)) return 0;
  return cluster_active_blocks(DL, live_cluster_launch(D), kClusterMinPoses,
                               wide_rows(D));
}

// Bytes of shared memory a block of an nb-block cluster needs for dimension D.
long long pcg_cluster_smem_bytes(int D, int nb) {
  return (long long)(cluster_smem_floats(D, nb) * 4);
}

// The path a live system of dimension DL takes in a solve of dimension D:
// 0 none (DL = 0: x = x0), 1 cluster, 2 the grid with the rows resident,
// 3 the grid streaming them; -1 if the grid's size cannot be read.
int pcg_path(int D, int DL) {
  if (DL <= 0) return 0;
  if (DL <= cluster_dl_max(D, kClusterMaxWide)) return 1;
  int err = 0;
  const int nb = resident_blocks(&err);
  if (err != 0) return -1;
  return DL <= resident_cap(D / 6, nb) ? 2 : 3;
}

// The earlier grid design for any D: all D rows streamed from L2, rows of
// S p in float64. S [D, D], rhs [D], Dinv [K, 6, 6], x0 [D] or null, x_out
// [D], scratch [pcg_scratch_floats(D)], all float32 on the device, D = 6K.
// Returns the CUDA error of the launch (0 on success), or -1 for a shape it
// refuses.
int pcg_launch_grid(const void* S, const void* rhs, const void* Dinv,
                    const void* x0, void* x_out, void* scratch, int D, int K,
                    int n_iters, void* stream) {
  return launch_grid((const void*)pcg_kernel<double>, S, rhs, Dinv, x0, x_out,
                     scratch, D, K, n_iters, stream);
}

// The earlier grid design with each row of S p summed in float32, its
// design before that (timing scripts only). Arguments as pcg_launch_grid.
int pcg_launch_grid_f32rows(const void* S, const void* rhs, const void* Dinv,
                            const void* x0, void* x_out, void* scratch, int D,
                            int K, int n_iters, void* stream) {
  return launch_grid((const void*)pcg_kernel<float>, S, rhs, Dinv, x0, x_out,
                     scratch, D, K, n_iters, stream);
}

// The cluster path on all K poses with a cluster of nb blocks (1..16; above
// 8 the size is not portable and the launch may be refused); rows of S p in
// float32. Arguments as pcg_launch_grid, without scratch. Returns -1 where
// the matrix does not fit.
int pcg_launch_cluster(const void* S, const void* rhs, const void* Dinv,
                       const void* x0, void* x_out, int D, int K, int n_iters,
                       int nb, void* stream) {
  if (K <= 0 || D != 6 * K || n_iters < 0 || nb < 1 || nb > kMaxCluster)
    return -1;
  const size_t smem = cluster_smem_floats(D, nb) * 4;
  if (smem > kSmemPerBlock) return -1;
  return launch_cluster(pcg_cluster_kernel<false, float>, nb, smem,
                        (cudaStream_t)stream, (const float*)S,
                        (const float*)rhs, (const float*)Dinv,
                        (const float*)x0, (float*)x_out, (const float*)nullptr,
                        (const int*)nullptr, (const int*)nullptr, D, K,
                        n_iters, 0, D);
}

// The solve on the live poses: the live rows' pass over S, the list, then
// every path the live dimension may take (each returns at once where it is
// not the case). min_poses: the fewest poses a block of the cluster path
// gets where fewer blocks hold the rows; cluster_max: where D > 924, the
// largest live dimension the cluster path takes (at most what it holds;
// larger ones go to the grid). Arguments as pcg_launch_grid.
int pcg_launch_live(const void* S, const void* rhs, const void* Dinv,
                    const void* x0, void* x_out, void* scratch, int D, int K,
                    int n_iters, int min_poses, int cluster_max,
                    void* stream) {
  if (K <= 0 || D != 6 * K || n_iters < 0 || min_poses < 1) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  float* r0 = sc + 4 * D + 2 * kMaxBlocks;
  int* row_live = (int*)(r0 + D);
  int* live = (int*)(sc + scratch_live_offset(D));
  int* n_live = live + K;
  const bool f64 = wide_rows(D);
  const int rows_blocks = (D + kWarps - 1) / kWarps;
  if (f64)
    pcg_live_rows_kernel<double><<<rows_blocks, kThreads, 0, st>>>(
        (const float*)S, (const float*)rhs, (const float*)x0, r0, row_live, D);
  else
    pcg_live_rows_kernel<float><<<rows_blocks, kThreads, 0, st>>>(
        (const float*)S, (const float*)rhs, (const float*)x0, r0, row_live, D);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  pcg_live_compact_kernel<<<1, kCompactThreads, 0, st>>>(
      row_live, (const float*)x0, (float*)x_out, live, n_live, K);
  e = (int)cudaGetLastError();
  if (e != 0) return e;

  const int nbc = live_cluster_launch(D);
  const int c_cap = cluster_dl_max(D, cluster_max);
  const size_t smem_c = live_cluster_smem(D, nbc, min_poses, c_cap);
  auto cluster = [&](auto kern) {
    return launch_cluster(kern, nbc, smem_c, st, (const float*)S,
                          (const float*)rhs, (const float*)Dinv,
                          (const float*)x0, (float*)x_out, (const float*)r0,
                          (const int*)live, (const int*)n_live, D, K, n_iters,
                          min_poses, c_cap);
  };
  if (c_cap > 0) {
    e = f64 ? cluster(pcg_cluster_kernel<true, double>)
            : cluster(pcg_cluster_kernel<true, float>);
    if (e != 0) return e;
  }
  if (D <= c_cap) return 0;
  // the grid runs only where D > 924, whose rows sum in float64
  int err = 0;
  const int nbr = resident_blocks(&err);
  if (err != 0) return err;
  if (nbr <= 0) return -1;
  const int r_cap = resident_cap(K, nbr);
  size_t smem = live_grid_smem_floats(D, K, (K + nbr - 1) / nbr, false) * 4;
  if (r_cap > c_cap) {
    const size_t res = resident_smem_bytes(r_cap, K, nbr);
    if (res > smem) smem = res;
  }
  float* z = sc + 2 * D;
  float* part = sc + 4 * D;
  const float* r0c = r0;
  const int* livec = live;
  const int* n_livec = n_live;
  void* args[] = {(void*)&S, (void*)&Dinv, (void*)&x0, (void*)&x_out,
                  (void*)&r0c, (void*)&livec, (void*)&n_livec, (void*)&z,
                  (void*)&part, (void*)&D, (void*)&K, (void*)&n_iters,
                  (void*)&c_cap, (void*)&r_cap};
  cudaError_t ce = cudaLaunchCooperativeKernel(
      (const void*)pcg_live_grid_kernel, dim3(nbr), dim3(kThreads), args,
      smem, st);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The solve: pcg_launch_live with the launcher's constants, at every D (on
// the BA path's own local BA, D = 384 with 7 live poses, it was faster than
// the cluster path on all 64 poses: H100). Arguments as pcg_launch_grid.
int pcg_launch(const void* S, const void* rhs, const void* Dinv,
               const void* x0, void* x_out, void* scratch, int D, int K,
               int n_iters, void* stream) {
  return pcg_launch_live(S, rhs, Dinv, x0, x_out, scratch, D, K, n_iters,
                         kClusterMinPoses, kClusterMaxWide, stream);
}

// The barrier skeleton on the earlier grid design's grid for dimension D.
int pcg_barrier_chain_grid(void* scratch, void* out, int D, int n,
                           void* stream) {
  int err = 0;
  const int blocks = grid_blocks(D, &err);
  if (err != 0) return err;
  if (blocks <= 0) return -1;
  return barrier_chain(scratch, out, D, n, blocks, stream);
}

// The barrier skeleton on the resident grid.
int pcg_barrier_chain_resident(void* scratch, void* out, int D, int n,
                               void* stream) {
  int err = 0;
  const int blocks = resident_blocks(&err);
  if (err != 0) return err;
  if (blocks <= 0) return -1;
  return barrier_chain(scratch, out, D, n, blocks, stream);
}

// out [1] float32. Runs the barrier skeleton of n iterations on one cluster
// of nb blocks.
int pcg_barrier_chain_cluster(void* out, int n, int nb, void* stream) {
  if (nb < 1 || nb > kMaxCluster) return -1;
  return launch_cluster(cluster_chain_kernel, nb, 0, (cudaStream_t)stream,
                        (float*)out, n);
}

}  // extern "C"
