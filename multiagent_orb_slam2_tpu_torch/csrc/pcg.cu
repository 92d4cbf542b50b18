// Block-Jacobi preconditioned conjugate gradients on the dense reduced camera
// system of bundle adjustment: the whole solve in one launch.
//
// Replaces the Pallas TPU kernel optim/ba_kernels.py::pcg_solve_pallas (inner
// `kernel`) of the JAX package: a fixed number of CG iterations on S x = rhs
// with S [D, D] symmetric positive definite, D = 6K, preconditioned by the
// inverses Dinv [K, 6, 6] of S's diagonal pose blocks; a warm start x0 is
// folded into the right-hand side (rhs - S x0), the iteration starts from
// zero and the result is x + x0; the denominators of alpha and beta are
// guarded at 1e-30. All operands and recurrences are float32.
//
// What bounds it on an H100: S is read once per iteration (n_iters + 1 times
// with a warm start), 2 D^2 operations per read, so bytes against operations
// is 1 to 2 and the matrix stream decides; at every D up to 3072 (37.7 MB) S
// fits the 50 MB L2, and for small D the two barriers of an iteration cost
// more than the stream. Two paths, chosen by D alone:
//
//  - cluster path, for every D whose matrix fits the shared memory of one
//    thread-block cluster (8 blocks up to D = 660: the main path's D = 384
//    takes 74 KB a block; 16 blocks, a size the launch must ask leave for, up
//    to D = 924). The poses are dealt to the blocks in contiguous runs, a
//    block copies its rows of S into shared memory ONCE (16-byte loads, rows
//    padded to a multiple of 4 floats) and every matvec reads them from
//    there. A block owns the rows of its poses for the matvec AND for the
//    update of x, r and z = Dinv r (a pose's 6x6 block is applied by one
//    thread), so those never leave its shared memory. What the other blocks
//    need goes through distributed shared memory: each block sends its
//    partial of p^T S p, and later its slice of z and its partial of r^T z,
//    into every block's shared memory with asynchronous remote stores that
//    are counted on the receiver's mbarrier. A block waits on its own barrier
//    for the bytes it is owed: two such exchanges an iteration, no cluster
//    barrier and no global memory in the loop;
//  - grid path, for larger D: one persistent cooperative kernel. Rows of S
//    are dealt to warps round-robin over the whole grid and stream from L2
//    with 16-byte loads; the search direction p lives in every block's shared
//    memory, updated redundantly by each block, so an iteration needs two
//    grid barriers and not three; Ap, r, z and x go through global memory.
//
// On both paths the two dot products are reduced without atomics: per-block
// partials, then every block sums them in block order, so all blocks hold
// bit-identical alpha and beta and two launches agree bit for bit. The dense
// [D, D] preconditioner matrix of the TPU kernel is not needed.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;   // partial-sum slots the scratch provides

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

// ---------------------------------------------------------------------------
// Cluster path: S resident in the shared memory of one thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 16;          // blocks a cluster may have
constexpr int kPortableCluster = 8;      // largest size every launch may ask
constexpr size_t kSmemPerBlock = 232448; // dynamic shared memory of one block

// Row stride of the resident rows: a multiple of 4 floats, so that every row
// starts on a 16-byte boundary and a warp reads it as consecutive float4.
__host__ __device__ inline int row_stride(int D) { return (D + 3) & ~3; }

// First pose of block b when K poses are dealt to nb blocks in contiguous
// runs whose lengths differ by at most one (the longer runs first).
__host__ __device__ inline int first_pose(int K, int nb, int b) {
  const int base = K / nb, rem = K % nb;
  return b * base + (b < rem ? b : rem);
}

// Floats of shared memory a block of an nb-block cluster needs.
__host__ __device__ inline size_t cluster_smem_floats(int D, int nb) {
  const int ld = row_stride(D);
  const int poses = (D / 6 + nb - 1) / nb;
  const int rows = 6 * poses;
  const int rows4 = (rows + 3) & ~3;
  // S rows, p, z of all blocks, Ap / r / x / z of the own rows (each padded
  // to 4 floats), Dinv of the own poses, block_sum's buffer, the two dot
  // products' partials
  return (size_t)rows * ld + 2 * (size_t)ld + 4 * (size_t)rows4 +
         36 * (size_t)poses + kWarps + 2 * kMaxCluster;
}

// Blocks of the cluster that holds dimension D, or 0 if none does: 8 (the
// largest portable size) where they hold S, else 16.
int cluster_blocks(int D) {
  if (cluster_smem_floats(D, kPortableCluster) * 4 <= kSmemPerBlock)
    return kPortableCluster;
  if (cluster_smem_floats(D, kMaxCluster) * 4 <= kSmemPerBlock)
    return kMaxCluster;
  return 0;
}

__global__ void __launch_bounds__(kThreads)
pcg_cluster_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
                   const float* __restrict__ Dinv,
                   const float* __restrict__ x0, float* __restrict__ x_out,
                   int D, int K, int n_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_stride(D);
  const int poses_max = (K + nb - 1) / nb;
  const int rows_max = 6 * poses_max;
  const int k0 = first_pose(K, nb, rank);
  const int n_poses = first_pose(K, nb, rank + 1) - k0;
  const int r0 = 6 * k0;
  const int n_rows = 6 * n_poses;

  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;                        // [rows_max][ld] own rows of S
  float* p = Ss + (size_t)rows_max * ld;   // [ld] search direction, all of it
  float* zf = p + ld;                      // [ld] z, every block's slice
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
  const unsigned bytes_pap = 4u * nb, bytes_z = 4u * (D + nb);
  unsigned phase_pap = 0, phase_z = 0;
  if (tid == 0) {
    mbar_init(bar_pap, 1);
    mbar_init(bar_z, 1);
    mbar_fence_init();
    mbar_expect(bar_pap, bytes_pap);
    mbar_expect(bar_z, bytes_z);
  }

  // the own rows of S, once
  if ((D & 3) == 0) {
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
    Dv[i] = __ldg(Dinv + 36 * k0 + i);
  for (int i = tid; i < ld; i += kThreads)
    p[i] = (x0 != nullptr && i < D) ? x0[i] : 0.0f;
  // every block of the cluster must run before its shared memory is written
  cluster.sync();

  // Apo[j] = S[r0 + j, :] . p for the own rows, eight lanes to a row (a
  // quarter-warp reads 128 consecutive bytes of its row: no bank conflict
  // whatever the stride); returns, in every lane of such a group, the
  // group's sum of p[r0 + j] * Apo[j]
  auto matvec_own = [&]() {
    float vov = 0.0f;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int grp = tid >> 3, gl = tid & 7;
    for (int j0 = 0; j0 < n_rows; j0 += kThreads / 8) {
      const int j = j0 + grp;
      float acc0 = 0.0f, acc1 = 0.0f;
      if (j < n_rows) {
        const float4* s4 = reinterpret_cast<const float4*>(Ss + (size_t)j * ld);
#pragma unroll 4
        for (int c = gl; c < ld / 4; c += 8) {
          const float4 a = s4[c];
          const float4 b = p4[c];
          acc0 += a.x * b.x + a.y * b.y;
          acc1 += a.z * b.z + a.w * b.w;
        }
      }
      float acc = acc0 + acc1;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (j < n_rows) {
        if (gl == 0) Apo[j] = acc;
        vov += p[r0 + j] * acc;
      }
    }
    return vov;
  };

  // owners (one thread a pose): r -= alpha Ap (first: r = rhs - Ap), x +=
  // alpha p, z = Dinv r into zo; returns this thread's part of r . z
  auto update_own = [&](float alpha, bool first) {
    float rz_part = 0.0f;
    for (int k = tid; k < n_poses; k += kThreads) {
      float rk[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int j = 6 * k + i;
        if (first) {
          rk[i] = rhs[r0 + j];
          if (x0 != nullptr) rk[i] -= Apo[j];
          xo[j] = 0.0f;
        } else {
          xo[j] += alpha * p[r0 + j];
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

  // warm start: r0 = rhs - S x0 (p holds x0; own rows only, no barrier)
  if (x0 != nullptr) {
    matvec_own();
    __syncthreads();
  }
  float rz = exchange_z(update_own(0.0f, true));
  for (int i = tid; i < D; i += kThreads) p[i] = zf[i];
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
    for (int i = tid; i < D; i += kThreads) p[i] = zf[i] + beta * p[i];
    __syncthreads();
  }

  for (int j = tid; j < n_rows; j += kThreads)
    x_out[r0 + j] = xo[j] + (x0 != nullptr ? x0[r0 + j] : 0.0f);
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
// Grid path: S streamed from L2 by a cooperative grid
// ---------------------------------------------------------------------------

// out[row] = S[row, :] . v for this block's rows; returns, in every lane of a
// warp, that warp's sum of v[row] * out[row]. Each row's products are summed
// in float64 and rounded once: on an ill-conditioned system (a global BA's
// D = 3072) the rounding of a float32 sum, which depends on the summation
// order, moves the early iterates along directions S hardly sees by as much
// as reordering the plain version's poses does, more than the check against
// the plain version allows; summed in float64 the grid path stays close to a
// float64 CG. Acc = float is that earlier design, kept for timing it beside
// the present one (pcg_launch_grid_f32rows).
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
    const float* Dk = Dinv + 36 * k;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float zi = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) zi += __ldg(Dk + 6 * i + j) * rk[j];
      z[6 * k + i] = zi;
      rz_part += rk[i] * zi;
    }
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
      const float* Dk = Dinv + 36 * k;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float zi = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) zi += __ldg(Dk + 6 * i + j) * rk[j];
        z[6 * k + i] = zi;
        rz_part += rk[i] * zi;
      }
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

// Blocks of a cooperative launch of `kern` (a pcg_kernel) for dimension D:
// one warp per row where the card can hold that many blocks at once, else as
// many as are co-resident.
int grid_blocks(int D, int* err,
                const void* kern = (const void*)pcg_kernel<double>) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(D);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  *err = (int)e;
  if (e != cudaSuccess) return 0;
  int blocks = (D + kWarps - 1) / kWarps;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks;
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

}  // namespace

extern "C" {

// Floats of scratch the caller provides for dimension D (grid path only; the
// cluster path keeps everything in shared memory and ignores it).
int pcg_scratch_floats(int D) { return 4 * D + 2 * kMaxBlocks; }

// Blocks the grid path's launch for dimension D uses (0 if the query failed).
int pcg_grid_blocks(int D) {
  int err = 0;
  return grid_blocks(D, &err);
}

// Blocks of the cluster that pcg_launch uses for dimension D; 0 where D is
// too large for the cluster path and pcg_launch takes the grid path.
int pcg_cluster_blocks(int D) { return cluster_blocks(D); }

// Bytes of shared memory a block of an nb-block cluster needs for dimension D.
long long pcg_cluster_smem_bytes(int D, int nb) {
  return (long long)(cluster_smem_floats(D, nb) * 4);
}

// The grid path for any D. S [D, D], rhs [D], Dinv [K, 6, 6], x0 [D] or null,
// x_out [D], scratch [pcg_scratch_floats(D)], all float32 on the device,
// D = 6K. Returns the CUDA error of the launch (0 on success), or -1 for a
// shape it refuses.
int pcg_launch_grid(const void* S, const void* rhs, const void* Dinv,
                    const void* x0, void* x_out, void* scratch, int D, int K,
                    int n_iters, void* stream) {
  return launch_grid((const void*)pcg_kernel<double>, S, rhs, Dinv, x0, x_out,
                     scratch, D, K, n_iters, stream);
}

// The grid path with each row of S p summed in float32, its earlier design
// (timing scripts only). Arguments as pcg_launch_grid.
int pcg_launch_grid_f32rows(const void* S, const void* rhs, const void* Dinv,
                            const void* x0, void* x_out, void* scratch, int D,
                            int K, int n_iters, void* stream) {
  return launch_grid((const void*)pcg_kernel<float>, S, rhs, Dinv, x0, x_out,
                     scratch, D, K, n_iters, stream);
}

// The cluster path with a cluster of nb blocks (1..16; above 8 the size is
// not portable and the launch may be refused). Arguments as pcg_launch_grid,
// without scratch. Returns -1 where the matrix does not fit.
int pcg_launch_cluster(const void* S, const void* rhs, const void* Dinv,
                       const void* x0, void* x_out, int D, int K, int n_iters,
                       int nb, void* stream) {
  if (K <= 0 || D != 6 * K || n_iters < 0 || nb < 1 || nb > kMaxCluster)
    return -1;
  const size_t smem = cluster_smem_floats(D, nb) * 4;
  if (smem > kSmemPerBlock) return -1;
  return launch_cluster(pcg_cluster_kernel, nb, smem, (cudaStream_t)stream,
                        (const float*)S, (const float*)rhs,
                        (const float*)Dinv, (const float*)x0, (float*)x_out,
                        D, K, n_iters);
}

// The solve: the cluster path where pcg_cluster_blocks(D) > 0, else the grid
// path (which alone reads `scratch`). Arguments as pcg_launch_grid.
int pcg_launch(const void* S, const void* rhs, const void* Dinv,
               const void* x0, void* x_out, void* scratch, int D, int K,
               int n_iters, void* stream) {
  const int nb = cluster_blocks(D);
  if (nb > 0)
    return pcg_launch_cluster(S, rhs, Dinv, x0, x_out, D, K, n_iters, nb,
                              stream);
  return pcg_launch_grid(S, rhs, Dinv, x0, x_out, scratch, D, K, n_iters,
                         stream);
}

// scratch as for pcg_launch_grid, out [1] float32. Runs the barrier skeleton
// of n iterations on the grid that the grid path uses for dimension D.
int pcg_barrier_chain_grid(void* scratch, void* out, int D, int n,
                           void* stream) {
  int err = 0;
  const int blocks = grid_blocks(D, &err);
  if (err != 0) return err;
  if (blocks <= 0) return -1;
  float* part = (float*)scratch + 4 * D;
  float* o = (float*)out;
  void* args[] = {(void*)&part, (void*)&o, (void*)&n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)barrier_chain_kernel, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out [1] float32. Runs the barrier skeleton of n iterations on one cluster
// of nb blocks.
int pcg_barrier_chain_cluster(void* out, int n, int nb, void* stream) {
  if (nb < 1 || nb > kMaxCluster) return -1;
  return launch_cluster(cluster_chain_kernel, nb, 0, (cudaStream_t)stream,
                        (float*)out, n);
}

// The barrier skeleton of the path that pcg_launch takes for dimension D.
int pcg_barrier_chain(void* scratch, void* out, int D, int n, void* stream) {
  const int nb = cluster_blocks(D);
  if (nb > 0) return pcg_barrier_chain_cluster(out, n, nb, stream);
  return pcg_barrier_chain_grid(scratch, out, D, n, stream);
}

}  // extern "C"
