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
// fits the 50 MB L2, so after the first pass the stream comes from L2, and
// for small D the two grid-wide barriers of an iteration cost more than the
// stream. The design: one persistent cooperative kernel. Rows of S are dealt
// to warps round-robin over the whole grid and a warp reduces its row with
// 16-byte loads and shuffles; the search direction p lives in every block's
// shared memory, updated redundantly by each block, so an iteration needs two
// grid barriers and not three: one after the matvec (p^T S p) and one after
// the owners' update of x, r and z = Dinv r (r^T z). A pose's six unknowns
// are owned by one thread, which applies its 6x6 block directly: the dense
// [D, D] preconditioner matrix of the TPU kernel is not needed. The two dot
// products are reduced without atomics: per-block partials go to a small
// global buffer and, after the barrier, every block sums them in the same
// order, so all blocks hold bit-identical alpha and beta and two launches
// agree bit for bit.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

// out[row] = S[row, :] . v for this block's rows; returns, in every lane of a
// warp, that warp's sum of v[row] * out[row].
__device__ __forceinline__ float matvec_rows(const float* __restrict__ S,
                                             const float* v, float* out,
                                             int D) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int total = gridDim.x * kWarps;
  float vov = 0.0f;
  for (int row = gwarp; row < D; row += total) {
    const float* srow = S + (size_t)row * D;
    float acc = 0.0f;
    if ((D & 3) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(srow);
      const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 4
      for (int c = lane; c < D / 4; c += 32) {
        const float4 a = __ldg(s4 + c);
        const float4 b = v4[c];
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < D; c += 32) acc += __ldg(srow + c) * v[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = acc;
    vov += v[row] * acc;
  }
  return vov;
}

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
    matvec_rows(S, p, Ap, D);
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
    float pap = matvec_rows(S, p, Ap, D);
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

// Blocks of a cooperative launch for dimension D: one warp per row where the
// card can hold that many blocks at once, else as many as are co-resident.
int grid_blocks(int D, int* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(D);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(pcg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel,
                                                      kThreads, smem);
  *err = (int)e;
  if (e != cudaSuccess) return 0;
  int blocks = (D + kWarps - 1) / kWarps;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks;
}

}  // namespace

extern "C" {

// Floats of scratch the caller provides for dimension D.
int pcg_scratch_floats(int D) { return 4 * D + 2 * kMaxBlocks; }

// Blocks the launch for dimension D will use (0 if the query failed).
int pcg_grid_blocks(int D) {
  int err = 0;
  return grid_blocks(D, &err);
}

// S [D, D], rhs [D], Dinv [K, 6, 6], x0 [D] or null, x_out [D], scratch
// [pcg_scratch_floats(D)], all float32 on the device, D = 6K.
// Returns the CUDA error of the launch (0 on success), or -1 for a shape it
// refuses.
int pcg_launch(const void* S, const void* rhs, const void* Dinv,
               const void* x0, void* x_out, void* scratch, int D, int K,
               int n_iters, void* stream) {
  if (K <= 0 || D != 6 * K || n_iters < 0) return -1;
  int err = 0;
  const int blocks = grid_blocks(D, &err);
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
      (void*)pcg_kernel, dim3(blocks), dim3(kThreads), args, smem_bytes(D),
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// scratch as for pcg_launch, out [1] float32. Runs the barrier skeleton of n
// iterations on the grid that pcg_launch uses for dimension D.
int pcg_barrier_chain(void* scratch, void* out, int D, int n, void* stream) {
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

}  // extern "C"
