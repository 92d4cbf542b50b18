// Exchange between the blocks of a thread-block cluster without a cluster
// barrier (sm_90); included by pose_opt.cu and pcg.cu.
//
// Hopper's asynchronous remote store: the value goes into another block's
// shared memory and its bytes are counted on an mbarrier there, so the
// receiver waits on its own barrier and the sender waits for nothing (a
// cluster barrier makes every block wait for every block's stores to be
// acknowledged). Addresses are 32-bit shared-memory addresses.

#pragma once

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}
__device__ __forceinline__ unsigned peer_u32(unsigned local, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void mbar_init(unsigned bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(arrivals) : "memory");
}
// The one arrival of a phase, with the bytes that phase is to receive.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Wait until the phase of the given parity is complete; what was stored for
// it is then visible. A wait of over a second traps instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 2000000000LL) __trap();
  }
}
__device__ __forceinline__ void st_async(unsigned dst, float v, unsigned bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];" :: "r"(dst), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async4(unsigned dst, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
