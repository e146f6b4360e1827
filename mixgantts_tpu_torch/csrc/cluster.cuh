// Thread-block clusters on Hopper (sm_90a): a CTA's rank, addresses in
// another CTA's shared memory, bulk copies between shared memories that
// complete on the receiver's mbarrier, the cluster barrier, and mbarrier
// arrivals and waits across the cluster.
//
// The denoiser kernel (denoiser_stack.cu) and the whole-stage MRF kernel
// (mrf_stack_streamed.cu) all-gather their bf16 operand tiles across a
// cluster with these.  Each library includes this header from one
// translation unit, so its definitions have internal linkage.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory byte in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// `bytes` of this CTA's shared memory at src to dst in another CTA of the
// cluster, completing on that CTA's mbarrier bar (both mapped addresses).
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This thread's shared-memory writes (generic proxy) made visible to the
// async proxy: wgmma's reads and the bulk copies to the other CTAs.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival, with release at cluster scope, on the mbarrier at `bar` in
// CTA `rank` of the cluster (`bar` is this CTA's address of it).
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(map_rank(bar, rank)) : "memory");
}

// Wait, with acquire at cluster scope, until the phase of this CTA's
// mbarrier `bar` with this parity has completed (its arrivals came from
// other CTAs).  Traps after ~2^28 polls instead of holding the card.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

}  // namespace
