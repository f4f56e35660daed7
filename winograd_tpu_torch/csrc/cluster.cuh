// Thread-block cluster helpers (sm_90): the cluster barrier, a block's rank
// in its cluster, and loads from and stores to another block's shared
// memory through distributed shared memory. Shared by csrc/pointwise.cu
// (its MMA path's K splits reduced in a cluster), csrc/pointwise_int8.cu
// (the same, on s8 wgmma, and the row maxima its splits exchange), the
// heads' GEMVs of both (gemv_cluster.cuh: partials and maxima pushed to
// their owners) and csrc/winograd_int8.cu (the inverse reading the 16
// positions' M from the cluster's blocks).
#pragma once

#include "cp_async.cuh"

namespace wt {

// Every thread of every block of the cluster arrives, then waits: shared
// memory written before it by any block is seen after it by all of them.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same barrier in two halves: every thread arrives early (relaxed: it
// orders no memory access) and waits later, once it is about to store into
// another block's shared memory, which it may do only once every block of
// the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address in the cluster's window of shared address `addr` of block
// `rank`.
__device__ __forceinline__ unsigned rank_addr(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// The float at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ float load_rank(unsigned addr, unsigned rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(rank_addr(addr, rank))
               : "memory");
  return v;
}

// Stores the 32-bit word v at shared address `addr` of the cluster's block
// `rank`.
__device__ __forceinline__ void store_rank_u32(unsigned addr, unsigned rank, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(rank_addr(addr, rank)), "r"(v)
               : "memory");
}

// The 32-bit word at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ unsigned load_rank_u32(unsigned addr, unsigned rank) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(rank_addr(addr, rank))
               : "memory");
  return v;
}

}  // namespace wt
