// Asynchronous global -> shared copies (cp.async, sm_80 and up) for the
// multi-stage shared-memory rings of the wgmma tiles (A through
// mma_tf32.cuh's loader) and the FP64 F(2,3) tile.
//
// A copy whose `valid` is false reads nothing and zero-fills its shared
// bytes (src-size 0), so ragged tile edges need no second code path; the
// source pointer of such a copy is never dereferenced but must still be a
// global address, so callers pass the operand's base pointer.
//
// The 16-byte form is cp.async.cg: it bypasses the SM's L1, so it also
// reads data written earlier in the same launch behind a grid barrier
// (grid_sync.cuh). The 4-byte form exists only as .ca (L1-cached) and is
// for operands that no block of the launch writes.
#pragma once

#include <cuda_runtime.h>

namespace wt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace wt
