// The FP64 tensor cores' mma.sync (sm_80 and up; m16n8k8 and m16n8k16 from
// sm_90): d += a * b on one 16 x 8 fragment of FP64 accumulators, K deep.
// A product of two doubles that came from bf16 or f32 values is exact, and
// the sums stay in FP64, so a kernel that rounds its result to float once
// matches a float64 plain version whatever order the sums take (to a
// last-bit tie in FP64). Used by csrc/stem.cu (m16n8k4) and by winograd.cuh's
// FP64 F(2,3) tile (kF64K deep).
//
// Lane l of the warp holds, with g = l / 4 and t = l % 4:
//   a[i] at row g + 8 (i % 2), k t + 4 (i / 2)   (K / 2 values)
//   b[j] at k t + 4 j, column g                  (K / 4 values)
//   d[i] at row g + 8 (i / 2), column 2 t + i % 2.
#pragma once

#include <cuda_runtime.h>

namespace wt {

// m16n8k4: a at rows g and g + 8, k t; b at k t, column g.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], const double (&b)[1]) {
  dmma(d, a, b[0]);
}

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

}  // namespace wt
