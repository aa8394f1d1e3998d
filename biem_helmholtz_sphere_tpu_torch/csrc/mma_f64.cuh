// The FP64 tensor-core products of Hopper KS and K3 use (mma.sync m16n8k16
// and m16n8k8 with .f64 operands), one warp: D[16 x 8] += A[16 x K]
// B[K x 8].  With g = lane / 4 and t = lane % 4, each lane holds
//   a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],  i < K / 2,
//   b[i] = B[t + 4 i][g],                    i < K / 4,
//   d[i] = D[g + 8 (i / 2)][2 t + i % 2],    i < 4.
// KS's and K3's card tests hold this layout against their plain versions.
#pragma once

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
