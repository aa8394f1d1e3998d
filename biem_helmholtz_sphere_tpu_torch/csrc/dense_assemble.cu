// KD: the dense BIEM matrix of the block-gather assembly.
//
// Replaces the block-gather branch of
// biem_helmholtz_sphere_tpu/biem/_core.py::_assemble (the [B, B'] pair-id
// gather from the unique-offset (S|R) stack, the row and column radial
// factors and the mirror parity fused into it, and the diagonal through an
// iota mask) and its single-sphere diagonal scatter:
//
//   A[k, b, b', h, h'] = (r[k, b, h] T[k, pid[k, b, b'], h, h']) c[k, b', h']
//       r = rowf * s, c = colf * s on a mirror block (b > b'), s_h = (-1)^{n_h}
//   A[k, b, b, h, h']  = delta_{hh'} diag[k, b, h]
//
// with one pair map for every k (a geometry shared by the batch) or one per
// k (geometry along the batch, each k's table holding its own offsets),
// written in one of two layouts by strides: pair-major [K, B, B', H, H']
// (dense GMRES) or [K, B, H, B', H'] (LU and calc.matrix; an [N, N]
// row-major matrix per k).  The last axis H' is contiguous in both.  In the
// second layout it can write a window of rows alone, r0 <= b H + h < r1
// (the row-sharded solve of parallel.sharded_solve; a window may cut a
// ball's rows): only the pairs of the balls that meet the window get CTAs,
// each CTA's tile is counted from the ball's first tile inside the window
// and clipped to it, and row r lands at r - r0.
//
// What bounds it on the H100: device memory bandwidth on the write.  At
// the bench (K = 4, B = 16, H = 1024, complex64) it writes 8.6 GB and
// reads the 0.8 GB table; two complex products per entry are far below
// the card's arithmetic rate.
//
// Design: a CTA per (pair (b, b'), tile of kRows rows h, k).  The pairs
// come from the host sorted by offset id, so the CTAs that read the same
// rows of one table block (the ~10 blocks of an offset at the bench, its
// pairs and their mirrors) run side by side and find them in L2; the
// diagonal pairs come last.
// Each thread owns V consecutive columns per pass (V = 2 for complex64
// with an even H and 16-byte aligned operands, else 1), keeps their
// column factors in registers, and walks the tile's rows: one 16-byte
// load of T, one broadcast load of the row factor, one 16-byte streaming
// store (st.global.cs, so the write stream does not evict the table from
// L2).  One thread writes each entry, with no atomics: results repeat bit
// for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows h of a CTA's tile

template <typename T>
__device__ __forceinline__ void store(c2_t<T>* p, c2_t<T> v) {
  __stcs(p, v);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dense_assemble_kernel(const c2_t<T>* __restrict__ table, const int* __restrict__ pairs,
                      long long pairs_k, const c2_t<T>* __restrict__ rowf,
                      const c2_t<T>* __restrict__ colf,
                      const T* __restrict__ sgn, const c2_t<T>* __restrict__ diag,
                      c2_t<T>* __restrict__ out, int B, int NO, int H, long long s_b,
                      long long s_bp, long long s_h, long long s_k, long long r0,
                      long long r1) {
  using T2 = c2_t<T>;
  const int k = blockIdx.z;
  const int* pk = pairs + k * pairs_k + 3 * blockIdx.x;  // pairs_k = 0: shared
  const int b = __ldg(pk);
  const int bp = __ldg(pk + 1);
  const int pid = __ldg(pk + 2);
  // this ball's rows inside the window [r0, r1) (all of them for the whole
  // matrix: r0 = 0, r1 = B H), and this CTA's tile of them
  const long long ball0 = (long long)b * H;
  const int lo = (int)max(r0 - ball0, 0LL);
  const int hi = (int)min(r1 - ball0, (long long)H);
  const int tile = lo / kRows + blockIdx.y;
  const int h0 = max(lo, tile * kRows);
  const int h1 = min(hi, (tile + 1) * kRows);
  if (h0 >= h1) return;
  // row h of the block at (b, b'): k s_k + b s_b + b' s_bp + h s_h - r0 s_h
  T2* base = out + ((long long)k * s_k + b * s_b + bp * s_bp - r0 * s_h);
  constexpr int kPass = kThreads * V;  // columns per pass

  if (b == bp) {  // diagonal block: delta_{hh'} diag[k, b, h]
    const T2* dv = diag + ((size_t)k * B + b) * H;
    const T2 zero = cmake<T>(0, 0);
    for (int c0 = V * threadIdx.x; c0 < H; c0 += kPass) {
      for (int h = h0; h < h1; ++h) {
        T2* dst = base + h * s_h + c0;
        if constexpr (V == 2) {
          const T2 d = __ldg(dv + h);
          const T2 v0 = c0 == h ? d : zero, v1 = c0 + 1 == h ? d : zero;
          __stcs(reinterpret_cast<float4*>(dst), make_float4(v0.x, v0.y, v1.x, v1.y));
        } else {
          store<T>(dst, c0 == h ? __ldg(dv + h) : zero);
        }
      }
    }
    return;
  }

  const bool mirror = b > bp;
  const T2* rr = rowf + ((size_t)k * B + b) * H;
  const T2* cc = colf + ((size_t)k * B + bp) * H;
  const T2* tb = table + ((size_t)k * NO + pid) * H * H;
  for (int c0 = V * threadIdx.x; c0 < H; c0 += kPass) {
    T2 cf[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = min(c0 + v, H - 1);
      const T2 x = __ldg(cc + col);
      cf[v] = mirror ? cscale<T>(x, __ldg(sgn + col)) : x;
    }
    for (int h = h0; h < h1; ++h) {
      T2 r = __ldg(rr + h);
      if (mirror) r = cscale<T>(r, __ldg(sgn + h));
      const T2* src = tb + (size_t)h * H + c0;
      T2* dst = base + h * s_h + c0;
      if constexpr (V == 2) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src));
        const T2 v0 = cmul<T>(cmul<T>(r, cmake<T>(t.x, t.y)), cf[0]);
        const T2 v1 = cmul<T>(cmul<T>(r, cmake<T>(t.z, t.w)), cf[1]);
        __stcs(reinterpret_cast<float4*>(dst), make_float4(v0.x, v0.y, v1.x, v1.y));
      } else {
        store<T>(dst, cmul<T>(cmul<T>(r, __ldg(src)), cf[0]));
      }
    }
  }
}

template <typename T, int V>
cudaError_t run(const void* table, const void* pairs, long long pairs_k, const void* rowf,
                const void* colf, const void* sgn, const void* diag, void* out, int K, int B,
                int NO, int H, int n_pairs, int n_tiles, long long s_b, long long s_bp,
                long long s_h, long long s_k, long long r0, long long r1, cudaStream_t st) {
  const dim3 grid(n_pairs, n_tiles, K);
  dense_assemble_kernel<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const c2_t<T>*>(table), static_cast<const int*>(pairs), pairs_k,
      static_cast<const c2_t<T>*>(rowf), static_cast<const c2_t<T>*>(colf),
      static_cast<const T*>(sgn), static_cast<const c2_t<T>*>(diag),
      static_cast<c2_t<T>*>(out), B, NO, H, s_b, s_bp, s_h, s_k, r0, r1);
  return cudaGetLastError();
}

}  // namespace

// table [K, NO, H, H]; pairs int32 [n_pairs, 3] = (b, b', offset id), the
// diagonal pairs' id unused, for every k (pairs_k = 0) or [K, n_pairs, 3]
// (pairs_k = 3 n_pairs); rowf, colf, diag [K, B, H]; sgn real [H];
// out: k at stride s_k, (b, b', h) at strides (s_b, s_bp, s_h) in elements,
// the flat rows b H + h of the window [r0, r1) (the whole matrix: 0, B H;
// a window needs s_b = H s_h, the [K, B, H, B', H'] layout), row r at
// r - r0; the pairs those of the balls that meet the window, n_tiles the
// most tiles of kRows rows that one of them has inside it.
// vec: complex64 operands 16-byte aligned with H even (two values a
// thread); ignored for complex128.
extern "C" int bhs_dense_assemble(const void* table, const void* pairs, long long pairs_k,
                                  const void* rowf, const void* colf, const void* sgn,
                                  const void* diag, void* out, int K, int B, int NO, int H,
                                  int n_pairs, int n_tiles, long long s_b, long long s_bp,
                                  long long s_h, long long s_k, long long r0, long long r1,
                                  int vec, int dbl, void* stream) {
  if (K <= 0 || B <= 0 || H <= 0 || n_pairs <= 0 || n_tiles <= 0) return 0;
  if (K > 65535 || n_tiles > 65535 || r0 < 0 || r1 > (long long)B * H || r0 >= r1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double, 1>(table, pairs, pairs_k, rowf, colf, sgn, diag, out, K, B, NO, H,
                               n_pairs, n_tiles, s_b, s_bp, s_h, s_k, r0, r1, st);
  if (vec)
    return (int)run<float, 2>(table, pairs, pairs_k, rowf, colf, sgn, diag, out, K, B, NO, H,
                              n_pairs, n_tiles, s_b, s_bp, s_h, s_k, r0, r1, st);
  return (int)run<float, 1>(table, pairs, pairs_k, rowf, colf, sgn, diag, out, K, B, NO, H,
                            n_pairs, n_tiles, s_b, s_bp, s_h, s_k, r0, r1, st);
}
