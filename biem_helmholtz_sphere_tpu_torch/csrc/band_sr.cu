// KS: the banded (S|R) (or (R|R)) table of any tree in d >= 3, with the
// exponent fold.
//
// Replaces biem_helmholtz_sphere_tpu/ops/pallas_sr.py::sr_banded_pallas
// (deleted in commit 545c0ad), whose work lives on in the JAX package's
// translation/_ops.py::_sr_banded (the masked band scan) and
// translation/_scaled.py::sr_banded_scaled (the same with per-band
// exponents), with the ball-max fold of biem/_core.py.
//
//   table[k, o, h', h] = i^{n_h' - n_h} sum_q F_N(q) conj(Y_h'(s_q)) Y_h(s_q)
//   F_N(q) = w_q sum_{n <= N} coef[k, o, N, n] C_n(t^_o . s_q),  N = n_h' + n_h
//
// with C_n the Gegenbauer polynomial of index nu = (d - 2) / 2, and coef the
// band coefficients i^n A_d rad_n(k |t_o|) (2n + d - 2) / ((d - 2) Omega_d),
// in the scaled modes times exp(min(he_n - he_N, 80)) (ops/band_sr.py).  The
// masked scan's sum over the bands n <= N of whole [H, H] contractions is the
// contraction of the prefix F_N: an entry still meets only the bands at or
// below its own Gaunt support, and each costs one complex product per node,
// not one per band.  In fold mode the store multiplies by
// exp(e_r[k, h'] + he[k, o, N] + e_b[k, h]), the exponents summed before the
// exp (only the sum is finite in float32).
//
// What bounds it on the H100: operations, 8 K NO Ho Hi Q real ones (one
// complex multiply-add per entry and node) at the card's peak for the type,
// 67 TFLOP/s in both: float32 on the CUDA cores (no TF32: the harmonic
// products cancel), float64 on the tensor cores (DMMA), which this kernel
// does not use yet (it runs on the CUDA cores); the table's write is a
// small fraction of that.
//
// Design: a CTA per (k, o) and tile of kRows rows of ONE root degree n' (the
// host cuts each row degree block into tiles, `row_tiles`) by kCols columns;
// the harmonics are sorted by degree, so the tile's N = n' + n spans the
// columns' narrow degree range.  The nodes go by in chunks of kQc: per chunk
// the CTA stages conj(Y) of its rows (conjugated as it reads them: rows and
// columns share one table when n_out == n_in) and Y of its columns, evaluates
// C_0..C_{N_hi} at each node by the three-term recurrence, forms F_N for the
// tile's range, and multiplies each column's Y by F at its N (the row degree
// being the tile's own); then each thread accumulates its 4 x 4 entries (rows
// ty + 8 i, columns tx + 32 j) with one complex multiply-add per entry and
// node, in the real type.  The sum over the nodes is taken in two levels,
// kGroup chunks (256 nodes) apart and then their partial sums: a sequential
// float32 sum over tens of thousands of nodes loses ~1e-4 of the small degree
// blocks, a two-level one ~1e-6, as the masked scan.  One thread writes each
// entry, in a fixed order: results repeat bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;      // rows of a CTA's tile (one root degree)
constexpr int kCols = 128;     // columns of a CTA's tile
constexpr int kQc = 32;        // quadrature nodes per chunk
constexpr int kGroup = 8;      // chunks summed apart before they join the total
constexpr int kMaxDim = 32;    // the largest d

// v * i^p, p in 0..3: exact
template <typename T>
__device__ __forceinline__ c2_t<T> rotate(c2_t<T> v, int p) {
  switch (p) {
    case 1: return cmake<T>(-v.y, v.x);
    case 2: return cmake<T>(-v.x, -v.y);
    case 3: return cmake<T>(v.y, -v.x);
    default: return v;
  }
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(kThreads)
band_sr_kernel(const c2_t<T>* __restrict__ coef, const T* __restrict__ he,
               const T* __restrict__ t_hat, long long t_k, const T* __restrict__ w,
               const T* __restrict__ s_cart, const c2_t<T>* __restrict__ yo,
               const c2_t<T>* __restrict__ yi, const int* __restrict__ n_o,
               const int* __restrict__ n_i, const int* __restrict__ row_tiles,
               const T* __restrict__ e_r, const T* __restrict__ e_b,
               c2_t<T>* __restrict__ out, int NO, int d, int Q, int Ho, int Hi, int NB,
               int col_tiles, int w_max, T nu) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* ya = reinterpret_cast<T2*>(smem_raw);  // [kQc][kRows] conj(Y_out)
  T2* yb = ya + kQc * kRows;                 // [kQc][kCols] Y_in, then Y_in F_N
  T2* fz = yb + kQc * kCols;                 // [kQc][w_max] F_{N_lo + j}
  T* cz = reinterpret_cast<T*>(fz + kQc * w_max);  // [kQc][NB] C_n
  __shared__ T th[kMaxDim];
  __shared__ int coff[kCols];  // each column's N - N_lo

  const int ko = blockIdx.x;
  const int k = ko / NO;
  const int o = ko - k * NO;
  const int rt = blockIdx.y / col_tiles;
  const int r0 = __ldg(row_tiles + 2 * rt);
  const int r1 = __ldg(row_tiles + 2 * rt + 1);
  const int c0 = (blockIdx.y - rt * col_tiles) * kCols;
  const int c1 = min(Hi, c0 + kCols);
  const int nr = __ldg(n_o + r0);  // the tile's one row degree
  const int n_lo = nr + __ldg(n_i + c0);
  const int n_hi = nr + __ldg(n_i + c1 - 1);
  const int W = n_hi - n_lo + 1;
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;

  if (tid < d) th[tid] = __ldg(t_hat + k * t_k + (long long)o * d + tid);
  for (int c = tid; c < kCols; c += kThreads)
    coff[c] = __ldg(n_i + min(c0 + c, Hi - 1)) + nr - n_lo;

  T2 acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = cmake<T>(0, 0);
  const T2* ck = coef + (size_t)ko * NB * NB;
  __syncthreads();

  for (int q0 = 0; q0 < Q; q0 += kQc) {
    // the chunk's harmonics, zero past the tile and past Q
    for (int e = tid; e < kQc * kRows; e += kThreads) {
      const int qq = e / kRows;
      const int r = r0 + e - qq * kRows;
      const int q = q0 + qq;
      T2 v = cmake<T>(0, 0);
      if (q < Q && r < r1) {
        v = __ldg(yo + (size_t)q * Ho + r);
        v.y = -v.y;
      }
      ya[e] = v;
    }
    for (int e = tid; e < kQc * kCols; e += kThreads) {
      const int qq = e / kCols;
      const int c = c0 + e - qq * kCols;
      const int q = q0 + qq;
      yb[e] = (q < Q && c < c1) ? __ldg(yi + (size_t)q * Hi + c) : cmake<T>(0, 0);
    }
    // C_0 .. C_{N_hi} at each node: (n + 1) C_{n+1} = 2 (n + nu) x C_n
    // - (n + 2 nu - 1) C_{n-1}
    if (tid < kQc) {
      const int q = q0 + tid;
      T x = 0;
      if (q < Q)
        for (int a = 0; a < d; ++a) x = t_fma(th[a], __ldg(s_cart + (size_t)a * Q + q), x);
      T cm = 0, cc = 1;
      T* cq = cz + tid * NB;
      for (int n = 0; n <= n_hi; ++n) {
        cq[n] = cc;
        const T cn = (2 * ((T)n + nu) * x * cc - ((T)n + 2 * nu - 1) * cm) / (T)(n + 1);
        cm = cc;
        cc = cn;
      }
    }
    __syncthreads();
    // F_N at the chunk's nodes for the tile's N_lo <= N <= N_hi
    for (int e = tid; e < kQc * W; e += kThreads) {
      const int qq = e / W;
      const int j = e - qq * W;
      const int q = q0 + qq;
      const int N = n_lo + j;
      T2 s = cmake<T>(0, 0);
      if (q < Q) {
        const T2* cN = ck + (size_t)N * NB;
        const T* cq = cz + qq * NB;
        for (int n = 0; n <= N; ++n) {
          const T2 cf = __ldg(cN + n);
          s.x = t_fma(cf.x, cq[n], s.x);
          s.y = t_fma(cf.y, cq[n], s.y);
        }
        s = cscale<T>(s, __ldg(w + q));
      }
      fz[qq * w_max + j] = s;
    }
    __syncthreads();
    // each column's Y times F at its N
    for (int e = tid; e < kQc * kCols; e += kThreads) {
      const int qq = e / kCols;
      yb[e] = cmul<T>(yb[e], fz[qq * w_max + coff[e - qq * kCols]]);
    }
    __syncthreads();
#pragma unroll 2
    for (int qq = 0; qq < kQc; ++qq) {
      T2 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ya[qq * kRows + ty + 8 * i];
        b[i] = yb[qq * kCols + tx + 32 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = cfma<T>(a[i], b[j], part[i][j]);
    }
    if ((q0 / kQc) % kGroup == kGroup - 1 || q0 + kQc >= Q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = cadd<T>(acc[i][j], part[i][j]);
          part[i][j] = cmake<T>(0, 0);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    if (r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 32 * j;
      if (c >= c1) continue;
      const int nc = coff[tx + 32 * j] + n_lo - nr;
      T2 v = rotate<T>(acc[i][j], (nr - nc) & 3);
      if constexpr (kFold)
        v = cscale<T>(v, t_exp(__ldg(e_r + (size_t)k * Ho + r) +
                               __ldg(he + (size_t)ko * NB + nr + nc) +
                               __ldg(e_b + (size_t)k * Hi + c)));
      out[((size_t)ko * Ho + r) * Hi + c] = v;
    }
  }
}

template <typename T, bool kFold>
cudaError_t run(const void* coef, const void* he, const void* t_hat, long long t_k,
                const void* w, const void* s_cart, const void* yo, const void* yi,
                const void* n_o, const void* n_i, const void* row_tiles, const void* e_r,
                const void* e_b, void* out, int K, int NO, int d, int Q, int Ho, int Hi,
                int NB, int n_row_tiles, int w_max, double nu, cudaStream_t st) {
  auto kernel = band_sr_kernel<T, kFold>;
  const size_t smem = (size_t)kQc * (kRows + kCols + w_max) * sizeof(c2_t<T>) +
                      (size_t)kQc * NB * sizeof(T);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (Hi + kCols - 1) / kCols;
  const dim3 grid((unsigned)(K * NO), (unsigned)(n_row_tiles * col_tiles));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const c2_t<T>*>(coef), static_cast<const T*>(he),
      static_cast<const T*>(t_hat), t_k, static_cast<const T*>(w),
      static_cast<const T*>(s_cart), static_cast<const c2_t<T>*>(yo),
      static_cast<const c2_t<T>*>(yi), static_cast<const int*>(n_o),
      static_cast<const int*>(n_i), static_cast<const int*>(row_tiles),
      static_cast<const T*>(e_r), static_cast<const T*>(e_b), static_cast<c2_t<T>*>(out), NO,
      d, Q, Ho, Hi, NB, col_tiles, w_max, (T)nu);
  return cudaGetLastError();
}

}  // namespace

// coef [K, NO, NB, NB] complex; he [K, NO, NB] real or null; t_hat real
// [K, NO, d] (t_k = NO d) or [NO, d] for every k (t_k = 0); w [Q], s_cart
// [d, Q] real; yo [Q, Ho] (Y_out, not conjugated), yi [Q, Hi] complex (the
// same array when n_out == n_in); n_o [Ho], n_i [Hi] int32,
// ascending, n_o[-1] + n_i[-1] < NB; row_tiles int32 [n_row_tiles, 2], the
// (first, end) rows of each tile, at most kRows rows of one degree; e_r
// [K, Ho], e_b [K, Hi] real or null; out [K, NO, Ho, Hi].  w_max: the widest
// N range of a tile (the column degrees of kCols columns).
extern "C" int bhs_band_sr(const void* coef, const void* he, const void* t_hat,
                           long long t_k, const void* w, const void* s_cart, const void* yo,
                           const void* yi, const void* n_o, const void* n_i,
                           const void* row_tiles, const void* e_r, const void* e_b, void* out,
                           int K, int NO, int d, int Q, int Ho, int Hi, int NB,
                           int n_row_tiles, int w_max, double nu, int fold, int dbl,
                           void* stream) {
  if (K <= 0 || NO <= 0 || Ho <= 0 || Hi <= 0 || Q <= 0) return 0;
  const long long tiles = (long long)n_row_tiles * ((Hi + kCols - 1) / kCols);
  if (d < 1 || d > kMaxDim || w_max <= 0 || w_max > NB || n_row_tiles <= 0 ||
      tiles > 65535 || (long long)K * NO > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)(fold ? run<double, true>(coef, he, t_hat, t_k, w, s_cart, yo, yi, n_o, n_i,
                                          row_tiles, e_r, e_b, out, K, NO, d, Q, Ho, Hi, NB,
                                          n_row_tiles, w_max, nu, st)
                      : run<double, false>(coef, he, t_hat, t_k, w, s_cart, yo, yi, n_o, n_i,
                                           row_tiles, e_r, e_b, out, K, NO, d, Q, Ho, Hi, NB,
                                           n_row_tiles, w_max, nu, st));
  return (int)(fold ? run<float, true>(coef, he, t_hat, t_k, w, s_cart, yo, yi, n_o, n_i,
                                       row_tiles, e_r, e_b, out, K, NO, d, Q, Ho, Hi, NB,
                                       n_row_tiles, w_max, nu, st)
                    : run<float, false>(coef, he, t_hat, t_k, w, s_cart, yo, yi, n_o, n_i,
                                        row_tiles, e_r, e_b, out, K, NO, d, Q, Ho, Hi, NB,
                                        n_row_tiles, w_max, nu, st));
}
