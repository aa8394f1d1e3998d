// KG: the 2D Graf (S|R) table, with the exponent fold.
//
// Replaces biem_helmholtz_sphere_tpu/translation/_scaled.py::graf_2d_scaled
// with the ball-max fold of biem/_core.py (offset table, dense assembly) and
// biem/_lattice.py (the kernel build), and translation/_ops.py::_graf_2d
// (unscaled): gathers, i-powers and exponentials that XLA fused on the TPU.
//
//   table[k, o, h', h] = tab[k, o, |mu|] sqrt(2/pi) i^p e^{i mu theta[k, o]}
//                        exp(e_r[k, h'] + e[k, o, |mu|] + e_b[k, h])
//   mu = m_in[h] - m_out[h'],  p = |m_out[h']| - |m_in[h]| + |mu|
//
// with tab the h (or j) of the d = 2 family at k |t| (K5), or its mantissa
// and e its exponent; without e (zero-exponent mode) every exponent is 0
// and the factor is left out.
//
// What bounds it on the H100: device memory bandwidth on the write, K NO Ho
// Hi entries of 8 or 16 bytes.  The reads (one order table per (k, o), the
// order and exponent vectors) are a few per cent of that.
//
// Design: a CTA per (k, o) and tile of `rows` rows h'.  It stages that
// (k, o)'s phase table w[mu] = tab[|mu|] sqrt(2/pi) e^{i mu theta} for every
// signed mu in shared memory (mu theta taken in the real type, then sincos:
// |mu theta| reaches hundreds of radians at large n_end, so no fast-math
// intrinsics), and the exponents e[|mu|] in fold mode.  Then one thread per
// output entry, consecutive threads along h: a shared-memory read, the
// rotation by i^p (p mod 4, p possibly negative), the factor exp of the
// exponent sum taken in the real type (only the sum is finite in float32),
// and one streaming store.  One thread writes each entry, so results repeat
// bit for bit.
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void t_sincos(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void t_sincos(double a, double* s, double* c) { sincos(a, s, c); }

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
graf_fold_kernel(const c2_t<T>* __restrict__ tab, const T* __restrict__ etab,
                 const T* __restrict__ theta, long long theta_k,
                 const int* __restrict__ m_out, const int* __restrict__ m_in,
                 const T* __restrict__ e_r, const T* __restrict__ e_b,
                 c2_t<T>* __restrict__ out, int NO, int NMU, int Ho, int Hi, int rows,
                 int row_tiles, T scale) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* w = reinterpret_cast<T2*>(smem_raw);  // [2 NMU - 1], signed mu + NMU - 1
  T* ex = reinterpret_cast<T*>(w + (2 * NMU - 1));  // [NMU] (fold mode)
  const int k = blockIdx.y;
  const int o = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - o * row_tiles) * rows;
  const size_t ko = (size_t)k * NO + o;
  const T th = __ldg(theta + k * theta_k + o);
  const T2* tk = tab + ko * NMU;
  for (int i = threadIdx.x; i < 2 * NMU - 1; i += kThreads) {
    const int mu = i - (NMU - 1);
    T s, c;
    t_sincos((T)mu * th, &s, &c);
    w[i] = cmul<T>(cscale<T>(__ldg(tk + abs(mu)), scale), cmake<T>(c, s));
  }
  if constexpr (kFold) {
    for (int i = threadIdx.x; i < NMU; i += kThreads) ex[i] = __ldg(etab + ko * NMU + i);
  }
  __syncthreads();

  const int r1 = min(Ho, r0 + rows);
  const int n = (r1 - r0) * Hi;
  T2* dst = out + (ko * Ho + r0) * Hi;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = r0 + e / Hi;
    const int col = e - (r - r0) * Hi;
    const int mo = __ldg(m_out + r);
    const int mi = __ldg(m_in + col);
    const int mu = mi - mo;
    const int a = abs(mu);
    T2 v;
    if (a < NMU) {
      v = rotate<T>(w[mu + NMU - 1], (abs(mo) - abs(mi) + a) & 3);
      if constexpr (kFold)
        v = cscale<T>(v, t_exp(__ldg(e_r + (size_t)k * Ho + r) + ex[a] +
                               __ldg(e_b + (size_t)k * Hi + col)));
    } else {  // an order past the table (orders that are not a 2D basis's)
      v = cmake<T>((T)CUDART_NAN, (T)CUDART_NAN);
    }
    __stcs(dst + e, v);
  }
}

template <typename T, bool kFold>
cudaError_t run(const void* tab, const void* etab, const void* theta, long long theta_k,
                const void* m_out, const void* m_in, const void* e_r, const void* e_b,
                void* out, int K, int NO, int NMU, int Ho, int Hi, int rows, int smem,
                double scale, cudaStream_t st) {
  auto kernel = graf_fold_kernel<T, kFold>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (Ho + rows - 1) / rows;
  const dim3 grid((unsigned)((long long)NO * row_tiles), K);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const c2_t<T>*>(tab), static_cast<const T*>(etab),
      static_cast<const T*>(theta), theta_k, static_cast<const int*>(m_out),
      static_cast<const int*>(m_in), static_cast<const T*>(e_r), static_cast<const T*>(e_b),
      static_cast<c2_t<T>*>(out), NO, NMU, Ho, Hi, rows, row_tiles, (T)scale);
  return cudaGetLastError();
}

}  // namespace

// tab [K, NO, NMU] complex; etab [K, NO, NMU] real or null; theta real
// [K, NO] (theta_k = NO) or [NO] for every k (theta_k = 0); m_out int32
// [Ho], m_in int32 [Hi]; e_r [K, Ho], e_b [K, Hi] real or null; out
// [K, NO, Ho, Hi].  rows: rows h' per CTA; smem: the phase table's bytes,
// (2 NMU - 1) complex values and, in fold mode, NMU reals.
extern "C" int bhs_graf_fold(const void* tab, const void* etab, const void* theta,
                             long long theta_k, const void* m_out, const void* m_in,
                             const void* e_r, const void* e_b, void* out, int K, int NO,
                             int NMU, int Ho, int Hi, int rows, int smem, double scale,
                             int fold, int dbl, void* stream) {
  if (K <= 0 || NO <= 0 || Ho <= 0 || Hi <= 0) return 0;
  if (rows <= 0 || NMU <= 0 || K > 65535 ||
      (long long)NO * ((Ho + rows - 1) / rows) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)(fold ? run<double, true>(tab, etab, theta, theta_k, m_out, m_in, e_r, e_b,
                                          out, K, NO, NMU, Ho, Hi, rows, smem, scale, st)
                      : run<double, false>(tab, etab, theta, theta_k, m_out, m_in, e_r, e_b,
                                           out, K, NO, NMU, Ho, Hi, rows, smem, scale, st));
  return (int)(fold ? run<float, true>(tab, etab, theta, theta_k, m_out, m_in, e_r, e_b, out,
                                       K, NO, NMU, Ho, Hi, rows, smem, scale, st)
                    : run<float, false>(tab, etab, theta, theta_k, m_out, m_in, e_r, e_b,
                                        out, K, NO, NMU, Ho, Hi, rows, smem, scale, st));
}
