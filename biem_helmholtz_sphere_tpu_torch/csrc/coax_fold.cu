// K2: the folded coaxial factor of the factored (S|R) matvec, written
// straight into the packed child-state blocks that KB consumes.
//
// Replaces biem_helmholtz_sphere_tpu/translation/_scaled.py coaxial_scaled
// (:86) and the degree-level fold at biem_helmholtz_sphere_tpu/biem/
// _core.py:551-584, which form dense [K, NR, H, H] mant, S and fold factor
// tensors and then pack them.  For every (k, radius) pair p and packed
// entry j = (row a, col b), of root degrees (la, lb):
//
//   coef_p[n] = (i^n a_d zf[n]) radm_p[n] exp(rade_p[n] - sig_p[g(n)])
//   acc       = sum_g exp(min(sig_p[g] - rade_p[la+lb], 80))
//                     sum_{n in g} coef_p[n] U[n, j]
//   out[p, j] = acc i^la conj(i^lb) exp(e_r[k, la] + rade_p[la+lb] + e_b[k, lb])
//
// with (radm, rade) the scaled h_n(k r) of the 2 n_end - 1 bands (K5),
// padded to whole groups of 8 bands with zero coefficients and the last
// exponent, sig_p[g] the largest exponent of group g, U the
// radius-independent band matrices at the packed entries (zero where
// la + lb < n) and e_r, e_b the degree-level ball-max radial exponents.
// The operations and their order are those of the plain version
// (translation/_scaled.py::_coax_fold_packed_plain), the clamp at 80 and the
// separate fold factor included: cancelling rade[la+lb] between the two is
// not an identity where the clamp binds.
//
// What bounds it on the H100: device memory, barely.  At the bench (4 k x
// 9 radii, n_end = 32, 21,856 packed entries, complex64) it reads U (64 x
// 21,856 float32, 5.6 MB) and writes 6.3 MB, against ~2e8 flops: ~4 us.
// Design: one thread per packed entry holds its column of U in registers
// (8 groups of 8 bands at a time in float32, 4 in float64) and loops over a
// tile of 16 pairs whose coefficients, exponents and group maxima are
// staged in shared memory, so each U value is read once per tile.  No
// [H, H] tensor and no per-group temporary is formed.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairTile = 16;  // (k, radius) pairs per CUDA block
constexpr int kGroup = 8;      // bands per scale group (_GROUP)

// i^q a
template <typename T>
__device__ __forceinline__ c2_t<T> rot_i(c2_t<T> a, int q) {
  switch (q & 3) {
    case 0:
      return a;
    case 1:
      return cmake<T>(-a.y, a.x);
    case 2:
      return cmake<T>(-a.x, -a.y);
    default:
      return cmake<T>(a.y, -a.x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coax_fold_kernel(const c2_t<T>* __restrict__ radm, const T* __restrict__ rade,
                 const c2_t<T>* __restrict__ iazf, const T* __restrict__ u,
                 const int* __restrict__ l_row, const int* __restrict__ l_col,
                 const T* __restrict__ e_r, const T* __restrict__ e_b,
                 c2_t<T>* __restrict__ out, int P, int n_rad, int nb, int ng, int nnz, int L) {
  using T2 = c2_t<T>;
  constexpr int kChunk = sizeof(T) == 4 ? 8 : 4;  // groups of U held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbp = ng * kGroup;
  const int p0 = blockIdx.y * kPairTile;
  const int np = min(kPairTile, P - p0);
  T2* coef = reinterpret_cast<T2*>(smem_raw);                     // [np, nbp]
  T* rad_e = reinterpret_cast<T*>(coef + (size_t)kPairTile * nbp);  // [np, nbp]
  T* sig = rad_e + (size_t)kPairTile * nbp;                         // [np, ng]

  for (int e = threadIdx.x; e < np * nbp; e += kThreads) {
    const int q = e / nbp, n = e - q * nbp;
    rad_e[e] = rade[(size_t)(p0 + q) * nb + min(n, nb - 1)];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < np * ng; e += kThreads) {
    const T* r = rad_e + (e / ng) * nbp + (e % ng) * kGroup;
    T mx = r[0];
    for (int t = 1; t < kGroup; ++t) mx = r[t] > mx ? r[t] : mx;
    sig[e] = mx;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < np * nbp; e += kThreads) {
    const int q = e / nbp, n = e - q * nbp;
    const T2 c = n < nb ? cmul<T>(iazf[n], radm[(size_t)(p0 + q) * nb + n]) : cmake<T>(0, 0);
    coef[e] = cscale<T>(c, t_exp(rad_e[e] - sig[q * ng + n / kGroup]));
  }
  __syncthreads();

  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nnz) return;
  const int la = l_row[j], lb = l_col[j];
  const int ls = la + lb;
  for (int g0 = 0; g0 < ng; g0 += kChunk) {
    T uj[kChunk * kGroup];
#pragma unroll
    for (int t = 0; t < kChunk * kGroup; ++t) {
      const int n = g0 * kGroup + t;
      uj[t] = n < nbp ? u[(size_t)n * nnz + j] : T(0);
    }
    const bool last = g0 + kChunk >= ng;
    for (int q = 0; q < np; ++q) {
      const size_t o = (size_t)(p0 + q) * nnz + j;
      T2 acc = g0 == 0 ? cmake<T>(0, 0) : out[o];
      const T rl = rad_e[q * nbp + ls];
      const T2* cq = coef + q * nbp + g0 * kGroup;
#pragma unroll
      for (int gg = 0; gg < kChunk; ++gg) {
        if (g0 + gg < ng) {
          T2 t = cmake<T>(0, 0);
#pragma unroll
          for (int b = 0; b < kGroup; ++b) {
            const T2 c = cq[gg * kGroup + b];
            const T w = uj[gg * kGroup + b];
            t.x = t_fma(c.x, w, t.x);
            t.y = t_fma(c.y, w, t.y);
          }
          T x = sig[q * ng + g0 + gg] - rl;
          x = x > T(80) ? T(80) : x;
          const T sc = t_exp(x);
          acc.x += t.x * sc;
          acc.y += t.y * sc;
        }
      }
      if (!last) {  // partial sum over the groups so far (n_end > 32 in float32)
        out[o] = acc;
        continue;
      }
      const int k = (p0 + q) / n_rad;
      const T2 mant = rot_i<T>(rot_i<T>(acc, la), 4 - (lb & 3));
      out[o] = cscale<T>(mant, t_exp((e_r[(size_t)k * L + la] + rl) + e_b[(size_t)k * L + lb]));
    }
  }
}

template <typename T>
cudaError_t run(const void* radm, const void* rade, const void* iazf, const void* u,
                const void* l_row, const void* l_col, const void* e_r, const void* e_b, void* out,
                int P, int n_rad, int nb, int ng, int nnz, int L, cudaStream_t stream) {
  if (P == 0 || nnz == 0) return cudaSuccess;
  if (nb < 1 || ng * kGroup < nb || n_rad < 1) return cudaErrorInvalidValue;
  const size_t nbp = (size_t)ng * kGroup;
  const size_t smem = kPairTile * (nbp * (sizeof(c2_t<T>) + sizeof(T)) + (size_t)ng * sizeof(T));
  const cudaError_t err = allow_smem(coax_fold_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  using T2 = c2_t<T>;
  const dim3 grid((nnz + kThreads - 1) / kThreads, (P + kPairTile - 1) / kPairTile);
  coax_fold_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T2*>(radm), static_cast<const T*>(rade), static_cast<const T2*>(iazf),
      static_cast<const T*>(u), static_cast<const int*>(l_row), static_cast<const int*>(l_col),
      static_cast<const T*>(e_r), static_cast<const T*>(e_b), static_cast<T2*>(out), P, n_rad,
      nb, ng, nnz, L);
  return cudaGetLastError();
}

}  // namespace

// radm, rade [P, nb] (P = K * n_rad, k-major); iazf [nb]; u [ng * 8, nnz];
// l_row, l_col [nnz] int32; e_r, e_b [K, L]; out [P, nnz].
extern "C" int bhs_coax_fold(const void* radm, const void* rade, const void* iazf,
                             const void* u, const void* l_row, const void* l_col,
                             const void* e_r, const void* e_b, void* out, int P, int n_rad,
                             int nb, int ng, int nnz, int L, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(radm, rade, iazf, u, l_row, l_col, e_r, e_b, out, P, n_rad, nb, ng,
                            nnz, L, st);
  return (int)run<float>(radm, rade, iazf, u, l_row, l_col, e_r, e_b, out, P, n_rad, nb, ng,
                         nnz, L, st);
}
