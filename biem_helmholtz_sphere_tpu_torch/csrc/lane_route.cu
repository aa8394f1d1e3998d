// KC: routing of sphere vectors into the compacted pair lanes of the
// factored (S|R) matvec and back.
//
// Replaces the one-hot routing matmuls and the diagonal/coupling epilogue
// of biem_helmholtz_sphere_tpu/biem/_core.py (_matfree_operator, factored
// `mv`: the `gth` gather, the mirror parity and the `sct` scatter):
//
//   gather:  lanes[k, l, h] = (blc * x)[k, b, h] * (src[l] >= B ? pm[h] : 1),
//            b = src[l] mod B
//   scatter: out[k, b, h] = diag*x + reg * sum_{q in csr(b)} y[k, lane[q], h]
//                                         * (dn[q] ? pm[h] : 1)
//
// The lanes are compacted: only the lanes that route a pair (240 of the
// 864 a padded [slot, 2 p_max] layout has at the bench), so neither
// kernel reads or writes a padding lane.
//
// What bounds it on the H100: device memory bandwidth (a few flops per
// 8-16 bytes moved; the lanes are 240 x 1024 x K complex).  Design: one
// thread per output element, consecutive threads on consecutive h so every
// access is coalesced.  The scatter sums each ball's lanes in the fixed
// ascending CSR order, with no atomics, so a k sweep is bit-for-bit
// repeatable; the routing tables are tiny and stay in L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const c2_t<T>* __restrict__ x, const c2_t<T>* __restrict__ blc,
                   const T* __restrict__ pm, const int* __restrict__ src,
                   c2_t<T>* __restrict__ lanes, int K, int B, int L, int H) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)K * L * H) return;
  const int h = (int)(idx % H);
  const size_t t = idx / H;
  const int l = (int)(t % L);
  const int k = (int)(t / L);
  const int s = src[l];
  const int b = s < B ? s : s - B;
  const size_t o = ((size_t)k * B + b) * H + h;
  c2_t<T> v = cmul<T>(blc[o], x[o]);
  if (s >= B) v = cscale<T>(v, pm[h]);
  lanes[idx] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_scatter_kernel(const c2_t<T>* __restrict__ y, const c2_t<T>* __restrict__ x,
                    const c2_t<T>* __restrict__ diag, const c2_t<T>* __restrict__ reg,
                    const T* __restrict__ pm, const int* __restrict__ csr_ptr,
                    const int* __restrict__ csr_lane, const int* __restrict__ csr_dn,
                    c2_t<T>* __restrict__ out, int K, int B, int L, int H) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)K * B * H) return;
  const int h = (int)(idx % H);
  const size_t t = idx / H;
  const int b = (int)(t % B);
  const int k = (int)(t / B);
  const T p = pm[h];
  c2_t<T> acc = cmake<T>(0, 0);
  for (int q = csr_ptr[b]; q < csr_ptr[b + 1]; ++q) {
    c2_t<T> v = y[((size_t)k * L + csr_lane[q]) * H + h];
    if (csr_dn[q]) v = cscale<T>(v, p);
    acc = cadd<T>(acc, v);
  }
  out[idx] = cadd<T>(cmul<T>(diag[idx], x[idx]), cmul<T>(reg[idx], acc));
}

inline unsigned blocks_for(size_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int bhs_lane_gather(const void* x, const void* blc, const void* pm,
                               const void* src, void* lanes, int K, int B, int L, int H,
                               int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for((size_t)K * L * H);
  if (nb == 0) return 0;
  if (dbl)
    lane_gather_kernel<double><<<nb, kThreads, 0, st>>>(
        static_cast<const double2*>(x), static_cast<const double2*>(blc),
        static_cast<const double*>(pm), static_cast<const int*>(src),
        static_cast<double2*>(lanes), K, B, L, H);
  else
    lane_gather_kernel<float><<<nb, kThreads, 0, st>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(blc),
        static_cast<const float*>(pm), static_cast<const int*>(src),
        static_cast<float2*>(lanes), K, B, L, H);
  return (int)cudaGetLastError();
}

extern "C" int bhs_lane_scatter(const void* y, const void* x, const void* diag,
                                const void* reg, const void* pm, const void* csr_ptr,
                                const void* csr_lane, const void* csr_dn, void* out, int K,
                                int B, int L, int H, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for((size_t)K * B * H);
  if (nb == 0) return 0;
  if (dbl)
    lane_scatter_kernel<double><<<nb, kThreads, 0, st>>>(
        static_cast<const double2*>(y), static_cast<const double2*>(x),
        static_cast<const double2*>(diag), static_cast<const double2*>(reg),
        static_cast<const double*>(pm), static_cast<const int*>(csr_ptr),
        static_cast<const int*>(csr_lane), static_cast<const int*>(csr_dn),
        static_cast<double2*>(out), K, B, L, H);
  else
    lane_scatter_kernel<float><<<nb, kThreads, 0, st>>>(
        static_cast<const float2*>(y), static_cast<const float2*>(x),
        static_cast<const float2*>(diag), static_cast<const float2*>(reg),
        static_cast<const float*>(pm), static_cast<const int*>(csr_ptr),
        static_cast<const int*>(csr_lane), static_cast<const int*>(csr_dn),
        static_cast<float2*>(out), K, B, L, H);
  return (int)cudaGetLastError();
}
