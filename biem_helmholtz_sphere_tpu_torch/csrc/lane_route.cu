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
// 8-16 bytes moved; the lanes are 240 x 1024 x K complex).
//
// The gather reads each source row once and writes each lane once: a CTA
// per (chunk of h, source row s of [z; z*pm], k), over make_route's
// by-source CSR (src_ptr, src_lane).  It loads blc and x of ball s mod B
// with 16-byte loads (two complex64 or one complex128 per thread), forms
// z = blc x (times pm on a mirror row) into shared memory, then writes the
// chunk to every lane of s with 16-byte stores.  All index arithmetic is
// 32-bit, from blockIdx, with one 64-bit row offset per row and no
// division.  For complex64 a row that starts off 16 bytes (odd H, or an
// operand at an odd element offset) takes a scalar head and tail element.
// A source with no lane returns at once.
//
// The scatter: one thread per output element, consecutive threads on
// consecutive h so every access is coalesced.  It sums each ball's lanes
// in the fixed ascending CSR order, with no atomics, so a k sweep is
// bit-for-bit repeatable; the routing tables are tiny and stay in L1/L2.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // the scatter's block
constexpr int kGatherThreads = 128;  // the gather's block: one 16-byte vector per thread

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// z at element e of the chunk: blc x, times pm on a mirror row
template <typename T>
__device__ __forceinline__ c2_t<T> route_value(c2_t<T> b, c2_t<T> xv, const T* pm, int e,
                                               bool mirror) {
  const c2_t<T> v = cmul<T>(b, xv);
  return mirror ? cscale<T>(v, pm[e]) : v;
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
lane_gather_kernel(const c2_t<T>* __restrict__ x, const c2_t<T>* __restrict__ blc,
                   const T* __restrict__ pm, const int* __restrict__ src_ptr,
                   const int* __restrict__ src_lane, c2_t<T>* __restrict__ lanes, int B,
                   int L, int H) {
  using T2 = c2_t<T>;
  constexpr int kVec = 16 / sizeof(T2);  // complex values per 16 bytes
  constexpr int kChunk = kGatherThreads * kVec;
  __shared__ __align__(16) T2 zs[kChunk];
  const int s = blockIdx.y, k = blockIdx.z;
  const int q0 = src_ptr[s], q1 = src_ptr[s + 1];
  if (q0 == q1) return;
  const int h0 = blockIdx.x * kChunk;
  const int n = min(kChunk, H - h0);  // elements of this chunk
  const bool mirror = s >= B;
  const int b = mirror ? s - B : s;
  const size_t src_row = ((size_t)k * B + b) * H + h0;
  const T2* xr = x + src_row;
  const T2* br = blc + src_row;
  const T* pr = pm + h0;
  const int t = threadIdx.x;

  if constexpr (kVec == 1) {
    if (t < n) zs[t] = route_value<T>(br[t], xr[t], pr, t, mirror);
  } else {
    const int e = kVec * t;
    if (aligned16(xr) && aligned16(br) && e + 1 < n) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + e);
      const float4 bv = *reinterpret_cast<const float4*>(br + e);
      zs[e] = route_value<T>(cmake<T>(bv.x, bv.y), cmake<T>(xv.x, xv.y), pr, e, mirror);
      zs[e + 1] = route_value<T>(cmake<T>(bv.z, bv.w), cmake<T>(xv.z, xv.w), pr, e + 1, mirror);
    } else {
      for (int f = e; f < e + kVec && f < n; ++f)
        zs[f] = route_value<T>(br[f], xr[f], pr, f, mirror);
    }
  }
  __syncthreads();

  for (int q = q0; q < q1; ++q) {
    T2* dr = lanes + ((size_t)k * L + __ldg(src_lane + q)) * H + h0;
    if constexpr (kVec == 1) {
      if (t < n) dr[t] = zs[t];
    } else {
      const int head = aligned16(dr) ? 0 : 1;  // rows are 8-byte aligned
      const int pairs = (n - head) / 2;
      if (t < pairs) {
        const int e = head + 2 * t;
        const T2 a = zs[e], c = zs[e + 1];
        *reinterpret_cast<float4*>(dr + e) = make_float4(a.x, a.y, c.x, c.y);
      }
      if (t == kGatherThreads - 1) {
        if (head) dr[0] = zs[0];
        if ((n - head) & 1) dr[n - 1] = zs[n - 1];
      }
    }
  }
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

// src_ptr [2B + 1], src_lane [L]: the lanes of each source row of
// [z; z*pm], ascending (make_route's by-source CSR)
extern "C" int bhs_lane_gather(const void* x, const void* blc, const void* pm,
                               const void* src_ptr, const void* src_lane, void* lanes, int K,
                               int B, int L, int H, int dbl, void* stream) {
  if (K <= 0 || B <= 0 || L <= 0 || H <= 0) return 0;
  if (K > 65535 || 2 * B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = kGatherThreads * (dbl ? 1 : 2);
  const dim3 grid((H + chunk - 1) / chunk, 2 * B, K);
  if (dbl)
    lane_gather_kernel<double><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const double2*>(x), static_cast<const double2*>(blc),
        static_cast<const double*>(pm), static_cast<const int*>(src_ptr),
        static_cast<const int*>(src_lane), static_cast<double2*>(lanes), B, L, H);
  else
    lane_gather_kernel<float><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(blc),
        static_cast<const float*>(pm), static_cast<const int*>(src_ptr),
        static_cast<const int*>(src_lane), static_cast<float2*>(lanes), B, L, H);
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
