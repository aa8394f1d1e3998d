// KR: the plane-wave right-hand side, the boundary data of e^{i k d^.x} on
// every sphere expanded in the tree's harmonics.
//
// Replaces biem_helmholtz_sphere_tpu/biem/_core.py:239-291, `_rhs_plane_wave`,
// which XLA fused on the TPU:
//
//   f_h(k, b) = -A_d i^{n_h} e^{i k d^.c_b} conj(Y_h(d^))
//               (alpha_b j_{n_h}(k rho_b) + beta_b k j'_{n_h}(k rho_b))
//
// out [K, B, H] (complex64 or complex128) from j, j' [K, B, n_end] as K5
// (csrc/spherical_jh.cu, unscaled mode) writes them, k [K] real or complex,
// the direction [d, K] and the centers [K, B, d] (each by strides: a shared
// geometry or direction has stride 0 along K), alpha and beta [K, B].  Y_h
// comes from the tree's program (ops/harmonic_program.py) through the
// device evaluator of csrc/harmonics.cuh, straight from the cartesian
// direction: `hjob` [H, n_nodes] gives each harmonic's job at every node.
// The plain version is ops/plane_rhs.py::plane_wave_rhs_plain.
//
// What bounds it on the H100: the bytes, [K, B, H] written and j, j' read
// (at the bench, 4 x 16 x 1,024 in complex64, 0.16 us at 3.35 TB/s); the
// launch and the latency of one warp's Jacobi recurrences are far above
// that.  Design, simple and right first:
// - A CTA per slice of 32 harmonics (a lane each) x a range of balls x a
//   range of k (the ranges split only where the slices alone leave the card
//   idle: ops/plane_rhs.py::_grid).  Warp 0 evaluates the slice's
//   conj(Y_h) i^{n_h} (-A_d) into shared memory at its first k and again
//   only at a k whose direction differs, bit for bit, from the previous
//   one's: at the bench (one direction over 4 k, 16 balls) every harmonic's
//   Y is evaluated once.  The angles are computed once per direction by
//   lane 0 (tree_angles), the node factors by every lane from the seeds
//   (factor_product).
// - The warps then take the (k, b) rows in turn: a row's phase, alpha and
//   beta are the same in every lane (broadcast loads), each lane gathers
//   j and j' at its degree n_h and writes its entry (a warp stores 32
//   consecutive harmonics).
// - The phase's argument is formed as the plain version forms it, products
//   and sums rounded one by one with no FMA (d^.c_b summed over the axes in
//   order, then k times it), so that the kernel's phase error is that of
//   one sincos at the same argument whatever |k d^.c_b|.
// - Each output has one writer and a fixed order of operations: two
//   launches give the same bits.  No atomics, no shared state across CTAs.
// Later work: none planned; the stage is launch-bound.
#include "common.cuh"
#include "harmonics.cuh"

#include <cstdint>

namespace {

constexpr int kSlice = 32;  // harmonics per CTA (= ops/plane_rhs.py _SLICE)
constexpr int kWarps = 16;  // warps per CTA (= ops/plane_rhs.py _WARPS)

__device__ __forceinline__ void t_sincos(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void t_sincos(double a, double* s, double* c) { sincos(a, s, c); }
// a product and a sum rounded alone (nvcc would contract them into an FMA)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ uint32_t bits_of(float a) { return __float_as_uint(a); }
__device__ __forceinline__ unsigned long long bits_of(double a) {
  return (unsigned long long)__double_as_longlong(a);
}

template <typename T>
struct KrArgs {
  c2_t<T>* out;                    // [K, B, H]
  const c2_t<T>* j;                // [K, B, ne]
  const c2_t<T>* jp;               // [K, B, ne]
  const T* kv;                     // k [K]: real, or complex interleaved (kc)
  long long skv;                   // k's stride (in k values)
  const T* dir;                    // [d, K] by strides
  long long sdd, sdk;
  const T* cen;                    // [K, B, d] by strides
  long long sck, scb, scd;
  const c2_t<T>* alpha;            // [K, B] by strides
  long long sak, sab;
  const c2_t<T>* beta;
  long long sbk, sbb;
  const int* n_root;               // [H]
  const int* hjob;                 // [H, n_nodes]
  hprog::Prog<T> pg;
  int K, B, H, ne, d, kc, has_uin, has_grad, b_per, k_per;
  T neg_a;                         // -A_d, rounded to T
};

// conj(y) i^n: exact (a swap and signs)
template <typename T>
__device__ __forceinline__ c2_t<T> conj_ipow(c2_t<T> y, int n) {
  switch (n & 3) {
    case 0: return cmake<T>(y.x, -y.y);
    case 1: return cmake<T>(y.y, y.x);
    case 2: return cmake<T>(-y.x, y.y);
    default: return cmake<T>(-y.y, -y.x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) plane_rhs_kernel(const KrArgs<T> a) {
  using T2 = c2_t<T>;
  __shared__ T sv[hprog::kMaxNodes + 1];
  __shared__ T sax[hprog::kMaxNodes], sac[hprog::kMaxNodes], sas[hprog::kMaxNodes];
  __shared__ int skind[hprog::kMaxNodes];
  __shared__ T2 scy[kSlice];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * kSlice + lane;
  const bool live = h < a.H;
  const int b0 = blockIdx.y * a.b_per, b1 = min(a.B, b0 + a.b_per);
  const int k0 = blockIdx.z * a.k_per, k1 = min(a.K, k0 + a.k_per);
  const int n_h = live ? a.n_root[h] : 0;
  if (threadIdx.x == 0) hprog::node_kinds<T>(a.pg, skind);

  for (int k = k0; k < k1; ++k) {
    // a direction that repeats the previous k's, bit for bit, keeps its Y
    bool fresh = k == k0;
    for (int i = 0; i < a.d && !fresh; ++i)
      fresh = bits_of(a.dir[i * a.sdd + k * a.sdk]) != bits_of(a.dir[i * a.sdd + (k - 1) * a.sdk]);
    if (fresh) {  // the same in every thread: the CTA takes the branch together
      __syncthreads();  // the previous direction's readers are done with scy
      if (warp == 0) {
        if (lane == 0) {
          for (int i = 0; i < a.d; ++i) sv[i] = a.dir[i * a.sdd + k * a.sdk];
          hprog::tree_angles<T>(a.pg, sv, sax, sac, sas);
        }
        __syncwarp();
        if (live) {
          const T2 y = hprog::factor_product<T>(a.pg, skind, a.hjob + (size_t)h * a.pg.n_nodes,
                                                0, sax, sac, sas);
          scy[lane] = cscale<T>(conj_ipow<T>(y, n_h), a.neg_a);
        }
      }
      __syncthreads();
    }
    const T2 cy = live ? scy[lane] : cmake<T>(0, 0);
    T2 kw;
    if (a.kc) {
      kw = reinterpret_cast<const T2*>(a.kv)[k * a.skv];
    } else {
      kw = cmake<T>(a.kv[k * a.skv], 0);
    }
    for (int b = b0 + warp; b < b1; b += kWarps) {
      // e^{i k d^.c_b}: the plain version's argument, rounding for rounding
      const T* c = a.cen + k * a.sck + b * a.scb;
      T ip = mul_rn(a.dir[k * a.sdk], c[0]);
      for (int i = 1; i < a.d; ++i) ip = add_rn(ip, mul_rn(a.dir[i * a.sdd + k * a.sdk], c[i * a.scd]));
      T s, co;
      T2 phase;
      if (a.kc) {  // exp((-Im k ip) + i (Re k ip))
        t_sincos(mul_rn(kw.x, ip), &s, &co);
        const T e = t_exp(mul_rn(-kw.y, ip));
        phase = cmake<T>(e * co, e * s);
      } else {
        t_sincos(mul_rn(kw.x, ip), &s, &co);
        phase = cmake<T>(co, s);
      }
      if (!live) continue;
      const size_t r = ((size_t)k * a.B + b) * a.ne + n_h;
      T2 term = cmake<T>(0, 0);
      if (a.has_uin) term = cmul<T>(a.alpha[k * a.sak + b * a.sab], a.j[r]);
      if (a.has_grad) {
        const T2 jp = a.jp[r];
        const T2 jpk = a.kc ? cmul<T>(jp, kw) : cscale<T>(jp, kw.x);
        term = cadd<T>(term, cmul<T>(a.beta[k * a.sbk + b * a.sbb], jpk));
      }
      a.out[((size_t)k * a.B + b) * a.H + h] = cmul<T>(cmul<T>(phase, term), cy);
    }
  }
}

template <typename T>
cudaError_t run(const void* out, const void* j, const void* jp, const void* kv, long long skv,
                int kc, const void* dir, long long sdd, long long sdk, const void* cen,
                long long sck, long long scb, long long scd, const void* alpha, long long sak,
                long long sab, const void* beta, long long sbk, long long sbb,
                const void* n_root, const void* hjob, const void* nodes, const void* jobs,
                const void* fam, const void* coef, const void* famr, int n_nodes, int K, int B,
                int H, int ne, int d, int has_uin, int has_grad, int b_per, int k_per,
                double neg_a, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (K == 0 || B == 0 || H == 0) return cudaSuccess;
  if (n_nodes < 1 || n_nodes > hprog::kMaxNodes || d < 1 || d > hprog::kMaxNodes + 1 ||
      b_per < 1 || k_per < 1)
    return cudaErrorInvalidValue;
  const KrArgs<T> a{static_cast<T2*>(const_cast<void*>(out)), static_cast<const T2*>(j),
                    static_cast<const T2*>(jp), static_cast<const T*>(kv), skv,
                    static_cast<const T*>(dir), sdd, sdk, static_cast<const T*>(cen), sck, scb,
                    scd, static_cast<const T2*>(alpha), sak, sab, static_cast<const T2*>(beta),
                    sbk, sbb, static_cast<const int*>(n_root), static_cast<const int*>(hjob),
                    hprog::Prog<T>{static_cast<const int4*>(nodes),
                                   static_cast<const int4*>(jobs), static_cast<const int*>(fam),
                                   static_cast<const T*>(coef), static_cast<const T*>(famr),
                                   n_nodes},
                    K, B, H, ne, d, kc, has_uin, has_grad, b_per, k_per, (T)neg_a};
  const dim3 grid((H + kSlice - 1) / kSlice, (B + b_per - 1) / b_per, (K + k_per - 1) / k_per);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  plane_rhs_kernel<T><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out [K, B, H]; j, jp [K, B, ne] (contiguous); k [K] at stride skv, real or
// complex (kc: interleaved pairs, the stride in pairs); direction [d, K] and
// centers [K, B, d] by strides (in reals); alpha, beta [K, B] by strides (in
// complex values); n_root [H] and hjob [H, n_nodes] (int32) and the tree's
// program (ops/harmonic_program.py); b_per balls and k_per k a CTA;
// neg_a = -A_d.
extern "C" int bhs_plane_rhs(const void* out, const void* j, const void* jp, const void* kv,
                             long long skv, int kc, const void* dir, long long sdd,
                             long long sdk, const void* cen, long long sck, long long scb,
                             long long scd, const void* alpha, long long sak, long long sab,
                             const void* beta, long long sbk, long long sbb, const void* n_root,
                             const void* hjob, const void* nodes, const void* jobs,
                             const void* fam, const void* coef, const void* famr, int n_nodes,
                             int K, int B, int H, int ne, int d, int has_uin, int has_grad,
                             int b_per, int k_per, double neg_a, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(out, j, jp, kv, skv, kc, dir, sdd, sdk, cen, sck, scb, scd, alpha,
                            sak, sab, beta, sbk, sbb, n_root, hjob, nodes, jobs, fam, coef, famr,
                            n_nodes, K, B, H, ne, d, has_uin, has_grad, b_per, k_per, neg_a, st);
  return (int)run<float>(out, j, jp, kv, skv, kc, dir, sdd, sdk, cen, sck, scb, scd, alpha, sak,
                         sab, beta, sbk, sbb, n_root, hjob, nodes, jobs, fam, coef, famr, n_nodes,
                         K, B, H, ne, d, has_uin, has_grad, b_per, k_per, neg_a, st);
}
