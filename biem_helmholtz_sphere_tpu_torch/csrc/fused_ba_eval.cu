// KA: fused scattered-field evaluation on the 3D "ba" tree.
//
// Replaces biem_helmholtz_sphere_tpu/biem/_eval_fused.py::_fused_ba_dot_blocked
// together with the radial table of biem/_eval.py::_h_clamped (->
// special/_family.py::spherical_h_scaled).  Per (point, ball):
//
//   u_b = 1/sqrt(2 pi) sum_m e^{i m phi} sin^{|m|}(theta)
//         sum_{l >= |m|} p~_{l-|m|}^{(|m|,|m|)}(cos theta) rad_l w2[b, m, l]
//
// with (theta, phi, r) the "ba" angles of x - c_b (of x itself in the far
// field), rad_l = h_l(k r) from the upward recurrence in mantissa/exponent
// form, clamped at exp(80) (float32) / exp(700) (float64) as the plain
// version does (far field: rad = 1), and the sum over balls b in order
// (or one output per ball).  k is real or complex (a template flag: the
// complex instance seeds and steps the h_l chain on a complex kr, the real
// one keeps its real arithmetic), and the centers are each k's own ([K, B,
// 3] at a k stride; 0 for a geometry shared by the batch).
//
// What bounds it on the H100: FP32 instruction throughput, not bytes:
// ~13 operations per (m, l) pair with l >= |m| (n^2 = 1,024 pairs per point
// and ball at n_end=32) against 24 bytes of point data.  Two modes, chosen
// by the shape of the call (the wrapper: P * K below 4 x 132):
//
// Many points (fused_ba_eval_kernel).  One point per thread, 128 threads
// and ~48 KB of shared memory per CTA: 16 warps per SM.  At n_end = 32
// (the N = 32 instance) the h_l table of each point lives in registers:
// the degree steps of one order f are written out once and entered at
// l = f through a switch that falls through to l = 31, so every table
// index is a constant while the code stays small (a fully unrolled (f, l)
// nest outgrew the instruction cache and ran slower).  Any other n_end
// runs the generic instance (N = 0), whose h_l table sits in shared memory
// strided by thread (at n_end = 32 on an H100 that instance takes 1.44x
// the register one's time: tools/torch_kernel_ab.py).  Each degree step is ~16
// instructions: two broadcast shared loads of the weights and one 16-byte
// (c64) load of the packed coefficients {-a_j/b_{j+1}, 1/b_{j+1},
// b_j/b_{j+1}}, p h_l for both slots, and the recurrence, which runs one
// degree behind its use so the seed needs no select and (ct - a_j) /
// b_{j+1} is one FMA.  The weights of ball b + 1 (16 KB in c64) are staged
// with cp.async into the second of two shared buffers while ball b
// computes.  The clamp of h_l costs a compare (an exp only where the chain
// rescales, a division where it clamps) instead of a log and two exps;
// the angles come from the coordinates by division, not atan2/cos/sin,
// and e^{i m phi} sin^m theta by one complex product per order.  Two
// points per thread needed ~200 registers in float32 (8 warps per SM) and
// ran slower.  What holds it back: the instruction count itself
// (~16 per (m, l) pair and point against the ~13 operations the bound
// counts, plus the h_l chain) at well under one instruction per cycle.
//
// Few points (fused_ba_eval_few_kernel), e.g. uscat(0): one CTA per
// (point, k); its 16 warps take the balls (warp w: balls w, w + 16, ...)
// and the 32 lanes of a warp the orders |m| (lane f: f, f + 32, ...), each
// lane running its own Jacobi recurrence over l.  The warp computes the h_l
// chain once into shared memory, reduces the orders with a fixed shuffle
// tree, and the CTA sums its warps in order: the sum order is fixed, so
// repeated calls are bit-for-bit equal.
//
// Nothing of size [points, balls, .] reaches device memory.
#include "common.cuh"
#include "hankel.cuh"

namespace {

constexpr int kThreads = 128;      // many-point mode
constexpr int kFewThreads = 512;   // few-point mode: 16 warps
constexpr int kFewWarps = kFewThreads / 32;
constexpr int kUnrolledN = 32;     // the register-table instance (n_end = 32)

// One step of the (f, f) Jacobi recurrence, p_{j+1} = (ct - a_j) p_j / b_{j+1}
// - (b_j / b_{j+1}) p_{j-1}, as p_{j+1} = (ct b1 + ab) p_j - bb p_{j-1}.
template <typename T> struct Coef4 { T ab, b1, bb, pad; };  // -a_j/b_{j+1}, 1/b_{j+1}, b_j/b_{j+1}

template <typename T>
__device__ __forceinline__ T jacobi_next(const Coef4<T>& c, T ct, T pn, T pm) {
  return t_fma(t_fma(ct, c.b1, c.ab), pn, -c.bb * pm);
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(c2_t<T>* dst, const c2_t<T>* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(c2_t<T>)));
}

template <typename T, int N, bool CK>
__global__ void __launch_bounds__(kThreads)
fused_ba_eval_kernel(const T* __restrict__ x, long long sxd, long long sxk, long long sxp,
                     int kx, const T* __restrict__ centers_all, long long sck,
                     const T* __restrict__ kv,
                     const c2_t<T>* __restrict__ w2, const T* __restrict__ cab,
                     const T* __restrict__ cb1, const T* __restrict__ cbb,
                     const T* __restrict__ p0v, c2_t<T>* __restrict__ out, int P, int K,
                     int B, int n, int far, int per_ball, T lim, T rescale) {
  using T2 = c2_t<T>;
  static_assert(N == 0 || N == 32, "the unrolled instance is written out for n_end = 32");
  const int n_ = N > 0 ? N : n;
  const int MN = (2 * n_ - 1) * n_;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Coef4<T>* Cf = reinterpret_cast<Coef4<T>*>(smem_raw);  // [n * n]
  T2* Wbuf = reinterpret_cast<T2*>(Cf + n_ * n_);         // [2][M * n]
  T* P0 = reinterpret_cast<T*>(Wbuf + 2 * MN);            // [n]
  T2* Hs = reinterpret_cast<T2*>(P0 + n_ + (n_ & 1));     // [n][kThreads], N == 0 only

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const T* centers = centers_all + k * sck;
  const T2* wk = w2 + (size_t)k * B * MN;
  for (int e = tid; e < MN; e += kThreads) cp_async_elem<T>(Wbuf + e, wk + e);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = tid; e < n_ * n_; e += kThreads) Cf[e] = Coef4<T>{cab[e], cb1[e], cbb[e], (T)0};
  for (int e = tid; e < n_; e += kThreads) P0[e] = p0v[e];

  const int p = blockIdx.x * kThreads + tid;
  T px = 0, py = 0, pz = 0;
  if (p < P) {
    const T* xp = x + (kx == 1 ? 0LL : (long long)k * sxk) + (long long)p * sxp;
    px = xp[0];
    py = xp[sxd];
    pz = xp[2 * sxd];
  }
  const T2 kk = k_of<T, CK>(kv, k);
  const T log_rescale = t_log(rescale);
  const T elim = t_exp(lim);
  const T inv_sqrt_2pi = (T)0.39894228040143267794;
  T2 total = cmake<T>(0, 0);
  T2 hreg[N > 0 ? N : 1];  // h_l at N: registers (every index below is a constant)

  for (int b = 0; b < B; ++b) {
    if (b + 1 < B) {  // stage the next ball's weights while this one computes
      const T2* src = wk + (size_t)(b + 1) * MN;
      T2* dst = Wbuf + ((b + 1) & 1) * MN;
      for (int e = tid; e < MN; e += kThreads) cp_async_elem<T>(dst + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const T2* Ws = Wbuf + (b & 1) * MN;

    T rx = px, ry = py, rz = pz;
    if (!far) {
      rx -= centers[3 * b];
      ry -= centers[3 * b + 1];
      rz -= centers[3 * b + 2];
    }
    const T rc = t_hypot(rx, ry);
    const T r = t_hypot(rc, rz);
    const T ct = r > 0 ? rz / r : (T)1;  // cos theta
    const T st = r > 0 ? rc / r : (T)0;
    const T2 z1 = rc > 0 ? cmake<T>(st * (rx / rc), st * (ry / rc)) : cmake<T>(st, 0);
    if constexpr (N > 0) {
      if (far) {
#pragma unroll
        for (int l = 0; l < N; ++l) hreg[l] = cmake<T>(1, 0);
      } else {
        h_chain<T, N, CK>(k_times<T, CK>(kk, r), N, lim, elim, rescale, log_rescale,
                          [&](int l, T2 v) { hreg[l] = v; });
      }
    } else if (!far) {
      h_chain<T, 0, CK>(k_times<T, CK>(kk, r), n_, lim, elim, rescale, log_rescale,
                        [&](int l, T2 v) { Hs[(size_t)l * kThreads + tid] = v; });
    }

    T2 ub = cmake<T>(0, 0);
    T2 zf = cmake<T>(1, 0);  // e^{i f phi} sin^f theta
#pragma unroll 1
    for (int f = 0; f < n_; ++f) {
      const T2* wp = Ws + (n_ - 1 + f) * n_;  // slot m = +f
      const T2* wm = Ws + (n_ - 1 - f) * n_;  // slot m = -f (= +f at f = 0)
      const Coef4<T>* cf = Cf + f * n_;
      T pm = 0, pn = P0[f];  // p at degrees l - 1 and l
      T2 ap = cmake<T>(0, 0), am = cmake<T>(0, 0);
      // degree l >= f: p h_l w for both slots, then the recurrence to l + 1
      // (no select for the seed; the last step's transition is unused)
      auto step = [&](const int l) {
        const Coef4<T> c = cf[l - f];
        T2 rad;
        if constexpr (N > 0) {
          rad = hreg[l];
        } else {
          rad = far ? cmake<T>(1, 0) : Hs[(size_t)l * kThreads + tid];
        }
        const T2 pr = cscale<T>(rad, pn);
        ap = cfma<T>(pr, wp[l], ap);
        am = cfma<T>(pr, wm[l], am);
        const T pp = jacobi_next<T>(c, ct, pn, pm);
        pm = pn;
        pn = pp;
      };
      if constexpr (N == 32) {
        // enter the written-out steps at l = f and fall through to l = 31:
        // no step for l < f is visited, and every hreg index is a constant
        switch (f) {
#define KA_CASE(L) \
  case L:          \
    step(L);       \
    [[fallthrough]];
          KA_CASE(0) KA_CASE(1) KA_CASE(2) KA_CASE(3) KA_CASE(4) KA_CASE(5) KA_CASE(6)
          KA_CASE(7) KA_CASE(8) KA_CASE(9) KA_CASE(10) KA_CASE(11) KA_CASE(12) KA_CASE(13)
          KA_CASE(14) KA_CASE(15) KA_CASE(16) KA_CASE(17) KA_CASE(18) KA_CASE(19)
          KA_CASE(20) KA_CASE(21) KA_CASE(22) KA_CASE(23) KA_CASE(24) KA_CASE(25)
          KA_CASE(26) KA_CASE(27) KA_CASE(28) KA_CASE(29) KA_CASE(30)
#undef KA_CASE
          case 31:
            step(31);
        }
      } else {
        for (int l = f; l < n_; ++l) step(l);
      }
      T2 term = cmul<T>(ap, zf);
      if (f > 0) term = cadd<T>(term, cmul<T>(am, cmake<T>(zf.x, -zf.y)));
      ub = cadd<T>(ub, term);
      zf = cmul<T>(zf, z1);
    }
    const T2 u = cscale<T>(ub, inv_sqrt_2pi);
    if (per_ball) {
      if (p < P) out[((size_t)p * K + k) * B + b] = u;
    } else {
      total = cadd<T>(total, u);
    }
    __syncthreads();  // this ball's buffer is free for the ball after next
  }
  if (!per_ball && p < P) out[(size_t)p * K + k] = total;
}

template <typename T, bool CK>
__global__ void __launch_bounds__(kFewThreads)
fused_ba_eval_few_kernel(const T* __restrict__ x, long long sxd, long long sxk,
                         long long sxp, int kx, const T* __restrict__ centers_all,
                         long long sck, const T* __restrict__ kv,
                         const c2_t<T>* __restrict__ w2,
                         const T* __restrict__ cab, const T* __restrict__ cb1,
                         const T* __restrict__ cbb, const T* __restrict__ p0v,
                         c2_t<T>* __restrict__ out, int P, int K, int B, int n, int far,
                         int per_ball, T lim, T rescale) {
  using T2 = c2_t<T>;
  const int M = 2 * n - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Coef4<T>* Cf = reinterpret_cast<Coef4<T>*>(smem_raw);  // [n * n]
  T2* Hw = reinterpret_cast<T2*>(Cf + n * n);             // [warps][n]
  T2* part = Hw + kFewWarps * n;                          // [warps]
  T* P0 = reinterpret_cast<T*>(part + kFewWarps);         // [n]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.x / K, k = blockIdx.x % K;
  for (int e = tid; e < n * n; e += kFewThreads) Cf[e] = Coef4<T>{cab[e], cb1[e], cbb[e], (T)0};
  for (int e = tid; e < n; e += kFewThreads) P0[e] = p0v[e];
  __syncthreads();

  const T* xp = x + (kx == 1 ? 0LL : (long long)k * sxk) + (long long)p * sxp;
  const T px = xp[0], py = xp[sxd], pz = xp[2 * sxd];
  const T* centers = centers_all + k * sck;
  const T2 kk = k_of<T, CK>(kv, k);
  const T elim = t_exp(lim);
  const T inv_sqrt_2pi = (T)0.39894228040143267794;
  T2* H = Hw + warp * n;
  T2 wsum = cmake<T>(0, 0);

  for (int b = warp; b < B; b += kFewWarps) {
    T rx = px, ry = py, rz = pz;
    if (!far) {
      rx -= centers[3 * b];
      ry -= centers[3 * b + 1];
      rz -= centers[3 * b + 2];
    }
    const T rc = t_hypot(rx, ry);
    const T theta = t_atan2(rc, rz);
    const T phi = t_atan2(ry, rx);
    const T ct = t_cos(theta), st = t_sin(theta);
    if (!far) {
      // every lane runs the chain (uniform branches); lane l % 32 keeps h_l
      h_chain<T, 0, CK>(k_times<T, CK>(kk, t_hypot(rc, rz)), n, lim, elim, rescale,
                        t_log(rescale), [&](int l, T2 v) { if ((l & 31) == lane) H[l] = v; });
      __syncwarp();
    }
    const T2* wb = w2 + ((size_t)k * B + b) * M * n;
    T2 acc = cmake<T>(0, 0);
    for (int f = lane; f < n; f += 32) {
      const T2* wp = wb + (n - 1 + f) * n;
      const T2* wm = wb + (n - 1 - f) * n;
      T pm = 0, pn = P0[f];  // p at degrees l - 1 and l
      T2 ap = cmake<T>(0, 0), am = cmake<T>(0, 0);
      for (int l = f; l < n; ++l) {
        const T2 rad = far ? cmake<T>(1, 0) : H[l];
        const T2 pr = cscale<T>(rad, pn);
        ap = cfma<T>(pr, wp[l], ap);
        am = cfma<T>(pr, wm[l], am);
        const T pp = jacobi_next<T>(Cf[f * n + l - f], ct, pn, pm);
        pm = pn;
        pn = pp;
      }
      // e^{i f phi} sin^f theta, as the plain version's powers and phases
      T stp = 1;
      for (int i = 0; i < f; ++i) stp *= st;
      const T ang = phi * (T)f;
      const T ca_ = t_cos(ang), sa = t_sin(ang);
      T2 term = cmul<T>(ap, cmake<T>(ca_, sa));
      if (f > 0) term = cadd<T>(term, cmul<T>(am, cmake<T>(ca_, -sa)));
      acc = cadd<T>(acc, cscale<T>(term, stp));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {  // fixed tree: lane 0 holds the sum
      acc.x += __shfl_down_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_down_sync(0xffffffffu, acc.y, off);
    }
    const T2 u = cscale<T>(acc, inv_sqrt_2pi);
    if (per_ball) {
      if (lane == 0) out[((size_t)p * K + k) * B + b] = u;
    } else {
      wsum = cadd<T>(wsum, u);
    }
    __syncwarp();  // H is rewritten by the warp's next ball
  }
  if (per_ball) return;
  if (lane == 0) part[warp] = wsum;
  __syncthreads();
  if (tid == 0) {
    T2 s = cmake<T>(0, 0);
    for (int w = 0; w < kFewWarps; ++w) s = cadd<T>(s, part[w]);
    out[(size_t)p * K + k] = s;
  }
}

template <typename T, int N, bool CK>
cudaError_t run_many(const void* x, long long sxd, long long sxk, long long sxp, int kx,
                     const void* centers, long long sck, const void* k, const void* w2,
                     const void* cab, const void* cb1, const void* cbb, const void* p0,
                     void* out, int P, int K, int B, int n, int far, int per_ball, double lim,
                     double rescale, cudaStream_t stream) {
  using T2 = c2_t<T>;
  const size_t M = 2 * (size_t)n - 1;
  size_t smem = sizeof(Coef4<T>) * n * n + 2 * sizeof(T2) * M * n + sizeof(T) * (n + (n & 1));
  if (N == 0) smem += sizeof(T2) * (size_t)n * kThreads;
  auto kernel = fused_ba_eval_kernel<T, N, CK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kThreads - 1) / kThreads, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers), sck,
      static_cast<const T*>(k), static_cast<const T2*>(w2), static_cast<const T*>(cab),
      static_cast<const T*>(cb1), static_cast<const T*>(cbb), static_cast<const T*>(p0),
      static_cast<T2*>(out), P, K, B, n, far, per_ball, (T)lim, (T)rescale);
  return cudaGetLastError();
}

template <typename T, bool CK>
cudaError_t run(const void* x, long long sxd, long long sxk, long long sxp, int kx,
                const void* centers, long long sck, const void* k, const void* w2,
                const void* cab, const void* cb1, const void* cbb, const void* p0, void* out,
                int P, int K, int B, int n, int far, int per_ball, int few, double lim,
                double rescale, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (P == 0 || K == 0) return cudaSuccess;
  if (few) {
    const size_t smem = sizeof(Coef4<T>) * n * n + sizeof(T2) * (kFewWarps * (size_t)n + kFewWarps) +
                        sizeof(T) * n;
    auto kernel = fused_ba_eval_few_kernel<T, CK>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<P * K, kFewThreads, smem, stream>>>(
        static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers), sck,
        static_cast<const T*>(k), static_cast<const T2*>(w2), static_cast<const T*>(cab),
        static_cast<const T*>(cb1), static_cast<const T*>(cbb), static_cast<const T*>(p0),
        static_cast<T2*>(out), P, K, B, n, far, per_ball, (T)lim, (T)rescale);
    return cudaGetLastError();
  }
  if (n == kUnrolledN)
    return run_many<T, kUnrolledN, CK>(x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1,
                                       cbb, p0, out, P, K, B, n, far, per_ball, lim, rescale,
                                       stream);
  return run_many<T, 0, CK>(x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1, cbb, p0, out,
                            P, K, B, n, far, per_ball, lim, rescale, stream);
}

template <typename T>
cudaError_t run_k(int ck, const void* x, long long sxd, long long sxk, long long sxp, int kx,
                  const void* centers, long long sck, const void* k, const void* w2,
                  const void* cab, const void* cb1, const void* cbb, const void* p0, void* out,
                  int P, int K, int B, int n, int far, int per_ball, int few, double lim,
                  double rescale, cudaStream_t stream) {
  if (ck)
    return run<T, true>(x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1, cbb, p0, out, P,
                        K, B, n, far, per_ball, few, lim, rescale, stream);
  return run<T, false>(x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1, cbb, p0, out, P, K,
                       B, n, far, per_ball, few, lim, rescale, stream);
}

}  // namespace

// x [3, Kx, P] by strides; centers [K, B, 3] with (B, 3) contiguous at k
// stride sck (0: shared); k [K] real, or complex (ck = 1, interleaved);
// w2 [K, B, 2n - 1, n]; out [P, K] or [P, K, B].
extern "C" int bhs_fused_ba_eval(const void* x, long long sxd, long long sxk, long long sxp,
                                 int kx, const void* centers, long long sck, const void* k,
                                 int ck, const void* w2, const void* cab, const void* cb1,
                                 const void* cbb, const void* p0, void* out, int P, int K,
                                 int B, int n, int far, int per_ball, int few, double lim,
                                 double rescale, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run_k<double>(ck, x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1, cbb, p0,
                              out, P, K, B, n, far, per_ball, few, lim, rescale, st);
  return (int)run_k<float>(ck, x, sxd, sxk, sxp, kx, centers, sck, k, w2, cab, cb1, cbb, p0,
                           out, P, K, B, n, far, per_ball, few, lim, rescale, st);
}
