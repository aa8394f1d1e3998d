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
// form, normalized and clamped at exp(80) (float32) / exp(700) (float64)
// exactly as the plain version does (far field: rad = 1), and the sum over
// balls b (or one output per ball).
//
// What bounds it on the H100: FP32 instruction throughput, not bytes: ~16 * 63 * 32 * 14
// flop per point against 24 bytes of point data.  Design: one thread per
// evaluation point walking the balls; each ball's regrouped weights
// w2 [M=2n-1, n] (16 KB in c64 at n=32) are staged in shared memory one
// ball at a time (all 16 would be 258 KB, over the 227 KB a block may
// have).  The h_l table of each thread lives in shared memory, the Jacobi
// recurrence in registers; the +m and -m slots share their (|m|, |m|)
// recurrence.  Nothing of size [points, balls, .] reaches device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// mant * exp(e) renormalized to max(|re|, |im|) = 1, exponent clamped at lim
template <typename T>
__device__ __forceinline__ c2_t<T> h_value(c2_t<T> mant, T e, T lim) {
  const T ar = mant.x < 0 ? -mant.x : mant.x;
  const T ai = mant.y < 0 ? -mant.y : mant.y;
  const T a = ar > ai ? ar : ai;
  const T ln = a > 0 ? t_log(a) : (T)0;
  const T ee = e + ln < lim ? e + ln : lim;
  return cscale<T>(cscale<T>(mant, t_exp(-ln)), t_exp(ee));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ba_eval_kernel(const T* __restrict__ x, long long sxd, long long sxk, long long sxp,
                     int kx, const T* __restrict__ centers, const T* __restrict__ kv,
                     const c2_t<T>* __restrict__ w2, const T* __restrict__ ca,
                     const T* __restrict__ cb1, const T* __restrict__ cbb,
                     const T* __restrict__ p0v, c2_t<T>* __restrict__ out, int P, int K,
                     int B, int n, int far, int per_ball, T lim, T rescale) {
  using T2 = c2_t<T>;
  const int M = 2 * n - 1;
  const int bd = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* Ws = reinterpret_cast<T2*>(smem_raw);  // [M * n] weights of one ball
  T2* Hs = Ws + M * n;                        // [n * bd] h_l of each thread
  T* Ca = reinterpret_cast<T*>(Hs + n * bd);  // [n * n] recurrence tables
  T* Cb1 = Ca + n * n;
  T* Cbb = Cb1 + n * n;
  T* P0 = Cbb + n * n;  // [n]

  const int tid = threadIdx.x;
  const int p = blockIdx.x * bd + tid;
  const int k = blockIdx.y;
  const bool active = p < P;
  for (int e = tid; e < n * n; e += bd) {
    Ca[e] = ca[e];
    Cb1[e] = cb1[e];
    Cbb[e] = cbb[e];
  }
  for (int e = tid; e < n; e += bd) P0[e] = p0v[e];

  T px = 0, py = 0, pz = 0;
  if (active) {
    const T* xp = x + (kx == 1 ? 0LL : (long long)k * sxk) + (long long)p * sxp;
    px = xp[0];
    py = xp[sxd];
    pz = xp[2 * sxd];
  }
  const T kk = kv[k];
  const T log_rescale = t_log(rescale);
  const T inv_sqrt_2pi = (T)0.39894228040143267794;
  T2 total = cmake<T>(0, 0);

  for (int b = 0; b < B; ++b) {
    __syncthreads();  // the previous ball's weights are no longer read
    const T2* wsrc = w2 + ((size_t)k * B + b) * M * n;
    for (int e = tid; e < M * n; e += bd) Ws[e] = wsrc[e];
    __syncthreads();
    if (!active) continue;

    T rx = px, ry = py, rz = pz;
    if (!far) {
      rx -= centers[3 * b];
      ry -= centers[3 * b + 1];
      rz -= centers[3 * b + 2];
    }
    const T rc = t_hypot(rx, ry);
    const T theta = t_atan2(rc, rz);
    const T phi = t_atan2(ry, rx);
    const T ct = t_cos(theta);
    const T st = t_sin(theta);

    if (!far) {
      // h_0, h_1 seeds, then the upward recurrence with rescaling
      const T z = kk * t_hypot(rc, rz);
      const T zs = z == 0 ? (T)1 : z;  // as the plain version's h seeds
      const T cz = t_cos(z), sz = t_sin(z);
      T2 fm = cmake<T>(sz / zs, -cz / zs);
      T2 fn = cmake<T>(-(cz * zs - sz) / (zs * zs), -(sz * zs + cz) / (zs * zs));
      T e = 0;
      Hs[tid] = h_value<T>(fm, e, lim);
      if (n > 1) Hs[bd + tid] = h_value<T>(fn, e, lim);
      for (int l = 1; l + 1 < n; ++l) {
        const T c = (T)(2 * l + 1) / z;
        T2 fp = cmake<T>(fn.x * c - fm.x, fn.y * c - fm.y);
        if (t_hypot(fp.x, fp.y) > rescale) {
          fp = cscale<T>(fp, (T)1 / rescale);
          fn = cscale<T>(fn, (T)1 / rescale);
          e += log_rescale;
        }
        fm = fn;
        fn = fp;
        Hs[(l + 1) * bd + tid] = h_value<T>(fp, e, lim);
      }
    }

    T2 ub = cmake<T>(0, 0);
    T stp = 1;  // sin^f(theta)
    for (int f = 0; f < n; ++f) {
      const T2* wp = Ws + (n - 1 + f) * n;  // slot m = +f
      const T2* wm = Ws + (n - 1 - f) * n;  // slot m = -f
      const T* a_f = Ca + f * n;
      const T* b1_f = Cb1 + f * n;
      const T* bb_f = Cbb + f * n;
      T pm = 0, pn = 0;
      T2 ap = cmake<T>(0, 0), am = cmake<T>(0, 0);
      for (int l = f; l < n; ++l) {
        T pp;
        if (l == f) {
          pp = P0[f];
        } else {
          const int j = l - f - 1;
          pp = (ct - a_f[j]) * pn * b1_f[j] - bb_f[j] * pm;
        }
        pm = pn;
        pn = pp;
        const T2 rad = far ? cmake<T>(1, 0) : Hs[l * bd + tid];
        const T2 tp = cmul<T>(rad, wp[l]);
        ap = cmake<T>(t_fma(pp, tp.x, ap.x), t_fma(pp, tp.y, ap.y));
        if (f > 0) {
          const T2 tm = cmul<T>(rad, wm[l]);
          am = cmake<T>(t_fma(pp, tm.x, am.x), t_fma(pp, tm.y, am.y));
        }
      }
      const T ang = phi * (T)f;
      const T ca_ = t_cos(ang), sa = t_sin(ang);
      T2 term = cmul<T>(ap, cmake<T>(ca_, sa));
      if (f > 0) term = cadd<T>(term, cmul<T>(am, cmake<T>(ca_, -sa)));
      ub = cadd<T>(ub, cscale<T>(term, stp));
      stp *= st;
    }
    ub = cscale<T>(ub, inv_sqrt_2pi);
    if (per_ball)
      out[((size_t)p * K + k) * B + b] = ub;
    else
      total = cadd<T>(total, ub);
  }
  if (active && !per_ball) out[(size_t)p * K + k] = total;
}

template <typename T>
cudaError_t run(const void* x, long long sxd, long long sxk, long long sxp, int kx,
                const void* centers, const void* k, const void* w2, const void* ca,
                const void* cb1, const void* cbb, const void* p0, void* out, int P, int K,
                int B, int n, int far, int per_ball, double lim, double rescale,
                cudaStream_t stream) {
  if (P == 0 || K == 0) return cudaSuccess;
  const int M = 2 * n - 1;
  const size_t smem = sizeof(c2_t<T>) * ((size_t)M * n + (size_t)n * kThreads) +
                      sizeof(T) * (3 * (size_t)n * n + n);
  cudaError_t err = allow_smem(fused_ba_eval_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kThreads - 1) / kThreads, K);
  fused_ba_eval_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers),
      static_cast<const T*>(k), static_cast<const c2_t<T>*>(w2),
      static_cast<const T*>(ca), static_cast<const T*>(cb1), static_cast<const T*>(cbb),
      static_cast<const T*>(p0), static_cast<c2_t<T>*>(out), P, K, B, n, far, per_ball,
      (T)lim, (T)rescale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bhs_fused_ba_eval(const void* x, long long sxd, long long sxk, long long sxp,
                                 int kx, const void* centers, const void* k, const void* w2,
                                 const void* ca, const void* cb1, const void* cbb,
                                 const void* p0, void* out, int P, int K, int B, int n,
                                 int far, int per_ball, double lim, double rescale, int dbl,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(x, sxd, sxk, sxp, kx, centers, k, w2, ca, cb1, cbb, p0, out, P,
                            K, B, n, far, per_ball, lim, rescale, st);
  return (int)run<float>(x, sxd, sxk, sxp, kx, centers, k, w2, ca, cb1, cbb, p0, out, P, K,
                         B, n, far, per_ball, lim, rescale, st);
}
