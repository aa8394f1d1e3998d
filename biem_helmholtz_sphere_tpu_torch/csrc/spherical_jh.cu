// K5: the radial special-function family of odd dimension d.
//
// Replaces biem_helmholtz_sphere_tpu/special/_family.py spherical_jh_scaled
// (:215), spherical_h_scaled (:288) and spherical_jh_all (:332) with their
// helpers _seeds (:47), _miller_down (:92), _upward_scaled (:148) and
// _scaled_deriv (:187).  Their plain versions in the port's
// special/_family.py are this kernel's oracle; it follows them step for
// step.
//
// For each complex z and order n < n_end, with base 3 and shift
// m = (d-3)/2 (f^{(d)}_n = z^{-m} f^{(3)}_{n+m}, n_top = n_end + m):
//   h_n by upward recurrence from the closed-form seeds;
//   j_n upward where n <= |z|, elsewhere by Miller's downward recurrence
//   from n_top + 36, normalised by the Wronskian j_1 h_0 - j_0 h_1 = i/z^2;
//   f'_n = f_{n-1} - ((n+1)/z) f_n, shifted for m > 0.
// Three modes behind one entry:
//   0  scaled j, j', h, h': mantissa * exp(exponent), max(|re|, |im|) = 1;
//   1  scaled h only (the upward pass alone);
//   2  unscaled j, j', h, h', with the z = 0 limits.
// A scaled recurrence divides its mantissas by `rescale` (1e30 in float32,
// 1e150 in float64) whenever |f| -- a hypot, as torch's complex abs --
// exceeds it, and adds log(rescale) to the exponent, one addition per
// rescale, as the plain version does: both then carry the same exponents,
// so their values agree to rounding.
//
// What bounds it on the H100: neither bytes nor operations.  A launch on
// the main path holds 36-64 z's, each a dependent chain of ~100-200
// complex steps, and writes under 130 KB: the bound is one launch plus one
// serial chain, a few microseconds.  Design: one thread per z, the
// recurrence state in registers; the Miller table (n_top + 1 complex
// values and exponents) sits in shared memory strided by thread, since
// n_end is a runtime value.  The upward pass then writes each order as
// soon as it reaches it, derivatives included.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;       // z's per CUDA block
constexpr int kMillerBuffer = 36;  // _MILLER_BUFFER of special/_family.py

enum { kScaled = 0, kHOnly = 1, kUnscaled = 2 };

__device__ __forceinline__ float t_sinh(float a) { return sinhf(a); }
__device__ __forceinline__ double t_sinh(double a) { return sinh(a); }
__device__ __forceinline__ float t_cosh(float a) { return coshf(a); }
__device__ __forceinline__ double t_cosh(double a) { return cosh(a); }
__device__ __forceinline__ float t_fabs(float a) { return fabsf(a); }
__device__ __forceinline__ double t_fabs(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ c2_t<T> csub(c2_t<T> a, c2_t<T> b) {
  return cmake<T>(a.x - b.x, a.y - b.y);
}

template <typename T>
__device__ __forceinline__ T cabs(c2_t<T> a) {
  return t_hypot(a.x, a.y);
}

// a / b as torch's complex division does it (Smith's algorithm)
template <typename T>
__device__ c2_t<T> cdiv(c2_t<T> a, c2_t<T> b) {
  const T ac = t_fabs(b.x), ad = t_fabs(b.y);
  if (ac >= ad) {
    if (ac == T(0) && ad == T(0)) return cmake<T>(a.x / ac, a.y / ad);
    const T rat = b.y / b.x;
    const T scl = T(1) / (b.x + b.y * rat);
    return cmake<T>((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const T rat = b.x / b.y;
  const T scl = T(1) / (b.y + b.x * rat);
  return cmake<T>((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

template <typename T>
__device__ __forceinline__ c2_t<T> crecip(c2_t<T> b) {
  return cdiv<T>(cmake<T>(1, 0), b);
}

template <typename T>
__device__ __forceinline__ c2_t<T> cdiv_real(c2_t<T> a, T s) {
  return cmake<T>(a.x / s, a.y / s);
}

template <typename T>
__device__ c2_t<T> cexp_(c2_t<T> a) {
  const T r = t_exp(a.x);
  if (a.y == T(0)) return cmake<T>(r, a.y);
  return cmake<T>(r * t_cos(a.y), r * t_sin(a.y));
}

// (j0, j1, h0, h1) of the base-3 family: the port's _seeds, with the
// series for j0, j1 at |z| < 1e-4 and z substituted only at z = 0
template <typename T>
__device__ void seeds(c2_t<T> z, c2_t<T>* j0, c2_t<T>* j1, c2_t<T>* h0, c2_t<T>* h1) {
  using T2 = c2_t<T>;
  const T2 one = cmake<T>(1, 0);
  if (cabs<T>(z) < T(1e-4)) {
    const T2 z2 = cmul<T>(z, z);
    *j0 = csub<T>(one, cmul<T>(cdiv_real<T>(z2, T(6)),
                               csub<T>(one, cdiv_real<T>(z2, T(20)))));
    *j1 = cmul<T>(cdiv_real<T>(z, T(3)),
                  csub<T>(one, cmul<T>(cdiv_real<T>(z2, T(10)),
                                       csub<T>(one, cdiv_real<T>(z2, T(28))))));
  } else {
    const T ch = t_cosh(z.y), sh = t_sinh(z.y);
    const T2 s = cmake<T>(t_sin(z.x) * ch, t_cos(z.x) * sh);
    const T2 c = cmake<T>(t_cos(z.x) * ch, -t_sin(z.x) * sh);
    *j0 = cdiv<T>(s, z);
    *j1 = csub<T>(cdiv<T>(s, cmul<T>(z, z)), cdiv<T>(c, z));
  }
  const T2 zh = (z.x == T(0) && z.y == T(0)) ? one : z;
  const T2 eiz = cexp_<T>(cmake<T>(-z.y, z.x));
  *h0 = cdiv<T>(cmake<T>(eiz.y, -eiz.x), zh);  // e^{iz} (-i) / z
  *h1 = cdiv<T>(cmul<T>(cmake<T>(-eiz.x, -eiz.y), cmake<T>(zh.x, zh.y + T(1))),
                cmul<T>(zh, zh));
}

// Upward recurrence f_{n+1} = ((2n+1)/z) f_n - f_{n-1}; fm, fn hold the
// last two orders, e the exponent of the scaled form.
template <typename T>
struct Upward {
  c2_t<T> fm, fn;
  T e;
  // advance to order i >= 2
  __device__ __forceinline__ void step(c2_t<T> inv, int i, bool scaled, T rescale,
                                       T inv_rescale, T log_rescale) {
    c2_t<T> fp = csub<T>(cscale<T>(cmul<T>(fn, inv), T(2 * i - 1)), fm);
    if (scaled && cabs<T>(fp) > rescale) {
      fp = cscale<T>(fp, inv_rescale);
      fn = cscale<T>(fn, inv_rescale);
      e = e + log_rescale;
    }
    fm = fn;
    fn = fp;
  }
  // the order-n value (stored mantissa, exponent) for n = 0, 1 or the last step
  __device__ __forceinline__ void at(int n, c2_t<T> f0, c2_t<T>* v, T* ve) const {
    *v = n == 0 ? f0 : fn;
    *ve = n <= 1 ? T(0) : e;
  }
};

// renormalise to max(|re|, |im|) = 1 (the port's _normalize) and store
template <typename T>
__device__ __forceinline__ void put_scaled(c2_t<T>* mo, T* eo, size_t o, c2_t<T> v, T e) {
  const T ar = t_fabs(v.x), ai = t_fabs(v.y);
  // torch.maximum propagates NaN, and log(where(a > 0, a, 1)) turns it into 0
  const T a = (ar != ar || ai != ai) ? T(0) : (ar > ai ? ar : ai);
  const T ln = t_log(a > T(0) ? a : T(1));
  mo[o] = cscale<T>(v, t_exp(-ln));
  eo[o] = e + ln;
}

// scaled derivative at order n >= 1 from orders n-1 (pm, pe) and n (cm, ce):
// the port's _scaled_deriv, then the z^{-m} phase
template <typename T>
__device__ __forceinline__ void deriv_scaled(c2_t<T> pm, T pe, c2_t<T> cm, T ce, int n, int m,
                                             c2_t<T> inv, c2_t<T> zm, T zm_log, c2_t<T>* out,
                                             T* out_e) {
  T ep = pe > ce ? pe : ce;
  const c2_t<T> t1 = cscale<T>(pm, t_exp(pe - ep));
  const c2_t<T> cs = cscale<T>(cm, t_exp(ce - ep));
  c2_t<T> fp = csub<T>(t1, cmul<T>(cs, cscale<T>(inv, T(n + 1))));
  if (m > 0) {
    fp = cmul<T>(zm, csub<T>(fp, cmul<T>(cs, cscale<T>(inv, T(m)))));
    ep = ep + zm_log;
  }
  *out = fp;
  *out_e = ep;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
spherical_jh_kernel(const c2_t<T>* __restrict__ z_in, c2_t<T>* __restrict__ jm,
                    T* __restrict__ je, c2_t<T>* __restrict__ jpm, T* __restrict__ jpe,
                    c2_t<T>* __restrict__ hm, T* __restrict__ he, c2_t<T>* __restrict__ hpm,
                    T* __restrict__ hpe, int N, int n_end, int m, int d, double c_d,
                    double rescale_d) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  constexpr bool kScaledMode = kMode != kUnscaled;
  const int n_top = n_end + m;
  const T rescale = (T)rescale_d;
  const T inv_rescale = (T)(1.0 / rescale_d);
  const T log_rescale = (T)log(rescale_d);

  T2 z = z_in[i];
  const bool at_zero = kMode == kUnscaled && z.x == T(0) && z.y == T(0);
  if (at_zero) z = cmake<T>(1, 0);
  const T absz = cabs<T>(z);
  const T2 inv = crecip<T>(z);
  T2 j0, j1, h0, h1;
  seeds<T>(z, &j0, &j1, &h0, &h1);

  // the shift z^{-m}: (z/|z|)^{-m} and -m log|z| scaled, z^{-m} unscaled
  T2 zm = cmake<T>(1, 0);
  T zm_log = T(0);
  if (m > 0) {
    const T2 r = crecip<T>(kScaledMode ? cscale<T>(z, T(1) / absz) : z);
    for (int q = 0; q < m; ++q) zm = cmul<T>(zm, r);
    if (kScaledMode) zm_log = T(-m) * t_log(absz);
  }
  const size_t row = (size_t)i * n_end;

  Upward<T> hu{h0, h1, T(0)};
  if (kMode == kHOnly) {
    for (int n = 0; n < n_top; ++n) {
      if (n >= 2) hu.step(inv, n, true, rescale, inv_rescale, log_rescale);
      if (n < m) continue;
      T2 v;
      T ve;
      hu.at(n, h0, &v, &ve);
      if (m > 0) {
        v = cmul<T>(zm, v);
        ve = ve + zm_log;
      }
      put_scaled<T>(hm, he, row + n - m, v, ve);
    }
    return;
  }

  // Miller's downward recurrence, unnormalised, with log-scaling: A[n] S[n]
  T2* A = reinterpret_cast<T2*>(smem_raw) + threadIdx.x;
  T* S = reinterpret_cast<T*>(reinterpret_cast<T2*>(smem_raw) + (size_t)(n_top + 1) * kThreads) +
         threadIdx.x;
  {
    T2 fn1 = cmake<T>(0, 0), fn = cmake<T>(1, 0);
    T sig = T(0);
    for (int n = n_top + kMillerBuffer; n >= 1; --n) {
      T2 fm = csub<T>(cscale<T>(cmul<T>(fn, inv), T(2 * n + 1)), fn1);
      if (cabs<T>(fm) > rescale) {
        fm = cscale<T>(fm, inv_rescale);
        fn = cscale<T>(fn, inv_rescale);
        sig = sig + log_rescale;
      }
      fn1 = fn;
      fn = fm;
      if (n - 1 <= n_top) {
        A[(n - 1) * kThreads] = fm;
        S[(n - 1) * kThreads] = sig;
      }
    }
  }
  // Wronskian normalisation: s = (i / z^2) / (a_1 e^{sig_1 - sig_0} h_0 - a_0 h_1)
  const T S0 = S[0];
  const T2 w_target = [&] {
    const T2 r = crecip<T>(cmul<T>(z, z));
    return cmake<T>(-r.y, r.x);
  }();
  const T2 denom = csub<T>(cmul<T>(cscale<T>(A[kThreads], t_exp(S[kThreads] - S0)), h0),
                           cmul<T>(A[0], h1));
  const T2 s = cdiv<T>(w_target, denom);
  const T s_abs = cabs<T>(s);
  const T2 s_hat = s_abs > T(0) ? cscale<T>(s, T(1) / s_abs) : s;
  const T ln_s = t_log(s_abs > T(0) ? s_abs : T(1));

  Upward<T> ju{j0, j1, T(0)};
  T2 jv_p = j0, hv_p = h0;
  T je_p = T(0), he_p = T(0);
  const int n_last = max(m + n_end - 1, 1);
  for (int n = 0; n <= n_last; ++n) {
    // order-n values: h upward; j upward where n <= |z|, else Miller
    if (n >= 2) hu.step(inv, n, kScaledMode, rescale, inv_rescale, log_rescale);
    T2 hv, jv;
    T hev, jev;
    hu.at(n, h0, &hv, &hev);
    if ((T)n <= absz) {
      if (n >= 2) ju.step(inv, n, kScaledMode, rescale, inv_rescale, log_rescale);
      ju.at(n, j0, &jv, &jev);
    } else if (kScaledMode) {
      jv = cmul<T>(s_hat, A[n * kThreads]);
      jev = (S[n * kThreads] - S0) + ln_s;
    } else {
      jv = cscale<T>(cmul<T>(s, A[n * kThreads]), t_exp(S[n * kThreads] - S0));
      jev = T(0);
    }

    const bool in_win = n >= m && n < m + n_end;
    const size_t o = row + (n - m);
    if (kScaledMode) {
      if (in_win) {
        put_scaled<T>(jm, je, o, m > 0 ? cmul<T>(zm, jv) : jv, m > 0 ? jev + zm_log : jev);
        put_scaled<T>(hm, he, o, m > 0 ? cmul<T>(zm, hv) : hv, m > 0 ? hev + zm_log : hev);
        if (n >= 1) {
          T2 dv;
          T de;
          deriv_scaled<T>(jv_p, je_p, jv, jev, n, m, inv, zm, zm_log, &dv, &de);
          put_scaled<T>(jpm, jpe, o, dv, de);
          deriv_scaled<T>(hv_p, he_p, hv, hev, n, m, inv, zm, zm_log, &dv, &de);
          put_scaled<T>(hpm, hpe, o, dv, de);
        }
      }
      if (n == 1 && m == 0) {  // f'_0 = -f_1
        put_scaled<T>(jpm, jpe, row, cmake<T>(-jv.x, -jv.y), jev);
        put_scaled<T>(hpm, hpe, row, cmake<T>(-hv.x, -hv.y), hev);
      }
    } else {
      const int pos = n - m;
      if (in_win) {
        T2 jo = m > 0 ? cmul<T>(zm, jv) : jv;
        T2 ho = m > 0 ? cmul<T>(zm, hv) : hv;
        if (at_zero) {  // j_n(0) = c_d delta_{n0}; h is infinite
          jo = cmake<T>(pos == 0 ? (T)c_d : T(0), T(0));
          ho = cmake<T>(INFINITY, INFINITY);
        }
        jm[o] = jo;
        hm[o] = ho;
        if (n >= 1) {
          T2 jd = csub<T>(jv_p, cmul<T>(jv, cscale<T>(inv, T(n + 1))));
          T2 hd = csub<T>(hv_p, cmul<T>(hv, cscale<T>(inv, T(n + 1))));
          if (m > 0) {
            jd = cmul<T>(zm, csub<T>(jd, cmul<T>(jv, cscale<T>(inv, T(m)))));
            hd = cmul<T>(zm, csub<T>(hd, cmul<T>(hv, cscale<T>(inv, T(m)))));
          }
          if (at_zero) {  // j_n'(0) = (c_d / d) delta_{n1}
            jd = cmake<T>(pos == 1 ? (T)(c_d / d) : T(0), T(0));
            hd = cmake<T>(INFINITY, INFINITY);
          }
          jpm[o] = jd;
          hpm[o] = hd;
        }
      }
      if (n == 1 && m == 0) {  // f'_0 = -f_1
        jpm[row] = at_zero ? cmake<T>(T(0), T(0)) : cmake<T>(-jv.x, -jv.y);
        hpm[row] = at_zero ? cmake<T>(INFINITY, INFINITY) : cmake<T>(-hv.x, -hv.y);
      }
    }
    jv_p = jv;
    je_p = jev;
    hv_p = hv;
    he_p = hev;
  }
}

template <typename T, int kMode>
cudaError_t run(const void* z, void* const* outs, int N, int n_end, int m, int d, double c_d,
                double rescale, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const size_t smem = kMode == kHOnly ? 0
                                      : (size_t)kThreads * (n_end + m + 1) *
                                            (sizeof(c2_t<T>) + sizeof(T));
  const cudaError_t err = allow_smem(spherical_jh_kernel<T, kMode>, smem);
  if (err != cudaSuccess) return err;
  using T2 = c2_t<T>;
  spherical_jh_kernel<T, kMode><<<(N + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      static_cast<const T2*>(z), static_cast<T2*>(outs[0]), static_cast<T*>(outs[1]),
      static_cast<T2*>(outs[2]), static_cast<T*>(outs[3]), static_cast<T2*>(outs[4]),
      static_cast<T*>(outs[5]), static_cast<T2*>(outs[6]), static_cast<T*>(outs[7]), N, n_end,
      m, d, c_d, rescale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const void* z, void* const* outs, int N, int n_end, int m, int d,
                     double c_d, double rescale, cudaStream_t stream) {
  switch (mode) {
    case kScaled:
      return run<T, kScaled>(z, outs, N, n_end, m, d, c_d, rescale, stream);
    case kHOnly:
      return run<T, kHOnly>(z, outs, N, n_end, m, d, c_d, rescale, stream);
    case kUnscaled:
      return run<T, kUnscaled>(z, outs, N, n_end, m, d, c_d, rescale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Outputs (null where a mode does not write them), each [N, n_end]:
// mode 0: jm je jpm jpe hm he hpm hpe; mode 1: hm he; mode 2: j - jp - h - hp -.
extern "C" int bhs_spherical_jh(const void* z, void* jm, void* je, void* jpm, void* jpe,
                                void* hm, void* he, void* hpm, void* hpe, int N, int n_end,
                                int m, int mode, int d, double c_d, double rescale, int dbl,
                                void* stream) {
  if (n_end < 1 || m < 0) return (int)cudaErrorInvalidValue;
  void* const outs[8] = {jm, je, jpm, jpe, hm, he, hpm, hpe};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl) return (int)dispatch<double>(mode, z, outs, N, n_end, m, d, c_d, rescale, st);
  return (int)dispatch<float>(mode, z, outs, N, n_end, m, d, c_d, rescale, st);
}
