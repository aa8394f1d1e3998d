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
// the main path holds 36-64 z's and writes under 130 KB; its floor is one
// launch plus the longest dependent chain, Miller's n_top + 36 complex
// steps.  Design: one warp per z.
//   phase 1  the three recurrences run on three lanes of the warp in one
//            instruction stream (lane 0 Miller downward, lane 1 h upward,
//            lane 2 j upward while n <= |z|), so they overlap instead of
//            running one after the other; each lane only steps and stores
//            its raw (mantissa, exponent) per order into the warp's tables
//            in shared memory.  The step has no divergent branch: a lane
//            past its chain steps on into entries nothing reads, the
//            rescale is a select, and the rescale test computes the hypot
//            only where max(|re|, |im|) >= rescale / 2 (below that |f| <=
//            sqrt(2) max < rescale, so the answer is the plain version's),
//            in a branch the whole warp takes or skips (__any_sync).  The
//            h-only mode runs lane 1 alone.
//   phase 2  after a __syncwarp every lane forms the Wronskian normaliser
//            from the tables (the same instructions on every lane);
//   phase 3  lane l takes the output orders n - m = l, l + 32, ...: the
//            Miller-or-upward choice, the normalisation, the
//            renormalisation (a log and an exp each), the derivatives from
//            orders n - 1 and n, the z^{-m} phase and the stores, which are
//            coalesced across the warp.
// Outputs are planes [N, n_end] of one buffer: the complex planes (j, j',
// h, h' or h alone) first, then the exponent planes in the same order.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // z's per CUDA block, a warp each
constexpr int kMillerBuffer = 36;  // _MILLER_BUFFER of special/_family.py
constexpr int kChains = 3;         // tables per warp: Miller, h, j

enum { kScaled = 0, kHOnly = 1, kUnscaled = 2 };
enum { kMiller = 0, kH = 1, kJ = 2 };  // the lane, and the table, of each chain

__device__ __forceinline__ float t_sinh(float a) { return sinhf(a); }
__device__ __forceinline__ double t_sinh(double a) { return sinh(a); }
__device__ __forceinline__ float t_cosh(float a) { return coshf(a); }
__device__ __forceinline__ double t_cosh(double a) { return cosh(a); }
__device__ __forceinline__ float t_fabs(float a) { return fabsf(a); }
__device__ __forceinline__ double t_fabs(double a) { return fabs(a); }
__device__ __forceinline__ float t_fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_fmax(double a, double b) { return fmax(a, b); }

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
__global__ void __launch_bounds__(kWarps * 32)
spherical_jh_kernel(const c2_t<T>* __restrict__ z_in, c2_t<T>* __restrict__ out, int N,
                    int n_end, int m, int d, double c_d, double rescale_d,
                    double inv_rescale_d, double log_rescale_d) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // the whole warp: i is the warp's z
  constexpr bool kScaledMode = kMode != kUnscaled;
  const int n_top = n_end + m;
  const int n_tab = n_top + 1;
  const int n_last = max(n_top - 1, 1);  // the highest order any output reads
  const T rescale = (T)rescale_d;
  const T inv_rescale = (T)inv_rescale_d;
  const T log_rescale = (T)log_rescale_d;
  // this warp's tables: [chain][order] mantissas, then exponents
  T2* tab_m = reinterpret_cast<T2*>(smem_raw) + (size_t)warp * kChains * n_tab;
  T* tab_e = reinterpret_cast<T*>(reinterpret_cast<T2*>(smem_raw) +
                                  (size_t)kWarps * kChains * n_tab) +
             (size_t)warp * kChains * n_tab;

  T2 z = z_in[i];
  const bool at_zero = kMode == kUnscaled && z.x == T(0) && z.y == T(0);
  if (at_zero) z = cmake<T>(1, 0);
  const T absz = cabs<T>(z);
  const T2 inv = crecip<T>(z);
  T2 j0, j1, h0, h1;
  seeds<T>(z, &j0, &j1, &h0, &h1);

  // phase 1: lane kMiller f_{n-1} = ((2n+1)/z) f_n - f_{n+1}, n = n_top+36..1,
  // storing orders <= n_top (always log-scaled); lanes kH and kJ
  // f_n = ((2n-1)/z) f_{n-1} - f_{n-2}, n = 2..n_last (j while n <= |z|)
  const int n_start = n_top + kMillerBuffer;
  int steps = 0, coef = 3, at = n_top + 1, dir = 0;  // at > n_top: stores nothing
  T2 fm = cmake<T>(0, 0), fn = cmake<T>(1, 0);
  if (lane == kMiller && kMode != kHOnly) {
    steps = n_start;
    coef = 2 * n_start + 1;
    at = n_start - 1;
    dir = -1;
  } else if (lane == kH) {
    steps = n_last - 1;
    at = 2;
    dir = 1;
    fm = h0;
    fn = h1;
  } else if (lane == kJ && kMode != kHOnly) {
    // the orders 2..n_last with n <= |z| (n is exact in T, so n <= |z|
    // exactly when n <= floor(|z|))
    steps = max((absz >= T(n_last) ? n_last : (int)absz) - 1, 0);
    at = 2;
    dir = 1;
    fm = j0;
    fn = j1;
  }
  const bool rescales = lane == kMiller || kScaledMode;
  T2* my_m = tab_m + (size_t)min(lane, kChains - 1) * n_tab;
  T* my_e = tab_e + (size_t)min(lane, kChains - 1) * n_tab;
  if (lane == kH || (lane == kJ && kMode != kHOnly)) {
    my_m[0] = fm;
    my_m[1] = fn;
    my_e[0] = T(0);
    my_e[1] = T(0);
  }
  const int max_steps = kMode == kHOnly ? n_last - 1 : n_start;
  // one step for every lane, without divergence.  A lane past its chain
  // steps on, unscaled, into table entries nothing reads (orders past
  // n_last, or j past |z|).  The rescale is a select; its test is the
  // plain version's |f| > rescale, with the hypot only where it can be
  // true (max(|re|, |im|) < rescale / 2 gives |f| < rescale; NaN and inf
  // take the hypot's answer), in a branch the whole warp takes or skips
  const T half = T(0.5) * rescale;
  const T dc = T(2 * dir);
  T c = T(coef), e = T(0);
  for (int t = 0; t < max_steps; ++t) {
    const T2 fp = csub<T>(cscale<T>(cmul<T>(fn, inv), c), fm);
    const bool maybe = t < steps && rescales && t_fmax(t_fabs(fp.x), t_fabs(fp.y)) >= half;
    bool big = false;
    if (__any_sync(0xffffffffu, maybe)) big = maybe && cabs<T>(fp) > rescale;
    fm = big ? cscale<T>(fn, inv_rescale) : fn;
    fn = big ? cscale<T>(fp, inv_rescale) : fp;
    e = big ? e + log_rescale : e;
    if (at <= n_top) {
      my_m[at] = fn;
      my_e[at] = e;
    }
    at += dir;
    c += dc;
  }
  __syncwarp();

  const T2* Hm = tab_m + kH * n_tab;
  const T* He = tab_e + kH * n_tab;
  // the shift z^{-m}: (z/|z|)^{-m} and -m log|z| scaled, z^{-m} unscaled
  T2 zm = cmake<T>(1, 0);
  T zm_log = T(0);
  if (m > 0) {
    const T2 r = crecip<T>(kScaledMode ? cscale<T>(z, T(1) / absz) : z);
    for (int q = 0; q < m; ++q) zm = cmul<T>(zm, r);
    if (kScaledMode) zm_log = T(-m) * t_log(absz);
  }
  const size_t plane = (size_t)N * n_end;
  const size_t row = (size_t)i * n_end;

  if (kMode == kHOnly) {
    T* out_e = reinterpret_cast<T*>(out + plane);
    for (int pos = lane; pos < n_end; pos += 32) {
      const int n = pos + m;
      T2 v = Hm[n];
      T ve = He[n];
      if (m > 0) {
        v = cmul<T>(zm, v);
        ve = ve + zm_log;
      }
      put_scaled<T>(out, out_e, row + pos, v, ve);
    }
    return;
  }

  // phase 2: Wronskian normalisation
  // s = (i / z^2) / (a_1 e^{sig_1 - sig_0} h_0 - a_0 h_1)
  const T2* Am = tab_m + kMiller * n_tab;
  const T* Ae = tab_e + kMiller * n_tab;
  const T2* Jm = tab_m + kJ * n_tab;
  const T* Je = tab_e + kJ * n_tab;
  const T S0 = Ae[0];
  const T2 w_target = [&] {
    const T2 r = crecip<T>(cmul<T>(z, z));
    return cmake<T>(-r.y, r.x);
  }();
  const T2 denom = csub<T>(cmul<T>(cscale<T>(Am[1], t_exp(Ae[1] - S0)), h0), cmul<T>(Am[0], h1));
  const T2 s = cdiv<T>(w_target, denom);
  const T s_abs = cabs<T>(s);
  const T2 s_hat = s_abs > T(0) ? cscale<T>(s, T(1) / s_abs) : s;
  const T ln_s = t_log(s_abs > T(0) ? s_abs : T(1));

  // j at order n: upward where n <= |z|, else Miller, normalised
  auto j_at = [&](int n, T2* v, T* ve) {
    if ((T)n <= absz) {
      *v = Jm[n];
      *ve = Je[n];
    } else if (kScaledMode) {
      *v = cmul<T>(s_hat, Am[n]);
      *ve = (Ae[n] - S0) + ln_s;
    } else {
      *v = cscale<T>(cmul<T>(s, Am[n]), t_exp(Ae[n] - S0));
      *ve = T(0);
    }
  };

  // phase 3: lane l takes the output orders n - m = l, l + 32, ...
  T2* const jo = out;
  T2* const jpo = out + plane;
  T2* const ho = out + 2 * plane;
  T2* const hpo = out + 3 * plane;
  for (int pos = lane; pos < n_end; pos += 32) {
    const int n = pos + m;
    const size_t o = row + pos;
    // order n - 1, or order 1 for f'_0 = -f_1 (n = 0 only when m = 0)
    const int np = n >= 1 ? n - 1 : 1;
    const T2 hv = Hm[n], hv_p = Hm[np];
    const T hev = He[n], he_p = He[np];
    T2 jv, jv_p;
    T jev, je_p;
    j_at(n, &jv, &jev);
    j_at(np, &jv_p, &je_p);
    if (kScaledMode) {
      T* const je = reinterpret_cast<T*>(out + 4 * plane);
      T* const jpe = je + plane;
      T* const he = je + 2 * plane;
      T* const hpe = je + 3 * plane;
      put_scaled<T>(jo, je, o, m > 0 ? cmul<T>(zm, jv) : jv, m > 0 ? jev + zm_log : jev);
      put_scaled<T>(ho, he, o, m > 0 ? cmul<T>(zm, hv) : hv, m > 0 ? hev + zm_log : hev);
      if (n >= 1) {
        T2 dv;
        T de;
        deriv_scaled<T>(jv_p, je_p, jv, jev, n, m, inv, zm, zm_log, &dv, &de);
        put_scaled<T>(jpo, jpe, o, dv, de);
        deriv_scaled<T>(hv_p, he_p, hv, hev, n, m, inv, zm, zm_log, &dv, &de);
        put_scaled<T>(hpo, hpe, o, dv, de);
      } else {  // f'_0 = -f_1
        put_scaled<T>(jpo, jpe, o, cmake<T>(-jv_p.x, -jv_p.y), je_p);
        put_scaled<T>(hpo, hpe, o, cmake<T>(-hv_p.x, -hv_p.y), he_p);
      }
    } else {
      T2 jw = m > 0 ? cmul<T>(zm, jv) : jv;
      T2 hw = m > 0 ? cmul<T>(zm, hv) : hv;
      if (at_zero) {  // j_n(0) = c_d delta_{n0}; h is infinite
        jw = cmake<T>(pos == 0 ? (T)c_d : T(0), T(0));
        hw = cmake<T>(INFINITY, INFINITY);
      }
      jo[o] = jw;
      ho[o] = hw;
      T2 jd, hd;
      if (n >= 1) {
        jd = csub<T>(jv_p, cmul<T>(jv, cscale<T>(inv, T(n + 1))));
        hd = csub<T>(hv_p, cmul<T>(hv, cscale<T>(inv, T(n + 1))));
        if (m > 0) {
          jd = cmul<T>(zm, csub<T>(jd, cmul<T>(jv, cscale<T>(inv, T(m)))));
          hd = cmul<T>(zm, csub<T>(hd, cmul<T>(hv, cscale<T>(inv, T(m)))));
        }
        if (at_zero) {  // j_n'(0) = (c_d / d) delta_{n1}
          jd = cmake<T>(pos == 1 ? (T)(c_d / d) : T(0), T(0));
          hd = cmake<T>(INFINITY, INFINITY);
        }
      } else {  // f'_0 = -f_1
        jd = at_zero ? cmake<T>(T(0), T(0)) : cmake<T>(-jv_p.x, -jv_p.y);
        hd = at_zero ? cmake<T>(INFINITY, INFINITY) : cmake<T>(-hv_p.x, -hv_p.y);
      }
      jpo[o] = jd;
      hpo[o] = hd;
    }
  }
}

template <typename T, int kMode>
cudaError_t run(const void* z, void* out, int N, int n_end, int m, int d, double c_d,
                double rescale, double inv_rescale, double log_rescale, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const size_t smem =
      (size_t)kWarps * kChains * (n_end + m + 1) * (sizeof(c2_t<T>) + sizeof(T));
  const cudaError_t err = allow_smem(spherical_jh_kernel<T, kMode>, smem);
  if (err != cudaSuccess) return err;
  using T2 = c2_t<T>;
  spherical_jh_kernel<T, kMode><<<(N + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      static_cast<const T2*>(z), static_cast<T2*>(out), N, n_end, m, d, c_d, rescale,
      inv_rescale, log_rescale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const void* z, void* out, int N, int n_end, int m, int d,
                     double c_d, double rescale, double inv_rescale, double log_rescale,
                     cudaStream_t stream) {
  switch (mode) {
    case kScaled:
      return run<T, kScaled>(z, out, N, n_end, m, d, c_d, rescale, inv_rescale, log_rescale,
                             stream);
    case kHOnly:
      return run<T, kHOnly>(z, out, N, n_end, m, d, c_d, rescale, inv_rescale, log_rescale,
                            stream);
    case kUnscaled:
      return run<T, kUnscaled>(z, out, N, n_end, m, d, c_d, rescale, inv_rescale, log_rescale,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out: one buffer of planes [N, n_end], the complex planes first, then the
// exponent planes: mode 0 j j' h h' | je j'e he h'e; mode 1 h | he; mode 2
// j j' h h'.  The rescale constants come from the caller, so both versions
// use the same rounding of 1/rescale and log(rescale).
extern "C" int bhs_spherical_jh(const void* z, void* out, int N, int n_end, int m, int mode,
                                int d, double c_d, double rescale, double inv_rescale,
                                double log_rescale, int dbl, void* stream) {
  if (n_end < 1 || m < 0 || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)dispatch<double>(mode, z, out, N, n_end, m, d, c_d, rescale, inv_rescale,
                                 log_rescale, st);
  return (int)dispatch<float>(mode, z, out, N, n_end, m, d, c_d, rescale, inv_rescale,
                              log_rescale, st);
}
