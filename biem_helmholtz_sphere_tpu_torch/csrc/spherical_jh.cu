// K5: the radial special-function family of dimension d.
//
// Replaces biem_helmholtz_sphere_tpu/special/_family.py spherical_jh_scaled
// (:215), spherical_h_scaled (:288) and spherical_jh_all (:332) with their
// helpers _seeds (:47), _miller_down (:92), _upward_scaled (:148) and
// _scaled_deriv (:187), and, for even d, the cylinder seeds of
// special/_cyl.py::cyl_jh01 (:125).  Their plain versions in the port's
// special/_family.py and special/_cyl.py are this kernel's oracle; it
// follows them step for step.
//
// For each complex z and order n < n_end, with base 3 (odd d) or 2 (even
// d) and shift m = (d - base)/2 (f^{(d)}_n = z^{-m} f^{(base)}_{n+m},
// n_top = n_end + m):
//   h_n by upward recurrence f_{n+1} = ((2n + base - 2)/z) f_n - f_{n-1}
//   from the seeds: closed trigonometric forms for base 3, sqrt(pi/2)
//   (J0, J1, H0, H1) for base 2 (`seeds2`: the ascending series for
//   |z| <= 14, the Hankel asymptotics above, with the plain version's
//   coefficients, handed in as a table, in its Horner order, and in
//   double for either dtype: in float32 the series would lose ~5 digits
//   to cancellation near the seam);
//   j_n upward where n <= |z|, elsewhere by Miller's downward recurrence
//   from n_top + 36, normalised by the Wronskian j_1 h_0 - j_0 h_1 =
//   i/z^{base-1};
//   f'_n = f_{n-1} - ((n + base - 2)/z) f_n, shifted for m > 0.
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
__device__ void seeds3(c2_t<T> z, c2_t<T>* j0, c2_t<T>* j1, c2_t<T>* h0, c2_t<T>* h1) {
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

// The coefficient table of the cylinder seeds (special/_cyl.py, float64,
// each block in its Horner order): J0 and J1's series, Y0's, Y1's, then
// the Hankel expansions' complex terms for (nu, sign) = (0, +), (1, +),
// (0, -), (1, -).
constexpr int kSeries = 42;            // _N_SERIES
constexpr int kAsym = 23;              // _N_ASYM - 1 terms
constexpr int kCylJ0 = 0, kCylJ1 = kSeries, kCylY0 = 2 * kSeries;
constexpr int kCylY1 = kCylY0 + kSeries - 1, kCylAsym = kCylY1 + kSeries;
constexpr int kCylTable = kCylAsym + 4 * 2 * kAsym;
constexpr double kPi = 3.14159265358979323846;

template <typename T>
__device__ __forceinline__ c2_t<T> cadd_real(c2_t<T> a, T s) {
  return cmake<T>(a.x + s, a.y);
}

template <typename T>
__device__ __forceinline__ c2_t<T> clog_(c2_t<T> a) {
  return cmake<T>(t_log(cabs<T>(a)), t_atan2(a.y, a.x));
}

// the principal square root
template <typename T>
__device__ __forceinline__ c2_t<T> csqrt_(c2_t<T> a) {
  const T r = cabs<T>(a);
  const T re = sqrt(t_fmax((r + a.x) * T(0.5), T(0)));
  const T im = sqrt(t_fmax((r - a.x) * T(0.5), T(0)));
  return cmake<T>(re, a.y < T(0) ? -im : im);
}

// H^{(1)}_nu (sign +1) or H^{(2)}_nu (sign -1) by the Hankel asymptotics,
// DLMF 10.17.5-6: _cyl.py's _asym_h with the terms tab (kAsym complex)
template <typename T>
__device__ c2_t<T> asym_h(const double* tab, T nu, int sign, c2_t<T> z) {
  const c2_t<T> inv = crecip<T>(z);
  c2_t<T> s = cmake<T>(0, 0);
  for (int i = 0; i < kAsym; ++i)
    s = cmul<T>(cadd<T>(s, cmake<T>((T)tab[2 * i], (T)tab[2 * i + 1])), inv);
  s = cadd_real<T>(s, T(1));
  const c2_t<T> omega = cadd_real<T>(z, -(T(0.5) * nu + T(0.25)) * T(kPi));
  const c2_t<T> pref = csqrt_<T>(cscale<T>(inv, T(2.0 / kPi)));
  const c2_t<T> e = cexp_<T>(sign > 0 ? cmake<T>(-omega.y, omega.x) : cmake<T>(omega.y, -omega.x));
  return cmul<T>(cmul<T>(pref, e), s);
}

// (j0, j1, h0, h1) of the base-2 family: sqrt(pi/2) (J0, J1, H0, H1) as
// _cyl.py's cyl_jh01 computes them, the series at |z| <= 14
template <typename T>
__device__ void seeds2(c2_t<T> z, const double* tab, c2_t<T>* j0, c2_t<T>* j1, c2_t<T>* h0,
                       c2_t<T>* h1) {
  using T2 = c2_t<T>;
  T2 J0, J1, H0, H1;
  if (cabs<T>(z) > T(14)) {
    const double* as = tab + kCylAsym;
    H0 = asym_h<T>(as, T(0), 1, z);
    H1 = asym_h<T>(as + 2 * kAsym, T(1), 1, z);
    J0 = cscale<T>(cadd<T>(H0, asym_h<T>(as + 4 * kAsym, T(0), -1, z)), T(0.5));
    J1 = cscale<T>(cadd<T>(H1, asym_h<T>(as + 6 * kAsym, T(1), -1, z)), T(0.5));
  } else {
    const T2 zh = cscale<T>(z, T(0.5));
    const T2 q = cmul<T>(zh, zh);
    J0 = cmake<T>(0, 0);
    J1 = J0;
    for (int i = 0; i < kSeries; ++i) {
      J0 = cadd_real<T>(cmul<T>(J0, q), (T)tab[kCylJ0 + i]);
      J1 = cadd_real<T>(cmul<T>(J1, q), (T)tab[kCylJ1 + i]);
    }
    J1 = cmul<T>(J1, zh);
    constexpr T kGamma = T(0.5772156649015328606);
    const T2 lg = cadd_real<T>(clog_<T>(zh), kGamma);
    T2 s0 = cmake<T>(0, 0);
    for (int i = 0; i < kSeries - 1; ++i) s0 = cmul<T>(cadd_real<T>(s0, (T)tab[kCylY0 + i]), q);
    const T2 y0 = cscale<T>(cadd<T>(cmul<T>(lg, J0), s0), T(2.0 / kPi));
    T2 s1 = cmake<T>(0, 0);
    for (int i = 0; i < kSeries; ++i) s1 = cadd_real<T>(cmul<T>(s1, q), (T)tab[kCylY1 + i]);
    const T2 y1 = csub<T>(
        csub<T>(cscale<T>(cmul<T>(cadd_real<T>(lg, -kGamma), J1), T(2.0 / kPi)),
                cscale<T>(crecip<T>(z), T(2.0 / kPi))),
        cscale<T>(cmul<T>(s1, zh), T(1.0 / kPi)));
    H0 = cmake<T>(J0.x - y0.y, J0.y + y0.x);  // J + i Y
    H1 = cmake<T>(J1.x - y1.y, J1.y + y1.x);
  }
  const T r = T(1.2533141373155002512);  // sqrt(pi/2)
  *j0 = cscale<T>(J0, r);
  *j1 = cscale<T>(J1, r);
  *h0 = cscale<T>(H0, r);
  *h1 = cscale<T>(H1, r);
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

// scaled derivative at order n >= 1 from orders n-1 (pm, pe) and n (cm, ce),
// f'_n = f_{n-1} - ((n + base - 2)/z) f_n:
// the port's _scaled_deriv, then the z^{-m} phase
template <typename T>
__device__ __forceinline__ void deriv_scaled(c2_t<T> pm, T pe, c2_t<T> cm, T ce, int n, int m,
                                             int base, c2_t<T> inv, c2_t<T> zm, T zm_log,
                                             c2_t<T>* out, T* out_e) {
  T ep = pe > ce ? pe : ce;
  const c2_t<T> t1 = cscale<T>(pm, t_exp(pe - ep));
  const c2_t<T> cs = cscale<T>(cm, t_exp(ce - ep));
  c2_t<T> fp = csub<T>(t1, cmul<T>(cs, cscale<T>(inv, T(n + base - 2))));
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
                    int n_end, int base, int m, int d, const double* __restrict__ cyl,
                    double c_d, double rescale_d, double inv_rescale_d, double log_rescale_d) {
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
  if (base == 2) {  // in double for either T, as the plain version (_cyl.py)
    double2 s[4];
    seeds2<double>(make_double2((double)z.x, (double)z.y), cyl, s, s + 1, s + 2, s + 3);
    j0 = cmake<T>((T)s[0].x, (T)s[0].y);
    j1 = cmake<T>((T)s[1].x, (T)s[1].y);
    h0 = cmake<T>((T)s[2].x, (T)s[2].y);
    h1 = cmake<T>((T)s[3].x, (T)s[3].y);
  } else {
    seeds3<T>(z, &j0, &j1, &h0, &h1);
  }

  // phase 1: lane kMiller f_{n-1} = ((2n+base-2)/z) f_n - f_{n+1}, n =
  // n_top+36..1, storing orders <= n_top (always log-scaled); lanes kH and
  // kJ f_n = ((2n+base-4)/z) f_{n-1} - f_{n-2}, n = 2..n_last (j while n <= |z|)
  const int n_start = n_top + kMillerBuffer;
  int steps = 0, coef = base, at = n_top + 1, dir = 0;  // at > n_top: stores nothing
  T2 fm = cmake<T>(0, 0), fn = cmake<T>(1, 0);
  if (lane == kMiller && kMode != kHOnly) {
    steps = n_start;
    coef = 2 * n_start + base - 2;
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
  // s = (i / z^{base-1}) / (a_1 e^{sig_1 - sig_0} h_0 - a_0 h_1)
  const T2* Am = tab_m + kMiller * n_tab;
  const T* Ae = tab_e + kMiller * n_tab;
  const T2* Jm = tab_m + kJ * n_tab;
  const T* Je = tab_e + kJ * n_tab;
  const T S0 = Ae[0];
  const T2 w_target = [&] {
    const T2 r = crecip<T>(base == 2 ? z : cmul<T>(z, z));
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
        deriv_scaled<T>(jv_p, je_p, jv, jev, n, m, base, inv, zm, zm_log, &dv, &de);
        put_scaled<T>(jpo, jpe, o, dv, de);
        deriv_scaled<T>(hv_p, he_p, hv, hev, n, m, base, inv, zm, zm_log, &dv, &de);
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
        jd = csub<T>(jv_p, cmul<T>(jv, cscale<T>(inv, T(n + base - 2))));
        hd = csub<T>(hv_p, cmul<T>(hv, cscale<T>(inv, T(n + base - 2))));
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
cudaError_t run(const void* z, void* out, int N, int n_end, int base, int m, int d,
                const double* cyl, double c_d, double rescale, double inv_rescale,
                double log_rescale, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const size_t smem =
      (size_t)kWarps * kChains * (n_end + m + 1) * (sizeof(c2_t<T>) + sizeof(T));
  const cudaError_t err = allow_smem(spherical_jh_kernel<T, kMode>, smem);
  if (err != cudaSuccess) return err;
  using T2 = c2_t<T>;
  spherical_jh_kernel<T, kMode><<<(N + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      static_cast<const T2*>(z), static_cast<T2*>(out), N, n_end, base, m, d, cyl, c_d,
      rescale, inv_rescale, log_rescale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const void* z, void* out, int N, int n_end, int base, int m,
                     int d, const double* cyl, double c_d, double rescale, double inv_rescale,
                     double log_rescale, cudaStream_t stream) {
  switch (mode) {
    case kScaled:
      return run<T, kScaled>(z, out, N, n_end, base, m, d, cyl, c_d, rescale, inv_rescale,
                             log_rescale, stream);
    case kHOnly:
      return run<T, kHOnly>(z, out, N, n_end, base, m, d, cyl, c_d, rescale, inv_rescale,
                            log_rescale, stream);
    case kUnscaled:
      return run<T, kUnscaled>(z, out, N, n_end, base, m, d, cyl, c_d, rescale, inv_rescale,
                               log_rescale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out: one buffer of planes [N, n_end], the complex planes first, then the
// exponent planes: mode 0 j j' h h' | je j'e he h'e; mode 1 h | he; mode 2
// j j' h h'.  base 2 or 3, d = base + 2 m; cyl: the kCylTable float64
// coefficients of the cylinder seeds (read for base 2 only).  The rescale
// constants come from the caller, so both versions use the same rounding
// of 1/rescale and log(rescale).
extern "C" int bhs_spherical_jh(const void* z, void* out, int N, int n_end, int base, int m,
                                int mode, int d, const void* cyl, int cyl_len, double c_d,
                                double rescale, double inv_rescale, double log_rescale,
                                int dbl, void* stream) {
  if (n_end < 1 || m < 0 || N < 0 || (base != 2 && base != 3) || d != base + 2 * m)
    return (int)cudaErrorInvalidValue;
  if (base == 2 && cyl_len != kCylTable) return (int)cudaErrorInvalidValue;
  const double* cy = static_cast<const double*>(cyl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)dispatch<double>(mode, z, out, N, n_end, base, m, d, cy, c_d, rescale,
                                 inv_rescale, log_rescale, st);
  return (int)dispatch<float>(mode, z, out, N, n_end, base, m, d, cy, c_d, rescale,
                              inv_rescale, log_rescale, st);
}
