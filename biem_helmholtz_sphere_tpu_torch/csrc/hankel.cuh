// The outgoing radial factor h_l(k r) of odd dimension 3 in registers: the
// upward chain in mantissa/exponent form with the clamp of
// biem/_eval_fused.py::_h_clamped, shared by KA (fused_ba_eval.cu) and KE
// (harmonic_eval.cu).
#pragma once
#include "common.cuh"

namespace {

// mant * exp(e) clamped at exp(lim) in magnitude max(|re|, |im|), as the
// plain version's hm * exp(min(he, lim)) with hm = mant / max|.|.  The
// caller keeps s = exp(e), which changes only when the chain rescales, so
// no transcendental runs where nothing clamps; the exponent-past-the-clamp
// case keeps the original log/exp form.
template <typename T>
__device__ __forceinline__ c2_t<T> h_value(c2_t<T> mant, T e, T s, T lim, T elim) {
  const T ar = mant.x < 0 ? -mant.x : mant.x;
  const T ai = mant.y < 0 ? -mant.y : mant.y;
  const T a = ar > ai ? ar : ai;
  if (e <= lim) {
    if (a * s <= elim) return cscale<T>(mant, s);
    return cscale<T>(mant, elim / a);
  }
  const T ln = a > 0 ? t_log(a) : (T)0;
  const T ee = e + ln < lim ? e + ln : lim;
  return cscale<T>(cscale<T>(mant, t_exp(-ln)), t_exp(ee));
}

// 1 / a for complex a
template <typename T>
__device__ __forceinline__ c2_t<T> crecip(c2_t<T> a) {
  const T d = (T)1 / (a.x * a.x + a.y * a.y);
  return cmake<T>(a.x * d, -a.y * d);
}

// The upward h_l(z) chain, l = 0 .. n-1, handing each clamped value to
// put(l, h); z = k r, real (CK false: z.y unused) or complex.
template <typename T, int N, bool CK, typename Put>
__device__ __forceinline__ void h_chain(c2_t<T> zc, int n, T lim, T elim, T rescale,
                                        T log_rescale, Put put) {
  const int n_ = N > 0 ? N : n;
  c2_t<T> fm, fn, inv;
  if constexpr (CK) {
    // h_0 = -i e^{iz} / z, h_1 = -e^{iz} (z + i) / z^2, as the plain seeds
    const bool zero = zc.x == 0 && zc.y == 0;
    const c2_t<T> zs = zero ? cmake<T>(1, 0) : zc;
    const T ez = t_exp(-zc.y);
    const c2_t<T> eiz = cmake<T>(ez * t_cos(zc.x), ez * t_sin(zc.x));
    const c2_t<T> izs = crecip<T>(zs);
    inv = crecip<T>(zc);
    fm = cmul<T>(cmake<T>(eiz.y, -eiz.x), izs);
    fn = cmul<T>(cmul<T>(cmake<T>(-eiz.x, -eiz.y), cmake<T>(zs.x, zs.y + (T)1)),
                 cmul<T>(izs, izs));
  } else {
    const T z = zc.x;
    const T zs = z == 0 ? (T)1 : z;  // as the plain version's h seeds
    const T cz = t_cos(z), sz = t_sin(z);
    inv = cmake<T>((T)1 / z, 0);
    fm = cmake<T>(sz / zs, -cz / zs);
    fn = cmake<T>(-(cz * zs - sz) / (zs * zs), -(sz * zs + cz) / (zs * zs));
  }
  T e = 0, se = 1;  // se = exp(e)
  put(0, h_value<T>(fm, e, se, lim, elim));
  if (n_ > 1) put(1, h_value<T>(fn, e, se, lim, elim));
  constexpr int kU = N > 0 ? N : 1;
#pragma unroll(kU)
  for (int l = 1; l + 1 < n_; ++l) {
    c2_t<T> fp;
    if constexpr (CK) {
      const c2_t<T> t = cscale<T>(cmul<T>(fn, inv), (T)(2 * l + 1));
      fp = cmake<T>(t.x - fm.x, t.y - fm.y);
    } else {
      const T c = (T)(2 * l + 1) * inv.x;
      fp = cmake<T>(fn.x * c - fm.x, fn.y * c - fm.y);
    }
    if (t_hypot(fp.x, fp.y) > rescale) {
      fp = cscale<T>(fp, (T)1 / rescale);
      fn = cscale<T>(fn, (T)1 / rescale);
      e += log_rescale;
      se = t_exp(e);
    }
    fm = fn;
    fn = fp;
    put(l + 1, h_value<T>(fp, e, se, lim, elim));
  }
}

// k of batch entry kb: real, or (re, im) for a complex k
template <typename T, bool CK>
__device__ __forceinline__ c2_t<T> k_of(const T* kv, int kb) {
  if constexpr (CK) return cmake<T>(kv[2 * kb], kv[2 * kb + 1]);
  return cmake<T>(kv[kb], 0);
}

template <typename T, bool CK>
__device__ __forceinline__ c2_t<T> k_times(c2_t<T> kk, T r) {
  return CK ? cscale<T>(kk, r) : cmake<T>(kk.x * r, 0);
}

}  // namespace
