// K6: one Arnoldi step of the port's restarted GMRES, and a cycle's
// back-substitution, on the card.
//
// Replaces biem_helmholtz_sphere_tpu/ops/cplx.py:569-607 (`step_work`
// under `step`'s lax.cond, with pre_mv's Jacobi division, `:68-69`) and
// `back` (`:627-646`), which XLA fused into the one device program of a
// solve on the TPU.  The plain versions are ops/gmres_step.py::
// _arnoldi_step_plain and _backsolve_plain.
//
// The step on the state (V [K, m+1, n], R [K, m, m] as R[k, col, row],
// g [K, m+1], Q [K, m+1, m+1], resid [K], steps [K] int32, the flag word
// int32 [3]: any system active, any residual non-finite, steps run):
//   w <- w / diag; CGS2: h1 = V_{0..j}^H w, w -= h1 V, h2 = V^H w, w -= h2 V;
//   hn = |w|, V[j+1] = w / hn (0 where hn <= tiny); h = h1 + h2 rotated by
//   the accumulated Givens product Q; a new rotation (u, v) eliminates
//   (hr[j], hn); rows j and j+1 of Q, row j of R, g[j], g[j+1]; steps +=
//   (resid > target) before the step, resid = |g[j] v|; then the flag word.
// Every launch first reads the flag word and returns when no system is
// active or a residual is non-finite: a masked step leaves every state
// tensor unchanged, so the host may run ahead of its reads of the word.
//
// What bounds it on the H100: the bytes.  A step reads rows 0..j of V four
// times (a pass of dots, an update and a pass of dots, an update) and w,
// diag and the work vector a few times; at the bench block (K 4, n 16,384,
// c64) a step at j = 7 moves ~20 MB (~6 us at 3.35 TB/s).  Design, simple
// and right first:
// - Three passes of one kernel (k6_project) over a grid of slices of n x
//   K: each thread keeps E entries of w in registers and streams the rows
//   of V, 8 / E rows in flight; the update's sums run over the rows in
//   order, the dots go through a warp-shuffle tree and the CTA's warps in
//   order into one partial per (system, row, slice).
// - k6_reduce: a warp per (system, row) sums the slices' partials in a
//   fixed order.  Sums are two-level and no atomics are used: two launches
//   give the same bits (one flat float64 sum over ~10^4 terms lost
//   accuracy in K3's first version).
// - k6_normalize_rotate: the slices write V[j+1] (each sums the partial
//   norms in the same order), while a warp per row of Q forms hr[r] =
//   sum_{c <= min(r+1, j)} Q[r, c] h[c] (Q's rows past r + 1 are exact
//   zeros, and rows past j are identity rows: the product is O(j^2), not
//   O(m j)).
// - k6_givens: one CTA does each system's small work and then the flag
//   word; it alone writes the word, last, so every earlier launch of the
//   step read the same one.
// - k6_backsolve: a warp per system, columns j_f - 1 down to 0, the sums
//   over the later columns by lanes and a shuffle tree; columns >= j_f get
//   0, so the correction y V may run over all m columns.
// No size ceiling: any K, any n (masked edges), any m (the rows stream from
// device memory, nothing of size m lives in shared memory).  Later work: a
// single cooperative kernel with grid syncs, rows of V through TMA, the
// step captured in a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // = ops/gmres_step.py _THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ c2_t<T> czero() {
  return cmake<T>(T(0), T(0));
}

// acc + conj(a) * b
template <typename T>
__device__ __forceinline__ c2_t<T> cfma_conj(c2_t<T> a, c2_t<T> b, c2_t<T> acc) {
  acc.x = t_fma(a.x, b.x, t_fma(a.y, b.y, acc.x));
  acc.y = t_fma(a.x, b.y, t_fma(-a.y, b.x, acc.y));
  return acc;
}

// a / b as torch's complex division (numpy's: scaled by the larger part)
template <typename T>
__device__ __forceinline__ c2_t<T> cdiv(c2_t<T> a, c2_t<T> b) {
  const T ac = fabs(b.x), ad = fabs(b.y);
  if (ac >= ad) {
    if (ac == T(0) && ad == T(0)) return cmake<T>(a.x / ac, a.y / ad);
    const T rat = b.y / b.x, scl = T(1) / (b.x + b.y * rat);
    return cmake<T>((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const T rat = b.x / b.y, scl = T(1) / (b.y + b.x * rat);
  return cmake<T>((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;  // lane 0 holds the sum
}

template <typename T>
__device__ __forceinline__ T inv_or_zero(T a, T tiny) {
  return a > tiny ? T(1) / fmax(a, tiny) : T(0);
}

// no system active, or a residual non-finite: the step is masked
__device__ __forceinline__ bool masked(const int* flag) { return flag[0] == 0 || flag[1] != 0; }

// Loads rows i0 .. i0 + RB - 1 of V (clamped to the last row `rows` - 1:
// the loads stay unconditional) at this thread's E entries.
template <typename T, int E, int RB>
__device__ __forceinline__ void load_rows(const c2_t<T>* __restrict__ Vk, int i0, int rows,
                                          int t0, int n, c2_t<T> (&v)[RB][E]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const size_t row = (size_t)min(i0 + r, rows - 1) * n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = t0 + e * kThreads;
      v[r][e] = t < n ? Vk[row + t] : czero<T>();
    }
  }
}

// mode 0: x = w / diag, dots; 1: x = wk - h V, dots; 2: x = wk - h V, |x|^2.
// x is written to wk; the dots conj(V_i) . x of rows i <= j to
// part[k, i, blk], the squared norm to pn[k, blk].
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
k6_project(const c2_t<T>* __restrict__ V, const c2_t<T>* __restrict__ w,
           const c2_t<T>* __restrict__ diag, const c2_t<T>* __restrict__ h,
           c2_t<T>* __restrict__ wk, c2_t<T>* __restrict__ part, T* __restrict__ pn,
           const int* __restrict__ flag, int n, int m, int j, int nblk, int mode) {
  if (masked(flag)) return;
  constexpr int RB = 8 / E;  // rows in flight: 8 entries of V a thread
  __shared__ c2_t<T> red[kWarps][RB];
  const int k = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)k * n;
  const c2_t<T>* Vk = V + (size_t)k * (m + 1) * n;
  const int rows = j + 1;
  const int t0 = blk * kThreads * E + tid;
  c2_t<T> x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = t0 + e * kThreads;
    x[e] = czero<T>();
    if (t < n) x[e] = mode == 0 ? cdiv<T>(w[base + t], diag[base + t]) : wk[base + t];
  }
  if (mode > 0) {  // x -= sum_i h_i V_i, the rows in order
    const c2_t<T>* hk = h + (size_t)k * (m + 1);
    c2_t<T> s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] = czero<T>();
    for (int i0 = 0; i0 < rows; i0 += RB) {
      c2_t<T> v[RB][E];
      load_rows<T, E, RB>(Vk, i0, rows, t0, n, v);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (i0 + r < rows) {
          const c2_t<T> hi = hk[i0 + r];
#pragma unroll
          for (int e = 0; e < E; ++e) s[e] = cfma<T>(hi, v[r][e], s[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = cmake<T>(x[e].x - s[e].x, x[e].y - s[e].y);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = t0 + e * kThreads;
    if (t < n) wk[base + t] = x[e];
  }
  if (mode == 2) {
    __shared__ T rq[kWarps];
    T q = T(0);
#pragma unroll
    for (int e = 0; e < E; ++e) q += x[e].x * x[e].x + x[e].y * x[e].y;
    q = warp_sum(q);
    if (lane == 0) rq[warp] = q;
    __syncthreads();
    if (tid == 0) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < kWarps; ++i) acc += rq[i];
      pn[(size_t)k * nblk + blk] = acc;
    }
    return;
  }
  c2_t<T>* pk = part + (size_t)k * (m + 1) * nblk + blk;
  for (int i0 = 0; i0 < rows; i0 += RB) {
    c2_t<T> v[RB][E];
    load_rows<T, E, RB>(Vk, i0, rows, t0, n, v);
    c2_t<T> acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      acc[r] = czero<T>();
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r] = cfma_conj<T>(v[r][e], x[e], acc[r]);
      acc[r].x = warp_sum(acc[r].x);
      acc[r].y = warp_sum(acc[r].y);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) red[warp][r] = acc[r];
    }
    __syncthreads();
    if (tid < RB && i0 + tid < rows) {
      c2_t<T> a = czero<T>();
#pragma unroll
      for (int i = 0; i < kWarps; ++i) a = cadd<T>(a, red[i][tid]);
      pk[(size_t)(i0 + tid) * nblk] = a;
    }
    __syncthreads();
  }
}

// h[k, i] = sum over the slices of part[k, i, :], a warp per (k, i)
template <typename T>
__global__ void __launch_bounds__(kThreads)
k6_reduce(const c2_t<T>* __restrict__ part, c2_t<T>* __restrict__ h,
          const int* __restrict__ flag, int m, int j, int nblk) {
  if (masked(flag)) return;
  const int k = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i > j) return;  // whole warps
  const c2_t<T>* p = part + ((size_t)k * (m + 1) + i) * nblk;
  c2_t<T> a = czero<T>();
  for (int b = lane; b < nblk; b += 32) a = cadd<T>(a, p[b]);
  a.x = warp_sum(a.x);
  a.y = warp_sum(a.y);
  if (lane == 0) h[(size_t)k * (m + 1) + i] = a;
}

// CTAs < nblk: V[k, j+1] = wk / hn by slices (hn[k] kept by slice 0);
// the others: hr[k, r] = sum_c Q[k, r, c] (h1 + h2)[k, c], a warp per row
// r <= j
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
k6_normalize_rotate(c2_t<T>* __restrict__ V, const c2_t<T>* __restrict__ wk,
                    const T* __restrict__ pn, T* __restrict__ hn_out,
                    const c2_t<T>* __restrict__ Q, const c2_t<T>* __restrict__ h1,
                    const c2_t<T>* __restrict__ h2, c2_t<T>* __restrict__ hr,
                    const int* __restrict__ flag, int n, int m, int j, int nblk, T tiny) {
  if (masked(flag)) return;
  const int k = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x < nblk) {
    // every warp sums the partial norms in the same order: one hn
    const T* p = pn + (size_t)k * nblk;
    T q = T(0);
    for (int b = lane; b < nblk; b += 32) q += p[b];
    q = __shfl_sync(kFull, warp_sum(q), 0);
    const T hn = sqrt(q);
    const T inv = inv_or_zero(hn, tiny);
    if (blockIdx.x == 0 && tid == 0) hn_out[k] = hn;
    c2_t<T>* dst = V + ((size_t)k * (m + 1) + j + 1) * n;
    const c2_t<T>* src = wk + (size_t)k * n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = blockIdx.x * kThreads * E + e * kThreads + tid;
      if (t < n) dst[t] = cscale<T>(src[t], inv);
    }
    return;
  }
  const int r = ((int)blockIdx.x - nblk) * kWarps + warp;
  if (r > j) return;  // whole warps
  const c2_t<T>* qr = Q + ((size_t)k * (m + 1) + r) * (m + 1);
  const c2_t<T>* a1 = h1 + (size_t)k * (m + 1);
  const c2_t<T>* a2 = h2 + (size_t)k * (m + 1);
  const int c_end = min(r + 1, j);
  c2_t<T> a = czero<T>();
  for (int c = lane; c <= c_end; c += 32) a = cfma<T>(qr[c], cadd<T>(a1[c], a2[c]), a);
  a.x = warp_sum(a.x);
  a.y = warp_sum(a.y);
  if (lane == 0) hr[(size_t)k * (m + 1) + r] = a;
}

// One CTA: each system's rotation, Q's rows j and j+1, R's row j, g, resid
// and steps; then the flag word
template <typename T>
__global__ void __launch_bounds__(kThreads)
k6_givens(c2_t<T>* __restrict__ R, c2_t<T>* __restrict__ g, c2_t<T>* __restrict__ Q,
          T* __restrict__ resid, int* __restrict__ steps, int* __restrict__ flag,
          const c2_t<T>* __restrict__ hr, const T* __restrict__ hn_in,
          const T* __restrict__ target, int K, int m, int j, T tiny) {
  if (masked(flag)) return;  // uniform: the word is written below, after barriers
  __shared__ c2_t<T> su;
  __shared__ T sv, srr;
  const int tid = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    c2_t<T>* gk = g + (size_t)k * (m + 1);
    const c2_t<T>* hk = hr + (size_t)k * (m + 1);
    if (tid == 0) {
      const c2_t<T> a = hk[j];
      const T hn = hn_in[k];
      const T aa = t_hypot(a.x, a.y);
      const T rr = sqrt(aa * aa + hn * hn);
      const T inv_r = inv_or_zero(rr, tiny);
      const c2_t<T> u = rr > tiny ? cmake<T>(a.x * inv_r, -a.y * inv_r) : cmake<T>(T(1), T(0));
      const T v = hn * inv_r;
      if (resid[k] > target[k]) steps[k] += 1;
      const c2_t<T> gj = gk[j];
      gk[j] = cmul<T>(u, gj);
      gk[j + 1] = cmake<T>(-gj.x * v, -gj.y * v);
      resid[k] = t_hypot(gj.x * v, gj.y * v);
      su = u;
      sv = v;
      srr = rr;
    }
    __syncthreads();
    const c2_t<T> u = su;
    const T v = sv;
    // rows j and j+1 of Q; their columns past j + 1 are exact zeros
    c2_t<T>* qj = Q + ((size_t)k * (m + 1) + j) * (m + 1);
    c2_t<T>* qj1 = qj + (m + 1);
    for (int c = tid; c <= j + 1; c += kThreads) {
      const c2_t<T> a = qj[c], b = qj1[c];
      qj[c] = cadd<T>(cmul<T>(u, a), cscale<T>(b, v));
      qj1[c] = cmake<T>(b.x * u.x + b.y * u.y - a.x * v, b.y * u.x - b.x * u.y - a.y * v);
    }
    // row j of R: hr[:j], then rr (its entries past j are 0, as allocated)
    c2_t<T>* rj = R + ((size_t)k * m + j) * m;
    for (int r = tid; r <= j; r += kThreads) rj[r] = r == j ? cmake<T>(srr, T(0)) : hk[r];
    __syncthreads();
  }
  if (tid == 0) {
    int active = 0, bad = 0;
    for (int k = 0; k < K; ++k) {
      const T r = resid[k];
      active |= r > target[k];
      bad |= !isfinite(r);
    }
    flag[0] = active;
    flag[1] = bad;
    flag[2] += 1;
  }
}

// y[k, col] for col < j_f (flag[2]) by back-substitution on R's upper
// triangle, 0 for col >= j_f; a warp per system
template <typename T>
__global__ void __launch_bounds__(32)
k6_backsolve(const c2_t<T>* __restrict__ R, const c2_t<T>* __restrict__ g,
             const int* __restrict__ flag, c2_t<T>* __restrict__ y, int m, T tiny) {
  const int k = blockIdx.x, lane = threadIdx.x;
  const int jf = min(flag[2], m);
  const c2_t<T>* Rk = R + (size_t)k * m * m;
  const c2_t<T>* gk = g + (size_t)k * (m + 1);
  c2_t<T>* yk = y + (size_t)k * m;
  for (int c = jf + lane; c < m; c += 32) yk[c] = czero<T>();
  for (int col = jf - 1; col >= 0; --col) {
    c2_t<T> s = czero<T>();
    for (int c = col + 1 + lane; c < jf; c += 32) s = cfma<T>(Rk[(size_t)c * m + col], yk[c], s);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
    if (lane == 0) {
      const c2_t<T> rll = Rk[(size_t)col * m + col];
      const T sc = inv_or_zero(t_hypot(rll.x, rll.y), tiny);
      const T s2 = sc * sc;
      const c2_t<T> num = cmake<T>(gk[col].x - s.x, gk[col].y - s.y);
      yk[col] = cmul<T>(num, cmake<T>(rll.x * s2, -rll.y * s2));
    }
    __syncwarp();
  }
}

inline int cdiv_int(int a, int b) { return (a + b - 1) / b; }

template <typename T, int E>
cudaError_t step_run(void* V, void* R, void* g, void* Q, void* resid, void* steps, void* flag,
                     const void* w, const void* diag, const void* target, void* cwork,
                     void* rwork, int K, int n, int m, int j, int nblk, double tiny,
                     cudaStream_t stream) {
  using C = c2_t<T>;
  C* v = static_cast<C*>(V);
  C* wk = static_cast<C*>(cwork);
  C* part = wk + (size_t)K * n;
  C* h1 = part + (size_t)K * (m + 1) * nblk;
  C* h2 = h1 + (size_t)K * (m + 1);
  C* hr = h2 + (size_t)K * (m + 1);
  T* pn = static_cast<T*>(rwork);
  T* hn = pn + (size_t)K * nblk;
  int* fl = static_cast<int*>(flag);
  const dim3 slices(nblk, K);
  const dim3 rows(cdiv_int(j + 1, kWarps), K);
  k6_project<T, E><<<slices, kThreads, 0, stream>>>(
      v, static_cast<const C*>(w), static_cast<const C*>(diag), h1, wk, part, pn, fl, n, m, j,
      nblk, 0);
  k6_reduce<T><<<rows, kThreads, 0, stream>>>(part, h1, fl, m, j, nblk);
  k6_project<T, E><<<slices, kThreads, 0, stream>>>(v, nullptr, nullptr, h1, wk, part, pn, fl,
                                                    n, m, j, nblk, 1);
  k6_reduce<T><<<rows, kThreads, 0, stream>>>(part, h2, fl, m, j, nblk);
  k6_project<T, E><<<slices, kThreads, 0, stream>>>(v, nullptr, nullptr, h2, wk, part, pn, fl,
                                                    n, m, j, nblk, 2);
  k6_normalize_rotate<T, E><<<dim3(nblk + rows.x, K), kThreads, 0, stream>>>(
      v, wk, pn, hn, static_cast<const C*>(Q), h1, h2, hr, fl, n, m, j, nblk, (T)tiny);
  k6_givens<T><<<1, kThreads, 0, stream>>>(
      static_cast<C*>(R), static_cast<C*>(g), static_cast<C*>(Q), static_cast<T*>(resid),
      static_cast<int*>(steps), fl, hr, hn, static_cast<const T*>(target), K, m, j, (T)tiny);
  return cudaGetLastError();  // a refused launch among the seven is reported here
}

template <typename T>
cudaError_t step_dispatch(void* V, void* R, void* g, void* Q, void* resid, void* steps,
                          void* flag, const void* w, const void* diag, const void* target,
                          void* cwork, void* rwork, int K, int n, int m, int j, int nblk,
                          int ept, double tiny, cudaStream_t stream) {
  switch (ept) {
    case 1:
      return step_run<T, 1>(V, R, g, Q, resid, steps, flag, w, diag, target, cwork, rwork, K,
                            n, m, j, nblk, tiny, stream);
    case 2:
      return step_run<T, 2>(V, R, g, Q, resid, steps, flag, w, diag, target, cwork, rwork, K,
                            n, m, j, nblk, tiny, stream);
    case 4:
      return step_run<T, 4>(V, R, g, Q, resid, steps, flag, w, diag, target, cwork, rwork, K,
                            n, m, j, nblk, tiny, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One Arnoldi step j of every system.  V [K, m+1, n], R [K, m, m], g
// [K, m+1], Q [K, m+1, m+1] complex; resid [K] real; steps [K] int32; flag
// int32 [3]; w, diag [K, n] complex (w = the matvec of V[:, j]); target
// [K] real; cwork complex [K n + K (m+1) nblk + 3 K (m+1)]; rwork real
// [K nblk + K]; nblk = ceil(n / (256 ept)) slices of n, ept entries a
// thread (1, 2 or 4).
extern "C" int bhs_arnoldi_step(void* V, void* R, void* g, void* Q, void* resid, void* steps,
                                void* flag, const void* w, const void* diag, const void* target,
                                void* cwork, void* rwork, int K, int n, int m, int j, int nblk,
                                int ept, double tiny, int dbl, void* stream) {
  if (K < 1 || n < 1 || m < 1 || j < 0 || j >= m || K > 65535 ||
      nblk != cdiv_int(n, kThreads * ept))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dbl ? step_dispatch<double>(V, R, g, Q, resid, steps, flag, w, diag, target,
                                           cwork, rwork, K, n, m, j, nblk, ept, tiny, s)
                   : step_dispatch<float>(V, R, g, Q, resid, steps, flag, w, diag, target,
                                          cwork, rwork, K, n, m, j, nblk, ept, tiny, s));
}

// y [K, m] complex from R [K, m, m], g [K, m+1] and j_f = flag[2]
extern "C" int bhs_gmres_backsolve(const void* R, const void* g, const void* flag, void* y,
                                   int K, int m, double tiny, int dbl, void* stream) {
  if (K < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl)
    k6_backsolve<double><<<K, 32, 0, s>>>(
        static_cast<const double2*>(R), static_cast<const double2*>(g),
        static_cast<const int*>(flag), static_cast<double2*>(y), m, tiny);
  else
    k6_backsolve<float><<<K, 32, 0, s>>>(
        static_cast<const float2*>(R), static_cast<const float2*>(g),
        static_cast<const int*>(flag), static_cast<float2*>(y), m, (float)tiny);
  return (int)cudaGetLastError();
}
