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
// geometry or direction has stride 0 along K), alpha and beta [K, B].  The
// plain version is ops/plane_rhs.py::plane_wave_rhs_plain.
//
// What bounds it on the H100: the bytes, [K, B, H] written and j, j' read
// (at the bench, 4 x 16 x 1,024 in complex64, 0.16 us at 3.35 TB/s); the
// launch's own latency is far above that, so the design keeps every step
// of a warm call short and spreads the rows over the card.
// - Y is kept across calls.  cy = conj(Y_h(d^)) i^{n_h} (-A_d) lives in a
//   device table the wrapper caches per (tree, n_end, dtype, device, stream),
//   [r_cap][H] in the walk's entry order (ops/harmonic_program.py::
//   ke_walk_numpy; entry t is harmonic ke_perm[t]), with a stamp beside
//   each (row range, unit) slice [r_cap][units][d + 1]: the bits of the
//   direction the slice was formed at and a 1 once formed.  A CTA whose
//   first k's direction equals its slice's stamp bit for bit reads its cy
//   and goes straight to the rows; any other CTA forms its slice, writes it
//   and its stamp.  Each slice belongs to one CTA of a launch (the CTA of
//   its unit and row range), so no two CTAs touch one; launches on one
//   stream run in order, and the wrapper keeps a table per stream.  Within a
//   launch a k whose direction differs, bit for bit, from the previous k's
//   forms its cy again in registers (per-k directions), not written back.
// - The grid is sized for the card (ops/plane_rhs.py::_grid): a CTA per
//   unit of kUnit consecutive walk entries x range of rows_per (k, b) rows
//   (k-major), enough CTAs to fill 132 SMs twice where the rows allow.
// - Y, where it must be formed, is formed by every thread, in double in
//   both instances (the tree's float64 program; cy rounded once to the
//   table's type, so that complex64's cy is as exact as its type allows,
//   also at a direction on a pole, x = +-1, where a float32 recurrence
//   loses ~1e-5 by degree 64): a thread owns
//   kPer consecutive walk entries, computes the direction's angles itself
//   in registers (quotients by a reciprocal and two Newton
//   steps, so no division's slow-path call spills registers; no lane waits
//   on another), rebuilds its
//   first entry's child state from the first values by their steps
//   (Walk::replay) and the root's recurrence from its seed, then carries:
//   the next entry is one root step on, or one walk step to the next child
//   state.  Every index is a compile-time level (a kernel instance per tree
//   shape of at most 4 nodes, as KE's), so nothing spills to a stack; a
//   larger tree takes the generic instance, whose angles one thread
//   computes into shared memory and whose entries each thread evaluates
//   from their seeds (harmonics.cuh).  The same entry is always formed by
//   the same operations (a unit's split does not depend on the call), so a
//   cold call, a warm one and one after a change of direction give the same
//   bits.  Where a unit has fewer entries than the CTA has threads, the
//   threads past its entries' owners form copies of them and take other
//   rows (only the first copy writes the table).
// - A row's phase, alpha and beta are the same for every entry: each
//   thread forms them for its rows, gathers j and j' at its entries'
//   degrees n_h and writes its entries (scattered in h: the walk's order).
// - The phase's argument is formed as the plain version forms it, products
//   and sums rounded one by one with no FMA (d^.c_b summed over the axes in
//   order, then k times it), so that the kernel's phase error is that of
//   one sincos at the same argument whatever |k d^.c_b|.
// - Each output has one writer and a fixed order of operations.  No
//   atomics.
#include "common.cuh"
#include "harmonic_walk.cuh"
#include "harmonics.cuh"

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;            // a CTA (= ops/plane_rhs.py _THREADS)
constexpr int kPer = 2;                  // walk entries a thread (_PER)
constexpr int kUnit = kThreads * kPer;   // walk entries a CTA (_UNIT)
constexpr int kGeneric = 0;              // the shape code of trees of more than 4 nodes

// sin and cos of the phase's argument a, in double, rounded once to T:
// a (exact in double) less n pi/2 in two fma steps (pi/2's double and the
// rest: the remainder's error stays ~1e-16 while |a| < 2^30, any phase a
// sphere of the port sees), then sincospi of the remainder over pi (|r| <=
// pi/4) and the quadrant's swap and signs.  sincos / sincosf would do the
// same below their Payne-Hanek path, whose local array gives a stack frame.
__device__ __forceinline__ void sincos_reduced(double a, double* s, double* c) {
  const double n = rint(a * 0.63661977236758134308);
  double r = fma(-n, 1.5707963267948966192e+00, a);
  r = fma(-n, 6.1232339957367660360e-17, r);
  double sr, cr;
  sincospi(r * 0.31830988618379067154, &sr, &cr);
  switch ((int)((long long)n & 3)) {
    case 0: *s = sr; *c = cr; break;
    case 1: *s = cr; *c = -sr; break;
    case 2: *s = -sr; *c = -cr; break;
    default: *s = -cr; *c = sr; break;
  }
}
__device__ __forceinline__ void t_sincos(float a, float* s, float* c) {
  double sd, cd;
  sincos_reduced((double)a, &sd, &cd);
  *s = (float)sd;
  *c = (float)cd;
}
__device__ __forceinline__ void t_sincos(double a, double* s, double* c) {
  sincos_reduced(a, s, c);
}
// a product and a sum rounded alone (nvcc would contract them into an FMA)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ uint32_t bits_of(float a) { return __float_as_uint(a); }
__device__ __forceinline__ unsigned long long bits_of(double a) {
  return (unsigned long long)__double_as_longlong(a);
}

// 1 / x (x > 0, normal) without the IEEE division's slow-path call (whose
// saved registers would spill to a stack): the hardware's approximate
// reciprocal, then two Newton steps, within an ulp of the quotient
__device__ __forceinline__ double recip(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  y = fma(y, e, y);
  e = fma(-x, y, 1.0);
  return fma(y, e, y);
}

// The angles of the direction v node by node (x, c, s of each node into the
// walk's state, rounded to T), as hprog::tree_angles / Walk::angles form
// them but in double and with recip() for the quotients
template <typename T, int S>
__device__ __forceinline__ void walk_angles(Walk<T, 1, S>& st, const int4 (&nds)[nn_of(S)],
                                            const double (&v)[nn_of(S) + 1]) {
  constexpr int NN = nn_of(S), D = NN + 1;
  double r[NN];
  static_for<NN>([&](auto I) {
    constexpr int i = decltype(I)::value;
    constexpr int nid = NN - 1 - i, kd = kind_of(S, nid);
    constexpr int ch1 = kd == hprog::kA ? 0 : c1_of(S, nid);
    constexpr int ch2 = kd == hprog::kC ? c2_of(S, nid) : 0;
    const int4 nd = nds[i];
    double r1, r2;
    if constexpr (kd == hprog::kA) {
      r1 = pick<double, D>(v, nd.z);
      r2 = pick<double, D>(v, nd.w);
    } else if constexpr (kd == hprog::kB) {
      r1 = r[ch1];
      r2 = pick<double, D>(v, nd.w);
    } else {
      r1 = r[ch1];
      r2 = r[ch2];
    }
    const double rr = hypot(r1, r2);
    r[nid] = rr;
    const double first = kd == hprog::kB ? r2 : r1, second = kd == hprog::kB ? r1 : r2;
    const double inv = rr > 0 ? recip(rr) : 0.0;
    const double cs = rr > 0 ? first * inv : 1.0;
    const double sn = rr > 0 ? second * inv : 0.0;
    st.c[0][nid] = (T)cs;
    st.s[0][nid] = (T)sn;
    st.x[0][nid] = (T)(kd == hprog::kC ? (cs - sn) * (cs + sn) : cs);
  });
}

// The generic instance's angles (trees of more than 4 nodes): the same
// operations node by node at run time, into shared memory (r: scratch)
template <typename T>
__device__ __forceinline__ void tree_angles_rcp(const hprog::Prog<T>& pg, const T* v, T* ax,
                                                T* ac, T* as, double* r) {
  for (int i = 0; i < pg.n_nodes; ++i) {
    const int4 nd = pg.nodes[i];
    const double r1 = nd.x == hprog::kA ? (double)v[nd.z] : r[nd.z];
    const double r2 = nd.x == hprog::kC ? r[nd.w] : (double)v[nd.w];
    const double rr = hypot(r1, r2);
    r[nd.y] = rr;
    const double first = nd.x == hprog::kB ? r2 : r1, second = nd.x == hprog::kB ? r1 : r2;
    const double inv = rr > 0 ? recip(rr) : 0.0;
    const double cs = rr > 0 ? first * inv : 1.0;
    const double sn = rr > 0 ? second * inv : 0.0;
    ac[nd.y] = (T)cs;
    as[nd.y] = (T)sn;
    ax[nd.y] = (T)(nd.x == hprog::kC ? (cs - sn) * (cs + sn) : cs);
  }
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
  const int2* hn;                  // [H]: each walk entry's harmonic h and root degree n_h
  const int* wcs;                  // [H]: the child state (walk order) of each walk entry
  const int* hjob;                 // [H, n_nodes]
  hprog::Prog<double> pg;          // the tree's program in float64 (cy is formed in double)
  const int4* walk;                // ke_walk_numpy's tables
  const int4* wfam;
  const double* wroot;
  const int4* wstep;
  c2_t<T>* cy;                     // [r_cap, H] walk order: the kept slices
  T* stamp;                        // [r_cap, units, d + 1]
  int K, B, H, ne, d, kc, has_uin, has_grad, rows_per, units;
  double neg_a;                    // -A_d
};

// conj(y) i^n (-A_d), formed in double and rounded once to T (conj and
// i^n exact: a swap and signs)
template <typename T>
__device__ __forceinline__ c2_t<T> cy_of(double2 y, int n, double neg_a) {
  double2 v;
  switch (n & 3) {
    case 0: v = make_double2(y.x, -y.y); break;
    case 1: v = make_double2(y.y, y.x); break;
    case 2: v = make_double2(-y.x, y.y); break;
    default: v = make_double2(-y.y, -y.x); break;
  }
  return cmake<T>((T)(v.x * neg_a), (T)(v.y * neg_a));
}

template <typename T>
__device__ __forceinline__ T dir_at(const KrArgs<T>& a, int i, int k) {
  return a.dir[i * a.sdd + k * a.sdk];
}

// Whether k's direction equals k - 1's, bit for bit
template <typename T>
__device__ __forceinline__ bool same_dir(const KrArgs<T>& a, int k) {
  bool same = true;
  for (int i = 0; i < a.d; ++i)
    same = same && bits_of(dir_at(a, i, k)) == bits_of(dir_at(a, i, k - 1));
  return same;
}

// The thread's cy at the direction of k: entries t0 .. t0 + kPer - 1 of the
// walk (those below H), by the carried walk of a tree of shape S (1 to 4
// nodes; see the file's header), in double
template <typename T, int S>
__device__ __forceinline__ void form_walk(const KrArgs<T>& a, int k, int t0,
                                          const int (&nh)[kPer], c2_t<T> (&cy)[kPer]) {
  using W = Walk<double, 1, S>;
  constexpr int NN = nn_of(S);
  W st;
  int4 nds[NN];
#pragma unroll
  for (int i = 0; i < NN; ++i) nds[i] = a.pg.nodes[i];
  double v[W::D];
#pragma unroll
  for (int i = 0; i < W::D; ++i) v[i] = dir_at(a, i, k);
  walk_angles<double, S>(st, nds, v);
  if constexpr (NN == 1) {  // a root 'a': entry t is the order m = t - (H - 1) / 2
    const int half = (a.H - 1) / 2;
    const double2 z = cmake<double>(st.c[0][0], st.s[0][0]);
    double2 f = hprog::a_factor<double>(t0 - half, st.c[0][0], st.s[0][0]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (t0 + i < a.H) {
        if (i > 0) f = cmul<double>(f, z);
        cy[i] = cy_of<T>(f, nh[i], a.neg_a);
      }
    }
  } else {
    int e = a.wcs[t0];
    int4 wk = a.walk[e];
    int4 wf = a.wfam[e];
    st.replay(a.pg, wf, a.wstep[e]);
    Root<double> wr = load_root(a.wroot, e);
    double pn[1], pm = 0;
    st.root_seed(wr.p0, wr.norm, pn);
    int j = t0 - wk.z;
    for (int i = 0; i < j; ++i)
      hprog::jacobi_step<double>(a.pg, wf.w + i, st.x[0][0], pn[0], pm);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (t0 + i >= a.H) continue;  // (then so is every later entry)
      if (i > 0) {
        if (j + 1 < wk.y) {  // the next root degree of this child state
          hprog::jacobi_step<double>(a.pg, wf.w + j, st.x[0][0], pn[0], pm);
          ++j;
        } else {  // the walk's next child state, one step on
          ++e;
          wk = a.walk[e];
          wf = a.wfam[e];
          st.advance(a.pg, wk.x, wf);
          wr = load_root(a.wroot, e);
          st.root_seed(wr.p0, wr.norm, pn);
          pm = 0;
          j = 0;
        }
      }
      cy[i] = cy_of<T>(cscale<double>(st.prod[0][W::NL - 1], pn[0]), nh[i], a.neg_a);
    }
  }
}

// The generic instance's cy at the direction of k (trees of more than 4
// nodes): the angles by thread 0 into shared memory, then each entry from
// its seeds, in double.  Called by every thread of the CTA together.
template <typename T>
__device__ __forceinline__ void form_generic(const KrArgs<T>& a, int k, int t0,
                                             const int (&hh)[kPer], const int (&nh)[kPer],
                                             c2_t<T> (&cy)[kPer], double* sv, double* sax,
                                             double* sac, double* sas, double* sr,
                                             const int* skind) {
  __syncthreads();  // every thread is done with the previous angles
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.d; ++i) sv[i] = dir_at(a, i, k);
    tree_angles_rcp<double>(a.pg, sv, sax, sac, sas, sr);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (t0 + i >= a.H) continue;
    const int* job_of = a.hjob + (size_t)hh[i] * a.pg.n_nodes;
    cy[i] = cy_of<T>(hprog::factor_product<double>(a.pg, skind, job_of, 0, sax, sac, sas), nh[i],
                     a.neg_a);
  }
}

// (no __launch_bounds__: with it ptxas held some instances to 64 registers
// and spilled; without, every instance fits its registers, 72-168)
template <typename T, int S>
__global__ void plane_rhs_kernel(const KrArgs<T> a) {
  using T2 = c2_t<T>;
  constexpr bool generic = S == kGeneric;
  __shared__ double sv[generic ? hprog::kMaxNodes + 1 : 1];
  __shared__ double sax[generic ? hprog::kMaxNodes : 1], sac[generic ? hprog::kMaxNodes : 1],
      sas[generic ? hprog::kMaxNodes : 1];
  __shared__ double sr[generic ? hprog::kMaxNodes : 1];
  __shared__ int skind[generic ? hprog::kMaxNodes : 1];

  const int tid = threadIdx.x, unit = blockIdx.x, range = blockIdx.y;
  const int rows = a.K * a.B;
  const int r0 = range * a.rows_per, r1 = min(rows, r0 + a.rows_per);
  // the unit's owners (threads with entries) and the copies of them that
  // take the other rows: owner o = tid % own, copy = tid / own (the generic
  // instance, whose forming takes the whole CTA at its barriers, keeps one
  // copy: every thread then walks the same rows)
  const int u0 = unit * kUnit;
  const int n_own = min(kThreads, (a.H - u0 + kPer - 1) / kPer);
  const int own = generic ? kThreads : (n_own + 31) & ~31, copies = kThreads / own;
  const int o = tid % own, copy = tid / own;
  const int t0 = u0 + o * kPer;
  const bool active = copy < copies && o < n_own;
  int hh[kPer], nh[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool live = active && t0 + i < a.H;
    const int2 v = live ? a.hn[t0 + i] : make_int2(0, 0);
    hh[i] = v.x;
    nh[i] = v.y;
  }
  if constexpr (generic) {
    if (tid == 0) hprog::node_kinds<double>(a.pg, skind);
  }

  // the slice's stamp against the first k's direction, read by every thread
  // (the same values: the decision is the CTA's); its rewrite waits, at the
  // end, for every thread's read
  const int k_first = r0 / a.B;
  T* stamp = a.stamp + ((size_t)range * a.units + unit) * (a.d + 1);
  bool kept = stamp[a.d] == (T)1;
  for (int i = 0; i < a.d; ++i)
    kept = kept && bits_of(stamp[i]) == bits_of(dir_at(a, i, k_first));
  T2 cy[kPer];
  T2* slice = a.cy + (size_t)range * a.H;
  if (kept) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      cy[i] = active && t0 + i < a.H ? slice[t0 + i] : cmake<T>(0, 0);
  } else {
    if constexpr (generic) {
      form_generic<T>(a, k_first, t0, hh, nh, cy, sv, sax, sac, sas, sr, skind);
    } else if (active) {
      form_walk<T, S>(a, k_first, t0, nh, cy);
    }
    if (active && copy == 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (t0 + i < a.H) slice[t0 + i] = cy[i];
    }
  }

  int k_prev = k_first;
  // (outside the generic instance, whose forming has barriers, a thread with
  // no entries takes no rows)
  const int row0 = generic || active ? r0 + (active ? copy : 0) : r1;
  for (int row = row0; row < r1; row += copies) {
    const int k = row / a.B, b = row - k * a.B;
    // a direction that differs, bit for bit, from the previous k's: Y again
    // (k moves the same way in every thread of the CTA: the rows of one
    // k-major range)
    for (; k_prev < k; ++k_prev) {
      if (!same_dir(a, k_prev + 1)) {
        if constexpr (generic) {
          form_generic<T>(a, k_prev + 1, t0, hh, nh, cy, sv, sax, sac, sas, sr, skind);
        } else if (active) {
          form_walk<T, S>(a, k_prev + 1, t0, nh, cy);
        }
      }
    }
    if (!active) continue;
    // e^{i k d^.c_b}: the plain version's argument, rounding for rounding
    T2 kw;
    if (a.kc) {
      kw = reinterpret_cast<const T2*>(a.kv)[k * a.skv];
    } else {
      kw = cmake<T>(a.kv[k * a.skv], 0);
    }
    const T* c = a.cen + k * a.sck + b * a.scb;
    T ip = mul_rn(dir_at(a, 0, k), c[0]);
    for (int i = 1; i < a.d; ++i) ip = add_rn(ip, mul_rn(dir_at(a, i, k), c[i * a.scd]));
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
    const T2 al = a.alpha[k * a.sak + b * a.sab];
    const T2 be = a.beta[k * a.sbk + b * a.sbb];
    const size_t r = (size_t)row * a.ne;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (t0 + i >= a.H) continue;
      T2 term = cmake<T>(0, 0);
      if (a.has_uin) term = cmul<T>(al, a.j[r + nh[i]]);
      if (a.has_grad) {
        const T2 jp = a.jp[r + nh[i]];
        const T2 jpk = a.kc ? cmul<T>(jp, kw) : cscale<T>(jp, kw.x);
        term = cadd<T>(term, cmul<T>(be, jpk));
      }
      a.out[(size_t)row * a.H + hh[i]] = cmul<T>(cmul<T>(phase, term), cy[i]);
    }
  }
  if (!kept) {  // the same in every thread
    __syncthreads();  // every thread has read the stamp
    if (tid == 0) {
      for (int i = 0; i < a.d; ++i) stamp[i] = dir_at(a, i, k_first);
      stamp[a.d] = (T)1;
    }
  }
}

template <typename T>
cudaError_t launch(const KrArgs<T>& a, int shape, dim3 grid, cudaStream_t stream) {
  switch (shape) {
    case 256: plane_rhs_kernel<T, 256><<<grid, kThreads, 0, stream>>>(a); break;
    case 513: plane_rhs_kernel<T, 513><<<grid, kThreads, 0, stream>>>(a); break;
    case 773: plane_rhs_kernel<T, 773><<<grid, kThreads, 0, stream>>>(a); break;
    case 770: plane_rhs_kernel<T, 770><<<grid, kThreads, 0, stream>>>(a); break;
    case 1045: plane_rhs_kernel<T, 1045><<<grid, kThreads, 0, stream>>>(a); break;
    case 1033: plane_rhs_kernel<T, 1033><<<grid, kThreads, 0, stream>>>(a); break;
    case 1030: plane_rhs_kernel<T, 1030><<<grid, kThreads, 0, stream>>>(a); break;
    case 1042: plane_rhs_kernel<T, 1042><<<grid, kThreads, 0, stream>>>(a); break;
    case kGeneric: plane_rhs_kernel<T, kGeneric><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* out, const void* j, const void* jp, const void* kv, long long skv,
                int kc, const void* dir, long long sdd, long long sdk, const void* cen,
                long long sck, long long scb, long long scd, const void* alpha, long long sak,
                long long sab, const void* beta, long long sbk, long long sbb,
                const void* hn, const void* wcs, const void* hjob,
                const void* nodes, const void* jobs, const void* fam, const void* coef,
                const void* famr, int n_nodes, int shape, const void* walk, const void* wfam,
                const void* wroot, const void* wstep, const void* cy, const void* stamp, int K,
                int B, int H, int ne, int d, int has_uin, int has_grad, int rows_per, int r_cap,
                double neg_a, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (K == 0 || B == 0 || H == 0) return cudaSuccess;
  const long long ranges = ((long long)K * B + rows_per - 1) / (rows_per > 0 ? rows_per : 1);
  if (n_nodes < 1 || n_nodes > hprog::kMaxNodes || d != n_nodes + 1 || rows_per < 1 ||
      ranges > r_cap || ranges > 65535 || (shape != kGeneric && (shape >> 8) != n_nodes))
    return cudaErrorInvalidValue;
  const int units = (H + kUnit - 1) / kUnit;
  const KrArgs<T> a{static_cast<T2*>(const_cast<void*>(out)), static_cast<const T2*>(j),
                    static_cast<const T2*>(jp), static_cast<const T*>(kv), skv,
                    static_cast<const T*>(dir), sdd, sdk, static_cast<const T*>(cen), sck, scb,
                    scd, static_cast<const T2*>(alpha), sak, sab, static_cast<const T2*>(beta),
                    sbk, sbb, static_cast<const int2*>(hn), static_cast<const int*>(wcs),
                    static_cast<const int*>(hjob),
                    hprog::Prog<double>{static_cast<const int4*>(nodes),
                                        static_cast<const int4*>(jobs),
                                        static_cast<const int*>(fam),
                                        static_cast<const double*>(coef),
                                        static_cast<const double*>(famr), n_nodes},
                    static_cast<const int4*>(walk), static_cast<const int4*>(wfam),
                    static_cast<const double*>(wroot), static_cast<const int4*>(wstep),
                    static_cast<T2*>(const_cast<void*>(cy)),
                    static_cast<T*>(const_cast<void*>(stamp)), K, B, H, ne, d, kc, has_uin,
                    has_grad, rows_per, units, neg_a};
  return launch<T>(a, shape, dim3(units, (unsigned)ranges), stream);
}

}  // namespace

// The launch's fixed arguments, packed once per layout of the call by the
// wrapper (ops/plane_rhs.py::_SLOTS, in this order): 64-bit slots,
// pointers and integers as integers, neg_a as its bits.  Strides in
// elements; k at stride skv, real or complex (kc: interleaved pairs, the
// stride in pairs); direction [d, K] and centers [K, B, d] by strides (in
// reals); alpha, beta [K, B] by strides (in complex values); hn [H, 2]
// (each walk entry's h and n_h), wcs [H] and hjob [H, n_nodes] (int32),
// the tree's program and KE's walk (ops/harmonic_program.py: nodes, jobs, fam, coef, famr, shape,
// walk, wfam, wroot, wstep); the kept table cy [r_cap, H] and its stamps
// [r_cap, units, d + 1] (units = ceil(H / 256)), zeroed when made;
// rows_per (k, b) rows a CTA; neg_a = -A_d; dbl: complex128.
enum Slot {
  kSkv, kKc, kSdd, kSdk, kSck, kScb, kScd, kSak, kSab, kSbk, kSbb, kHn, kWcs, kHjob,
  kNodes, kJobs, kFam, kCoef, kFamr, kNNodes, kShape, kWalk, kWfam, kWroot, kWstep, kCy, kStamp,
  kK, kB, kH, kNe, kD, kHasUin, kHasGrad, kRowsPer, kRCap, kNegA, kDbl, kSlots
};

// out [K, B, H]; j, jp [K, B, ne] (contiguous); k, direction, centers,
// alpha, beta as `pack` describes them (kSlots 64-bit slots).
extern "C" int bhs_plane_rhs(const void* pack, const void* out, const void* j, const void* jp,
                             const void* kv, const void* dir, const void* cen, const void* alpha,
                             const void* beta, void* stream) {
  const long long* p = static_cast<const long long*>(pack);
  const auto ptr = [p](int s) { return reinterpret_cast<const void*>(p[s]); };
  const auto i32 = [p](int s) { return (int)p[s]; };
  double neg_a;
  memcpy(&neg_a, p + kNegA, sizeof(double));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p[kDbl])
    return (int)run<double>(out, j, jp, kv, p[kSkv], i32(kKc), dir, p[kSdd], p[kSdk], cen,
                            p[kSck], p[kScb], p[kScd], alpha, p[kSak], p[kSab], beta, p[kSbk],
                            p[kSbb], ptr(kHn), ptr(kWcs), ptr(kHjob),
                            ptr(kNodes), ptr(kJobs), ptr(kFam), ptr(kCoef), ptr(kFamr),
                            i32(kNNodes), i32(kShape), ptr(kWalk), ptr(kWfam), ptr(kWroot),
                            ptr(kWstep), ptr(kCy), ptr(kStamp), i32(kK), i32(kB), i32(kH),
                            i32(kNe), i32(kD), i32(kHasUin), i32(kHasGrad), i32(kRowsPer),
                            i32(kRCap), neg_a, st);
  return (int)run<float>(out, j, jp, kv, p[kSkv], i32(kKc), dir, p[kSdd], p[kSdk], cen, p[kSck],
                         p[kScb], p[kScd], alpha, p[kSak], p[kSab], beta, p[kSbk], p[kSbb],
                         ptr(kHn), ptr(kWcs), ptr(kHjob), ptr(kNodes),
                         ptr(kJobs), ptr(kFam), ptr(kCoef), ptr(kFamr), i32(kNNodes),
                         i32(kShape), ptr(kWalk), ptr(kWfam), ptr(kWroot), ptr(kWstep),
                         ptr(kCy), ptr(kStamp), i32(kK), i32(kB), i32(kH), i32(kNe), i32(kD),
                         i32(kHasUin), i32(kHasGrad), i32(kRowsPer), i32(kRCap), neg_a, st);
}
