// KE: the general field evaluation, the near field of every tree but the
// 3D "ba" one (KA's), from a tree's program.
//
// Replaces the near field of biem_helmholtz_sphere_tpu/biem/_eval.py:146-148
// (the harmonics at x - c_b, the clamped radial factor and the density,
// summed over the harmonics), whose plain version is
// ops/harmonic_eval.py::_harmonic_eval_plain.  Per (point, k, ball):
//
//   u_b = sum_cs Y_child(cs) sum_{j < J_cs} f_root(cs, j) rad_{l0 + step j}
//         w[k, b, woff_cs + j]
//
// over the child states cs of ops/harmonic_program.py in KE's walk order
// (the density in that order, `ke_perm`), f_root the root's factor run by
// its recurrence in registers (the prefactor folded into the seed), rad_l =
// hm_l exp(min(he_l, lim)) from a K5 launch in its h-only mode (the clamp
// of biem/_eval_fused.py::_h_clamped, so an underflowed density never meets
// an overflowed h) or, in 3D, the chain of hankel.cuh, and Y_child(cs) the
// product of the subtree's factors.  A root 'a' (2D) is one child state
// whose entries are its orders m (rad_{|m|}).
//
// The walk (ops/harmonic_program.py::ke_walk_numpy): consecutive child
// states differ by one step at one level (a non-root node), every level
// inside it back at its first value.  So each level's state is carried in
// registers, not rebuilt from its seed: an 'a' level's power of
// e^{+-i phi} (one product a step, the two chains apart), a 'b' or 'c'
// level's recurrence pair (one Jacobi step), and for each non-root node C
// the powers A[C][l] = base_C^(the degree C's subtree's levels <= l give
// it), base_C the sine (cosine for the first child of a 'c' node) of C's
// parent's angle: a restarted level takes its seed's prefactor from them,
// the root its seed's.  A carried step is the same operation as the one
// from the seed, and a carried power the same products in the same order,
// so every factor has the bits of harmonics.cuh's from-seed evaluation;
// only the product of the factors (level by level) and the order of the sum
// over child states differ.  The state is indexed by compile-time levels: a
// kernel instance per tree shape (the node kinds in pre-order, every shape
// of at most 4 nodes: 'a'; 'ba'; 'bba', 'caa'; 'bbba', 'bcaa', 'cbaa',
// 'caba'), so nothing is indexed at run time in the walk; larger trees take
// the generic instance, which evaluates each child state's factors from
// their seeds (harmonics.cuh) as before.
//
// Two modes, chosen by the shape of the call (the wrapper: P K below
// kernels.FEW_POINTS).  Many points (harmonic_eval_kernel): PT points a
// thread, `threads` threads a CTA, a CTA per (tile of points, k, slice of
// bpz balls), the slices sized by the wrapper to fill the card (each writes
// its own sum or its balls' outputs; the wrapper sums the slices in a fixed
// order); every thread walks the same child states, so each uniform load
// (the walk's tables, the density in shared memory, the coefficient row)
// serves PT points, whose recurrences are independent chains.  The radial
// tables are [n][threads][PT] in shared memory (a thread's points' h_l in
// one 16-byte load in complex64 at PT = 2), or, where that would leave an
// SM fewer than 4 warps (n_end in the hundreds), in a device scratch
// strided by the grid's threads (the GLOB instance).  The density comes in
// windows of `wwin` entries (all H of them when that leaves an SM as many
// warps), gathered through `ke_perm` as the walk reaches them.  Nothing of
// size [P, B, H] reaches device memory; results repeat bit for bit (no
// atomics).  Few points: see harmonic_eval_few_kernel.
//
// What bounds it: operations, ~9 instructions per harmonic and (point,
// ball) (h times the root factor, its complex product with the density, the
// Jacobi step), the loads and loop shared by PT points; the walk adds about
// one step per child state and level.  In practice the instruction rate: the
// radial tables' claim on shared memory caps the warps an SM (12 at
// 'bpa' n_end = 32 in complex64), so each step's loads start a step
// ahead and the even and odd steps sum apart.
#include "hankel.cuh"
#include "harmonic_walk.cuh"
#include "harmonics.cuh"

namespace {

// where rad_l comes from: K5's table (hm, he), or the chain of hankel.cuh
// on a real or a complex k r (d = 3)
constexpr int kRadTable = 0, kRadReal = 1, kRadComplex = 2;
constexpr int kMaxThreads = 128;  // many-point mode: at most, a CTA
constexpr int kFewThreads = 256;  // few-point mode: 8 warps
constexpr int kFewWarps = kFewThreads / 32;
constexpr int kGeneric = 0;  // the shape code of trees of more than 4 nodes
// many-point mode: points a thread (ops/harmonic_eval.py _PT): two in
// complex64 (their h_l in one 16-byte load); one in complex128, whose
// radial tables (16 bytes an entry) would leave an SM 4 warps at two
template <typename T>
constexpr int kPT = sizeof(T) == 4 ? 2 : 1;

// The thread's PT points' h_l (consecutive in the radial table): one
// 16-byte load for two complex64
template <typename T, int PT>
__device__ __forceinline__ void load_h(const c2_t<T>* src, c2_t<T> (&h)[PT]) {
  if constexpr (sizeof(c2_t<T>) == 8 && PT % 2 == 0) {
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      h[2 * i] = cmake<T>(v.x, v.y);
      h[2 * i + 1] = cmake<T>(v.z, v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PT; ++i) h[i] = src[i];
  }
}

// One root step for PT points: acc += (h pn) w, then (pm, pn) by the Jacobi
// step at coefficients cf (hprog::jacobi_step's operations)
template <typename T, int PT, typename C3>
__device__ __forceinline__ void root_step(const c2_t<T> (&h)[PT], c2_t<T> w, C3 cf,
                                          const T (&x0)[PT], T (&pn)[PT], T (&pm)[PT],
                                          c2_t<T> (&acc)[PT]) {
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    acc[p] = cfma<T>(cscale<T>(h[p], pn[p]), w, acc[p]);
    const T pp = t_fma(t_fma(x0[p], cf.x, cf.y), pn[p], -cf.z * pm[p]);
    pm[p] = pn[p];
    pn[p] = pp;
  }
}

// The density w of one ball in KE's order read through `ke_perm` from its
// flat order (the few-point mode; the many-point mode gathers its windows)
template <typename T>
struct Gather {
  const c2_t<T>* w;
  const int* idx;
  __device__ __forceinline__ c2_t<T> operator[](int j) const { return w[idx[j]]; }
};

// The root's recurrence over a child state's J >= 1 entries for PT points:
// acc += (h_{l0 + step j} pn_j) w_j with pn_0 the seed and pn_{j+1} its
// Jacobi step at coefficient row row + j (cf the first row's).  Each step's
// loads (h, w and the next coefficient row: the table has a row past the
// last family's) start a step ahead, into two sets of registers taken
// in turn (two steps a trip), so that no step waits on a load and no value
// is copied; the even and odd steps sum apart (two chains), then add.
template <typename T, int PT, typename C3, typename W>
__device__ __forceinline__ void root_sum(const c2_t<T>* hp, size_t hstep, W wc,
                                         int J, const T* __restrict__ coef, int row, C3 cf,
                                         const T (&x0)[PT], T (&pn)[PT], c2_t<T> (&acc)[PT]) {
  T pm[PT];
  c2_t<T> ha[PT], hb[PT];
#pragma unroll
  for (int p = 0; p < PT; ++p) pm[p] = 0;
  load_h<T, PT>(hp, ha);
  c2_t<T> wa = wc[0], wb, odd[PT];
#pragma unroll
  for (int p = 0; p < PT; ++p) odd[p] = cmake<T>(0, 0);
  C3 ca = cf, cb;
  const T* cp = coef + 4 * (size_t)(row + 1);  // the next step's row
  int j = 0;
  for (; j + 2 < J; j += 2, cp += 8) {
    cb = hprog::coef_row(cp, 0);
    hp += hstep;
    load_h<T, PT>(hp, hb);
    wb = wc[j + 1];
    root_step<T, PT>(ha, wa, ca, x0, pn, pm, acc);
    ca = hprog::coef_row(cp, 1);
    hp += hstep;
    load_h<T, PT>(hp, ha);
    wa = wc[j + 2];
    root_step<T, PT>(hb, wb, cb, x0, pn, pm, odd);
  }
  if (j + 1 < J) {  // one step left, then the last entry
    hp += hstep;
    load_h<T, PT>(hp, hb);
    wb = wc[j + 1];
    root_step<T, PT>(ha, wa, ca, x0, pn, pm, acc);
#pragma unroll
    for (int p = 0; p < PT; ++p) odd[p] = cfma<T>(cscale<T>(hb[p], pn[p]), wb, odd[p]);
  } else {
#pragma unroll
    for (int p = 0; p < PT; ++p) acc[p] = cfma<T>(cscale<T>(ha[p], pn[p]), wa, acc[p]);
  }
#pragma unroll
  for (int p = 0; p < PT; ++p) acc[p] = cadd<T>(acc[p], odd[p]);
}

// A launch's arguments (see bhs_harmonic_eval)
template <typename T>
struct KeArgs {
  const T* x;
  long long sxd, sxk, sxp;
  int kx;
  const T* centers;
  long long sck;
  const c2_t<T>* hm;
  const T* he;
  const T* kv;
  T rescale, lim;
  const c2_t<T>* w;
  const int* perm;
  hprog::Prog<T> pg;
  const int4* walk;
  const int4* wfam;
  const T* wroot;
  const int4* wstep;
  const int* wjob;
  const int* runs;
  c2_t<T>* out;
  int P, K, B, n, H, n_cs, d, root_step, per_ball, bpz, wwin, wpb;
  c2_t<T>* hs_glob;
};

// The clamped radial factor from K5's table at entry `hoff + l`
template <typename T>
__device__ __forceinline__ c2_t<T> rad_table(const KeArgs<T>& a, size_t i) {
  const T he = a.he[i];
  return cscale<T>(a.hm[i], t_exp(he < a.lim ? he : a.lim));
}

// point p's coordinates at batch entry k
template <typename T>
__device__ __forceinline__ T x_at(const KeArgs<T>& a, int i, int k, int p) {
  const long long off = (long long)i * a.sxd + (a.kx == 1 ? 0LL : (long long)k * a.sxk);
  return a.x[off + (long long)p * a.sxp];
}

// Bytes of the many-point mode's shared memory: the density's window, then
// (unless in the scratch) the radial tables [n][threads][PT] at an even
// element offset (16-byte aligned)
inline size_t many_smem(int wwin, int n, int threads, int pt, bool glob, size_t elt) {
  return elt * ((size_t)((wwin + 1) & ~1) + (glob ? 0 : (size_t)n * threads * pt));
}

template <typename T, int R, int PT, int S, bool GLOB>
__global__ void __launch_bounds__(kMaxThreads) harmonic_eval_kernel(const KeArgs<T> a) {
  using T2 = c2_t<T>;
  constexpr int NN = nn_of(S);
  constexpr int D = S == kGeneric ? hprog::kMaxNodes + 1 : NN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* Ws = reinterpret_cast<T2*>(smem_raw);  // [wwin]
  const int nt = blockDim.x, tid = threadIdx.x;
  // the thread's radial tables: [n][nt][PT] after Ws, or (GLOB) [n][the
  // grid's threads][PT] in hs_glob; an instance each, so that the shared
  // one is addressed as shared memory
  size_t hst = (size_t)nt * PT;
  T2* Hs = Ws + ((a.wwin + 1) & ~1) + (size_t)tid * PT;
  if constexpr (GLOB) {
    hst = (size_t)gridDim.x * gridDim.y * gridDim.z * nt * PT;
    Hs = a.hs_glob + ((((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                      nt + tid) * PT;
  }

  const int k = blockIdx.y;
  const int p0 = (blockIdx.x * nt + tid) * PT;
  const T* centers = a.centers + k * a.sck;
  const int d = S == kGeneric ? a.d : D;
  T px[PT][D];
  bool live[PT];
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    live[p] = p0 + p < a.P;
    for (int i = 0; i < d; ++i) px[p][i] = live[p] ? x_at(a, i, k, p0 + p) : (T)0;
  }
  int4 nds[NN > 0 ? NN : 1];
  if constexpr (S != kGeneric) {
#pragma unroll
    for (int i = 0; i < NN; ++i) nds[i] = a.pg.nodes[i];
  }
  int kind[S == kGeneric ? hprog::kMaxNodes : 1];
  if constexpr (S == kGeneric) hprog::node_kinds<T>(a.pg, kind);
  Walk<T, PT, S == kGeneric ? (1 << 8) : S> st;  // (unused by the generic instance)
  T ax[S == kGeneric ? PT : 1][S == kGeneric ? hprog::kMaxNodes : 1];
  T ac[S == kGeneric ? PT : 1][S == kGeneric ? hprog::kMaxNodes : 1];
  T as[S == kGeneric ? PT : 1][S == kGeneric ? hprog::kMaxNodes : 1];

  T2 total[PT];
#pragma unroll
  for (int p = 0; p < PT; ++p) total[p] = cmake<T>(0, 0);
  const int b1 = (blockIdx.z + 1) * a.bpz < a.B ? (blockIdx.z + 1) * a.bpz : a.B;
  for (int b = blockIdx.z * a.bpz; b < b1; ++b) {
    const T2* wb = a.w + ((size_t)k * a.B + b) * a.H;
    T r[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      T v[D];
      for (int i = 0; i < d; ++i) v[i] = px[p][i] - centers[(size_t)b * d + i];
      if constexpr (S == kGeneric) r[p] = hprog::tree_angles<T>(a.pg, v, ax[p], ac[p], as[p]);
      else r[p] = st.angles(nds, v, p);
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      if constexpr (R == kRadTable) {
        const size_t hoff = (((size_t)k * a.P + (live[p] ? p0 + p : 0)) * a.B + b) * a.n;
        for (int l = 0; l < a.n; ++l)
          Hs[l * hst + p] = live[p] ? rad_table(a, hoff + l) : cmake<T>(0, 0);
      } else {
        h_chain<T, 0, R == kRadComplex>(
            k_times<T, R == kRadComplex>(k_of<T, R == kRadComplex>(a.kv, k), r[p]), a.n, a.lim,
            t_exp(a.lim), a.rescale, t_log(a.rescale),
            [&](int l, T2 h) { Hs[l * hst + p] = live[p] ? h : cmake<T>(0, 0); });
      }
    }

    T2 ub[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) ub[p] = cmake<T>(0, 0);
    int wlo = -1;  // the window's first entry (none yet for this ball)
    // the child state's (op, J, woff, l0), families and root; the next one's a
    // state ahead
    int4 wk = a.walk[0], wf = a.wfam[0];
    Root<T> wr = load_root(a.wroot, 0);
    for (int e = 0; e < a.n_cs; ++e) {
      const int en = e + 1 < a.n_cs ? e + 1 : e;
      const int4 wk_n = a.walk[en], wf_n = a.wfam[en];
      const Root<T> wr_n = load_root(a.wroot, en);
      if (wlo < 0 || wk.z + wk.y > wlo + a.wwin) {  // uniform: every thread walks alike
        __syncthreads();  // every thread is done with the last window
        wlo = wk.z;
        for (int i = tid; i < a.wwin && wlo + i < a.H; i += nt) Ws[i] = wb[a.perm[wlo + i]];
        __syncthreads();
      }
      const T2* wc = Ws + (wk.z - wlo);
      T2 acc[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) acc[p] = cmake<T>(0, 0);
      if constexpr (NN == 1) {  // a root 'a': orders m = -half..half, powers of e^{i phi}
        const int half = wk.y / 2;
        T2 f[PT], z[PT];
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          z[p] = cmake<T>(st.c[p][0], st.s[p][0]);
          f[p] = hprog::a_factor<T>(-half, st.c[p][0], st.s[p][0]);
        }
        for (int j = 0; j < wk.y; ++j) {
          const int am = j < half ? half - j : j - half;
          const T2 wv = wc[j];
          T2 h[PT];
          load_h<T, PT>(Hs + (size_t)am * hst, h);
#pragma unroll
          for (int p = 0; p < PT; ++p) {
            acc[p] = cfma<T>(cmul<T>(f[p], h[p]), wv, acc[p]);
            f[p] = cmul<T>(f[p], z[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < PT; ++p) ub[p] = cadd<T>(ub[p], acc[p]);
      } else if constexpr (S == kGeneric) {  // every child state from its seeds
        const int* job_of = a.wjob + (size_t)e * a.pg.n_nodes;
        const int4 job = a.pg.jobs[job_of[0]];
        T pn[PT], x0[PT];
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          pn[p] = hprog::job_seed<T>(a.pg, kind[0], job, ac[p][0], as[p][0]);
          x0[p] = ax[p][0];
        }
        const int row = a.pg.fam[job.x];
        root_sum<T, PT>(Hs + (size_t)wk.w * hst, (size_t)a.root_step * hst, wc, wk.y, a.pg.coef,
                        row, hprog::coef_row(a.pg.coef, row), x0, pn, acc);
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          const T2 y = hprog::factor_product<T>(a.pg, kind, job_of, 1, ax[p], ac[p], as[p]);
          ub[p] = cfma<T>(acc[p], y, ub[p]);
        }
      } else {  // the walk: one step from the previous child state
        st.advance(a.pg, e == 0 ? -1 : wk.x, wf);
        T pn[PT], x0[PT];
        st.root_seed(wr.p0, wr.norm, pn);
#pragma unroll
        for (int p = 0; p < PT; ++p) x0[p] = st.x[p][0];
        root_sum<T, PT>(Hs + (size_t)wk.w * hst, (size_t)st.RS * hst, wc, wk.y, a.pg.coef,
                        wf.w, root_coef(wr), x0, pn, acc);
#pragma unroll
        for (int p = 0; p < PT; ++p) ub[p] = cfma<T>(acc[p], st.prod[p][st.NL - 1], ub[p]);
      }
      wk = wk_n;
      wf = wf_n;
      wr = wr_n;
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      if (a.per_ball) {
        if (live[p]) a.out[((size_t)(p0 + p) * a.K + k) * a.B + b] = ub[p];
      } else {
        total[p] = cadd<T>(total[p], ub[p]);
      }
    }
  }
  if (!a.per_ball) {
#pragma unroll
    for (int p = 0; p < PT; ++p)
      if (live[p]) a.out[((size_t)(p0 + p) * a.K + k) * gridDim.z + blockIdx.z] = total[p];
  }
}

// Few points (P K below the wrapper's threshold, e.g. uscat(0)): a CTA per
// (point, k) and slice of bpz balls (grid.y); its 8 warps in groups of wpb
// take the slice's balls (group g: balls g, g + 8 / wpb, ...), the group's
// 32 wpb lanes contiguous runs of the walk (`runs`, about equal work: a
// lane rebuilds its first child state from the first values by their steps,
// then carries), or, for a root 'a' and the generic instance, its entries /
// child states in turn from their seeds; the group's radial table in shared
// memory; a fixed shuffle tree sums each warp's lanes, the group its warps
// and the CTA its groups in order into one sum per slice (the wrapper sums
// the slices), so results repeat bit for bit.
template <typename T, int R, int S>
__global__ void __launch_bounds__(kFewThreads) harmonic_eval_few_kernel(const KeArgs<T> a) {
  using T2 = c2_t<T>;
  constexpr int NN = nn_of(S);
  constexpr int D = S == kGeneric ? hprog::kMaxNodes + 1 : NN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_grp = kFewWarps / a.wpb, lanes = 32 * a.wpb;
  T2* Hw = reinterpret_cast<T2*>(smem_raw);  // [n_grp][n]
  T2* part = Hw + (size_t)n_grp * a.n;       // [warps]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / a.wpb, gl = tid % lanes;
  const int p = blockIdx.x / a.K, k = blockIdx.x % a.K;
  const T* centers = a.centers + k * a.sck;
  const int d = S == kGeneric ? a.d : D;
  T px[D];
  for (int i = 0; i < d; ++i) px[i] = x_at(a, i, k, p);
  int4 nds[NN > 0 ? NN : 1];
  if constexpr (S != kGeneric) {
#pragma unroll
    for (int i = 0; i < NN; ++i) nds[i] = a.pg.nodes[i];
  }
  int kind[S == kGeneric ? hprog::kMaxNodes : 1];
  if constexpr (S == kGeneric) hprog::node_kinds<T>(a.pg, kind);
  T2* H_ = Hw + (size_t)grp * a.n;
  T2 gsum = cmake<T>(0, 0);

  const int b0 = blockIdx.y * a.bpz;
  const int b1 = b0 + a.bpz < a.B ? b0 + a.bpz : a.B;
  const int rounds = (a.bpz + n_grp - 1) / n_grp;  // the same for every group
  for (int rd = 0; rd < rounds; ++rd) {
    const int b = b0 + rd * n_grp + grp;
    const bool has = b < b1;
    Walk<T, 1, S == kGeneric ? (1 << 8) : S> st;
    T ax[S == kGeneric ? hprog::kMaxNodes : 1], ac[S == kGeneric ? hprog::kMaxNodes : 1],
        as[S == kGeneric ? hprog::kMaxNodes : 1];
    T r = 0;
    if (has) {
      T v[D];
      for (int i = 0; i < d; ++i) v[i] = px[i] - centers[(size_t)b * d + i];
      if constexpr (S == kGeneric) r = hprog::tree_angles<T>(a.pg, v, ax, ac, as);
      else r = st.angles(nds, v, 0);
      if constexpr (R == kRadTable) {
        const size_t hoff = (((size_t)k * a.P + p) * a.B + b) * a.n;
        for (int l = gl; l < a.n; l += lanes) H_[l] = rad_table(a, hoff + l);
      } else {  // every lane runs the chain (uniform branches); lane l % lanes keeps h_l
        h_chain<T, 0, R == kRadComplex>(
            k_times<T, R == kRadComplex>(k_of<T, R == kRadComplex>(a.kv, k), r), a.n, a.lim,
            t_exp(a.lim), a.rescale, t_log(a.rescale), [&](int l, T2 h) {
              if (l % lanes == gl) H_[l] = h;
            });
      }
    }
    __syncthreads();
    const T2* wb = a.w + ((size_t)k * a.B + (has ? b : 0)) * a.H;
    T2 acc_l = cmake<T>(0, 0);
    if (has) {
      if constexpr (NN == 1) {  // a root 'a': its entries in turn
        const int4 ci = a.walk[0];
        const int half = ci.y / 2;
        for (int j = gl; j < ci.y; j += lanes) {
          const int m = j - half;
          const T2 f = hprog::a_factor<T>(m, st.c[0][0], st.s[0][0]);
          acc_l = cfma<T>(cmul<T>(f, H_[m < 0 ? -m : m]), wb[a.perm[ci.z + j]], acc_l);
        }
      } else if constexpr (S == kGeneric) {  // child states in turn, from their seeds
        for (int e = gl; e < a.n_cs; e += lanes) {
          const int4 wk = a.walk[e];
          const int* job_of = a.wjob + (size_t)e * a.pg.n_nodes;
          const int4 job = a.pg.jobs[job_of[0]];
          T pn[1] = {hprog::job_seed<T>(a.pg, kind[0], job, ac[0], as[0])}, x0[1] = {ax[0]};
          T2 acc[1] = {cmake<T>(0, 0)};
          const int row = a.pg.fam[job.x];
          root_sum<T, 1>(H_ + wk.w, a.root_step, Gather<T>{wb, a.perm + wk.z}, wk.y, a.pg.coef,
                         row, hprog::coef_row(a.pg.coef, row), x0, pn, acc);
          const T2 y = hprog::factor_product<T>(a.pg, kind, job_of, 1, ax, ac, as);
          acc_l = cfma<T>(acc[0], y, acc_l);
        }
      } else {  // a contiguous run of the walk, carried
        const int e0 = a.runs[gl], e1 = a.runs[gl + 1];
        for (int e = e0; e < e1; ++e) {
          const int4 wk = a.walk[e];
          const int4 wf = a.wfam[e];
          if (e == e0) st.replay(a.pg, wf, a.wstep[e]);
          else st.advance(a.pg, wk.x, wf);
          const Root<T> wr = load_root(a.wroot, e);
          T pn[1], x0[1] = {st.x[0][0]};
          T2 acc[1] = {cmake<T>(0, 0)};
          st.root_seed(wr.p0, wr.norm, pn);
          root_sum<T, 1>(H_ + wk.w, st.RS, Gather<T>{wb, a.perm + wk.z}, wk.y, a.pg.coef, wf.w,
                         root_coef(wr), x0, pn, acc);
          acc_l = cfma<T>(acc[0], st.prod[0][st.NL - 1], acc_l);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {  // fixed tree: lane 0 holds the warp's sum
      acc_l.x += __shfl_down_sync(0xffffffffu, acc_l.x, off);
      acc_l.y += __shfl_down_sync(0xffffffffu, acc_l.y, off);
    }
    if (lane == 0) part[warp] = acc_l;
    __syncthreads();
    if (has && gl == 0) {  // the ball's sum: its group's warps in order
      T2 s = cmake<T>(0, 0);
      for (int i = 0; i < a.wpb; ++i) s = cadd<T>(s, part[grp * a.wpb + i]);
      if (a.per_ball) a.out[((size_t)p * a.K + k) * a.B + b] = s;
      else gsum = cadd<T>(gsum, s);
    }
    __syncthreads();  // part and the radial tables are rewritten next round
  }
  if (a.per_ball) return;
  if (gl == 0) part[grp] = gsum;
  __syncthreads();
  if (tid == 0) {  // the sum of this CTA's slice of balls (one slice: of all)
    T2 s = cmake<T>(0, 0);
    for (int i = 0; i < n_grp; ++i) s = cadd<T>(s, part[i]);
    a.out[((size_t)p * a.K + k) * gridDim.y + blockIdx.y] = s;
  }
}

// A launch's grid: mode, threads a CTA, points a thread, CTAs along x, slices
struct Grid {
  int few, threads, pt, blocks_x, slices;
};

template <typename T, int R, int S>
cudaError_t launch_shape(const KeArgs<T>& a, const Grid& g, cudaStream_t stream) {
  const int few = g.few, threads = g.threads, pt = g.pt, blocks_x = g.blocks_x, slices = g.slices;
  using T2 = c2_t<T>;
  if (few) {
    const size_t smem = sizeof(T2) * ((size_t)(kFewWarps / a.wpb) * a.n + kFewWarps);
    auto kernel = harmonic_eval_few_kernel<T, R, S>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((unsigned)((long long)a.P * a.K), slices), kFewThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = many_smem(a.wwin, a.n, threads, pt, a.hs_glob != nullptr, sizeof(T2));
  auto kernel = a.hs_glob ? harmonic_eval_kernel<T, R, kPT<T>, S, true>
                          : harmonic_eval_kernel<T, R, kPT<T>, S, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks_x, a.K, slices), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance of a tree shape (the node kinds in pre-order) and a radial
// source: d = 3 ('ba') takes the chain, every other shape K5's table
template <typename T>
cudaError_t launch(const KeArgs<T>& a, int shape, int rad, const Grid& g, cudaStream_t stream) {
  if (shape == 513) {
    if (rad == kRadReal)
      return launch_shape<T, kRadReal, 513>(a, g, stream);
    if (rad == kRadComplex)
      return launch_shape<T, kRadComplex, 513>(a, g, stream);
    return cudaErrorInvalidValue;
  }
  if (rad != kRadTable) return cudaErrorInvalidValue;
  switch (shape) {
    case 256: return launch_shape<T, kRadTable, 256>(a, g, stream);
    case 773: return launch_shape<T, kRadTable, 773>(a, g, stream);
    case 770: return launch_shape<T, kRadTable, 770>(a, g, stream);
    case 1045: return launch_shape<T, kRadTable, 1045>(a, g, stream);
    case 1033: return launch_shape<T, kRadTable, 1033>(a, g, stream);
    case 1030: return launch_shape<T, kRadTable, 1030>(a, g, stream);
    case 1042: return launch_shape<T, kRadTable, 1042>(a, g, stream);
    case kGeneric:
      return launch_shape<T, kRadTable, kGeneric>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* x, long long sxd, long long sxk, long long sxp, int kx,
                const void* centers, long long sck, int rad, const void* hm, const void* he,
                const void* kv, double rescale, const void* w, const void* perm,
                const void* nodes, const void* jobs, const void* fam, const void* coef,
                const void* famr, int n_nodes, int shape, const void* walk, const void* wfam,
                const void* wroot, const void* wstep, const void* wjob, const void* runs,
                void* out, int P, int K, int B, int n, int H, int n_cs, int d, int root_step,
                int per_ball, int few, int bpz, double lim,
                int wwin, int threads, int pt, int wpb, void* hs_glob, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (P == 0 || K == 0) return cudaSuccess;
  if (n_nodes > hprog::kMaxNodes || (shape != kGeneric && (shape >> 8) != n_nodes) ||
      (!few && (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || pt != kPT<T>)) ||
      (few && (wpb < 1 || kFewWarps % wpb != 0)))
    return cudaErrorInvalidValue;
  KeArgs<T> a{static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers), sck,
              static_cast<const T2*>(hm), static_cast<const T*>(he), static_cast<const T*>(kv),
              (T)rescale, (T)lim, static_cast<const T2*>(w), static_cast<const int*>(perm),
              hprog::Prog<T>{static_cast<const int4*>(nodes), static_cast<const int4*>(jobs),
                             static_cast<const int*>(fam), static_cast<const T*>(coef),
                             static_cast<const T*>(famr), n_nodes},
              static_cast<const int4*>(walk), static_cast<const int4*>(wfam),
              static_cast<const T*>(wroot), static_cast<const int4*>(wstep),
              static_cast<const int*>(wjob),
              static_cast<const int*>(runs), static_cast<T2*>(out), P, K, B, n, H, n_cs, d,
              root_step, per_ball, bpz, wwin, wpb, static_cast<T2*>(hs_glob)};
  const int slices = (B + bpz - 1) / bpz;
  const long long tile = (long long)threads * pt;
  const Grid g{few, threads, pt, few ? 0 : (int)((P + tile - 1) / tile), slices};
  return launch<T>(a, shape, rad, g, stream);
}

// CTAs of the many-point instance that fit on one SM at this shared memory
template <typename T, int R, int S>
cudaError_t occupancy_shape(int threads, bool glob, size_t smem, int* blocks) {
  auto kernel = glob ? harmonic_eval_kernel<T, R, kPT<T>, S, true>
                     : harmonic_eval_kernel<T, R, kPT<T>, S, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <typename T>
cudaError_t occupancy(int shape, int rad, int threads, bool glob, size_t smem, int* blocks) {
  if (shape == 513)
    return rad == kRadComplex ? occupancy_shape<T, kRadComplex, 513>(threads, glob, smem, blocks)
                              : occupancy_shape<T, kRadReal, 513>(threads, glob, smem, blocks);
  switch (shape) {
    case 256: return occupancy_shape<T, kRadTable, 256>(threads, glob, smem, blocks);
    case 773: return occupancy_shape<T, kRadTable, 773>(threads, glob, smem, blocks);
    case 770: return occupancy_shape<T, kRadTable, 770>(threads, glob, smem, blocks);
    case 1045: return occupancy_shape<T, kRadTable, 1045>(threads, glob, smem, blocks);
    case 1033: return occupancy_shape<T, kRadTable, 1033>(threads, glob, smem, blocks);
    case 1030: return occupancy_shape<T, kRadTable, 1030>(threads, glob, smem, blocks);
    case 1042: return occupancy_shape<T, kRadTable, 1042>(threads, glob, smem, blocks);
    default: return occupancy_shape<T, kRadTable, kGeneric>(threads, glob, smem, blocks);
  }
}

}  // namespace

// x [d, Kx, P] by strides; centers [K, B, d] with (B, d) contiguous at k
// stride sck (0: shared); rad 0: hm / he [K, P, B, n] (K5's h-only outputs
// at k |x - c_b|), rad 1 / 2 (d = 3): the chain on k [K] real / complex
// (interleaved) with `rescale`; w [K, B, H] and `ke_perm` [H] (int32: entry
// t of KE's order is w[..., ke_perm[t]]); the
// program's tables and KE's walk (ops/harmonic_program.py: shape, walk,
// wfam, wroot, wstep, wjob) and, few-point mode, `runs` [32 wpb + 1] (the lanes'
// runs of the walk, ke_runs); out [P, K, B] (per_ball), or summed: [P, K,
// slices] (slices of bpz balls; [P, K] at one slice).  Many-point mode:
// `threads` a CTA, pt (kPT) points a thread, wwin the density's window (entries,
// at least every child state's), hs_glob null (the radial tables in shared
// memory) or a scratch of n pt times the grid's threads; few-point mode: wpb
// warps a ball.
extern "C" int bhs_harmonic_eval(const void* x, long long sxd, long long sxk, long long sxp,
                                 int kx, const void* centers, long long sck, int rad,
                                 const void* hm, const void* he, const void* kv, double rescale,
                                 const void* w, const void* perm, const void* nodes,
                                 const void* jobs,
                                 const void* fam, const void* coef, const void* famr,
                                 int n_nodes, int shape, const void* walk, const void* wfam,
                                 const void* wroot, const void* wstep, const void* wjob,
                                 const void* runs,
                                 void* out, int P, int K, int B, int n, int H, int n_cs, int d,
                                 int root_step, int per_ball, int few, int bpz, double lim,
                                 int wwin, int threads, int pt, int wpb, void* hs_glob, int dbl,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(x, sxd, sxk, sxp, kx, centers, sck, rad, hm, he, kv, rescale, w,
                            perm, nodes, jobs, fam, coef, famr, n_nodes, shape, walk, wfam,
                            wroot, wstep, wjob, runs, out, P, K, B, n, H, n_cs, d, root_step,
                            per_ball, few, bpz, lim, wwin, threads, pt, wpb, hs_glob, st);
  return (int)run<float>(x, sxd, sxk, sxp, kx, centers, sck, rad, hm, he, kv, rescale, w, perm,
                         nodes, jobs, fam, coef, famr, n_nodes, shape, walk, wfam, wroot, wstep,
                         wjob, runs, out, P, K, B, n, H, n_cs, d, root_step, per_ball, few, bpz,
                         lim, wwin, threads, pt, wpb, hs_glob, st);
}

// The many-point instance's CTAs per SM (into *blocks) at `threads` a CTA, pt
// points a thread and the shared memory of (wwin, n, glob)
extern "C" int bhs_harmonic_eval_occupancy(int shape, int rad, int threads, int pt, int n,
                                           int wwin, int glob, int dbl, void* blocks) {
  int* out = static_cast<int*>(blocks);
  if (dbl)
    return (int)occupancy<double>(shape, rad, threads, glob,
                                  many_smem(wwin, n, threads, pt, glob, sizeof(double2)), out);
  return (int)occupancy<float>(shape, rad, threads, glob,
                               many_smem(wwin, n, threads, pt, glob, sizeof(float2)), out);
}
