// The device-side evaluator of a tree's harmonics, shared by KE
// (harmonic_eval.cu), K3 (rotation_blocks.cu) and KR (plane_rhs.cu).
//
// It reads the program of ops/harmonic_program.py (the tables named there)
// and computes the node factors of harmonics/_eval.py::_node_table (the
// JAX package's harmonics/_eval.py:40-82):
//
//   'a'  : e^{i m phi} / sqrt(2 pi)
//   'b'  : (sin th)^{nc} p~_{l-nc}^{(lam,lam)}(cos th)
//   'c'  : norm (cos th)^{n1} (sin th)^{n2} p~_j^{(al,be)}(cos 2 th)
//
// with p~ the orthonormal Jacobi family of the job's family, run from its
// seed p_0 = 1 / b_0 by p_{j+1} = (x c1 + c2) p_j - c3 p_{j-1}.  The
// prefactor multiplies the seed (the recurrence is linear), so every value
// the recurrence carries is the factor itself, bounded like a normalised
// harmonic, and an underflowed prefactor gives 0 as the plain product does.
// e^{i m phi} is the |m|-th power of e^{i phi} (conjugated for m < 0): no
// sincos, and an error of |m| roundings, below the plain version's own in
// float32 (the rounding of the angle m phi).
//
// Angles come from a cartesian vector node by node, children before
// parents, as coords/_transform.py::from_cartesian: 'a' cos phi = x_i / r,
// sin phi = x_j / r; 'b'/'bp' cos th = x_axis / r, sin th = r_child / r;
// 'c' cos th = r_1 / r, sin th = r_2 / r (r = 0: the angle 0, as
// atan2(0, 0)).  Each node keeps x (the recurrence's argument: cos th for
// 'b', cos 2 th for 'c', cos phi for 'a'), c = cos and s = sin.
#pragma once
#include "common.cuh"

namespace hprog {

constexpr int kMaxNodes = 32;  // d <= 33
constexpr int kA = 0, kB = 1, kC = 2;

// The program's device tables (ops/harmonic_program.py)
template <typename T>
struct Prog {
  const int4* nodes;  // [n_nodes]: kind, nid, a0, a1; children before parents
  const int4* jobs;   // [n_jobs]: family, steps, p1, p2
  const int* fam;     // [n_fam]: first step's row of coef
  const T* coef;      // [n_coef][4]: c1, c2, c3, 0
  const T* famr;      // [n_fam][2]: p0, norm
  int n_nodes;
};

// The angles of every node at the cartesian vector v [d], into ax, ac, as
// (by node id); returns |v| by the tree's hypot chain (the root's radius).
template <typename T>
__device__ __forceinline__ T tree_angles(const Prog<T>& pg, const T* v, T* ax, T* ac, T* as) {
  T r[kMaxNodes];
  T root_r = 0;
  for (int i = 0; i < pg.n_nodes; ++i) {
    const int4 nd = pg.nodes[i];
    // 'a': its two axes; 'b': child radius, own axis; 'c': two child radii
    const T r1 = nd.x == kA ? v[nd.z] : r[nd.z];
    const T r2 = nd.x == kC ? r[nd.w] : v[nd.w];
    const T rr = t_hypot(r1, r2);
    r[nd.y] = rr;
    // th = atan2(r_child, x_axis) for 'b', else atan2(second, first)
    const T first = nd.x == kB ? r2 : r1, second = nd.x == kB ? r1 : r2;
    const T cs = rr > 0 ? first / rr : (T)1;
    const T sn = rr > 0 ? second / rr : (T)0;
    ac[nd.y] = cs;
    as[nd.y] = sn;
    ax[nd.y] = nd.x == kC ? (cs - sn) * (cs + sn) : cs;
    root_r = rr;  // children come first: the last node is the root
  }
  return root_r;
}

template <typename T>
__device__ __forceinline__ T int_pow(T x, int n) {  // x^n by repeated products
  T p = 1;
  for (int i = 0; i < n; ++i) p *= x;
  return p;
}

// The seed of a 'b'/'c' job: its prefactor times p_0
template <typename T>
__device__ __forceinline__ T job_seed(const Prog<T>& pg, int kind, int4 job, T c, T s) {
  const T pref = kind == kB ? int_pow<T>(s, job.z)
                            : pg.famr[2 * job.x + 1] * int_pow<T>(c, job.z) * int_pow<T>(s, job.w);
  return pref * pg.famr[2 * job.x];
}

// Row `row` of coef (c1, c2, c3) in one 16-byte load (two for double)
__device__ __forceinline__ float3 coef_row(const float* coef, int row) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(coef) + row);
  return make_float3(v.x, v.y, v.z);
}
__device__ __forceinline__ double3 coef_row(const double* coef, int row) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(coef) + 2 * row);
  const double2 b = __ldg(reinterpret_cast<const double2*>(coef) + 2 * row + 1);
  return make_double3(a.x, a.y, b.x);
}

// One recurrence step at coef row `row`: (p_j, p_{j-1}) -> (p_{j+1}, p_j)
template <typename T>
__device__ __forceinline__ void jacobi_step(const Prog<T>& pg, int row, T x, T& pn, T& pm) {
  const auto cf = coef_row(pg.coef, row);
  const T pp = t_fma(t_fma(x, cf.x, cf.y), pn, -cf.z * pm);
  pm = pn;
  pn = pp;
}

// e^{i m phi} / sqrt(2 pi) from (cos phi, sin phi)
template <typename T>
__device__ __forceinline__ c2_t<T> a_factor(int m, T c, T s) {
  const c2_t<T> z = cmake<T>(c, m < 0 ? -s : s);
  c2_t<T> p = cmake<T>((T)0.39894228040143267794, 0);
  for (int i = 0; i < (m < 0 ? -m : m); ++i) p = cmul<T>(p, z);
  return p;
}

// The factor of a node of kind `kind` at job `job`, from its seed.
template <typename T>
__device__ __forceinline__ c2_t<T> node_factor(const Prog<T>& pg, int kind, int4 job, T x, T c,
                                               T s) {
  if (kind == kA) return a_factor<T>(job.z, c, s);
  T pn = job_seed<T>(pg, kind, job, c, s), pm = 0;
  const int row = pg.fam[job.x];
  for (int j = 0; j < job.y; ++j) jacobi_step<T>(pg, row + j, x, pn, pm);
  return cmake<T>(pn, 0);
}

// The kind of each node by id
template <typename T>
__device__ __forceinline__ void node_kinds(const Prog<T>& pg, int* kind) {
  for (int i = 0; i < pg.n_nodes; ++i) kind[pg.nodes[i].y] = pg.nodes[i].x;
}

// The product of the factors of nodes first..n_nodes-1 (by id) at the jobs
// job_of[nid] (a row of csjob) and the angles ax, ac, as (by node id): a
// child state's subtree factors with first = 1 (the root is node 0).
template <typename T>
__device__ __forceinline__ c2_t<T> factor_product(const Prog<T>& pg, const int* kind,
                                                  const int* __restrict__ job_of, int first,
                                                  const T* ax, const T* ac, const T* as) {
  c2_t<T> y = cmake<T>(1, 0);
  for (int nid = first; nid < pg.n_nodes; ++nid) {
    const int4 job = pg.jobs[job_of[nid]];
    const c2_t<T> f = node_factor<T>(pg, kind[nid], job, ax[nid], ac[nid], as[nid]);
    y = kind[nid] == kA ? cmul<T>(y, f) : cscale<T>(y, f.x);
  }
  return y;
}

}  // namespace hprog
