// The walk of a tree's child states at a compile-time tree shape, shared by
// KE (harmonic_eval.cu) and KR (plane_rhs.cu): the shape's decoding, the
// carried state `Walk` of ops/harmonic_program.py::ke_walk_numpy (see
// harmonic_eval.cu's header for what it carries and why its factors have
// the bits of harmonics.cuh's from-seed evaluation) and a child state's
// root tables (`wroot`).
#pragma once
#include <utility>

#include "harmonics.cuh"

namespace {

// ---- The tree's shape at compile time: S = n_nodes << 8 | sum kind_i << 2 i
// over the node ids i (pre-order); level lv is node n_nodes - 1 - lv.

struct Shape {
  int nn;
  int kind[4], parent[4], c1[4], c2[4], size[4];
};

__host__ __device__ constexpr Shape decode(int S) {
  Shape sh{};
  sh.nn = S >> 8;
  for (int i = 0; i < 4; ++i) {
    sh.kind[i] = (S >> (2 * i)) & 3;
    sh.parent[i] = sh.c1[i] = sh.c2[i] = -1;
    sh.size[i] = 1;
  }
  for (int i = sh.nn - 1; i >= 0; --i) {  // children (ids above i) first
    const int arity = sh.kind[i] == hprog::kA ? 0 : sh.kind[i] == hprog::kB ? 1 : 2;
    int ch = i + 1;
    for (int a = 0; a < arity; ++a) {
      if (a == 0) sh.c1[i] = ch;
      else sh.c2[i] = ch;
      sh.parent[ch] = i;
      sh.size[i] += sh.size[ch];
      ch += sh.size[ch];
    }
  }
  return sh;
}

__host__ __device__ constexpr int nn_of(int S) { return S >> 8; }
__host__ __device__ constexpr int kind_of(int S, int nid) { return decode(S).kind[nid]; }
__host__ __device__ constexpr int c1_of(int S, int nid) { return decode(S).c1[nid]; }
__host__ __device__ constexpr int c2_of(int S, int nid) { return decode(S).c2[nid]; }
__host__ __device__ constexpr int parent_of(int S, int nid) { return decode(S).parent[nid]; }
// level <-> node id
__host__ __device__ constexpr int node_of(int S, int lv) { return nn_of(S) - 1 - lv; }
__host__ __device__ constexpr int level_of(int S, int nid) { return nn_of(S) - 1 - nid; }
// the levels of node (at level) hl's subtree: [lo_of, hl]
__host__ __device__ constexpr int lo_of(int S, int hl) {
  return hl - decode(S).size[node_of(S, hl)] + 1;
}
// whether a step at level lv moves the power of node (at level) hl
__host__ __device__ constexpr bool holds(int S, int hl, int lv) {
  return lo_of(S, hl) <= lv && lv <= hl;
}
// whether the power of node nid has its parent's cosine as base
__host__ __device__ constexpr bool base_is_cos(int S, int nid) {
  return kind_of(S, parent_of(S, nid)) == hprog::kC && c1_of(S, parent_of(S, nid)) == nid;
}

template <typename F, int... I>
__device__ __forceinline__ void static_for_(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
// f(integral_constant<int, i>) for i = 0 .. N-1 in order
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// v[i] for a run-time i < D, by selects (v stays in registers)
template <typename T, int D>
__device__ __forceinline__ T pick(const T (&v)[D], int i) {
  T r = v[0];
#pragma unroll
  for (int j = 1; j < D; ++j) r = i == j ? v[j] : r;
  return r;
}

template <int LV>
__device__ __forceinline__ int fam_at(int4 f) {
  return LV == 0 ? f.x : LV == 1 ? f.y : f.z;
}

// The walk's state of PT points at a tree of shape S (1 to 4 nodes), every
// index a compile-time level or node.
template <typename T, int PT, int S>
struct Walk {
  using T2 = c2_t<T>;
  static constexpr int NN = nn_of(S);
  static constexpr int NL = NN > 1 ? NN - 1 : 1;  // levels (one unused for a root 'a')
  static constexpr int D = NN + 1;                // d = n_nodes + 1 for every tree
  static constexpr int RS = kind_of(S, 0) == hprog::kC ? 2 : 1;  // root degrees a step

  T x[PT][NN], c[PT][NN], s[PT][NN];  // each node's recurrence argument, cos, sin
  T A[PT][NL][NL];                    // A[p][level of C][lv]: see the file's header
  T2 pa[PT][NL];                      // an 'a' level's power (over sqrt(2 pi))
  T pn[PT][NL], pm[PT][NL];           // a 'b' / 'c' level's recurrence pair
  T2 prod[PT][NL];                    // the factors of levels 0 .. lv
  int row[NL];                        // a 'b' / 'c' level's next coefficient row
  T c1[NL], c2[NL], c3[NL];           // ... its coefficients, loaded a step ahead
  bool neg[NL];                       // an 'a' level on its negative chain

  // The angles of point p at v as hprog::tree_angles (same expressions,
  // nodes children first: nds[i] is node NN - 1 - i); returns |v|.
  __device__ __forceinline__ T angles(const int4 (&nds)[NN], const T (&v)[D], int p) {
    T r[NN];
    static_for<NN>([&](auto I) {
      constexpr int i = decltype(I)::value;
      constexpr int nid = NN - 1 - i, kd = kind_of(S, nid);
      constexpr int ch1 = kd == hprog::kA ? 0 : c1_of(S, nid);
      constexpr int ch2 = kd == hprog::kC ? c2_of(S, nid) : 0;
      const int4 nd = nds[i];
      T r1, r2;
      if constexpr (kd == hprog::kA) {
        r1 = pick<T, D>(v, nd.z);
        r2 = pick<T, D>(v, nd.w);
      } else if constexpr (kd == hprog::kB) {
        r1 = r[ch1];
        r2 = pick<T, D>(v, nd.w);
      } else {
        r1 = r[ch1];
        r2 = r[ch2];
      }
      const T rr = t_hypot(r1, r2);
      r[nid] = rr;
      const T first = kd == hprog::kB ? r2 : r1, second = kd == hprog::kB ? r1 : r2;
      const T cs = rr > 0 ? first / rr : (T)1;
      const T sn = rr > 0 ? second / rr : (T)0;
      c[p][nid] = cs;
      s[p][nid] = sn;
      x[p][nid] = kd == hprog::kC ? (cs - sn) * (cs + sn) : cs;
    });
    return r[0];
  }

  // The prefactor of node NID's job (before p0) from its children's powers:
  // (sin)^nc for 'b', norm (cos)^n1 (sin)^n2 for 'c', as hprog::job_seed.
  template <int NID>
  __device__ __forceinline__ T pref(int p, T norm) const {
    constexpr int a = level_of(S, c1_of(S, NID));
    if constexpr (kind_of(S, NID) == hprog::kB) {
      return A[p][a][a];
    } else {
      constexpr int b = level_of(S, c2_of(S, NID));
      return norm * A[p][a][a] * A[p][b][b];
    }
  }

  // Level LV back at its first value (m = 0, or its recurrence's seed at
  // family f), its powers from the level outside it.
  template <int LV>
  __device__ __forceinline__ void restart(const hprog::Prog<T>& pg, int f) {
    constexpr int nid = node_of(S, LV), kd = kind_of(S, nid);
    static_for<NL>([&](auto H) {
      constexpr int hl = decltype(H)::value;
      if constexpr (holds(S, hl, LV)) {
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          if constexpr (LV == lo_of(S, hl)) A[p][hl][LV] = (T)1;
          else A[p][hl][LV] = A[p][hl][LV - 1];
        }
      }
    });
    if constexpr (kd == hprog::kA) {
      neg[LV] = false;
#pragma unroll
      for (int p = 0; p < PT; ++p) pa[p][LV] = cmake<T>((T)0.39894228040143267794, 0);
    } else {
      row[LV] = pg.fam[f];
      const auto cf = hprog::coef_row(pg.coef, row[LV]);
      c1[LV] = cf.x;
      c2[LV] = cf.y;
      c3[LV] = cf.z;
      const T p0 = pg.famr[2 * f];
      const T norm = kd == hprog::kC ? pg.famr[2 * f + 1] : (T)1;
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        pn[p][LV] = this->template pref<nid>(p, norm) * p0;
        pm[p][LV] = 0;
      }
    }
  }

  // One step at level LV: its factor and the powers it moves
  template <int LV>
  __device__ __forceinline__ void step(const hprog::Prog<T>& pg) {
    constexpr int nid = node_of(S, LV), kd = kind_of(S, nid);
    if constexpr (kd == hprog::kA) {
#pragma unroll
      for (int p = 0; p < PT; ++p)
        pa[p][LV] = cmul<T>(pa[p][LV], cmake<T>(c[p][nid], neg[LV] ? -s[p][nid] : s[p][nid]));
    } else {
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        const T pp = t_fma(t_fma(x[p][nid], c1[LV], c2[LV]), pn[p][LV], -c3[LV] * pm[p][LV]);
        pm[p][LV] = pn[p][LV];
        pn[p][LV] = pp;
      }
      const auto cf = hprog::coef_row(pg.coef, ++row[LV]);  // the next step's, ahead
      c1[LV] = cf.x;
      c2[LV] = cf.y;
      c3[LV] = cf.z;
    }
    static_for<NL>([&](auto H) {
      constexpr int hl = decltype(H)::value;
      if constexpr (holds(S, hl, LV)) {
        constexpr int cn = node_of(S, hl), par = parent_of(S, cn);
        constexpr bool cosb = base_is_cos(S, cn);
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          const T base = cosb ? c[p][par] : s[p][par];
          A[p][hl][LV] *= base;
          if constexpr (kd == hprog::kC) A[p][hl][LV] *= base;  // a 'c' step: degree + 2
        }
      }
    });
  }

  // prod[lv] for lv >= first
  __device__ __forceinline__ void products(int first) {
    static_for<NL>([&](auto L) {
      constexpr int lv = decltype(L)::value;
      constexpr int kd = kind_of(S, node_of(S, lv));
      if (lv >= first) {
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          if constexpr (lv == 0) {
            prod[p][0] = pa[p][0];  // level 0 is a leaf, an 'a' node
          } else if constexpr (kd == hprog::kA) {
            prod[p][lv] = cmul<T>(prod[p][lv - 1], pa[p][lv]);
          } else {
            prod[p][lv] = cscale<T>(prod[p][lv - 1], pn[p][lv]);
          }
        }
      }
    });
  }

  // From the previous child state to the next: op = the level that steps
  // (| 256: switches to the negative chain), every level inside it
  // restarted (op < 0: every level restarted, the walk's first child state)
  __device__ __forceinline__ void advance(const hprog::Prog<T>& pg, int op, int4 wf) {
    const int lvc = op < 0 ? -1 : (op & 255);
    const bool flip = op >= 256;
    static_for<NL>([&](auto L) {
      constexpr int lv = decltype(L)::value;
      if (lv == lvc) {
        if (flip) {
          this->template restart<lv>(pg, fam_at<lv>(wf));
          neg[lv] = true;
        }
        this->template step<lv>(pg);
      } else if (lv > lvc) {
        this->template restart<lv>(pg, fam_at<lv>(wf));
      }
    });
    products(lvc < 0 ? 0 : lvc);
  }

  // Every level rebuilt at a child state from its first values by its steps
  // ws (m for an 'a' level), outer levels first: a few-point lane's first
  // child state
  __device__ __forceinline__ void replay(const hprog::Prog<T>& pg, int4 wf, int4 ws) {
    static_for<NL>([&](auto L) {
      constexpr int lv = decltype(L)::value;
      constexpr bool a_level = kind_of(S, node_of(S, lv)) == hprog::kA;
      const int st = lv == 0 ? ws.x : lv == 1 ? ws.y : ws.z;
      this->template restart<lv>(pg, fam_at<lv>(wf));
      if constexpr (a_level) neg[lv] = st < 0;
      const int n_st = st < 0 ? -st : st;
      for (int i = 0; i < n_st; ++i) this->template step<lv>(pg);
    });
    products(0);
  }

  // The root's seed for each point, its family's p0 and prefactor constant
  // given
  __device__ __forceinline__ void root_seed(T p0, T norm, T (&r0)[PT]) const {
    constexpr bool c_root = kind_of(S, 0) == hprog::kC;
#pragma unroll
    for (int p = 0; p < PT; ++p) r0[p] = this->template pref<0>(p, c_root ? norm : (T)1) * p0;
  }
};

// A child state's root: its family's p0 and prefactor constant, its first
// coefficient row (wroot [n_cs][8])
template <typename T>
struct Root {
  T p0, norm;
  c2_t<T> c12;
  T c3;
};
__device__ __forceinline__ Root<float> load_root(const float* wroot, int e) {
  const float4 a = reinterpret_cast<const float4*>(wroot)[2 * e];
  const float4 b = reinterpret_cast<const float4*>(wroot)[2 * e + 1];
  return Root<float>{a.x, a.y, make_float2(a.z, a.w), b.x};
}
__device__ __forceinline__ Root<double> load_root(const double* wroot, int e) {
  const double2 a = reinterpret_cast<const double2*>(wroot)[4 * e];
  const double2 b = reinterpret_cast<const double2*>(wroot)[4 * e + 1];
  const double2 c = reinterpret_cast<const double2*>(wroot)[4 * e + 2];
  return Root<double>{a.x, a.y, b, c.x};
}
__device__ __forceinline__ float3 root_coef(const Root<float>& r) {
  return make_float3(r.c12.x, r.c12.y, r.c3);
}
__device__ __forceinline__ double3 root_coef(const Root<double>& r) {
  return make_double3(r.c12.x, r.c12.y, r.c3);
}

}  // namespace
