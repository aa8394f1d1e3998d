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
// with the child states cs of ops/harmonic_program.py (the density in its
// program order), f_root the root's factor run by its recurrence in
// registers (the prefactor folded into the seed), rad_l = hm_l
// exp(min(he_l, lim)) from a K5 launch in its h-only mode (the clamp of
// biem/_eval_fused.py::_h_clamped, so an underflowed density never meets an
// overflowed h), and Y_child(cs) the product of the subtree's factors from
// the evaluator (harmonics.cuh).  A root 'a' (2D) is one child state whose
// entries are its orders m (rad_{|m|}).
//
// Two modes, chosen by the shape of the call (the wrapper: P K below
// 4 x 132, as KA's).  Many points (harmonic_eval_kernel): one thread per
// (point, k), 128 points a CTA, the balls in order (a call with too few
// CTAs to fill the card splits the balls over grid.z, bpz a slice, each
// slice writing its balls' own outputs);
// the density of ball b (in program order) and the radial table of each
// thread (n_end values, strided by thread) in shared memory.  The density
// comes in windows of `wwin` entries (all H of them when they fit beside
// the radial table), loaded as the child states reach them; a radial
// table too large for shared memory beside a window (n_end in the
// hundreds) goes to a scratch in device memory, strided by the grid's
// threads.  Every thread walks the same child states and steps (uniform
// loads of the program and the density); nothing of size [P, B, H]
// reaches device memory.  The sum over balls is in order (or one output per ball), so
// results repeat bit for bit.  Few points: see harmonic_eval_few_kernel.
//
// What bounds it: operations, ~8 real per harmonic and (point, ball) for
// the root's recurrence and the product with the density, plus the subtree
// factors once per child state (from their seeds: a recurrence per 'b' or
// 'c' node, powers of e^{i phi} for an 'a' node).
#include "hankel.cuh"
#include "harmonics.cuh"

namespace {

// where rad_l comes from: K5's table (hm, he), or the chain of hankel.cuh
// on a real or a complex k r (d = 3)
constexpr int kRadTable = 0, kRadReal = 1, kRadComplex = 2;
constexpr int kThreads = 128;     // many-point mode
constexpr int kFewThreads = 256;  // few-point mode: 8 warps
constexpr int kFewWarps = kFewThreads / 32;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
harmonic_eval_kernel(const T* __restrict__ x, long long sxd, long long sxk, long long sxp,
                     int kx, const T* __restrict__ centers_all, long long sck,
                     const c2_t<T>* __restrict__ hm, const T* __restrict__ he,
                     const T* __restrict__ kv, T rescale,
                     const c2_t<T>* __restrict__ w, hprog::Prog<T> pg,
                     const int4* __restrict__ cs_tab, const int* __restrict__ csjob,
                     c2_t<T>* __restrict__ out, int P, int K, int B, int n, int H, int n_cs,
                     int d, int root_step, int per_ball, int bpz, T lim, int wwin,
                     c2_t<T>* __restrict__ hs_glob) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* Ws = reinterpret_cast<T2*>(smem_raw);  // [wwin]
  const int tid = threadIdx.x;
  // the thread's radial table: [n][kThreads] in shared memory after Ws, or
  // [n][the grid's threads] in hs_glob
  const size_t hst = hs_glob ? (size_t)gridDim.x * gridDim.y * gridDim.z * kThreads : kThreads;
  T2* Hs = hs_glob ? hs_glob + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                                blockIdx.x) * kThreads + tid
                   : Ws + wwin + tid;

  const int k = blockIdx.y;
  const int p = blockIdx.x * kThreads + tid;
  const bool live = p < P;
  const T* centers = centers_all + k * sck;
  T px[hprog::kMaxNodes + 1];
  for (int i = 0; i < d; ++i)
    px[i] = live ? x[(long long)i * sxd + (kx == 1 ? 0LL : (long long)k * sxk) + (long long)p * sxp]
                 : (T)0;
  int kind[hprog::kMaxNodes];
  hprog::node_kinds<T>(pg, kind);
  const int root_kind = kind[0];
  T2 total = cmake<T>(0, 0);

  const int b1 = (blockIdx.z + 1) * bpz < B ? (blockIdx.z + 1) * bpz : B;
  for (int b = blockIdx.z * bpz; b < b1; ++b) {
    const T2* wb = w + ((size_t)k * B + b) * H;
    T v[hprog::kMaxNodes + 1];
    for (int i = 0; i < d; ++i) v[i] = px[i] - centers[(size_t)b * d + i];
    T ax[hprog::kMaxNodes], ac[hprog::kMaxNodes], as[hprog::kMaxNodes];
    const T r = hprog::tree_angles<T>(pg, v, ax, ac, as);
    if constexpr (R == kRadTable) {
      const size_t hoff = (((size_t)k * P + (live ? p : 0)) * B + b) * n;
      for (int l = 0; l < n; ++l) {
        const T2 m = hm[hoff + l];
        const T s = t_exp(he[hoff + l] < lim ? he[hoff + l] : lim);
        Hs[l * hst] = live ? cscale<T>(m, s) : cmake<T>(0, 0);
      }
    } else {
      h_chain<T, 0, R == kRadComplex>(
          k_times<T, R == kRadComplex>(k_of<T, R == kRadComplex>(kv, k), r), n, lim,
          t_exp(lim), rescale, t_log(rescale),
          [&](int l, T2 h) { Hs[l * hst] = live ? h : cmake<T>(0, 0); });
    }

    T2 ub = cmake<T>(0, 0);
    int wlo = -1;  // the window's first entry (none yet for this ball)
    for (int cs = 0; cs < n_cs; ++cs) {
      const int4 ci = cs_tab[cs];  // first root job, J, woff, l0
      if (wlo < 0 || ci.z + ci.y > wlo + wwin) {  // uniform: every thread walks cs alike
        __syncthreads();  // every thread is done with the last window
        wlo = ci.z;
        for (int e = tid; e < wwin && wlo + e < H; e += kThreads) Ws[e] = wb[wlo + e];
        __syncthreads();
      }
      const T2* wc = Ws + (ci.z - wlo);
      T2 acc = cmake<T>(0, 0);
      if (root_kind == hprog::kA) {  // orders m = -half..half: powers of e^{i phi}
        const int half = ci.y / 2;
        const T2 z = cmake<T>(ac[0], as[0]);
        T2 f = hprog::a_factor<T>(-half, ac[0], as[0]);
        for (int j = 0; j < ci.y; ++j) {
          const int am = j < half ? half - j : j - half;
          acc = cfma<T>(cmul<T>(f, Hs[am * hst]), wc[j], acc);
          f = cmul<T>(f, z);
        }
        ub = cadd<T>(ub, acc);
        continue;
      }
      const int4 job = pg.jobs[ci.x];
      T pn = hprog::job_seed<T>(pg, root_kind, job, ac[0], as[0]), pm = 0;
      const int row = pg.fam[job.x];
      for (int j = 0; j < ci.y; ++j) {
        const T2 pr = cscale<T>(Hs[(ci.w + root_step * j) * hst], pn);
        acc = cfma<T>(pr, wc[j], acc);
        if (j + 1 < ci.y) hprog::jacobi_step<T>(pg, row + j, ax[0], pn, pm);
      }
      const T2 y = hprog::factor_product<T>(pg, kind, csjob + (size_t)cs * pg.n_nodes, 1,
                                                 ax, ac, as);
      ub = cfma<T>(acc, y, ub);
    }
    if (per_ball) {
      if (live) out[((size_t)p * K + k) * B + b] = ub;
    } else {
      total = cadd<T>(total, ub);
    }
  }
  if (!per_ball && live) out[(size_t)p * K + k] = total;
}

// Few points (P K below the wrapper's threshold, e.g. uscat(0)): a CTA per
// (point, k) and slice of bpz balls (grid.y); its warps take the slice's
// balls (warp w: balls w, w + 8, ...), the lanes the child states (a root
// 'a': its entries), the warp's radial table in shared memory; a fixed
// shuffle tree sums the lanes and the CTA its warps in order into one sum
// per slice (the wrapper sums the slices), so results repeat bit for bit.
template <typename T, int R>
__global__ void __launch_bounds__(kFewThreads)
harmonic_eval_few_kernel(const T* __restrict__ x, long long sxd, long long sxk, long long sxp,
                         int kx, const T* __restrict__ centers_all, long long sck,
                         const c2_t<T>* __restrict__ hm, const T* __restrict__ he,
                         const T* __restrict__ kv, T rescale,
                         const c2_t<T>* __restrict__ w, hprog::Prog<T> pg,
                         const int4* __restrict__ cs_tab, const int* __restrict__ csjob,
                         c2_t<T>* __restrict__ out, int P, int K, int B, int n, int H, int n_cs,
                         int d, int root_step, int per_ball, int bpz, T lim) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* Hw = reinterpret_cast<T2*>(smem_raw);  // [warps][n]
  T2* part = Hw + kFewWarps * n;             // [warps]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.x / K, k = blockIdx.x % K;
  const T* centers = centers_all + k * sck;
  T px[hprog::kMaxNodes + 1];
  for (int i = 0; i < d; ++i)
    px[i] = x[(long long)i * sxd + (kx == 1 ? 0LL : (long long)k * sxk) + (long long)p * sxp];
  int kind[hprog::kMaxNodes];
  hprog::node_kinds<T>(pg, kind);
  const int root_kind = kind[0];
  T2* H_ = Hw + warp * n;
  T2 wsum = cmake<T>(0, 0);

  const int b1 = (blockIdx.y + 1) * bpz < B ? (blockIdx.y + 1) * bpz : B;
  for (int b = blockIdx.y * bpz + warp; b < b1; b += kFewWarps) {
    T v[hprog::kMaxNodes + 1];
    for (int i = 0; i < d; ++i) v[i] = px[i] - centers[(size_t)b * d + i];
    T ax[hprog::kMaxNodes], ac[hprog::kMaxNodes], as[hprog::kMaxNodes];
    const T r = hprog::tree_angles<T>(pg, v, ax, ac, as);
    if constexpr (R == kRadTable) {
      const size_t hoff = (((size_t)k * P + p) * B + b) * n;
      for (int l = lane; l < n; l += 32) {
        const T s = t_exp(he[hoff + l] < lim ? he[hoff + l] : lim);
        H_[l] = cscale<T>(hm[hoff + l], s);
      }
    } else {  // every lane runs the chain (uniform branches); lane l % 32 keeps h_l
      h_chain<T, 0, R == kRadComplex>(
          k_times<T, R == kRadComplex>(k_of<T, R == kRadComplex>(kv, k), r), n, lim,
          t_exp(lim), rescale, t_log(rescale),
          [&](int l, T2 h) { if ((l & 31) == lane) H_[l] = h; });
    }
    __syncwarp();
    const T2* wb = w + ((size_t)k * B + b) * H;
    T2 acc_l = cmake<T>(0, 0);
    if (root_kind == hprog::kA) {
      const int4 ci = cs_tab[0];
      for (int j = lane; j < ci.y; j += 32) {
        const int m = pg.jobs[ci.x + j].z;
        const T2 f = hprog::a_factor<T>(m, ac[0], as[0]);
        acc_l = cfma<T>(cmul<T>(f, H_[m < 0 ? -m : m]), wb[ci.z + j], acc_l);
      }
    } else {
      for (int cs = lane; cs < n_cs; cs += 32) {
        const int4 ci = cs_tab[cs];
        const int4 job = pg.jobs[ci.x];
        T pn = hprog::job_seed<T>(pg, root_kind, job, ac[0], as[0]), pm = 0;
        const int row = pg.fam[job.x];
        T2 acc = cmake<T>(0, 0);
        for (int j = 0; j < ci.y; ++j) {
          acc = cfma<T>(cscale<T>(H_[ci.w + root_step * j], pn), wb[ci.z + j], acc);
          if (j + 1 < ci.y) hprog::jacobi_step<T>(pg, row + j, ax[0], pn, pm);
        }
        const T2 y = hprog::factor_product<T>(pg, kind, csjob + (size_t)cs * pg.n_nodes, 1,
                                              ax, ac, as);
        acc_l = cfma<T>(acc, y, acc_l);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {  // fixed tree: lane 0 holds the sum
      acc_l.x += __shfl_down_sync(0xffffffffu, acc_l.x, off);
      acc_l.y += __shfl_down_sync(0xffffffffu, acc_l.y, off);
    }
    if (per_ball) {
      if (lane == 0) out[((size_t)p * K + k) * B + b] = acc_l;
    } else {
      wsum = cadd<T>(wsum, acc_l);
    }
    __syncwarp();  // H_ is rewritten for the warp's next ball
  }
  if (per_ball) return;
  if (lane == 0) part[warp] = wsum;
  __syncthreads();
  if (tid == 0) {  // the sum of this CTA's slice of balls (one slice: of all)
    T2 s = cmake<T>(0, 0);
    for (int i = 0; i < kFewWarps; ++i) s = cadd<T>(s, part[i]);
    out[((size_t)p * K + k) * gridDim.y + blockIdx.y] = s;
  }
}

template <typename T, int R>
cudaError_t run(const void* x, long long sxd, long long sxk, long long sxp, int kx,
                const void* centers, long long sck, const void* hm, const void* he,
                const void* kv, double rescale,
                const void* w, const void* nodes, const void* jobs, const void* fam,
                const void* coef, const void* famr, int n_nodes, const void* cs,
                const void* csjob, void* out, int P, int K, int B, int n, int H, int n_cs,
                int d, int root_step, int per_ball, int few, int bpz, double lim, int wwin,
                void* hs_glob, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (P == 0 || K == 0) return cudaSuccess;
  if (n_nodes > hprog::kMaxNodes) return cudaErrorInvalidValue;
  hprog::Prog<T> pg{static_cast<const int4*>(nodes), static_cast<const int4*>(jobs),
                    static_cast<const int*>(fam), static_cast<const T*>(coef),
                    static_cast<const T*>(famr), n_nodes};
  if (few) {
    const size_t smem = sizeof(T2) * ((size_t)kFewWarps * n + kFewWarps);
    auto kernel = harmonic_eval_few_kernel<T, R>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((unsigned)((long long)P * K), (B + bpz - 1) / bpz), kFewThreads, smem,
             stream>>>(
        static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers), sck,
        static_cast<const T2*>(hm), static_cast<const T*>(he), static_cast<const T*>(kv),
        (T)rescale, static_cast<const T2*>(w), pg, static_cast<const int4*>(cs),
        static_cast<const int*>(csjob), static_cast<T2*>(out), P, K, B, n, H, n_cs, d, root_step,
        per_ball, bpz, (T)lim);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(T2) * ((size_t)wwin + (hs_glob ? 0 : (size_t)n * kThreads));
  auto kernel = harmonic_eval_kernel<T, R>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kThreads - 1) / kThreads, K, (B + bpz - 1) / bpz);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sxd, sxk, sxp, kx, static_cast<const T*>(centers), sck,
      static_cast<const T2*>(hm), static_cast<const T*>(he), static_cast<const T*>(kv),
      (T)rescale, static_cast<const T2*>(w), pg, static_cast<const int4*>(cs),
      static_cast<const int*>(csjob), static_cast<T2*>(out), P, K, B, n, H, n_cs, d, root_step,
      per_ball, bpz, (T)lim, wwin, static_cast<T2*>(hs_glob));
  return cudaGetLastError();
}


template <typename T>
cudaError_t run_rad(int rad, const void* x, long long sxd, long long sxk, long long sxp, int kx,
                    const void* centers, long long sck, const void* hm, const void* he,
                    const void* kv, double rescale, const void* w, const void* nodes,
                    const void* jobs, const void* fam, const void* coef, const void* famr,
                    int n_nodes, const void* cs, const void* csjob, void* out, int P, int K,
                    int B, int n, int H, int n_cs, int d, int root_step, int per_ball, int few,
                    int bpz, double lim, int wwin, void* hs_glob, cudaStream_t stream) {
  if (rad == kRadReal)
    return run<T, kRadReal>(x, sxd, sxk, sxp, kx, centers, sck, hm, he, kv, rescale, w, nodes,
                            jobs, fam, coef, famr, n_nodes, cs, csjob, out, P, K, B, n, H, n_cs,
                            d, root_step, per_ball, few, bpz, lim, wwin, hs_glob, stream);
  if (rad == kRadComplex)
    return run<T, kRadComplex>(x, sxd, sxk, sxp, kx, centers, sck, hm, he, kv, rescale, w,
                               nodes, jobs, fam, coef, famr, n_nodes, cs, csjob, out, P, K, B, n,
                               H, n_cs, d, root_step, per_ball, few, bpz, lim, wwin, hs_glob,
                               stream);
  return run<T, kRadTable>(x, sxd, sxk, sxp, kx, centers, sck, hm, he, kv, rescale, w, nodes,
                           jobs, fam, coef, famr, n_nodes, cs, csjob, out, P, K, B, n, H, n_cs,
                           d, root_step, per_ball, few, bpz, lim, wwin, hs_glob, stream);
}

}  // namespace

// x [d, Kx, P] by strides; centers [K, B, d] with (B, d) contiguous at k
// stride sck (0: shared); rad 0: hm / he [K, P, B, n] (K5's h-only outputs
// at k |x - c_b|), rad 1 / 2 (d = 3): the chain on k [K] real / complex
// (interleaved) with `rescale`; w [K, B, H] in program order; the
// program's tables (ops/harmonic_program.py); out [P, K, B] (per_ball), or
// summed: [P, K, slices] (few-point mode, slices of bpz balls) or [P, K]
// (many-point mode, bpz = B).  Many-point mode: wwin the density's window
// (entries, at least every child state's), hs_glob null (the radial
// tables in shared memory) or a scratch of n times the grid's threads.
extern "C" int bhs_harmonic_eval(const void* x, long long sxd, long long sxk, long long sxp,
                                 int kx, const void* centers, long long sck, int rad,
                                 const void* hm, const void* he, const void* kv, double rescale,
                                 const void* w, const void* nodes, const void* jobs,
                                 const void* fam, const void* coef, const void* famr,
                                 int n_nodes, const void* cs, const void* csjob, void* out,
                                 int P, int K, int B, int n, int H, int n_cs, int d,
                                 int root_step, int per_ball, int few, int bpz, double lim,
                                 int wwin, void* hs_glob, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run_rad<double>(rad, x, sxd, sxk, sxp, kx, centers, sck, hm, he, kv, rescale, w,
                                nodes, jobs, fam, coef, famr, n_nodes, cs, csjob, out, P, K, B,
                                n, H, n_cs, d, root_step, per_ball, few, bpz, lim, wwin, hs_glob,
                                st);
  return (int)run_rad<float>(rad, x, sxd, sxk, sxp, kx, centers, sck, hm, he, kv, rescale, w,
                             nodes, jobs, fam, coef, famr, n_nodes, cs, csjob, out, P, K, B, n,
                             H, n_cs, d, root_step, per_ball, few, bpz, lim, wwin, hs_glob, st);
}
