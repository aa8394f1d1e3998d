// K3: the rotation D(R) of every direction, degree block by degree block.
//
// Replaces no Pallas kernel: the JAX package computes D by quadrature in
// XLA (biem_helmholtz_sphere_tpu/translation/_rotation.py:251-294,
// rotation_blocks).  The plain version is translation/_rotation.py::
// _rotation_blocks_plain.  For each direction n and root-degree block l
// (g = harm_n_ndim(l, d) rows at offset o):
//
//   D_l[n][i, j] = sum_q ycw[q, o + i] Y_{o + j}(R_n^T s_q)
//
// with ycw = conj(Y) w at the quadrature nodes s_q (cached on the card, in
// `_rot_ycw`'s layout: chunk-major lines of 32 nodes, each block's rows
// padded to 8) and R_n the rotation taking the root axis to the direction
// (`_rotation_to_axis`, [N, d, d]).  Only exact degree blocks are
// computed: the zeros between the blocks of a degree group hold by
// construction (the wrapper's buffer starts at zero), which is the mask
// the plain version applies.  Each entry is written to both forms the
// callers read: the degree groups (`RotationD.blocks`, the sandwich's) and
// the packed blocks (`RotationD.packed`, KB's).
//
// What bounds it: operations, 8 N Q sum_l g_l^2 real ones (a contraction:
// the FP32 CUDA cores, or the FP64 tensor cores in complex128), beside
// which the harmonics at each direction's rotated nodes are ~16 N Q H
// (chip_smoke.py::k3_bound).
//
// The design (translation/_rotation.py::_k3_plan, _k3_jobs, _k3_slab):
// - One harmonic generation per direction.  rotated_harmonics_kernel, a
//   thread per (direction, node), rotates the node, takes its angles and
//   evaluates every harmonic of the tree there by the program's child
//   states (ops/harmonic_program.py: the subtree's factors once per child
//   state, the root's recurrence through its degrees; e^{i m phi} by a
//   double sincos), H values a thread, into a scratch of lines.  Generating
//   them inside the product, a degree block at a time, costs ~sum_l l^2
//   recurrence steps a node where the whole tree costs ~H: producer warps
//   doing so were latency-bound and took 2.9-9x the product (PERF.md, PR
//   16).  The nodes go in slabs of at most _K3_SCRATCH bytes of harmonics.
// - Work sized to the block.  A block's columns of every direction sit
//   side by side (column n g + j is direction n's column j: conj(Y) w is
//   the same for every direction), cut into strips of W columns; its rows
//   into shares of at most 64, a multiple of 8.  A CTA computes one share
//   of one strip: its product is padded to 8 rows and 4 (complex64) or 16
//   (complex128) columns only, not to 64 x 64 tiles (3D blocks have at most
//   2 l + 1 rows; 64 x 64 tiles computed 3.0x the needed entries at
//   n_end = 32 and 8.5x at n_end = 19).  Every share of a strip reads the
//   same generated harmonics.
// - The loads under the product.  Per chunk of 32 nodes a CTA needs its
//   strip's lines of harmonics and its share's lines of conj(Y) w.  Both
//   lie chunk-major in device memory, in the lines of shared memory
//   (padding included), so they arrive as one cp.async.bulk per direction
//   of the strip and one for the share (a copy a line added half the
//   product's time: small copies are slow), issued by warp 0's lanes two chunks
//   ahead into a ring of 3 stages; full mbarriers (the expected bytes) and
//   empty ones (the 8 warps' releases) take the place of CTA barriers.
//   Persistent: a CTA an SM walks its units, the loads running ahead
//   across them.
// - The product: complex64 an 8 x 4 register tile a thread on the FP32
//   CUDA cores (no TF32), 16-byte loads of two nodes; complex128 on the
//   FP64 tensor cores (DMMA m16n8k8, mma_f64.cuh) as D^T = Y^T conj(Y) w:
//   a warp's 4 slots of 16 columns x 8 rows, the real and imaginary planes
//   in four real products, read in fragment order from lines of 36 (no
//   select).  Both sum in two levels, 64 nodes apart, then their partials
//   (one sequence over ~10^4 nodes left D D^H - I at 4.7x the plain
//   version's), slab after slab into D.
// Each entry is summed by one thread in a fixed order (no atomics), so
// results repeat bit for bit.
#include <cstdint>
#include <type_traits>

#include "harmonics.cuh"
#include "mma_f64.cuh"

namespace {

constexpr int kQ = 32;  // nodes a chunk (_K3_KQ)
constexpr int kThreads = 256;
constexpr int kStages = 3;

// per dtype: a line's stride (a chunk's nodes and padding, so that a
// warp's 16-byte loads of consecutive lines miss no bank twice) and a ring
// stage's lines (_K3_LINES)
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int S = kQ + 2, kLines = 280;
};
template <> struct Cfg<double> {
  static constexpr int S = kQ + 4, kLines = 128;
};

// per block (_K3Plan.info): o, g, group size G, row in the group, first
// row of ycw, strip columns W; the group's entries before it per
// direction, the packed offset of the block
struct BlockInfo {
  int o, g, G, oi, op, W;
  long long gpre, voff;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {  // x^n by squaring
  T r = 1;
  for (; n; n >>= 1, x *= x)
    if (n & 1) r *= x;
  return r;
}

// A job's seed: its prefactor (powers by squaring) times p_0
template <typename T>
__device__ __forceinline__ T seed(const hprog::Prog<T>& pg, int kind, int4 job, T c, T s) {
  const T pref = kind == hprog::kB ? ipow<T>(s, job.z)
                                   : pg.famr[2 * job.x + 1] * ipow<T>(c, job.z) * ipow<T>(s, job.w);
  return pref * pg.famr[2 * job.x];
}

// The subtree's factors of a child state (nodes but the root, node 0) at
// the jobs job_of[nid]: a 'b'/'c' node by its recurrence from the seed, an
// 'a' node's e^{i m phi} / sqrt(2 pi) in double from phi (atan2 of the
// node's (s, c), once a point), then rounded to T (e^{i phi}'s powers in T
// doubled D D^H - I in complex64)
template <typename T>
__device__ __forceinline__ c2_t<T> subtree_factor(const hprog::Prog<T>& pg, const int* kind,
                                                  const int* __restrict__ job_of, const T* ax,
                                                  const T* ac, const T* as, const double* phi) {
  c2_t<T> y = cmake<T>(1, 0);
  for (int nid = 1; nid < pg.n_nodes; ++nid) {
    const int4 job = pg.jobs[job_of[nid]];
    if (kind[nid] == hprog::kA) {
      double sn, cs;
      sincos(job.z * phi[nid], &sn, &cs);
      y = cmul<T>(y, cmake<T>((T)(0.39894228040143267794 * cs), (T)(0.39894228040143267794 * sn)));
    } else {
      T pn = seed<T>(pg, kind[nid], job, ac[nid], as[nid]), pm = 0;
      const int row = pg.fam[job.x];
      for (int j = 0; j < job.y; ++j) hprog::jacobi_step<T>(pg, row + j, ax[nid], pn, pm);
      y = cscale<T>(y, pn);
    }
  }
  return y;
}

// Every harmonic at every direction's rotated nodes q0 .. q0 + qn - 1:
// harm [qn / 32][N][H][S], chunk-major in K3's lines (a padding node past
// Q repeats the last; conj(Y) w is 0 there); a complex64 line (272 bytes,
// straddling 32-byte sectors) written whole, its padding too (lines
// written in part cut the write rate by a quarter)
template <typename T>
__global__ void __launch_bounds__(128)
rotated_harmonics_kernel(const T* __restrict__ s_cart, const T* __restrict__ rot,
                         hprog::Prog<T> pg, const int4* __restrict__ cs_tab,
                         const int* __restrict__ csjob, const long long* __restrict__ perm,
                         int n_cs, c2_t<T>* __restrict__ harm, int N, int Q, int q0, int qn,
                         int H, int d) {
  const long long e = (long long)blockIdx.x * 128 + threadIdx.x;
  if (e >= (long long)N * qn) return;
  const int n = (int)(e / qn), ql = (int)(e % qn);
  const int q = q0 + ql < Q ? q0 + ql : Q - 1;
  const T* R = rot + (size_t)n * d * d;
  T v[hprog::kMaxNodes + 1];
  for (int j = 0; j < d; ++j) {  // (R^T s)_j = sum_i R[i, j] s_i
    T sj = 0;
    for (int i = 0; i < d; ++i) sj = t_fma(R[i * d + j], s_cart[(size_t)i * Q + q], sj);
    v[j] = sj;
  }
  T ax[hprog::kMaxNodes], ac[hprog::kMaxNodes], as[hprog::kMaxNodes];
  hprog::tree_angles<T>(pg, v, ax, ac, as);
  int kind[hprog::kMaxNodes];
  hprog::node_kinds<T>(pg, kind);
  double phi[hprog::kMaxNodes];
  for (int nid = 1; nid < pg.n_nodes; ++nid)
    phi[nid] = kind[nid] == hprog::kA ? atan2((double)as[nid], (double)ac[nid]) : 0.0;
  c2_t<T>* out = harm + ((size_t)(ql / kQ) * N + n) * H * Cfg<T>::S + ql % kQ;
  for (int cs = 0; cs < n_cs; ++cs) {
    const int4 ci = cs_tab[cs];  // first root job, J, first entry, l0
    const c2_t<T> y =
        subtree_factor<T>(pg, kind, csjob + (size_t)cs * pg.n_nodes, ax, ac, as, phi);
    const int4 job = pg.jobs[ci.x];
    T pn = seed<T>(pg, kind[0], job, ac[0], as[0]), pm = 0;
    const int row = pg.fam[job.x];
    for (int j = 0; j < ci.y; ++j) {
      c2_t<T>* line = out + (size_t)perm[ci.z + j] * Cfg<T>::S;
      line[0] = cscale<T>(y, pn);
      if constexpr (Cfg<T>::S * sizeof(c2_t<T>) % 32 != 0)  // whole lines, whole sectors
        if (ql % kQ < Cfg<T>::S - kQ) line[kQ] = cmake<T>(0, 0);
      if (j + 1 < ci.y) hprog::jacobi_step<T>(pg, row + j, ax[0], pn, pm);
    }
  }
}

// shared memory of a CTA: the ring (per stage the strip's W lines of
// harmonics, then the share's lines of conj(Y) w), the stages' full and
// empty barriers
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(c2_t<T>) * kStages * Cfg<T>::kLines * Cfg<T>::S +
         sizeof(uint64_t) * 2 * kStages;
}

// One unit of work (_k3_jobs): a share of one strip of one block
struct Unit {
  BlockInfo bi;
  int c0, r0, nr, wu, nr8;
};
__device__ __forceinline__ Unit unit_at(const BlockInfo* __restrict__ blocks,
                                        const int4* __restrict__ desc, int k, int N) {
  const int4 dc = desc[k];  // block, the strip's first column, the share's first row, rows
  Unit u;
  u.bi = blocks[dc.x];
  u.c0 = dc.y;
  u.r0 = dc.z;
  u.nr = dc.w;
  u.wu = min(u.bi.W, N * u.bi.g - u.c0);
  u.nr8 = (u.nr + 7) & ~7;
  return u;
}

// Persistent: a CTA an SM takes units blockIdx.x, + gridDim.x, ... (the
// largest blocks first), step by step (unit, chunk of 32 nodes), the loads
// running two steps ahead across units, so that a unit's stores overlap the
// next one's loads (a CTA a unit spent its start and end with the SM idle:
// 3D units hold 8-24 chunks).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rotation_blocks_kernel(const c2_t<T>* __restrict__ ycw, const c2_t<T>* __restrict__ harm,
                       const BlockInfo* __restrict__ blocks, const int4* __restrict__ desc,
                       int n_units, c2_t<T>* __restrict__ grp, c2_t<T>* __restrict__ packed,
                       int N, int hp, int H, int q0, int qn, int first, int last,
                       long long nnz) {
  using T2 = c2_t<T>;
  constexpr int S = Cfg<T>::S, kLines = Cfg<T>::kLines;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T2* ring = reinterpret_cast<T2*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)kStages * kLines * S);
  uint64_t* empty = full + kStages;

  const int nq = qn / kQ;
  const int my_units =
      (int)blockIdx.x < n_units ? (n_units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int n_steps = my_units * nq;
  const size_t stage = (size_t)kLines * S;
  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);  // warp 0's expected bytes
      mbar_init(&empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step t's lines into its stage, as they lie in device memory: the
  // strip's columns a bulk copy per direction n (block columns ja..jb-1:
  // harm's lines of chunk c, direction n, harmonics o + ja..), then the
  // share's rows of conj(Y) w in one, across warp 0's lanes
  auto issue = [&](int t) {
    const Unit u = unit_at(blocks, desc, blockIdx.x + (t / nq) * gridDim.x, N);
    const int c = t % nq, st = t % kStages, g = u.bi.g;
    const int n_a = u.c0 / g, n_dirs = (u.c0 + u.wu - 1) / g - n_a + 1;
    T2* line0 = ring + st * stage;
    if (lane == 0) mbar_arrive_tx(&full[st], (u.wu + u.nr8) * S * sizeof(T2));
    __syncwarp();
    for (int k = lane; k <= n_dirs; k += 32) {
      if (k == n_dirs) {
        bulk_load(line0 + (size_t)u.bi.W * S,
                  ycw + ((size_t)(q0 / kQ + c) * hp + u.bi.op + u.r0) * S,
                  u.nr8 * S * sizeof(T2), &full[st]);
      } else {
        const int n = n_a + k;
        const int ja = max(0, u.c0 - n * g), jb = min(g, u.c0 + u.wu - n * g);
        bulk_load(line0 + (size_t)(n * g + ja - u.c0) * S,
                  harm + (((size_t)c * N + n) * H + u.bi.o + ja) * S,
                  (jb - ja) * S * sizeof(T2), &full[st]);
      }
    }
  };
  if (wp == 0)
    for (int t = 0; t < kStages - 1 && t < n_steps; ++t) issue(t);

  // warp 0 issues step t + 2 once every warp is done with step t - 1,
  // whose stage it takes; each warp then waits for step t
  auto next = [&](int t) {
    if (wp == 0 && t + kStages - 1 < n_steps) {
      if (t >= 1) mbar_wait(&empty[(t - 1) % kStages], ((t - 1) / kStages) & 1);
      issue(t + kStages - 1);
    }
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
  };
  auto release = [&](int t) {  // this warp is done with step t
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % kStages]);
  };
  // D's entry (share row i, strip column cc) of unit u: the slab's sum
  // added to the earlier slabs' in the degree groups; both forms written
  // at the last
  auto store = [&](const Unit& un, int i, int cc, T2 v) {
    if (i < un.nr && cc < un.wu) {
      const int n = (un.c0 + cc) / un.bi.g, j = (un.c0 + cc) % un.bi.g;
      const long long G = un.bi.G;
      T2* g = grp + un.bi.gpre * N + n * G * G + (un.bi.oi + un.r0 + i) * G + un.bi.oi + j;
      if (!first) v = cadd<T>(*g, v);
      *g = v;
      if (last) packed[n * nnz + un.bi.voff + (long long)(un.r0 + i) * un.bi.g + j] = v;
    }
  };

  Unit u{};
  if constexpr (std::is_same<T, double>::value) {
    // warp wp takes slots 4 wp .. 4 wp + 3 of the share's (16 columns, 8
    // rows) slots, column-tile major; D^T[16 x 8] += Y^T A (m16n8k8), the
    // planes as D_re += Yr Ar - Yi Ai, D_im += Yr Ai + Yi Ar
    const int g8 = lane >> 2, t4 = lane & 3;
    int rt_n = 1, n_slots = 0;
    double pre[4][4], pim[4][4], are[4][4], aim[4][4];
    for (int t = 0; t < n_steps; ++t) {
      const int c = t % nq;
      if (c == 0) {
        u = unit_at(blocks, desc, blockIdx.x + (t / nq) * gridDim.x, N);
        rt_n = u.nr8 / 8;
        n_slots = rt_n * ((u.wu + 15) / 16);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) pre[s][i] = pim[s][i] = are[s][i] = aim[s][i] = 0;
      }
      next(t);
      const double2* Bs = reinterpret_cast<const double2*>(ring + (t % kStages) * stage);
      const double2* As = Bs + (size_t)u.bi.W * S;
#pragma unroll
      for (int kb = 0; kb < kQ; kb += 8) {
        double yr[4], yi[4];
        int cur = -1;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int k = 4 * wp + s;
          if (k < n_slots) {
            const int mt = k / rt_n, rt = k % rt_n;
            if (mt != cur) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const double2 v =
                    Bs[(size_t)(16 * mt + g8 + 8 * (i & 1)) * S + kb + t4 + 4 * (i >> 1)];
                yr[i] = v.x;
                yi[i] = v.y;
              }
              cur = mt;
            }
            double ar[2], ai[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const double2 w = As[(size_t)(8 * rt + g8) * S + kb + t4 + 4 * i];
              ar[i] = w.x;
              ai[i] = w.y;
            }
            mma_f64(pre[s], yr, ar);
            mma_f64(pim[s], yr, ai);
            mma_f64(pim[s], yi, ar);
            ai[0] = -ai[0];
            ai[1] = -ai[1];
            mma_f64(pre[s], yi, ai);
          }
        }
      }
      release(t);
      if ((c & 1) || c == nq - 1) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            are[s][i] += pre[s][i];
            aim[s][i] += pim[s][i];
            pre[s][i] = pim[s][i] = 0;
          }
      }
      if (c == nq - 1) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int k = 4 * wp + s;
          if (k < n_slots) {
            const int mt = k / rt_n, rt = k % rt_n;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              store(u, 8 * rt + 2 * t4 + (i & 1), 16 * mt + g8 + 8 * (i >> 1),
                    cmake<T>(are[s][i], aim[s][i]));
          }
        }
      }
    }
  } else {
    // thread (tr, tc): rows tr + TR i, columns tc + TC j (neighbouring
    // threads on neighbouring columns: D's rows are stored whole)
    int TR = 1, TC = 1, tr = 0, tc = 0;
    bool live = false;
    float2 part[8][4], acc[8][4];
    for (int t = 0; t < n_steps; ++t) {
      const int c = t % nq;
      if (c == 0) {
        u = unit_at(blocks, desc, blockIdx.x + (t / nq) * gridDim.x, N);
        TR = u.nr8 / 8;
        TC = (u.wu + 3) / 4;
        tc = tid % TC;
        tr = tid / TC;
        live = tr < TR;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = acc[i][j] = make_float2(0.f, 0.f);
      }
      next(t);
      const float2* Bs = reinterpret_cast<const float2*>(ring + (t % kStages) * stage);
      const float2* As = Bs + (size_t)u.bi.W * S;
      if (live) {
#pragma unroll 2
        for (int qq = 0; qq < kQ; qq += 2) {  // two nodes a 16-byte load
          float4 b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(Bs + (size_t)(tc + TC * j) * S + qq);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(As + (size_t)(tr + TR * i) * S + qq);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              part[i][j] = cfma<float>(make_float2(a.x, a.y), make_float2(b[j].x, b[j].y),
                                       part[i][j]);
              part[i][j] = cfma<float>(make_float2(a.z, a.w), make_float2(b[j].z, b[j].w),
                                       part[i][j]);
            }
          }
        }
      }
      release(t);
      if ((c & 1) || c == nq - 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = cadd<float>(acc[i][j], part[i][j]);
            part[i][j] = make_float2(0.f, 0.f);
          }
      }
      if (c == nq - 1 && live) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) store(u, tr + TR * i, tc + TC * j, acc[i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t run(const void* ycw, const void* s_cart, const void* rot, const void* nodes,
                const void* jobs, const void* fam, const void* coef, const void* famr,
                int n_nodes, const void* cs_tab, const void* csjob, const void* perm, int n_cs,
                const void* blocks, const void* desc, int n_cta, void* harm, int slab,
                void* grp, void* packed, int N, int Q, int Qp, int hp, int H, int d,
                long long nnz, cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (N == 0 || n_cta == 0) return cudaSuccess;
  if (n_nodes > hprog::kMaxNodes || Qp % kQ != 0 || slab <= 0 || slab % kQ != 0)
    return cudaErrorInvalidValue;
  hprog::Prog<T> pg{static_cast<const int4*>(nodes), static_cast<const int4*>(jobs),
                    static_cast<const int*>(fam), static_cast<const T*>(coef),
                    static_cast<const T*>(famr), n_nodes};
  constexpr size_t smem = smem_bytes<T>();
  auto kernel = rotation_blocks_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = n_cta < sms ? n_cta : sms;  // persistent: a CTA an SM
  // slab after slab of nodes: the harmonics there, then the CTAs' sums
  for (int q0 = 0; q0 < Qp; q0 += slab) {
    const int qn = Qp - q0 < slab ? Qp - q0 : slab;
    const long long n_thr = (long long)N * qn;
    rotated_harmonics_kernel<T><<<(unsigned)((n_thr + 127) / 128), 128, 0, stream>>>(
        static_cast<const T*>(s_cart), static_cast<const T*>(rot), pg,
        static_cast<const int4*>(cs_tab), static_cast<const int*>(csjob),
        static_cast<const long long*>(perm), n_cs, static_cast<T2*>(harm), N, Q, q0, qn, H, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
        static_cast<const T2*>(ycw), static_cast<const T2*>(harm),
        static_cast<const BlockInfo*>(blocks), static_cast<const int4*>(desc), n_cta,
        static_cast<T2*>(grp), static_cast<T2*>(packed), N, hp, H, q0, qn, q0 == 0,
        q0 + qn >= Qp, nnz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// ycw [Qp / 32, hp, S] complex (`_rot_ycw`: conj(Y) w chunk-major in K3's
// lines, blocks' rows padded to 8, nodes to Qp, a multiple of 32); s_cart
// [d, Q]; rot [N, d, d]; the program's tables (ops/harmonic_program.py:
// nodes, jobs, fam, coef, famr, the child states cs [n_cs, 4], csjob
// [n_cs, n_nodes], perm [H] int64); K3's plan (translation/_rotation.py::
// _k3_plan, _k3_jobs): blocks [n_blocks] of BlockInfo (12 int32 each),
// desc [n_cta, 4]; harm a scratch of slab / 32 x N x H lines (slab a
// multiple of 32 nodes); grp the degree groups, each [N, G, G] at N gpre,
// zero-filled; packed [N, nnz].
extern "C" int bhs_rotation_blocks(const void* ycw, const void* s_cart, const void* rot,
                                   const void* nodes, const void* jobs, const void* fam,
                                   const void* coef, const void* famr, int n_nodes,
                                   const void* cs_tab, const void* csjob, const void* perm,
                                   int n_cs, const void* blocks, const void* desc, int n_cta,
                                   void* harm, int slab, void* grp, void* packed, int N, int Q,
                                   int Qp, int hp, int H, int d, long long nnz, int dbl,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(ycw, s_cart, rot, nodes, jobs, fam, coef, famr, n_nodes, cs_tab,
                            csjob, perm, n_cs, blocks, desc, n_cta, harm, slab, grp, packed, N,
                            Q, Qp, hp, H, d, nnz, st);
  return (int)run<float>(ycw, s_cart, rot, nodes, jobs, fam, coef, famr, n_nodes, cs_tab, csjob,
                         perm, n_cs, blocks, desc, n_cta, harm, slab, grp, packed, N, Q, Qp, hp,
                         H, d, nnz, st);
}
