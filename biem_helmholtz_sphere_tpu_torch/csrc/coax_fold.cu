// K2: the folded coaxial factor of the factored (S|R) matvec, written
// straight into the packed child-state blocks that KB consumes.
//
// Replaces biem_helmholtz_sphere_tpu/translation/_scaled.py coaxial_scaled
// (:86) and the degree-level fold at biem_helmholtz_sphere_tpu/biem/
// _core.py:551-584, which form dense [K, NR, H, H] mant, S and fold factor
// tensors and then pack them.  For every (k, radius) pair p and packed
// entry j = (row a, col b), of root degrees (la, lb) and ls = la + lb:
//
//   coef_p[n] = (i^n a_d zf[n]) radm_p[n] exp(rade_p[n] - sig_p[g(n)])
//   acc       = sum_g exp(min(sig_p[g] - rade_p[ls], 80))
//                     sum_{n in g} coef_p[n] U[n, j]
//   out[p, j] = acc i^la conj(i^lb) exp(e_r[k, la] + rade_p[ls] + e_b[k, lb])
//
// with (radm, rade) the scaled h_n(k r) of the 2 n_end - 1 bands (K5),
// padded to whole groups of 8 bands with zero coefficients and the last
// exponent, sig_p[g] the largest exponent of group g, U the
// radius-independent band matrices at the packed entries (zero where
// ls < n) and e_r, e_b the degree-level ball-max radial exponents.  The
// operations are those of the plain version
// (translation/_scaled.py::_coax_fold_packed_plain), the clamp at 80 and
// the separate fold factor included: cancelling rade[ls] between the two
// is not an identity where the clamp binds.
//
// What bounds it on the H100: device memory, with the FP32 rate close
// behind.  At the bench (4 k x 9 radii, n_end = 32, 21,856 packed entries,
// complex64) it must read U's 873,984 entries inside ls >= n (3.5 MB) and
// write 6.3 MB (~3 us at 3.35 TB/s); the 36 x 873,984 complex x real MACs
// take ~1.9 us at 67 TFLOP/s.  Design:
// - One pass over U, and no work on the Gaunt zeros.  The host
//   (translation/_scaled.py::_coax_tiles) sorts the packed entries by their
//   top group ls // 8, cuts each run of one top group into tiles of 64
//   entries, stores each tile's bands 0 .. 8 (top + 1) - 1 as one
//   contiguous image, slab by slab (a slab: one group of 8 bands, [2][64
//   entries][4 bands], zero past the tile's entries), and deals the runs
//   out in work units of consecutive tiles of one top group, of about
//   equal cost, one unit per SM.  A CTA takes a unit and every pair p of
//   the call: U crosses from device memory once, and the groups above an
//   entry's top group (32% of the dense table at the bench) are neither
//   read nor multiplied.
// - Each tile's slabs arrive by one bulk asynchronous copy (the Hopper TMA
//   unit, cp.async.bulk) completing its own mbarrier, all issued first;
//   the unit's entries and the pass's e_r, e_b rows follow by cp.async.
//   Meanwhile each warp turns its pairs' rows of radm and rade, a lane per
//   (pair, band), into the coefficients [pairs, bands] and the group
//   scales exp(min(sig_p[g] - rade_p[ls], 80)) at the unit's 8 values of
//   ls ([pairs, groups, 8]): the unit shares one top group, so these
//   tables serve all its tiles.
// - A SIMT GEMM with register tiles: 12 warps, warp w taking pairs w,
//   w + 12, w + 24 and each lane 2 entries (lane and lane + 32), so one
//   16-byte load of U (4 bands of an entry) and one broadcast 16-byte load
//   of coefficients feed 8 or 4 FMAs per thread.  Each group's sum takes
//   its scale from the table once per (pair, entry, group).
// - Where P exceeds a pass (36 pairs, fewer when shared memory is short at
//   large n_end), the CTA loops over passes with its U slabs staying in
//   shared memory.  Every output is written once, in one pass over all
//   groups in both dtypes and at any n_end whose tile fits: no partial
//   sums in device memory.
// - Each output has one writer and a fixed summation order: a second
//   launch gives the same bits.  FP32 (FP64) FMA on the CUDA cores; no
//   tensor cores, no TF32.
// What holds it back (H100, bench, complex64: ~13 us a launch against a
// ~3 us bound; tools/torch_k2_trace.py splits it CTA by CTA): the band
// loop runs well below the FP32 FMA rate (the latency of the shared loads
// and the short FMA chains between them, at 3 warps a scheduler); each
// tile's epilogue (phases, fold factors, scattered stores) costs a few
// slabs' work; and the prologue (the coefficient tables' global loads,
// shuffles and exps) passes before the first FMA.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 3;  // pairs per warp: kWarps * kPairs per pass
constexpr int kTile = 64;  // packed entries per tile (= translation/_scaled.py _TILE)
constexpr int kGroup = 8;  // bands per scale group (_GROUP)
constexpr int kSlab = kGroup * kTile;  // values per slab of the U image

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`, which expects exactly these bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// wait for the first phase of `bar` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// one element, global -> shared, asynchronously (4, 8 or 16 bytes)
template <typename V>
__device__ __forceinline__ void cp_async_elem(V* dst, const V* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(sizeof(V)));
}

// 4 consecutive reals / complex values from 16-byte aligned shared memory
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const float2* p, float2 (&v)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = make_float2(a.x, a.y), v[1] = make_float2(a.z, a.w);
  v[2] = make_float2(b.x, b.y), v[3] = make_float2(b.z, b.w);
}
__device__ __forceinline__ void load4(const double2* p, double2 (&v)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) v[b] = p[b];
}

// Shared memory of one CTA (offsets in bytes, each a multiple of 16): the
// unit's U slabs [slabs][2][kTile][4] and its entries of `order` [slabs *
// kTile]; per pass, coef [pt][nbp] complex, the group scales [pt][ng][8],
// rade at the unit's 8 values of ls [pt][8] and the e_r, e_b rows of the
// pass's k's [kspan][L]; an mbarrier per tile (at most one per slab).
template <typename T>
struct Layout {
  size_t ent, coef, scl, rl, er, eb, bar, total;
  __host__ __device__ Layout(int slabs, int ng, int pt, int kspan, int L) {
    const size_t nbp = (size_t)ng * kGroup;
    ent = (size_t)slabs * kSlab * sizeof(T);
    coef = ent + (size_t)slabs * kTile * sizeof(int2);
    scl = coef + pad16((size_t)pt * nbp * 2 * sizeof(T));
    rl = scl + pad16((size_t)pt * nbp * sizeof(T));
    er = rl + pad16((size_t)pt * kGroup * sizeof(T));
    eb = er + pad16((size_t)kspan * L * sizeof(T));
    bar = eb + pad16((size_t)kspan * L * sizeof(T));
    total = bar + (size_t)slabs * sizeof(uint64_t);
  }
  __host__ __device__ static size_t pad16(size_t b) { return (b + 15) / 16 * 16; }
};

// A lane's two entries of a tile: packed index (-1: none), degrees, ls -
// 8 top, and the phase i^la conj(i^lb) = i^(la - lb).
template <typename T>
struct Entries {
  int dst[2], la[2], lb[2], s8[2];
  c2_t<T> ph[2];
  __device__ void load(const int2* order, int e0, int ne, int top, int lane) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      const int2 o = order[e0 + min(j, ne - 1)];
      dst[r] = j < ne ? o.x : -1;
      la[r] = o.y & 0xffff;
      lb[r] = o.y >> 16;
      s8[r] = la[r] + lb[r] - top * kGroup;
      const int d = (la[r] - lb[r]) & 3;
      ph[r] = cmake<T>(d == 0 ? T(1) : d == 2 ? T(-1) : T(0), d == 1 ? T(1) : d == 3 ? T(-1) : T(0));
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
coax_fold_kernel(const c2_t<T>* __restrict__ radm, const T* __restrict__ rade,
                 const c2_t<T>* __restrict__ iazf, const T* __restrict__ u_img,
                 const int4* __restrict__ units, const int2* __restrict__ order,
                 const T* __restrict__ e_r, const T* __restrict__ e_b,
                 c2_t<T>* __restrict__ out, int P, int pt, int kspan, int n_rad, int nb, int ng,
                 int nnz, int L, int max_slabs) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout<T> lay(max_slabs, ng, pt, kspan, L);
  const int nbp = ng * kGroup;
  T* us = reinterpret_cast<T*>(smem_raw);
  int2* ent = reinterpret_cast<int2*>(smem_raw + lay.ent);
  T2* coef = reinterpret_cast<T2*>(smem_raw + lay.coef);
  T* scl = reinterpret_cast<T*>(smem_raw + lay.scl);
  T* rlt = reinterpret_cast<T*>(smem_raw + lay.rl);
  T* er = reinterpret_cast<T*>(smem_raw + lay.er);
  T* eb = reinterpret_cast<T*>(smem_raw + lay.eb);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);

  // (first sorted entry, entries, top group, first slab) of this CTA's unit
  const int4 unit = units[blockIdx.x];
  const int top = unit.z, ngc = top + 1, nbc = ngc * kGroup;
  const int n_tiles = (unit.y + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the last warp's first lane starts the tiles' bulk copies, one per tile;
  // the barriers are initialised before the __syncthreads below, and
  // nobody waits on them before it
  if (tid == kThreads - 32) {
    for (int t = 0; t < n_tiles; ++t) mbar_init(&bar[t]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const T* src = u_img + (size_t)unit.w * kSlab;
    const unsigned bytes = ngc * kSlab * sizeof(T);
    for (int t = 0; t < n_tiles; ++t)
      bulk_load(us + (size_t)t * ngc * kSlab, src + (size_t)t * ngc * kSlab, bytes, &bar[t]);
  }
  // the unit's entries of `order`, asynchronously
  for (int e = tid; e < unit.y; e += kThreads) cp_async_elem(ent + e, order + unit.x + e);

  // pairs warp + kWarps i of a pass; slots past pt read pair 0
  int qs[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) qs[i] = warp + kWarps * i < pt ? warp + kWarps * i : 0;

  for (int p0 = 0; p0 < P; p0 += pt) {
    const int np = min(pt, P - p0);
    const int k0 = p0 / n_rad, nk = (p0 + np - 1) / n_rad - k0 + 1;
    if (p0 > 0) __syncthreads();  // the last pass is done with its tables
    for (int e = tid; e < nk * L; e += kThreads) {
      cp_async_elem(er + e, e_r + (size_t)k0 * L + e);
      cp_async_elem(eb + e, e_b + (size_t)k0 * L + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // Warp w's pair rows: the coefficients of bands 0 .. nbc - 1 and their
    // group scales at the unit's 8 values of ls, a lane per (row, band),
    // bands fastest (conflict-free).  Every row's loads are issued before
    // any is used, so their latencies overlap.  nbc is a multiple of 8, so
    // each aligned 8 lanes hold one group and take its maximum by
    // shuffles.  Rows past np are zero.
    const int nl = min(top * kGroup + (lane & (kGroup - 1)), nb - 1);
    for (int n0 = 0; n0 < nbc; n0 += 2 * 32) {
      T re[2][kPairs], rl[kPairs];
      T2 cm[2][kPairs], iz[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) iz[c] = iazf[min(n0 + 32 * c + lane, nb - 1)];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const size_t row = (size_t)(p0 + min(warp + kWarps * i, np - 1)) * nb;
        rl[i] = rade[row + nl];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int nc = min(n0 + 32 * c + lane, nb - 1);
          re[c][i] = rade[row + nc];
          cm[c][i] = radm[row + nc];
        }
      }
#pragma unroll
      for (int ci = 0; ci < 2 * kPairs; ++ci) {
        const int c = ci / kPairs, i = ci % kPairs, n = n0 + 32 * c + lane;
        if (n0 + 32 * c >= nbc) break;  // warp-uniform
        const int q = warp + kWarps * i;
        const bool live = q < np;
        const T r0 = live ? re[c][i] : T(0), r1 = live ? rl[i] : T(0);
        T mx = r0;
#pragma unroll
        for (int o = 1; o < kGroup; o <<= 1) {
          const T v = __shfl_xor_sync(0xffffffffu, mx, o);
          mx = v > mx ? v : mx;
        }
        if (q < pt && n < nbc) {
          const T2 cc = cmul<T>(iz[c], cm[c][i]);
          coef[q * nbp + n] = live && n < nb ? cscale<T>(cc, t_exp(r0 - mx)) : cmake<T>(0, 0);
          T x = mx - r1;
          x = x > T(80) ? T(80) : x;
          scl[q * nbp + n] = t_exp(x);  // [q][group n / 8][ls - 8 top = n % 8]
          if (n >= top * kGroup) rlt[q * kGroup + n - top * kGroup] = r0;
        }
      }
    }
    // the staged entries and e_r, e_b rows, and the barriers' initialisation,
    // are visible to every warp
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    for (int tl = 0; tl < n_tiles; ++tl) {
      Entries<T> cur;
      cur.load(ent, tl * kTile, unit.y - tl * kTile, top, lane);
      mbar_wait(&bar[tl]);
      T2 acc[kPairs][2];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) acc[i][0] = acc[i][1] = cmake<T>(0, 0);
      for (int g = 0; g < ngc; ++g) {
        const int s = tl * ngc + g;
        T2 t[kPairs][2];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) t[i][0] = t[i][1] = cmake<T>(0, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // bands 8 g + 4 h .. 8 g + 4 h + 3
          T u0[4], u1[4];
          const T* slab = us + (size_t)(s * 2 + h) * kTile * 4;
          load4(slab + lane * 4, u0);
          load4(slab + (lane + 32) * 4, u1);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            T2 c[4];
            load4(coef + qs[i] * nbp + g * kGroup + h * 4, c);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              t[i][0].x = t_fma(c[b].x, u0[b], t[i][0].x);
              t[i][0].y = t_fma(c[b].y, u0[b], t[i][0].y);
              t[i][1].x = t_fma(c[b].x, u1[b], t[i][1].x);
              t[i][1].y = t_fma(c[b].y, u1[b], t[i][1].y);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const T* sq = scl + (qs[i] * ng + g) * kGroup;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const T sc = sq[cur.s8[r]];
            acc[i][r].x += t[i][r].x * sc;
            acc[i][r].y += t[i][r].y * sc;
          }
        }
      }

      // the phase and the fold factor; one store each
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int q = warp + kWarps * i;
        const int k = ((p0 + min(q, np - 1)) / n_rad - k0) * L;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const T rl = rlt[qs[i] * kGroup + cur.s8[r]];
          const T f = t_exp((er[k + cur.la[r]] + rl) + eb[k + cur.lb[r]]);
          const T2 a = acc[i][r], ph = cur.ph[r];
          const T2 mant = cmake<T>(a.x * ph.x - a.y * ph.y, a.x * ph.y + a.y * ph.x);
          if (q < np && cur.dst[r] >= 0)
            out[(size_t)(p0 + q) * nnz + cur.dst[r]] = cscale<T>(mant, f);
        }
      }
    }
  }
}

// The most shared memory a CTA may ask for on the H100 (227 KB).
constexpr size_t kSmemMax = 232448;

template <typename T>
cudaError_t run(const void* radm, const void* rade, const void* iazf, const void* u_img,
                const void* units, const void* order, const void* e_r, const void* e_b,
                void* out, int P, int n_rad, int nb, int ng, int nnz, int n_units, int max_slabs,
                int L, cudaStream_t stream) {
  if (P == 0 || n_units == 0) return cudaSuccess;
  if (nb < 1 || ng * kGroup < nb || n_rad < 1 || nnz < 1 || P % n_rad || max_slabs < 1)
    return cudaErrorInvalidValue;
  // pairs per pass: the register tile's, fewer where shared memory is short;
  // a pass of pt pairs spans at most kspan k's
  const auto kspan = [&](int pt) { return std::min(P / n_rad, (pt - 1) / n_rad + 2); };
  const auto bytes = [&](int pt) { return Layout<T>(max_slabs, ng, pt, kspan(pt), L).total; };
  int pt = std::min(kWarps * kPairs, P);
  while (pt > 1 && bytes(pt) > kSmemMax) --pt;
  const size_t smem = bytes(pt);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(coax_fold_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  using T2 = c2_t<T>;
  coax_fold_kernel<T><<<n_units, kThreads, smem, stream>>>(
      static_cast<const T2*>(radm), static_cast<const T*>(rade), static_cast<const T2*>(iazf),
      static_cast<const T*>(u_img), static_cast<const int4*>(units),
      static_cast<const int2*>(order), static_cast<const T*>(e_r), static_cast<const T*>(e_b),
      static_cast<T2*>(out), P, pt, kspan(pt), n_rad, nb, ng, nnz, L, max_slabs);
  return cudaGetLastError();
}

}  // namespace

// radm, rade [P, nb] (P = K * n_rad, k-major); iazf [nb]; u_img [slabs, 2,
// 64, 4] (the tiles' band images); units [n_units, 4] int32 (first sorted
// entry, entries, top group, first slab), each unit at most max_slabs
// slabs; order [nnz, 2] int32 (the packed index and la + 65536 lb of each
// sorted entry); e_r, e_b [K, L]; out [P, nnz].
extern "C" int bhs_coax_fold(const void* radm, const void* rade, const void* iazf,
                             const void* u_img, const void* units, const void* order,
                             const void* e_r, const void* e_b, void* out, int P, int n_rad,
                             int nb, int ng, int nnz, int n_units, int max_slabs, int L, int dbl,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(radm, rade, iazf, u_img, units, order, e_r, e_b, out, P, n_rad, nb,
                            ng, nnz, n_units, max_slabs, L, st);
  return (int)run<float>(radm, rade, iazf, u_img, units, order, e_r, e_b, out, P, n_rad, nb, ng,
                         nnz, n_units, max_slabs, L, st);
}
