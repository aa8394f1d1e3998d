// KU: the coaxial factor's band tables U at the packed child-state entries,
// in the two forms K2 (csrc/coax_fold.cu) and its plain version read.
//
// Replaces biem_helmholtz_sphere_tpu/translation/_scaled.py:135-136, the
// einsum "qn,qa,qb->nab" of tz w, t_cols, t_cols and the Gaunt mask
// l + l' >= n, which the JAX package forms dense [NB, H, H] on its device.
// For each packed entry e = (a, b) of the child-state blocks and each band
// n < NG * 8:
//
//   U_n[e] = sum_q (tz w)[q, n] t[a, q] t[b, q]   where l_a + l_b >= n,
//
// exactly 0 elsewhere, accumulated in float64 and rounded once to the
// table's type.  It writes u [NG * 8, nnz] and the tiles' image u_img
// [slabs][2][64][4] (translation/_scaled.py::_coax_tiles: slab s of a tile
// at [h][j][b] holds U_{8 s + 4 h + b} of the tile's entry j, zero past a
// ragged tile's end).  The plain version is ops/coax_u.py::_coax_u_plain.
//
// What bounds it on the H100: the float64 multiply-adds.  At 'ba' n_end=64
// (174,784 entries, 129 nodes) the bands inside l + l' >= n are 13,981,696
// (entry, band) pairs: 2 q of them is 3.61 GFLOP of contraction, 54 us at
// the FP64 tensor cores' 67 TFLOP/s (plus 22.5 M node products, 0.7 us
// on the FP64 pipes), against u's and the image's writes, 148 MB in
// float32 and 296 MB in float64 (44 / 88 us at 3.35 TB/s: the bound in
// float64); the same count as chip_smoke.py::ku_bound.  The tiles' whole
// top groups, the nodes padded to chunks of 8, make the product this
// kernel issues 4.0 GFLOP, and its second pass reads the image again.
//
// Design: the tile's contraction as one matrix product on DMMA, then u
// from the image in a second, streaming pass.
// - Pass 1 (coax_u_kernel): one CTA (8 warps) per tile of 64 entries of
//   `order` (all of one top group g, the host's plan; the heaviest tiles
//   come first in `order`).  The tile's product is D[64, 8 (g + 1)] =
//   P[64, q] TZW[q, 8 (g + 1)], P[j, q] = t[a_j, q] t[b_j, q]: bands
//   < 8 (g + 1) only.
// - The nodes in chunks of kChunk through a ring of kStages stages in
//   shared memory, every copy by cp.async (8 bytes a copy: a row of t or of
//   tz w is an odd number of doubles; zero-filled past q, past the last band
//   and past a ragged tile's end): each chunk's rows t[a_j] and t[b_j] (four
//   lanes read 8 consecutive nodes of one row: one harmonic's nodes are
//   contiguous) and its (tz w)[q, bands].  kStages - 1 chunks are in flight
//   while the warps multiply one; one barrier a chunk.
// - The product on the FP64 tensor cores (mma.sync m16n8k8 .f64, through
//   mma_f64.cuh): the tile's 64 rows are four m16 tiles, each band group an
//   n8 tile; warp w takes m tile w % 4 and the groups of parity w / 4, up to
//   kGroupsW of them in float64 registers (a pass: every band group of
//   n_end <= 64 in one pass; a tile with more groups, n_end > 64, takes
//   more passes over the nodes).  Each A fragment's entry is the product
//   t_a t_b, rounded once, formed as the fragment is loaded.  Shared memory
//   is fixed (105,216 bytes, two CTAs an SM), whatever q and n_end: no size
//   ceiling.
// - Its epilogue applies the mask l_a + l_b >= n, rounds once to the
//   table's type and writes the tile's slabs of the image (whole sectors,
//   from one CTA), and where each packed entry sits (`where`: tile << 6 |
//   row).
// - Pass 2 (coax_u_rows_kernel): a thread per packed entry e writes its
//   column of u, every band: the image's values up to its tile's top group
//   (two 16- or 32-byte loads a group), 0 above.  A warp writes 32
//   consecutive entries of a band row: whole sectors, where pass 1's
//   tile-ordered writes into u's [band, entry] rows leave sectors half
//   written by two tiles, each half read back from memory once u outgrows
//   the L2 cache.  Where pass 1's tiles fit one wave at a CTA an SM
//   (`direct`, the wrapper's choice: the 5D pair), each CTA does pass 2's
//   work for its own tile from the slabs it wrote (an instance of its own,
//   whose registers a second CTA on the SM would not leave room for), and
//   pass 2, whose launch would not hide behind a second wave, is not
//   launched.  Either way every element of u is written: no memset.
// - Each output has one writer and a fixed order of summation (nodes
//   ascending, chunk by chunk, the MMA's k order within a chunk): two
//   launches give the same bits.  No atomics.
#include "common.cuh"
#include "mma_f64.cuh"

#include <cstdint>

namespace {

constexpr int kTile = 64;      // entries per tile (= ops/coax_u.py _TILE)
constexpr int kGroup = 8;      // bands per group (_GROUP)
constexpr int kThreads = 256;  // 8 warps: 4 m tiles x 2 group parities (_KU_THREADS)
constexpr int kChunk = 8;      // nodes a stage: one k8 step (_KU_CHUNK)
constexpr int kStages = 5;     // the ring's stages (_KU_STAGES)
constexpr int kGroupsW = 8;    // band groups a warp holds in a pass (_KU_GROUPS_W)
constexpr int kGroupsP = 2 * kGroupsW;  // band groups a pass (_KU_GROUPS_PASS)
constexpr int kTStride = kChunk + 4;    // t rows' stride in shared memory: no bank conflicts
constexpr int kZStride = kGroupsP * kGroup + 4;  // tz w's row stride in shared memory
constexpr int kStage = 2 * kTile * kTStride + kChunk * kZStride;  // doubles a stage
// dynamic shared memory: the ring, then the tile's row and column offsets,
// packed indices and l_a + l_b (= ops/coax_u.py _ku_smem)
constexpr size_t kSmem = sizeof(double) * kStages * kStage +
                         kTile * (2 * sizeof(long long) + 2 * sizeof(int));
constexpr int kRowsThreads = 256;  // pass 2: a thread per packed entry

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared, 8 bytes, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, double a, double b) {
  *reinterpret_cast<float2*>(p) = make_float2((float)a, (float)b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}
// four consecutive values of the image (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

// Band group grp of u's column e, the entry at row j of `tile`: its 8
// values from the tile's slab (two 16- or 32-byte loads), 0 above the
// tile's top group
template <typename T>
__device__ __forceinline__ void u_group(int4 tile, int j, int e, int grp,
                                        const T* __restrict__ u_img, T* __restrict__ u,
                                        int nnz) {
  T v[2][4] = {};
  if (grp <= tile.z) {
    const T* slab = u_img + (size_t)(tile.w + grp) * kGroup * kTile;
    load4(slab + j * 4, v[0]);
    load4(slab + (kTile + j) * 4, v[1]);
  }
#pragma unroll
  for (int b = 0; b < kGroup; ++b) u[(size_t)(grp * kGroup + b) * nnz + e] = v[b >> 2][b & 3];
}

template <typename T, bool DIRECT>
__global__ void __launch_bounds__(kThreads, DIRECT ? 1 : 2)
coax_u_kernel(const double* __restrict__ t, const double* __restrict__ tzw,
              const long long* __restrict__ rows, const long long* __restrict__ cols,
              const int2* __restrict__ order, const int4* __restrict__ tiles,
              T* __restrict__ u_img, int* __restrict__ where, T* __restrict__ u, int q, int nb,
              int nnz, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);  // [kStages][ta | tb | z]
  long long* s_oa = reinterpret_cast<long long*>(ring + kStages * kStage);  // [kTile]
  long long* s_ob = s_oa + kTile;                       // [kTile]
  int* s_e = reinterpret_cast<int*>(s_ob + kTile);     // [kTile]
  int* s_ls = s_e + kTile;                              // [kTile]

  // (first entry of order, entries, top group, first slab) of this tile
  const int4 tile = tiles[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the MMA fragments' row and column lanes
  const int m0 = (warp & 3) * 16, par = warp >> 2;
  if (tid < kTile) {
    long long oa = -1, ob = -1;
    int e = 0, ls = -1;
    if (tid < tile.y) {
      const int2 o = order[tile.x + tid];
      e = o.x;
      ls = (o.y & 0xffff) + (o.y >> 16);
      oa = rows[e] * q;
      ob = cols[e] * q;
      if constexpr (!DIRECT) where[e] = (blockIdx.x << 6) | tid;
    }
    s_oa[tid] = oa;
    s_ob[tid] = ob;
    s_e[tid] = e;
    s_ls[tid] = ls;
  }
  __syncthreads();

  const int n_chunks = (q + kChunk - 1) / kChunk;
  const int n_groups = tile.z + 1;
  for (int pb = 0; pb < n_groups; pb += kGroupsP) {
    const int gp = min(kGroupsP, n_groups - pb);  // groups of this pass
    // chunk c into its stage, then a commit (empty past the end).  The
    // thread's copies: 2 nodes of row jr of t_a and t_b; column zc of tz w at
    // rows zr, zr + 2, ..; every index rederived from threadIdx.x and the
    // tile's offsets in shared memory at each issue, so that none holds a
    // register across the product
    auto issue = [&](int c) {
      if (c < n_chunks) {
        const int id = threadIdx.x;
        const int jr = id >> 2, kn = 2 * (id & 3);
        const int zc = id % (kGroupsP * kGroup), zr = id / (kGroupsP * kGroup);
        double* st = ring + (c % kStages) * kStage;
        const int q0 = c * kChunk;
        const long long oa = s_oa[jr], ob = s_ob[jr];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qq = q0 + kn + i;
          cp8(st + jr * kTStride + kn + i, t + (oa >= 0 && qq < q ? oa + qq : 0),
              oa >= 0 && qq < q);
          cp8(st + kTile * kTStride + jr * kTStride + kn + i,
              t + (ob >= 0 && qq < q ? ob + qq : 0), ob >= 0 && qq < q);
        }
        const int band = pb * kGroup + zc;
        if (zc < gp * kGroup) {
          double* z = st + 2 * kTile * kTStride;
#pragma unroll
          for (int r = zr; r < kChunk; r += kThreads / (kGroupsP * kGroup)) {
            const bool ok = band < nb && q0 + r < q;
            cp8(z + r * kZStride + zc, tzw + (ok ? (size_t)(q0 + r) * nb + band : 0), ok);
          }
        }
      }
      cp_commit();
    };

    double acc[kGroupsW][4];
#pragma unroll
    for (int i = 0; i < kGroupsW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.0;
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    for (int c = 0; c < n_chunks; ++c) {
      cp_wait<kStages - 2>();
      __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's stage
      issue(c + kStages - 1);  // into chunk c - 1's stage
      const double* ta = ring + (c % kStages) * kStage;
      const double* tb = ta + kTile * kTStride;
      const double* z = tb + kTile * kTStride;
      double a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (m0 + g + 8 * (i & 1)) * kTStride + tq + 4 * (i >> 1);
        a[i] = ta[o] * tb[o];  // P = t_a t_b, one rounding
      }
#pragma unroll
      for (int gi = 0; gi < kGroupsW; ++gi) {
        const int lg = 2 * gi + par;  // the pass's group
        if (lg < gp) {                // the same in every lane of the warp
          const double b[2] = {z[tq * kZStride + lg * kGroup + g],
                               z[(tq + 4) * kZStride + lg * kGroup + g]};
          mma_f64(acc[gi], a, b);
        }
      }
    }

    // the epilogue: rows m0 + g and m0 + g + 8, bands 2 tq and 2 tq + 1 of
    // each of the warp's groups into the image; the mask, one rounding
#pragma unroll
    for (int gi = 0; gi < kGroupsW; ++gi) {
      const int lg = 2 * gi + par;
      if (lg >= gp) continue;
      const int grp = pb + lg;
      T* slab = u_img + (size_t)(tile.w + grp) * kGroup * kTile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = m0 + g + 8 * h;
        const int ls = s_ls[j];
        const int n = grp * kGroup + 2 * tq;
        const double v0 = n <= ls ? acc[gi][2 * h] : 0.0;
        const double v1 = n + 1 <= ls ? acc[gi][2 * h + 1] : 0.0;
        // band 2 tq + c of the group at [(2 tq + c) / 4][j][(2 tq + c) % 4]
        store2(slab + ((tq >> 1) * kTile + j) * 4 + 2 * (tq & 1), v0, v1);
      }
    }
    cp_wait<0>();
    __syncthreads();  // the next pass refills the ring; the image is written
  }
  if constexpr (DIRECT) {  // pass 2's work on this tile's entries, from the slabs it wrote
    for (int i = tid; i < tile.y * ng; i += kThreads) {
      const int j = i % tile.y;
      u_group(tile, j, s_e[j], i / tile.y, u_img, u, nnz);
    }
  }
}

// Pass 2: u [ng * 8, nnz] from the image, a thread per packed entry
template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
coax_u_rows_kernel(const int* __restrict__ where, const int4* __restrict__ tiles,
                   const T* __restrict__ u_img, T* __restrict__ u, int nnz, int ng) {
  const int e = blockIdx.x * kRowsThreads + threadIdx.x;
  if (e >= nnz) return;
  const int w = where[e];
  const int4 tile = tiles[w >> 6];
  for (int grp = 0; grp < ng; ++grp) u_group(tile, w & (kTile - 1), e, grp, u_img, u, nnz);
}

template <typename T>
cudaError_t run(const void* t, const void* tzw, const void* rows, const void* cols,
                const void* order, const void* tiles, void* u, void* u_img, void* where, int q,
                int nb, int nnz, int n_tiles, int ng, int direct, long long smem,
                cudaStream_t stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (q < 1 || nb < 1 || nnz < 1 || n_tiles < 0 || ng * kGroup < nb ||
      smem != (long long)kSmem)
    return cudaErrorInvalidValue;
  auto kernel = direct ? coax_u_kernel<T, true> : coax_u_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kThreads, kSmem, stream>>>(
      static_cast<const double*>(t), static_cast<const double*>(tzw),
      static_cast<const long long*>(rows), static_cast<const long long*>(cols),
      static_cast<const int2*>(order), static_cast<const int4*>(tiles), static_cast<T*>(u_img),
      static_cast<int*>(where), static_cast<T*>(u), q, nb, nnz, ng);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  coax_u_rows_kernel<T><<<(nnz + kRowsThreads - 1) / kRowsThreads, kRowsThreads, 0, stream>>>(
      static_cast<const int*>(where), static_cast<const int4*>(tiles),
      static_cast<const T*>(u_img), static_cast<T*>(u), nnz, ng);
  return cudaGetLastError();
}

}  // namespace

// t [H, q] float64 (the root factors, transposed); tzw [q, nb] float64;
// rows, cols [nnz] int64 (the basis row and column of each packed entry);
// order [nnz, 2] int32 (packed index, la + 65536 lb, by top group); tiles
// [n_tiles, 4] int32 (first entry of order, entries, top group, first
// slab); u [ng * 8, nnz] and u_img [slabs, 2, 64, 4] in float64 (dbl) or
// float32, both written whole; where [nnz] int32 scratch; direct: pass 1
// writes u itself, tile by tile (where its tiles are one wave at a CTA an
// SM), else pass 2 does;
// smem the dynamic shared memory the wrapper plans
// (ops/coax_u.py::_ku_smem), which must be this kernel's.
extern "C" int bhs_coax_u(const void* t, const void* tzw, const void* rows, const void* cols,
                          const void* order, const void* tiles, void* u, void* u_img,
                          void* where, int q, int nb, int nnz, int n_tiles, int ng, int direct,
                          long long smem, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(t, tzw, rows, cols, order, tiles, u, u_img, where, q, nb, nnz,
                            n_tiles, ng, direct, smem, st);
  return (int)run<float>(t, tzw, rows, cols, order, tiles, u, u_img, where, q, nb, nnz, n_tiles,
                         ng, direct, smem, st);
}
