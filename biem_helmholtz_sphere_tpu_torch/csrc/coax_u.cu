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
// (174,784 entries, 129 nodes) the bands inside l + l' >= n need about 5.7
// GFLOP (86 us at the DMMA rate, 170 us on the FP64 pipes) against 148 MB
// of writes (44 us at 3.35 TB/s).  Design, simple and right first:
// - One CTA per tile of 64 entries of `order` (all of one top group g, the
//   host's plan), one thread per entry; only bands < 8 (g + 1) are formed:
//   the wrapper's memset leaves u's higher bands 0 and the mask zeroes the
//   rest of the top group.
// - The band groups of 8 outermost, their sums in 8 float64 registers; for
//   each group the nodes in chunks of kChunk, the chunk's (tz w)[q, 8 bands]
//   staged in shared memory (8 KB, whatever q and n_end: no size ceiling)
//   and read by every thread as a broadcast; each thread's factors t[a, q]
//   and t[b, q] come from the [H, q] copy (one harmonic's nodes contiguous,
//   L1-resident across the groups).
// - Each output has one writer and a fixed order of summation (q
//   ascending, one FMA per node): two launches give the same bits.  No
//   atomics, no tensor cores.
// Later work: the product on DMMA (mma.sync f64) over a tile's distinct
// rows, and a producer warp for the chunks.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kTile = 64;    // entries per tile (= ops/coax_u.py _TILE)
constexpr int kGroup = 8;    // bands per group (_GROUP)
constexpr int kChunk = 128;  // nodes of (tz w) staged at a time

template <typename T>
__global__ void __launch_bounds__(kTile)
coax_u_kernel(const double* __restrict__ t, const double* __restrict__ tzw,
              const long long* __restrict__ rows, const long long* __restrict__ cols,
              const int2* __restrict__ order, const int4* __restrict__ tiles,
              T* __restrict__ u, T* __restrict__ u_img, int q, int nb, int nnz) {
  __shared__ __align__(16) double stz[kChunk * kGroup];
  // (first entry of order, entries, top group, first slab) of this tile
  const int4 tile = tiles[blockIdx.x];
  const int j = threadIdx.x;
  const bool live = j < tile.y;
  int e = 0, ls = -1;
  const double* ta = t;
  const double* tb = t;
  if (live) {
    const int2 o = order[tile.x + j];
    e = o.x;
    ls = (o.y & 0xffff) + (o.y >> 16);
    ta = t + (size_t)rows[e] * q;
    tb = t + (size_t)cols[e] * q;
  }
  for (int g = 0; g <= tile.z; ++g) {
    double acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = 0.0;
    for (int q0 = 0; q0 < q; q0 += kChunk) {
      const int nq = min(kChunk, q - q0);
      __syncthreads();  // every thread is done with the last chunk
      for (int i = j; i < nq * kGroup; i += kTile) {
        const int n = g * kGroup + (i & (kGroup - 1));
        stz[i] = n < nb ? tzw[(size_t)(q0 + i / kGroup) * nb + n] : 0.0;
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < nq; ++k) {
          const double p = ta[q0 + k] * tb[q0 + k];
          const double2* s = reinterpret_cast<const double2*>(stz + k * kGroup);
#pragma unroll
          for (int i = 0; i < kGroup / 2; ++i) {
            const double2 v = s[i];
            acc[2 * i] = fma(v.x, p, acc[2 * i]);
            acc[2 * i + 1] = fma(v.y, p, acc[2 * i + 1]);
          }
        }
      }
    }
    T v[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) v[i] = g * kGroup + i <= ls ? (T)acc[i] : T(0);
    if (live) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) u[(size_t)(g * kGroup + i) * nnz + e] = v[i];
    }
    // slab tile.w + g: [2][kTile][4]; a thread past the tile's entries writes
    // its zeros
    T* slab = u_img + (size_t)(tile.w + g) * kGroup * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int b = 0; b < 4; ++b) slab[(h * kTile + j) * 4 + b] = v[4 * h + b];
    }
  }
}

template <typename T>
cudaError_t run(const void* t, const void* tzw, const void* rows, const void* cols,
                const void* order, const void* tiles, void* u, void* u_img, int q, int nb,
                int nnz, int n_tiles, cudaStream_t stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (q < 1 || nb < 1 || nnz < 1 || n_tiles < 0) return cudaErrorInvalidValue;
  coax_u_kernel<T><<<n_tiles, kTile, 0, stream>>>(
      static_cast<const double*>(t), static_cast<const double*>(tzw),
      static_cast<const long long*>(rows), static_cast<const long long*>(cols),
      static_cast<const int2*>(order), static_cast<const int4*>(tiles), static_cast<T*>(u),
      static_cast<T*>(u_img), q, nb, nnz);
  return cudaGetLastError();
}

}  // namespace

// t [H, q] float64 (the root factors, transposed); tzw [q, nb] float64;
// rows, cols [nnz] int64 (the basis row and column of each packed entry);
// order [nnz, 2] int32 (packed index, la + 65536 lb, by top group); tiles
// [n_tiles, 4] int32 (first entry of order, entries, top group, first
// slab); u [ng * 8, nnz] (zeroed by the caller) and u_img [slabs, 2, 64, 4]
// in float64 (dbl) or float32.
extern "C" int bhs_coax_u(const void* t, const void* tzw, const void* rows, const void* cols,
                          const void* order, const void* tiles, void* u, void* u_img, int q,
                          int nb, int nnz, int n_tiles, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(t, tzw, rows, cols, order, tiles, u, u_img, q, nb, nnz, n_tiles, st);
  return (int)run<float>(t, tzw, rows, cols, order, tiles, u, u_img, q, nb, nnz, n_tiles, st);
}
