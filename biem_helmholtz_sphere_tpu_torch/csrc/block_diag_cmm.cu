// KB: products of block-diagonal complex matrices with compacted lanes.
//
// Replaces the three dense [H, H] einsums of the factored (S|R) matvec in
// biem_helmholtz_sphere_tpu/biem/_core.py (_matfree_operator, factored
// `mv`): D^H and D per offset slot (degree blocks of size 2l+1, 4.2%
// nonzero at n_end=32) and the folded coaxial factor X per (k, radius)
// (child-state blocks of size n-|m|, 2.1% nonzero).  x, y are [K, L, H]
// with only the L lanes that route a pair; the lanes of matrix m form the
// segment lane0 .. lane0+nl.  For every block b of that matrix:
//
//   y[k, l, perm[off_b + i]] = sum_j op(A_m)_b[i, j] x[k, l, perm[off_b + j]]
//
// with op the identity or the conjugate transpose, A given as its packed
// diagonal blocks (vals[mat, voffs[b] + i*g + j], row-major) and perm the
// packed -> basis permutation (null: the identity).  X's blocks live in
// the child-state order, so the kernel reads and writes the lanes through
// perm itself: no permutation pass in device memory.
//
// What bounds it on the H100: bytes at the bench shapes (D^H: 8.4 MB of D
// and 2 x 7.9 MB of lanes, ~7 us at 3.35 TB/s; the ~42 M complex MACs take
// ~5 us at 67 TFLOP/s FP32), close to the FP32 rate too, so both the
// loads and the inner loop matter.  Design:
// - The host builds a work list once per shape (ops/block_diag.py
//   work_list): each item is a run of consecutive blocks of ONE matrix
//   applied to all its lanes (all K k's for a matrix shared by the k's,
//   so D crosses from device memory once per product), with about the
//   same g^2 x lanes per item, largest first.  Small blocks share an item;
//   a block whose work alone exceeds the target has its lanes split.
// - Persistent CTAs walk the list in rounds of gridDim.x items, in
//   alternating directions, so a CTA that takes one of the largest items
//   in one round takes one of the smallest in the next.  The next item's
//   op(A) blocks and lane slices are staged with cp.async into the second
//   of two dynamic shared-memory buffers while the current item computes.
//   cp.async moves one complex element per copy (8 bytes in c64, 16 in
//   c128): block b starts at l^2 in a lane and at sum_{l'<l} (2l'+1)^2 in
//   vals, which is 16-byte aligned in c64 only for even offsets, and X's
//   lane slices are gathered through perm, so element copies need no
//   padding of the packed layout.  Staging indexes elements by shifts (the
//   column count rounded up to a power of two), not integer divisions.
// - Register tiles: each thread forms a 4-row x 2-lane tile of outputs;
//   per j it reads 4 entries of op(A) (one 32-byte row of the transposed,
//   row-padded block) and 2 lane entries, and does 8 complex FMAs.  Tiles
//   of one item's blocks form one index space, so threads with no tile
//   left in a small block go straight on to the next block.
// - Each output entry has one writer and sums j in order in one thread:
//   no atomics, so repeated sweeps are bit-for-bit equal.  FP32 (FP64)
//   FMA on the CUDA cores; no tensor cores, no TF32.
// What holds it back (H100, bench shapes): the element-wise staging (X's
// slices gathered through perm) and the per-item overheads, not the inner
// loop: halving every block's j loop cuts a product by ~1/6 only
// (tools/torch_kernel_ab.py).  4x4 tiles halve the threads with work per
// item; X took 1.24x as long with them in c64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4;   // = ops/block_diag.py _ROW_TILE
constexpr int kLaneTile = 2;  // = ops/block_diag.py _LANE_TILE
constexpr int kItem = 9;      // = ops/block_diag.py ITEM_FIELDS

struct Item {
  int mat, k0, nk, lane0, nl, b0, b1, q0, q1;
};

__device__ __forceinline__ Item load_item(const int* __restrict__ items, int i) {
  const int* p = items + (size_t)i * kItem;
  return Item{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
}

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// one complex element, global -> shared, asynchronously
template <typename T2>
__device__ __forceinline__ void cp_async_elem(T2* dst, const T2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T2)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage item `it` into buf: per block, As[j*gp + i] = A-entry feeding
// op(A)[i][j] (conjugated at use for the adjoint), rows g..gp zero; then
// Xs[q*g + j] = x of item lane q at packed column j, lanes Q..Qp zero.
template <typename T>
__device__ void stage(const Item& it, const c2_t<T>* __restrict__ vals,
                      const int* __restrict__ offs, const int* __restrict__ sizes,
                      const int* __restrict__ voffs, const int* __restrict__ perm,
                      const c2_t<T>* __restrict__ x, c2_t<T>* s, int nnz, int L, int H,
                      int adjoint) {
  using T2 = c2_t<T>;
  const int tid = threadIdx.x;
  const int Q = it.q1 - it.q0;
  const int Qp = round_up(Q, kLaneTile);
  const T2* A = vals + (size_t)it.mat * nnz;
  const T2 zero = cmake<T>(0, 0);
  const float inv_nl = 1.0f / (float)it.nl;
  for (int b = it.b0; b < it.b1; ++b) {
    const int g = sizes[b], gp = round_up(g, kRowTile), off = offs[b];
    const T2* Ab = A + voffs[b];
    T2* As = s;
    T2* Xs = s + g * gp;
    // element (row, col) <-> e = row << sh | col, with 1 << sh >= gp: no
    // integer division per element
    const int sh = 32 - __clz(gp - 1), mask = (1 << sh) - 1;
    for (int e = tid; e < (g << sh); e += kThreads) {
      const int r = e >> sh, c = e & mask;
      if (c < g) {  // A[r][c]
        cp_async_elem(As + (adjoint ? r * gp + c : c * gp + r), Ab + r * g + c);
      } else if (c < gp) {  // rows g .. gp of column r
        As[r * gp + c] = zero;
      }
    }
    for (int e = tid; e < (Qp << sh); e += kThreads) {
      const int q = e >> sh, j = e & mask;
      if (j >= g) continue;
      if (q < Q) {
        const int qq = it.q0 + q;
        const int kk = __float2int_rz(((float)qq + 0.5f) * inv_nl);  // qq / nl, exact here
        const int l = it.lane0 + qq - kk * it.nl;
        const int col = perm ? perm[off + j] : off + j;
        cp_async_elem(Xs + q * g + j, x + ((size_t)(it.k0 + kk) * L + l) * H + col);
      } else {
        Xs[q * g + j] = zero;
      }
    }
    s += g * gp + Qp * g;
  }
}

template <typename T>
__device__ __forceinline__ void load_rows(const c2_t<T>* p, c2_t<T> (&a)[kRowTile]) {
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) a[r] = p[r];
}

// c64: two 16-byte shared loads for the 4 rows (p is 16-byte aligned:
// j*gp + i0 and every buffer offset are even)
template <>
__device__ __forceinline__ void load_rows<float>(const float2* p, float2 (&a)[kRowTile]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  a[0] = make_float2(u.x, u.y);
  a[1] = make_float2(u.z, u.w);
  a[2] = make_float2(v.x, v.y);
  a[3] = make_float2(v.z, v.w);
}

template <typename T, bool ADJ>
__device__ void compute(const Item& it, const int* __restrict__ offs,
                        const int* __restrict__ sizes, const int* __restrict__ perm,
                        const c2_t<T>* s, c2_t<T>* __restrict__ y, int L, int H) {
  using T2 = c2_t<T>;
  const int Q = it.q1 - it.q0;
  const int Qp = round_up(Q, kLaneTile);
  const int nqt = Qp / kLaneTile;
  int e = threadIdx.x;  // tile index, carried across the item's blocks
  for (int b = it.b0; b < it.b1; ++b) {
    const int g = sizes[b], gp = round_up(g, kRowTile), off = offs[b];
    const int nrt = gp / kRowTile, nt = nrt * nqt;
    const T2* As = s;
    const T2* Xs = s + g * gp;
    for (; e < nt; e += kThreads) {
      const int i0 = (e % nrt) * kRowTile, qa = (e / nrt) * kLaneTile;
      T2 acc[kRowTile][kLaneTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
#pragma unroll
        for (int c = 0; c < kLaneTile; ++c) acc[r][c] = cmake<T>(0, 0);
      const T2* xa = Xs + qa * g;
      for (int j = 0; j < g; ++j) {
        T2 a[kRowTile];
        load_rows<T>(As + j * gp + i0, a);
        T2 xv[kLaneTile];
#pragma unroll
        for (int c = 0; c < kLaneTile; ++c) xv[c] = xa[c * g + j];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (ADJ) a[r].y = -a[r].y;
#pragma unroll
          for (int c = 0; c < kLaneTile; ++c) acc[r][c] = cfma<T>(a[r], xv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kLaneTile; ++c) {
        const int q = qa + c;
        if (q >= Q) continue;
        const int qq = it.q0 + q;
        T2* yl = y + ((size_t)(it.k0 + qq / it.nl) * L + it.lane0 + qq % it.nl) * H;
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const int i = i0 + r;
          if (i < g) yl[perm ? perm[off + i] : off + i] = acc[r][c];
        }
      }
    }
    e -= nt;
    s += g * gp + Qp * g;
  }
}

template <typename T, bool ADJ>
__global__ void __launch_bounds__(kThreads)
block_diag_cmm_kernel(const c2_t<T>* __restrict__ vals, const int* __restrict__ offs,
                      const int* __restrict__ sizes, const int* __restrict__ voffs,
                      const int* __restrict__ perm, const int* __restrict__ items,
                      int n_items, const c2_t<T>* __restrict__ x, c2_t<T>* __restrict__ y,
                      int nnz, int L, int H, int buf_elems) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* bufs = reinterpret_cast<T2*>(smem_raw);
  // Rounds of gridDim.x items, walked in alternating directions (items
  // are sorted largest first, so a CTA that takes a large item in one
  // round takes a small one in the next).
  const int G = gridDim.x, c = blockIdx.x, R = (n_items + G - 1) / G;
  auto item_at = [&](int r) { return (r & 1) ? (r + 1) * G - 1 - c : r * G + c; };
  int r = 0;  // item_at(0) < n_items: the grid is at most n_items
  stage<T>(load_item(items, item_at(0)), vals, offs, sizes, voffs, perm, x, bufs, nnz, L, H,
           ADJ);
  cp_async_commit();
  for (int cur = 0; r < R; cur ^= 1) {
    int rn = r + 1;
    while (rn < R && item_at(rn) >= n_items) ++rn;
    if (rn < R)  // stage the next item while this one computes
      stage<T>(load_item(items, item_at(rn)), vals, offs, sizes, voffs, perm, x,
               bufs + (cur ^ 1) * buf_elems, nnz, L, H, ADJ);
    cp_async_commit();
    cp_async_wait_prev();  // the current item's copies have landed
    __syncthreads();
    compute<T, ADJ>(load_item(items, item_at(r)), offs, sizes, perm, bufs + cur * buf_elems,
                    y, L, H);
    __syncthreads();  // its buffer is free for the item after next
    r = rn;
  }
}

template <typename T, bool ADJ>
cudaError_t run_t(const void* vals, const void* offs, const void* sizes, const void* voffs,
                  const void* perm, const void* items, int n_items, const void* x, void* y,
                  int nnz, int L, int H, int buf_elems, cudaStream_t stream) {
  auto kernel = block_diag_cmm_kernel<T, ADJ>;
  const size_t smem = 2 * sizeof(c2_t<T>) * (size_t)buf_elems;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int grid = n_items < per_sm * n_sm ? n_items : per_sm * n_sm;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const c2_t<T>*>(vals), static_cast<const int*>(offs),
      static_cast<const int*>(sizes), static_cast<const int*>(voffs),
      static_cast<const int*>(perm), static_cast<const int*>(items), n_items,
      static_cast<const c2_t<T>*>(x), static_cast<c2_t<T>*>(y), nnz, L, H, buf_elems);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* vals, const void* offs, const void* sizes, const void* voffs,
                const void* perm, const void* items, int n_items, const void* x, void* y,
                int nnz, int L, int H, int buf_elems, int adjoint, cudaStream_t stream) {
  if (n_items == 0) return cudaSuccess;
  if (adjoint)
    return run_t<T, true>(vals, offs, sizes, voffs, perm, items, n_items, x, y, nnz, L, H,
                          buf_elems, stream);
  return run_t<T, false>(vals, offs, sizes, voffs, perm, items, n_items, x, y, nnz, L, H,
                         buf_elems, stream);
}

}  // namespace

extern "C" int bhs_block_diag_cmm(const void* vals, const void* offs, const void* sizes,
                                  const void* voffs, const void* perm, const void* items,
                                  int n_items, const void* x, void* y, int nnz, int L, int H,
                                  int buf_elems, int adjoint, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(vals, offs, sizes, voffs, perm, items, n_items, x, y, nnz, L, H,
                            buf_elems, adjoint, st);
  return (int)run<float>(vals, offs, sizes, voffs, perm, items, n_items, x, y, nnz, L, H,
                         buf_elems, adjoint, st);
}
