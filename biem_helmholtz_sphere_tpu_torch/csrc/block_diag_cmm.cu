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
// - Row panels (d >= 4): a degree block of D too large to stage whole
//   with two lanes (400 x 400 at 4D n_end=20, 1.28 MB in complex64) gets
//   items that each cover rows [r0, r1) of op(A) x a chunk of at most 64
//   lanes, with at most one register tile per thread.  Such an item is
//   staged column panel by column panel (min(g, buf / (rp + Qp)) columns
//   each) through the same double buffer, and each thread carries its
//   tile's sums across the panels: the K-loop of a GEMM.  The sum over j
//   still runs in ascending order in one thread, whatever the panel
//   sizes, so the result is the one a whole-block stage would give.
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
constexpr int kItem = 11;     // = ops/block_diag.py ITEM_FIELDS

// rows [r0, min(r1, g)) of each block b0 .. b1 of matrix `mat`, item lanes
// [q0, q1) of the nk * nl lanes of the segment at lane0
struct Item {
  int mat, k0, nk, lane0, nl, b0, b1, q0, q1, r0, r1;
};

__device__ __forceinline__ Item load_item(const int* __restrict__ items, int i) {
  const int* p = items + (size_t)i * kItem;
  return Item{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10]};
}

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shape of block b's stage in column panel p (= ops/block_diag.py
// item_stages): rows of op(A) and their padding, the columns of a full
// panel, and this panel's first column and column count.
struct Panel {
  int g, rows, rp, cw, c0, cols;
};

__device__ __forceinline__ Panel panel_of(const Item& it, int g, int p, int buf) {
  const int rows = min(it.r1, g) - it.r0, rp = round_up(rows, kRowTile);
  const int qp = round_up(it.q1 - it.q0, kLaneTile);
  // a run of several blocks fits whole: one panel, no division
  const int cw = it.b1 - it.b0 == 1 ? min(g, buf / (rp + qp)) : g, c0 = p * cw;
  return Panel{g, rows, rp, cw, c0, min(cw, g - c0)};
}

// column panels of an item: one unless it is a single block that does not
// fit the buffer whole
__device__ __forceinline__ int n_panels(const Item& it, const int* __restrict__ sizes,
                                        int buf) {
  if (it.b1 - it.b0 != 1) return 1;
  const Panel pn = panel_of(it, sizes[it.b0], 0, buf);
  return (pn.g + pn.cw - 1) / pn.cw;
}

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

// Stage column panel p of item `it` into s: per block, As[j*rp + i] = the
// A-entry feeding op(A)[r0 + i][c0 + j] (conjugated at use for the
// adjoint), rows `rows` .. rp zero; then Xs[q*cols + j] = x of item lane q
// at packed column c0 + j, lanes Q..Qp zero.  For a whole block (rows [0,
// g), one panel) that is As[j*gp + i] and Xs[q*g + j].
template <typename T>
__device__ void stage(const Item& it, int p, const c2_t<T>* __restrict__ vals,
                      const int* __restrict__ offs, const int* __restrict__ sizes,
                      const int* __restrict__ voffs, const int* __restrict__ perm,
                      const c2_t<T>* __restrict__ x, c2_t<T>* s, int nnz, int L, int H,
                      int buf, int adjoint) {
  using T2 = c2_t<T>;
  const int tid = threadIdx.x;
  const int Q = it.q1 - it.q0;
  const int Qp = round_up(Q, kLaneTile);
  const T2* A = vals + (size_t)it.mat * nnz;
  const T2 zero = cmake<T>(0, 0);
  const float inv_nl = 1.0f / (float)it.nl;
  for (int b = it.b0; b < it.b1; ++b) {
    const Panel pn = panel_of(it, sizes[b], p, buf);
    const int g = pn.g, off = offs[b];
    const T2* Ab = A + voffs[b];
    T2* As = s;
    T2* Xs = s + pn.cols * pn.rp;
    // A's sub-rectangle [ar0, ar0 + ar) x [ac0, ac0 + ac), read along its
    // rows: op(A)'s rows x columns, or its columns x rows for the adjoint.
    // Its extent padded to op(A)'s rp rows (arp x acp) takes the zero rows
    // rows .. rp too.  Element (r, c) <-> e = r << sh | c with 1 << sh >=
    // acp: no integer division per element.
    const int ar = adjoint ? pn.cols : pn.rows, ac = adjoint ? pn.rows : pn.cols;
    const int arp = adjoint ? ar : pn.rp, acp = adjoint ? pn.rp : ac;
    const int ar0 = adjoint ? pn.c0 : it.r0, ac0 = adjoint ? it.r0 : pn.c0;
    int sh = 32 - __clz(acp - 1), mask = (1 << sh) - 1;
    for (int e = tid; e < (arp << sh); e += kThreads) {
      const int r = e >> sh, c = e & mask;
      if (c >= acp) continue;
      T2* dst = As + (adjoint ? r * pn.rp + c : c * pn.rp + r);
      if (r < ar && c < ac)
        cp_async_elem(dst, Ab + (ar0 + r) * g + ac0 + c);
      else
        *dst = zero;
    }
    sh = 32 - __clz(pn.cols - 1);
    mask = (1 << sh) - 1;
    for (int e = tid; e < (Qp << sh); e += kThreads) {
      const int q = e >> sh, j = e & mask;
      if (j >= pn.cols) continue;
      if (q < Q) {
        const int qq = it.q0 + q;
        const int kk = __float2int_rz(((float)qq + 0.5f) * inv_nl);  // qq / nl, exact here
        const int l = it.lane0 + qq - kk * it.nl;
        const int col = perm ? perm[off + pn.c0 + j] : off + pn.c0 + j;
        cp_async_elem(Xs + q * pn.cols + j, x + ((size_t)(it.k0 + kk) * L + l) * H + col);
      } else {
        Xs[q * pn.cols + j] = zero;
      }
    }
    s += pn.cols * pn.rp + Qp * pn.cols;
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

// Column panel p of np of item `it`, staged in s.  Each thread forms 4-row
// x 2-lane tiles of outputs in acc: zeroed at the first panel, summed over
// the panel's columns in order, written at the last.  An item of several
// panels has at most one tile per thread, so acc carries it across them.
template <typename T, bool ADJ>
__device__ __forceinline__ void compute(const Item& it, int p, int np,
                                        const int* __restrict__ offs,
                                        const int* __restrict__ sizes,
                                        const int* __restrict__ perm, const c2_t<T>* s,
                                        c2_t<T>* __restrict__ y, int L, int H, int buf,
                                        c2_t<T> (&acc)[kRowTile][kLaneTile]) {
  using T2 = c2_t<T>;
  const int Q = it.q1 - it.q0;
  const int Qp = round_up(Q, kLaneTile);
  const int nqt = Qp / kLaneTile;
  int e = threadIdx.x;  // tile index, carried across the item's blocks
  for (int b = it.b0; b < it.b1; ++b) {
    const Panel pn = panel_of(it, sizes[b], p, buf);
    const int off = offs[b], cols = pn.cols;
    const int nrt = pn.rp / kRowTile, nt = nrt * nqt;
    const T2* As = s;
    const T2* Xs = s + cols * pn.rp;
    for (; e < nt; e += kThreads) {
      const int i0 = (e % nrt) * kRowTile, qa = (e / nrt) * kLaneTile;
      if (p == 0) {
#pragma unroll
        for (int r = 0; r < kRowTile; ++r)
#pragma unroll
          for (int c = 0; c < kLaneTile; ++c) acc[r][c] = cmake<T>(0, 0);
      }
      const T2* xa = Xs + qa * cols;
      for (int j = 0; j < cols; ++j) {
        T2 a[kRowTile];
        load_rows<T>(As + j * pn.rp + i0, a);
        T2 xv[kLaneTile];
#pragma unroll
        for (int c = 0; c < kLaneTile; ++c) xv[c] = xa[c * cols + j];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (ADJ) a[r].y = -a[r].y;
#pragma unroll
          for (int c = 0; c < kLaneTile; ++c) acc[r][c] = cfma<T>(a[r], xv[c], acc[r][c]);
        }
      }
      if (p != np - 1) continue;
#pragma unroll
      for (int c = 0; c < kLaneTile; ++c) {
        const int q = qa + c;
        if (q >= Q) continue;
        const int qq = it.q0 + q;
        T2* yl = y + ((size_t)(it.k0 + qq / it.nl) * L + it.lane0 + qq % it.nl) * H;
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const int i = i0 + r;
          if (i < pn.rows) {
            const int row = off + it.r0 + i;
            yl[perm ? perm[row] : row] = acc[r][c];
          }
        }
      }
    }
    e -= nt;
    s += cols * pn.rp + Qp * cols;
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
  // round takes a small one in the next); each item is one stage per
  // column panel.
  const int G = gridDim.x, c = blockIdx.x, R = (n_items + G - 1) / G;
  auto item_at = [&](int r) { return (r & 1) ? (r + 1) * G - 1 - c : r * G + c; };
  T2 acc[kRowTile][kLaneTile];
  // items are read again where used (not carried across the loop): fewer
  // live registers beside acc
  int r = 0, p = 0;  // item_at(0) < n_items: the grid is at most n_items
  int np = n_panels(load_item(items, item_at(0)), sizes, buf_elems);
  stage<T>(load_item(items, item_at(0)), 0, vals, offs, sizes, voffs, perm, x, bufs, nnz, L, H,
           buf_elems, ADJ);
  cp_async_commit();
  for (int cur = 0; r < R; cur ^= 1) {
    int rn = r, pn = p + 1, npn = np;
    if (pn == np) {
      pn = 0;
      rn = r + 1;
      while (rn < R && item_at(rn) >= n_items) ++rn;
      if (rn < R) npn = n_panels(load_item(items, item_at(rn)), sizes, buf_elems);
    }
    if (rn < R)  // stage the next panel while this one computes
      stage<T>(load_item(items, item_at(rn)), pn, vals, offs, sizes, voffs, perm, x,
               bufs + (cur ^ 1) * buf_elems, nnz, L, H, buf_elems, ADJ);
    cp_async_commit();
    cp_async_wait_prev();  // the current panel's copies have landed
    __syncthreads();
    compute<T, ADJ>(load_item(items, item_at(r)), p, np, offs, sizes, perm,
                    bufs + cur * buf_elems, y, L, H, buf_elems, acc);
    __syncthreads();  // its buffer is free for the panel after next
    r = rn;
    p = pn;
    np = npn;
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
