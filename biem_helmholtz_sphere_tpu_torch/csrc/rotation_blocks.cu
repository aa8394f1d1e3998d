// K3: the rotation D(R) of every direction, degree block by degree block.
//
// Replaces the quadrature of biem_helmholtz_sphere_tpu/translation/
// _rotation.py:251-294 (rotation_blocks), whose plain version is
// translation/_rotation.py::_rotation_blocks_plain.  For each direction n
// and root-degree block l (g = harm_n_ndim(l, d) rows at offset o):
//
//   D_l[n][i, j] = sum_q ycw[q, o + i] Y_{o + j}(R_n^T s_q)
//
// with ycw = conj(Y) w at the quadrature nodes s_q (cached on the card) and
// R_n the rotation taking the root axis to the direction (`_rotation_to_
// axis`, [N, d, d]).  Only exact degree blocks are computed: the zeros
// between the blocks of a degree group hold by construction (the wrapper's
// buffer starts at zero), which is the mask the plain version applies.
// Each entry is written to both forms the callers read: the degree groups
// (`RotationD.blocks`, the sandwich's) and the packed blocks
// (`RotationD.packed`, KB's).
//
// Two kernels, one call.  rotated_angles_kernel rotates every node for
// every direction once and writes each tree node's angles there (the
// evaluator's tree_angles) to a scratch [N][3][n_nodes][Qp]; the tiles of
// a direction all read them.  rotation_blocks_kernel: a CTA per direction
// and 64 x 64 tile of one block runs the reduction over the nodes in
// chunks (32 nodes in complex64, 16 in complex128).  Per chunk it fills
// the node tables of the job factors that the tile's 64 columns read, and
// only those (translation/_rotation.py::_k3_plan: at most ~180 rows at
// any n_end, so the shared memory does not grow with n_end), with the
// device evaluator (harmonics.cuh: a recurrence per 'b'/'c' family from
// its seed, kept from the lowest step read, and the powers of e^{i phi}
// per 'a' node, a node a lane), forms the tile's 64 columns of harmonics
// as products of table rows, and multiplies them into the tile;
// [N, Q, H] is never formed.  The chunk's rows of ycw arrive by cp.async
// while its tables are filled, the next chunk's angles while it is worked.
// (Each Y_h from its nodes' seeds, a recurrence per entry, ran slower than
// the plain version at phase 8 (a)'s shapes.)  The product:
// - complex64: a 4 x 4 register tile a thread on the FP32 CUDA cores (no
//   TF32), rows 4 ty + i and columns tx + 16 j;
// - complex128: on the FP64 tensor cores (DMMA, mma_f64.cuh), a warp per
//   16 rows x 32 columns: A' = [Re ycw, Im ycw] node by node and B' =
//   [[Re Y, Im Y], [-Im Y, Re Y]], four real products per complex one;
// both summed in two levels, 64 nodes apart, then their partials (one
// sequence over ~10^4 nodes left D D^H - I at 4.7x the plain version's in
// complex128, the 4D n_end = 12 case of the card tests; 256 nodes apart,
// 2.2x in complex64 at the 3D bench's n_end = 32).
// One CTA sums every node of its entries in a fixed order (no atomics), so
// results repeat bit for bit.
//
// What bounds it: operations, 8 N Q sum_l g_l^2 real ones; the node tables
// cost at most a few thousand recurrence steps a node and tile (the
// families of its columns, each run from its seed).
#include <type_traits>

#include "harmonics.cuh"
#include "mma_f64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows and columns of a CTA's tile
constexpr int kPad = kTile + 4;
constexpr int kSumNodes = 64;   // nodes summed apart
constexpr int kQp = 32;         // the angle scratch's node axis, padded to it

// nodes per chunk: 32 in complex64, 16 in complex128 (its accumulators take
// 128 registers a lane: one CTA an SM)
template <typename T>
struct Kq {
  static constexpr int value = std::is_same<T, double>::value ? 16 : 32;
};

// per block: o, g, group size G, row of the block in its group, the group's
// entries before it per direction, the packed offset of the block
struct BlockInfo {
  int o, g, G, oi;
  long long gpre, voff;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared, asynchronously; zero-filled when !ok (src is then not read)
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B), "r"(ok ? B : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The angles of every node at every direction: ang [N][3][nn][Qp] (x, c, s)
template <typename T>
__global__ void __launch_bounds__(128)
rotated_angles_kernel(const T* __restrict__ s_cart, const T* __restrict__ rot,
                      hprog::Prog<T> pg, T* __restrict__ ang, int N, int Q, int Qp, int d) {
  const long long e = (long long)blockIdx.x * 128 + threadIdx.x;
  if (e >= (long long)N * Qp) return;
  const int n = (int)(e / Qp), qp = (int)(e % Qp);
  const int q = qp < Q ? qp : Q - 1;
  const T* R = rot + (size_t)n * d * d;
  T v[hprog::kMaxNodes + 1];
  for (int j = 0; j < d; ++j) {  // (R^T s)_j = sum_i R[i, j] s_i
    T sj = 0;
    for (int i = 0; i < d; ++i) sj = t_fma(R[i * d + j], s_cart[(size_t)i * Q + q], sj);
    v[j] = sj;
  }
  T ax[hprog::kMaxNodes], ac[hprog::kMaxNodes], as[hprog::kMaxNodes];
  hprog::tree_angles<T>(pg, v, ax, ac, as);
  const int nn = pg.n_nodes;
  T* out = ang + (size_t)n * 3 * nn * Qp + qp;
  for (int nid = 0; nid < nn; ++nid) {
    out[(size_t)(0 * nn + nid) * Qp] = ax[nid];
    out[(size_t)(1 * nn + nid) * Qp] = ac[nid];
    out[(size_t)(2 * nn + nid) * Qp] = as[nid];
  }
}

// shared memory of a CTA: the chunk's rows of ycw (As) and tile columns of
// harmonics (Bs), two chunks' angles, the node tables (`rows` rows), the
// tile columns' table rows
template <typename T>
size_t smem_bytes(int n_nodes, int rows) {
  constexpr int KQ = Kq<T>::value;
  return sizeof(c2_t<T>) * 2 * KQ * kPad + sizeof(T) * (2 * 3 * n_nodes + rows) * KQ +
         sizeof(int) * kTile * n_nodes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rotation_blocks_kernel(const c2_t<T>* __restrict__ ycw, const T* __restrict__ ang_all,
                       hprog::Prog<T> pg, const BlockInfo* __restrict__ blocks,
                       const int4* __restrict__ tiles, const int4* __restrict__ ctile,
                       const int* __restrict__ ccol, const hprog::FillItem* __restrict__ work,
                       int rows, c2_t<T>* __restrict__ grp, c2_t<T>* __restrict__ packed, int N,
                       int n_tiles, int Q, int Qp, int H, long long nnz) {
  using T2 = c2_t<T>;
  constexpr bool kDmma = std::is_same<T, double>::value;
  constexpr int KQ = Kq<T>::value;
  const int nn = pg.n_nodes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2(*As)[kPad] = reinterpret_cast<T2(*)[kPad]>(smem_raw);  // [KQ][kPad]
  T2(*Bs)[kPad] = As + KQ;                                  // [KQ][kPad]
  T* Ang = reinterpret_cast<T*>(Bs + KQ);                   // [2][3][nn][KQ]: x, c, s
  T* Tab = Ang + 2 * 3 * nn * KQ;                           // [rows][KQ]
  int* Cs = reinterpret_cast<int*>(Tab + (size_t)rows * KQ);  // [kTile][nn]

  const int tid = threadIdx.x;
  const int n = blockIdx.x / n_tiles;
  const int4 tl = tiles[blockIdx.x % n_tiles];  // block, i0, j0, column tile
  const BlockInfo bi = blocks[tl.x];
  const int i0 = tl.y, j0 = tl.z;
  const int4 ct = ctile[tl.w];  // its first work item, their number
  const T* ang_n = ang_all + (size_t)n * 3 * nn * Qp;
  // the table row of each tile column at each node (bit 30 for 'a'), as an
  // offset into Tab
  for (int e = tid; e < kTile * nn; e += kThreads) {
    const int v = ccol[(size_t)tl.w * kTile * nn + e];
    Cs[e] = (v & ((1 << 30) - 1)) * KQ | (v & (1 << 30));
  }
  auto load_ang = [&](int q0, T* dst) {  // 3 nn rows of KQ angles, 16-byte copies
    constexpr int kPer = 16 / sizeof(T);
    for (int e = tid; e < 3 * nn * (KQ / kPer); e += kThreads) {
      const int r = e / (KQ / kPer), u = (e % (KQ / kPer)) * kPer;
      cp_async<16>(dst + r * KQ + u, ang_n + (size_t)r * Qp + q0 + u, true);
    }
  };
  auto load_rows = [&](int q0) {  // the chunk's rows of ycw, zero past Q and g
    for (int e = tid; e < KQ * kTile; e += kThreads) {
      const int qq = e / kTile, i = e % kTile;
      const int q = q0 + qq;
      const bool ok = q < Q && i0 + i < bi.g;
      cp_async<sizeof(T2)>(&As[qq][i], ycw + (ok ? (size_t)q * H + bi.o + i0 + i : 0), ok);
    }
  };

  // complex64: thread (ty, tx) takes rows 4 ty + i, columns tx + 16 j (a
  // warp's column loads are consecutive: no bank conflict)
  const int ty = tid / 16, tx = tid % 16;
  T2 acc[4][4], part[4][4];
  // complex128: warp wp takes rows 16 (wp % 4) + ., columns 32 (wp / 4) + .
  const int lane = tid % 32, wp = tid / 32, g8 = lane >> 2, t4 = lane & 3;
  double dacc[8][4], dpart[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = cmake<T>(0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dacc[i][j] = dpart[i][j] = 0;

  // cp.async groups, oldest first: angles A_c, rows R_c, angles A_{c+1}, ...
  load_ang(0, Ang);
  cp_commit();
  load_rows(0);
  cp_commit();
  for (int q0 = 0, c = 0; q0 < Q; q0 += KQ, ++c) {
    // the next chunk's angles arrive while this chunk is worked
    if (q0 + KQ < Q) load_ang(q0 + KQ, Ang + ((c + 1) & 1) * 3 * nn * KQ);
    cp_commit();
    cp_wait<2>();  // A_c is in (R_c and A_{c+1} may not be)
    __syncthreads();
    const T* ang = Ang + (c & 1) * 3 * nn * KQ;
    // the tile columns' job factors at the chunk's rotated nodes: a work
    // item a group of KQ lanes, a node a lane (the longest items first)
    constexpr int kItemsPerWarp = 32 / KQ;
    for (int w = (tid / 32) * kItemsPerWarp + (tid % 32) / KQ; w < ct.y;
         w += (kThreads / 32) * kItemsPerWarp) {
      const int qq = tid % KQ;
      const hprog::FillItem it = work[ct.x + w];
      hprog::fill_item<T, 1>(it, pg, ang + (0 * nn + it.nid) * KQ + qq,
                             ang + (1 * nn + it.nid) * KQ + qq, ang + (2 * nn + it.nid) * KQ + qq,
                             1, Tab + qq, KQ);
    }
    __syncthreads();
    // the tile's columns of harmonics at them: products of table rows
#pragma unroll 4
    for (int e = tid; e < KQ * kTile; e += kThreads) {
      const int qq = e % KQ, j = e / KQ;
      T2 y = cmake<T>(0, 0);
      if (q0 + qq < Q && j0 + j < bi.g) {
        y = cmake<T>(1, 0);
        for (int nid = 0; nid < nn; ++nid) {
          const int v = Cs[j * nn + nid];
          const T* row = Tab + (v & ((1 << 30) - 1)) + qq;
          y = (v >> 30) ? cmul<T>(y, cmake<T>(row[0], row[KQ])) : cscale<T>(y, row[0]);
        }
      }
      Bs[qq][j] = y;
    }
    cp_wait<1>();  // R_c is in: it arrived while the tables were filled
    __syncthreads();
    const bool fold = (q0 + KQ) % kSumNodes == 0 || q0 + KQ >= Q;
    if constexpr (kDmma) {
      const double* ad = reinterpret_cast<const double*>(&As[0][0]);
      const int rb = 16 * (wp % 4), cb = 32 * (wp / 4);
#pragma unroll
      for (int kb = 0; kb < 2 * KQ; kb += 16) {  // k' = 2 node + part
        double a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kp = kb + t4 + 4 * (i >> 1);
          a[i] = ad[((kp >> 1) * kPad + rb + g8 + 8 * (i & 1)) * 2 + (kp & 1)];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = cb + 4 * nt + (g8 >> 1);
          double bfr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kp = kb + t4 + 4 * i;
            const T2 yv = Bs[kp >> 1][col];
            // B'[2q][Re] = Re Y, B'[2q+1][Re] = -Im Y; B'[2q][Im] = Im Y, B'[2q+1][Im] = Re Y
            bfr[i] = (g8 & 1) == 0 ? ((kp & 1) ? -yv.y : yv.x) : ((kp & 1) ? yv.x : yv.y);
          }
          mma_f64(dpart[nt], a, bfr);
        }
      }
      if (fold) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dacc[i][j] += dpart[i][j];
            dpart[i][j] = 0;
          }
      }
    } else {
#pragma unroll 4
      for (int qq = 0; qq < KQ; ++qq) {
        T2 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = As[qq][4 * ty + i];
          b[i] = Bs[qq][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = cfma<T>(a[i], b[j], part[i][j]);
      }
      if (fold) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = cadd<T>(acc[i][j], part[i][j]);
            part[i][j] = cmake<T>(0, 0);
          }
      }
    }
    __syncthreads();
    // the next chunk's rows arrive while its tables are filled
    if (q0 + KQ < Q) load_rows(q0 + KQ);
    cp_commit();
  }
  cp_wait<0>();

  const long long G = bi.G;
  T2* gout = grp + bi.gpre * N + (long long)n * G * G;
  T2* pout = packed + (long long)n * nnz + bi.voff;
  auto store = [&](int i, int j, T2 v) {
    if (i < bi.g && j < bi.g) {
      gout[(long long)(bi.oi + i) * G + bi.oi + j] = v;
      pout[(long long)i * bi.g + j] = v;
    }
  };
  if constexpr (kDmma) {
    const int rb = 16 * (wp % 4), cb = 32 * (wp / 4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = j0 + cb + 4 * nt + t4;
      store(i0 + rb + g8, j, cmake<T>(dacc[nt][0], dacc[nt][1]));
      store(i0 + rb + g8 + 8, j, cmake<T>(dacc[nt][2], dacc[nt][3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(i0 + 4 * ty + i, j0 + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
cudaError_t run(const void* ycw, const void* s_cart, const void* rot, const void* nodes,
                const void* jobs, const void* fam, const void* coef, const void* famr,
                int n_nodes, const void* blocks, const void* tiles, const void* ctile,
                const void* ccol, const void* work, int rows, void* ang, void* grp,
                void* packed, int N, int n_tiles, int Q, int H, int d, long long nnz,
                cudaStream_t stream) {
  using T2 = c2_t<T>;
  if (N == 0 || n_tiles == 0) return cudaSuccess;
  if (n_nodes > hprog::kMaxNodes) return cudaErrorInvalidValue;
  hprog::Prog<T> pg{static_cast<const int4*>(nodes), static_cast<const int4*>(jobs),
                    static_cast<const int*>(fam), static_cast<const T*>(coef),
                    static_cast<const T*>(famr), n_nodes};
  const int Qp = (Q + kQp - 1) / kQp * kQp;
  const long long n_ang = (long long)N * Qp;
  rotated_angles_kernel<T><<<(unsigned)((n_ang + 127) / 128), 128, 0, stream>>>(
      static_cast<const T*>(s_cart), static_cast<const T*>(rot), pg, static_cast<T*>(ang), N, Q,
      Qp, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T>(n_nodes, rows);
  auto kernel = rotation_blocks_kernel<T>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)N * n_tiles), kThreads, smem, stream>>>(
      static_cast<const T2*>(ycw), static_cast<const T*>(ang), pg,
      static_cast<const BlockInfo*>(blocks), static_cast<const int4*>(tiles),
      static_cast<const int4*>(ctile), static_cast<const int*>(ccol),
      static_cast<const hprog::FillItem*>(work), rows, static_cast<T2*>(grp),
      static_cast<T2*>(packed), N, n_tiles, Q, Qp, H, nnz);
  return cudaGetLastError();
}

}  // namespace

// ycw [Q, H] complex; s_cart [d, Q]; rot [N, d, d]; the program's tables
// (ops/harmonic_program.py); K3's plan (translation/_rotation.py::_k3_plan):
// blocks [n_blocks] of BlockInfo (8 int32 each), tiles [n_tiles] of
// (block, i0, j0, column tile), ctile [n_ct] of (first item, items, 0, 0),
// ccol [n_ct, 64, n_nodes], work [n_work] of FillItem, rows the node
// tables' rows; ang a scratch of N 3 n_nodes Qp reals (Qp: Q rounded up to
// 32); grp the degree groups, each [N, G, G] at N gpre, zero-filled;
// packed [N, nnz].
extern "C" int bhs_rotation_blocks(const void* ycw, const void* s_cart, const void* rot,
                                   const void* nodes, const void* jobs, const void* fam,
                                   const void* coef, const void* famr, int n_nodes,
                                   const void* blocks, const void* tiles, const void* ctile,
                                   const void* ccol, const void* work, int rows, void* ang,
                                   void* grp, void* packed, int N, int n_tiles, int Q, int H,
                                   int d, long long nnz, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(ycw, s_cart, rot, nodes, jobs, fam, coef, famr, n_nodes, blocks,
                            tiles, ctile, ccol, work, rows, ang, grp, packed, N, n_tiles, Q, H,
                            d, nnz, st);
  return (int)run<float>(ycw, s_cart, rot, nodes, jobs, fam, coef, famr, n_nodes, blocks, tiles,
                         ctile, ccol, work, rows, ang, grp, packed, N, n_tiles, Q, H, d, nnz,
                         st);
}
