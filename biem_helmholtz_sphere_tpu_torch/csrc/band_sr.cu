// KS: the banded (S|R) (or (R|R)) table of any tree in d >= 3, with the
// exponent fold; KF, its F pass.
//
// Replaces biem_helmholtz_sphere_tpu/ops/pallas_sr.py::sr_banded_pallas
// (deleted in commit 545c0ad), whose work lives on in the JAX package's
// translation/_ops.py::_sr_banded (the masked band scan) and
// translation/_scaled.py::sr_banded_scaled (the same with per-band
// exponents), with the ball-max fold of biem/_core.py.
//
//   table[k, o, h', h] = i^{n_h' - n_h} sum_q F_N(q) conj(Y_h'(s_q)) Y_h(s_q)
//   F_N(q) = w_q sum_{n <= N} coef[k, o, N, n] C_n(t^_o . s_q),  N = n_h' + n_h
//
// with C_n the Gegenbauer polynomial of index nu = (d - 2) / 2, and coef the
// band coefficients i^n A_d rad_n(k |t_o|) (2n + d - 2) / ((d - 2) Omega_d),
// in the scaled modes times exp(min(he_n - he_N, 80)) (ops/band_sr.py).  The
// masked scan's sum over the bands n <= N of whole [H, H] contractions is the
// contraction of the prefix F_N: an entry still meets only the bands at or
// below its own Gaunt support, and each costs one complex product per node.
// In fold mode the store multiplies by exp(e_r[k, h'] + he[k, o, N] +
// e_b[k, h]), the exponents summed before the exp (only the sum is finite in
// float32).
//
// What bounds it on the H100: operations, 8 K NO Ho Hi Q real ones (four
// real products per complex one, entry and node) at 67 TFLOP/s: complex128
// on the FP64 tensor cores (DMMA, mma.sync m16n8k16 .f64), complex64 on the
// FP32 CUDA cores (no TF32: the harmonic products cancel).  F is 2 K NO Q
// NB complex operations, a few percent.  What holds it back: in
// complex128 the inner loop itself (the shared loads of A' and of the raw
// columns and F that each lane forms its B' entries from, between the
// MMAs), in complex64 also the work around the products.  Every CTA
// streams all Q nodes of its rows, columns and F through shared memory,
// and with one CTA an SM (the accumulators take 128 registers a lane) the
// staging and the Y_in F writes do not overlap the products fully: a copy
// that stages and prepares nothing took 83 % of KS's time in complex128
// and 69 % in complex64 (tools/torch_kernel_ab.py; PERF.md, PR 12).
//
// Design, two launches per group of offsets (the wrapper cuts K NO into
// groups whose F fits its scratch budget):
// - KF (band_f_kernel): F_N(q) for every N < NB, node and offset of the
//   group, once, written as F [G, NB, Qp] (zero past Q), each band's nodes
//   contiguous.  What bounds it: F's write, 8 (complex64) or 16 bytes per
//   band, node and offset at 3.35 TB/s; the NB (NB + 1) / 2 complex-by-real
//   products per node and offset come to ~40 % of that time on the FP32
//   and FP64 pipes, the recurrence (its division without a divide:
//   `kf_div`) about as much again.  A thread takes two nodes and, per
//   chunk of kFWidth = 16 bands, holds their accumulators in registers
//   while it walks n upwards, forming C_n by the recurrence in registers
//   (a chunk after the first reruns it, so any NB fits); the chunk's
//   coefficients come into shared memory a slice of 16 rows at a time by
//   cp.async, the next slice's copies in flight while this one is summed,
//   row n holding its bands side by side, so that one warp-uniform 16-byte
//   load feeds 8 FMAs (complex64) or 4 DFMAs (complex128).  Each warp
//   stores 512 contiguous bytes per instruction, streaming (st.global.cs:
//   F is far beyond L2, and KS reads it later).
// - KS (band_sr_kernel): a CTA per (4 offsets, 64 columns, slot), a slot
//   being two consecutive M-tiles of at most 16 rows of one root degree
//   (the host's `row_plan`), so F_N is a column factor.  The 4 offsets
//   share the staged rows and columns: per chunk of 16 nodes a four-stage
//   cp.async ring brings in the raw Y_out rows, the raw Y_in columns and,
//   for each offset, F at the tile's N range only (16-byte copies, zero
//   filled past Q and the tables' padded width; the rows of complex64 in
//   8-byte copies, since a degree block may start on an odd row).  What
//   the products read besides is prepared for the next chunk into one of
//   two buffers while the products of this one read the other (one
//   barrier a chunk):
//   * complex128: F in three forms (u, v) (prep_f: a few hundred values a
//     chunk), and each warp takes one offset's 32 rows by 32 columns as a
//     real product on DMMA: A' = [Re Y_out, Im Y_out] node by node (the raw
//     rows, no copy), B' = [[Re B, Im B], [Im B, -Re B]] for B = Y_in F,
//     each lane forming its entry Re(Y_in) u + Im(Y_in) v in registers, so
//     that A' B' gives conj(Y_out)^T (Y_in F) with four real products per
//     complex one (no Karatsuba); 128 accumulator registers a lane, one sum
//     over the nodes in the MMA's order (float64 loses ~1e-13 there).
//   * complex64: Y_in F per offset (build_bs), and each thread takes 4
//     rows by 8 columns of one offset (two 128-bit shared loads of the rows
//     and four of the columns per node for 32 complex FMAs), summed in two
//     levels: 256 nodes apart, then their partials (a single float32
//     sequence over tens of thousands of nodes loses ~5e-5 of the small
//     degree blocks).
//   No atomics: one thread writes each entry, so results repeat bit for
//   bit.  The 16-row tiles cost 12 % of padded MACs at 'caa' n_end = 14
//   (1,136 rows for 1,015), an empty M-tile of a slot none (its products
//   are skipped).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_f64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;         // rows of an M-tile (one degree)
constexpr int kRows = 2 * kTile;  // a CTA's rows: one slot of two M-tiles of one degree
constexpr int kCols = 64;         // columns of a CTA
constexpr int kOffs = 4;          // offsets of a CTA, sharing its staged rows and columns
constexpr int kArow = kRows + 4;  // staged rows per node (+4: banks)
constexpr int kBrow = kCols + 4;  // staged columns per node (+4: banks)
constexpr int kStages = 4;        // the cp.async ring
constexpr int kSumNodes = 256;    // complex64: nodes summed apart
constexpr int kMaxDim = 32;       // the largest d
constexpr int kFThreads = 128;    // KF: threads a CTA
constexpr int kFNodes = 2;        // KF: nodes a thread
constexpr int kFWidth = 16;       // KF: bands a thread accumulates at once (a chunk)

constexpr int KQ = 16;            // nodes per staged chunk
constexpr int kK = 16;            // the f64 MMA's depth (m16n8k16)

// v * i^p, p in 0..3: exact
template <typename T>
__device__ __forceinline__ c2_t<T> rotate(c2_t<T> v, int p) {
  switch (p) {
    case 1: return cmake<T>(-v.y, v.x);
    case 2: return cmake<T>(-v.x, -v.y);
    case 3: return cmake<T>(v.y, -v.x);
    default: return v;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
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

// acc + conj(a) b
__device__ __forceinline__ float2 cfma_conj(float2 a, float2 b, float2 acc) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
  return acc;
}

// ---------------------------------------------------------------- KF

// The recurrence's factors of a row n: 2 (n + nu), n + 2 nu - 1 and
// RN(1 / (n + 1)), each rounded as the recurrence with a division rounds
// them (below)
template <typename T>
struct KfRow {
  T a, b, y;
};

// A slice of a chunk's coefficients: rows n0 .. n0 + W - 1 of the chunk
// of bands N0 .. N0 + W - 1 (chunk c, `kf_chunks`).  A chunk's slices are
// its rows below N0, W at a time, then its own W rows (n0 = N0: the
// triangle).
struct KfSlice {
  int c, N0, n0;
};

template <int W>
__device__ __forceinline__ KfSlice kf_chunk_start(int c, int NB) {
  const int N0 = NB > W ? min(c * W, NB - W) : 0;
  return {c, N0, 0};
}

template <int W>
__device__ __forceinline__ KfSlice kf_next(KfSlice s, int NB) {
  if (s.n0 == s.N0) return kf_chunk_start<W>(s.c + 1, NB);
  return {s.c, s.N0, min(s.n0 + W, s.N0)};
}

// The slice's coefficients into `cs`, row n (of kLd values) holding
// coef[N0 + j, n] at column j, zero where n > N0 + j or N0 + j >= NB (the
// prefix's triangle, the bands past the last), by asynchronous copies
// (the caller commits and waits); and the recurrence's factors of its
// rows into `rf`.
template <typename T, int W>
__device__ __forceinline__ void kf_stage(c2_t<T>* cs, KfRow<T>* rf, const c2_t<T>* __restrict__ ck,
                                         KfSlice s, int NB, T nu, int tid) {
  constexpr int kLd = W + 16 / (int)sizeof(c2_t<T>);
  if (tid < W) {
    const int n = s.n0 + tid;
    rf[tid] = {2 * ((T)n + nu), (T)n + 2 * nu - 1, (T)1 / (T)(n + 1)};
  }
  for (int e = tid; e < W * W; e += kFThreads) {
    const int j = e / W;
    const int nn = e - j * W;  // consecutive threads: consecutive n, one row of coef
    const int N = s.N0 + j;
    const int n = s.n0 + nn;
    const bool ok = N < NB && n <= N;
    const c2_t<T>* src = ck + (ok ? (size_t)N * NB + n : 0);
    if constexpr (sizeof(c2_t<T>) == 16)
      cp16(cs + nn * kLd + j, src, ok);
    else
      cp8(cs + nn * kLd + j, src, ok);
  }
}

// acc[i][j] += coef[N0 + j, n] C_n at the thread's nodes i, for the columns
// j >= j0 (compile-time in the triangle: its zeros are skipped), from row
// n of the staged coefficients: one warp-uniform 16-byte shared load for
// two columns (complex64) or one (complex128), one FMA per part
template <typename T, int W>
__device__ __forceinline__ void kf_row(c2_t<T> (&acc)[kFNodes][W], const c2_t<T>* row,
                                       const T (&cc)[kFNodes], int j0) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
      if (j + 1 < j0) continue;
      const float4 v = *reinterpret_cast<const float4*>(row + j);
#pragma unroll
      for (int i = 0; i < kFNodes; ++i) {
        if (j >= j0) {
          acc[i][j].x = t_fma(v.x, cc[i], acc[i][j].x);
          acc[i][j].y = t_fma(v.y, cc[i], acc[i][j].y);
        }
        acc[i][j + 1].x = t_fma(v.z, cc[i], acc[i][j + 1].x);
        acc[i][j + 1].y = t_fma(v.w, cc[i], acc[i][j + 1].y);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < j0) continue;
      const double2 v = row[j];
#pragma unroll
      for (int i = 0; i < kFNodes; ++i) {
        acc[i][j].x = t_fma(v.x, cc[i], acc[i][j].x);
        acc[i][j].y = t_fma(v.y, cc[i], acc[i][j].y);
      }
    }
  }
}

__device__ __forceinline__ float t_mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double t_mul_rn(double a, double b) { return __dmul_rn(a, b); }

// a / b rounded to nearest without a divide, from y = RN(1 / b), for an
// integer 1 <= b <= 2^20: q0 = RN(a y) lies within 1.5 ulp of a / b, so r =
// a - b q0 is exact by the FMA, and q0 + r y lies within 2^-p ulp of a /
// b, which is at least 2^-21 ulp from a midpoint between two floats (or on
// a float): RN(q0 + r y) is RN(a / b) wherever the quotient is a normal
// number, for finite |a| >= 2^-100 in float and 2^-1000 in double by the
// check of every float a and of 2^31 double a for each b = 1 .. 256
// (tools/kf_div_check.cu).  A zero a may give a zero of the other sign,
// which F never sees (a sum that starts at +0 stays +0 through zero
// terms); an infinite a gives NaN (the recurrence has overflowed).  The
// division's own code, its reciprocal refined and its slow-path call,
// costs 10-25 instructions a node and step, and its branches fence the
// scheduler.
template <typename T>
__device__ __forceinline__ T kf_div(T a, T b, T y) {
  const T q0 = t_mul_rn(a, y);
  return t_fma(t_fma(-b, q0, a), y, q0);
}

// C_{n+1} from C_n = cc and C_{n-1} = cm at each node by (n + 1) C_{n+1} =
// 2 (n + nu) x C_n - (n + 2 nu - 1) C_{n-1}, from the row's factors: the
// expression and roundings of that recurrence with its division
template <typename T>
__device__ __forceinline__ void kf_step(T (&cm)[kFNodes], T (&cc)[kFNodes],
                                        const T (&x)[kFNodes], int n, KfRow<T> f) {
#pragma unroll
  for (int i = 0; i < kFNodes; ++i) {
    const T cn = kf_div<T>(f.a * x[i] * cc[i] - f.b * cm[i], (T)(n + 1), f.y);
    cm[i] = cc[i];
    cc[i] = cn;
  }
}

// KF: F [G, NB, Qp], F_N(q) = w_q sum_{n <= N} coef[k, o, N, n] C_n(x_q),
// x_q = t^_o . s_q, for the offsets ko0 .. ko0 + G - 1 (blockIdx.y) and a
// tile of kFThreads * kFNodes nodes (blockIdx.x).  Each thread holds the
// accumulators of a chunk of W bands at its two nodes in registers and
// walks n upwards, forming C_n by the recurrence as it goes; a chunk after
// the first (`kf_chunks`) reruns it.  The chunk's coefficients come slice
// after slice through two shared buffers, the next slice's copies in
// flight while this one's rows are summed (one barrier a slice): its rows
// below N0 in a loop, its own W rows unrolled, column j from row j on.
// Every sum runs in ascending n with the same FMAs as a single sum per (N,
// node), the recurrence's quotients are the division's (`kf_div`), and
// past Q a node has x = 0, w = 0: F has the bits of a thread per node
// running the recurrence with its division and each sum in that order,
// wherever every numerator is zero or finite and at least `kf_div`'s
// bound.  No atomics: one thread writes each value, and launches repeat
// bit for bit.
template <typename T>
__global__ void __launch_bounds__(kFThreads)
band_f_kernel(const c2_t<T>* __restrict__ coef, const T* __restrict__ t_hat, long long t_k,
              const T* __restrict__ w, const T* __restrict__ s_cart, c2_t<T>* __restrict__ F,
              int ko0, int NO, int d, int Q, int Qp, int NB, T nu) {
  using T2 = c2_t<T>;
  constexpr int W = kFWidth;
  constexpr int kLd = W + 16 / (int)sizeof(T2);  // a staged row (+16 bytes: banks)
  constexpr bool kPair = sizeof(T2) == 8;        // complex64: two adjacent nodes a lane
  __shared__ __align__(16) T2 cs[2][W * kLd];
  __shared__ KfRow<T> rf[2][W];
  __shared__ T th[kMaxDim];

  const int z = blockIdx.y;
  const int ko = ko0 + z;
  const int k = ko / NO;
  const int o = ko - k * NO;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int qw = blockIdx.x * (kFThreads * kFNodes) + (tid >> 5) * (32 * kFNodes);
  const T2* ck = coef + (size_t)ko * NB * NB;
  T2* fz = F + (size_t)z * NB * Qp;
  KfSlice s = kf_chunk_start<W>(0, NB);
  kf_stage<T, W>(cs[0], rf[0], ck, s, NB, nu, tid);
  cp_commit();
  if (tid < d) th[tid] = __ldg(t_hat + k * t_k + (long long)o * d + tid);
  __syncthreads();
  int q[kFNodes];
  T x[kFNodes], wq[kFNodes];
#pragma unroll
  for (int i = 0; i < kFNodes; ++i) {
    q[i] = kPair ? qw + kFNodes * lane + i : qw + 32 * i + lane;
    x[i] = 0;
    if (q[i] < Q)
      for (int a = 0; a < d; ++a) x[i] = t_fma(th[a], __ldg(s_cart + (size_t)a * Q + q[i]), x[i]);
    wq[i] = q[i] < Q ? __ldg(w + q[i]) : (T)0;
  }
  T2 acc[kFNodes][W];
  T cm[kFNodes], cc[kFNodes];
  for (int sl = 0;; ++sl) {
    if (s.n0 == 0) {  // a chunk's first slice: the recurrence from C_0
#pragma unroll
      for (int i = 0; i < kFNodes; ++i) {
        cm[i] = 0;
        cc[i] = 1;
#pragma unroll
        for (int j = 0; j < W; ++j) acc[i][j] = cmake<T>(0, 0);
      }
    }
    cp_wait<0>();
    __syncthreads();  // slice sl has landed; every thread is done with slice sl - 1
    const KfSlice nx = kf_next<W>(s, NB);
    const bool more = nx.c * W < NB;
    if (more) kf_stage<T, W>(cs[(sl + 1) & 1], rf[(sl + 1) & 1], ck, nx, NB, nu, tid);
    cp_commit();
    const T2* buf = cs[sl & 1];
    const KfRow<T>* rb = rf[sl & 1];
    if (s.n0 < s.N0) {  // rows below the chunk: every column
      const int rows = min(W, s.N0 - s.n0);
#pragma unroll 1
      for (int nn = 0; nn < rows; ++nn) {
        kf_row<T, W>(acc, buf + nn * kLd, cc, 0);
        kf_step<T>(cm, cc, x, s.n0 + nn, rb[nn]);
      }
    } else {  // the chunk's own rows, then its stored bands
#pragma unroll
      for (int nn = 0; nn < W; ++nn) {
        if (s.N0 + nn >= NB) break;  // NB < W only
        kf_row<T, W>(acc, buf + nn * kLd, cc, nn);
        if (nn + 1 < W) kf_step<T>(cm, cc, x, s.N0 + nn, rb[nn]);
      }
      // F_N = w_q acc[N - N0], streamed past L1
      const int j_lo = s.c * W - s.N0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < j_lo || s.N0 + j >= NB) continue;
        T2* fr = fz + (size_t)(s.N0 + j) * Qp;
        if constexpr (kPair) {
          if (q[0] < Qp) {
            const T2 a = cscale<T>(acc[0][j], wq[0]);
            const T2 b = cscale<T>(acc[1][j], wq[1]);
            __stcs(reinterpret_cast<float4*>(fr + q[0]), make_float4(a.x, a.y, b.x, b.y));
          }
        } else {
#pragma unroll
          for (int i = 0; i < kFNodes; ++i)
            if (q[i] < Qp) __stcs(fr + q[i], cscale<T>(acc[i][j], wq[i]));
        }
      }
    }
    if (!more) break;
    s = nx;
  }
}

// ---------------------------------------------------------------- KS

// The CTA's staging of the chunk of nodes q0 .. q0 + KQ - 1 into one stage
// of the ring: rows r0 .. r0 + 31 of Y_out [KQ][kArow], columns c0 .. c0 +
// 63 of Y_in [KQ][kBrow], and F [kOffs][w_max][KQ] of its n_off offsets at
// N = n_lo .. n_lo + W - 1.
template <typename T>
__device__ __forceinline__ void stage_chunk(c2_t<T>* as, const c2_t<T>* __restrict__ yo,
                                            const c2_t<T>* __restrict__ yi,
                                            const c2_t<T>* __restrict__ fz, int r0, int q0,
                                            int c0, int n_lo, int W, int w_max, int n_off,
                                            int Q, int Qp, int Hop, int Hip, int NB, int tid) {
  using T2 = c2_t<T>;
  T2* bs = as + KQ * kArow;
  T2* fs = bs + KQ * kBrow;
  for (int e = tid; e < KQ * kRows; e += kThreads) {
    const int qq = e / kRows;
    const int r = r0 + e - qq * kRows;
    const int q = q0 + qq;
    const bool ok = q < Q && r < Hop;
    const T2* src = yo + (ok ? (size_t)q * Hop + r : 0);
    if constexpr (sizeof(T2) == 16)
      cp16(as + qq * kArow + r - r0, src, ok);
    else
      cp8(as + qq * kArow + r - r0, src, ok);
  }
  constexpr int kPer = 16 / sizeof(T2);  // complex values per 16-byte copy
  for (int e = tid; e < KQ * kCols / kPer; e += kThreads) {
    const int qq = e / (kCols / kPer);
    const int c = (e - qq * (kCols / kPer)) * kPer;
    const int q = q0 + qq;
    const bool ok = q < Q && c0 + c < Hip;
    cp16(bs + qq * kBrow + c, yi + (ok ? (size_t)q * Hip + c0 + c : 0), ok);
  }
  // F: the KQ values of one (offset, N) are contiguous, kFc copies
  constexpr int kFc = KQ * (int)sizeof(T2) / 16;
  for (int e = tid; e < n_off * W * kFc; e += kThreads) {
    const int pw = e / kFc;
    const int u = e - pw * kFc;
    const int p = pw / W;
    const int wv = pw - p * W;
    const char* src = reinterpret_cast<const char*>(fz + ((size_t)p * NB + n_lo + wv) * Qp + q0);
    char* dst = reinterpret_cast<char*>(fs + (p * w_max + wv) * KQ);
    cp16(dst + 16 * u, src + 16 * u, true);
  }
}

// complex64: Y_in F_N of a landed chunk at each column's N = slot degree +
// column degree, for each of the CTA's offsets: bs [kOffs][KQ][kBrow]
__device__ __forceinline__ void build_bs(float2* bs, const float2* stage, int n_off, int w_max,
                                         const int* ncol, int tid) {
  const float2* braw = stage + KQ * kArow;
  const float2* fs = braw + KQ * kBrow;
  for (int e = tid; e < n_off * KQ * kCols; e += kThreads) {
    const int p = e / (KQ * kCols);
    const int rem = e - p * (KQ * kCols);
    const int qq = rem / kCols;
    const int cc = rem - qq * kCols;
    bs[(p * KQ + qq) * kBrow + cc] =
        cmul<float>(braw[qq * kBrow + cc], fs[(p * w_max + ncol[cc]) * KQ + qq]);
  }
}

// complex128: F of a landed chunk in the three forms (u, v) the lanes need,
// so that a lane's B' fragment entry is Re(Y_in) u + Im(Y_in) v:
// Re(Y_in F) from (Re F, -Im F), Im(Y_in F) from (Im F, Re F), and
// -Re(Y_in F) from (-Re F, Im F); fq [kOffs][w_max][KQ][3]
__device__ __forceinline__ void prep_f(double2* fq, const double2* stage, int n_off, int w_max,
                                       int tid) {
  const double2* fs = stage + KQ * (kArow + kBrow);
  for (int e = tid; e < n_off * w_max * KQ; e += kThreads) {
    const double2 f = fs[e];
    fq[3 * e] = make_double2(f.x, -f.y);
    fq[3 * e + 1] = make_double2(f.y, f.x);
    fq[3 * e + 2] = make_double2(-f.x, f.y);
  }
}

// complex128: the chunk's product on DMMA, a warp per offset x 32 columns
// (kM M-tiles x four n8 tiles of complex columns as eight of real ones).
// Each lane forms its B' entries from the raw columns and its offset's F:
// wq[nt] is the offset of its column's N in fq, form its (u, v).
template <int kM>
__device__ __forceinline__ void chunk_dmma(double (&acc)[2][8][4], const double2* as,
                                           const double2* braw, const double2* fq,
                                           const int (&wq)[8], int form, int wn, int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const double* ad = reinterpret_cast<const double*>(as);
#pragma unroll
  for (int kb = 0; kb < 2 * KQ; kb += kK) {
    double a[kM][kK / 2];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kK / 2; ++i) {
        const int kp = kb + t4 + 4 * (i >> 1);  // k' = 2 node + part
        const int row = kTile * m + g + 8 * (i & 1);
        a[m][i] = ad[((kp >> 1) * kArow + row) * 2 + (kp & 1)];
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      double b[kK / 4];
      const int col = 32 * wn + 4 * nt + (g >> 1);
#pragma unroll
      for (int i = 0; i < kK / 4; ++i) {
        const int qq = (kb + t4 + 4 * i) >> 1;
        const double2 y = braw[qq * kBrow + col];
        const double2 uv = fq[wq[nt] + 3 * qq + form];
        b[i] = fma(y.x, uv.x, y.y * uv.y);
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) mma_f64(acc[m][nt], a[m], b);
    }
  }
}

// complex64: the chunk's product on the CUDA cores, 4 rows x 8 columns a
// thread (rows 4 ty + i, columns 16 j + 2 tx + e)
__device__ __forceinline__ void chunk_simt(float2 (&part)[4][8], const float2* as,
                                           const float2* bsl, int ty, int tx) {
#pragma unroll 4
  for (int qq = 0; qq < KQ; ++qq) {
    const float4 a01 = *reinterpret_cast<const float4*>(as + qq * kArow + 4 * ty);
    const float4 a23 = *reinterpret_cast<const float4*>(as + qq * kArow + 4 * ty + 2);
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(bsl + qq * kBrow + 16 * j + 2 * tx);
    const float2 a[4] = {make_float2(a01.x, a01.y), make_float2(a01.z, a01.w),
                         make_float2(a23.x, a23.y), make_float2(a23.z, a23.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[i][2 * j] = cfma_conj(a[i], make_float2(b[j].x, b[j].y), part[i][2 * j]);
        part[i][2 * j + 1] = cfma_conj(a[i], make_float2(b[j].z, b[j].w), part[i][2 * j + 1]);
      }
  }
}

template <typename T>
__device__ __forceinline__ void store_entry(c2_t<T>* __restrict__ out, c2_t<T> v, int ko,
                                            int k, int r, int c, int nr, int nc, int Ho,
                                            int Hi, int NB, const T* __restrict__ he,
                                            const T* __restrict__ e_r,
                                            const T* __restrict__ e_b, bool fold) {
  v = rotate<T>(v, (nr - nc) & 3);
  if (fold)
    v = cscale<T>(v, t_exp(__ldg(e_r + (size_t)k * Ho + r) +
                           __ldg(he + (size_t)ko * NB + nr + nc) +
                           __ldg(e_b + (size_t)k * Hi + c)));
  out[((size_t)ko * Ho + r) * Hi + c] = v;
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
band_sr_kernel(const c2_t<T>* __restrict__ F, const c2_t<T>* __restrict__ yo,
               const c2_t<T>* __restrict__ yi, const int* __restrict__ n_o,
               const int* __restrict__ n_i, const int* __restrict__ row_plan,
               const T* __restrict__ he, const T* __restrict__ e_r,
               const T* __restrict__ e_b, c2_t<T>* __restrict__ out, int ko0, int G, int NO,
               int Q, int Qp, int Ho, int Hi, int Hop, int Hip, int NB, int w_max) {
  using T2 = c2_t<T>;
  constexpr bool kDmma = std::is_same<T, double>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage_elems = KQ * (kArow + kBrow + kOffs * w_max);
  T2* ring = reinterpret_cast<T2*>(smem_raw);  // kStages x [rows | columns | F]
  // two chunks' worth of what the products read besides the rows: complex128
  // F's lane forms [kOffs][w_max][KQ][3], complex64 Y_in F [kOffs][KQ][kBrow]
  T2* prep = ring + kStages * stage_elems;
  const int prep_elems = kDmma ? kOffs * w_max * KQ * 3 : kOffs * KQ * kBrow;
  __shared__ int ncol[kCols];  // each column's N - n_lo

  const int z0 = blockIdx.x * kOffs;  // the CTA's first offset in the group
  const int n_off = min(kOffs, G - z0);
  const int c0 = blockIdx.y * kCols;
  const int* plan = row_plan + (size_t)blockIdx.z * 4;
  const int r0 = __ldg(plan);
  const int rhi0 = __ldg(plan + 1);
  const int rlo1 = __ldg(plan + 2);
  const int rhi1 = __ldg(plan + 3);
  const bool on1 = rhi1 > rlo1;
  const int deg = __ldg(n_o + r0);  // the slot's one row degree
  const int n_lo = deg + __ldg(n_i + c0);
  const int W = deg + __ldg(n_i + min(c0 + kCols, Hi) - 1) - n_lo + 1;
  const int tid = threadIdx.x;
  for (int c = tid; c < kCols; c += kThreads)
    ncol[c] = __ldg(n_i + min(c0 + c, Hi - 1)) + deg - n_lo;
  const T2* fz = F + (size_t)z0 * NB * Qp;
  const int nch = (Q + KQ - 1) / KQ;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  // complex128: warp (p, wn) = (offset, 32-column half); complex64: thread
  // (p, ty, tx), its M-tile ty / 4 the warp's
  const int p = kDmma ? (warp >> 1) : (tid >> 6);
  const int wn = warp & 1;
  const int ty = (tid >> 3) & 7;
  const int tx = tid & 7;
  const bool my_on = p < n_off && (kDmma || ty < 4 || on1);
  // complex128: the lane's form of F (see prep_f) and its columns' N in fq
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int form = ((t4 ^ g) & 1) ? 1 : ((t4 & g & 1) ? 2 : 0);

  double dacc[2][8][4];
  float2 part[4][8], facc[4][8];
  int wq[8];
  if constexpr (kDmma) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dacc[m][nt][i] = 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = facc[i][j] = make_float2(0.f, 0.f);
  }

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch)
      stage_chunk<T>(ring + s * stage_elems, yo, yi, fz, r0, s * KQ, c0, n_lo, W, w_max, n_off,
                     Q, Qp, Hop, Hip, NB, tid);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();  // chunk 0 has landed; ncol is written
  if constexpr (kDmma) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      wq[nt] = (p * w_max + ncol[32 * wn + 4 * nt + (g >> 1)]) * KQ * 3;
    prep_f(prep, ring, n_off, w_max, tid);
  } else {
    build_bs(prep, ring, n_off, w_max, ncol, tid);
  }
  // One barrier a chunk: chunk c's products read one prep buffer while
  // chunk c + 1's is written into the other, after them in program order.
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    cp_wait<kStages - 3>();
    __syncthreads();  // chunk c + 1 has landed, chunk c's prep is written,
                      // chunk c - 1's readers are done
    if (c + kStages - 1 < nch)
      stage_chunk<T>(ring + ((c + kStages - 1) % kStages) * stage_elems, yo, yi, fz, r0,
                     (c + kStages - 1) * KQ, c0, n_lo, W, w_max, n_off, Q, Qp, Hop, Hip, NB,
                     tid);
    cp_commit();
    const T2* cur = ring + (c % kStages) * stage_elems;
    const T2* pc = prep + (c & 1) * prep_elems;
    if constexpr (kDmma) {
      if (my_on && on1)
        chunk_dmma<2>(dacc, cur, cur + KQ * kArow, pc, wq, form, wn, lane);
      else if (my_on)
        chunk_dmma<1>(dacc, cur, cur + KQ * kArow, pc, wq, form, wn, lane);
      if (c + 1 < nch)
        prep_f(prep + ((c + 1) & 1) * prep_elems, ring + ((c + 1) % kStages) * stage_elems,
               n_off, w_max, tid);
    } else {
      if (my_on) chunk_simt(part, cur, pc + p * KQ * kBrow, ty, tx);
      if ((c + 1) % (kSumNodes / KQ) == 0 || c == nch - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            facc[i][j].x += part[i][j].x;
            facc[i][j].y += part[i][j].y;
            part[i][j] = make_float2(0.f, 0.f);
          }
      }
      if (c + 1 < nch)
        build_bs(prep + ((c + 1) & 1) * prep_elems, ring + ((c + 1) % kStages) * stage_elems,
                 n_off, w_max, ncol, tid);
    }
  }
  cp_wait<0>();

  if (!my_on) return;
  const int ko = ko0 + z0 + p;
  const int k = ko / NO;
  if constexpr (kDmma) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int rhi = m ? rhi1 : rhi0;
      if (m && !on1) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int cc = 32 * wn + 4 * nt + t4;
        if (c0 + cc >= Hi) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + kTile * m + g + 8 * h;
          if (r >= rhi) continue;
          store_entry<T>(out, cmake<T>(dacc[m][nt][2 * h], dacc[m][nt][2 * h + 1]), ko, k, r,
                         c0 + cc, deg, ncol[cc] + n_lo - deg, Ho, Hi, NB, he, e_r, e_b, kFold);
        }
      }
    }
  } else {
    const int rhi = ty < 4 ? rhi0 : rhi1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      if (r >= rhi) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 16 * (j >> 1) + 2 * tx + (j & 1);
        if (c0 + cc >= Hi) continue;
        store_entry<T>(out, cmake<T>(facc[i][j].x, facc[i][j].y), ko, k, r, c0 + cc, deg,
                       ncol[cc] + n_lo - deg, Ho, Hi, NB, he, e_r, e_b, kFold);
      }
    }
  }
}

template <typename T>
size_t ks_smem(int w_max) {
  const size_t prep = std::is_same<T, double>::value ? (size_t)kOffs * w_max * KQ * 3
                                                     : (size_t)kOffs * KQ * kBrow;
  return ((size_t)kStages * KQ * (kArow + kBrow + kOffs * w_max) + 2 * prep) * sizeof(c2_t<T>);
}

template <typename T>
cudaError_t run_f(const void* coef, const void* t_hat, long long t_k, const void* w,
                  const void* s_cart, void* F, int ko0, int G, int NO, int d, int Q, int Qp,
                  int NB, double nu, cudaStream_t st) {
  constexpr int kFTile = kFThreads * kFNodes;  // nodes a CTA
  const dim3 grid((unsigned)((Qp + kFTile - 1) / kFTile), (unsigned)G);
  band_f_kernel<T><<<grid, kFThreads, 0, st>>>(
      static_cast<const c2_t<T>*>(coef), static_cast<const T*>(t_hat), t_k,
      static_cast<const T*>(w), static_cast<const T*>(s_cart), static_cast<c2_t<T>*>(F), ko0,
      NO, d, Q, Qp, NB, (T)nu);
  return cudaGetLastError();
}

template <typename T, bool kFold>
cudaError_t run_sr(const void* F, const void* yo, const void* yi, const void* n_o,
                   const void* n_i, const void* row_plan, const void* he, const void* e_r,
                   const void* e_b, void* out, int ko0, int G, int NO, int Q, int Qp, int Ho,
                   int Hi, int Hop, int Hip, int NB, int n_slots, int w_max, cudaStream_t st) {
  auto kernel = band_sr_kernel<T, kFold>;
  const size_t smem = ks_smem<T>(w_max);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((G + kOffs - 1) / kOffs), (unsigned)((Hi + kCols - 1) / kCols),
                  (unsigned)n_slots);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const c2_t<T>*>(F), static_cast<const c2_t<T>*>(yo),
      static_cast<const c2_t<T>*>(yi), static_cast<const int*>(n_o),
      static_cast<const int*>(n_i), static_cast<const int*>(row_plan),
      static_cast<const T*>(he), static_cast<const T*>(e_r), static_cast<const T*>(e_b),
      static_cast<c2_t<T>*>(out), ko0, G, NO, Q, Qp, Ho, Hi, Hop, Hip, NB, w_max);
  return cudaGetLastError();
}

}  // namespace

// KF. coef [K, NO, NB, NB] complex; t_hat real [K, NO, d] (t_k = NO d) or
// [NO, d] for every k (t_k = 0); w [Q], s_cart [d, Q] real; F [G, NB, Qp]
// complex, written for the offsets ko0 .. ko0 + G - 1 of the flattened
// (k, o); Qp >= Q a multiple of 16 (F is zero past Q).
extern "C" int bhs_band_f(const void* coef, const void* t_hat, long long t_k, const void* w,
                          const void* s_cart, void* F, int ko0, int G, int NO, int d, int Q,
                          int Qp, int NB, double nu, int dbl, void* stream) {
  if (G <= 0 || Q <= 0) return 0;
  if (d < 1 || d > kMaxDim || NB <= 0 || NB > (1 << 20) || NO <= 0 || Qp < Q || Qp % 16 != 0 ||
      G > 65535)  // NB: kf_div's divisors n + 1 <= 2^20
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dbl ? run_f<double>(coef, t_hat, t_k, w, s_cart, F, ko0, G, NO, d, Q, Qp, NB,
                                   nu, st)
                   : run_f<float>(coef, t_hat, t_k, w, s_cart, F, ko0, G, NO, d, Q, Qp, NB,
                                  nu, st));
}

// KS. F [G, NB, Qp] from KF; yo [Q, Hop] (Y_out, not conjugated), yi
// [Q, Hip] complex, zero past Ho and Hi (the same array when n_out ==
// n_in), Hop and Hip multiples of 8; n_o [Ho], n_i [Hi] int32 ascending,
// n_o[-1] + n_i[-1] < NB; row_plan int32 [n_slots, 2, 2]: the (first, end)
// rows of each slot's two M-tiles (at most 16 rows each, both of one
// degree, the second starting where the first ends, possibly empty);
// w_max: the widest range of column degrees over 64 columns, plus one; he
// [K, NO, NB], e_r [K, Ho], e_b [K, Hi] real or null (fold); out [K, NO,
// Ho, Hi], written for the offsets ko0 .. ko0 + G - 1.
extern "C" int bhs_band_sr(const void* F, const void* yo, const void* yi, const void* n_o,
                           const void* n_i, const void* row_plan, const void* he,
                           const void* e_r, const void* e_b, void* out, int ko0, int G, int NO,
                           int Q, int Qp, int Ho, int Hi, int Hop, int Hip, int NB,
                           int n_slots, int w_max, int fold, int dbl, void* stream) {
  if (G <= 0 || Q <= 0 || Ho <= 0 || Hi <= 0) return 0;
  if (NO <= 0 || NB <= 0 || n_slots <= 0 || n_slots > 65535 || G > 65535 * kOffs ||
      Qp < Q || Qp % 16 != 0 || Hop < Ho || Hip < Hi || Hop % 8 != 0 || Hip % 8 != 0 ||
      w_max <= 0 || w_max > NB ||
      (dbl ? ks_smem<double>(w_max) : ks_smem<float>(w_max)) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)(fold ? run_sr<double, true>(F, yo, yi, n_o, n_i, row_plan, he, e_r, e_b, out,
                                             ko0, G, NO, Q, Qp, Ho, Hi, Hop, Hip, NB, n_slots,
                                             w_max, st)
                      : run_sr<double, false>(F, yo, yi, n_o, n_i, row_plan, he, e_r, e_b,
                                              out, ko0, G, NO, Q, Qp, Ho, Hi, Hop, Hip, NB,
                                              n_slots, w_max, st));
  return (int)(fold ? run_sr<float, true>(F, yo, yi, n_o, n_i, row_plan, he, e_r, e_b, out,
                                          ko0, G, NO, Q, Qp, Ho, Hi, Hop, Hip, NB, n_slots,
                                          w_max, st)
                    : run_sr<float, false>(F, yo, yi, n_o, n_i, row_plan, he, e_r, e_b, out,
                                           ko0, G, NO, Q, Qp, Ho, Hi, Hop, Hip, NB, n_slots,
                                           w_max, st));
}
