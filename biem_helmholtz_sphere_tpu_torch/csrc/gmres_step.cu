// K6: one Arnoldi step of the port's restarted GMRES, and a cycle's
// back-substitution, on the card.
//
// Replaces biem_helmholtz_sphere_tpu/ops/cplx.py:569-607 (`step_work`
// under `step`'s lax.cond, with pre_mv's Jacobi division, `:68-69`) and
// `back` (`:627-646`), which XLA fused into the one device program of a
// solve on the TPU.  The plain versions are ops/gmres_step.py::
// _arnoldi_step_plain and _backsolve_plain.
//
// The step on the state (V [K, m+1, n], R [K, m, m] as R[k, col, row],
// g [K, m+1], Q [K, m+1, m+1], resid [K], steps [K] int32, the flag word
// int32 [3]: any system active, any residual non-finite, steps run):
//   w <- w / diag; CGS2: h1 = V_{0..j}^H w, w -= h1 V, h2 = V^H w, w -= h2 V;
//   hn = |w|, V[j+1] = w / hn (0 where hn <= tiny); h = h1 + h2 rotated by
//   the accumulated Givens product Q; a new rotation (u, v) eliminates
//   (hr[j], hn); rows j and j+1 of Q, row j of R, g[j], g[j+1]; steps +=
//   (resid > target) before the step, resid = |g[j] v|; then the flag word.
// Every CTA first reads the flag word and returns when no system is active
// or a residual is non-finite: a masked step leaves every state tensor
// unchanged, so the host may run ahead of its reads of the word.
//
// What bounds it on the H100: the bytes.  A step must read rows 0..j of V
// once, w and diag, and write V[j+1] (chip_smoke.py::k6_bound); at the
// bench block (K 4, n 16,384, c64) step 47 moves ~26 MB (8 us at 3.35
// TB/s); the 2D lattice's cold rung (K 1, n 12,288, m 4,608) reads up to
// 0.11 GB a step.  Design, one cooperative launch a step:
// - Every SM busy.  K x n is cut into contiguous slices, one per CTA of a
//   grid no larger than the card's co-resident capacity (one CTA an SM:
//   the CTA takes the whole shared memory), balanced to within 2 entries
//   (ops/gmres_step.py::_plan computes the same cut; at K 1, n 12,288 a
//   slice is ~93 entries).  A slice spans at most two systems (its two
//   pieces): where K exceeds the grid, the systems go in rounds.  Each CTA
//   keeps its slice of w (x) and the update's sums (s) in shared memory
//   for the whole step (in a scratch of its own only where a slice exceeds
//   half the shared memory).
// - The basis through bulk copies.  A producer warp copies the CTA's tile
//   of V (rows 0..j of its slice) in stages of rb rows x cw entries: a
//   box of V's tensor map a piece (cp.async.bulk.tensor), or, where a row
//   of n entries is no multiple of 16 bytes, a cp.async.bulk a row and
//   piece from the 16-byte boundary at or before it; each stage completes
//   on a full mbarrier and is released on an empty one by the 8 consumer
//   warps.  Where the tile fits in shared memory (j + 1 <= resident_rows:
//   the bench block's every step) it is copied once, the first sweep
//   waiting stage by stage, and the other three sweeps of CGS2 run as
//   whole-tile loops; elsewhere every sweep streams it again through a
//   ring of `stages` stages, the odd sweeps backwards so that each starts
//   on the rows the last one left in L2.
// - CGS2's arithmetic as the plain step: two projections, each a sweep of
//   dots (a warp a row, lanes over the slice, a shuffle tree: one partial
//   per CTA, piece and row) and a sweep of the update (a thread an entry,
//   the rows in order), the sums in interleaved halves or quarters.  Each
//   h[k, i] sums its system's partials over the CTAs in slice order,
//   strided over a group of lanes, then a tree: where the partials are
//   few (j < kJRed, (j + 1) x the most pieces of a system <= kTRed) every
//   CTA sums those of its own systems itself, else the (system, row) pairs
//   are spread over the grid, then a grid barrier.  No atomics in any sum:
//   two launches give the same bits, and the grid depends only on the
//   shapes and the card (its SM count and shared memory), so parallel/'s
//   replicas on like cards agree bit for bit.
// - Grid barriers among the consumer warps (an arrival counter in the
//   state's scratch whose top bit flips each barrier, added with release,
//   polled with acquire): after each projection's dots (and a spread
//   reduction), and after the norms' partials.  Before the last, the
//   CTAs that hold a system form hr[r] = sum_{c <= min(r+1, j)} Q[r, c]
//   h[c] for r <= j (Q's rows past r + 1 are exact zeros and rows past j
//   identity rows: O(j^2), not O(m j)), rows r < j straight into row j of
//   R, hr[j] into a scratch; after it they write their slice of V[j+1]
//   (each sums the partial norms in the same order: one hn), and CTA 0
//   alone forms each system's rotation (a warp a system), rotates Q's rows
//   j and j+1 with all its threads, writes R[j, j], g, resid and steps,
//   and last the flag word: every CTA read it before the first barrier.
// A refused launch (a grid above the co-resident capacity, say) is
// returned as an error; there is no other path.  A wait that lasts ~20 s
// traps.  No size ceiling: any K (rounds), any n (chunks of the slice; x
// and s in a scratch past half the shared memory), any m (the rows stream;
// h from the state's scratch past kJRed rows).
//
// The back-substitution: one CTA a system, right-looking from the last
// column, y[col] = g'[col] conj(R[col, col]) / |R[col, col]|^2 (0 where
// |R[col, col]| <= tiny), then g'[r] -= R[col, r] y[col] for r < col, in
// blocks of 32 columns (k6_backsolve below); R[col, 0..col] is one
// contiguous row of the port's R, so its reads are coalesced; g' lives in
// shared memory (in y itself where m is too large); y = 0 past j_f =
// flag[2], read on the device.
#include <cuda.h>  // CUtensorMap and its encoder's types

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;  // threads that compute
constexpr int kThreads = kConsumers + 32;        // and the producer warp (= _THREADS)
constexpr int kSlots = 64;    // stages of the ring / the resident tile (= _SLOTS)
constexpr int kRbMax = 32;    // rows a stage (= _RB_MAX)
constexpr int kJRed = 128;    // rows of the CTA-local reduction (= _J_RED)
constexpr int kTRed = 4096;   // its most partials a value (= _T_RED)
constexpr int kBsThreads = 512;  // the back-substitution's CTA: R's rows in flight
constexpr unsigned kFull = 0xffffffffu;

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
// A wait that lasts ~20 s is a fault of the kernel, never a result: it
// traps (the launch reports an error) rather than hang the card.
constexpr long long kSpinCycles = 40'000'000'000LL;
__device__ __forceinline__ void spin_guard(long long t0) {
  if (clock64() - t0 > kSpinCycles) __trap();
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done) spin_guard(t0);
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
// global -> shared, one box of the 3D tensor map `map` at (c0, c1, c2),
// completing on `bar` (dst 128-byte aligned)
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
// the consumer warps' barrier (the producer warp takes no part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// a complex entry of the tile, loaded as shared memory (ld.shared)
__device__ __forceinline__ float2 lds(const float2* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ double2 lds(const double2* p) {
  double2 v;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n" : "=d"(v.x), "=d"(v.y) : "r"(smem_u32(p)));
  return v;
}

template <typename T>
__device__ __forceinline__ c2_t<T> czero() {
  return cmake<T>(T(0), T(0));
}

// acc + conj(a) * b
template <typename T>
__device__ __forceinline__ c2_t<T> cfma_conj(c2_t<T> a, c2_t<T> b, c2_t<T> acc) {
  acc.x = t_fma(a.x, b.x, t_fma(a.y, b.y, acc.x));
  acc.y = t_fma(a.x, b.y, t_fma(-a.y, b.x, acc.y));
  return acc;
}

// a / b as torch's complex division (numpy's: scaled by the larger part)
template <typename T>
__device__ __forceinline__ c2_t<T> cdiv(c2_t<T> a, c2_t<T> b) {
  const T ac = fabs(b.x), ad = fabs(b.y);
  if (ac >= ad) {
    if (ac == T(0) && ad == T(0)) return cmake<T>(a.x / ac, a.y / ad);
    const T rat = b.y / b.x, scl = T(1) / (b.x + b.y * rat);
    return cmake<T>((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const T rat = b.x / b.y, scl = T(1) / (b.y + b.x * rat);
  return cmake<T>((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

// a sum every lane holds (a butterfly: the same bits on every lane)
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
template <typename T>
__device__ __forceinline__ c2_t<T> warp_allsum_c(c2_t<T> v) {
  return cmake<T>(warp_allsum(v.x), warp_allsum(v.y));
}

template <typename T>
__device__ __forceinline__ T inv_or_zero(T a, T tiny) {
  return a > tiny ? T(1) / fmax(a, tiny) : T(0);
}

// no system active, or a residual non-finite: the step is masked
__device__ __forceinline__ bool masked(const int* flag) { return flag[0] == 0 || flag[1] != 0; }

// Grid barrier among the consumer warps of every CTA: CTA 0 adds 2^31 -
// (G - 1), the others 1, so the counter's top bit flips once all have
// arrived and its low bits return to where they were (no reset).  The
// add releases what the CTA wrote before it; the polling load acquires.
__device__ __forceinline__ void grid_sync(unsigned* bar, int n_cta) {
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (unsigned)(n_cta - 1) : 1u;
    unsigned old, cur;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(bar), "r"(inc)
                 : "memory");
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(cur) : "l"(bar) : "memory");
      spin_guard(t0);
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  consumer_sync();
}

// the OR of a predicate over the consumer warps (a barrier of theirs)
__device__ __forceinline__ int consumer_or(int pred) {
  int out;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n bar.red.or.pred q, 1, %2, p;\n"
      " selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(pred), "n"(kConsumers)
      : "memory");
  return out;
}

template <typename T>
struct StepArgs {
  CUtensorMap vmap;  // V as 3D [K, m+1, n w] of 8-byte words (the streamed ring's boxes)
  c2_t<T>* V;
  c2_t<T>* R;
  c2_t<T>* g;
  c2_t<T>* Q;
  T* resid;
  int* steps;
  int* flag;
  const c2_t<T>* w;
  const c2_t<T>* diag;
  const T* target;
  c2_t<T>* part;  // [2 passes][grid][2 pieces][m+1] partial dots
  c2_t<T>* hg;    // [K][2 passes][m+1] h1, h2
  c2_t<T>* hrj;   // [K] hr[j], the rotated column's entry j
  c2_t<T>* xs;    // [grid][2][lmax] x and s where they spill (else null)
  T* pn;          // [rounds][grid][2 pieces] partial squared norms
  unsigned* bar;  // the grid barrier's counter
  int K, n, m, j;
  int grid, per_round, rounds, unit, lmax, cw, chunks, rb, stages;
  int boxes;    // boxes a stage holds: 2 where a slice may span two systems
  int brows;    // rows a box copies: min(rb, j + 1)
  int tensor;   // the streamed ring copies boxes of vmap (else a copy a row and piece)
  int resident, red;
  T tiny;
};

// A round: systems sys0 .. sys0 + kr - 1, their kr n entries cut into the
// slices of the first `ga` CTAs (ops/gmres_step.py::_slice_lo)
struct Round {
  long long N, nu;
  int sys0, kr, ga;
  bool narrow;  // the cut's products fit 32 bits: its divisions run in 32 bits
};

__device__ __forceinline__ Round round_at(int rho, int K, int n, int per_round, int grid,
                                          int unit) {
  Round r;
  r.sys0 = rho * per_round;
  r.kr = min(per_round, K - r.sys0);
  r.N = (long long)r.kr * n;
  r.ga = (int)min((long long)grid, max((long long)r.kr, (r.N + 31) / 32));
  r.nu = (r.N + unit - 1) / unit;
  r.narrow = (r.N + 1) * r.ga < (1LL << 32);
  return r;
}
__device__ __forceinline__ long long slice_lo(const Round& r, int b, int unit) {
  if (b >= r.ga) return r.N;
  const long long u = r.narrow ? (unsigned)b * (unsigned)r.nu / (unsigned)r.ga
                               : (long long)b * r.nu / r.ga;
  return min(r.N, u * unit);
}
// the CTA whose slice holds entry f of the round (unit 1 or 2)
__device__ __forceinline__ int slice_of(const Round& r, long long f, int unit) {
  const long long fu = f >> (unit - 1);
  return r.narrow ? (int)(((unsigned)fu * (unsigned)r.ga + (unsigned)r.ga - 1) / (unsigned)r.nu)
                  : (int)(((fu + 1) * r.ga - 1) / r.nu);
}

// This CTA's slice in a round: L entries, piece 0 (L0 entries from entry
// t0 of system sys0 + k0), then piece 1 (from entry 0 of the next system)
struct Slice {
  int L, L0, t0, k0, np;
};

__device__ __forceinline__ Slice slice_at(const Round& r, int b, int n, int unit) {
  Slice s;
  const long long lo = slice_lo(r, b, unit), hi = slice_lo(r, b + 1, unit);
  s.L = (int)(hi - lo);
  s.k0 = r.narrow ? (int)((unsigned)lo / (unsigned)n) : (int)(lo / n);
  s.t0 = (int)(lo - (long long)s.k0 * n);
  s.L0 = min(s.L, n - s.t0);
  s.np = s.L0 < s.L ? 2 : 1;
  return s;
}

// A sum over the `width` lanes of a group (a power of 2; each lane of the
// group holds it)
template <typename T>
__device__ __forceinline__ T group_allsum(T v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The CTAs that hold round-local system k, and whether k is the first
// one's second piece
struct Owners {
  int bf, bl, q_first;
};
__device__ __forceinline__ Owners owners_of(const Round& r, int k, int n, int unit) {
  const long long f0 = (long long)k * n;
  Owners o;
  o.bf = slice_of(r, f0, unit);
  o.bl = slice_of(r, f0 + n - 1, unit);
  o.q_first = slice_lo(r, o.bf, unit) < f0 ? 1 : 0;
  return o;
}

// h[k, i] of round-local system k: its partials over the CTAs that hold
// it, in slice order strided over a group's `width` lanes (the loads in
// flight together), then the tree; every lane of the group holds it.
// All 32 lanes of the warp call it with one width.
template <typename T>
__device__ c2_t<T> reduce_h(const StepArgs<T>& a, const Owners& o, int i, int pass, int gl,
                            int width, bool valid) {
  c2_t<T> acc = czero<T>();
  if (valid) {
#pragma unroll 16
    for (int b = o.bf + gl; b <= o.bl; b += width) {
      const int q = b == o.bf ? o.q_first : 0;
      acc = cadd<T>(acc,
                    __ldcg(a.part + (((size_t)pass * a.grid + b) * 2 + q) * (a.m + 1) + i));
    }
  }
  return cmake<T>(group_allsum(acc.x, width), group_allsum(acc.y, width));
}

// hn of the system the same way (a whole warp), from round rho's partial
// squared norms: the owners and CTA 0 form the same bits
template <typename T>
__device__ T reduce_hn(const StepArgs<T>& a, const Owners& o, int rho, int lane, bool valid) {
  T acc = T(0);
  if (valid) {
#pragma unroll 8
    for (int b = o.bf + lane; b <= o.bl; b += 32) {
      const int q = b == o.bf ? o.q_first : 0;
      acc += __ldcg(a.pn + ((size_t)rho * a.grid + b) * 2 + q);
    }
  }
  return sqrt(warp_allsum(acc));
}

// lanes a value's partials take: as many groups as values (at most
// `groups_max` of 32 lanes' worth), a power of 2 from 1 to 32
__device__ __forceinline__ int group_width(long long values, long long lanes) {
  int w = 32;
  while (w > 1 && values * w > lanes) w >>= 1;
  return w;
}

// The stage (group g of rb rows, chunk c of cw entries) of a CTA's tile:
// its rows, and per piece the entries [ea, eb) of the slice it holds, the
// segment's offset in a stage row and, per row, the complex64 shift (a
// copy starts at the 16-byte boundary at or before the piece's entry)
template <typename T>
struct Stage {
  int i0, rows, ea[2], eb[2], off[2];
  int sys[2], t[2];  // piece q's system and the entry of its row that ea is
  long long f0[2];   // V's flat index of entry ea of row 0 of piece q
};

template <typename T>
__device__ __forceinline__ Stage<T> stage_at(const StepArgs<T>& a, const Round& r,
                                             const Slice& s, int g, int c) {
  Stage<T> st;
  st.i0 = g * a.rb;
  st.rows = min(a.rb, a.j + 1 - st.i0);
  const int c0 = c * a.cw, c1 = min(c0 + a.cw, s.L);
  st.ea[0] = c0;
  st.eb[0] = min(c1, s.L0);
  st.ea[1] = max(c0, s.L0);
  st.eb[1] = c1;
  const int len0 = max(0, st.eb[0] - st.ea[0]);
  st.off[0] = 0;
  // a complex64 segment takes up to 2 entries more than it holds
  st.off[1] = sizeof(T) == 4 ? (len0 > 0 ? (len0 & ~1) + 2 : 0) : len0;
  for (int q = 0; q < 2; ++q) {
    st.sys[q] = r.sys0 + s.k0 + q;
    st.t[q] = q == 0 ? s.t0 + st.ea[0] : st.ea[1] - s.L0;
    st.f0[q] = (long long)st.sys[q] * (a.m + 1) * a.n + st.t[q];
  }
  return st;
}

// the shift of row rr of piece q in its stage row (complex64 only): the
// parity of V's flat index of its first entry
template <typename T>
__device__ __forceinline__ int shift_of(const Stage<T>& st, int q, int rr, int n) {
  if (sizeof(T) != 4) return 0;
  return (int)((st.f0[q] + (long long)st.i0 * n) & 1) ^ (rr & n & 1);
}

// The producer warp issues one stage's copies (each row's piece
// segments), a copy a lane; lane 0 first posts the stage's bytes
template <typename T>
__device__ void issue_stage(const StepArgs<T>& a, const Stage<T>& st, unsigned char* dst,
                            int row_bytes, uint64_t* full, int lane, bool boxes) {
  constexpr int ES = sizeof(c2_t<T>);
  if (boxes) {  // a box of rb rows x cw entries a piece, from the piece's first entry
    if (lane == 0) {
      constexpr int W = ES / 8;
      // the box's brows rows land at the top of the piece's rb rows
      const unsigned box = (unsigned)a.brows * a.cw * ES;
      mbar_arrive_tx(full, box * ((st.ea[0] < st.eb[0]) + (st.ea[1] < st.eb[1])));
      for (int q = 0; q < 2; ++q)
        if (st.ea[q] < st.eb[q])
          tensor_load(dst + (size_t)q * a.rb * a.cw * ES, &a.vmap, st.t[q] * W, st.i0,
                      st.sys[q], full);
    }
    return;
  }
  constexpr long long P16 = 16 / ES;
  const int n_items = 2 * st.rows;
  unsigned total = 0;
  for (int t = lane; t < n_items; t += 32) {
    const int rr = t >> 1, q = t & 1;
    if (st.ea[q] >= st.eb[q]) continue;
    const long long f = st.f0[q] + (long long)(st.i0 + rr) * a.n;
    const long long fa = f - f % P16, fz = (f + (st.eb[q] - st.ea[q]) + P16 - 1) / P16 * P16;
    total += (unsigned)((fz - fa) * ES);
  }
  total = warp_allsum(total);
  if (lane == 0) mbar_arrive_tx(full, total);
  __syncwarp();
  for (int t = lane; t < n_items; t += 32) {
    const int rr = t >> 1, q = t & 1;
    if (st.ea[q] >= st.eb[q]) continue;
    const long long f = st.f0[q] + (long long)(st.i0 + rr) * a.n;
    const long long fa = f - f % P16, fz = (f + (st.eb[q] - st.ea[q]) + P16 - 1) / P16 * P16;
    bulk_load(dst + (size_t)rr * row_bytes + (size_t)st.off[q] * ES, a.V + fa,
              (unsigned)((fz - fa) * ES), full);
  }
}

// shared memory: mbarriers, the CTA-local h, the warps' staged h, the
// norms' scratch, then x and s (unless they spill), then the ring / tile
template <typename T>
struct Smem {
  static constexpr int ES = sizeof(c2_t<T>);
  static constexpr int kBars = 2 * kSlots * 8;
  static constexpr int kHsm = 2 * 2 * kJRed * ES;
  static constexpr int kHw = kConsumerWarps * 2 * kRbMax * ES;
  static constexpr int kRed = 256;
  static constexpr int kFixed = kBars + kHsm + kHw + kRed;  // = _fixed_smem
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
k6_arnoldi_step(const __grid_constant__ StepArgs<T> a) {
  using C = c2_t<T>;
  using L = Smem<T>;
  constexpr int ES = sizeof(C);
  extern __shared__ __align__(16) unsigned char smem[];
  if (masked(a.flag)) return;  // uniform: every CTA reads the word before any writes it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kSlots;
  C* hsm = reinterpret_cast<C*>(smem + L::kBars);  // [pass][piece][kJRed]
  C* hw = reinterpret_cast<C*>(smem + L::kBars + L::kHsm);  // [warp][piece][kRbMax]
  T* scr = reinterpret_cast<T*>(smem + L::kBars + L::kHsm + L::kHw);  // [warp][2], hn [2]
  unsigned char* xs_smem = smem + L::kFixed;
  const bool x_smem = a.xs == nullptr;
  // the ring / tile 128-byte aligned (a box's destination must be)
  unsigned char* ring =
      smem + ((size_t)L::kFixed + (x_smem ? (size_t)2 * a.lmax * ES : 0) + 127) / 128 * 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int j = a.j, ng = (j + 1 + a.rb - 1) / a.rb;
  // a stage: rb rows of the chunk as a box of rb x cw entries a piece (V's
  // tensor map), or, where n entries are no multiple of 16 bytes, a row's
  // pieces side by side (row_bytes each, copied a row and piece at a time)
  const bool boxes = a.tensor;
  const int row_bytes = boxes ? a.cw * ES : (a.cw + (ES == 8 ? 4 : 0)) * ES;
  const int box_bytes = a.rb * row_bytes;
  const int stage_bytes = boxes ? a.boxes * box_bytes : box_bytes;
  const int rs = row_bytes / ES;  // a stage row's stride in entries
  const int nodd = boxes || ES != 8 ? 0 : a.n & 1;
  // h of the step's rows in shared memory (hsm) while they fit: then the
  // resident tile's sweeps after the first run as whole-tile loops
  const bool hloc = j + 1 <= kJRed;
  if (tid == 0) {
    const int n_slots = a.resident ? ng * a.chunks : a.stages;
    for (int i = 0; i < n_slots; ++i) {
      mbar_init(&full[i], 1);  // the producer's expected bytes
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp
    int qseq = 0, ruse = 0;
    for (int rho = 0; rho < a.rounds; ++rho) {
      const Round r = round_at(rho, a.K, a.n, a.per_round, a.grid, a.unit);
      const Slice s = slice_at(r, b, a.n, a.unit);
      if (s.L <= 0) continue;
      const int nc = (s.L + a.cw - 1) / a.cw;
      for (int sw = 0; sw < (a.resident ? 1 : 4); ++sw)
        for (int gi = 0; gi < ng; ++gi)
          for (int ci = 0; ci < nc; ++ci) {
            // odd sweeps run backwards: they start on the rows the last one
            // left in L2
            const int g = sw & 1 ? ng - 1 - gi : gi, c = sw & 1 ? nc - 1 - ci : ci;
            int slot;
            if (a.resident) {
              slot = g * a.chunks + c;
              if (ruse > 0) mbar_wait(&empty[slot], (ruse - 1) & 1);
            } else {
              slot = qseq % a.stages;
              const int u = qseq / a.stages;
              if (u > 0) mbar_wait(&empty[slot], (u - 1) & 1);
              ++qseq;
            }
            issue_stage<T>(a, stage_at<T>(a, r, s, g, c), ring + (size_t)slot * stage_bytes,
                           row_bytes, &full[slot], lane, boxes);
          }
      if (a.resident) ++ruse;
    }
    return;
  }

  // the consumers
  int qseq = 0, ruse = 0;
  for (int rho = 0; rho < a.rounds; ++rho) {
    const Round r = round_at(rho, a.K, a.n, a.per_round, a.grid, a.unit);
    const Slice s = slice_at(r, b, a.n, a.unit);
    const bool active = s.L > 0;
    const int nc = active ? (s.L + a.cw - 1) / a.cw : 0;
    C* x = x_smem ? reinterpret_cast<C*>(xs_smem) : a.xs + (size_t)b * 2 * a.lmax;
    C* sacc = x + a.lmax;
    const long long sys0 = r.sys0 + s.k0, sys1 = sys0 + 1;
    // the CTAs that hold this CTA's pieces' systems
    const Owners own0 = owners_of(r, s.k0, a.n, a.unit),
                 own1 = s.np > 1 ? owners_of(r, s.k0 + 1, a.n, a.unit) : own0;
    // x = w / diag
    for (int e = tid; e < s.L; e += kConsumers) {
      const size_t idx = e < s.L0 ? sys0 * a.n + s.t0 + e : sys1 * a.n + (e - s.L0);
      x[e] = cdiv<T>(a.w[idx], a.diag[idx]);
    }
    consumer_sync();

    auto hval = [&](int pass, int q, int i) -> C {
      return hloc ? hsm[(pass * 2 + q) * kJRed + i]
                  : __ldcg(a.hg + ((size_t)(q ? sys1 : sys0) * 2 + pass) * (a.m + 1) + i);
    };
    // the entries of piece q's segment of chunk c in row 0 of a stage at
    // `base` of group g: V(row rr, entry e) = p0[rr rs + (rr odd ? alt : 0) + e]
    // (a complex64 row copy of an odd n starts one entry earlier or later on
    // odd rows)
    auto seg_of = [&](const unsigned char* base, const Stage<T>& st, int q, int& alt) -> const C* {
      if (boxes) {
        alt = 0;
        return reinterpret_cast<const C*>(base + (size_t)q * box_bytes) - st.ea[q];
      }
      const int sh = ES == 8 ? shift_of<T>(st, q, 0, a.n) : 0;
      alt = nodd ? 1 - 2 * sh : 0;
      return reinterpret_cast<const C*>(base) + st.off[q] + sh - st.ea[q];
    };

    // A sweep stage by stage (waiting on each): dots of x into part[pass]
    // (upd false), or the update s += h V with h of `pass` (upd true), the
    // stages of odd sweeps in reverse; each sum in two interleaved halves
    auto staged = [&](int sw, bool upd, int pass) {
      const bool rev = sw & 1;
      C acc[4][2];
      for (int gi = 0; gi < ng; ++gi) {
        const int g = rev ? ng - 1 - gi : gi;
        const int i0 = g * a.rb, rows = min(a.rb, j + 1 - i0);
        if (upd) {  // stage this group's h in the warp's lines
          if (lane < rows)
            for (int q = 0; q < s.np; ++q)
              hw[(warp * 2 + q) * kRbMax + lane] = hval(pass, q, i0 + lane);
          __syncwarp();
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[t][0] = acc[t][1] = czero<T>();
        }
        for (int ci = 0; ci < nc; ++ci) {
          const int c = rev ? nc - 1 - ci : ci;
          int slot;
          bool release;
          if (a.resident) {
            slot = g * a.chunks + c;
            if (sw == 0) mbar_wait(&full[slot], ruse & 1);
            release = sw == 3;
          } else {
            slot = qseq % a.stages;
            mbar_wait(&full[slot], (qseq / a.stages) & 1);
            ++qseq;
            release = true;
          }
          const Stage<T> st = stage_at<T>(a, r, s, g, c);
          const unsigned char* base = ring + (size_t)slot * stage_bytes;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ea = st.ea[q], eb = st.eb[q];
            if (ea >= eb) continue;
            int alt;
            const C* p0 = seg_of(base, st, q, alt);
            if (upd) {
              const C* hq = hw + (warp * 2 + q) * kRbMax;
              for (int e = ea + tid; e < eb; e += kConsumers) {
                C v0 = czero<T>(), v1 = czero<T>();
                int rr = 0;
#pragma unroll 4
                for (; rr + 1 < rows; rr += 2) {
                  v0 = cfma<T>(hq[rr], lds(p0 + rr * rs + e), v0);
                  v1 = cfma<T>(hq[rr + 1], lds(p0 + (rr + 1) * rs + alt + e), v1);
                }
                if (rr < rows) v0 = cfma<T>(hq[rr], lds(p0 + rr * rs + e), v0);
                const C prev = gi == 0 ? czero<T>() : sacc[e];
                sacc[e] = cadd<T>(prev, cadd<T>(v0, v1));
              }
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const int rr = warp + kConsumerWarps * t;
                if (rr >= rows) continue;
                const C* p = p0 + rr * rs + (rr & 1 ? alt : 0);
                C d0 = czero<T>(), d1 = czero<T>();
                int e = ea + lane;
#pragma unroll 4
                for (; e + 32 < eb; e += 64) {
                  d0 = cfma_conj<T>(lds(p + e), x[e], d0);
                  d1 = cfma_conj<T>(lds(p + e + 32), x[e + 32], d1);
                }
                if (e < eb) d0 = cfma_conj<T>(lds(p + e), x[e], d0);
                acc[t][q] = cadd<T>(acc[t][q], cadd<T>(d0, d1));
              }
            }
          }
          if (release) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
          }
        }
        if (!upd) {  // this group's partials
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int rr = warp + kConsumerWarps * t;
            if (rr >= rows) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (q >= s.np) continue;
              const C d = warp_allsum_c<T>(acc[t][q]);
              if (lane == 0)
                a.part[(((size_t)pass * a.grid + b) * 2 + q) * (a.m + 1) + i0 + rr] = d;
            }
          }
        }
        if (upd) __syncwarp();  // the warp's lines are restaged next group
      }
    };

    // A sweep of the resident tile as whole-tile loops (no waits, h in
    // hsm): the dots a warp a row over every chunk, the update a thread an
    // entry over every row, each sum in four interleaved quarters
    auto direct = [&](bool upd, int pass) {
      if (upd) {
        for (int e = tid; e < s.L; e += kConsumers) {
          const int c = e / a.cw, q = e < s.L0 ? 0 : 1;
          const C* hq = hsm + (pass * 2 + q) * kJRed;
          C v0 = czero<T>(), v1 = czero<T>(), v2 = czero<T>(), v3 = czero<T>();
          for (int g = 0; g < ng; ++g) {
            const Stage<T> st = stage_at<T>(a, r, s, g, c);
            int alt;
            const C* p0 = seg_of(ring + (size_t)(g * a.chunks + c) * stage_bytes, st, q, alt) + e;
            const C* h = hq + st.i0;
            int rr = 0;
#pragma unroll 2
            for (; rr + 3 < st.rows; rr += 4) {
              v0 = cfma<T>(h[rr], lds(p0 + rr * rs), v0);
              v1 = cfma<T>(h[rr + 1], lds(p0 + (rr + 1) * rs + alt), v1);
              v2 = cfma<T>(h[rr + 2], lds(p0 + (rr + 2) * rs), v2);
              v3 = cfma<T>(h[rr + 3], lds(p0 + (rr + 3) * rs + alt), v3);
            }
            for (; rr < st.rows; ++rr)
              v0 = cfma<T>(h[rr], lds(p0 + rr * rs + (rr & 1 ? alt : 0)), v0);
          }
          sacc[e] = cadd<T>(cadd<T>(v0, v1), cadd<T>(v2, v3));
        }
        return;
      }
      for (int i = warp; i <= j; i += kConsumerWarps) {
        const int g = i / a.rb, rr = i - g * a.rb;
        C acc0 = czero<T>(), acc1 = czero<T>();
        for (int c = 0; c < nc; ++c) {
          const Stage<T> st = stage_at<T>(a, r, s, g, c);
          const unsigned char* base = ring + (size_t)(g * a.chunks + c) * stage_bytes;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ea = st.ea[q], eb = st.eb[q];
            if (ea >= eb) continue;
            int alt;
            const C* p = seg_of(base, st, q, alt) + rr * rs + (rr & 1 ? alt : 0);
            C d0 = czero<T>(), d1 = czero<T>(), d2 = czero<T>(), d3 = czero<T>();
            int e = ea + lane;
            for (; e + 96 < eb; e += 128) {
              d0 = cfma_conj<T>(lds(p + e), x[e], d0);
              d1 = cfma_conj<T>(lds(p + e + 32), x[e + 32], d1);
              d2 = cfma_conj<T>(lds(p + e + 64), x[e + 64], d2);
              d3 = cfma_conj<T>(lds(p + e + 96), x[e + 96], d3);
            }
            for (; e < eb; e += 32) d0 = cfma_conj<T>(lds(p + e), x[e], d0);
            const C dq = cadd<T>(cadd<T>(d0, d1), cadd<T>(d2, d3));
            if (q == 0)
              acc0 = cadd<T>(acc0, dq);
            else
              acc1 = cadd<T>(acc1, dq);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= s.np) continue;
          const C d = warp_allsum_c<T>(q == 0 ? acc0 : acc1);
          if (lane == 0) a.part[(((size_t)pass * a.grid + b) * 2 + q) * (a.m + 1) + i] = d;
        }
      }
    };
    // sweep sw (0: dots 1, 1: update 1, 2: dots 2, 3: update 2)
    auto sweep = [&](int sw) {
      const bool upd = sw & 1;
      const int pass = sw >> 1;
      if (a.resident && sw > 0 && hloc) {
        direct(upd, pass);
        if (sw == 3) {  // the tile's slots are free for the next round
          __syncwarp();
          if (lane == 0)
            for (int g = 0; g < ng; ++g)
              for (int c = 0; c < nc; ++c) mbar_arrive(&empty[g * a.chunks + c]);
        }
      } else {
        staged(sw, upd, pass);
      }
    };

    // h of `pass` for this CTA's systems (CTA-local) or for every system
    // (spread over the grid, then a barrier); groups of lanes as wide as
    // the values allow, the width from j and the plan alone
    auto reduce = [&](int pass) {
      if (a.red) {
        const int width = group_width(2 * (j + 1), kConsumers);
        const int gid = tid / width, gl = tid % width, per = kConsumers / width;
        const int pairs = active ? s.np * (j + 1) : 0;
        for (int p0 = 0; p0 < pairs; p0 += per) {
          const int p = p0 + gid, q = p < pairs ? p / (j + 1) : 0, i = p % (j + 1);
          const C h = reduce_h<T>(a, q ? own1 : own0, i, pass, gl, width,
                                  p < pairs);
          if (gl == 0 && p < pairs) {
            hsm[(pass * 2 + q) * kJRed + i] = h;
            // the first CTA of the system publishes it (the rotated column reads it)
            if (q == 1 || s.t0 == 0)
              a.hg[((size_t)(q ? sys1 : sys0) * 2 + pass) * (a.m + 1) + i] = h;
          }
        }
        consumer_sync();
      } else {
        const long long pairs = (long long)r.kr * (j + 1);
        const int width = group_width(pairs, (long long)a.grid * kConsumers);
        const int gid = tid / width, gl = tid % width, per = kConsumers / width;
        const long long groups = (long long)a.grid * per;
        for (long long p0 = (long long)b * per; p0 < pairs; p0 += groups) {
          const long long p = p0 + gid;
          const int k = p < pairs ? (int)(p / (j + 1)) : 0, i = (int)(p % (j + 1));
          const C h = reduce_h<T>(a, owners_of(r, k, a.n, a.unit), i, pass, gl, width,
                                  p < pairs);
          if (gl == 0 && p < pairs) a.hg[((size_t)(r.sys0 + k) * 2 + pass) * (a.m + 1) + i] = h;
        }
        grid_sync(a.bar, a.grid);
        if (hloc && active) {  // this CTA's systems' h into hsm
          for (int p = tid; p < s.np * (j + 1); p += kConsumers) {
            const int q = p / (j + 1), i = p % (j + 1);
            hsm[(pass * 2 + q) * kJRed + i] =
                __ldcg(a.hg + ((size_t)(q ? sys1 : sys0) * 2 + pass) * (a.m + 1) + i);
          }
          consumer_sync();
        }
      }
    };
    // x -= s after an update sweep; the squared norms' partials after the second
    auto finish_update = [&](bool norm) {
      consumer_sync();
      T n0 = T(0), n1 = T(0);
      for (int e = tid; e < s.L; e += kConsumers) {
        const C v = x[e], u = sacc[e];
        const C y = cmake<T>(v.x - u.x, v.y - u.y);
        x[e] = y;
        if (e < s.L0)
          n0 += y.x * y.x + y.y * y.y;
        else
          n1 += y.x * y.x + y.y * y.y;
      }
      if (norm) {
        n0 = warp_allsum(n0);
        n1 = warp_allsum(n1);
        if (lane == 0) {
          scr[warp * 2] = n0;
          scr[warp * 2 + 1] = n1;
        }
      }
      consumer_sync();
      if (norm && tid < s.np) {
        T acc = T(0);
        for (int w = 0; w < kConsumerWarps; ++w) acc += scr[w * 2 + tid];
        a.pn[((size_t)rho * a.grid + b) * 2 + tid] = acc;
      }
    };

    if (active) sweep(0);
    grid_sync(a.bar, a.grid);
    reduce(0);
    if (active) {
      sweep(1);
      finish_update(false);
      sweep(2);
    }
    grid_sync(a.bar, a.grid);
    reduce(1);
    if (active) {
      sweep(3);
      finish_update(true);
      if (a.resident) ++ruse;
      // hr[r] = sum_{c <= min(r+1, j)} Q[r, c] (h1 + h2)[c] for the rows r
      // <= j of this CTA's systems, shared among the CTAs that hold each:
      // rows r < j into row j of R, hr[j] into hrj for the rotation
      for (int q = 0; q < s.np; ++q) {
        const Owners o = q ? own1 : own0;
        const int no = o.bl - o.bf + 1, ow = b - o.bf;
        const long long sq = q ? sys1 : sys0;
        const C* qk = a.Q + (size_t)sq * (a.m + 1) * (a.m + 1);
        for (int row = ow + no * warp; row <= j; row += no * kConsumerWarps) {
          const C* qr = qk + (size_t)row * (a.m + 1);
          const int c_end = min(row + 1, j);
          C acc = czero<T>();
#pragma unroll 4
          for (int c = lane; c <= c_end; c += 32)
            acc = cfma<T>(qr[c], cadd<T>(hval(0, q, c), hval(1, q, c)), acc);
          acc = warp_allsum_c<T>(acc);
          if (lane == 0) {
            if (row < j)
              a.R[((size_t)sq * a.m + j) * a.m + row] = acc;
            else
              a.hrj[sq] = acc;
          }
        }
      }
    }
    grid_sync(a.bar, a.grid);
    if (active) {  // V[j+1] = x / hn
      if (warp < s.np) {  // warp q: piece q's hn
        const T hn = reduce_hn<T>(a, warp ? own1 : own0, rho, lane, true);
        if (lane == 0) scr[2 * kConsumerWarps + warp] = hn;
      }
      consumer_sync();
      const T inv0 = inv_or_zero(scr[2 * kConsumerWarps], a.tiny);
      const T inv1 = s.np > 1 ? inv_or_zero(scr[2 * kConsumerWarps + 1], a.tiny) : T(0);
      for (int e = tid; e < s.L; e += kConsumers) {
        const bool p0 = e < s.L0;
        const size_t at = p0 ? ((size_t)sys0 * (a.m + 1) + j + 1) * a.n + s.t0 + e
                             : ((size_t)sys1 * (a.m + 1) + j + 1) * a.n + (e - s.L0);
        a.V[at] = cscale<T>(x[e], p0 ? inv0 : inv1);
      }
      consumer_sync();  // scr and x are reused by the next round
    }
  }
  if (b != 0) return;

  // CTA 0: a warp a system forms its rotation (hn from the partial norms,
  // hr[j] from hrj), 8 systems at a time; then all its threads rotate those
  // systems' rows j and j+1 of Q; last the flag word
  C* rot = hw;  // [8] u, then [8] (v, 0)
  int any_active = 0, any_bad = 0;
  for (int k0 = 0; k0 < a.K; k0 += kConsumerWarps) {
    const int k = k0 + warp;
    const bool valid = k < a.K;
    const int rho = valid ? k / a.per_round : 0;
    const Round r = round_at(rho, a.K, a.n, a.per_round, a.grid, a.unit);
    C hj = czero<T>(), gj = czero<T>();
    T rs = T(0), tg = T(0);
    if (valid && lane == 0) {  // issued beside the partial norms' loads
      hj = __ldcg(a.hrj + k);
      gj = a.g[(size_t)k * (a.m + 1) + j];
      rs = a.resid[k];
      tg = a.target[k];
    }
    const T hn = reduce_hn<T>(a, owners_of(r, valid ? k - r.sys0 : 0, a.n, a.unit), rho, lane,
                              valid);
    if (valid && lane == 0) {
      const T aa = t_hypot(hj.x, hj.y);
      const T rr = sqrt(aa * aa + hn * hn);
      const T inv_r = inv_or_zero(rr, a.tiny);
      const C u = rr > a.tiny ? cmake<T>(hj.x * inv_r, -hj.y * inv_r) : cmake<T>(T(1), T(0));
      const T v = hn * inv_r;
      if (rs > tg) a.steps[k] += 1;
      C* gk = a.g + (size_t)k * (a.m + 1);
      gk[j] = cmul<T>(u, gj);
      gk[j + 1] = cmake<T>(-gj.x * v, -gj.y * v);
      const T res = t_hypot(gj.x * v, gj.y * v);
      a.resid[k] = res;
      any_active |= res > tg;
      any_bad |= !isfinite(res);
      a.R[((size_t)k * a.m + j) * a.m + j] = cmake<T>(rr, T(0));
      rot[warp] = u;
      rot[kConsumerWarps + warp] = cmake<T>(v, T(0));
    }
    consumer_sync();
    // rows j and j+1 of Q; their columns past j + 1 are exact zeros
    const int nk = min(kConsumerWarps, a.K - k0);
#pragma unroll 4
    for (int t = tid; t < nk * (j + 2); t += kConsumers) {
      const int kk = t / (j + 2), c = t % (j + 2);
      const C u = rot[kk];
      const T v = rot[kConsumerWarps + kk].x;
      C* q0 = a.Q + ((size_t)(k0 + kk) * (a.m + 1) + j) * (a.m + 1);
      C* q1 = q0 + (a.m + 1);
      const C x0 = q0[c], x1 = q1[c];
      q0[c] = cadd<T>(cmul<T>(u, x0), cscale<T>(x1, v));
      q1[c] = cmake<T>(x1.x * u.x + x1.y * u.y - x0.x * v, x1.y * u.x - x1.x * u.y - x0.y * v);
    }
    consumer_sync();
  }
  any_active = consumer_or(any_active);
  any_bad = consumer_or(any_bad);
  if (tid == 0) {
    a.flag[0] = any_active;
    a.flag[1] = any_bad;
    a.flag[2] += 1;
  }
}

// y[k, col] for col < j_f (flag[2]) by back-substitution on R's upper
// triangle, right-looking, 0 for col >= j_f; one CTA a system.  Blocks of
// 32 columns from the last: the block's triangle R[col, c0..col] into
// shared memory (its rows are contiguous: coalesced), warp 0 solves the
// block (lane l holds g'[c0 + l]; y[col] broadcast by a shuffle, then the
// lanes below it update theirs), then every thread applies the block's y
// to its rows of g' above it, the columns in the same descending order as
// a column at a time.  Two barriers a block.
template <typename T>
__global__ void __launch_bounds__(kBsThreads)
k6_backsolve(const c2_t<T>* __restrict__ R, const c2_t<T>* __restrict__ g,
             const int* __restrict__ flag, c2_t<T>* __restrict__ y, int m, int gp_smem,
             T tiny) {
  using C = c2_t<T>;
  constexpr int B = 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ C blk[B][B + 1];  // blk[col - c0][r - c0] = R[col, r], r <= col
  __shared__ C yb[B];
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int jf = min(flag[2], m);
  C* yk = y + (size_t)k * m;
  C* gp = gp_smem ? reinterpret_cast<C*>(smem) : yk;  // g', then y
  const C* Rk = R + (size_t)k * m * m;
  for (int c = tid; c < m; c += kBsThreads) {
    if (c < jf)
      gp[c] = g[(size_t)k * (m + 1) + c];
    else
      yk[c] = czero<T>();
  }
  for (int c1 = jf; c1 > 0; c1 -= B) {
    const int c0 = c1 > B ? c1 - B : 0, nb = c1 - c0;
    for (int t = tid; t < nb * B; t += kBsThreads) {
      const int cl = t / B, rl = t % B;
      if (rl <= cl) blk[cl][rl] = Rk[(size_t)(c0 + cl) * m + c0 + rl];
    }
    __syncthreads();  // the triangle is in; g' above the block is final
    if (tid < 32) {
      C gl = lane < nb ? gp[c0 + lane] : czero<T>();
      for (int cl = nb - 1; cl >= 0; --cl) {
        const C rll = blk[cl][cl];
        const T sc = inv_or_zero(t_hypot(rll.x, rll.y), tiny);
        C yc;
        yc.x = __shfl_sync(kFull, gl.x, cl);
        yc.y = __shfl_sync(kFull, gl.y, cl);
        yc = cmul<T>(yc, cmake<T>(rll.x * sc * sc, -rll.y * sc * sc));
        if (lane < cl) gl = cfma<T>(blk[cl][lane], cmake<T>(-yc.x, -yc.y), gl);
        if (lane == cl) yb[cl] = yc;
      }
      __syncwarp();
      if (lane < nb) yk[c0 + lane] = yb[lane];
    }
    __syncthreads();  // the block's y is in yb
    for (int r = tid; r < c0; r += kBsThreads) {
      C acc = gp[r];
#pragma unroll 16
      for (int cl = nb - 1; cl >= 0; --cl)
        acc = cfma<T>(Rk[(size_t)(c0 + cl) * m + r], cmake<T>(-yb[cl].x, -yb[cl].y), acc);
      gp[r] = acc;
    }
    // the next block's triangle load writes blk after this barrier
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled, found once through the runtime's entry-point
// query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled tensor_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// V [K, m+1, n] complex as a 3D tensor of 8-byte words, a box rows x cw
// entries (n * sizeof(complex) a multiple of 16, cw * sizeof(complex) <= 2 KB)
template <typename T>
cudaError_t encode_v(CUtensorMap* map, void* V, int K, int n, int m, int cw, int rows) {
  constexpr int W = sizeof(c2_t<T>) / 8;
  const EncodeTiled enc = tensor_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n * W, (cuuint64_t)(m + 1), (cuuint64_t)K};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 8 * W, (cuuint64_t)(m + 1) * n * 8 * W};
  const cuuint32_t box[3] = {(cuuint32_t)(cw * W), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, V, dims, strides, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t step_launch(StepArgs<T> a, int smem, cudaStream_t stream) {
  // the shared-memory limit, set once per card (a CUDA call per launch
  // would add to the step's host time)
  static int limit_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || limit_set[dev] != smem) {
    err = allow_smem(k6_arnoldi_step<T>, (size_t)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) limit_set[dev] = smem;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)k6_arnoldi_step<T>, dim3(a.grid),
                                    dim3(kThreads), args, (size_t)smem, stream);
  if (err != cudaSuccess) cudaGetLastError();  // reported to the caller, not to the next launch
  return err;
}

template <typename T>
cudaError_t step_run(void* V, void* R, void* g, void* Q, void* resid, void* steps, void* flag,
                     const void* w, const void* diag, const void* target, void* cwork,
                     void* rwork, int K, int n, int m, int j, int grid, int per_round, int unit,
                     int lmax, int cw, int rb, int stages, int resident_rows, int max_pieces,
                     int x_smem, int boxes, int smem, double tiny, cudaStream_t stream) {
  using C = c2_t<T>;
  StepArgs<T> a;
  a.resident = j + 1 <= resident_rows;
  a.tensor = boxes > 0;
  a.boxes = boxes;
  a.brows = rb < j + 1 ? rb : j + 1;  // a box copies no row past j while j < rb
  if (a.tensor) {
    const cudaError_t err = encode_v<T>(&a.vmap, V, K, n, m, cw, a.brows);
    if (err != cudaSuccess) return err;
  }
  a.V = static_cast<C*>(V);
  a.R = static_cast<C*>(R);
  a.g = static_cast<C*>(g);
  a.Q = static_cast<C*>(Q);
  a.resid = static_cast<T*>(resid);
  a.steps = static_cast<int*>(steps);
  a.flag = static_cast<int*>(flag);
  a.w = static_cast<const C*>(w);
  a.diag = static_cast<const C*>(diag);
  a.target = static_cast<const T*>(target);
  a.part = static_cast<C*>(cwork);
  a.hg = a.part + (size_t)2 * grid * 2 * (m + 1);
  a.hrj = a.hg + (size_t)K * 2 * (m + 1);
  a.xs = x_smem ? nullptr : a.hrj + K;
  a.bar = static_cast<unsigned*>(rwork);
  a.pn = static_cast<T*>(rwork) + 16 / sizeof(T);
  a.K = K;
  a.n = n;
  a.m = m;
  a.j = j;
  a.grid = grid;
  a.per_round = per_round;
  a.rounds = (K + per_round - 1) / per_round;
  a.unit = unit;
  a.lmax = lmax;
  a.cw = cw;
  a.chunks = (lmax + cw - 1) / cw;
  a.rb = rb;
  a.stages = stages;
  a.red = j + 1 <= kJRed && (long long)max_pieces * (j + 1) <= kTRed;
  a.tiny = (T)tiny;
  return step_launch<T>(a, smem, stream);
}

}  // namespace

// One Arnoldi step j of every system, one cooperative launch.  V [K, m+1,
// n], R [K, m, m], g [K, m+1], Q [K, m+1, m+1] complex; resid [K] real;
// steps [K] int32; flag int32 [3]; w, diag [K, n] complex (w = the matvec
// of V[:, j]); target [K] real; cwork complex [2 grid 2 (m+1) + K 2 (m+1)
// + K (+ grid 2 lmax where x and s spill)]; rwork real, zeroed when the state
// is made [16 bytes (the barrier's counter) + rounds grid 2]; the plan
// (ops/gmres_step.py::_plan): grid CTAs, per_round systems a round, slice
// boundaries multiples of `unit`, lmax entries at most a slice, stages of
// rb rows x cw entries, `stages` of them in the ring, the tile resident
// while j + 1 <= resident_rows, max_pieces partials at most a value,
// x_smem, boxes (0: the streamed ring copies a row and piece at a time;
// 1 or 2: boxes of V's tensor map, that many a stage), smem bytes of
// dynamic shared memory.
extern "C" int bhs_arnoldi_step(void* V, void* R, void* g, void* Q, void* resid, void* steps,
                                void* flag, const void* w, const void* diag, const void* target,
                                void* cwork, void* rwork, int K, int n, int m, int j, int grid,
                                int per_round, int unit, int lmax, int cw, int rb, int stages,
                                int resident_rows, int max_pieces, int x_smem, int boxes,
                                int smem, double tiny, int dbl, void* stream) {
  const int fixed = dbl ? Smem<double>::kFixed : Smem<float>::kFixed;
  if (K < 1 || n < 1 || m < 1 || j < 0 || j >= m || grid < 1 || per_round < 1 ||
      per_round > grid || (unit != 1 && unit != 2) || lmax < 1 || cw < 1 || cw % unit ||
      rb < 1 || rb > kRbMax || stages < 1 || stages > kSlots || smem < fixed || boxes < 0 ||
      boxes > 2 || (boxes && ((long long)n * (dbl ? 16 : 8) % 16 || cw * (dbl ? 2 : 1) > 256 ||
                              (cw * (dbl ? 16 : 8)) % 16)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dbl ? step_run<double>(V, R, g, Q, resid, steps, flag, w, diag, target, cwork,
                                      rwork, K, n, m, j, grid, per_round, unit, lmax, cw, rb,
                                      stages, resident_rows, max_pieces, x_smem, boxes, smem,
                                      tiny, s)
                   : step_run<float>(V, R, g, Q, resid, steps, flag, w, diag, target, cwork,
                                     rwork, K, n, m, j, grid, per_round, unit, lmax, cw, rb,
                                     stages, resident_rows, max_pieces, x_smem, boxes, smem,
                                     tiny, s));
}

// The step's co-resident capacity on the current card at the whole
// shared memory a CTA may take: out int [3] = CTAs an SM, SMs, bytes.
extern "C" int bhs_arnoldi_capacity(int dbl, void* out) {
  int* o = static_cast<int*>(out);
  int dev = 0, smem = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = dbl ? allow_smem(k6_arnoldi_step<double>, (size_t)smem)
              : allow_smem(k6_arnoldi_step<float>, (size_t)smem);
  if (err == cudaSuccess)
    err = dbl ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6_arnoldi_step<double>,
                                                              kThreads, (size_t)smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6_arnoldi_step<float>,
                                                              kThreads, (size_t)smem);
  o[0] = blocks;
  o[1] = sms;
  o[2] = smem;
  return (int)err;
}

// y [K, m] complex from R [K, m, m], g [K, m+1] and j_f = flag[2]
extern "C" int bhs_gmres_backsolve(const void* R, const void* g, const void* flag, void* y,
                                   int K, int m, double tiny, int dbl, void* stream) {
  if (K < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, budget = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // g' in shared memory beside the block's triangle (34 KB at most), else
  // in y itself
  const size_t es = dbl ? 16 : 8, g_bytes = (size_t)m * es;
  const int gp_smem = g_bytes + 33 * 33 * es <= (size_t)budget;
  const size_t smem = gp_smem ? g_bytes : 0;
  if (dbl) {
    err = allow_smem(k6_backsolve<double>, smem);
    if (err != cudaSuccess) return (int)err;
    k6_backsolve<double><<<K, kBsThreads, smem, s>>>(
        static_cast<const double2*>(R), static_cast<const double2*>(g),
        static_cast<const int*>(flag), static_cast<double2*>(y), m, gp_smem, tiny);
  } else {
    err = allow_smem(k6_backsolve<float>, smem);
    if (err != cudaSuccess) return (int)err;
    k6_backsolve<float><<<K, kBsThreads, smem, s>>>(
        static_cast<const float2*>(R), static_cast<const float2*>(g),
        static_cast<const int*>(flag), static_cast<float2*>(y), m, gp_smem, (float)tiny);
  }
  return (int)cudaGetLastError();
}
