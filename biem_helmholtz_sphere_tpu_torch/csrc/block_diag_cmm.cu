// KB: products with stacks of block-diagonal complex matrices.
//
// Replaces the three dense [H, H] einsums of the factored (S|R) matvec in
// biem_helmholtz_sphere_tpu/biem/_core.py (_matfree_operator, factored
// `mv`): D^H and D per offset slot (degree blocks of size 2l+1, 4.2%
// nonzero at n_end=32) and the folded coaxial factor X per radius
// (child-state blocks of size n-|m|, 2.1% nonzero, in the packed layout
// the caller permutes into).  For every stack entry s and lane p:
//
//   y[s, p, off_b + i] = sum_j op(A_{s % n_mat})_b[i, j] x[s, p, off_b + j]
//
// with op the identity or the conjugate transpose, A given as its packed
// diagonal blocks (vals[mat, voffs[b] + i*g + j], row-major).
//
// What bounds it on the H100: FP32 (FP64) instruction throughput.  Per
// matvec at the bench shapes (c64) the blocks need ~3 GFLOP and read
// 13 MB (D, shared by the k's, twice) + 6 MB (X); the dense einsums did
// ~29x the flops and read ~29x the bytes.  Design: one CUDA block per
// (diagonal block, stack entry, tile of 24 lanes) stages op(A_b), transposed so that
// neighbouring threads read neighbouring words, and the lanes' slices in
// shared memory (63x63 c64 = 31.8 KB, c128 = 63.5 KB: dynamic shared
// memory above 48 KB); each thread then forms whole output entries from
// shared memory.  No atomics: every output entry has one writer.  Simple
// first version: no tensor cores (complex FP32 has none), no TMA.
#include "common.cuh"

namespace {

constexpr int kLaneTile = 24;  // lanes per CUDA block
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_diag_cmm_kernel(const c2_t<T>* __restrict__ vals, const int* __restrict__ offs,
                      const int* __restrict__ sizes, const int* __restrict__ voffs,
                      const c2_t<T>* __restrict__ x, c2_t<T>* __restrict__ y,
                      int n_mat, int nnz, int P, int H, int adjoint) {
  using T2 = c2_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* As = reinterpret_cast<T2*>(smem_raw);
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const int p0 = blockIdx.z * kLaneTile;
  const int g = sizes[b];
  const int off = offs[b];
  const int np = min(kLaneTile, P - p0);
  T2* Xs = As + g * g;

  // As[j*g + i] = op(A)[i][j]
  const T2* A = vals + (size_t)(s % n_mat) * nnz + voffs[b];
  for (int e = threadIdx.x; e < g * g; e += blockDim.x) {
    const T2 a = A[e];  // A[r][c], e = r*g + c
    if (adjoint) {
      As[e] = cmake<T>(a.x, -a.y);  // op(A)[c][r] = conj(A[r][c])
    } else {
      const int r = e / g, c = e - (e / g) * g;
      As[c * g + r] = a;
    }
  }
  const T2* xb = x + ((size_t)s * P + p0) * H + off;
  for (int e = threadIdx.x; e < np * g; e += blockDim.x) {
    const int q = e / g, j = e - q * g;
    Xs[e] = xb[(size_t)q * H + j];
  }
  __syncthreads();

  T2* yb = y + ((size_t)s * P + p0) * H + off;
  for (int e = threadIdx.x; e < np * g; e += blockDim.x) {
    const int q = e / g, i = e - q * g;
    const T2* xq = Xs + q * g;
    T2 acc = cmake<T>(0, 0);
    for (int j = 0; j < g; ++j) acc = cfma<T>(As[j * g + i], xq[j], acc);
    yb[(size_t)q * H + i] = acc;
  }
}

template <typename T>
cudaError_t run(const void* vals, const void* offs, const void* sizes, const void* voffs,
                const void* x, void* y, int n_stack, int n_mat, int nnz, int P, int H,
                int nblk, int g_max, int adjoint, cudaStream_t stream) {
  if (n_stack == 0 || P == 0 || nblk == 0) return cudaSuccess;
  const size_t smem = sizeof(c2_t<T>) * ((size_t)g_max * g_max + (size_t)kLaneTile * g_max);
  cudaError_t err = allow_smem(block_diag_cmm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nblk, n_stack, (P + kLaneTile - 1) / kLaneTile);
  block_diag_cmm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const c2_t<T>*>(vals), static_cast<const int*>(offs),
      static_cast<const int*>(sizes), static_cast<const int*>(voffs),
      static_cast<const c2_t<T>*>(x), static_cast<c2_t<T>*>(y), n_mat, nnz, P, H, adjoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bhs_block_diag_cmm(const void* vals, const void* offs, const void* sizes,
                                  const void* voffs, const void* x, void* y, int n_stack,
                                  int n_mat, int nnz, int P, int H, int nblk, int g_max,
                                  int adjoint, int dbl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbl)
    return (int)run<double>(vals, offs, sizes, voffs, x, y, n_stack, n_mat, nnz, P, H, nblk,
                            g_max, adjoint, st);
  return (int)run<float>(vals, offs, sizes, voffs, x, y, n_stack, n_mat, nnz, P, H, nblk,
                         g_max, adjoint, st);
}
