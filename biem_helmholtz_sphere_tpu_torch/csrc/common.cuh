// Complex helpers shared by the port's kernels (float2 / double2 storage,
// the interleaved layout of torch.complex64 / complex128).
#pragma once
#include <cuda_runtime.h>

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

template <typename T> using c2_t = typename Cplx<T>::type;

// Real math with explicit float / double overloads.
__device__ __forceinline__ float t_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double t_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float t_sin(float a) { return sinf(a); }
__device__ __forceinline__ double t_sin(double a) { return sin(a); }
__device__ __forceinline__ float t_cos(float a) { return cosf(a); }
__device__ __forceinline__ double t_cos(double a) { return cos(a); }
__device__ __forceinline__ float t_exp(float a) { return expf(a); }
__device__ __forceinline__ double t_exp(double a) { return exp(a); }
__device__ __forceinline__ float t_log(float a) { return logf(a); }
__device__ __forceinline__ double t_log(double a) { return log(a); }
__device__ __forceinline__ float t_hypot(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double t_hypot(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float t_atan2(float a, float b) { return atan2f(a, b); }
__device__ __forceinline__ double t_atan2(double a, double b) { return atan2(a, b); }

template <typename T>
__device__ __forceinline__ c2_t<T> cmake(T re, T im) {
  c2_t<T> r;
  r.x = re;
  r.y = im;
  return r;
}

template <typename T>
__device__ __forceinline__ c2_t<T> cmul(c2_t<T> a, c2_t<T> b) {
  return cmake<T>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc + a * b
template <typename T>
__device__ __forceinline__ c2_t<T> cfma(c2_t<T> a, c2_t<T> b, c2_t<T> acc) {
  acc.x = t_fma(a.x, b.x, t_fma(-a.y, b.y, acc.x));
  acc.y = t_fma(a.x, b.y, t_fma(a.y, b.x, acc.y));
  return acc;
}

template <typename T>
__device__ __forceinline__ c2_t<T> cadd(c2_t<T> a, c2_t<T> b) {
  return cmake<T>(a.x + b.x, a.y + b.y);
}

template <typename T>
__device__ __forceinline__ c2_t<T> cscale(c2_t<T> a, T s) {
  return cmake<T>(a.x * s, a.y * s);
}

// Sets the dynamic shared-memory limit of `kernel` (needed above 48 KB).
// On failure the runtime's last-error state is cleared: the caller reports
// the error, and the next launch must not read it back as its own.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}
