// KF's division without a divide (csrc/band_sr.cu `kf_div`) against the
// division itself, on the card: q = RN(q0 + r y), q0 = RN(a y), r = a -
// b q0 by FMAs, y = RN(1 / b), for b = 1 .. 256 and every float32 a, and
// 2^31 float64 a per b (half of them with exponents within 2^+-60, a
// quarter with any bits, a quarter below 2^-980).  Prints the mismatches
// (bits, NaN equal to NaN) at finite |a| >= 2^-100 (float) / 2^-1000
// (double), where kf_div claims RN(a / b), below, and at infinite a (an
// infinite a / b comes out NaN).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/kf_div_check tools/kf_div_check.cu
//   build/kf_div_check
#include <cstdio>

// float: claimed, below, infinite; double: claimed, below, infinite
__device__ unsigned long long counts[6];

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T kf_div(T a, T b, T y) {  // as csrc/band_sr.cu
  const T q0 = mul_rn(a, y);
  return fma(fma(-b, q0, a), y, q0);
}

__global__ void check_float() {
  const float b = (float)(1 + blockIdx.y);
  const float y = 1.0f / b;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float a = __uint_as_float((unsigned)i);
    const float ref = a / b, got = kf_div(a, b, y);
    if (__float_as_uint(ref) != __float_as_uint(got) && !(ref != ref && got != got))
      atomicAdd(&counts[isinf(a) ? 2 : fabsf(a) >= 0x1p-100f ? 0 : 1], 1ull);
  }
}

__global__ void check_double(unsigned long long seed) {
  const double b = (double)(1 + blockIdx.y);
  const double y = 1.0 / b;
  unsigned long long s = seed ^ (blockIdx.x * 0x9E3779B97F4A7C15ull) ^
                         (threadIdx.x * 0xBF58476D1CE4E5B9ull) ^ blockIdx.y;
  for (int k = 0; k < 1024; ++k) {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    unsigned long long u = s * 0x2545F4914F6CDD1Dull;
    const unsigned long long e = (u >> 52) & 2047;
    if (k % 4 < 2)
      u = (u & 0x800FFFFFFFFFFFFFull) | ((1023 - 60 + e % 121) << 52);
    else if (k % 4 == 3)
      u = (u & 0x800FFFFFFFFFFFFFull) | ((e % 44) << 52);
    const double a = __longlong_as_double((long long)u);
    const double ref = a / b, got = kf_div(a, b, y);
    if (__double_as_longlong(ref) != __double_as_longlong(got) && !(ref != ref && got != got))
      atomicAdd(&counts[isinf(a) ? 5 : fabs(a) >= 0x1p-1000 ? 3 : 4], 1ull);
  }
}

int main() {
  check_float<<<dim3(4096, 256), 256>>>();
  check_double<<<dim3(8192, 256), 256>>>(12345);
  const cudaError_t err = cudaDeviceSynchronize();
  unsigned long long h[6] = {0, 0, 0, 0, 0, 0};
  cudaMemcpyFromSymbol(h, counts, sizeof h);
  printf("kf_div_check (%s): float32, every a, b = 1 .. 256: %llu mismatches at finite |a| >= "
         "2^-100, %llu below, %llu at infinite a; float64, 2^31 a per b: %llu at finite |a| >= "
         "2^-1000, %llu below, %llu at infinite a\n",
         cudaGetErrorString(err), h[0], h[1], h[2], h[3], h[4], h[5]);
  return err != cudaSuccess || h[0] || h[3];
}
