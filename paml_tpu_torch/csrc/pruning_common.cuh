// Device helpers shared by the pruning kernels (pruning.cu: B1/B2,
// pruning_big.cu: B3/B4).
//
// Layout (the JAX package's): P [nnode, C, N, N], row j = parent state,
// c[j, h] = sum_i P[j, i] s[i, h]; partials are [N, pattern]; states are
// padded to N = 64 by the wrapper (zero rows and columns), patterns are
// masked at the ragged edge by the kernels.  Each [64 x 64] x [64 x 64]
// product stages its operands in shared memory; 256 threads each hold a
// 4 x 4 tile of the result in registers and accumulate with FMA in the
// working type (no tensor cores, no TF32).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int N = 64;        // padded states
constexpr int HT = 64;       // patterns per tile
constexpr int LD = HT + 1;   // shared row stride (N == HT, one stride)
constexpr int NT = 256;      // threads per block

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float maxv() { return FLT_MAX; }
  static __device__ __forceinline__ float lg(float x) { return logf(x); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return fmaf(a, b, c);
  }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double maxv() { return DBL_MAX; }
  static __device__ __forceinline__ double lg(double x) { return log(x); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
};

// acc[p][q] = sum_k opA[ty + 16p][k] * opB[k][tx + 16q] over k < 64, with
// opA[r][k] = TA ? A[k][r] : A[r][k] and opB[k][c] = TB ? B[c][k] : B[k][c];
// A and B are [64][LD] in shared memory.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void mm64(const T* A, const T* B, T acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    T a[4], b[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      a[p] = TA ? A[k * LD + ty + 16 * p] : A[(ty + 16 * p) * LD + k];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      b[q] = TB ? B[(tx + 16 * q) * LD + k] : B[k * LD + tx + 16 * q];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = Num<T>::fma(a[p], b[q], acc[p][q]);
  }
}

// store a [64 x 64] register-tiled result to a row-major buffer (row
// stride ld), overwriting or adding
template <typename T>
__device__ __forceinline__ void store64(T* dst, int ld, T acc[4][4],
                                        bool add) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T* d = dst + (size_t)(ty + 16 * p) * ld + tx + 16 * q;
      *d = add ? *d + acc[p][q] : acc[p][q];
    }
}

template <typename T>
__device__ __forceinline__ void load_P(T* Ps, const T* Pv) {
  for (int e = threadIdx.x; e < N * N; e += NT)
    Ps[(e / N) * LD + e % N] = Pv[e];
}

// contribution of a state-code tip: c[j, h] = P[j, state[h]]
template <typename T>
__device__ __forceinline__ void tip_gather(T* out, const T* Pv,
                                           const int* sv, int h0, int H) {
  for (int e = threadIdx.x; e < N * HT; e += NT) {
    const int j = e / HT, h = e % HT, hg = h0 + h;
    const int s = hg < H ? sv[hg] : 0;
    out[e] = Pv[j * N + s];
  }
}

// per-pattern max over states, msafe = m > 0 ? m : 1 (threads h < HT)
template <typename T>
__device__ __forceinline__ T column_msafe(const T* Ss, int h) {
  T m = Ss[h];
  for (int j = 1; j < N; ++j) {
    const T x = Ss[j * LD + h];
    m = x > m ? x : m;
  }
  return m > T(0) ? m : T(1);
}

template <typename T>
__device__ __forceinline__ T root_F(const T* Ss, const T* pic, int h) {
  T F = T(0);
  for (int j = 0; j < N; ++j) F += pic[j] * Ss[j * LD + h];
  return F > Num<T>::tiny() ? F : Num<T>::tiny();
}

// the adjoint's G = A / m * (product of the siblings), clipped at +-1e12
// with NaN -> 0 (keeps absurd line-search trial points finite)
template <typename T>
__device__ __forceinline__ T clip_adjoint(T x) {
  const T cap = T(1e12);
  return x != x ? T(0) : (x > cap ? cap : (x < -cap ? -cap : x));
}

template <typename T>
__device__ __forceinline__ T guard(T x) {
  const T big = T(1e30);
  if (x != x) return T(0);
  if (x > Num<T>::maxv()) return big;
  if (x < -Num<T>::maxv()) return -big;
  return x;
}

// dP[k, c, i, j] = sum_g slab[g, k, c, i, j] (root row 0), dpi likewise,
// sliced from N back to n, with nan_to_num
template <typename T>
__global__ void reduce_kernel(const T* __restrict__ dP_slab,
                              const T* __restrict__ dpi_slab,
                              T* __restrict__ dP, T* __restrict__ dpi, int G,
                              int nnode, int C, int n, int root) {
  const size_t nP = (size_t)nnode * C * n * n;
  const size_t total = nP + (size_t)C * n;
  const size_t slab = (size_t)nnode * C * N * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    T s = T(0);
    if (idx < nP) {
      size_t r = idx;
      const int j = r % n;
      r /= n;
      const int i = r % n;
      r /= n;
      const int c = r % C;
      const int k = (int)(r / C);
      if (k != root) {
        const size_t off = (((size_t)k * C + c) * N + i) * N + j;
        for (int g = 0; g < G; ++g) s += dP_slab[g * slab + off];
      }
      dP[idx] = guard(s);
    } else {
      const size_t r = idx - nP;
      const int j = r % n, c = (int)(r / n);
      for (int g = 0; g < G; ++g) s += dpi_slab[((size_t)g * C + c) * N + j];
      dpi[r] = guard(s);
    }
  }
}

template <typename T>
int launch_reduce(const T* dP_slab, const T* dpi_slab, T* dP, T* dpi, int G,
                  int nnode, int C, int n, int root, cudaStream_t stream) {
  const size_t total = (size_t)nnode * C * n * n + (size_t)C * n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  reduce_kernel<T><<<blocks, 256, 0, stream>>>(dP_slab, dpi_slab, dP, dpi,
                                               G, nnode, C, n, root);
  return (int)cudaGetLastError();
}

}  // namespace
