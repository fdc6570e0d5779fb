// Device helpers shared by the pruning kernels (pruning_tree.cuh's tree
// walk, instantiated by pruning.cu: B1/B2 and pruning_big.cu: B3/B4).
//
// Layout (the JAX package's): P [nnode, C, N, N], row j = parent state,
// c[j, h] = sum_i P[j, i] s[i, h]; partials are [N, pattern]; states are
// padded by the wrapper (zero rows and columns) to the padded state count
// N, a template parameter of every kernel, as the TPU kernels' N is a
// parameter of their shapes (paml_tpu/core/pallas_pruning.py:502): N = 32
// for 16 to 32 states (amino acids), N = 64 for 33 to 64 (codons); the
// wrapper chooses the instance (cuda_pruning.padded_states).  Patterns
// are masked at the ragged edge by the kernels.
//
// The products stage their operands in shared memory: the three forms the
// walk needs on a tile of BHT = 32 patterns (prod_ps, prod_pts, prod_gst),
// P s and P^T G ([N x N] x [N x 32]) and G s^T ([N x 32] x [32 x N],
// added into registers).  In float64 each warp issues Hopper's FP64
// tensor-core product (mma.sync m16n8k8 .f64: 67 TFLOP/s on the H100 SXM's
// data sheet, twice its FP64 FMA rate); the operand strides LDN = N + 4
// and LDH = 36 (both 4 mod 16 doubles) make the 8-byte fragment loads free
// of bank conflicts.  In float32 the same threads compute the same result
// elements with FMA (TF32 would break the f32 tolerances).  The forward and
// the adjoint call the same routine, so the adjoint's recomputed
// contributions, and the scale factors taken from them, are bit for bit
// the forward's.  What bounds the kernels is the tree walk around the
// products (pruning_tree.cuh).
//
// Padding adds exact zeros to every product and sum, and the products take
// their k-steps in the same order at both N, so N = 32 and N = 64 give the
// same products.  The one sum over the states outside them, the root's
// (col_reduce), takes 8 rows a thread at both (pruning_tree.cuh: ROOT_RW),
// so the two instances give the same bits where the adjoint's grid (the
// order of its dP slabs' sum) is the same.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block (8 warps)
constexpr int BHT = 32;      // patterns per tile
constexpr int LDH = BHT + 4; // shared row stride of a [N x BHT] operand

// What follows from the padded state count N (32 or 64).  A product's
// result is cut into RG groups of 16 rows; the 8 warps take CG = 8 / RG
// column groups of each, QH tiles of 8 columns of a [N x BHT] result and
// QN of a [N x N] one (EH and EN accumulator values a thread).  The
// elementwise phases give each thread RW = N / 8 rows of its pattern.
template <int N>
struct Pad {
  static_assert(N == 32 || N == 64, "the walk takes N = 32 or N = 64");
  static constexpr int LDN = N + 4;       // row stride of an [N x N] operand
  static constexpr int TLD = N + 1;       // row stride of a tip's dP_k
  static constexpr int RG = N / 16;
  static constexpr int RGS = N / 32;      // log2 RG
  static constexpr int CG = 8 / RG;
  static constexpr int QH = BHT / 8 / CG;
  static constexpr int QN = N / 8 / CG;
  static constexpr int EH = 4 * QH;
  static constexpr int EN = 4 * QN;
  static constexpr int RW = N / 8;
};

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

// the adjoint's G = A / m * (product of the siblings), clipped at +-1e12
// with NaN -> 0 (keeps absurd line-search trial points finite).  Only a
// child of the caller's tree is clipped (kid < vclip); a node that
// big_tree added (identity P) keeps its G, NaN -> 0 alone: each added
// level rescales its partial, so its G legitimately grows by 1 / m per
// level, and a clip there would change the gradient of a wide node's
// children from what the tree itself gives
template <typename T>
__device__ __forceinline__ T clip_adjoint(T x, bool own) {
  const T cap = T(1e12);
  if (x != x) return T(0);
  if (!own) return x;
  return x > cap ? cap : (x < -cap ? -cap : x);
}

template <typename T>
__device__ __forceinline__ T guard(T x) {
  const T big = T(1e30);
  if (x != x) return T(0);
  if (x > Num<T>::maxv()) return big;
  if (x < -Num<T>::maxv()) return -big;
  return x;
}

// ---------------------------------------------------------------------------
// Products.  Warp w owns rows 16 (w % RG) + [0, 16) of the result and its
// column group w / RG; lane (gq = lane / 4, tq = lane % 4) holds, in each
// 16 x 8 tile, rows gq and gq + 8 and columns 2 tq and 2 tq + 1 (the
// m16n8k8 accumulator layout, used for float32 too).  NQ tiles a warp: a
// [N x BHT] result's at columns 8 (QH (w / RG) + q), a [N x N] result's at
// 8 (QN (w / RG) + q).  At N = 64 (RG 4) that is 2 tiles of [64 x BHT] and
// 4 of [64 x 64] a warp; at N = 32 (RG 2) one of each.  Element e of the
// accumulator is tile q = e / 4, register r = e % 4.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double d[4], const double a[4],
                                     const double b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// (row, column) of accumulator element e; NQ = Pad<N>::QH or Pad<N>::QN
template <int N, int NQ>
__device__ __forceinline__ void acc_rc(int e, int& row, int& col) {
  constexpr int RG = Pad<N>::RG, RGS = Pad<N>::RGS;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = e >> 2, r = e & 3;
  row = 16 * (w & (RG - 1)) + (lane >> 2) + 8 * (r >> 1);
  col = 8 * (NQ * (w >> RGS) + q) + 2 * (lane & 3) + (r & 1);
}

// acc (NQ tiles of 16 x 8) += opA [N x KD] . opB [KD x 8 NQ (this warp's
// columns)], with opA(m, k) = A[m * sam + k * sak] and opB(k, n) =
// B[k * sbk + n * sbn] in shared memory, k ascending (a fixed order)
template <typename T, int N, int NQ, int KD>
__device__ __forceinline__ void prod_acc(const T* A, int sam, int sak,
                                         const T* B, int sbk, int sbn,
                                         T* acc) {
  constexpr int RG = Pad<N>::RG, RGS = Pad<N>::RGS;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (w & (RG - 1)) + gq, n0 = 8 * NQ * (w >> RGS);
  if constexpr (std::is_same<T, double>::value) {
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 8) {
      const int ka = k0 + tq;
      const double a[4] = {A[r0 * sam + ka * sak], A[(r0 + 8) * sam + ka * sak],
                           A[r0 * sam + (ka + 4) * sak],
                           A[(r0 + 8) * sam + (ka + 4) * sak]};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int nc = n0 + 8 * q + gq;
        const double b[2] = {B[ka * sbk + nc * sbn],
                             B[(ka + 4) * sbk + nc * sbn]};
        dmma(acc + 4 * q, a, b);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < KD; ++k) {
      const T a0 = A[r0 * sam + k * sak], a1 = A[(r0 + 8) * sam + k * sak];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int nc = n0 + 8 * q + 2 * tq;
        const T b0 = B[k * sbk + nc * sbn], b1 = B[k * sbk + (nc + 1) * sbn];
        acc[4 * q + 0] = Num<T>::fma(a0, b0, acc[4 * q + 0]);
        acc[4 * q + 1] = Num<T>::fma(a0, b1, acc[4 * q + 1]);
        acc[4 * q + 2] = Num<T>::fma(a1, b0, acc[4 * q + 2]);
        acc[4 * q + 3] = Num<T>::fma(a1, b1, acc[4 * q + 3]);
      }
    }
  }
}

// acc (EH values) = P s: P [N][LDN], s [N][LDH]
template <typename T, int N>
__device__ __forceinline__ void prod_ps(const T* Ps, const T* Ss, T* acc) {
#pragma unroll
  for (int e = 0; e < Pad<N>::EH; ++e) acc[e] = T(0);
  prod_acc<T, N, Pad<N>::QH, N>(Ps, Pad<N>::LDN, 1, Ss, LDH, 1, acc);
}

// acc (EH values) = P^T G: P [N][LDN], G [N][LDH]
template <typename T, int N>
__device__ __forceinline__ void prod_pts(const T* Ps, const T* Gs, T* acc) {
#pragma unroll
  for (int e = 0; e < Pad<N>::EH; ++e) acc[e] = T(0);
  prod_acc<T, N, Pad<N>::QH, N>(Ps, 1, Pad<N>::LDN, Gs, LDH, 1, acc);
}

// acc (EN values) += G s^T: G [N][LDH], s [N][LDH] (a sum over the tile's
// patterns)
template <typename T, int N>
__device__ __forceinline__ void prod_gst(const T* Gs, const T* Ss, T* acc) {
  prod_acc<T, N, Pad<N>::QN, BHT>(Gs, LDH, 1, Ss, 1, LDH, acc);
}

// dP[k, c, i, j] = sum_g slab[g, k, c, i, j] (root row 0), dpi likewise,
// sliced from N back to n, with nan_to_num
template <typename T, int N>
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

template <typename T, int N>
int launch_reduce(const T* dP_slab, const T* dpi_slab, T* dP, T* dpi, int G,
                  int nnode, int C, int n, int root, cudaStream_t stream) {
  const size_t total = (size_t)nnode * C * n * n + (size_t)C * n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  reduce_kernel<T, N><<<blocks, 256, 0, stream>>>(dP_slab, dpi_slab, dP, dpi,
                                               G, nnode, C, n, root);
  return (int)cudaGetLastError();
}

}  // namespace
