// Felsenstein pruning for large trees on Hopper (B3/B4): the forward pass
// with a residual of scaled partials, and the adjoint that reads the
// residual instead of recomputing the forward; float and double, behind a
// plain C interface (built with nvcc, loaded with ctypes by
// paml_tpu_torch/_build.py).
//
// Replaces the TPU kernels of paml_tpu/core/pallas_pruning_big.py:
//   big_fwd  <- _fwd_big_kernel (:170), via _fwd_big_call_x32 (:514)
//   big_bwd  <- _bwd_big_kernel (:270), via _bwd_big_call_x32 (:566)
//
// The kernels are pruning_tree.cuh's tree walk with state-code tips (AMB =
// false): its header has the schedules, the design and what bounds them.
// One entry point per dtype and padded state count N (`_n32`, `_n64`).
// State-code tips only, as in the JAX kernel; the coded tips with an
// ambiguity table go to pruning.cu (B1/B2), the same walk with AMB = true.

#include "pruning_tangent.cuh"

namespace {

template <typename T, int N>
int launch_big_fwd(const int* fs, int nsteps, int kmax, const T* P,
                   const int* states, const T* pi, T* lnf, T* S, T* work,
                   int ntiles, int C, int H, int ns, int n, int nslots,
                   int smem, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      big_fwd_kernel<T, false, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  big_fwd_kernel<T, false, N><<<dim3(ntiles, C), NT, smem, stream>>>(
      fs, nsteps, kmax, P, states, pi, lnf, S, work, C, H, ns, n, nslots,
      nullptr, 0);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_big_bwd(const int* bs, int nint, int kmax, const T* P,
                   const int* states, const T* pi, const T* gbar, const T* S,
                   T* dP_slab, T* dpi_slab, T* work, T* dP, T* dpi, int G,
                   int ntiles, int TV, int C, int H, int ns, int n, int nnode,
                   int vclip, int nslots, int root, int smem,
                   cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      big_bwd_kernel<T, false, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  big_bwd_kernel<T, false, N><<<dim3(G, C), NT, smem, stream>>>(
      bs, nint, kmax, P, states, pi, gbar, S, dP_slab, dpi_slab, work, C, H,
      ns, n, nnode, vclip, nslots, ntiles, TV, nullptr, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<T, N>(dP_slab, dpi_slab, dP, dpi, G, nnode, C, n,
                             root, stream);
}

}  // namespace

#define PAML_BIG_ENTRIES(T, SUFFIX, NPAD)                                    \
  extern "C" int paml_big_fwd_##SUFFIX##_n##NPAD(                            \
      const int* fs, int nsteps, int kmax, const T* P, const int* states,    \
      const T* pi, T* lnf, T* S, T* work, int ntiles, int C, int H, int ns,  \
      int n, int nslots, int smem, void* stream) {                           \
    return launch_big_fwd<T, NPAD>(fs, nsteps, kmax, P, states, pi, lnf, S,  \
                                   work, ntiles, C, H, ns, n, nslots, smem,  \
                                   static_cast<cudaStream_t>(stream));       \
  }                                                                          \
  extern "C" int paml_big_bwd_##SUFFIX##_n##NPAD(                            \
      const int* bs, int nint, int kmax, const T* P, const int* states,      \
      const T* pi, const T* gbar, const T* S, T* dP_slab, T* dpi_slab,       \
      T* work, T* dP, T* dpi, int G, int ntiles, int TV, int C, int H,       \
      int ns, int n, int nnode, int vclip, int nslots, int root, int smem,   \
      void* stream) {                                                        \
    return launch_big_bwd<T, NPAD>(bs, nint, kmax, P, states, pi, gbar, S,   \
                                   dP_slab, dpi_slab, work, dP, dpi, G,      \
                                   ntiles, TV, C, H, ns, n, nnode, vclip,    \
                                   nslots, root, smem,                       \
                                   static_cast<cudaStream_t>(stream));       \
  }

PAML_BIG_ENTRIES(float, f32, 32)
PAML_BIG_ENTRIES(float, f32, 64)
PAML_BIG_ENTRIES(double, f64, 32)
PAML_BIG_ENTRIES(double, f64, 64)
// H1 / H2 on state codes (pruning_tangent.cuh), float64: the Hessian's
PAML_TANGENT_ENTRIES(big_, false, double, f64, 32)
PAML_TANGENT_ENTRIES(big_, false, double, f64, 64)
