// Fused Felsenstein pruning on Hopper (B1/B2): the forward pass and its
// analytic adjoint for tips of any kind, float and double, behind a plain C
// interface (built with nvcc, loaded with ctypes by
// paml_tpu_torch/_build.py).
//
// Replaces the TPU kernels of paml_tpu/core/pallas_pruning.py:
//   pruning_fwd  <- _fwd_kernel_body (:389) over _upward (:347)
//   pruning_bwd  <- _bwd_kernel_body (:406)
//
// The Pallas pair takes tips as dense [ns, H, n] partials, so a gap or an
// ambiguous codon anywhere turns every tip into an [N x N] x [N x H]
// product.  Here the tips are coded (cuda_pruning.TipCodes): int32 codes
// [ns, H], a code below n a resolved state, a code n + a row a of the
// table amb [A, N] of the alignment's distinct tip vectors that are not
// one-hot (a gap is all ones, a codon with an N the codons it allows).
//
// Design
// * The walk is pruning_tree.cuh's, the large-tree pair's (B3/B4), with
//   AMB = true, at the padded state count N = 32 or 64 (one entry point per
//   instance, `_n32` / `_n64`; the wrapper chooses): 32-pattern tiles,
//   one forward block per (tile, class) that writes the residual S of
//   scaled partials, an adjoint that reads S and
//   keeps O(depth) adjoint slots, its grid G x C >= the SM count, products
//   on the FP64 tensor cores in float64 and FMA in float32, dP slabs summed
//   in a fixed order.  The walk takes binary trees: the wrapper walks
//   cuda_pruning.big_tree.
// * tip_table_kernel (pruning_tree.cuh) computes TA[v, c] = P_v amb^T [N x
//   LA] for every tip v and class c, once per launch: a tip's contribution
//   at an ambiguous cell is then a gather from TA, as a resolved cell's is
//   from P_v.  Its cost does not depend on the patterns: 2 n^2 A per tip and
//   class.
// * The adjoint's tip dP: a resolved cell is B4's ordered scatter; an
//   ambiguous cell a rank-one update G_k[:, h] amb[a]^T of the registers of
//   the product layout, in pattern order, added to the scatter's sum once
//   per visit.  Both orders are fixed, so fits repeat bit for bit.
//
// What bounds it on the H100 (f64; cuda_pruning.kernel_work).  As B3/B4:
// the products of the internal nodes (the bench shape: 2.7 GFLOP forward,
// 8.2 adjoint) and S (0.18 GB at the bench shape, 10 GB at 1024 taxa x
// 10240 patterns); the tip table and the ambiguous cells add a few per
// cent for gapped codon data.  What the walk leaves of the bound is B3/B4's
// (pruning_tree.cuh, PERF.md).

#include "pruning_tangent.cuh"

namespace {

template <typename T, int N>
int launch_fwd(const int* fs, int nsteps, int kmax, const T* P,
               const int* codes, const T* amb, int A, const T* pi, T* lnf,
               T* S, T* work, T* TA, int ntiles, int C, int H, int ns, int n,
               int nslots, int LA, int smem, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  int err = launch_tip_table<T, N>(P, 0, amb, TA, 0, 1, ns, C, A, LA,
                                   stream);
  if (err != (int)cudaSuccess) return err;
  cudaError_t e = cudaFuncSetAttribute(
      big_fwd_kernel<T, true, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  big_fwd_kernel<T, true, N><<<dim3(ntiles, C), NT, smem, stream>>>(
      fs, nsteps, kmax, P, codes, pi, lnf, S, work, C, H, ns, n, nslots, TA,
      LA);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_bwd(const int* bs, int nint, int kmax, const T* P,
               const int* codes, const T* amb, int A, const T* pi,
               const T* gbar, const T* S, T* dP_slab, T* dpi_slab, T* work,
               T* TA, T* dP, T* dpi, int G, int ntiles, int TV, int C, int H,
               int ns, int n, int nnode, int vclip, int nslots, int root,
               int LA, int smem, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  int err = launch_tip_table<T, N>(P, 0, amb, TA, 0, 1, ns, C, A, LA,
                                   stream);
  if (err != (int)cudaSuccess) return err;
  cudaError_t e = cudaFuncSetAttribute(
      big_bwd_kernel<T, true, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  big_bwd_kernel<T, true, N><<<dim3(G, C), NT, smem, stream>>>(
      bs, nint, kmax, P, codes, pi, gbar, S, dP_slab, dpi_slab, work, C, H,
      ns, n, nnode, vclip, nslots, ntiles, TV, amb, TA, LA);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce<T, N>(dP_slab, dpi_slab, dP, dpi, G, nnode, C, n,
                             root, stream);
}

}  // namespace

#define PAML_PRUNING_ENTRIES(T, SUFFIX, NPAD)                                \
  extern "C" int paml_pruning_fwd_##SUFFIX##_n##NPAD(                        \
      const int* fs, int nsteps, int kmax, const T* P, const int* codes,     \
      const T* amb, int A, const T* pi, T* lnf, T* S, T* work, T* TA,        \
      int ntiles, int C, int H, int ns, int n, int nslots, int LA, int smem, \
      void* stream) {                                                        \
    return launch_fwd<T, NPAD>(fs, nsteps, kmax, P, codes, amb, A, pi, lnf,  \
                               S, work, TA, ntiles, C, H, ns, n, nslots, LA, \
                               smem, static_cast<cudaStream_t>(stream));     \
  }                                                                          \
  extern "C" int paml_pruning_bwd_##SUFFIX##_n##NPAD(                        \
      const int* bs, int nint, int kmax, const T* P, const int* codes,       \
      const T* amb, int A, const T* pi, const T* gbar, const T* S,           \
      T* dP_slab, T* dpi_slab, T* work, T* TA, T* dP, T* dpi, int G,         \
      int ntiles, int TV, int C, int H, int ns, int n, int nnode, int vclip, \
      int nslots, int root, int LA, int smem, void* stream) {                \
    return launch_bwd<T, NPAD>(bs, nint, kmax, P, codes, amb, A, pi, gbar,   \
                               S, dP_slab, dpi_slab, work, TA, dP, dpi, G,   \
                               ntiles, TV, C, H, ns, n, nnode, vclip, nslots,\
                               root, LA, smem,                               \
                               static_cast<cudaStream_t>(stream));           \
  }

PAML_PRUNING_ENTRIES(float, f32, 32)
PAML_PRUNING_ENTRIES(float, f32, 64)
PAML_PRUNING_ENTRIES(double, f64, 32)
PAML_PRUNING_ENTRIES(double, f64, 64)
// H1 / H2 on coded tips (pruning_tangent.cuh), float64: the Hessian's
PAML_TANGENT_ENTRIES(pruning_, true, double, f64, 32)
PAML_TANGENT_ENTRIES(pruning_, true, double, f64, 64)
