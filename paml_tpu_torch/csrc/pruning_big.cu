// Felsenstein pruning for large trees on Hopper: the forward pass with a
// residual of scaled partials, and the adjoint that reads the residual
// instead of recomputing the forward; templated on float and double, behind
// a plain C interface (built with nvcc, loaded with ctypes by
// paml_tpu_torch/_build.py).
//
// Replaces the TPU kernels of paml_tpu/core/pallas_pruning_big.py:
//   big_fwd  <- _fwd_big_kernel (:170), via _fwd_big_call_x32 (:514)
//   big_bwd  <- _bwd_big_kernel (:270), via _bwd_big_call_x32 (:566)
//
// Schedules (host: cuda_pruning.BigPlan, the port of _sched_arrays :59):
//   fsched row, DFS postorder, root last:
//     [v, out_slot, srow | -1, kid_slot x Kmax (-1 pad)]
//   bsched row, internal nodes in reverse DFS order, root first:
//     [v, aslot, srow_v, (kid, kid_srow | -1, kid_aslot | -1,
//                         grandkid_tip x Kmax) x Kmax]
// A "cherry" is a non-root internal node whose children are all tips: it
// has no row in the residual S [n_srows, C, n, H]; the adjoint rebuilds its
// scaled partial from the grandchild tips.
//
// Design
// * One block per (pattern tile of HT = 64, site class) in the forward; the
//   adjoint's block (g, c) walks tiles g, g + G, ... and adds into its own
//   dP [nnode, C, N, N] and dpi [C, N] slab, which reduce_kernel sums (root
//   row zeroed, nan_to_num), as the JAX wrapper does outside its kernel
//   (:614-617).  Slabs rather than atomics: the sum order is fixed, so fits
//   repeat bit for bit.
// * Every internal node is rescaled (the JAX kernel's int_s, :206-214), so
//   the residual holds s_v = prod / max and the adjoint's recomputed
//   contributions and scale factors are bit for bit the forward's.
// * The forward writes each non-cherry internal node's scaled partial to S
//   from the shared-memory tile with plain coalesced stores (rows j < n,
//   patterns h < H); the TPU's 2-deep DMA ring has no counterpart.
// * The adjoint keeps O(depth) state per block: nslots + 1 adjoint slots
//   (A_v reuses c_v's forward slot, the root takes slot nslots) and, for the
//   node at hand, each child's s_k and c_k = P_k s_k; B2 keeps every node.
//   A node's slot is its last child's (the slot scan hands v the slot its
//   last child freed), so the children are processed in order and the last
//   one's A_k overwrites A_v only after A_v was last read.
// * State-code tips only, as in the JAX kernel: a tip's contribution is the
//   gather c[j, h] = P[j, state[h]]; its s is the one-hot of its state.
//
// What bounds it on the H100 (f64, one 1024-pattern chunk of the
// 1024-taxon balanced tree, C = 4; computed from the shapes).  The forward
// does 1022 products of 2 * 64^3 per (tile, class): 34 GFLOP over 64 blocks,
// which fill half of the 132 SMs; it writes S, 511 rows x 4 x 61 x 1024 x
// 8 B = 1.02 GB.  The adjoint does about 5 products per internal node and
// class (c_k and dP_k for two children, A_k for the internal ones): ~170
// GFLOP, reads S once, and writes G dP slabs of 268 MB, which the reduction
// reads back.  The products use FMA in the working type from shared memory,
// as in pruning.cu, so both kernels are bound by the shared-memory loads
// of the product loop and, at one chunk, by the 64 blocks per launch.

#include "pruning_common.cuh"

namespace {

// Ss[j][h] (and sk[j*HT + h] when asked) = S[srow, c, j, h0 + h], zero
// past n and H
template <typename T>
__device__ __forceinline__ void load_S_row(T* Ss, T* sk, const T* S,
                                           int srow, int c, int C, int n,
                                           int H, int h0) {
  const T* src = S + ((size_t)srow * C + c) * n * H;
  for (int e = threadIdx.x; e < N * HT; e += NT) {
    const int j = e / HT, h = e % HT, hg = h0 + h;
    const T x = (j < n && hg < H) ? src[(size_t)j * H + hg] : T(0);
    Ss[j * LD + h] = x;
    if (sk != nullptr) sk[e] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) big_fwd_kernel(
    const int* __restrict__ fs, int nsteps, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ pi, T* __restrict__ lnf, T* __restrict__ S,
    T* __restrict__ work, int C, int H, int ns, int n, int nslots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);
  T* Ss = Ps + N * LD;
  T* logm = Ss + N * LD;
  T* msc = logm + HT;
  const int tile = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int h0 = tile * HT, width = 3 + kmax;
  const size_t NH = (size_t)N * HT;
  T* wb = work + (size_t)(tile * C + c) * nslots * NH;
  if (tid < HT) logm[tid] = T(0);
  for (int i = 0; i < nsteps; ++i) {
    const int* r = fs + (size_t)i * width;
    const int v = r[0], out_slot = r[1], srow = r[2];
    const T* Pv = P + ((size_t)v * C + c) * N * N;
    if (v < ns) {
      tip_gather(wb + (size_t)out_slot * NH, Pv, states + (size_t)v * H, h0,
                 H);
      __syncthreads();
      continue;
    }
    // product of the children's contributions, rescaled by its column max
    for (int e = tid; e < N * HT; e += NT) {
      T prod = T(1);
      for (int k = 0; k < kmax; ++k) {
        const int sl = r[3 + k];
        if (sl >= 0) prod *= wb[(size_t)sl * NH + e];
      }
      Ss[(e / HT) * LD + e % HT] = prod;
    }
    __syncthreads();
    if (tid < HT) {
      const T ms = column_msafe(Ss, tid);
      msc[tid] = ms;
      logm[tid] += Num<T>::lg(ms);
    }
    __syncthreads();
    T* Sv = (S != nullptr && srow >= 0)
                ? S + ((size_t)srow * C + c) * n * H : nullptr;
    for (int e = tid; e < N * HT; e += NT) {
      const int j = e / HT, h = e % HT, hg = h0 + h;
      const T x = Ss[j * LD + h] / msc[h];
      Ss[j * LD + h] = x;
      if (Sv != nullptr && j < n && hg < H) Sv[(size_t)j * H + hg] = x;
    }
    __syncthreads();
    if (i == nsteps - 1) {   // the root
      if (tid < HT && h0 + tid < H) {
        const T F = root_F(Ss, pi + (size_t)c * N, tid);
        lnf[(size_t)c * H + h0 + tid] = Num<T>::lg(F) + logm[tid];
      }
      return;
    }
    load_P(Ps, Pv);
    __syncthreads();
    T acc[4][4];
    mm64<T, false, false>(Ps, Ss, acc);
    store64(wb + (size_t)out_slot * NH, HT, acc, false);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) big_bwd_kernel(
    const int* __restrict__ bs, int nint, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ pi, const T* __restrict__ gbar,
    const T* __restrict__ S, T* __restrict__ dP_slab,
    T* __restrict__ dpi_slab, T* __restrict__ work, int C, int H, int ns,
    int n, int nnode, int nslots, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);
  T* Ss = Ps + N * LD;
  T* Gs = Ss + N * LD;
  T* red = Gs + N * LD;    // [HT] scale factor of the node, or gbar / F
  T* red2 = red + HT;      // [HT] scale factor of a rebuilt cherry
  const int g = blockIdx.x, c = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const size_t NH = (size_t)N * HT;
  T* abuf = work + (size_t)(g * C + c) * (nslots + 1 + 2 * kmax) * NH;
  T* sbuf = abuf + (size_t)(nslots + 1) * NH;   // s_k of the node's children
  T* cbuf = sbuf + (size_t)kmax * NH;           // c_k = P_k s_k
  T* dps = dP_slab + (size_t)g * nnode * C * N * N;
  T* dpis = dpi_slab + (size_t)(g * C + c) * N;
  const T* pic = pi + (size_t)c * N;
  for (int tile = g; tile < ntiles; tile += G) {
    const bool add = tile != g;
    const int h0 = tile * HT;
    // root (bsched row 0): gF = gbar / F, A_root = gF pi, dpi += gF s_root
    load_S_row<T>(Ss, nullptr, S, bs[2], c, C, n, H, h0);
    __syncthreads();
    if (tid < HT) {
      const int hg = h0 + tid;
      red[tid] = hg < H ? gbar[(size_t)c * H + hg] / root_F(Ss, pic, tid)
                        : T(0);
    }
    __syncthreads();
    T* Ar = abuf + (size_t)bs[1] * NH;
    for (int e = tid; e < N * HT; e += NT) Ar[e] = red[e % HT] * pic[e / HT];
    if (tid < N) {
      T s = T(0);
      for (int h = 0; h < HT; ++h) s += red[h] * Ss[tid * LD + h];
      dpis[tid] = add ? dpis[tid] + s : s;
    }
    __syncthreads();
    for (int i = 0; i < nint; ++i) {
      const int* r = bs + (size_t)i * width;
      const T* Av = abuf + (size_t)r[1] * NH;
      // 1) each child's s_k and c_k = P_k s_k
      int K = 0;
      for (; K < kmax && r[3 + stride * K] >= 0; ++K) {
        const int* kr = r + 3 + stride * K;
        const int kid = kr[0], ksrow = kr[1];
        const T* Pk = P + ((size_t)kid * C + c) * N * N;
        T* ck = cbuf + (size_t)K * NH;
        if (kid < ns) {
          tip_gather(ck, Pk, states + (size_t)kid * H, h0, H);
          continue;
        }
        T* sk = sbuf + (size_t)K * NH;
        if (ksrow >= 0) {
          load_S_row(Ss, sk, S, ksrow, c, C, n, H, h0);
        } else {
          // cherry: product of the grandchild tips' gathers, rescaled
          for (int e = tid; e < N * HT; e += NT) {
            const int j = e / HT, h = e % HT, hg = h0 + h;
            T prod = T(1);
            for (int q = 0; q < kmax && kr[3 + q] >= 0; ++q) {
              const int gk = kr[3 + q];
              const int st = hg < H ? states[(size_t)gk * H + hg] : 0;
              prod *= P[(((size_t)gk * C + c) * N + j) * N + st];
            }
            Ss[j * LD + h] = prod;
          }
          __syncthreads();
          if (tid < HT) red2[tid] = column_msafe(Ss, tid);
          __syncthreads();
          for (int e = tid; e < N * HT; e += NT) {
            const int j = e / HT, h = e % HT;
            const T x = Ss[j * LD + h] / red2[h];
            Ss[j * LD + h] = x;
            sk[e] = x;
          }
        }
        load_P(Ps, Pk);
        __syncthreads();
        T acc[4][4];
        mm64<T, false, false>(Ps, Ss, acc);
        store64(ck, HT, acc, false);
        __syncthreads();
      }
      __syncthreads();
      // 2) the node's scale factor, from the product of the c_k
      if (tid < HT) {
        T m = T(0);
        for (int j = 0; j < N; ++j) {
          T p = cbuf[(size_t)j * HT + tid];
          for (int k = 1; k < K; ++k) p *= cbuf[k * NH + (size_t)j * HT + tid];
          m = (j == 0 || p > m) ? p : m;
        }
        red[tid] = m > T(0) ? m : T(1);
      }
      __syncthreads();
      // 3) per child: G_k, dP_k += G_k s_k^T, A_k = P_k^T G_k
      for (int k = 0; k < K; ++k) {
        const int* kr = r + 3 + stride * k;
        const int kid = kr[0], kaslot = kr[2];
        for (int e = tid; e < N * HT; e += NT) {
          const int j = e / HT, h = e % HT;
          T loo = T(1);
          for (int k2 = 0; k2 < K; ++k2)
            if (k2 != k) loo *= cbuf[k2 * NH + e];
          Gs[j * LD + h] = clip_adjoint(Av[e] / red[h] * loo);
        }
        if (kid < ns) {
          const int* sv = states + (size_t)kid * H;
          for (int e = tid; e < N * HT; e += NT) {
            const int j = e / HT, h = e % HT, hg = h0 + h;
            Ss[j * LD + h] = (hg < H && sv[hg] == j) ? T(1) : T(0);
          }
        } else {
          const T* sk = sbuf + k * NH;
          for (int e = tid; e < N * HT; e += NT)
            Ss[(e / HT) * LD + e % HT] = sk[e];
          load_P(Ps, P + ((size_t)kid * C + c) * N * N);
        }
        __syncthreads();
        T acc[4][4];
        mm64<T, false, true>(Gs, Ss, acc);
        store64(dps + ((size_t)kid * C + c) * N * N, N, acc, add);
        if (kid >= ns) {
          mm64<T, true, false>(Ps, Gs, acc);
          store64(abuf + (size_t)kaslot * NH, HT, acc, false);
        }
        __syncthreads();
      }
    }
  }
}

template <typename T>
int launch_big_fwd(const int* fs, int nsteps, int kmax, const T* P,
                   const int* states, const T* pi, T* lnf, T* S, T* work,
                   int ntiles, int C, int H, int ns, int n, int nslots,
                   cudaStream_t stream) {
  const int smem = (int)((2 * N * LD + 2 * HT) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      big_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  big_fwd_kernel<T><<<dim3(ntiles, C), NT, smem, stream>>>(
      fs, nsteps, kmax, P, states, pi, lnf, S, work, C, H, ns, n, nslots);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_big_bwd(const int* bs, int nint, int kmax, const T* P,
                   const int* states, const T* pi, const T* gbar, const T* S,
                   T* dP_slab, T* dpi_slab, T* work, T* dP, T* dpi, int G,
                   int ntiles, int C, int H, int ns, int n, int nnode,
                   int nslots, int root, cudaStream_t stream) {
  const int smem = (int)((3 * N * LD + 2 * HT) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      big_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  big_bwd_kernel<T><<<dim3(G, C), NT, smem, stream>>>(
      bs, nint, kmax, P, states, pi, gbar, S, dP_slab, dpi_slab, work, C, H,
      ns, n, nnode, nslots, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(dP_slab, dpi_slab, dP, dpi, G, nnode, C, n, root,
                       stream);
}

}  // namespace

#define PAML_BIG_ENTRIES(T, SUFFIX)                                           \
  extern "C" int paml_big_fwd_##SUFFIX(                                       \
      const int* fs, int nsteps, int kmax, const T* P, const int* states,     \
      const T* pi, T* lnf, T* S, T* work, int ntiles, int C, int H, int ns,   \
      int n, int nslots, void* stream) {                                      \
    return launch_big_fwd<T>(fs, nsteps, kmax, P, states, pi, lnf, S, work,   \
                             ntiles, C, H, ns, n, nslots,                     \
                             static_cast<cudaStream_t>(stream));              \
  }                                                                           \
  extern "C" int paml_big_bwd_##SUFFIX(                                       \
      const int* bs, int nint, int kmax, const T* P, const int* states,       \
      const T* pi, const T* gbar, const T* S, T* dP_slab, T* dpi_slab,        \
      T* work, T* dP, T* dpi, int G, int ntiles, int C, int H, int ns, int n, \
      int nnode, int nslots, int root, void* stream) {                        \
    return launch_big_bwd<T>(bs, nint, kmax, P, states, pi, gbar, S,          \
                             dP_slab, dpi_slab, work, dP, dpi, G, ntiles, C,  \
                             H, ns, n, nnode, nslots, root,                   \
                             static_cast<cudaStream_t>(stream));              \
  }

PAML_BIG_ENTRIES(float, f32)
PAML_BIG_ENTRIES(double, f64)
