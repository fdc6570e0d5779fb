// Fused Felsenstein pruning on Hopper: the forward pass and its analytic
// adjoint, templated on float and double, behind a plain C interface
// (built with nvcc, loaded with ctypes by paml_tpu_torch/_build.py).
//
// Replaces the TPU kernels of paml_tpu/core/pallas_pruning.py:
//   pruning_fwd  <- _fwd_kernel_body (:389) over _upward (:347)
//   pruning_bwd  <- _bwd_kernel_body (:406)
//
// Layout (the JAX package's): P [nnode, C, N, N], row j = parent state,
// c[j, h] = sum_i P[j, i] s[i, h]; partials are [N, pattern]; states are
// padded to N = 64 by the wrapper (zero rows and columns), patterns are
// masked at the ragged edge here.
//
// Design
// * One block per (pattern tile of HT = 64, site class): every class walks
//   the tree on its own.  The block loops over the tree schedule, an int32
//   table in device memory (one row per node in DFS postorder: node, flags,
//   slot, arity, child nodes, child slots), so one binary serves every
//   tree; the Pallas kernel was unrolled per topology at trace time.
// * Partials live in a device-memory workspace the wrapper allocates (the
//   forward reuses O(depth) slots through the host's liveness scan; the
//   adjoint keeps every node's contribution, scaled partial, adjoint and
//   scale factor).  Each [64 x 64] x [64 x 64] product stages its operands
//   in shared memory; 256 threads each hold a 4 x 4 tile of the result in
//   registers and accumulate with FMA in the working type (no tensor
//   cores, no TF32).
// * A state-code tip's contribution is the gather c[j, h] = P[j, state[h]],
//   not a product.
// * Scaling: the forward max-rescales only the nodes flagged F_SCALE (every
//   4th internal level and the root, as the Pallas kernel); the adjoint
//   rescales every internal node in its recompute, because sparse scaling
//   there lost the gradient on the TPU (0.98 relative error).
// * Cross-tile sums.  The Pallas adjoint summed dP and dpi across pattern
//   tiles in revisited output blocks, which relies on the TPU grid running
//   in order.  Here block (g, c) walks tiles g, g + G, ... and adds into its
//   own slab (dP [G, nnode, C, N, N], dpi [G, C, N]); a second kernel sums
//   the slabs.  Slabs rather than atomics: no read-modify-write race, and a
//   sum order fixed from run to run, so fits are reproducible.
// * Guards of the JAX package: F floored at the type's smallest normal,
//   msafe = m > 0 ? m : 1, the adjoint clipped at +-1e12 with NaN -> 0, and
//   nan_to_num (inf -> +-1e30) on dP and dpi.
//
// What bounds it on the H100 (f64, bench shape: 32 taxa, 4096 patterns,
// 3 classes; computed from the shapes).  The forward does 3.0 GFLOP with
// a workspace of a few slots per block (~18 MB in all) that stays in L2.
// The adjoint does 12.3 GFLOP and moves ~3.3 GB through a workspace that
// does not fit L2, plus 0.4 GB of dP slabs.  Both run at ~15 % of the FP64
// FMA peak; the inner product loop issues 8 shared-memory loads per 16
// FMA and a block synchronises several times per node, which is where a
// faster version starts: tensor-core products (f64 mma.sync, or wgmma in
// f32), operands resident in shared memory, fewer synchronisations, and
// an adjoint workspace sized to L2.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int N = 64;        // padded states
constexpr int HT = 64;       // patterns per tile
constexpr int LD = HT + 1;   // shared row stride (N == HT, one stride)
constexpr int NT = 256;      // threads per block
constexpr int F_TIP = 1, F_ROOT = 2, F_SCALE = 4;

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

struct Step {
  int v, flags, slot, K;
  const int* kid;     // child node ids [K]
  const int* kslot;   // child slots [K]
};

__device__ __forceinline__ Step load_step(const int* sched, int width,
                                          int kmax, int i) {
  const int* r = sched + (size_t)i * width;
  Step s;
  s.v = r[0];
  s.flags = r[1];
  s.slot = r[2];
  s.K = r[3];
  s.kid = r + 4;
  s.kslot = r + 4 + kmax;
  return s;
}

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

// tip partial [N, H] (multi-hot data), masked past H
template <typename T>
__device__ __forceinline__ void load_tip_part(T* Ss, const T* tv, int h0,
                                              int H) {
  for (int e = threadIdx.x; e < N * HT; e += NT) {
    const int j = e / HT, h = e % HT, hg = h0 + h;
    Ss[j * LD + h] = hg < H ? tv[(size_t)j * H + hg] : T(0);
  }
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

// Ss[j][h] = prod_k cbuf_k[j][h] over the children of the step
template <typename T>
__device__ __forceinline__ void child_product(T* Ss, const T* base,
                                              const int* idx, int K,
                                              size_t stride) {
  for (int e = threadIdx.x; e < N * HT; e += NT) {
    T prod = base[(size_t)idx[0] * stride + e];
    for (int k = 1; k < K; ++k) prod *= base[(size_t)idx[k] * stride + e];
    Ss[(e / HT) * LD + e % HT] = prod;
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

template <typename T>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const int* __restrict__ sched, int nsteps, int width, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ part, const T* __restrict__ pi,
    T* __restrict__ lnf, T* __restrict__ work, int C, int H, int nslots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);
  T* Ss = Ps + N * LD;
  T* logm = Ss + N * LD;
  T* msc = logm + HT;
  const int tile = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int h0 = tile * HT;
  const size_t NH = (size_t)N * HT;
  T* wb = work + (size_t)(tile * C + c) * nslots * NH;
  if (tid < HT) logm[tid] = T(0);
  for (int i = 0; i < nsteps; ++i) {
    const Step st = load_step(sched, width, kmax, i);
    const T* Pv = P + ((size_t)st.v * C + c) * N * N;
    if (st.flags & F_TIP) {
      if (states != nullptr) {
        tip_gather(wb + st.slot * NH, Pv, states + (size_t)st.v * H, h0, H);
        __syncthreads();
        continue;
      }
      load_tip_part(Ss, part + (size_t)st.v * N * H, h0, H);
    } else {
      child_product(Ss, wb, st.kslot, st.K, NH);
      __syncthreads();
      if (st.flags & F_SCALE) {
        if (tid < HT) {
          const T ms = column_msafe(Ss, tid);
          msc[tid] = ms;
          logm[tid] += Num<T>::lg(ms);
        }
        __syncthreads();
        for (int e = tid; e < N * HT; e += NT)
          Ss[(e / HT) * LD + e % HT] /= msc[e % HT];
      }
      if (st.flags & F_ROOT) {
        __syncthreads();
        if (tid < HT && h0 + tid < H) {
          const T F = root_F(Ss, pi + (size_t)c * N, tid);
          lnf[(size_t)c * H + h0 + tid] = Num<T>::lg(F) + logm[tid];
        }
        return;
      }
    }
    load_P(Ps, Pv);
    __syncthreads();
    T acc[4][4];
    mm64<T, false, false>(Ps, Ss, acc);
    store64(wb + st.slot * NH, HT, acc, false);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) bwd_kernel(
    const int* __restrict__ sched, int nsteps, int width, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ part, const T* __restrict__ pi,
    const T* __restrict__ gbar, T* __restrict__ dP_slab,
    T* __restrict__ dpi_slab, T* __restrict__ work, int C, int H, int ns,
    int nnode, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);
  T* Ss = Ps + N * LD;
  T* Gs = Ss + N * LD;
  T* red = Gs + N * LD;
  const int g = blockIdx.x, c = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x;
  const int nint = nnode - ns;
  const size_t NH = (size_t)N * HT;
  T* cbuf = work + (size_t)(g * C + c) * ((nnode + 2 * nint) * NH + nint * HT);
  T* sbuf = cbuf + nnode * NH;
  T* abuf = sbuf + nint * NH;
  T* mbuf = abuf + nint * NH;
  T* dps = dP_slab + (size_t)g * nnode * C * N * N;
  T* dpis = dpi_slab + (size_t)(g * C + c) * N;
  const T* pic = pi + (size_t)c * N;
  const T cap = T(1e12);
  int root = -1;
  for (int tile = g; tile < ntiles; tile += G) {
    const bool add = tile != g;
    const int h0 = tile * HT;
    // upward recompute, every internal node rescaled
    for (int i = 0; i < nsteps; ++i) {
      const Step st = load_step(sched, width, kmax, i);
      const T* Pv = P + ((size_t)st.v * C + c) * N * N;
      if (st.flags & F_TIP) {
        if (states != nullptr) {
          tip_gather(cbuf + st.v * NH, Pv, states + (size_t)st.v * H, h0, H);
          __syncthreads();
          continue;
        }
        load_tip_part(Ss, part + (size_t)st.v * N * H, h0, H);
      } else {
        child_product(Ss, cbuf, st.kid, st.K, NH);
        __syncthreads();
        T* mv = mbuf + (size_t)(st.v - ns) * HT;
        if (tid < HT) mv[tid] = column_msafe(Ss, tid);
        __syncthreads();
        T* sv = sbuf + (st.v - ns) * NH;
        for (int e = tid; e < N * HT; e += NT) {
          const int j = e / HT, h = e % HT;
          const T x = Ss[j * LD + h] / mv[h];
          Ss[j * LD + h] = x;
          sv[e] = x;
        }
        if (st.flags & F_ROOT) {
          root = st.v;
          __syncthreads();
          break;
        }
      }
      load_P(Ps, Pv);
      __syncthreads();
      T acc[4][4];
      mm64<T, false, false>(Ps, Ss, acc);
      store64(cbuf + st.v * NH, HT, acc, false);
      __syncthreads();
    }
    // root: Ss holds s_root; gF = gbar / F, A_root = gF pi, dpi += gF s_root
    if (tid < HT) {
      const int hg = h0 + tid;
      red[tid] = hg < H ? gbar[(size_t)c * H + hg] / root_F(Ss, pic, tid)
                        : T(0);
    }
    __syncthreads();
    T* Ar = abuf + (root - ns) * NH;
    for (int e = tid; e < N * HT; e += NT) Ar[e] = red[e % HT] * pic[e / HT];
    if (tid < N) {
      T s = T(0);
      for (int h = 0; h < HT; ++h) s += red[h] * Ss[tid * LD + h];
      dpis[tid] = add ? dpis[tid] + s : s;
    }
    __syncthreads();
    // downward adjoint sweep
    for (int i = nsteps - 1; i >= 0; --i) {
      const Step st = load_step(sched, width, kmax, i);
      if (st.flags & F_TIP) continue;
      const T* Av = abuf + (st.v - ns) * NH;
      const T* mv = mbuf + (size_t)(st.v - ns) * HT;
      for (int kk = 0; kk < st.K; ++kk) {
        const int k = st.kid[kk];
        // G_k = A_v / m_v * prod of the siblings' contributions
        for (int e = tid; e < N * HT; e += NT) {
          const int j = e / HT, h = e % HT;
          T loo = T(1);
          for (int k2 = 0; k2 < st.K; ++k2)
            if (k2 != kk) loo *= cbuf[(size_t)st.kid[k2] * NH + e];
          T Gv = Av[e] / mv[h] * loo;
          Gv = Gv != Gv ? T(0) : (Gv > cap ? cap : (Gv < -cap ? -cap : Gv));
          Gs[j * LD + h] = Gv;
        }
        // s_k: tip one-hot / multi-hot, or the stored scaled partial
        if (k >= ns) {
          const T* sk = sbuf + (k - ns) * NH;
          for (int e = tid; e < N * HT; e += NT)
            Ss[(e / HT) * LD + e % HT] = sk[e];
        } else if (states != nullptr) {
          const int* sv = states + (size_t)k * H;
          for (int e = tid; e < N * HT; e += NT) {
            const int j = e / HT, h = e % HT, hg = h0 + h;
            Ss[j * LD + h] = (hg < H && sv[hg] == j) ? T(1) : T(0);
          }
        } else {
          load_tip_part(Ss, part + (size_t)k * N * H, h0, H);
        }
        if (k >= ns) load_P(Ps, P + ((size_t)k * C + c) * N * N);
        __syncthreads();
        // dP_k[j][i] += sum_h G_k[j][h] s_k[i][h]
        T acc[4][4];
        mm64<T, false, true>(Gs, Ss, acc);
        store64(dps + ((size_t)k * C + c) * N * N, N, acc, add);
        if (k >= ns) {
          // A_k[i][h] = sum_j P_k[j][i] G_k[j][h]
          mm64<T, true, false>(Ps, Gs, acc);
          store64(abuf + (k - ns) * NH, HT, acc, false);
        }
        __syncthreads();
      }
    }
  }
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
int launch_fwd(const int* sched, int nsteps, int width, int kmax, const T* P,
               const int* states, const T* part, const T* pi, T* lnf,
               T* work, int ntiles, int C, int H, int nslots,
               cudaStream_t stream) {
  const int smem = (int)((2 * N * LD + 2 * HT) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<T><<<dim3(ntiles, C), NT, smem, stream>>>(
      sched, nsteps, width, kmax, P, states, part, pi, lnf, work, C, H,
      nslots);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const int* sched, int nsteps, int width, int kmax, const T* P,
               const int* states, const T* part, const T* pi, const T* gbar,
               T* dP_slab, T* dpi_slab, T* work, T* dP, T* dpi, int G,
               int ntiles, int C, int H, int ns, int nnode, int n, int root,
               cudaStream_t stream) {
  const int smem = (int)((3 * N * LD + HT) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T><<<dim3(G, C), NT, smem, stream>>>(
      sched, nsteps, width, kmax, P, states, part, pi, gbar, dP_slab,
      dpi_slab, work, C, H, ns, nnode, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nnode * C * n * n + (size_t)C * n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  reduce_kernel<T><<<blocks, 256, 0, stream>>>(dP_slab, dpi_slab, dP, dpi,
                                               G, nnode, C, n, root);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAML_PRUNING_ENTRIES(T, SUFFIX)                                       \
  extern "C" int paml_pruning_fwd_##SUFFIX(                                   \
      const int* sched, int nsteps, int width, int kmax, const T* P,          \
      const int* states, const T* part, const T* pi, T* lnf, T* work,         \
      int ntiles, int C, int H, int nslots, void* stream) {                   \
    return launch_fwd<T>(sched, nsteps, width, kmax, P, states, part, pi,     \
                         lnf, work, ntiles, C, H, nslots,                     \
                         static_cast<cudaStream_t>(stream));                  \
  }                                                                           \
  extern "C" int paml_pruning_bwd_##SUFFIX(                                   \
      const int* sched, int nsteps, int width, int kmax, const T* P,          \
      const int* states, const T* part, const T* pi, const T* gbar,           \
      T* dP_slab, T* dpi_slab, T* work, T* dP, T* dpi, int G, int ntiles,     \
      int C, int H, int ns, int nnode, int n, int root, void* stream) {       \
    return launch_bwd<T>(sched, nsteps, width, kmax, P, states, part, pi,     \
                         gbar, dP_slab, dpi_slab, work, dP, dpi, G, ntiles,   \
                         C, H, ns, nnode, n, root,                            \
                         static_cast<cudaStream_t>(stream));                  \
  }

PAML_PRUNING_ENTRIES(float, f32)
PAML_PRUNING_ENTRIES(double, f64)
