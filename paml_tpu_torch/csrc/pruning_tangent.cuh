// The tangents of the tree walk on Hopper (H1, H2): what the walk's forward
// (B1/B3) and adjoint (B2/B4) give along a batch of D directions (Pd, pid)
// of (P, pi), so that a Hessian of the likelihood runs on the card.
// Templated on the dtype, on the tip encoding (AMB: B1/B2's coded tips with
// an ambiguity table, else B3/B4's state codes) and on the padded state
// count N; instantiated by pruning.cu (AMB = true) and pruning_big.cu
// (AMB = false) in float64 at N = 32 and 64.
//
// They replace no TPU kernel: the JAX package takes its Hessians by
// jax.hessian, forward over reverse through the custom_vjp of its pruning
// pass (paml_tpu/core/pruning.py:195-283), which differentiates the forward
// and the analytic adjoint `_lnf_lvl_bwd` (:215) along each direction.
// These two kernels compute those two tangents.
//
// Notation (per class c and pattern h; k a child of v, K children):
//   c_k = P_k U_k, U_k = s_k (internal child) or the tip's columns
//   (one-hot of its state, or its row of the ambiguity table);
//   p_v = prod_k c_k, m_v its column max (a constant: lnf does not depend on
//   it), s_v = p_v / m_v, F = pi . s_root, lnf = log F + sum_v log m_v.
// H1 (tan_fwd), per direction d:
//   cd_k = Pd_k U_k + P_k Ud_k (Ud_k = sd_k for an internal child, 0 for a
//   tip), sd_v = (sum_k cd_k prod_{k' != k} c_k') / m_v,
//   lnfd = (pid . s_root + pi . sd_root) / F   (0 where F is floored),
//   and the residual Sd [D, nrows, C, n, H] of every sd_v.
// H2 (tan_bwd), per direction d, the tangent of the adjoint
// (gbar, P, pi) -> (dP, dpi) along (gd, Pd, pid), from the root down:
//   gF = gbar / F, gFd = gd / F - gbar Fd / F^2,
//   A_root = gF pi, Ad_root = gFd pi + gF pid, dpid = sum_h gFd s + gF sd;
//   G_k = clip(A_v loo_k / m_v), Gd_k = (Ad_v loo_k + A_v lood_k) / m_v
//   (0 where the clip or the NaN guard is active: their derivative);
//   dPd_k = Gd_k U_k^T + G_k Ud_k^T, A_k = P_k^T G_k,
//   Ad_k = Pd_k^T G_k + P_k^T Gd_k.
// The gbar tangent gd enters H2 at the root, so one launch carries both
// halves of the Hessian-vector product: the adjoint's own second
// derivative and its response to the cotangent's change.
//
// Design (a first version: right before fast)
// * Both walk cuda_pruning.BigPlan's bsched of a plan with no cherries
//   (`full_plan`): every internal node, the root included, has a row in
//   the forward's residual S, and H1 writes Sd in the same rows; H1 takes
//   the rows last to first (DFS postorder), H2 first to last.
// * Grids: H1 one block per (tile of BHT patterns, class, direction), H2
//   one per (tile range g, class, direction), so the directions of a
//   Hessian row block are a grid axis.
// * Every product goes through pruning_common.cuh's prod_acc, on the FP64
//   tensor cores: P_k and Pd_k are read from global memory (L1 / L2), the
//   tile's operands (U, Ud, c, cd, G, Gd, A, Ad) sit in shared memory.  A
//   tip's columns are a one-hot (or table) operand, so a tip is a product
//   here where B1-B4 gather; fewer products are work for a later version.
// * H2's adjoint slots A, Ad per block follow B4's (nslots + 1 of them, one
//   tile a visit); its dPd slabs [G, D, nnode, C, N, N] are zeroed by the
//   wrapper and summed by tan_reduce_kernel: no atomics, each element owned
//   by one thread, so a Hessian repeats bit for bit.
#pragma once

#include "pruning_tree.cuh"

namespace {

// dst [N][LDH] <- rows of src [n][H] at the tile's patterns (zero past n
// and H); thread (w, lane) holds rows RW w + q of pattern lane
template <typename T, int N>
__device__ __forceinline__ void tile_rows(T* dst, const T* src, int n, int H,
                                          int h0) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, hg = h0 + lane;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int j = RW * w + q;
    dst[j * LDH + lane] =
        (j < n && hg < H) ? src[(size_t)j * H + hg] : T(0);
  }
}

// dst [N][LDH] <- a tip's columns U at the tile's patterns: the one-hot of a
// state code, with AMB the table row amb[code - n] of a code >= n; zero past
// H
template <typename T, bool AMB, int N>
__device__ __forceinline__ void tile_tip(T* dst, const int* codes, int H,
                                         int h0, int n, const T* amb) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, hg = h0 + lane;
  const int code = hg < H ? codes[hg] : -1;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int j = RW * w + q;
    T u = T(code == j);
    if constexpr (AMB) {
      if (code >= n) u = amb[(size_t)(code - n) * N + j];
    }
    dst[j * LDH + lane] = u;
  }
}

// dst [N][LDH] <- an adjoint slot [N][BHT]
template <typename T, int N>
__device__ __forceinline__ void tile_slot(T* dst, const T* src) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int j = RW * w + q;
    dst[j * LDH + lane] = src[j * BHT + lane];
  }
}

// acc (EH values) += M V with M [N][N] in global memory (row-major), or
// M^T V (TRANS); V [N][LDH] in shared memory
template <typename T, int N, bool TRANS>
__device__ __forceinline__ void add_mv(const T* M, const T* V, T* acc) {
  if constexpr (TRANS)
    prod_acc<T, N, Pad<N>::QH, N>(M, 1, N, V, LDH, 1, acc);
  else
    prod_acc<T, N, Pad<N>::QH, N>(M, N, 1, V, LDH, 1, acc);
}

// a [N x BHT] accumulator (EH values) into dst with row stride ld
template <typename T, int N>
__device__ __forceinline__ void store_h(T* dst, int ld, const T* acc) {
#pragma unroll
  for (int e = 0; e < Pad<N>::EH; ++e) {
    int row, col;
    acc_rc<N, Pad<N>::QH>(e, row, col);
    dst[row * ld + col] = acc[e];
  }
}

// each child's c_k = P_k U_k into cb[k] and cd_k = Pd_k U_k + P_k Ud_k into
// cdb[k] ([KMAX][N][LDH] each; Ud_k for internal children only)
template <typename T, int N>
__device__ __forceinline__ void child_products(
    const int* r, int K, int stride, int ns, const T* P, const T* Pdd, int c,
    int C, const T* Ub, const T* Udb, T* cb, T* cdb) {
  constexpr int EH = Pad<N>::EH;
  const size_t PN = (size_t)N * N;
  for (int k = 0; k < K; ++k) {
    const int kid = r[3 + stride * k];
    const T* Pk = P + ((size_t)kid * C + c) * PN;
    const T* Pdk = Pdd + ((size_t)kid * C + c) * PN;
    T a[EH], ad[EH];
#pragma unroll
    for (int e = 0; e < EH; ++e) a[e] = ad[e] = T(0);
    add_mv<T, N, false>(Pk, Ub + k * N * LDH, a);
    add_mv<T, N, false>(Pdk, Ub + k * N * LDH, ad);
    if (kid >= ns) add_mv<T, N, false>(Pk, Udb + k * N * LDH, ad);
    store_h<T, N>(cb + k * N * LDH, LDH, a);
    store_h<T, N>(cdb + k * N * LDH, LDH, ad);
  }
}

// child k's U_k (and Ud_k for an internal child) at the tile: the tip's
// columns, or its residual rows of S and of Sd (direction d's)
template <typename T, bool AMB, int N>
__device__ __forceinline__ void child_operands(
    const int* r, int K, int stride, int ns, const int* codes,
    const T* amb, const T* S, const T* Sdd, int c, int C, int n, int H,
    int h0, T* Ub, T* Udb) {
  for (int k = 0; k < K; ++k) {
    const int* kr = r + 3 + stride * k;
    if (kr[0] < ns) {
      tile_tip<T, AMB, N>(Ub + k * N * LDH, codes + (size_t)kr[0] * H, H, h0,
                          n, amb);
    } else {
      tile_rows<T, N>(Ub + k * N * LDH, S + ((size_t)kr[1] * C + c) * n * H,
                      n, H, h0);
      tile_rows<T, N>(Udb + k * N * LDH,
                      Sdd + ((size_t)kr[1] * C + c) * n * H, n, H, h0);
    }
  }
}

__device__ __forceinline__ int children(const int* r, int kmax, int stride) {
  int K = 0;
  while (K < kmax && r[3 + stride * K] >= 0) ++K;
  return K;
}

// H1.  Block (tile, c, d); bs rows [nint][3 + (3 + kmax) kmax] of the full
// plan; P [nnode, C, N, N], Pd [D, nnode, C, N, N], pi [C, N], pid [D, C,
// N]; S [nrows, C, n, H] (the forward's); out Sd [D, nrows, C, n, H] and
// lnfd [D, C, H].  Sd is written and read back in the walk: no __restrict__
template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT) tan_fwd_kernel(
    const int* __restrict__ bs, int nint, int kmax, const T* __restrict__ P,
    const T* __restrict__ Pd, const int* __restrict__ codes,
    const T* __restrict__ amb, const T* __restrict__ pi,
    const T* __restrict__ pid, const T* __restrict__ S, T* Sd,
    T* __restrict__ lnfd, int C, int H, int ns, int n, int nnode,
    int nrows) {
  constexpr int RW = Pad<N>::RW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ub = reinterpret_cast<T*>(smem_raw);   // [KMAX][N][LDH]: U_k
  T* Udb = Ub + KMAX * N * LDH;              // Ud_k
  T* cb = Udb + KMAX * N * LDH;              // c_k
  T* cdb = cb + KMAX * N * LDH;              // cd_k
  T* red = cdb + KMAX * N * LDH;             // [RED]: col_reduce
  const int tile = blockIdx.x, c = blockIdx.y, d = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = tile * BHT, hg = h0 + lane;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const T* Pdd = Pd + (size_t)d * nnode * C * N * N;
  T* Sdd = Sd + (size_t)d * nrows * C * n * H;
  const T* pic = pi + (size_t)c * N;
  const T* pidc = pid + ((size_t)d * C + c) * N;
  int half = 0;
  for (int i = nint - 1; i >= 0; --i) {
    const int* r = bs + (size_t)i * width;
    const int K = children(r, kmax, stride);
    __syncthreads();   // the previous node's operands are read
    child_operands<T, AMB, N>(r, K, stride, ns, codes, amb, S, Sdd, c, C, n,
                              H, h0, Ub, Udb);
    __syncthreads();
    child_products<T, N>(r, K, stride, ns, P, Pdd, c, C, Ub, Udb, cb, cdb);
    __syncthreads();
    T p[RW], pd[RW], m = T(0);
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int e = (RW * w + q) * LDH + lane;
      const T y0 = cb[e], yd0 = cdb[e];
      if (K > 1) {
        const T y1 = cb[N * LDH + e], yd1 = cdb[N * LDH + e];
        p[q] = y0 * y1;
        pd[q] = yd0 * y1 + y0 * yd1;
      } else {
        p[q] = y0;
        pd[q] = yd0;
      }
      m = (q == 0 || p[q] > m) ? p[q] : m;
    }
    m = col_reduce<T, true>(m, red, half);
    const T rms = T(1) / (m > T(0) ? m : T(1));
    T* sdv = Sdd + ((size_t)r[2] * C + c) * n * H;
    T F = T(0), Fd = T(0);
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int j = RW * w + q;
      const T s = p[q] * rms, sd = pd[q] * rms;
      if (j < n && hg < H) sdv[(size_t)j * H + hg] = sd;
      F += pic[j] * s;
      Fd += pidc[j] * s + pic[j] * sd;
    }
    if (i == 0) {   // the root: lnf's tangent
      F = col_reduce<T, false>(F, red, half);
      Fd = col_reduce<T, false>(Fd, red, half);
      if (w == 0 && hg < H)
        lnfd[((size_t)d * C + c) * H + hg] =
            F > Num<T>::tiny() ? Fd / F : T(0);
    }
  }
}

// H2.  Block (g, c, d) takes tiles [g ntiles / G, (g + 1) ntiles / G), one
// walk a tile.  gbar [C, H], gd [D, C, H]; S, Sd as H1's; dP_slab [G, D,
// nnode, C, N, N] (zeroed), dpi_slab [G, D, C, N]; work [D, G, C, 2,
// nslots + 1, N, BHT] the adjoint slots (A, then Ad).  The slabs and slots
// are read and written in the walk: no __restrict__
template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT) tan_bwd_kernel(
    const int* __restrict__ bs, int nint, int kmax, const T* __restrict__ P,
    const T* __restrict__ Pd, const int* __restrict__ codes,
    const T* __restrict__ amb, const T* __restrict__ pi,
    const T* __restrict__ pid, const T* __restrict__ gbar,
    const T* __restrict__ gd, const T* __restrict__ S,
    const T* __restrict__ Sd, T* dP_slab, T* __restrict__ dpi_slab, T* work,
    int C, int H, int ns, int n, int nnode, int vclip, int nslots, int nrows,
    int ntiles) {
  constexpr int RW = Pad<N>::RW, EH = Pad<N>::EH, EN = Pad<N>::EN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ab = reinterpret_cast<T*>(smem_raw);   // [N][LDH]: A_v
  T* Adb = Ab + N * LDH;                     // Ad_v
  T* Ub = Adb + N * LDH;                     // [KMAX][N][LDH]: U_k
  T* Udb = Ub + KMAX * N * LDH;              // Ud_k
  T* cb = Udb + KMAX * N * LDH;              // c_k, then G_k
  T* cdb = cb + KMAX * N * LDH;              // cd_k, then Gd_k
  T* red = cdb + KMAX * N * LDH;             // [RED]: col_reduce
  T* dpa = red + RED;                        // [N]: the block's dpid
  const int g = blockIdx.x, c = blockIdx.y, d = blockIdx.z;
  const int G = gridDim.x, D = gridDim.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const size_t NH = (size_t)N * BHT, PN = (size_t)N * N;
  T* abuf = work + (((size_t)d * G + g) * C + c) * 2 * (nslots + 1) * NH;
  T* adbuf = abuf + (nslots + 1) * NH;
  T* dps = dP_slab + ((size_t)g * D + d) * nnode * C * PN;
  const T* Pdd = Pd + (size_t)d * nnode * C * PN;
  const T* Sdd = Sd + (size_t)d * nrows * C * n * H;
  const T* pic = pi + (size_t)c * N;
  const T* pidc = pid + ((size_t)d * C + c) * N;
  const int lo = (int)((long long)g * ntiles / G);
  const int hi = (int)((long long)(g + 1) * ntiles / G);
  int half = 0;
  if (tid < N) dpa[tid] = T(0);
  for (int t = lo; t < hi; ++t) {
    const int h0 = t * BHT, hg = h0 + lane;
    {
      // the root (bsched row 0): A_root, Ad_root into its slot, dpid
      const T* Sr = S + ((size_t)bs[2] * C + c) * n * H;
      const T* Sdr = Sdd + ((size_t)bs[2] * C + c) * n * H;
      T x[RW], xd[RW], F = T(0), Fd = T(0);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int j = RW * w + q;
        const bool ok = j < n && hg < H;
        x[q] = ok ? Sr[(size_t)j * H + hg] : T(0);
        xd[q] = ok ? Sdr[(size_t)j * H + hg] : T(0);
        F += pic[j] * x[q];
        Fd += pidc[j] * x[q] + pic[j] * xd[q];
      }
      F = col_reduce<T, false>(F, red, half);
      Fd = col_reduce<T, false>(Fd, red, half);
      if (!(F > Num<T>::tiny())) {   // the floor: derivative 0
        F = Num<T>::tiny();
        Fd = T(0);
      }
      const T gb = hg < H ? gbar[(size_t)c * H + hg] : T(0);
      const T gdd = hg < H ? gd[((size_t)d * C + c) * H + hg] : T(0);
      // gFd = gd / F - gbar Fd / F^2 without F^2, which underflows at the
      // floor (the columns past H)
      const T gf = gb / F, gfd = (gdd - gf * Fd) / F;
      T* Ar = abuf + (size_t)bs[1] * NH;
      T* Adr = adbuf + (size_t)bs[1] * NH;
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int j = RW * w + q;
        Ar[j * BHT + lane] = gf * pic[j];
        Adr[j * BHT + lane] = gfd * pic[j] + gf * pidc[j];
        T s = gfd * x[q] + gf * xd[q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) dpa[j] += s;
      }
    }
    for (int i = 0; i < nint; ++i) {
      const int* r = bs + (size_t)i * width;
      const int K = children(r, kmax, stride);
      __syncthreads();   // the parent's slots are written, the buffers read
      tile_slot<T, N>(Ab, abuf + (size_t)r[1] * NH);
      tile_slot<T, N>(Adb, adbuf + (size_t)r[1] * NH);
      child_operands<T, AMB, N>(r, K, stride, ns, codes, amb, S, Sdd, c, C,
                                n, H, h0, Ub, Udb);
      __syncthreads();
      child_products<T, N>(r, K, stride, ns, P, Pdd, c, C, Ub, Udb, cb, cdb);
      __syncthreads();
      // the scale factor, then G_k and Gd_k over c_k and cd_k (each thread
      // reads and writes its own elements)
      T y[KMAX][RW], yd[KMAX][RW], m = T(0);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int e = (RW * w + q) * LDH + lane;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          y[k][q] = k < K ? cb[k * N * LDH + e] : T(1);
          yd[k][q] = k < K ? cdb[k * N * LDH + e] : T(0);
        }
        const T p = y[0][q] * (K > 1 ? y[1][q] : T(1));
        m = (q == 0 || p > m) ? p : m;
      }
      m = col_reduce<T, true>(m, red, half);
      const T rms = T(1) / (m > T(0) ? m : T(1));
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int e = (RW * w + q) * LDH + lane;
        const T a = Ab[e] * rms, ad = Adb[e] * rms;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K) continue;
          const T loo = K > 1 ? y[1 - k][q] : T(1);
          const T lood = K > 1 ? yd[1 - k][q] : T(0);
          const bool own = r[3 + stride * k] < vclip;
          const T gr = a * loo;
          const bool pass = isfinite(gr) && (!own || fabs(gr) <= T(1e12));
          cb[k * N * LDH + e] = clip_adjoint(gr, own);
          cdb[k * N * LDH + e] = pass ? ad * loo + a * lood : T(0);
        }
      }
      __syncthreads();
      for (int k = 0; k < K; ++k) {
        const int* kr = r + 3 + stride * k;
        const int kid = kr[0];
        // dPd_k += Gd_k U_k^T + G_k Ud_k^T, into the block's slab
        T acc[EN];
#pragma unroll
        for (int e = 0; e < EN; ++e) acc[e] = T(0);
        prod_gst<T, N>(cdb + k * N * LDH, Ub + k * N * LDH, acc);
        if (kid >= ns) prod_gst<T, N>(cb + k * N * LDH, Udb + k * N * LDH, acc);
        T* dk = dps + ((size_t)kid * C + c) * PN;
#pragma unroll
        for (int e = 0; e < EN; ++e) {
          int row, col;
          acc_rc<N, Pad<N>::QN>(e, row, col);
          dk[row * N + col] += acc[e];
        }
        if (kid < ns) continue;
        // A_k = P_k^T G_k and Ad_k = Pd_k^T G_k + P_k^T Gd_k into k's slots
        const T* Pk = P + ((size_t)kid * C + c) * PN;
        const T* Pdk = Pdd + ((size_t)kid * C + c) * PN;
        T a[EH], ad[EH];
#pragma unroll
        for (int e = 0; e < EH; ++e) a[e] = ad[e] = T(0);
        add_mv<T, N, true>(Pk, cb + k * N * LDH, a);
        add_mv<T, N, true>(Pdk, cb + k * N * LDH, ad);
        add_mv<T, N, true>(Pk, cdb + k * N * LDH, ad);
        store_h<T, N>(abuf + (size_t)kr[2] * NH, BHT, a);
        store_h<T, N>(adbuf + (size_t)kr[2] * NH, BHT, ad);
      }
    }
  }
  __syncthreads();
  if (tid < N) dpi_slab[(((size_t)g * D + d) * C + c) * N + tid] = dpa[tid];
}

// dPd [D, nout, C, n, n] = sum over g of dP_slab [G, D, nnode, C, N, N]
// (rows < nout: the caller's own nodes), dpid [D, C, n] likewise from
// dpi_slab [G, D, C, N]; each sum in g order, then nan_to_num
template <typename T, int N>
__global__ void tan_reduce_kernel(const T* __restrict__ dP_slab,
                                  const T* __restrict__ dpi_slab,
                                  T* __restrict__ dP, T* __restrict__ dpi,
                                  int G, int D, int nnode, int nout, int C,
                                  int n) {
  const size_t nP = (size_t)D * nout * C * n * n;
  const size_t total = nP + (size_t)D * C * n;
  const size_t slab = (size_t)D * nnode * C * N * N;
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
      r /= C;
      const int k = r % nout;
      const int dd = (int)(r / nout);
      const size_t off =
          ((((size_t)dd * nnode + k) * C + c) * N + i) * N + j;
      for (int g = 0; g < G; ++g) s += dP_slab[g * slab + off];
      dP[idx] = guard(s);
    } else {
      const size_t r = idx - nP;
      const int j = r % n;
      const size_t dc = r / n;
      for (int g = 0; g < G; ++g)
        s += dpi_slab[((size_t)g * D * C + dc) * N + j];
      dpi[r] = guard(s);
    }
  }
}

// shared memory of a block: H1 four [KMAX][N][LDH] operands and the
// column-reduction scratch; H2 two more tiles (A_v, Ad_v) and dpid [N]
template <typename T, int N>
constexpr int tan_fwd_smem() {
  return (int)((4 * KMAX * N * LDH + RED) * sizeof(T));
}
template <typename T, int N>
constexpr int tan_bwd_smem() {
  return (int)(((2 + 4 * KMAX) * N * LDH + RED + N) * sizeof(T));
}

template <typename T, bool AMB, int N>
int launch_tan_fwd(const int* bs, int nint, int kmax, const T* P,
                   const T* Pd, const int* codes, const T* amb, const T* pi,
                   const T* pid, const T* S, T* Sd, T* lnfd, int D,
                   int ntiles, int C, int H, int ns, int n, int nnode,
                   int nrows, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  const int smem = tan_fwd_smem<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      tan_fwd_kernel<T, AMB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  tan_fwd_kernel<T, AMB, N><<<dim3(ntiles, C, D), NT, smem, stream>>>(
      bs, nint, kmax, P, Pd, codes, amb, pi, pid, S, Sd, lnfd, C, H, ns, n,
      nnode, nrows);
  return (int)cudaGetLastError();
}

template <typename T, bool AMB, int N>
int launch_tan_bwd(const int* bs, int nint, int kmax, const T* P,
                   const T* Pd, const int* codes, const T* amb, const T* pi,
                   const T* pid, const T* gbar, const T* gd, const T* S,
                   const T* Sd, T* dP_slab, T* dpi_slab, T* work, T* dPd,
                   T* dpid, int D, int G, int ntiles, int C, int H, int ns,
                   int n, int nnode, int nout, int vclip, int nslots,
                   int nrows, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  const int smem = tan_bwd_smem<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      tan_bwd_kernel<T, AMB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  tan_bwd_kernel<T, AMB, N><<<dim3(G, C, D), NT, smem, stream>>>(
      bs, nint, kmax, P, Pd, codes, amb, pi, pid, gbar, gd, S, Sd, dP_slab,
      dpi_slab, work, C, H, ns, n, nnode, vclip, nslots, nrows, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)D * nout * C * n * n + (size_t)D * C * n;
  const int blocks =
      (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  tan_reduce_kernel<T, N><<<blocks, 256, 0, stream>>>(
      dP_slab, dpi_slab, dPd, dpid, G, D, nnode, nout, C, n);
  return (int)cudaGetLastError();
}

}  // namespace

// the entries of one instance: `paml_<pre>tan_fwd_f64_n<N>` and
// `paml_<pre>tan_bwd_f64_n<N>` (pre `pruning_` for B1/B2's coded tips,
// `big_` for B3/B4's state codes; amb is null there)
#define PAML_TANGENT_ENTRIES(PRE, AMB, T, SUFFIX, NPAD)                      \
  extern "C" int paml_##PRE##tan_fwd_##SUFFIX##_n##NPAD(                     \
      const int* bs, int nint, int kmax, const T* P, const T* Pd,            \
      const int* codes, const T* amb, const T* pi, const T* pid,             \
      const T* S, T* Sd, T* lnfd, int D, int ntiles, int C, int H, int ns,   \
      int n, int nnode, int nrows, void* stream) {                           \
    return launch_tan_fwd<T, AMB, NPAD>(                                     \
        bs, nint, kmax, P, Pd, codes, amb, pi, pid, S, Sd, lnfd, D, ntiles,  \
        C, H, ns, n, nnode, nrows, static_cast<cudaStream_t>(stream));       \
  }                                                                          \
  extern "C" int paml_##PRE##tan_bwd_##SUFFIX##_n##NPAD(                     \
      const int* bs, int nint, int kmax, const T* P, const T* Pd,            \
      const int* codes, const T* amb, const T* pi, const T* pid,             \
      const T* gbar, const T* gd, const T* S, const T* Sd, T* dP_slab,       \
      T* dpi_slab, T* work, T* dPd, T* dpid, int D, int G, int ntiles,       \
      int C, int H, int ns, int n, int nnode, int nout, int vclip,           \
      int nslots, int nrows, void* stream) {                                 \
    return launch_tan_bwd<T, AMB, NPAD>(                                     \
        bs, nint, kmax, P, Pd, codes, amb, pi, pid, gbar, gd, S, Sd,         \
        dP_slab, dpi_slab, work, dPd, dpid, D, G, ntiles, C, H, ns, n,       \
        nnode, nout, vclip, nslots, nrows,                                   \
        static_cast<cudaStream_t>(stream));                                  \
  }
