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
// What bounds them on the H100, and the design.  The bound is the FP64
// tensor cores (cuda_pruning.tan_work: per direction two products per
// internal node in H1, six in H2, and c, A once).  A first version (one
// block per tile, class and direction) reached 6-9 % of it: every block
// recomputed the direction-independent c_k, m_v, G_k and A_k, took a tip as
// a one-hot product, read P_k and Pd_k from L1 / L2 in every product with
// one 8-warp block an SM, and H2 added its dPd into a slab in device memory
// once per tile and edge (about 25 GB at the bench shape) on a grid that
// left a second, lone wave.  Here:
// * Directions inside the block.  A block takes one class, a range of
//   tiles and a group of directions (all D unless tiles x classes cannot
//   fill a wave: `cuda_pruning.tan_grid`).  Per node it stages each
//   internal child's P_k in shared memory by cp.async, once for every tile
//   and direction, and per tile computes the direction-independent part
//   once: c_k (one product), m_v and, in H2, a = A_v / m_v, G_k and A_k =
//   P_k^T G_k.  It then loops over its directions: H1's two products per
//   internal child (cd = Pd s + P sd), H2's six (cd, dPd = Gd s^T + G
//   sd^T, Ad = Pd^T G + P^T Gd), every operand in shared memory: Pd_k
//   and sd_k are staged by cp.async, one internal child at a time (H1 runs
//   them as a queue of jobs, the next step's copies issued as soon as the
//   last job has read the buffers; H2 keeps Pd_k for all the tiles of a
//   direction when the node has one internal child, as on the bench's
//   ladder, and copies again where it has two).
// * Tips gathered, not multiplied: c_k[j, h] = P_k[j, state[h]], cd_k[j,
//   h] = Pd_k[j, state[h]], the latter by cp.async into the tip's free
//   tile (H1: one of two, a step ahead), in flight with the products; with
//   AMB an ambiguous cell gathers
//   from B1's table TA = P amb^T and its tangent TAd = Pd amb^T
//   (tip_table_kernel over the directions, once per launch).  H2 adds a
//   tip's Gd_k into dPd_k[j, state[h]] by B4's ordered, warp-owned scatter
//   in shared memory; an ambiguous cell is B2's rank-one update of
//   registers.
// * H2 walks the tree once per visit of up to TV tiles: per node, a first
//   pass over the visit's tiles does the direction-independent part and
//   keeps a, c_k and 1 / m_v in the block's workspace (device memory);
//   then per direction a pass over the tiles sums each child's dPd over the
//   visit, in registers for an internal child and in shared memory for a
//   tip, and stores it once into the block's slab.  tan_reduce_kernel sums
//   the slabs in a fixed order: no atomics, so a Hessian repeats bit for
//   bit.  dpid goes the same way (each element owned by one thread).
// * What is left is latency: each (node, tile, direction) step waits on
//   the copies of the next operands (Sd and the adjoint slots stream from
//   device memory) and on barriers, with one 8-warp block an SM.  The
//   elementwise phases load everything before their first store (stores
//   through pointers the compiler cannot tell apart would otherwise hold
//   each load behind the one before), and the streaming stores (Sd, the
//   slabs) are marked evict-first to keep P, Pd and the workspace in L2.
//   `tools/torch_ab_tangent.py --probe` times each section (`TP(s)`,
//   compiled in with -DPAML_TPROBE).
// * Grids in whole waves: one block per (tile range, class, direction
//   group), at most as many as the SMs hold at the blocks per SM the design
//   counts on (TanOcc), chosen from the card's SM count and size alone, so
//   the slabs' sum order, and so the bits, repeat.  At N = 64 a block's
//   shared memory (P_k of both children, one Pd_k and the tiles: 214 KB)
//   leaves one block an SM; at N = 32 two fit.
#pragma once

#include "pruning_tree.cuh"

#ifdef PAML_TPROBE
// cycles by section of the tangent kernels, thread 0 of every block: TP(s)
// adds the cycles since the block's last mark to section s.  The sections
// are listed here and nowhere else: paml_tprobe_read gives their cycles
// (and resets them), paml_tprobe_names their labels, in this order
// (tools/torch_ab_tangent.py --probe builds a library of its own with
// -DPAML_TPROBE)
#define PAML_TP_SECTIONS(X)                                                 \
  X(H1_NODE, "H1 node start") X(H1_TILE_WAIT, "H1 tile wait")               \
  X(H1_C_PRODUCTS, "H1 c products") X(H1_C_M, "H1 c, m")                    \
  X(H1_JOB_WAIT, "H1 job wait") X(H1_JOB_PRODUCT, "H1 job product")         \
  X(H1_NEXT_COPIES, "H1 barrier, next copies, store")                       \
  X(H1_CD_STORED, "H1 barrier (cd stored)")                                 \
  X(H1_ELEMENTWISE, "H1 elementwise") X(H2_ROOT, "H2 root")                 \
  X(H2_NODE, "H2 node start") X(H2_I_WAIT, "H2 I wait")                     \
  X(H2_I_C_PRODUCTS, "H2 I c products")                                     \
  X(H2_I_C_M, "H2 I c, m, workspace") X(H2_I_G_A, "H2 I G, A")              \
  X(H2_II_DIRECTION, "H2 II direction start")                               \
  X(H2_II_TILE_WAIT, "H2 II tile wait")                                     \
  X(H2_A_PRODUCTS, "H2 A cd products") X(H2_A_BARRIER, "H2 A barrier")      \
  X(H2_B_ELEMENTWISE, "H2 B elementwise")                                   \
  X(H2_C_STAGE_G, "H2 C stage, G") X(H2_C_PRODUCTS, "H2 C products")        \
  X(H2_C_COPIES, "H2 C barrier, copies")                                    \
  X(H2_TIP_SCATTER, "H2 tip scatter") X(H2_SLAB_STORE, "H2 slab store")
#define PAML_TP_ENUM(s, label) TP_##s,
#define PAML_TP_LABEL(s, label) label "\n"
enum { PAML_TP_SECTIONS(PAML_TP_ENUM) TP_COUNT };
static __device__ unsigned long long g_tprobe[TP_COUNT];
#define TP_INIT long long tp_ = clock64();
#define TP(s)                                                      \
  if (threadIdx.x == 0) {                                          \
    const long long t_ = clock64();                                \
    atomicAdd(&g_tprobe[TP_##s], (unsigned long long)(t_ - tp_));  \
    tp_ = t_;                                                      \
  }
extern "C" const char* paml_tprobe_names() {
  return PAML_TP_SECTIONS(PAML_TP_LABEL);
}
extern "C" int paml_tprobe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_tprobe, sizeof(g_tprobe));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[TP_COUNT] = {};
  return (int)cudaMemcpyToSymbol(g_tprobe, z, sizeof(g_tprobe));
}
#else
#define TP_INIT
#define TP(s)
#endif

namespace {

// shared memory of an H1 or H2 block: each child's P_k and one child's
// Pd_k [N][LDN]; each child's s_k and X_k, one child's sd_k and one more
// tile (H1 a tip's second buffer, H2 G_k) [N][LDH]; the column-reduction
// scratch (cuda_pruning.tan_smem)
template <typename T, int N>
constexpr int tan_smem() {
  return (int)(((KMAX + 1) * N * Pad<N>::LDN + (2 * KMAX + 2) * N * LDH +
                RED) * sizeof(T));
}

// blocks per SM the design counts on (launch bounds and grids): as many
// as the SM's shared memory holds, 1 KB a block kept by the card
// (cuda_pruning.tan_blocks_per_sm)
constexpr int SMEM_SM = 233472;
template <int N>
struct TanOcc {
  static constexpr int BLOCKS = SMEM_SM / (tan_smem<double, N>() + 1024);
};

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

__device__ __forceinline__ int children(const int* r, int kmax, int stride) {
  int K = 0;
  while (K < kmax && r[3 + stride * K] >= 0) ++K;
  return K;
}

// row j of a tip's columns at the code st: P_k[j, st], or with AMB and st
// >= n row j of the table TA (its column st - n); P [nnode, C, N, N], TA
// [ns, C, N, LA]
template <typename T, bool AMB, int N>
__device__ __forceinline__ const T* tip_ptr(const T* P, const T* TA,
                                            int kid, int c, int C, int st,
                                            int n, int LA, int j) {
  if constexpr (AMB) {
    if (st >= n)
      return TA + (((size_t)kid * C + c) * N + j) * LA + (st - n);
  }
  return P + (((size_t)kid * C + c) * N + j) * N + st;
}
template <typename T, bool AMB, int N>
__device__ __forceinline__ T tip_value(const T* P, const T* TA, int kid,
                                       int c, int C, int st, int n, int LA,
                                       int j) {
  return *tip_ptr<T, AMB, N>(P, TA, kid, c, C, st, n, LA, j);
}

// a tip's columns at this lane's code st into this thread's elements of
// dst [N][LDH] (rows RW w + q of pattern lane) by asynchronous copies; the
// caller commits and waits
template <typename T, bool AMB, int N>
__device__ __forceinline__ void tip_rows_async(T* dst, const T* P,
                                               const T* TA, int kid, int c,
                                               int C, int st, int n,
                                               int LA) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int j = RW * w + q;
    cp_async_val(dst + j * LDH + lane,
                 tip_ptr<T, AMB, N>(P, TA, kid, c, C, st, n, LA, j), true);
  }
}

// this thread's elements of a [N][BHT] slot into dst [N][LDH] by
// asynchronous copies (rows RW w + q of pattern lane; the caller commits)
template <typename T, int N>
__device__ __forceinline__ void slot_rows_async(T* dst, const T* src) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int j = RW * w + q;
    cp_async_val(dst + j * LDH + lane, src + j * BHT + lane, true);
  }
}

// the tips' state codes at this lane's pattern hg (0 past H; -1 for an
// internal child or past K)
__device__ __forceinline__ void tip_codes(int st[KMAX], const int* r, int K,
                                          int stride, int ns,
                                          const int* codes, int H, int hg) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int kid = k < K ? r[3 + stride * k] : -1;
    st[k] = (kid >= 0 && kid < ns) ? (hg < H ? codes[(size_t)kid * H + hg] : 0)
                                   : -1;
  }
}

// H1.  Block (g, c, z): tiles [g ntiles / G, (g + 1) ntiles / G), class c,
// directions [z D / Z, (z + 1) D / Z).  bs rows [nint][3 + (3 + kmax) kmax]
// of the full plan, taken last to first (DFS postorder); P [nnode, C, N,
// N], Pd [D, nnode, C, N, N], pi [C, N], pid [D, C, N]; TA [1 + D][ns, C,
// N, LA] (AMB: P amb^T, then Pd amb^T per direction); S [nrows, C, n, H]
// (the forward's); out Sd [D, nrows, C, n, H] and lnfd [D, C, H].  Per
// node the steps u = (tile, direction) run in order; the products of a
// step's internal children are jobs, each staging Pd_k and sd_k.  The
// copies of step u + 1 (its first job, its tips' gathered columns into
// the other of their two buffers, a new tile's s_k) go out as one group as
// soon as step u's last job has read its buffers.  Sd is written and read
// back in the walk: no __restrict__
template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT, TanOcc<N>::BLOCKS) tan_fwd_kernel(
    const int* __restrict__ bs, int nint, int kmax, const T* __restrict__ P,
    const T* __restrict__ Pd, const int* __restrict__ codes,
    const T* __restrict__ TA, int LA, const T* __restrict__ pi,
    const T* __restrict__ pid, const T* __restrict__ S, T* Sd,
    T* __restrict__ lnfd, int D, int C, int H, int ns, int n, int nnode,
    int nrows, int ntiles) {
  constexpr int LDN = Pad<N>::LDN, RW = Pad<N>::RW, EH = Pad<N>::EH;
  constexpr int QH = Pad<N>::QH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Pb = reinterpret_cast<T*>(smem_raw);   // [KMAX][N][LDN]: P_k
  T* Qb = Pb + KMAX * N * LDN;               // [N][LDN]: the job's Pd_k
  T* Sb = Qb + N * LDN;                      // [KMAX][N][LDH]: s_k
  T* Xb = Sb + KMAX * N * LDH;               // [KMAX][N][LDH]: c_k, cd_k
  T* Yb = Xb + KMAX * N * LDH;               // [N][LDH]: the job's sd_k
  T* Zb = Yb + N * LDH;                      // [N][LDH]: a tip's 2nd buffer
  T* red = Zb + N * LDH;                     // [RED]: col_reduce
  const int g = blockIdx.x, c = blockIdx.y, G = gridDim.x;
  const int d0 = (int)((long long)blockIdx.z * D / gridDim.z);
  const int d1 = (int)((long long)(blockIdx.z + 1) * D / gridDim.z);
  const int nd = d1 - d0;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const size_t PN = (size_t)N * N, SdD = (size_t)nrows * C * n * H;
  const size_t TAD = (size_t)ns * C * N * LA;
  const T* pic = pi + (size_t)c * N;
  const int lo = (int)((long long)g * ntiles / G);
  const int hi = (int)((long long)(g + 1) * ntiles / G);
  const int nu = (hi - lo) * nd;   // the steps of a node
  int half = 0;
  TP_INIT
  for (int i = nint - 1; i >= 0; --i) {
    const int* r = bs + (size_t)i * width;
    const int K = children(r, kmax, stride);
    int kin[KMAX], nin = 0;   // the internal children
    for (int k = 0; k < K; ++k)
      if (r[3 + stride * k] >= ns) kin[nin++] = k;
    // a tip child k's gathered columns at step u: X_k, or its second
    // buffer at odd u (Zb; with two tips the second's is Yb, which no job
    // uses then)
    auto tip_buf = [&](int k, int u) {
      return (u & 1) == 0 ? Xb + k * N * LDH
                          : (nin == 0 && k == 1 ? Yb : Zb);
    };
    // the copies of step u (not committed): its first job (Pd_k into Qb,
    // sd_k into Yb), its tips' columns at the codes st of its tile, and at
    // a new tile its s_k
    auto step_copies = [&](int u, const int* st) {
      const int t = lo + u / nd, d = d0 + u % nd;
      if (u % nd == 0)
        for (int j = 0; j < nin; ++j) {
          const int k = kin[j];
          copy_S<T, N>(Sb + k * N * LDH, S, r[3 + stride * k + 1], c, C, n,
                       H, t * BHT);
        }
      if (nin > 0) {
        const int* kr = r + 3 + stride * kin[0];
        copy_P<T, N>(Qb, Pd + (((size_t)d * nnode + kr[0]) * C + c) * PN);
        copy_S<T, N>(Yb, Sd + d * SdD, kr[1], c, C, n, H, t * BHT);
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K && st[k] >= 0)
          tip_rows_async<T, AMB, N>(tip_buf(k, u),
                                    Pd + (size_t)d * nnode * C * PN,
                                    TA + (1 + d) * TAD, r[3 + stride * k], c,
                                    C, st[k], n, LA);
    };
    __syncthreads();   // the previous node's buffers are read
    for (int j = 0; j < nin; ++j) {
      const int kid = r[3 + stride * kin[j]];
      copy_P<T, N>(Pb + kin[j] * N * LDN, P + ((size_t)kid * C + c) * PN);
    }
    // the tips' codes at the tile at hand and at the next one
    int st[KMAX], stn[KMAX];
    tip_codes(stn, r, K, stride, ns, codes, H, lo * BHT + lane);
    if (nu > 0) step_copies(0, stn);
    cp_async_commit();
    TP(H1_NODE)
    for (int t = lo; t < hi; ++t) {
      const int h0 = t * BHT, hg = h0 + lane;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) st[k] = stn[k];
      if (t + 1 < hi)
        tip_codes(stn, r, K, stride, ns, codes, H, h0 + BHT + lane);
      cp_async_wait();   // P_k, s_k, the tile's first step
      __syncthreads();
      TP(H1_TILE_WAIT)
      // the direction-independent part: c_k (a product, or the tip's
      // gather), the node's scale factor
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K || st[k] >= 0) continue;
        T a[EH];
        prod_ps<T, N>(Pb + k * N * LDN, Sb + k * N * LDH, a);
        store_h<T, N>(Xb + k * N * LDH, LDH, a);
      }
      __syncthreads();
      TP(H1_C_PRODUCTS)
      T cv[KMAX][RW], m = T(0);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int j = RW * w + q;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int kid = k < K ? r[3 + stride * k] : -1;
          cv[k][q] = k >= K ? T(1)
                     : st[k] >= 0
                         ? tip_value<T, AMB, N>(P, TA, kid, c, C, st[k], n,
                                                LA, j)
                         : Xb[k * N * LDH + j * LDH + lane];
        }
        const T p = cv[0][q] * cv[1][q];
        m = (q == 0 || p > m) ? p : m;
      }
      m = col_reduce<T, true>(m, red, half);   // (its barrier: c_k read)
      const T rms = T(1) / (m > T(0) ? m : T(1));
      T F = T(0);
      if (i == 0) {   // the root: F, for lnf's tangent
#pragma unroll
        for (int q = 0; q < RW; ++q)
          F += pic[RW * w + q] * (cv[0][q] * cv[1][q] * rms);
        F = col_reduce<T, false>(F, red, half);
      }
      TP(H1_C_M)
      // the directions
      for (int d = d0; d < d1; ++d) {
        const int u = (t - lo) * nd + (d - d0);
        // cd_k = Pd_k s_k + P_k sd_k of each internal child, one job each
        for (int j = 0; j < nin; ++j) {
          const int k = kin[j];
          if (d != d0 || j != 0) {
            cp_async_wait();   // the job's Pd_k, sd_k (and the step's tips)
            __syncthreads();
          }
          TP(H1_JOB_WAIT)
          T a[EH];
#pragma unroll
          for (int e = 0; e < EH; ++e) a[e] = T(0);
          prod_acc<T, N, QH, N>(Qb, LDN, 1, Sb + k * N * LDH, LDH, 1, a);
          prod_acc<T, N, QH, N>(Pb + k * N * LDN, LDN, 1, Yb, LDH, 1, a);
          TP(H1_JOB_PRODUCT)
          __syncthreads();   // Qb, Yb are read (and the last X_k)
          if (j + 1 < nin) {   // the next job: the second internal child
            const int* kr = r + 3 + stride * kin[j + 1];
            copy_P<T, N>(Qb, Pd + (((size_t)d * nnode + kr[0]) * C + c) *
                                      PN);
            copy_S<T, N>(Yb, Sd + d * SdD, kr[1], c, C, n, H, h0);
            cp_async_commit();
          } else if (u + 1 < nu) {
            step_copies(u + 1, d + 1 < d1 ? st : stn);
            cp_async_commit();
          }
          store_h<T, N>(Xb + k * N * LDH, LDH, a);
          TP(H1_NEXT_COPIES)
        }
        if (nin == 0) {
          cp_async_wait();   // the step's tips (each thread its own)
          if (u + 1 < nu) {
            step_copies(u + 1, d + 1 < d1 ? st : stn);
            cp_async_commit();
          }
        }
        __syncthreads();   // cd_k stored
        TP(H1_CD_STORED)
        T* sdv = Sd + d * SdD + ((size_t)r[2] * C + c) * n * H;
        const T* pidc = pid + ((size_t)d * C + c) * N;
        T cd[KMAX][RW];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const T* src = k >= K ? nullptr
                         : st[k] >= 0 ? tip_buf(k, u) : Xb + k * N * LDH;
#pragma unroll
          for (int q = 0; q < RW; ++q)
            cd[k][q] = k < K ? src[(RW * w + q) * LDH + lane] : T(0);
        }
        T Fd = T(0);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int j = RW * w + q;
          const T pd = K > 1 ? cd[0][q] * cv[1][q] + cv[0][q] * cd[1][q]
                             : cd[0][q];
          const T sd = pd * rms;
          // (evict-first: Sd streams past L2, which keeps P and Pd)
          if (j < n && hg < H) __stcs(sdv + (size_t)j * H + hg, sd);
          if (i == 0)
            Fd += pidc[j] * (cv[0][q] * cv[1][q] * rms) + pic[j] * sd;
        }
        if (i == 0) {   // the root: lnf's tangent
          Fd = col_reduce<T, false>(Fd, red, half);
          if (w == 0 && hg < H)
            lnfd[((size_t)d * C + c) * H + hg] =
                F > Num<T>::tiny() ? Fd / F : T(0);
        }
        TP(H1_ELEMENTWISE)
      }
    }
  }
}

// H2.  Block (g, c, z) as H1's; it walks its tiles in visits of up to TV.
// gbar [C, H], gd [D, C, H]; S, Sd as H1's; amb [A, N] and TA as H1's;
// dP_slab [G, D, nnode, C, N, N] (every non-root row of the block's
// directions written), dpi_slab [G, D, C, N]; work per block (g, c, z):
// the adjoint slots A [nslots + 1][TV][N][BHT], Ad of its directions
// [Dz][nslots + 1][TV][N][BHT], then the direction-independent part of
// the node at hand, [TV][3][N][BHT] (a = A_v / m_v, c_0, c_1) and 1 / m_v
// [TV][BHT].  Pd_k and sd_k of one internal child at a time sit in shared
// memory (Qb, SDb): Pd_k stays for every tile of a direction when the
// node has one internal child (the ladders of the bench), a node with two
// copies them again as it goes.  The slabs and the workspace are read and
// written in the walk: no __restrict__
template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT, TanOcc<N>::BLOCKS) tan_bwd_kernel(
    const int* __restrict__ bs, int nint, int kmax, const T* __restrict__ P,
    const T* __restrict__ Pd, const int* __restrict__ codes,
    const T* __restrict__ amb, const T* __restrict__ TA, int LA,
    const T* __restrict__ pi, const T* __restrict__ pid,
    const T* __restrict__ gbar, const T* __restrict__ gd,
    const T* __restrict__ S, const T* __restrict__ Sd, T* dP_slab,
    T* dpi_slab, T* work, int D, int C, int H, int ns, int n, int nnode,
    int vclip, int nslots, int nrows, int ntiles, int TV) {
  constexpr int LDN = Pad<N>::LDN, TLD = Pad<N>::TLD, RW = Pad<N>::RW;
  constexpr int EH = Pad<N>::EH, EN = Pad<N>::EN;
  constexpr int QH = Pad<N>::QH, QN = Pad<N>::QN;
  // SG = 256 / N warps share each 32 rows of a tip's dPd_k; SGS = log2 SG
  constexpr int SG = 256 / N, SGS = N == 64 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [KMAX][N][LDN]: P_k, or a tip's dPd_k ([N][TLD] in the same room)
  T* Pb = reinterpret_cast<T*>(smem_raw);
  T* Qb = Pb + KMAX * N * LDN;               // [N][LDN]: Pd_k of one child
  T* Sb = Qb + N * LDN;                      // [KMAX][N][LDH]: s_k
  T* Xb = Sb + KMAX * N * LDH;               // [KMAX][N][LDH]: c_k; cd_k, Gd_k
  T* SDb = Xb + KMAX * N * LDH;              // [N][LDH]: sd_k of one child
  T* Gb = SDb + N * LDH;                     // [N][LDH]: G_k of one child
  T* red = Gb + N * LDH;                     // [RED]: col_reduce
  const int g = blockIdx.x, c = blockIdx.y, G = gridDim.x;
  const int d0 = (int)((long long)blockIdx.z * D / gridDim.z);
  const int d1 = (int)((long long)(blockIdx.z + 1) * D / gridDim.z);
  const int Dz = (D + gridDim.z - 1) / gridDim.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const size_t NH = (size_t)N * BHT, PN = (size_t)N * N;
  const size_t SdD = (size_t)nrows * C * n * H;
  const size_t TAD = (size_t)ns * C * N * LA;
  const size_t slots = (size_t)(nslots + 1) * TV * NH;   // one direction's
  T* abuf = work + (((size_t)blockIdx.z * G + g) * C + c) *
                       ((1 + Dz) * slots + (size_t)TV * (3 * N + 1) * BHT);
  T* adbuf = abuf + slots;                   // direction d at (d - d0) slots
  T* wbuf = adbuf + Dz * slots;              // [TV][3][N][BHT]
  T* rbuf = wbuf + (size_t)TV * 3 * NH;      // [TV][BHT]
  T* dps = dP_slab + (size_t)g * D * nnode * C * PN;
  const T* pic = pi + (size_t)c * N;
  const int lo = (int)((long long)g * ntiles / G);
  const int hi = (int)((long long)(g + 1) * ntiles / G);
  int half = 0;
  TP_INIT
  for (int t0 = lo; t0 < hi; t0 += TV) {
    const int nt = min(TV, hi - t0);
    const bool add = t0 != lo;
    // the root (bsched row 0): A_root, Ad_root into their slots, dpid into
    // the block's dpi slab
    for (int t = 0; t < nt; ++t) {
      const int hg = (t0 + t) * BHT + lane;
      const T* Sr = S + ((size_t)bs[2] * C + c) * n * H;
      T x[RW], F = T(0);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int j = RW * w + q;
        x[q] = (j < n && hg < H) ? Sr[(size_t)j * H + hg] : T(0);
        F += pic[j] * x[q];
      }
      F = col_reduce<T, false>(F, red, half);
      const bool floored = !(F > Num<T>::tiny());   // derivative 0 there
      if (floored) F = Num<T>::tiny();
      const T gf = (hg < H ? gbar[(size_t)c * H + hg] : T(0)) / F;
      T* Ar = abuf + ((size_t)bs[1] * TV + t) * NH;
#pragma unroll
      for (int q = 0; q < RW; ++q)
        Ar[(RW * w + q) * BHT + lane] = gf * pic[RW * w + q];
      for (int d = d0; d < d1; ++d) {
        const T* Sdr = Sd + d * SdD + ((size_t)bs[2] * C + c) * n * H;
        const T* pidc = pid + ((size_t)d * C + c) * N;
        T xd[RW], Fd = T(0);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int j = RW * w + q;
          xd[q] = (j < n && hg < H) ? Sdr[(size_t)j * H + hg] : T(0);
          Fd += pidc[j] * x[q] + pic[j] * xd[q];
        }
        Fd = col_reduce<T, false>(Fd, red, half);
        if (floored) Fd = T(0);
        const T gdd = hg < H ? gd[((size_t)d * C + c) * H + hg] : T(0);
        // gFd = gd / F - gbar Fd / F^2 without F^2, which underflows at
        // the floor (the columns past H)
        const T gfd = (gdd - gf * Fd) / F;
        T* Adr = adbuf + (size_t)(d - d0) * slots +
                 ((size_t)bs[1] * TV + t) * NH;
        T* dpo = dpi_slab + (((size_t)g * D + d) * C + c) * N;
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int j = RW * w + q;
          Adr[j * BHT + lane] = gfd * pic[j] + gf * pidc[j];
          T s = gfd * x[q] + gf * xd[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) dpo[j] = (add || t > 0) ? dpo[j] + s : s;
        }
      }
    }
    TP(H2_ROOT)
    for (int i = 0; i < nint; ++i) {
      const int* r = bs + (size_t)i * width;
      const int K = children(r, kmax, stride);
      int kin[KMAX], nin = 0;   // the internal children
      for (int k = 0; k < K; ++k)
        if (r[3 + stride * k] >= ns) kin[nin++] = k;
      // which child's Pd_k (direction qd) and sd_k (direction, tile) sit in
      // Qb and SDb
      int qk = -1, qd = -1, sk = -1, sdt = -1;
      auto stage_q = [&](int k, int d) {
        if (qk == k && qd == d) return;
        load_Pn_async<T, N>(Qb, Pd + (((size_t)d * nnode +
                                       r[3 + stride * k]) * C + c) * PN);
        qk = k;
        qd = d;
      };
      auto stage_sd = [&](int k, int d, int t) {
        if (sk == k && sdt == d * TV + t) return;
        load_S_async<T, N>(SDb, Sd + d * SdD, r[3 + stride * k + 1], c, C,
                           n, H, (t0 + t) * BHT);
        sk = k;
        sdt = d * TV + t;
      };
      auto stage = [&](int k, int d, int t, bool wait) {
        if (qk == k && qd == d && sk == k && sdt == d * TV + t) return;
        if (wait) __syncthreads();   // Qb, SDb are read
        stage_q(k, d);
        stage_sd(k, d, t);
        if (wait) {
          cp_async_wait();
          __syncthreads();
        }
      };
      auto tile_s = [&](int t) {
        for (int j = 0; j < nin; ++j) {
          const int k = kin[j];
          load_S_async<T, N>(Sb + k * N * LDH, S, r[3 + stride * k + 1], c,
                             C, n, H, (t0 + t) * BHT);
        }
      };
      __syncthreads();   // the previous node's P_k and tip sums are read
      for (int j = 0; j < nin; ++j) {
        const int kid = r[3 + stride * kin[j]];
        load_Pn_async<T, N>(Pb + kin[j] * N * LDN,
                            P + ((size_t)kid * C + c) * PN);
      }
      tile_s(0);
      TP(H2_NODE)
      // 1) the direction-independent part, tile by tile: c_k, 1 / m_v, a =
      //    A_v / m_v and c_k into the workspace, G_k, A_k = P_k^T G_k
      for (int t = 0; t < nt; ++t) {
        const int h0 = (t0 + t) * BHT, hg = h0 + lane;
        int st[KMAX];
        tip_codes(st, r, K, stride, ns, codes, H, hg);
        const T* Av = abuf + ((size_t)r[1] * TV + t) * NH;
        T av[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) av[q] = Av[(RW * w + q) * BHT + lane];
        cp_async_wait();   // P_k, s_k
        __syncthreads();
        TP(H2_I_WAIT)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K || st[k] >= 0) continue;
          T a8[EH];
          prod_ps<T, N>(Pb + k * N * LDN, Sb + k * N * LDH, a8);
          store_h<T, N>(Xb + k * N * LDH, LDH, a8);
        }
        __syncthreads();   // c_k stored, s_k read
        // the next tile's s_k (phase 2's first, past the last tile)
        tile_s(t + 1 < nt ? t + 1 : 0);
        TP(H2_I_C_PRODUCTS)
        T cv[KMAX][RW], m = T(0);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int j = RW * w + q;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            const int kid = k < K ? r[3 + stride * k] : -1;
            cv[k][q] = k >= K ? T(1)
                       : st[k] >= 0
                           ? tip_value<T, AMB, N>(P, TA, kid, c, C, st[k], n,
                                                  LA, j)
                           : Xb[k * N * LDH + j * LDH + lane];
          }
          const T p = cv[0][q] * cv[1][q];
          m = (q == 0 || p > m) ? p : m;
        }
        m = col_reduce<T, true>(m, red, half);
        const T rms = T(1) / (m > T(0) ? m : T(1));
        T* wt = wbuf + (size_t)t * 3 * NH;
        if (w == 0) rbuf[(size_t)t * BHT + lane] = rms;
        T a[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int j = RW * w + q;
          a[q] = av[q] * rms;
          wt[j * BHT + lane] = a[q];
          wt[NH + j * BHT + lane] = cv[0][q];
          wt[2 * NH + j * BHT + lane] = cv[1][q];
        }
        TP(H2_I_C_M)
        for (int jj = 0; jj < nin; ++jj) {
          const int k = kin[jj];
          const int* kr = r + 3 + stride * k;
          const bool own = kr[0] < vclip;
          if (jj > 0) __syncthreads();   // Gb is read
#pragma unroll
          for (int q = 0; q < RW; ++q)
            Gb[(RW * w + q) * LDH + lane] =
                clip_adjoint(a[q] * (k == 0 ? cv[1][q] : cv[0][q]), own);
          __syncthreads();
          T a8[EH];
          prod_pts<T, N>(Pb + k * N * LDN, Gb, a8);
          store_h<T, N>(abuf + ((size_t)kr[2] * TV + t) * NH, BHT, a8);
        }
        TP(H2_I_G_A)
      }
      // 2) direction by direction, the visit's tiles: cd_k, Gd_k, dPd_k
      //    summed over the visit, Ad_k
      if (nin > 0) stage(kin[0], d0, 0, false);
      for (int d = d0; d < d1; ++d) {
        const T* Pdd = Pd + (size_t)d * nnode * C * PN;
        const T* TAd = TA + (1 + d) * TAD;
        T* adb = adbuf + (size_t)(d - d0) * slots;
        __syncthreads();   // the last direction's tip sums are stored
        for (int k = 0; k < K; ++k) {
          if (r[3 + stride * k] >= ns) continue;
          T* kk = Pb + k * N * LDN;
          for (int e = tid; e < N * TLD; e += NT) kk[e] = T(0);
        }
        T acc[KMAX][EN];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
          for (int e = 0; e < EN; ++e) acc[k][e] = T(0);
        TP(H2_II_DIRECTION)
        for (int t = 0; t < nt; ++t) {
          const int h0 = (t0 + t) * BHT, hg = h0 + lane;
          const int hn = min(BHT, H - h0);
          int st[KMAX];
          tip_codes(st, r, K, stride, ns, codes, H, hg);
          cp_async_wait();   // s_k, the first child's Pd_k and sd_k
          __syncthreads();
          // in flight with the products: a tip's cd_k[j, h] = Pd_k[j,
          // state[h]] into its X_k, Ad_v into Gb (free until step C)
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K && st[k] >= 0)
              tip_rows_async<T, AMB, N>(Xb + k * N * LDH, Pdd, TAd,
                                        r[3 + stride * k], c, C, st[k], n,
                                        LA);
          slot_rows_async<T, N>(Gb, adb + ((size_t)r[1] * TV + t) * NH);
          cp_async_commit();
          // step B's direction-independent inputs, in flight with the
          // products too
          const T* wt = wbuf + (size_t)t * 3 * NH;
          const T rms = rbuf[(size_t)t * BHT + lane];
          T a[RW], y[KMAX][RW];
#pragma unroll
          for (int q = 0; q < RW; ++q) {
            const int j = RW * w + q;
            a[q] = wt[j * BHT + lane];
            y[0][q] = wt[NH + j * BHT + lane];
            y[1][q] = wt[2 * NH + j * BHT + lane];
          }
          TP(H2_II_TILE_WAIT)
          // cd_k = Pd_k s_k + P_k sd_k of each internal child into X_k
          for (int jj = 0; jj < nin; ++jj) {
            const int k = kin[jj];
            stage(k, d, t, true);
            T a8[EH];
#pragma unroll
            for (int e = 0; e < EH; ++e) a8[e] = T(0);
            prod_acc<T, N, QH, N>(Qb, LDN, 1, Sb + k * N * LDH, LDH, 1, a8);
            prod_acc<T, N, QH, N>(Pb + k * N * LDN, LDN, 1, SDb, LDH, 1, a8);
            store_h<T, N>(Xb + k * N * LDH, LDH, a8);
          }
          TP(H2_A_PRODUCTS)
          cp_async_wait();   // the tips' gathers, Ad_v
          __syncthreads();
          TP(H2_A_BARRIER)
          // Gd_k (each thread its own elements: cd_k read before Gd_k
          // overwrites it)
          {
            // every load before the first store (the stores to X_k would
            // otherwise hold each load behind the one before)
            T ad[RW], yd[KMAX][RW];
#pragma unroll
            for (int q = 0; q < RW; ++q) {
              const int e = (RW * w + q) * LDH + lane;
              ad[q] = Gb[e];
#pragma unroll
              for (int k = 0; k < KMAX; ++k)
                yd[k][q] = k < K ? Xb[k * N * LDH + e] : T(0);
            }
#pragma unroll
            for (int q = 0; q < RW; ++q) {
              const int e = (RW * w + q) * LDH + lane;
#pragma unroll
              for (int k = 0; k < KMAX; ++k) {
                if (k >= K) continue;
                const T loo = K > 1 ? y[1 - k][q] : T(1);
                const T lood = K > 1 ? yd[1 - k][q] : T(0);
                const bool own = r[3 + stride * k] < vclip;
                const T gr = a[q] * loo;
                const bool pass =
                    isfinite(gr) && (!own || fabs(gr) <= T(1e12));
                Xb[k * N * LDH + e] =
                    pass ? (ad[q] * rms) * loo + a[q] * lood : T(0);
              }
            }
          }
          TP(H2_B_ELEMENTWISE)
          // dPd_k += Gd_k s_k^T + G_k sd_k^T and Ad_k = Pd_k^T G_k + P_k^T
          // Gd_k of each internal child, the one whose Pd_k and sd_k are
          // staged first; G_k again from a and c
          // (the next tile, or the next direction's first, in these
          // copies: with one internal child s_k and sd_k go out as soon as
          // the gst products have read them)
          const int tn = t + 1 < nt ? t + 1 : 0;
          const int dn = t + 1 < nt ? d : d + 1;
          for (int jj = nin - 1; jj >= 0; --jj) {
            const int k = kin[jj];
            const int* kr = r + 3 + stride * k;
            const bool own = kr[0] < vclip;
            stage(k, d, t, true);
            __syncthreads();   // Gd_k stored; Gb is read
#pragma unroll
            for (int q = 0; q < RW; ++q)
              Gb[(RW * w + q) * LDH + lane] =
                  clip_adjoint(a[q] * y[1 - k][q], own);
            __syncthreads();
            TP(H2_C_STAGE_G)
            const T* Gdk = Xb + k * N * LDH;
#pragma unroll
            for (int kk = 0; kk < KMAX; ++kk) {
              if (kk != k) continue;
              prod_gst<T, N>(Gdk, Sb + k * N * LDH, acc[kk]);
              prod_gst<T, N>(Gb, SDb, acc[kk]);
            }
            if (nin == 1 && dn < d1) {
              __syncthreads();   // s_k, sd_k are read
              tile_s(tn);
              stage_sd(k, dn, tn);
            }
            T a8[EH];
#pragma unroll
            for (int e = 0; e < EH; ++e) a8[e] = T(0);
            prod_acc<T, N, QH, N>(Qb, 1, LDN, Gb, LDH, 1, a8);
            prod_acc<T, N, QH, N>(Pb + k * N * LDN, 1, LDN, Gdk, LDH, 1, a8);
            store_h<T, N>(adb + ((size_t)kr[2] * TV + t) * NH, BHT, a8);
            TP(H2_C_PRODUCTS)
          }
          __syncthreads();   // Sb, SDb, Qb, Gb are read; Gd_k stored
          if (nin > 0 && dn < d1) {
            if (nin > 1) tile_s(tn);
            stage(kin[0], dn, tn, false);
          }
          TP(H2_C_COPIES)
          // a tip's Gd_k scattered into its dPd_k
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (k >= K || st[k] < 0) continue;
            const T* Gdk = Xb + k * N * LDH;
            // dPd_k[j, state[h]] += Gd_k[j, h], h in order; warp w takes
            // the states = w mod SG of rows 32 (w / SG) + lane, and walks
            // only the patterns whose state it owns (with AMB only the
            // resolved cells, st < n)
            T* kk = Pb + k * N * LDN;
            const int j = 32 * (w >> SGS) + lane;
            unsigned mine;
            if constexpr (AMB)
              mine = __ballot_sync(0xffffffffu,
                                   lane < hn && st[k] < n &&
                                       (st[k] & (SG - 1)) == (w & (SG - 1)));
            else
              mine = __ballot_sync(0xffffffffu,
                                   lane < hn && (st[k] & (SG - 1)) ==
                                                    (w & (SG - 1)));
            while (mine != 0u) {
              const int h = __ffs(mine) - 1;
              mine &= mine - 1u;
              const int sv = __shfl_sync(0xffffffffu, st[k], h);
              kk[j * TLD + sv] += Gdk[j * LDH + h];
            }
            if constexpr (AMB) {
              // an ambiguous cell h: dPd_k[j, i] += Gd_k[j, h] amb[a, i], h
              // in order, into this thread's elements of the product layout
              unsigned am =
                  __ballot_sync(0xffffffffu, lane < hn && st[k] >= n);
              while (am != 0u) {
                const int h = __ffs(am) - 1;
                am &= am - 1u;
                const T* ar =
                    amb + (size_t)(__shfl_sync(0xffffffffu, st[k], h) - n) * N;
#pragma unroll
                for (int e = 0; e < EN; ++e) {
                  int row, col;
                  acc_rc<N, QN>(e, row, col);
                  acc[k][e] = Num<T>::fma(Gdk[row * LDH + h], ar[col],
                                          acc[k][e]);
                }
              }
            }
          }
          TP(H2_TIP_SCATTER)
        }
        __syncthreads();   // every scatter of the visit is done
        if constexpr (AMB) {
          // the ambiguous cells' sums join the tip's scatter, each element
          // once
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (k >= K || r[3 + stride * k] >= ns) continue;
            T* kk = Pb + k * N * LDN;
#pragma unroll
            for (int e = 0; e < EN; ++e) {
              int row, col;
              acc_rc<N, QN>(e, row, col);
              kk[row * TLD + col] += acc[k][e];
            }
          }
          __syncthreads();
        }
        // the visit's dPd_k into the block's slab, once
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K) continue;
          const int kid = r[3 + stride * k];
          T* dk = dps + (((size_t)d * nnode + kid) * C + c) * PN;
          if (kid < ns) {
            const T* kk = Pb + k * N * LDN;
            for (int e = tid; e < N * N; e += NT) {
              const T x = kk[(e / N) * TLD + e % N];
              __stcs(dk + e, add ? dk[e] + x : x);
            }
          } else {
#pragma unroll
            for (int e = 0; e < EN; ++e) {
              int row, col;
              acc_rc<N, QN>(e, row, col);
              T* p = dk + row * N + col;
              // (evict-first: the slabs stream past L2 to the reduction)
              __stcs(p, add ? *p + acc[k][e] : acc[k][e]);
            }
          }
        }
        TP(H2_SLAB_STORE)
      }
      cp_async_wait();   // (no copy is left in flight past the node)
    }
  }
}

// dPd [D, nout, C, n, n] = sum over g of dP_slab [G, D, nnode, C, N, N]
// (rows < nout: the caller's own nodes; the root's row 0, which no slab
// holds), dpid [D, C, n] likewise from dpi_slab [G, D, C, N]; each sum in g
// order, then nan_to_num
template <typename T, int N>
__global__ void tan_reduce_kernel(const T* __restrict__ dP_slab,
                                  const T* __restrict__ dpi_slab,
                                  T* __restrict__ dP, T* __restrict__ dpi,
                                  int G, int D, int nnode, int nout, int C,
                                  int n, int root) {
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
      if (k != root) {
        const size_t off =
            ((((size_t)dd * nnode + k) * C + c) * N + i) * N + j;
        for (int g = 0; g < G; ++g) s += dP_slab[g * slab + off];
      }
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

// the AMB tables: TA = P amb^T, then Pd amb^T for each of the D directions
template <typename T, bool AMB, int N>
int tan_tables(const T* P, const T* Pd, const T* amb, int A, T* TA, int LA,
               int D, int ns, int nnode, int C, cudaStream_t stream) {
  if (!AMB || A == 0) return (int)cudaSuccess;
  const size_t tstride = (size_t)ns * C * N * LA;
  int err = launch_tip_table<T, N>(P, 0, amb, TA, 0, 1, ns, C, A, LA, stream);
  if (err != (int)cudaSuccess) return err;
  return launch_tip_table<T, N>(Pd, (size_t)nnode * C * N * N, amb,
                                TA + tstride, tstride, D, ns, C, A, LA,
                                stream);
}

template <typename T, bool AMB, int N>
int launch_tan_fwd(const int* bs, int nint, int kmax, const T* P,
                   const T* Pd, const int* codes, const T* amb, int A, T* TA,
                   int LA, const T* pi, const T* pid, const T* S, T* Sd,
                   T* lnfd, int D, int G, int Z, int ntiles, int C, int H,
                   int ns, int n, int nnode, int nrows, cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  int err = tan_tables<T, AMB, N>(P, Pd, amb, A, TA, LA, D, ns, nnode, C,
                                  stream);
  if (err != (int)cudaSuccess) return err;
  const int smem = tan_smem<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      tan_fwd_kernel<T, AMB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  tan_fwd_kernel<T, AMB, N><<<dim3(G, C, Z), NT, smem, stream>>>(
      bs, nint, kmax, P, Pd, codes, TA, LA, pi, pid, S, Sd, lnfd, D, C, H,
      ns, n, nnode, nrows, ntiles);
  return (int)cudaGetLastError();
}

template <typename T, bool AMB, int N>
int launch_tan_bwd(const int* bs, int nint, int kmax, const T* P,
                   const T* Pd, const int* codes, const T* amb, int A, T* TA,
                   int LA, const T* pi, const T* pid, const T* gbar,
                   const T* gd, const T* S, const T* Sd, T* dP_slab,
                   T* dpi_slab, T* work, T* dPd, T* dpid, int D, int G, int Z,
                   int ntiles, int TV, int C, int H, int ns, int n, int nnode,
                   int nout, int vclip, int nslots, int nrows, int root,
                   cudaStream_t stream) {
  if (kmax > KMAX) return (int)cudaErrorInvalidValue;
  int err = tan_tables<T, AMB, N>(P, Pd, amb, A, TA, LA, D, ns, nnode, C,
                                  stream);
  if (err != (int)cudaSuccess) return err;
  const int smem = tan_smem<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      tan_bwd_kernel<T, AMB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  tan_bwd_kernel<T, AMB, N><<<dim3(G, C, Z), NT, smem, stream>>>(
      bs, nint, kmax, P, Pd, codes, amb, TA, LA, pi, pid, gbar, gd, S, Sd,
      dP_slab, dpi_slab, work, D, C, H, ns, n, nnode, vclip, nslots, nrows,
      ntiles, TV);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)D * nout * C * n * n + (size_t)D * C * n;
  const int blocks =
      (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  tan_reduce_kernel<T, N><<<blocks, 256, 0, stream>>>(
      dP_slab, dpi_slab, dPd, dpid, G, D, nnode, nout, C, n, root);
  return (int)cudaGetLastError();
}

}  // namespace

// the entries of one instance: `paml_<pre>tan_fwd_f64_n<N>` and
// `paml_<pre>tan_bwd_f64_n<N>` (pre `pruning_` for B1/B2's coded tips,
// `big_` for B3/B4's state codes; amb and TA are null there, A and LA 0).
// G tile ranges x C classes x Z direction groups (cuda_pruning.tan_grid)
#define PAML_TANGENT_ENTRIES(PRE, AMB, T, SUFFIX, NPAD)                      \
  extern "C" int paml_##PRE##tan_fwd_##SUFFIX##_n##NPAD(                     \
      const int* bs, int nint, int kmax, const T* P, const T* Pd,            \
      const int* codes, const T* amb, int A, T* TA, int LA, const T* pi,     \
      const T* pid, const T* S, T* Sd, T* lnfd, int D, int G, int Z,         \
      int ntiles, int C, int H, int ns, int n, int nnode, int nrows,         \
      void* stream) {                                                        \
    return launch_tan_fwd<T, AMB, NPAD>(                                     \
        bs, nint, kmax, P, Pd, codes, amb, A, TA, LA, pi, pid, S, Sd, lnfd,  \
        D, G, Z, ntiles, C, H, ns, n, nnode, nrows,                          \
        static_cast<cudaStream_t>(stream));                                  \
  }                                                                          \
  extern "C" int paml_##PRE##tan_bwd_##SUFFIX##_n##NPAD(                     \
      const int* bs, int nint, int kmax, const T* P, const T* Pd,            \
      const int* codes, const T* amb, int A, T* TA, int LA, const T* pi,     \
      const T* pid, const T* gbar, const T* gd, const T* S, const T* Sd,     \
      T* dP_slab, T* dpi_slab, T* work, T* dPd, T* dpid, int D, int G,       \
      int Z, int ntiles, int TV, int C, int H, int ns, int n, int nnode,     \
      int nout, int vclip, int nslots, int nrows, int root, void* stream) {  \
    return launch_tan_bwd<T, AMB, NPAD>(                                     \
        bs, nint, kmax, P, Pd, codes, amb, A, TA, LA, pi, pid, gbar, gd, S,  \
        Sd, dP_slab, dpi_slab, work, dPd, dpid, D, G, Z, ntiles, TV, C, H,   \
        ns, n, nnode, nout, vclip, nslots, nrows, root,                      \
        static_cast<cudaStream_t>(stream));                                  \
  }
