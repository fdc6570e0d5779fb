// The tree walk of both pruning pairs on Hopper: the forward pass with a
// residual of scaled partials, and the adjoint that reads the residual
// instead of recomputing the forward; templated on float and double and on
// the tip encoding and on the padded state count N (pruning_common.cuh:
// 32 or 64).  Instantiated by pruning_big.cu (B3/B4: AMB = false,
// state-code tips) and pruning.cu (B1/B2: AMB = true, coded tips with an
// ambiguity table), each at N = 32 and N = 64.  With AMB = false every
// `if constexpr (AMB)` branch is gone: B3/B4's code is the state-code walk
// alone.
//
// Schedules (host: cuda_pruning.BigPlan, the port of _sched_arrays,
// paml_tpu/core/pallas_pruning_big.py:59):
//   fsched row, DFS postorder, root last:
//     [v, out_slot, srow | -1, kid_slot x Kmax (-1 pad)]
//   bsched row, internal nodes in reverse DFS order, root first:
//     [v, aslot, srow_v, (kid, kid_srow | -1, kid_aslot | -1,
//                         grandkid_tip x Kmax) x Kmax]
// A "cherry" is a non-root internal node whose children are all tips: it
// has no row in the residual S [n_srows, C, n, H]; the adjoint rebuilds its
// scaled partial from the grandchild tips.
//
// Tips.  B3/B4 take state codes [ns, H]: a tip's contribution is the gather
// c[j, h] = P[j, state[h]].  B1/B2 take codes [ns, H] where a code below n is
// a state and a code n + a names row a of the ambiguity table amb [A, N] (the
// alignment's distinct tip vectors that are not one-hot: a gap, a codon with
// an N); their contribution is the gather TA[v, c, j, a] from the tip table
// TA = P_v amb^T, which pruning.cu computes once per launch.  A tip's dP
// takes an ambiguous cell as a rank-one update of the product's registers,
// dP_k[j, i] += G_k[j, h] amb[a, i], in pattern order.
//
// Design
// * Tiles of BHT = 32 patterns.  The forward runs one block per (tile,
//   class); the adjoint's block (g, c) takes a contiguous range of tiles and
//   walks the tree once per visit of up to TV of them (TV from the wrapper).
// * Elementwise phases (the children's product, rescale, the adjoint G_k)
//   give thread (w = warp, lane) rows RW w .. RW w + RW - 1 of pattern
//   `lane` (RW = N / 8: 8 rows at N = 64, 4 at N = 32): a warp's gathers
//   P[j, state[h]] and its loads and stores of partials touch one row at a
//   time, a few cache lines; a column max or sum over the states is RW
//   values in registers and one pass through shared memory (col_reduce).
// * Products on the FP64 tensor cores in float64, FMA in float32, through
//   pruning_common.cuh's prod_* (the same routine in forward and adjoint).
// * The forward gathers a tip child's contribution where its parent needs
//   it (no tip step, no tip slot) and keeps a node's contribution in shared
//   memory when the next row is its parent (`keep`).
// * Rescaling multiplies by 1 / max (an f64 division per value costs more
//   than the rest of the phase), in the forward and in the adjoint's cherry
//   rebuild alike.
// * The adjoint keeps the node at hand in shared memory: each child's P_k
//   (internal children) for the whole visit; for the tile at hand each
//   child's c_k = P_k s_k, s_k and G_k, and A_v.  A_v and the residual rows
//   arrive by cp.async, the tips' and cherries' gathers with them.  The
//   children's dP_k are summed over the visit's tiles before one store to
//   the block's slab: internal children's in the product's
//   registers, tip children's in shared memory by a scatter, dP_k[j,
//   state[h]] += G_k[j, h] (warp w owns the states = w mod SG of 32 rows,
//   SG = 256 / N warps to each 32 rows, and takes, in order, the patterns
//   whose state it owns, so the sum order is fixed and the warp does not
//   diverge); a tip's one-hot product is gone.
// * The slabs (dP [G, nnode, C, N, N], dpi [G, C, N]) are summed by
//   reduce_kernel (root row zeroed, nan_to_num), as the JAX wrapper does
//   outside its kernel (pallas_pruning_big.py:614-617).  Slabs rather than
//   atomics: the sum order is fixed, so fits repeat bit for bit.
// * Every internal node is rescaled (the JAX kernel's int_s,
//   pallas_pruning_big.py:206-214), so the residual holds s_v = prod / max
//   and the adjoint's recomputed contributions and scale factors are bit for
//   bit the forward's.
// * The adjoint slots (nslots + 1 per visit tile; A_v reuses c_v's forward
//   slot, the root takes slot nslots) and the forward's contribution slots
//   stay in device memory, where L2 serves most of them.  A node's slot is
//   its last child's; A_v is copied to shared memory at the start of a
//   tile, so A_k may overwrite it later in the same tile.
// * Binary trees only (KMAX = 2): the wrappers walk cuda_pruning.big_tree,
//   which resolves a node of more children (a trifurcating root, a
//   polytomy) into binary ones joined by branches with an identity P.
//   Three children's buffers do not fit beside each other; at 1024 taxa a
//   trifurcating root walked with one s_k / G_k buffer, reloaded per child,
//   took B4 19 ms at a chunk and 108 ms unchunked, its binary resolution
//   with a buffer per child 16 and 85 ms (tools/torch_big_probe.py, PERF.md).
//
// What bounds it on the H100 (f64, the 1024-taxon balanced tree, C = 4,
// 10240 patterns; cuda_pruning.kernel_work).  The forward does 1022
// products of 2 * 61^2 per pattern and class, 312 GFLOP, 4.65 ms at 67
// TFLOP/s; it writes S, 10.2 GB, 3.1 ms at 3.35 TB/s.  The adjoint does
// 3066 such products, 935 GFLOP, 13.9 ms, and reads S once.  Measured, both
// run at about a sixth of that bound (PERF.md): each block walks the tree
// node by node, and its loads, gathers and barriers at each node leave the
// tensor cores idle most of the time.  At a 1024-pattern chunk the adjoint
// also writes G = 32 dP slabs of 268 MB (8.6 GB), which the reduction reads
// back: 3.3 of B4's 16 ms.  A smaller G writes less but walks longer, and
// costs more than it saves (G 16: 21 ms; PERF.md).  The tip table adds
// 2 n^2 A per tip and class, and an ambiguous cell 2 n^2 to its tip's dP:
// for gapped codon data (A of a few dozen, 5 % of the cells) a few per
// cent of the walk's products.  At N = 32 (20 states) each product and
// each P are a quarter of N = 64's, each partial half, and a block's shared
// memory 2.3-2.4 times smaller.
#pragma once

#include "pruning_common.cuh"

namespace {

constexpr int KMAX = 2;      // children per node (cuda_pruning.big_tree)
constexpr int RED = 2 * 8 * BHT;   // values of col_reduce's scratch
// rows a thread in the sum over the root's states, at every N: the column
// sums group the rows by thread, so N = 32's instance takes N = 64's
// grouping there (its other elementwise phases hold no sum over states),
// and both instances give the same bits where the adjoint's grid is the
// same
constexpr int ROOT_RW = 8;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// [N][LDN] <- P_v [N][N] by asynchronous 16-byte copies (cp.async), which
// overlap whatever the block does until cp_async_wait; copy_P leaves them
// uncommitted (the tangents commit a step's copies as one group)
template <typename T, int N>
__device__ __forceinline__ void copy_P(T* Ps, const T* Pv) {
  constexpr int V = 16 / sizeof(T);          // values per copy
  constexpr int PER = N * N / V / NT;        // copies per thread
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = (threadIdx.x + q * NT) * V;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        Ps + (e / N) * Pad<N>::LDN + e % N));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(Pv + e));
  }
}
template <typename T, int N>
__device__ __forceinline__ void load_Pn_async(T* Ps, const T* Pv) {
  copy_P<T, N>(Ps, Pv);
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// one value by an asynchronous copy, zero-filled where !ok (src must still
// be a valid address)
template <typename T>
__device__ __forceinline__ void cp_async_val(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

// The max (MAX) or sum over the N rows of pattern column `lane`, from
// each thread's value over its RW rows, through red [2][8][BHT]: the halves
// alternate, so a half is written again only after the barrier of the
// call between, and one barrier a call does.  Every thread gets the result;
// a sum runs in row order.
template <typename T, bool MAX>
__device__ __forceinline__ T col_reduce(T x, T* red, int& half) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* rb = red + half * 8 * BHT;
  half ^= 1;
  rb[w * BHT + lane] = x;
  __syncthreads();
  T r = rb[lane];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const T y = rb[i * BHT + lane];
    r = MAX ? (y > r ? y : r) : r + y;
  }
  return r;
}

// where a coded tip's contribution column lies (AMB): a state's in P_v
// (row stride N), an ambiguity's in the tip table TA (row stride LA)
template <typename T, int N>
__device__ __forceinline__ void coded_src(const T*& src, int& rs, const T* P,
                                          const T* TA, int v, int c, int C,
                                          int code, int n, int LA) {
  if (code >= n) {
    src = TA + ((size_t)v * C + c) * N * LA + (code - n);
    rs = LA;
  } else {
    src = P + ((size_t)v * C + c) * N * N + code;
    rs = N;
  }
}

template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT) big_fwd_kernel(
    const int* __restrict__ fs, int nsteps, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ pi, T* __restrict__ lnf, T* __restrict__ S,
    T* __restrict__ work, int C, int H, int ns, int n, int nslots,
    const T* __restrict__ TA, int LA) {
  constexpr int LDN = Pad<N>::LDN, RW = Pad<N>::RW, EH = Pad<N>::EH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);   // [N][LDN]
  T* Ss = Ps + N * LDN;                      // [N][LDH]
  T* Cs = Ss + N * LDH;                      // [N][LDH]: the kept c_v
  T* red = Cs + N * LDH;                     // [RED]: col_reduce
  const int tile = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, hg = tile * BHT + lane;
  const int width = 5 + 2 * kmax;
  const size_t NH = (size_t)N * BHT;
  T* wb = work + (size_t)(tile * C + c) * nslots * NH;
  T logm = T(0);
  int half = 0;
  for (int i = 0; i < nsteps; ++i) {
    const int* r = fs + (size_t)i * width;   // internal nodes only
    const int srow = r[2], keep = r[3 + 2 * kmax], kept = r[4 + 2 * kmax];
    const bool root = i == nsteps - 1;
    __syncthreads();   // the children's slots are written; Ps, Ss are free
    if (!root) load_Pn_async<T, N>(Ps, P + ((size_t)r[0] * C + c) * N * N);
    // the children's contributions (a gather for a tip, its slot or the
    // kept c for an internal node), their product rescaled by its column
    // max; each child's source and row stride first, then every load
    // unconditional, so that all of them are in flight together
    const T* src[KMAX];
    int rs[KMAX];
    bool has[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int kid = k < kmax ? r[3 + kmax + k] : -1;
      has[k] = kid >= 0;
      if (kid >= 0 && kid < ns) {
        const int st = hg < H ? states[(size_t)kid * H + hg] : 0;
        if constexpr (AMB) {
          coded_src<T, N>(src[k], rs[k], P, TA, kid, c, C, st, n, LA);
        } else {
          src[k] = P + ((size_t)kid * C + c) * N * N + st;
          rs[k] = N;
        }
      } else if (k == kept) {
        src[k] = Cs + lane;
        rs[k] = LDH;
      } else {
        src[k] = wb + (size_t)(kid >= 0 ? r[3 + k] : 0) * NH + lane;
        rs[k] = BHT;
      }
    }
    T y[KMAX][RW];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int q = 0; q < RW; ++q)
        y[k][q] = has[k] ? src[k][(RW * w + q) * rs[k]] : T(1);
    T x[RW], m = T(0);
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      T p = y[0][q];
#pragma unroll
      for (int k = 1; k < KMAX; ++k)
        if (has[k]) p *= y[k][q];
      x[q] = p;
      m = (q == 0 || p > m) ? p : m;
    }
    m = col_reduce<T, true>(m, red, half);
    // times 1 / max: an f64 division per value would cost more than the
    // rest of the phase; the adjoint rebuilds a cherry the same way
    const T ms = m > T(0) ? m : T(1), rms = T(1) / ms;
    logm += Num<T>::lg(ms);
    T* Sv = (S != nullptr && srow >= 0) ? S + ((size_t)srow * C + c) * n * H
                                        : nullptr;
    T F = T(0);
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int j = RW * w + q;
      x[q] = x[q] * rms;
      Ss[j * LDH + lane] = x[q];
      if (Sv != nullptr && j < n && hg < H) Sv[(size_t)j * H + hg] = x[q];
      F += pi[(size_t)c * N + j] * x[q];
    }
    if (root) {
      if constexpr (RW != ROOT_RW) {
        // the sum over the states as N = 64's instance takes it
        // (ROOT_RW), from s_root in Ss
        __syncthreads();
        F = T(0);
        if (w < N / ROOT_RW) {
#pragma unroll
          for (int q = 0; q < ROOT_RW; ++q) {
            const int j = ROOT_RW * w + q;
            F += pi[(size_t)c * N + j] * Ss[j * LDH + lane];
          }
        }
      }
      F = col_reduce<T, false>(F, red, half);
      if (w == 0 && hg < H)
        lnf[(size_t)c * H + hg] =
            Num<T>::lg(F > Num<T>::tiny() ? F : Num<T>::tiny()) + logm;
      return;
    }
    cp_async_wait();
    __syncthreads();
    T acc[EH];
    prod_ps<T, N>(Ps, Ss, acc);
    // c_v into shared memory when the next row is v's parent, else its slot
    T* out = keep ? Cs : wb + (size_t)r[1] * NH;
    const int ld = keep ? LDH : BHT;
#pragma unroll
    for (int e = 0; e < EH; ++e) {
      int row, col;
      acc_rc<N, Pad<N>::QH>(e, row, col);
      out[row * ld + col] = acc[e];
    }
  }
}

// a residual row of S into Sb [N][LDH] by asynchronous copies (zero past
// n and H; the caller waits); copy_S leaves them uncommitted
template <typename T, int N>
__device__ __forceinline__ void copy_S(T* Sb, const T* S, int srow, int c,
                                       int C, int n, int H, int h0) {
  const T* src = S + ((size_t)srow * C + c) * n * H;
#pragma unroll
  for (int q = 0; q < N * BHT / NT; ++q) {
    const int e = threadIdx.x + q * NT, j = e / BHT, h = e % BHT;
    const bool ok = j < n && h0 + h < H;
    cp_async_val(Sb + j * LDH + h, ok ? src + (size_t)j * H + h0 + h : src,
                 ok);
  }
}
template <typename T, int N>
__device__ __forceinline__ void load_S_async(T* Sb, const T* S, int srow,
                                             int c, int C, int n, int H,
                                             int h0) {
  copy_S<T, N>(Sb, S, srow, c, C, n, H, h0);
  cp_async_commit();
}

// the state codes that child kr needs at pattern hg: a tip's own (st[0]),
// or a cherry's grandchildren's; -1 where there is none
__device__ __forceinline__ void child_codes(int st[KMAX], const int* kr,
                                            int kmax, int ns,
                                            const int* states, int H,
                                            int hg) {
#pragma unroll
  for (int a = 0; a < KMAX; ++a) {
    const int v = kr[0] < ns ? (a == 0 ? kr[0] : -1)
                             : (a < kmax ? kr[3 + a] : -1);
    st[a] = v < 0 ? -1 : (hg < H ? states[(size_t)v * H + hg] : 0);
  }
}

// this thread's rows of a tip's contribution P_k[j, st] (kr a tip), or of
// a cherry's scaled partial rebuilt from its grandchildren's gathers as the
// forward built it (kr a cherry), into dst [N][LDH]
template <typename T, bool AMB, int N>
__device__ __forceinline__ void gather_child(T* dst, const int* kr,
                                             const int st[KMAX], int ns,
                                             const T* P, int c, int C,
                                             T* red, int& half, const T* TA,
                                             int n, int LA) {
  constexpr int RW = Pad<N>::RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T y[KMAX][RW];
  if constexpr (AMB) {
    const T* src[KMAX];
    int rs[KMAX];
#pragma unroll
    for (int a = 0; a < KMAX; ++a) {
      const int v = st[a] < 0 ? 0 : (kr[0] < ns ? kr[0] : kr[3 + a]);
      coded_src<T, N>(src[a], rs[a], P, TA, v, c, C, st[a] < 0 ? 0 : st[a],
                      n, LA);
    }
#pragma unroll
    for (int a = 0; a < KMAX; ++a)
#pragma unroll
      for (int q = 0; q < RW; ++q)
        y[a][q] = st[a] >= 0 ? src[a][(RW * w + q) * rs[a]] : T(1);
  } else {
    const T* src[KMAX];
#pragma unroll
    for (int a = 0; a < KMAX; ++a) {
      const int v = st[a] < 0 ? 0 : (kr[0] < ns ? kr[0] : kr[3 + a]);
      src[a] = P + ((size_t)v * C + c) * N * N + (st[a] < 0 ? 0 : st[a]);
    }
#pragma unroll
    for (int a = 0; a < KMAX; ++a)
#pragma unroll
      for (int q = 0; q < RW; ++q)
        y[a][q] = st[a] >= 0 ? src[a][(RW * w + q) * N] : T(1);
  }
  if (kr[0] < ns) {
#pragma unroll
    for (int q = 0; q < RW; ++q) dst[(RW * w + q) * LDH + lane] = y[0][q];
    return;
  }
  T x[RW], m = T(0);
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    x[q] = y[0][q];
#pragma unroll
    for (int a = 1; a < KMAX; ++a)
      if (st[a] >= 0) x[q] *= y[a][q];
    m = (q == 0 || x[q] > m) ? x[q] : m;
  }
  m = col_reduce<T, true>(m, red, half);
  const T rms = T(1) / (m > T(0) ? m : T(1));
#pragma unroll
  for (int q = 0; q < RW; ++q) dst[(RW * w + q) * LDH + lane] = x[q] * rms;
}

template <typename T, bool AMB, int N>
__global__ void __launch_bounds__(NT) big_bwd_kernel(
    const int* __restrict__ bs, int nint, int kmax,
    const T* __restrict__ P, const int* __restrict__ states,
    const T* __restrict__ pi, const T* __restrict__ gbar,
    const T* __restrict__ S, T* __restrict__ dP_slab,
    T* __restrict__ dpi_slab, T* __restrict__ work, int C, int H, int ns,
    int n, int nnode, int vclip, int nslots, int ntiles, int TV,
    const T* __restrict__ amb, const T* __restrict__ TA, int LA) {
  constexpr int LDN = Pad<N>::LDN, TLD = Pad<N>::TLD, RW = Pad<N>::RW;
  constexpr int EH = Pad<N>::EH, EN = Pad<N>::EN;
  constexpr int QH = Pad<N>::QH, QN = Pad<N>::QN;
  // SG = 256 / N warps share each 32 rows of a tip's dP_k; SGS = log2 SG
  constexpr int SG = 256 / N, SGS = N == 64 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [kmax][N][LDN]: P_k, or a tip's dP_k ([N][TLD] in the same room)
  T* kb = reinterpret_cast<T*>(smem_raw);
  T* cb = kb + kmax * N * LDN;               // [kmax][N][LDH]: c_k
  T* sb = cb + kmax * N * LDH;               // [KMAX][N][LDH]: s_k
  T* Gb = sb + KMAX * N * LDH;               // [KMAX][N][LDH]: G_k
  T* Ab = Gb + KMAX * N * LDH;               // [N][LDH]: A_v
  T* red = Ab + N * LDH;                     // [RED]: col_reduce
  T* dpa = red + RED;                        // [N]: dpi of the block
  const int g = blockIdx.x, c = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int stride = 3 + kmax, width = 3 + stride * kmax;
  const size_t NH = (size_t)N * BHT;
  T* abuf = work + (size_t)(g * C + c) * (nslots + 1) * TV * NH;
  T* dps = dP_slab + (size_t)g * nnode * C * N * N;
  const T* pic = pi + (size_t)c * N;
  const int lo = (int)((long long)g * ntiles / G);
  const int hi = (int)((long long)(g + 1) * ntiles / G);
  int half = 0;
  if (tid < N) dpa[tid] = T(0);
  for (int t0 = lo; t0 < hi; t0 += TV) {
    const int nt = min(TV, hi - t0);
    const bool add = t0 != lo;
    // root (bsched row 0): gF = gbar / F, A_root = gF pi, dpi += gF s_root
    for (int t = 0; t < nt; ++t) {
      const int hg = (t0 + t) * BHT + lane;
      const T* Sr = S + ((size_t)bs[2] * C + c) * n * H;
      T* Ar = abuf + ((size_t)bs[1] * TV + t) * NH;
      // ROOT_RW rows a thread at every N (warps past N / ROOT_RW idle at
      // N = 32): the sum over the states as N = 64's instance takes it
      const bool on = RW == ROOT_RW || w < N / ROOT_RW;
      T x[ROOT_RW], F = T(0);
#pragma unroll
      for (int q = 0; q < ROOT_RW; ++q) {
        const int j = ROOT_RW * w + q;
        x[q] = (on && j < n && hg < H) ? Sr[(size_t)j * H + hg] : T(0);
        if (on) F += pic[j] * x[q];
      }
      F = col_reduce<T, false>(F, red, half);
      F = F > Num<T>::tiny() ? F : Num<T>::tiny();
      const T gf = hg < H ? gbar[(size_t)c * H + hg] / F : T(0);
      if (on) {
#pragma unroll
        for (int q = 0; q < ROOT_RW; ++q) {
          const int j = ROOT_RW * w + q;
          Ar[j * BHT + lane] = gf * pic[j];
          // dpi[j] += sum over the tile's patterns (the warp's lanes)
          T s = gf * x[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) dpa[j] += s;
        }
      }
    }
    for (int i = 0; i < nint; ++i) {
      const int* r = bs + (size_t)i * width;
      int K = 0;
      while (K < kmax && r[3 + stride * K] >= 0) ++K;
      __syncthreads();   // the previous node's stores have read kb
      for (int k = 0; k < K; ++k) {
        const int kid = r[3 + stride * k];
        T* kk = kb + k * N * LDN;
        if (kid < ns) {
          for (int e = tid; e < N * TLD; e += NT) kk[e] = T(0);
        } else {
          load_Pn_async<T, N>(kk, P + ((size_t)kid * C + c) * N * N);
        }
      }
      // internal children's dP_k; with AMB also a tip child's ambiguous
      // cells (its resolved cells go to the scatter in kb)
      T acc[KMAX][EN];
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int e = 0; e < EN; ++e) acc[k][e] = T(0);
      for (int t = 0; t < nt; ++t) {
        const int ht = (t0 + t) * BHT;
        __syncthreads();   // kb's zeros are written; cb, sb, Gb, Ab are free
        // 1) each child's c_k = P_k s_k.  A_v and the residual rows by
        //    asynchronous copies, every state code the tips and cherries
        //    need, then their gathers: all in flight together; then the
        //    products.
        {
          const T* Av = abuf + ((size_t)r[1] * TV + t) * NH;
#pragma unroll
          for (int q = 0; q < N * BHT / NT; ++q) {
            const int e = tid + q * NT;
            cp_async_val(Ab + (e / BHT) * LDH + e % BHT, Av + e, true);
          }
          asm volatile("cp.async.commit_group;\n" ::);
        }
        int first = -1;   // the first internal child
        int st[KMAX][KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int* kr = r + 3 + stride * k;
          const bool inner = k < K && kr[0] >= ns;
          if (inner) {
            if (first < 0) first = k;
            if (kr[1] >= 0)
              load_S_async<T, N>(sb + k * N * LDH, S, kr[1], c, C, n, H, ht);
          }
          if (k < K && (!inner || kr[1] < 0))
            child_codes(st[k], kr, kmax, ns, states, H, ht + lane);
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int* kr = r + 3 + stride * k;
          if (k >= K || (kr[0] >= ns && kr[1] >= 0)) continue;
          gather_child<T, AMB, N>((kr[0] < ns ? cb : sb) + k * N * LDH, kr,
                                  st[k], ns, P, c, C, red, half, TA, n, LA);
        }
        for (int k = first; first >= 0 && k < K; ++k) {
          const int* kr = r + 3 + stride * k;
          if (kr[0] < ns) continue;
          T* ck = cb + k * N * LDH;
          if (k == first) {
            cp_async_wait();   // the node's P_k, the s_k
            __syncthreads();
          }
          T a8[EH];
          prod_ps<T, N>(kb + k * N * LDN, sb + k * N * LDH, a8);
#pragma unroll
          for (int e = 0; e < EH; ++e) {
            int row, col;
            acc_rc<N, QH>(e, row, col);
            ck[row * LDH + col] = a8[e];
          }
        }
        cp_async_wait();   // A_v (and P_k of a node without products)
        __syncthreads();
        // 2) the node's scale factor, from the product of the c_k
        T m = T(0);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int e = (RW * w + q) * LDH + lane;
          T p = cb[e];
          for (int k = 1; k < K; ++k) p *= cb[k * N * LDH + e];
          m = (q == 0 || p > m) ? p : m;
        }
        m = col_reduce<T, true>(m, red, half);
        const T ms = m > T(0) ? m : T(1), rms = T(1) / ms;
        // 3) per child, last first: G_k (every child's at once, on the
        //    first turn), dP_k += G_k s_k^T, A_k = P_k^T G_k
        // (a tip's codes of the tile are st[k][0]: lane h holds pattern h's)
        const int hn = min(BHT, H - ht);
#pragma unroll
        for (int k = KMAX - 1; k >= 0; --k) {
          if (k >= K) continue;
          const int* kr = r + 3 + stride * k;
          const int kid = kr[0];
          if (k == K - 1) {
#pragma unroll
            for (int k1 = KMAX - 1; k1 >= 0; --k1) {
              if (k1 >= K) continue;
              T* G1 = Gb + k1 * N * LDH;
              const bool own = (r + 3 + stride * k1)[0] < vclip;
#pragma unroll
              for (int q = 0; q < RW; ++q) {
                const int e = (RW * w + q) * LDH + lane;
                T loo = T(1);
                for (int k2 = 0; k2 < K; ++k2)
                  if (k2 != k1) loo *= cb[k2 * N * LDH + e];
                G1[e] = clip_adjoint(Ab[e] * rms * loo, own);
              }
            }
            cp_async_wait();
            __syncthreads();
          }
          const T* Gk = Gb + k * N * LDH;
          T* kk = kb + k * N * LDN;
          if (kid < ns) {
            // dP_k[j, state[h]] += G_k[j, h], h in order; warp w takes
            // the states = w mod SG of rows 32 (w / SG) + lane, and walks
            // only the patterns whose state it owns (a ballot over the
            // tile) (with AMB only the resolved cells, st < n)
            const int j = 32 * (w >> SGS) + lane;
            unsigned own;
            if constexpr (AMB)
              own = __ballot_sync(0xffffffffu,
                                  lane < hn && st[k][0] < n &&
                                      (st[k][0] & (SG - 1)) == (w & (SG - 1)));
            else
              own = __ballot_sync(0xffffffffu,
                                  lane < hn && (st[k][0] & (SG - 1)) ==
                                                   (w & (SG - 1)));
            while (own != 0u) {
              const int h = __ffs(own) - 1;
              own &= own - 1u;
              const int sv = __shfl_sync(0xffffffffu, st[k][0], h);
              kk[j * TLD + sv] += Gk[j * LDH + h];
            }
            if constexpr (AMB) {
              // an ambiguous cell h: dP_k[j, i] += G_k[j, h] amb[a, i], h in
              // order, into this thread's elements of the product layout
              unsigned am =
                  __ballot_sync(0xffffffffu, lane < hn && st[k][0] >= n);
              while (am != 0u) {
                const int h = __ffs(am) - 1;
                am &= am - 1u;
                const T* ar =
                    amb + (size_t)(__shfl_sync(0xffffffffu, st[k][0], h) - n)
                              * N;
#pragma unroll
                for (int e = 0; e < EN; ++e) {
                  int row, col;
                  acc_rc<N, QN>(e, row, col);
                  acc[k][e] = Num<T>::fma(Gk[row * LDH + h], ar[col],
                                          acc[k][e]);
                }
              }
            }
          } else {
            prod_gst<T, N>(Gk, sb + k * N * LDH, acc[k]);
            T a8[EH];
            prod_pts<T, N>(kk, Gk, a8);
            T* Ak = abuf + ((size_t)kr[2] * TV + t) * NH;
#pragma unroll
            for (int e = 0; e < EH; ++e) {
              int row, col;
              acc_rc<N, QH>(e, row, col);
              Ak[row * BHT + col] = a8[e];
            }
          }
          if (k == 0) __syncthreads();
        }
      }
      if constexpr (AMB) {
        // the ambiguous cells' sums join the tip's scatter, each element
        // once, after every scatter of the visit (the barrier above)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K || r[3 + stride * k] >= ns) continue;
          T* kk = kb + k * N * LDN;
#pragma unroll
          for (int e = 0; e < EN; ++e) {
            int row, col;
            acc_rc<N, QN>(e, row, col);
            kk[row * TLD + col] += acc[k][e];
          }
        }
        __syncthreads();
      }
      // the visit's dP_k into the block's slab
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K) continue;
        const int kid = r[3 + stride * k];
        T* d = dps + ((size_t)kid * C + c) * N * N;
        if (kid < ns) {
          const T* kk = kb + k * N * LDN;
          for (int e = tid; e < N * N; e += NT) {
            const T x = kk[(e / N) * TLD + e % N];
            d[e] = add ? d[e] + x : x;
          }
        } else {
#pragma unroll
          for (int e = 0; e < EN; ++e) {
            int row, col;
            acc_rc<N, QN>(e, row, col);
            T* p = d + row * N + col;
            *p = add ? *p + acc[k][e] : acc[k][e];
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < N) dpi_slab[(size_t)(g * C + c) * N + tid] = dpa[tid];
}

// TA[b, v, c, j, a0 + a] = sum_i P[b, v, c, j, i] amb[a0 + a, i] for tip v,
// class c, a block of BHT table rows (zero past A) and table b of a batch
// (P and TA b strides apart: B1/B2 build one table, from P, the tangents
// one more per direction, from Pd); amb is [A][N], TA [nb][ns, C, N, LA]
template <typename T, int N>
__global__ void __launch_bounds__(NT) tip_table_kernel(
    const T* __restrict__ P, size_t pstride, const T* __restrict__ amb,
    T* __restrict__ TA, size_t tstride, int C, int A, int LA) {
  constexpr int LDN = Pad<N>::LDN, EH = Pad<N>::EH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);   // [N][LDN]
  T* As = Ps + N * LDN;                      // [N][LDH]: amb^T
  const int nz = LA / BHT, b = blockIdx.z / nz;
  const int v = blockIdx.x, c = blockIdx.y, a0 = (blockIdx.z % nz) * BHT;
  const T* Pv = P + b * pstride + ((size_t)v * C + c) * N * N;
  for (int e = threadIdx.x; e < N * N; e += NT)
    Ps[(e / N) * LDN + e % N] = Pv[e];
  for (int e = threadIdx.x; e < N * BHT; e += NT) {
    const int i = e % N, a = e / N;
    As[i * LDH + a] = a0 + a < A ? amb[(size_t)(a0 + a) * N + i] : T(0);
  }
  __syncthreads();
  T acc[EH];
  prod_ps<T, N>(Ps, As, acc);
  T* out = TA + b * tstride + ((size_t)v * C + c) * N * LA + a0;
#pragma unroll
  for (int e = 0; e < EH; ++e) {
    int row, col;
    acc_rc<N, Pad<N>::QH>(e, row, col);
    out[(size_t)row * LA + col] = acc[e];
  }
}

// nb tip tables from nb P's pstride apart into TA, tstride apart
template <typename T, int N>
int launch_tip_table(const T* P, size_t pstride, const T* amb, T* TA,
                     size_t tstride, int nb, int ns, int C, int A, int LA,
                     cudaStream_t stream) {
  if (A == 0) return (int)cudaSuccess;
  const int smem = (int)((N * Pad<N>::LDN + N * LDH) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tip_table_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  tip_table_kernel<T, N><<<dim3(ns, C, nb * (LA / BHT)), NT, smem, stream>>>(
      P, pstride, amb, TA, tstride, C, A, LA);
  return (int)cudaGetLastError();
}

}  // namespace
