// Symmetric eigendecomposition of a batch of small float64 matrices by the
// parallel cyclic Jacobi method, with its failure state left on the device
// (plain C interface, built with nvcc and loaded with ctypes by
// paml_tpu_torch/_build.py).
//
// Replaces, on the P(t) route of paml_tpu_torch/core/pmat.py, the
// eigendecomposition that the JAX package leaves to XLA (jnp.linalg.eigh,
// paml_tpu/core/pmat.py:82-90).  It is not a TPU kernel: PyTorch's own
// torch.linalg.eigh computes the same function on the card, but it reads
// cuSOLVER's info on the host after every call, so an evaluation that
// uses it cannot be captured in a CUDA graph.  Here a status word per
// matrix (0 converged, 1 a non-finite entry, 2 no convergence within
// MAX_SWEEPS sweeps) and the sweeps taken stay on the card, for the
// caller to read with the copy it makes anyway.
//
// The method.  One block per matrix of order n <= 64 (codons 60-63, amino
// acids 20, nucleotides 4; S symmetric, its upper triangle read).  A sweep
// is npad - 1 rounds of the round-robin (circle) ordering over npad = n
// rounded up to even indices (a padded index is a zero row and column: its
// rotations are the identity); the npad / 2 rotations of a round touch
// disjoint index pairs, so a round computes them all and applies
// A' = J^T A J as 2 x 2 blocks over pairs of pairs and V' = V J.
// Convergence is tested before each sweep: the off-diagonal sum of squares
// at most DBL_EPSILON^2 times the whole.  Every product and sum is rounded
// on its own (no fused multiply-add), in the order of the plain version
// (`cuda_eigh.jacobi_plain`): the kernel gives its bits.  Eigenvalues
// ascending, eigenvectors as U's columns.
//
// What bounds it on the H100.  About 6 n^3 operations per sweep, a few
// microseconds of the card's FP64 rate for the three to eight matrices of
// a codon model, and fewer bytes: neither binds.  What it waits on is the
// latency of its rounds, 8 sweeps x 61 = 488 in sequence at n = 61: a
// round's rotations are a chain of a division, two square roots and two
// reciprocals (about 530 cycles), and a round cannot start before the
// last one's entries of A are written.  The first version (PR 13) ran
// that chain on 31 threads while the rest of the block waited, then A and
// V behind two barriers: 2.6 us a round.
//
// The design against that latency:
// - One barrier a round.  Warp 0 (the pivot warp) computes round r + 1's
//   rotations while the other warps apply round r's.  It forms each of its
//   three entries of A after round r itself: the off-diagonal one from A
//   before round r, by the same 2 x 2 arithmetic the update warps use (so
//   the same bits), the two diagonal ones from the running diagonal D,
//   which only the pivot warp writes.  A is double-buffered (read the one,
//   write the other), the rotations and D too.  The pivot lanes' index
//   arithmetic (a `Plan` per round and slot) is tabled in shared memory
//   at launch, so a round costs the chain one 16-byte load, and no update
//   warp shares the pivot warp's scheduler (warp 4 idles).
// - V off the chain, and out of shared memory where the order is known:
//   for npad 60-64 (the genetic codes' 59-64 sense codons), 20 and 4 a
//   thread holds a row of V in registers.  Relabeled so that position q
//   holds index (q + shift) mod (npad - 1), round r's pairs sit at fixed
//   positions (o, npad - 1) and (k + o, npad - 1 - k + o), o = the rounds
//   since the last shift; the rounds unroll U at a time with compile-time
//   positions and the row shifts by U in registers after each U (one cycle
//   of moves; none when U = npad - 1).  Such an instance runs at most 8
//   warps (four blocks of A an update thread), so that the row's 2 npad
//   registers fit without spilling.  Every other order runs a generic
//   instance with V in shared memory, four (row, slot) tasks a thread.
// - No idle tasks, no division in the loop: an update thread owns fixed
//   blocks (a, b), a < b, of pair slots for the whole launch; their
//   indices advance by one a round.  Each role (pivot, V row, update) runs
//   its own copy of the sweep loop, so their registers do not add up.
// - Conflict-free shared memory: A's upper triangle only, row stride 65,
//   so entry (i, j) lies on bank (i + j) mod 16 (8-byte words), every
//   access in the circle's own orientation (u, v) = ((r + k) mod (npad -
//   1), (r - k) mod (npad - 1)), consecutive over a warp's slots.  The
//   rotation is published as (c, sigma), sigma = s when u < v and -s
//   otherwise: c x_u - sigma x_v and sigma x_u + c x_v are then exactly
//   (bit for bit) the plain version's c x_p - s x_q and s x_p + c x_q in
//   either orientation, with no select.
// - The convergence test as warp-shuffle sums in a fixed order, one extra
//   barrier a sweep, during which the pivot warp computes the next sweep's
//   first rotations.
// A debug instance (`paml_eigh_probe_f64`, on no path of the package) can
// skip V, the update of A or the rotation chain, run a fixed number of
// sweeps and stamp each warp's clock around its part of each round, to
// split a round's time (tools/torch_eigh_probe.py).

#include <cfloat>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 64;          // largest order
constexpr int LD = NMAX + 1;      // row stride: (i, j) on bank (i + j) % 16
constexpr int KV = 4;             // V tasks per update thread (generic)
constexpr int MAX_SWEEPS = 30;
constexpr unsigned FULL = 0xffffffffu;

// probe flags
constexpr int SKIP_V = 1, SKIP_A = 2, SKIP_CHAIN = 4, STAMPS = 8;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the rotation (c, sigma) = P applied to the pair (x_u, x_v): its u and its
// v component
__device__ __forceinline__ double rot_u(double2 P, double xu, double xv) {
  return add(mul(P.x, xu), mul(-P.y, xv));
}
__device__ __forceinline__ double rot_v(double2 P, double xu, double xv) {
  return add(mul(P.y, xu), mul(P.x, xv));
}
// either component, chosen per thread without a branch (the same bits)
__device__ __forceinline__ double rot_uv(double2 P, bool u, double xu,
                                         double xv) {
  return add(mul(u ? P.x : P.y, xu), mul(u ? -P.y : P.x, xv));
}

// pair k of round r of the circle method over mc + 1 indices: index mc
// fixed, the others turning; u = r + k, v = r - k (mod mc)
__device__ __forceinline__ void circle(int r, int k, int mc, int& u, int& v) {
  if (k == 0) {
    u = r;
    v = mc;
  } else {
    u = r + k;
    if (u >= mc) u -= mc;
    v = r - k;
    if (v < 0) v += mc;
  }
}

// the same pair one round later
__device__ __forceinline__ void step(int k, int mc, int& u, int& v) {
  u = u + 1 == mc ? 0 : u + 1;
  if (k != 0) v = v + 1 == mc ? 0 : v + 1;
}

// the slot of index i in round r (m = (mc + 1) / 2 slots)
__device__ __forceinline__ int slot_of(int r, int i, int mc, int m) {
  if (i == mc) return 0;
  int k = i - r;
  if (k < 0) k += mc;
  return k < m ? k : mc - k;
}

// the stored (upper) entry of A for (i, j), i != j
__device__ __forceinline__ int at(int i, int j) {
  return i < j ? i * LD + j : j * LD + i;
}

// the rotation zeroing a_pq (p < q): c, s, t as the plain version (sg / z
// and 1 / sqrt(y) as round-to-nearest reciprocals: the same bits)
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s, double& t) {
  c = 1.0;
  s = 0.0;
  t = 0.0;
  if (apq != 0.0) {
    const double tau = sub(aqq, app) / mul(2.0, apq);
    const double rz = __drcp_rn(add(fabs(tau), sqrt(add(1.0, mul(tau, tau)))));
    t = tau >= 0.0 ? rz : -rz;
    c = __drcp_rn(sqrt(add(1.0, mul(t, t))));
    s = mul(t, c);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The pivot lane's addresses for the round r of slot k: the entry its pair
// zeroes, and for round r + 1's pair (p, q) the four entries of its block
// in round r (the lower slot's indices as rows), which component of the
// row and column rotations is its entry, and sigma's sign.
struct Plan {
  int zero, zuu, zuv, zvu, zvv, lo, hi, p, q;
  bool row_u, col_u, neg;
};

__device__ __forceinline__ Plan plan_of(int r, int k, int mc, int m) {
  Plan pl;
  int u, v, u1, v1, ul, vl, uh, vh;
  circle(r, k, mc, u, v);
  pl.zero = at(u, v);
  circle(r + 1 < mc ? r + 1 : 0, k, mc, u1, v1);
  const int s1 = slot_of(r, u1, mc, m), s2 = slot_of(r, v1, mc, m);
  pl.lo = min(s1, s2);
  pl.hi = max(s1, s2);
  circle(r, pl.lo, mc, ul, vl);
  circle(r, pl.hi, mc, uh, vh);
  pl.zuu = at(ul, uh);
  pl.zuv = at(ul, vh);
  pl.zvu = at(vl, uh);
  pl.zvv = at(vl, vh);
  pl.row_u = (s1 < s2 ? u1 : v1) == ul;
  pl.col_u = (s1 < s2 ? v1 : u1) == uh;
  pl.p = min(u1, v1);
  pl.q = max(u1, v1);
  pl.neg = v1 < u1;
  return pl;
}

// a Plan in 16 bytes (addresses < 2^13, slots < 2^5, indices < 2^6)
__device__ __forceinline__ uint4 pack(const Plan& pl) {
  return make_uint4(pl.zuu | pl.zuv << 16, pl.zvu | pl.zvv << 16,
                    pl.zero | pl.lo << 16 | pl.hi << 21 | pl.row_u << 26 |
                        pl.col_u << 27 | pl.neg << 28,
                    pl.p | pl.q << 8);
}

__device__ __forceinline__ Plan unpack(uint4 w) {
  Plan pl;
  pl.zuu = w.x & 0xffff;
  pl.zuv = w.x >> 16;
  pl.zvu = w.y & 0xffff;
  pl.zvv = w.y >> 16;
  pl.zero = w.z & 0xffff;
  pl.lo = (w.z >> 16) & 31;
  pl.hi = (w.z >> 21) & 31;
  pl.row_u = (w.z >> 26) & 1;
  pl.col_u = (w.z >> 27) & 1;
  pl.neg = (w.z >> 28) & 1;
  pl.p = w.w & 0xff;
  pl.q = w.w >> 8;
  return pl;
}

// A row of V in registers (npad = NPAD known), every position a template
// constant: pair K of a round at offset O, a round, the shift by U.
template <int NPAD, int O, int K>
__device__ __forceinline__ void vpair(double (&x)[NPAD], const double2* Pr) {
  constexpr int MC = NPAD - 1;
  constexpr int a = (K + O) % MC;
  constexpr int b = K == 0 ? MC : (MC - K + O) % MC;
  const double2 P = Pr[K];
  const double xa = x[a], xb = x[b];
  x[a] = rot_u(P, xa, xb);
  x[b] = rot_v(P, xa, xb);
}

template <int NPAD, int O, int... K>
__device__ __forceinline__ void vround(double (&x)[NPAD], const double2* Pr,
                                       std::integer_sequence<int, K...>) {
  (vpair<NPAD, O, K>(x, Pr), ...);
}

template <int NPAD, int U, int O = 0>
__device__ __forceinline__ void vround_at(int o, double (&x)[NPAD],
                                          const double2* Pr) {
  if constexpr (O < U) {
    if (o == O)
      vround<NPAD, O>(x, Pr, std::make_integer_sequence<int, NPAD / 2>{});
    else
      vround_at<NPAD, U, O + 1>(o, x, Pr);
  }
}

// positions q <- q + U (mod npad - 1): the relabeling after U rounds, as
// one cycle of moves through a single temporary (U prime to npad - 1)
__host__ __device__ constexpr int gcd(int a, int b) {
  return b ? gcd(b, a % b) : a;
}

template <int NPAD, int U, int... Q>
__device__ __forceinline__ void vshift(double (&x)[NPAD],
                                       std::integer_sequence<int, Q...>) {
  constexpr int MC = NPAD - 1;
  static_assert(gcd(U, MC) == 1, "the shift must be one cycle");
  const double t = x[0];
  ((x[Q * U % MC] = x[(Q + 1) * U % MC]), ...);
  x[(MC - 1) * U % MC] = t;
}

template <int NPAD, int... Q>
__device__ __forceinline__ void vinit(double (&x)[NPAD], int row,
                                      std::integer_sequence<int, Q...>) {
  ((x[Q] = Q == row ? 1.0 : 0.0), ...);
}

// the row back in index order: position q holds index (q + sh) mod mc
template <int NPAD, int... Q>
__device__ __forceinline__ void vstore(const double (&x)[NPAD], double* Vr,
                                       int sh,
                                       std::integer_sequence<int, Q...>) {
  constexpr int MC = NPAD - 1;
  ((Vr[Q + sh < MC ? Q + sh : Q + sh - MC] = x[Q]), ...);
  Vr[MC] = x[MC];
}

// shared memory, for orders up to NCAP: A twice and V ([NCAP][LD] each),
// the rotations and D twice, the test's sums, the ranks, the Plans
constexpr int RED_MAX = 512 / 32 + 2;

template <int NCAP>
struct Layout {
  static constexpr int V = 2 * NCAP * LD;
  static constexpr int P = V + NCAP * LD;             // double2 [2][NMAX / 2]
  static constexpr int D = P + 2 * NMAX;              // [2][NMAX]
  static constexpr int RED = D + 2 * NMAX;            // [warps + 1]
  static constexpr int RANK = (RED + RED_MAX) * sizeof(double);   // bytes
  static constexpr int PLAN = RANK + NMAX * sizeof(int);  // uint4 [NCAP][32]
  static constexpr int BYTES = PLAN + NCAP * 32 * 16;
};

// The instance's shape: NPAD > 0 holds V's rows in registers (NVW warps of
// rows, TA = 4 blocks of A a thread: at most 8 warps, so that a row's
// 2 npad registers fit beside its loop's without spilling); NPAD == 0 is
// generic, 512 update threads with one block of A and KV tasks of V each.
// Warp 0 is the pivot warp, then the rows' warps, then the update warps.
template <int NPAD>
struct Shape {
  static constexpr int M = NPAD / 2;
  static constexpr int NVW = NPAD ? (NPAD + 31) / 32 : 0;
  static constexpr int TA = NPAD ? 4 : 1;
  static constexpr int NAT =
      NPAD ? ((M * (M - 1) / 2 + TA * 32 - 1) / (TA * 32)) * 32 : 512;
  // no update warp beside the pivot warp on its scheduler (warp w runs on
  // sub-partition w % 4): warp 4 idles
  static constexpr int NW0 = 1 + NVW + NAT / 32;
  static constexpr bool IDLE4 = NPAD > 0 && NW0 > 4;
  static constexpr int NW = NW0 + IDLE4;
  static constexpr int NT = 32 * NW;
  static constexpr int U = NPAD == 0 ? 1 : NPAD - 1 <= 19 ? NPAD - 1 : 4;
  static constexpr int NCAP = NPAD ? NPAD : NMAX;     // the largest order
  using L = Layout<NCAP>;
};

// What every role shares: the matrix's order, A's buffers, the rotations,
// D, the test's sums, the sweeps.
struct Common {
  int n, m, mc, lane, warp, NW;
  double* Acur;
  double* Anew;
  double2* P;
  double* D;
  double* red;
  int b, sweeps, status;
  int fixed_sweeps;
  bool probe;
  long long* stamps;   // the probe's clock stamps, or null
};

// The sweeps, the same barriers in every role: before each sweep the test
// (role.test adds the role's sums; the pivot warp also computes round 0's
// rotations), then npad - 1 rounds (role.round), one barrier each.  Each
// role runs its own copy, so that one role's registers are not live in
// another's.
template <class Role>
__device__ __forceinline__ void drive(Common& cm, Role& role) {
  for (;;) {
    double up = 0.0, dg = 0.0;
    role.test(cm, up, dg);
    up = warp_sum(up);
    dg = warp_sum(dg);
    if (cm.lane == 0) {
      cm.red[cm.warp] = up;
      if (cm.warp == 0) cm.red[cm.NW] = dg;
    }
    __syncthreads();
    double usum = 0.0;
    for (int w = 0; w < cm.NW; ++w) usum = add(usum, cm.red[w]);
    const double off = mul(2.0, usum), tot = add(off, cm.red[cm.NW]);
    if (cm.probe && cm.fixed_sweeps > 0) {
      if (cm.sweeps == cm.fixed_sweeps) break;
    } else {
      if (off <= mul(mul(DBL_EPSILON, DBL_EPSILON), tot)) break;
      if (cm.sweeps == MAX_SWEEPS) {
        cm.status = 2;
        break;
      }
    }
    ++cm.sweeps;
    cm.b ^= 1;
    for (int r = 0; r < cm.mc; ++r) {
      // P[b] holds round r's rotations, D[b] the diagonal after round r
      const bool stamp = cm.stamps && cm.sweeps == 1 && cm.lane == 0;
      if (stamp) cm.stamps[(cm.warp * 64 + r) * 2] = clock64();
      role.round(cm, r, cm.P + cm.b * (NMAX / 2));
      if (stamp) cm.stamps[(cm.warp * 64 + r) * 2 + 1] = clock64();
      __syncthreads();
      double* tmp = cm.Acur;
      cm.Acur = cm.Anew;
      cm.Anew = tmp;
      if (r + 1 < cm.mc) cm.b ^= 1;
    }
  }
}

// Warp 0: each lane a slot k.  In the test P_0 from A directly; in round
// r the rotations of round r + 1 from the block of round r (its Plan).
struct PivotRole {
  Plan pl;
  const uint4* plans;
  bool skip_chain;

  __device__ __forceinline__ void test(Common& cm, double& up, double& dg) {
    const int k = cm.lane;
    if (k >= cm.m) return;
    int u, v;
    circle(0, k, cm.mc, u, v);
    const int p = min(u, v), q = max(u, v);
    const double apq = cm.Acur[p * LD + q], app = cm.D[cm.b * NMAX + p];
    const double aqq = cm.D[cm.b * NMAX + q];
    up = mul(apq, apq);
    dg = add(mul(app, app), mul(aqq, aqq));
    double c, s, t;
    rotation(app, aqq, apq, c, s, t);
    cm.P[(cm.b ^ 1) * (NMAX / 2) + k] = make_double2(c, u < v ? s : -s);
    cm.D[(cm.b ^ 1) * NMAX + p] = sub(app, mul(t, apq));
    cm.D[(cm.b ^ 1) * NMAX + q] = add(aqq, mul(t, apq));
  }

  __device__ __forceinline__ void round(Common& cm, int r,
                                        const double2* Pr) {
    const int k = cm.lane;
    if (k >= cm.m) return;
    if (r + 1 < cm.mc) {
      const double2 Pl = Pr[pl.lo], Ph = Pr[pl.hi];
      const double zuu = cm.Acur[pl.zuu], zuv = cm.Acur[pl.zuv];
      const double zvu = cm.Acur[pl.zvu], zvv = cm.Acur[pl.zvv];
      const double app = cm.D[cm.b * NMAX + pl.p];
      const double aqq = cm.D[cm.b * NMAX + pl.q];
      const uint4 wn = plans[(r + 1) * 32 + k];
      const double ru = rot_uv(Pl, pl.row_u, zuu, zvu);
      const double rv = rot_uv(Pl, pl.row_u, zuv, zvv);
      const double apq = rot_uv(Ph, pl.col_u, ru, rv);
      double c = 1.0, s = 0.0, t = 0.0;
      if (!skip_chain) rotation(app, aqq, apq, c, s, t);
      cm.P[(cm.b ^ 1) * (NMAX / 2) + k] = make_double2(c, pl.neg ? -s : s);
      cm.D[(cm.b ^ 1) * NMAX + pl.p] = sub(app, mul(t, apq));
      cm.D[(cm.b ^ 1) * NMAX + pl.q] = add(aqq, mul(t, apq));
      cm.Anew[pl.zero] = 0.0;         // the pair rotated in round r
      pl = unpack(wn);
    } else {
      cm.Anew[pl.zero] = 0.0;
      pl = unpack(plans[k]);
    }
  }
};

// A warp that only keeps the barriers.
struct IdleRole {
  __device__ __forceinline__ void test(Common&, double&, double&) {}
  __device__ __forceinline__ void round(Common&, int, const double2*) {}
};

// A row of V in registers (npad = NPAD): x[q] is V[row][(q + sh) mod mc],
// x[mc] V[row][mc]; o rounds since the last shift.
template <int NPAD, int U>
struct RowRole {
  double x[NPAD];
  int row, o, sh;
  bool skip;

  __device__ __forceinline__ void test(Common&, double&, double&) {}

  __device__ __forceinline__ void round(Common& cm, int, const double2* Pr) {
    if (skip || row >= cm.n) return;
    vround_at<NPAD, U>(o, x, Pr);
    if (++o == U) {
      if constexpr (U % (NPAD - 1) != 0)
        vshift<NPAD, U>(x, std::make_integer_sequence<int, NPAD - 2>{});
      o = 0;
      sh += U;
      if (sh >= NPAD - 1) sh -= NPAD - 1;
    }
  }
};

// An update thread: TA blocks (ta < tb) of slots of A, their pairs'
// indices in the current round; for the generic instance (GV) also KV
// (row, slot) tasks of V in shared memory.
template <int TA, bool GV>
struct UpdateRole {
  int ta[TA], tb[TA], ua[TA], va[TA], ub[TA], vb[TA];
  int vo[KV], vs[KV];
  double* V;
  bool skip_a, skip_v;

  __device__ __forceinline__ void test(Common& cm, double& up, double&) {
#pragma unroll
    for (int j = 0; j < TA; ++j) {
      if (ta[j] >= 0) {
        const double zuu = cm.Acur[at(ua[j], ub[j])];
        const double zuv = cm.Acur[at(ua[j], vb[j])];
        const double zvu = cm.Acur[at(va[j], ub[j])];
        const double zvv = cm.Acur[at(va[j], vb[j])];
        up = add(up, add(add(add(mul(zuu, zuu), mul(zuv, zuv)),
                             mul(zvu, zvu)), mul(zvv, zvv)));
      }
    }
  }

  __device__ __forceinline__ void round(Common& cm, int r,
                                        const double2* Pr) {
    if (!skip_a) {
      int iuu[TA], iuv[TA], ivu[TA], ivv[TA];
      double2 Pa[TA], Pb[TA];
      double zuu[TA], zuv[TA], zvu[TA], zvv[TA];
#pragma unroll
      for (int j = 0; j < TA; ++j) {
        if (ta[j] >= 0) {
          iuu[j] = at(ua[j], ub[j]);
          iuv[j] = at(ua[j], vb[j]);
          ivu[j] = at(va[j], ub[j]);
          ivv[j] = at(va[j], vb[j]);
          Pa[j] = Pr[ta[j]];
          Pb[j] = Pr[tb[j]];
          zuu[j] = cm.Acur[iuu[j]];
          zuv[j] = cm.Acur[iuv[j]];
          zvu[j] = cm.Acur[ivu[j]];
          zvv[j] = cm.Acur[ivv[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < TA; ++j) {
        if (ta[j] >= 0) {
          // rows by slot ta, then columns by slot tb
          const double ruu = rot_u(Pa[j], zuu[j], zvu[j]);
          const double rvu = rot_v(Pa[j], zuu[j], zvu[j]);
          const double ruv = rot_u(Pa[j], zuv[j], zvv[j]);
          const double rvv = rot_v(Pa[j], zuv[j], zvv[j]);
          cm.Anew[iuu[j]] = rot_u(Pb[j], ruu, ruv);
          cm.Anew[iuv[j]] = rot_v(Pb[j], ruu, ruv);
          cm.Anew[ivu[j]] = rot_u(Pb[j], rvu, rvv);
          cm.Anew[ivv[j]] = rot_v(Pb[j], rvu, rvv);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TA; ++j) {
      step(ta[j], cm.mc, ua[j], va[j]);
      step(tb[j], cm.mc, ub[j], vb[j]);
    }
    if constexpr (GV) {
      if (skip_v) return;
      // V's (row, slot) tasks, two at a time
#pragma unroll
      for (int h = 0; h < KV; h += 2) {
        int iu[2], iv[2];
        double2 Pv[2];
        double xu[2], xv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (vo[h + j] >= 0) {
            circle(r, vs[h + j], cm.mc, iu[j], iv[j]);
            Pv[j] = Pr[vs[h + j]];
            xu[j] = V[vo[h + j] + iu[j]];
            xv[j] = V[vo[h + j] + iv[j]];
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (vo[h + j] >= 0) {
            V[vo[h + j] + iu[j]] = rot_u(Pv[j], xu[j], xv[j]);
            V[vo[h + j] + iv[j]] = rot_v(Pv[j], xu[j], xv[j]);
          }
        }
      }
    }
  }
};

template <int NPAD, bool PROBE>
__global__ void __launch_bounds__(Shape<NPAD>::NT)
jacobi_eigh_kernel(const double* __restrict__ S, double* __restrict__ lam,
                   double* __restrict__ U, int* __restrict__ info, int n,
                   int flags, int fixed_sweeps) {
  using Sh = Shape<NPAD>;
  constexpr int NT = Sh::NT, TA = Sh::TA, NAT = Sh::NAT;
  extern __shared__ double smem[];
  double* A0 = smem;                                   // [NMAX][LD] upper
  using L = typename Sh::L;
  double* V = smem + L::V;                             // [NCAP][LD]
  int* rank = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                     L::RANK);                 // [NMAX]
  uint4* plans = reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem) +
                                          L::PLAN);            // [mc][32]

  const int g = blockIdx.x, tid = threadIdx.x;
  const int npad = NPAD ? NPAD : n + (n & 1);
  const double* Sg = S + (size_t)g * n * n;

  // A's upper triangle into both buffers (the probe's skipped updates read
  // the second), its diagonal into D[0], V = I in shared memory for the
  // generic instance
  bool bad = false;
  for (int e = tid; e < npad * npad; e += NT) {
    const int i = e / npad, j = e % npad;
    const double v = (i < n && j < n) ? Sg[i * n + j] : 0.0;
    bad = bad || !isfinite(v);
    if (i < j) A0[i * LD + j] = A0[Sh::NCAP * LD + i * LD + j] = v;
    if (i == j) smem[L::D + i] = v;
    if (!NPAD && i < n) V[i * LD + j] = i == j ? 1.0 : 0.0;
  }
  // the pivot lanes' Plans of every round
  for (int e = tid; e < (npad - 1) * (npad / 2); e += NT)
    plans[e / (npad / 2) * 32 + e % (npad / 2)] =
        pack(plan_of(e / (npad / 2), e % (npad / 2), npad - 1, npad / 2));
  const bool nonfinite = __syncthreads_or(bad);

  Common cm;
  cm.n = n;
  cm.m = npad / 2;
  cm.mc = npad - 1;
  cm.lane = tid & 31;
  cm.warp = tid >> 5;
  cm.NW = Sh::NW;
  cm.Acur = A0;
  cm.Anew = A0 + Sh::NCAP * LD;
  cm.P = reinterpret_cast<double2*>(smem + L::P);
  cm.D = smem + L::D;
  cm.red = smem + L::RED;
  cm.b = 0;
  cm.sweeps = 0;
  cm.status = nonfinite ? 1 : 0;
  cm.fixed_sweeps = fixed_sweeps;
  cm.probe = PROBE;
  // the probe's stamps: each warp's clock before and after its part of each
  // round of the first sweep, block 0's, into U (not written then)
  const bool stamps = PROBE && (flags & STAMPS);
  cm.stamps = stamps && g == 0 ? reinterpret_cast<long long*>(U) : nullptr;
  const bool skip_v = PROBE && (flags & SKIP_V);
  const bool skip_a = PROBE && (flags & SKIP_A);
  const bool skip_chain = PROBE && (flags & SKIP_CHAIN);

  if (!nonfinite) {
    if (cm.warp == 0) {
      PivotRole role;
      role.pl = unpack(plans[cm.lane]);
      role.plans = plans;
      role.skip_chain = skip_chain;
      drive(cm, role);
    } else if (Sh::IDLE4 && cm.warp == 4) {
      IdleRole role;
      drive(cm, role);
    } else if (cm.warp <= Sh::NVW) {
      if constexpr (NPAD > 0) {
        RowRole<NPAD, Sh::U> role;
        role.row = tid - 32;
        role.o = 0;
        role.sh = 0;
        role.skip = skip_v;
        vinit<NPAD>(role.x, role.row,
                    std::make_integer_sequence<int, NPAD>{});
        drive(cm, role);
        if (role.row < n)
          vstore<NPAD>(role.x, V + role.row * LD, role.sh,
                       std::make_integer_sequence<int, NPAD - 1>{});
      }
    } else {
      UpdateRole<TA, NPAD == 0> role;
      const int ut = tid - 32 * (1 + Sh::NVW + (Sh::IDLE4 && cm.warp > 4));
      const int m = cm.m, mc = cm.mc;
#pragma unroll
      for (int j = 0; j < TA; ++j) {
        role.ta[j] = role.tb[j] = -1;
        role.ua[j] = role.va[j] = role.ub[j] = role.vb[j] = 0;
        int w = ut + j * NAT;
        for (int a = 0; a < m && role.ta[j] < 0; ++a) {
          if (w < m - 1 - a) {
            role.ta[j] = a;
            role.tb[j] = a + 1 + w;
          }
          w -= m - 1 - a;
        }
        if (role.ta[j] >= 0) {
          circle(0, role.ta[j], mc, role.ua[j], role.va[j]);
          circle(0, role.tb[j], mc, role.ub[j], role.vb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KV; ++j) {
        const int w = ut + j * NAT;
        const bool ok = NPAD == 0 && w < n * m;
        role.vo[j] = ok ? (w % n) * LD : -1;
        role.vs[j] = ok ? w / n : 0;
      }
      role.V = V;
      role.skip_a = skip_a;
      role.skip_v = skip_v;
      drive(cm, role);
    }
  }

  // eigenvalues ascending (ties by index), U's columns in the same order
  const double* Df = cm.D + cm.b * NMAX;
  if (tid < n) {
    const double v = Df[tid];
    int k = 0;
    for (int i = 0; i < n; ++i) {
      const double u = Df[i];
      k += (u < v) || (u == v && i < tid);
    }
    rank[tid] = nonfinite ? tid : k;
  }
  __syncthreads();
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int e = tid; e < n * n && !stamps; e += NT) {
    const int i = e / n, j = e % n;
    U[(size_t)g * n * n + i * n + rank[j]] = nonfinite ? nan : V[i * LD + j];
  }
  if (tid < n) lam[(size_t)g * n + rank[tid]] = nonfinite ? nan : Df[tid];
  if (tid == 0) {
    info[2 * g] = cm.status;
    info[2 * g + 1] = cm.sweeps;
  }
}

template <int NPAD, bool PROBE>
int launch(const double* S, double* lam, double* U, int* info, int G, int n,
           int flags, int fixed_sweeps, cudaStream_t stream) {
  using Sh = Shape<NPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel<NPAD, PROBE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::L::BYTES);
  if (err != cudaSuccess) return (int)err;
  jacobi_eigh_kernel<NPAD, PROBE><<<G, Sh::NT, Sh::L::BYTES, stream>>>(
      S, lam, U, info, n, flags, fixed_sweeps);
  return (int)cudaGetLastError();
}

// rows of V in registers for npad 4, 20 and 60-64 (nucleotides, amino
// acids, the genetic codes' sense codons); every other order the generic
// instance.  The probe has two instances: npad 62 and the generic one.
template <bool PROBE>
int dispatch(const double* S, double* lam, double* U, int* info, int G,
             int n, int flags, int fixed_sweeps, void* stream) {
  if (n < 1 || n > NMAX || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int npad = n + (n & 1);
#define PAML_EIGH_LAUNCH(NPAD) \
  launch<NPAD, PROBE>(S, lam, U, info, G, n, flags, fixed_sweeps, st)
  if constexpr (PROBE) {
    return npad == 62 ? PAML_EIGH_LAUNCH(62) : PAML_EIGH_LAUNCH(0);
  } else {
    switch (npad) {
      case 4: return PAML_EIGH_LAUNCH(4);
      case 20: return PAML_EIGH_LAUNCH(20);
      case 60: return PAML_EIGH_LAUNCH(60);
      case 62: return PAML_EIGH_LAUNCH(62);
      case 64: return PAML_EIGH_LAUNCH(64);
      default: return PAML_EIGH_LAUNCH(0);
    }
  }
#undef PAML_EIGH_LAUNCH
}

}  // namespace

// S [G, n, n] symmetric, contiguous -> lam [G, n], U [G, n, n], info [G, 2]
// (status, sweeps); returns cudaGetLastError() after the launch.
extern "C" int paml_eigh_f64(const double* S, double* lam, double* U,
                             int* info, int G, int n, void* stream) {
  return dispatch<false>(S, lam, U, info, G, n, 0, 0, stream);
}

// The debug instance (npad 62, or the generic one): flags 1 skip V, 2
// skip the update of A, 4 skip the rotation chain (identity rotations), 8
// stamp the clock into U (block 0, the first sweep: [warp][round][before,
// after] as long long; U is not written); fixed_sweeps > 0 runs exactly
// that many sweeps whatever the test says.  Not on any path of the
// package.
extern "C" int paml_eigh_probe_f64(const double* S, double* lam, double* U,
                                   int* info, int G, int n, int flags,
                                   int fixed_sweeps, void* stream) {
  return dispatch<true>(S, lam, U, info, G, n, flags, fixed_sweeps, stream);
}
