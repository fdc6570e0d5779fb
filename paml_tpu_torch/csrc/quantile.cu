// The quantile code of the rate and omega distributions in float64: the
// regularized incomplete beta and gamma functions with their partial
// derivatives to second order, their inverses, and the median quantiles of
// the NSsites mixtures (plain C interface, built with nvcc and loaded with
// ctypes by paml_tpu_torch/_build.py; float64 only).
//
// Replaces, on the card, what the JAX package compiles with XLA into every
// jitted value + gradient: `betainc` (200 Lentz terms in a fori_loop,
// paml_tpu/core/dgamma.py:16-61), `gammaincinv` (:64-110), `betaincinv`
// (60 bisection and 5 Newton steps with an inverse-function JVP, :147-211),
// `discrete_gamma` / `discrete_beta` (:113, :214) through them, and
// `cdf_quantiles`' 70 halvings of the M6 / M9-M13 mixture CDFs
// (paml_tpu/apps/codeml.py:117-141).  It is not a TPU kernel.  No PyTorch
// call computes I_x(a, b), and torch.special.gammainc has no derivative in
// the shape, so the port's host route computed all of this on the CPU,
// which kept those models out of CUDA graphs.
//
// Entry points (the arithmetic of each is the plain version's,
// `paml_tpu_torch/core/cuda_quantile.py`):
// - paml_inc: elementwise I_x(a, b) (kind 0) or P(a, x) (kind 1): the value
//   and, by `order`, the partials in (a, b, x) and the 3 x 3 second
//   partials.  The a- and b-partials are forward-mode numbers (D<O>: value,
//   two first and three second partials) carried through the same
//   continued fraction / series as the value; the x-partials are the
//   density and its closed-form derivatives.  The symmetry switch, clamps
//   and 1e-300 floors of `_betainc_any` / `_gammainc_any`
//   (paml_tpu_torch/core/dgamma.py); a loop stops once its factor and the
//   factor's partials have been 1 (and 0) to the last bit for EXTRA terms,
//   within N_BETA_CF / N_GAMMA terms.
// - paml_inc_inv: x with I_x(p, q) = y (kind 0, x in [1e-12, 1 - 1e-12]) or
//   P(a, x) = y (kind 1), one warp per root.  Partials by the
//   inverse-function theorem with the JAX package's float64 safeguards (x
//   clipped to [1e-14, 1 - 1e-14], the sensitivities and 1 / pdf capped at
//   1e14), and their derivatives.
// - paml_mix_quantiles: the K median quantiles of the continuous part of
//   M6, M9-M13 (CDFdN_dS, src/codeml.c:2916-2983) from theta in device
//   memory, one warp per quantile: a bracket at least as narrow as
//   cdf_quantiles' 70 halvings, whose midpoint is returned (the caller's
//   two Newton steps carry the gradient).
// Each writes info[i] = {status, ops}: status 0 ok, 1 a non-finite input
// or result, 2 a series or continued fraction that did not converge within
// its terms (its last factor further than CONV_TOL from 1), or a mixture
// bracket still wider than the first design's after MIX_ROUNDS rounds; ops
// the FP64 additions, subtractions, multiplications and divisions of the
// series / fraction terms the element's result needed (Ops<O> below): the
// estimate's chain, lane 0's evaluations (a root's estimates, a mixture's
// one CDF a round), and the partials once.  The other lanes' bracket
// points are speculation that a root need not have, and the transcendental
// set-up of each evaluation is not counted, so this is a lower bound (the
// work count of cuda_quantile.kernel_work).
//
// What bounds it on the H100.  Nothing the card has in quantity: a call is
// at most a few thousand elements (BEB's 10 x 10 x 9 grid; ncatG roots for
// the fits) and a few thousand FP64 operations each; it waits on latency.
// The first design evaluated its fractions by modified Lentz,
// whose terms chain about six FP64 divisions (a reciprocal and its
// refinement each, hundreds of cycles of latency a term), and found a beta
// root in about 15 such fractions in sequence (6 rounds of multisection,
// up to 8 Newton steps, the partials), a mixture quantile in 14 rounds.
// This design shortens that chain three ways.
// 1. No division per term.  The fractions run as the forward recurrence of
//    their convergents, A_k = b_k A_k-1 + a_k A_k-2 (B_k alike), in FMAs:
//    the beta fraction after an equivalence transformation (b_k = a + k,
//    so that its partial numerators are polynomials with no quotient), the
//    gamma fraction with its terms divided by x (one reciprocal an
//    evaluation; its terms then stay near 1 whatever x), the gamma series
//    as a numerator and a denominator of its partial sum.  The four
//    numbers are rescaled by an exact power of two every RESCALE terms,
//    which changes no convergent.
//    A term stops the loop on a cross-multiplied difference of successive
//    convergents (|B_k A_k-1 - A_k B_k-1| < 4e-16 |A_k B_k-1|, Lentz's
//    |delta - 1| < 4e-16 without the quotient); only then are the factor's
//    partials formed, with one division, and held to 1e-15 on the scale of
//    the convergents' log-derivatives (term_done).  An evaluation ends in one
//    division, B / A.  Where Lentz guarded a vanishing denominator with
//    1e-30, the recurrence needs no guard: a convergent whose A or B
//    passes through 0 fails the stopping test and the loop goes on; a
//    result whose final A is 0 is not finite and says so (NONFINITE), and
//    a loop that ends unsettled still reports NOCONV.
// 2. Fewer evaluations in sequence.  A beta root starts from a closed
//    form (Abramowitz & Stegun 26.5.22 for p, q >= 1, the tails' power
//    laws otherwise, as in AS 109 / Numerical Recipes' invbetai), a gamma
//    root from the JAX package's Wilson-Hilferty and small-x starts; then
//    Halley steps, whose log-density derivative ((p - 1) / x - (q - 1) /
//    (1 - x), or a - x on log x) is closed-form, inside a bracket.  A step
//    that leaves the bracket or fails to halve the last step's size is
//    replaced by the bracket's midpoint; a step below 1e-9 x ends the root
//    (Halley's error after it is of the order of its cube).  A mixture
//    quantile takes two rounds of multisection, then Newton steps with the
//    mixture's density (closed form), each beside a cluster of points
//    around it; a cluster that misses the root hands the next round back
//    to the multisection, a second miss all the rest, so that the bracket
//    reaches the first design's width within MIX_ROUNDS (else NOCONV).
// 3. The lanes that repeated each other do real work.  In every round lane
//    0 evaluates the estimate and the other 31 lanes points of the bracket
//    (roots: a multisection of it; mixtures: the multisection or, once the
//    Newton steps run, a cluster of half-width twice the last step, at
//    least 8 ulps, around the estimate), so the bracket shrinks by 32 or
//    more beside each step, and a zero-density root (an M10 / M11 target
//    on the kink at omega = 1) is fenced in as by the first design's
//    rounds.  The partials stay one
//    evaluation that all lanes repeat (tools/torch_quantile_probe.py splits
//    a root's cycles: the share of the partials decides whether spreading
//    them over lanes would pay).
#include <cuda_runtime.h>
#include <math.h>

#ifdef PAML_QPROBE
// tools/torch_quantile_probe.py: lane 0 of each root's warp writes
// clock64() at the marks (0 the root's start, 1 its first round, 2 the
// root, 3 the partials)
__device__ long long paml_stamps[64 * 8];
#define STAMP(k)                                                          \
  do {                                                                    \
    const int r_ = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;          \
    if ((threadIdx.x & 31) == 0 && r_ < 64)                               \
      paml_stamps[r_ * 8 + (k)] = clock64();                              \
  } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

namespace {

constexpr int N_BETA_CF = 200;      // terms of the beta continued fraction
constexpr int N_GAMMA = 400;        // terms of the gamma series / fraction
constexpr int EXTRA = 8;            // converged terms before a loop stops
constexpr double CONV_TOL = 1e-12;  // the last factor's distance from 1
constexpr int RESCALE = 4;          // terms between rescalings
constexpr double X_LO = 1e-12, X_HI = 1.0 - 1e-12;
constexpr double CAP = 1e14;
constexpr int ROOT_ROUNDS = 12;     // rounds of a beta or gamma root
// a Halley step this small (relative to x, or to 1 - x for a beta root)
// ends a root: its error is of the order of the step cubed
constexpr double STEP_DONE = 1e-9;
constexpr double Y_LO = -690.0;     // a gamma root's log bracket (below)
// a mixture's rounds: the first design's 14 and three more, so that two
// cluster rounds that miss the root (after which the loop multisects) and
// the clusters' 32-fold narrowing (against 33) still reach its width
constexpr int MIX_ROUNDS = 17;
constexpr int MIX_SECTIONS = 2;     // multisection rounds before Newton
constexpr double MIX_LO = 1e-7, MIX_HI = 99.0;
// the width of the first design's final bracket, (99 - 1e-7) / 33^14
constexpr double MIX_WIDTH = 5.450546334289183e-20;
constexpr unsigned FULL = 0xffffffffu;
constexpr double SQRT2 = 1.4142135623730951, SQRT1_2 = 0.7071067811865476;
constexpr double INV_SQRT2PI = 0.3989422804014327;
// FP64 operations of one term of each loop at partials' order O = 0, 1, 2,
// counted from the code below: a D<O> sum costs 1 / 3 / 6, a product of
// two D<O> 1 / 7 / 26, a D<O> times a double 1 / 3 / 6, a double added 1,
// a negation 0, the stopping test's value 2, a rescaling (every RESCALE
// terms) its products spread over the terms.  The partials of a settled
// factor (a division, in the last EXTRA terms) are not counted.
template <int O>
struct Ops {
  static constexpr int beta_cf = O == 0 ? 30 : (O == 1 ? 112 : 345);
  static constexpr int gamma_series = O == 0 ? 8 : (O == 1 ? 22 : 63);
  static constexpr int gamma_cf = O == 0 ? 18 : (O == 1 ? 66 : 198);
};

enum { OK = 0, NONFINITE = 1, NOCONV = 2 };

// clamps that keep a NaN (as torch.clamp does)
__device__ __forceinline__ double clampd(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ double maxd(double v, double lo) {
  return v < lo ? lo : v;
}

// digamma and trigamma of x > 0: the recurrence up to x >= 10, then the
// asymptotic series (error below 1e-16 there)
__device__ double digamma(double x) {
  if (!(x > 0.0)) return NAN;
  double r = 0.0;
  while (x < 10.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  const double t = f * (-1.0 / 12 + f * (1.0 / 120 + f * (-1.0 / 252 + f * (
      1.0 / 240 + f * (-1.0 / 132 + f * (691.0 / 32760 + f * (-1.0 / 12)))))));
  return r + log(x) - 0.5 / x + t;
}

__device__ double trigamma(double x) {
  if (!(x > 0.0)) return NAN;
  double r = 0.0;
  while (x < 10.0) {
    r += 1.0 / (x * x);
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  const double t = f / x * (1.0 / 6 + f * (-1.0 / 30 + f * (1.0 / 42 + f * (
      -1.0 / 30 + f * (5.0 / 66 + f * (-691.0 / 2730 + f * (7.0 / 6)))))));
  return r + 1.0 / x + 0.5 * f + t;
}

// ---------------------------------------------------------------------------
// forward-mode numbers in two variables (a, b) to order O (0, 1 or 2)
// ---------------------------------------------------------------------------

template <int O>
struct D {
  double v, a, b, aa, ab, bb;
};

template <int O>
__device__ __forceinline__ D<O> cst(double v) {
  return D<O>{v, 0.0, 0.0, 0.0, 0.0, 0.0};
}

template <int O>
__device__ __forceinline__ D<O> seed(double v, int which) {
  D<O> r = cst<O>(v);
  if (which == 0) r.a = 1.0; else r.b = 1.0;
  return r;
}

// f(u), from f and its first two derivatives at u.v
template <int O>
__device__ __forceinline__ D<O> chain(const D<O>& u, double f0, double f1,
                                      double f2) {
  D<O> r = cst<O>(f0);
  if constexpr (O >= 1) {
    r.a = f1 * u.a;
    r.b = f1 * u.b;
  }
  if constexpr (O >= 2) {
    r.aa = f2 * u.a * u.a + f1 * u.aa;
    r.ab = f2 * u.a * u.b + f1 * u.ab;
    r.bb = f2 * u.b * u.b + f1 * u.bb;
  }
  return r;
}

template <int O>
__device__ __forceinline__ D<O> operator+(const D<O>& u, const D<O>& w) {
  return D<O>{u.v + w.v, u.a + w.a, u.b + w.b, u.aa + w.aa, u.ab + w.ab,
              u.bb + w.bb};
}
template <int O>
__device__ __forceinline__ D<O> operator+(const D<O>& u, double s) {
  D<O> r = u;
  r.v = u.v + s;
  return r;
}
template <int O>
__device__ __forceinline__ D<O> operator+(double s, const D<O>& u) {
  D<O> r = u;
  r.v = s + u.v;
  return r;
}
template <int O>
__device__ __forceinline__ D<O> operator-(const D<O>& u) {
  return D<O>{-u.v, -u.a, -u.b, -u.aa, -u.ab, -u.bb};
}
template <int O>
__device__ __forceinline__ D<O> operator-(const D<O>& u, const D<O>& w) {
  return D<O>{u.v - w.v, u.a - w.a, u.b - w.b, u.aa - w.aa, u.ab - w.ab,
              u.bb - w.bb};
}
template <int O>
__device__ __forceinline__ D<O> operator-(const D<O>& u, double s) {
  D<O> r = u;
  r.v = u.v - s;
  return r;
}
template <int O>
__device__ __forceinline__ D<O> operator-(double s, const D<O>& u) {
  D<O> r = -u;
  r.v = s - u.v;
  return r;
}
template <int O>
__device__ __forceinline__ D<O> operator*(const D<O>& u, const D<O>& w) {
  D<O> r = cst<O>(u.v * w.v);
  if constexpr (O >= 1) {
    r.a = u.a * w.v + u.v * w.a;
    r.b = u.b * w.v + u.v * w.b;
  }
  if constexpr (O >= 2) {
    r.aa = u.aa * w.v + 2.0 * u.a * w.a + u.v * w.aa;
    r.ab = u.ab * w.v + u.a * w.b + u.b * w.a + u.v * w.ab;
    r.bb = u.bb * w.v + 2.0 * u.b * w.b + u.v * w.bb;
  }
  return r;
}
template <int O>
__device__ __forceinline__ D<O> operator*(const D<O>& u, double s) {
  return D<O>{u.v * s, u.a * s, u.b * s, u.aa * s, u.ab * s, u.bb * s};
}
template <int O>
__device__ __forceinline__ D<O> operator/(const D<O>& u, const D<O>& w) {
  const double q = u.v / w.v;
  D<O> r = cst<O>(q);
  if constexpr (O >= 1) {
    r.a = (u.a - q * w.a) / w.v;
    r.b = (u.b - q * w.b) / w.v;
  }
  if constexpr (O >= 2) {
    r.aa = (u.aa - 2.0 * r.a * w.a - q * w.aa) / w.v;
    r.ab = (u.ab - r.a * w.b - r.b * w.a - q * w.ab) / w.v;
    r.bb = (u.bb - 2.0 * r.b * w.b - q * w.bb) / w.v;
  }
  return r;
}

template <int O>
__device__ __forceinline__ D<O> dlog(const D<O>& u) {
  return chain(u, log(u.v), 1.0 / u.v, -1.0 / (u.v * u.v));
}
template <int O>
__device__ __forceinline__ D<O> dexp(const D<O>& u) {
  const double e = exp(u.v);
  return chain(u, e, e, e);
}
// lgamma, from its value lg at u.v (computed by the caller)
template <int O>
__device__ __forceinline__ D<O> dlgamma(const D<O>& u, double lg) {
  return chain(u, lg, O >= 1 ? digamma(u.v) : 0.0,
               O >= 2 ? trigamma(u.v) : 0.0);
}

// One term of a convergent loop whose factor is 1 + U / Y (U, Y forward-
// mode numbers): the factor is 1 to the last bit when |U| < 4e-16 |Y|, and
// only then are its partials formed (one division) and each held to 1e-15
// (1 + |the same partial of Y / Y|): the recurrences carry A and B, whose
// log-derivatives grow with the terms, and the factor's partials are their
// differences, 0 only to the rounding of that scale (Lentz's ratios keep it
// near 1); `cnt` counts the consecutive terms that pass, and the loop stops
// once it reaches EXTRA; `diff` and `den` keep the last term's |U| and |Y|
// (a loop that ends with |U| > CONV_TOL |Y| did not converge).
__device__ __forceinline__ bool settled(double f, double y, double yv) {
  return fabs(f) < 1e-15 * (1.0 + fabs(y / yv));
}
template <int O>
__device__ __forceinline__ bool term_done(const D<O>& U, const D<O>& Y,
                                          int& cnt, double& diff,
                                          double& den) {
  diff = fabs(U.v);
  den = fabs(Y.v);
  bool ok = diff < 4e-16 * den;
  if constexpr (O >= 1) {
    if (ok) {
      const D<O> f = U / Y;
      ok = settled(f.a, Y.a, Y.v) && settled(f.b, Y.b, Y.v);
      if constexpr (O >= 2)
        ok = ok && settled(f.aa, Y.aa, Y.v) && settled(f.ab, Y.ab, Y.v)
            && settled(f.bb, Y.bb, Y.v);
    }
  }
  cnt = ok ? cnt + 1 : 0;
  return cnt >= EXTRA;
}

__device__ __forceinline__ void conv_status(double diff, double den,
                                            int& st) {
  if (!(diff <= CONV_TOL * den)) st = max(st, (int)NOCONV);
}

// 2^-e with e the exponent of the larger of |u| and |w| (1 for 0 or a
// non-finite number): the rescaling of a recurrence, exact in every
// component
__device__ __forceinline__ double pow2_scale(double u, double w) {
  int e = 0;
  const double m = fmax(fabs(u), fabs(w));
  if (m > 0.0 && isfinite(m)) frexp(m, &e);
  return ldexp(1.0, -e);
}

// h = B / A of the beta fraction after an equivalence transformation: b_0 =
// 1, b_k = aa + k, a_1 = -(aa + bb) xx, a_2m = m (bb - m) xx, a_2m+1 =
// -(aa + m)(aa + bb + m) xx (Numerical Recipes' betacf has d_k = a_k /
// ((aa + k - 1)(aa + k)) over b_k = 1: the same convergents)
template <int O>
__device__ D<O> beta_cf(const D<O>& aa, const D<O>& bb, double xx, int& st,
                        int& ops) {
  const D<O> qab = aa + bb;
  D<O> Ap = cst<O>(1.0), Bp = cst<O>(1.0);                   // k = 0
  D<O> Ac = (aa + 1.0) - qab * xx, Bc = aa + 1.0;           // k = 1
  int cnt = 0, n = 0;
  double diff = INFINITY, den = 0.0;
  for (int m = 1; m < N_BETA_CF; ++m) {
    ++n;
    const double fm = m;
    const D<O> e = (bb - fm) * (fm * xx);                   // a_2m
    const D<O> be = aa + 2.0 * fm;
    D<O> An = be * Ac + e * Ap, Bn = be * Bc + e * Bp;
    Ap = Ac; Bp = Bc; Ac = An; Bc = Bn;
    const D<O> o = -((aa + fm) * (qab + fm)) * xx;          // a_2m+1
    const D<O> bo = aa + (2.0 * fm + 1.0);
    An = bo * Ac + o * Ap;
    Bn = bo * Bc + o * Bp;
    // the factor h_2m+1 / h_2m = (Bn Ac) / (An Bc)
    const D<O> Y = An * Bc;
    const D<O> U = Bn * Ac - Y;
    Ap = Ac; Bp = Bc; Ac = An; Bc = Bn;
    const bool done = term_done(U, Y, cnt, diff, den);
    if (m % RESCALE == 0) {
      const double s = pow2_scale(Ac.v, Bc.v);
      Ac = Ac * s; Bc = Bc * s; Ap = Ap * s; Bp = Bp * s;
    }
    if (done) break;
  }
  ops += n * Ops<O>::beta_cf;
  conv_status(diff, den, st);
  return Bc / Ac;
}

// I_x(a, b) with partials in (a, b); `clamped` set when the result was
// clipped to [0, 1] (its partials then 0); lnB = lgamma(a) + lgamma(b) -
// lgamma(a + b), the caller's
template <int O>
__device__ D<O> betainc_d(double a, double b, double lnB, double x, int& st,
                          int& ops, bool& clamped) {
  const bool sym = x > (a + 1.0) / (a + b + 2.0);
  const D<O> A = seed<O>(a, 0), B = seed<O>(b, 1);
  const D<O> aa = sym ? B : A, bb = sym ? A : B;
  const double xx = clampd(sym ? 1.0 - x : x, 0.0, 1.0 - 1e-16);
  D<O> lnb = cst<O>(lnB);
  if constexpr (O >= 1)
    lnb = dlgamma(aa, lgamma(aa.v)) + dlgamma(bb, lgamma(bb.v))
        - dlgamma(aa + bb, lgamma(aa.v + bb.v));
  const D<O> lnfront = aa * log(maxd(xx, 1e-300)) + bb * log1p(-xx)
      - dlog(aa) - lnb;
  const D<O> res = dexp(lnfront) * beta_cf(aa, bb, xx, st, ops);
  const D<O> out = sym ? 1.0 - res : res;
  clamped = out.v < 0.0 || out.v > 1.0;
  if (out.v < 0.0) return cst<O>(0.0);
  if (out.v > 1.0) return cst<O>(1.0);
  return out;
}

// P(a, x) with partials in a (the b components stay 0): the series for
// x < a + 1, else the continued fraction of Q = 1 - P; lg = lgamma(a)
template <int O>
__device__ D<O> gammainc_d(double a, double lg, double x0, int& st, int& ops,
                           bool& clamped) {
  const D<O> A = seed<O>(a, 0);
  const double x = maxd(x0, 1e-300);
  const double lx = log(x);
  const D<O> front = dexp(-x + A * lx - dlgamma(A, lg));
  D<O> out;
  int cnt = 0, n = 0;
  double diff = INFINITY, den = 0.0;
  if (x0 < a + 1.0) {
    // sum_k x^k / (a (a + 1) ... (a + k)) as N / Q, the term as P / Q
    D<O> ap = A, Q = A, N = cst<O>(1.0);
    double P = 1.0;
    for (int k = 0; k < N_GAMMA; ++k) {
      ++n;
      ap = ap + 1.0;
      P = P * x;
      N = N * ap + P;
      Q = Q * ap;
      const bool done = term_done(cst<O>(P), N, cnt, diff, den);
      if ((k + 1) % RESCALE == 0) {
        const double s = pow2_scale(N.v, Q.v);
        N = N * s; Q = Q * s; P = P * s;
      }
      if (done) break;
    }
    ops += n * Ops<O>::gamma_series;
    out = N / Q * front;
  } else {
    // h = 1 / (b_0 + a_1 / (b_1 + ...)), b_i = x + 1 - a + 2i, a_i = -i (i -
    // a), after the equivalence transformation by 1 / x (b_i / x, a_i / x^2:
    // terms near 1, whatever x): h = B / A / x
    const double rx = 1.0 / x;
    D<O> bcf = x + 1.0 - A;
    D<O> Ap = cst<O>(1.0), Bp = cst<O>(0.0), Ac = bcf * rx, Bc = cst<O>(1.0);
    for (int i = 1; i < N_GAMMA; ++i) {
      ++n;
      const double fi = i;
      const D<O> an = (fi - A) * (-fi * rx * rx);
      bcf = bcf + 2.0;
      const D<O> bi = bcf * rx;
      const D<O> An = bi * Ac + an * Ap, Bn = bi * Bc + an * Bp;
      // the factor h_i / h_i-1 = (Bn Ac) / (An Bc)
      const D<O> Y = An * Bc;
      const D<O> U = Bn * Ac - Y;
      Ap = Ac; Bp = Bc; Ac = An; Bc = Bn;
      const bool done = term_done(U, Y, cnt, diff, den);
      if (i % RESCALE == 0) {
        const double s = pow2_scale(Ac.v, Bc.v);
        Ac = Ac * s; Bc = Bc * s; Ap = Ap * s; Bp = Bp * s;
      }
      if (done) break;
    }
    ops += n * Ops<O>::gamma_cf;
    out = 1.0 - front * (Bc / Ac * rx);
  }
  conv_status(diff, den, st);
  clamped = out.v < 0.0 || out.v > 1.0 || x0 <= 0.0;
  if (x0 <= 0.0 || out.v < 0.0) return cst<O>(0.0);
  if (out.v > 1.0) return cst<O>(1.0);
  return out;
}

__device__ __forceinline__ double beta_lnB(double p, double q) {
  return lgamma(p) + lgamma(q) - lgamma(p + q);
}

// the values, from the caller's lgamma terms
__device__ __forceinline__ double beta_v(double p, double q, double lnB,
                                         double x, int& st, int& ops) {
  bool cl;
  return betainc_d<0>(p, q, lnB, x, st, ops, cl).v;
}
__device__ __forceinline__ double gamma_v(double a, double lg, double x,
                                          int& st, int& ops) {
  bool cl;
  return gammainc_d<0>(a, lg, x, st, ops, cl).v;
}

__device__ __forceinline__ double beta_logpdf(double p, double q, double x) {
  return (p - 1.0) * log(x) + (q - 1.0) * log1p(-x) - beta_lnB(p, q);
}

// ---------------------------------------------------------------------------
// paml_inc: one thread per element
// ---------------------------------------------------------------------------

template <int O>
__global__ void inc_kernel(int kind, const double* __restrict__ A,
                           const double* __restrict__ B,
                           const double* __restrict__ X, int n,
                           double* __restrict__ val, double* __restrict__ d1,
                           double* __restrict__ d2, int* __restrict__ info) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double a = A[i], b = kind == 0 ? B[i] : 1.0, x = X[i];
  int st = OK, ops = 0;
  bool clamped = false;
  D<O> r = cst<O>(NAN);
  if (isfinite(a) && isfinite(b) && isfinite(x))
    r = kind == 0 ? betainc_d<O>(a, b, beta_lnB(a, b), x, st, ops, clamped)
                  : gammainc_d<O>(a, lgamma(a), x, st, ops, clamped);
  if (!isfinite(r.v)) st = NONFINITE;
  val[i] = r.v;
  info[2 * i] = st;
  info[2 * i + 1] = ops;
  if constexpr (O >= 1) {
    // the x-partials: the density and its derivatives, 0 where the result
    // was clamped or x lies outside the support
    const bool inside = !clamped && x > 0.0 && (kind == 1 || x < 1.0);
    double L = 0.0, pdf = 0.0;
    if (inside) {
      L = kind == 0 ? beta_logpdf(a, b, x) : (a - 1.0) * log(x) - x
          - lgamma(a);
      pdf = exp(L);
    }
    d1[3 * i] = r.a;
    d1[3 * i + 1] = kind == 0 ? r.b : 0.0;
    d1[3 * i + 2] = pdf;
    if constexpr (O >= 2) {
      double ax = 0.0, bx = 0.0, xxp = 0.0;
      if (inside) {
        if (kind == 0) {
          const double dab = digamma(a + b);
          ax = pdf * (log(x) - digamma(a) + dab);
          bx = pdf * (log1p(-x) - digamma(b) + dab);
          xxp = pdf * ((a - 1.0) / x - (b - 1.0) / (1.0 - x));
        } else {
          ax = pdf * (log(x) - digamma(a));
          xxp = pdf * ((a - 1.0) / x - 1.0);
        }
      }
      const double bb = kind == 0 ? r.bb : 0.0, ab = kind == 0 ? r.ab : 0.0;
      double* h = d2 + 9 * i;
      h[0] = r.aa; h[1] = ab; h[2] = ax;
      h[3] = ab;   h[4] = bb; h[5] = bx;
      h[6] = ax;   h[7] = bx; h[8] = xxp;
    }
  }
}

// ---------------------------------------------------------------------------
// the warp's rounds: lane 0 the estimate, the other lanes the bracket
// ---------------------------------------------------------------------------

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o; o >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o; o >>= 1) v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The bracket [lo, hi] on the root's axis after a round: hi the smallest
// point whose residual f was not below 0 (a NaN counts as not below, as the
// first design's ballot did), lo the largest point below it whose f was
// (so that residuals out of order by rounding keep lo <= hi, and a round of
// ordered points narrows as the first design's first-not-below rule).
__device__ __forceinline__ void narrow(double t, double f, double& lo,
                                       double& hi) {
  hi = fmin(hi, warp_min(f < 0.0 ? INFINITY : t));
  lo = fmax(lo, warp_max(f < 0.0 && t < hi ? t : -INFINITY));
}

__device__ __forceinline__ double logistic(double t) {
  return 1.0 / (1.0 + exp(-t));
}

// the start of a beta root (AS 26.5.22 for p, q >= 1; the tails' power
// laws otherwise: Numerical Recipes' invbetai)
__device__ double beta_start(double p, double q, double y) {
  double x;
  if (p >= 1.0 && q >= 1.0) {
    const double pp = y < 0.5 ? y : 1.0 - y;
    const double t = sqrt(-2.0 * log(pp));
    double z = (2.30753 + t * 0.27061) / (1.0 + t * (0.99229 + t * 0.04481))
        - t;
    if (y < 0.5) z = -z;
    const double al = (z * z - 3.0) / 6.0;
    const double h = 2.0 / (1.0 / (2.0 * p - 1.0) + 1.0 / (2.0 * q - 1.0));
    const double w = z * sqrt(al + h) / h - (1.0 / (2.0 * q - 1.0)
        - 1.0 / (2.0 * p - 1.0)) * (al + 5.0 / 6.0 - 2.0 / (3.0 * h));
    x = p / (p + q * exp(2.0 * w));
  } else {
    const double lna = log(p / (p + q)), lnb = log(q / (p + q));
    const double t = exp(p * lna) / p, u = exp(q * lnb) / q, w = t + u;
    x = y < t / w ? pow(p * w * y, 1.0 / p)
                  : 1.0 - pow(q * w * (1.0 - y), 1.0 / q);
  }
  return isfinite(x) ? clampd(x, X_LO, X_HI) : 0.5;
}

// x with I_x(p, q) = y in [X_LO, X_HI]: Halley steps in x from the start,
// the bracket on the logit of x; `par` counts the operations of this
// lane's own points (lane 0's: the estimates)
__device__ double beta_root(double p, double q, double y, int lane, int& st,
                            int& par) {
  const double lnB = beta_lnB(p, q);
  // the logits of X_LO and X_HI as the steps' own are computed, so that a
  // root clamped to either end lies in the bracket
  double tlo = log(X_LO) - log1p(-X_LO), thi = log(X_HI) - log1p(-X_HI);
  double x = beta_start(p, q, y), prev = INFINITY;
  for (int r = 0; r < ROOT_ROUNDS; ++r) {
    const double w = (thi - tlo) / 32.0;
    const double t = lane == 0 ? log(x) - log1p(-x) : tlo + lane * w;
    const double xl = lane == 0 ? x : logistic(t);
    const double f = beta_v(p, q, lnB, xl, st, par) - y;
    narrow(t, f, tlo, thi);
    if (r == 0) STAMP(1);
    // Halley from the estimate (every lane alike)
    const double f0 = __shfl_sync(FULL, f, 0);
    const double u = f0 / maxd(exp((p - 1.0) * log(x) + (q - 1.0) * log1p(-x)
                                   - lnB), 1e-300);
    const double c = u * ((p - 1.0) / x - (q - 1.0) / (1.0 - x));
    const double xn = clampd(x - u / (1.0 - 0.5 * fmin(1.0, c)), X_LO, X_HI);
    const double tn = log(xn) - log1p(-xn);
    const double step = fabs(xn - x);
    if (isfinite(xn) && tn >= tlo && tn <= thi && step <= 0.5 * prev) {
      x = xn;
      prev = step;
      if (!(step > STEP_DONE * fmin(x, 1.0 - x))) break;
    } else {
      x = clampd(logistic(0.5 * (tlo + thi)), X_LO, X_HI);
      prev = INFINITY;
    }
  }
  return x;
}

// x with P(a, x) = p: Halley steps on log x from the better of the JAX
// package's two starts (lane 0 evaluates Wilson-Hilferty's, lane 1 the
// series' first term in the first round), the bracket on log x
__device__ double gamma_root(double a, double p, int lane, int& st,
                             int& par) {
  const double lg = lgamma(a);
  const double z = SQRT2 * erfinv(2.0 * p - 1.0);
  const double g = 2.0 / (9.0 * a);
  const double c3 = 1.0 - g + z * sqrt(g);
  const double y_wh = log(maxd(a * (c3 * c3 * c3), 1e-300));
  const double y_sm = (log(p) + lgamma(a + 1.0)) / a;
  // log x from 1e-300 to beyond any quantile below 1 - 1e-16
  double ylo = Y_LO, yhi = log(2.0 * a + 40.0 * sqrt(a) + 800.0);
  double y = clampd(y_wh, ylo, yhi), prev = INFINITY;
  for (int r = 0; r < ROOT_ROUNDS; ++r) {
    const double w = (yhi - ylo) / 32.0;
    const double t = lane == 0 ? y : (r == 0 && lane == 1 ? y_sm
                                                          : ylo + lane * w);
    const double f = gamma_v(a, lg, exp(t), st, par) - p;
    narrow(t, f, ylo, yhi);
    double f0 = __shfl_sync(FULL, f, 0);
    if (r == 0) {
      const double f1 = __shfl_sync(FULL, f, 1);
      if (fabs(f1) < fabs(f0)) {
        y = y_sm;
        f0 = f1;
      }
      STAMP(1);
    }
    // Halley on log x: f' = x pdf, f'' / f' = a - x
    const double x = exp(y);
    const double u = f0 / maxd(exp(a * y - x - lg), 1e-300);
    const double c = u * (a - x);
    const double yn = y - clampd(u / (1.0 - 0.5 * fmin(1.0, c)), -2.0, 2.0);
    const double step = fabs(yn - y);
    if (isfinite(yn) && yn >= ylo && yn <= yhi && step <= 0.5 * prev) {
      y = yn;
      prev = step;
      if (!(step > STEP_DONE * fmax(1.0, fabs(y)))) break;
    } else {
      y = 0.5 * (ylo + yhi);
      prev = INFINITY;
    }
  }
  return exp(y);
}

template <int O>
__global__ void inc_inv_kernel(int kind, const double* __restrict__ P,
                               const double* __restrict__ Q,
                               const double* __restrict__ Y, int n,
                               double* __restrict__ xout,
                               double* __restrict__ d1,
                               double* __restrict__ d2,
                               int* __restrict__ info) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= n) return;                 // whole warps
  const double p = P[i], q = kind == 0 ? Q[i] : 1.0, y = Y[i];
  int st = OK, par = 0, ser = 0;
  double x = NAN;
  STAMP(0);
  if (isfinite(p) && isfinite(q) && isfinite(y))
    x = kind == 0 ? beta_root(p, q, y, lane, st, par)
                  : gamma_root(p, y, lane, st, par);
  if (!isfinite(x)) st = NONFINITE;
  STAMP(2);
  // the partials (every lane alike; lane 0 writes)
  double f1[3] = {0.0, 0.0, 0.0}, f2[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                           0.0, 0.0, 0.0};
  if constexpr (O >= 1) {
    if (st != NONFINITE) {
      bool cl;
      double Ex[3][3] = {{0.0}};     // explicit partials of F_i in (p, q, y)
      double Xx[3] = {0.0, 0.0, 0.0};  // partials of F_i in x
      if (kind == 0) {
        const double xc = clampd(x, 1e-14, 1.0 - 1e-14);
        const D<O> I = betainc_d<O>(p, q, 0.0, xc, st, ser, cl);
        const double L = beta_logpdf(p, q, xc);
        const double pdf = exp(clampd(L, -80.0, 80.0));
        const double inv = 1.0 / maxd(pdf, 1.0 / CAP);
        const double Ac = isfinite(I.a) ? clampd(I.a, -CAP, CAP)
                                        : (isnan(I.a) ? 0.0 : copysign(CAP, I.a));
        const double Bc = isfinite(I.b) ? clampd(I.b, -CAP, CAP)
                                        : (isnan(I.b) ? 0.0 : copysign(CAP, I.b));
        f1[0] = -Ac * inv;
        f1[1] = -Bc * inv;
        f1[2] = inv;
        if constexpr (O >= 2) {
          const double dxc = (x >= 1e-14 && x <= 1.0 - 1e-14) ? 1.0 : 0.0;
          const double dpq = digamma(p + q);
          const double Lp = log(xc) - digamma(p) + dpq;
          const double Lq = log1p(-xc) - digamma(q) + dpq;
          const double Lx = ((p - 1.0) / xc - (q - 1.0) / (1.0 - xc)) * dxc;
          const bool Lin = L >= -80.0 && L <= 80.0;
          const bool free_inv = pdf >= 1.0 / CAP;
          // partials of inv in (p, q, x)
          const double ip = (Lin && free_inv) ? -inv * Lp : 0.0;
          const double iq = (Lin && free_inv) ? -inv * Lq : 0.0;
          const double ix = (Lin && free_inv) ? -inv * Lx : 0.0;
          const double raw = exp(L);
          const bool fa = isfinite(I.a) && fabs(I.a) <= CAP;
          const bool fb = isfinite(I.b) && fabs(I.b) <= CAP;
          const double Ap = fa ? I.aa : 0.0, Aq = fa ? I.ab : 0.0;
          const double Ax = fa ? raw * Lp * dxc : 0.0;
          const double Bp = fb ? I.ab : 0.0, Bq = fb ? I.bb : 0.0;
          const double Bx = fb ? raw * Lq * dxc : 0.0;
          Ex[0][0] = -(Ap * inv + Ac * ip);
          Ex[0][1] = -(Aq * inv + Ac * iq);
          Xx[0] = -(Ax * inv + Ac * ix);
          Ex[1][0] = -(Bp * inv + Bc * ip);
          Ex[1][1] = -(Bq * inv + Bc * iq);
          Xx[1] = -(Bx * inv + Bc * ix);
          Ex[2][0] = ip;
          Ex[2][1] = iq;
          Xx[2] = ix;
        }
      } else {
        const double lg = lgamma(p);
        const D<O> Pd = gammainc_d<O>(p, lg, x, st, ser, cl);
        const double L = (p - 1.0) * log(x) - x - lg;
        const double inv = exp(-L);
        f1[0] = -Pd.a * inv;
        f1[2] = inv;
        if constexpr (O >= 2) {
          const double La = log(x) - digamma(p);
          const double Lx = (p - 1.0) / x - 1.0;
          const double ia = -inv * La, ix = -inv * Lx;
          const double Pax = exp(L) * La;
          Ex[0][0] = -(Pd.aa * inv + Pd.a * ia);
          Xx[0] = -(Pax * inv + Pd.a * ix);
          Ex[2][0] = ia;
          Xx[2] = ix;
        }
      }
      if constexpr (O >= 2) {
        for (int r = 0; r < 3; ++r)
          for (int j = 0; j < 3; ++j)
            f2[3 * r + j] = Ex[r][j] + Xx[r] * f1[j];
      }
    }
  }
  STAMP(3);
  st = __reduce_max_sync(FULL, st);
  if (lane == 0) {
    xout[i] = x;
    info[2 * i] = st;
    info[2 * i + 1] = par + ser;
    if constexpr (O >= 1)
      for (int j = 0; j < 3; ++j) d1[3 * i + j] = f1[j];
    if constexpr (O >= 2)
      for (int j = 0; j < 9; ++j) d2[9 * i + j] = f2[j];
  }
}

// ---------------------------------------------------------------------------
// paml_mix_quantiles: one warp (a block) per quantile
// ---------------------------------------------------------------------------

__device__ __forceinline__ double ndtr(double z) {
  return 0.5 * erfc(-z * SQRT1_2);
}
__device__ __forceinline__ double npdf(double z) {
  return INV_SQRT2PI * exp(-0.5 * z * z);
}

// the parameters of one mixture (`codeml.nssites_mixture_cdf`'s layout)
// and the lgamma terms of its beta and gamma parts
struct Mix {
  int model;
  double t[6];
  double lnB, lg1, lg2;
};

__device__ __forceinline__ double bcdf(const Mix& m, double x, int& st,
                                       int& ops) {
  return beta_v(m.t[1], m.t[2], m.lnB, clampd(x, 1e-12, 1.0 - 1e-12), st,
                ops);
}
__device__ __forceinline__ double bpdf(const Mix& m, double x) {
  return x > 1e-12 && x < 1.0 - 1e-12
      ? exp((m.t[1] - 1.0) * log(x) + (m.t[2] - 1.0) * log1p(-x) - m.lnB)
      : 0.0;
}
__device__ __forceinline__ double gcdf(double a, double b, double lg,
                                       double x, int& st, int& ops) {
  return gamma_v(a, lg, b * maxd(x, 0.0), st, ops);
}
__device__ __forceinline__ double gpdf(double a, double b, double lg,
                                       double x) {
  return x > 0.0 ? b * exp((a - 1.0) * log(b * x) - b * x - lg) : 0.0;
}

// the CDF of the continuous part of the omega distribution
// (`codeml.nssites_mixture_cdf`)
__device__ double mix_cdf(const Mix& m, double x, int& st, int& ops) {
  const double* t = m.t;
  switch (m.model) {
    case 6:    // 2gamma: p0, a1, b1, a2 (= b2)
      return t[0] * gcdf(t[1], t[2], m.lg1, x, st, ops)
          + (1.0 - t[0]) * gcdf(t[3], t[3], m.lg2, x, st, ops);
    case 9:    // beta&gamma: p0, p, q, a, b
      return t[0] * bcdf(m, x, st, ops)
          + (1.0 - t[0]) * gcdf(t[3], t[4], m.lg1, x, st, ops);
    case 10:   // beta&gamma+1
      return x <= 1.0 ? t[0] * bcdf(m, x, st, ops)
                      : t[0] + (1.0 - t[0]) * gcdf(t[3], t[4], m.lg1,
                                                   x - 1.0, st, ops);
    case 11: { // beta&normal>1: p0, p, q, mu, s
      const double z1 = maxd(ndtr((t[3] - 1.0) / t[4]), 1e-12);
      return x <= 1.0 ? t[0] * bcdf(m, x, st, ops)
                      : t[0] + (1.0 - t[0])
                          * (1.0 - ndtr((t[3] - x) / t[4]) / z1);
    }
    case 12: { // 0&2normal (continuous part): p0, p1, mu2, s1, s2
      const double p1 = t[1], mu2 = t[2], s1 = t[3], s2 = t[4];
      return 1.0 - p1 * ndtr(-(x - 1.0) / s1) / ndtr(1.0 / s1)
          - (1.0 - p1) * ndtr(-(x - mu2) / s2) / maxd(ndtr(mu2 / s2), 1e-12);
    }
    default: { // 13, 3normal: t0, t1 (transformed), mu2, s0, s1, s2
      const double e0 = exp(t[0]), e1 = exp(t[1]);
      const double z = e0 + e1 + 1.0;
      const double f0 = e0 / z, f1 = e1 / z, f2 = 1.0 - f0 - f1;
      const double mu2 = t[2], s0 = t[3], s1 = t[4], s2 = t[5];
      return 1.0 - f0 * 2.0 * ndtr(-x / s0)
          - f1 * ndtr(-(x - 1.0) / s1) / ndtr(1.0 / s1)
          - f2 * ndtr(-(x - mu2) / s2) / maxd(ndtr(mu2 / s2), 1e-12);
    }
  }
}

// its density (0 where mix_cdf clamps), for the Newton steps
__device__ double mix_pdf(const Mix& m, double x) {
  const double* t = m.t;
  switch (m.model) {
    case 6:
      return t[0] * gpdf(t[1], t[2], m.lg1, x)
          + (1.0 - t[0]) * gpdf(t[3], t[3], m.lg2, x);
    case 9:
      return t[0] * bpdf(m, x) + (1.0 - t[0]) * gpdf(t[3], t[4], m.lg1, x);
    case 10:
      return x <= 1.0 ? t[0] * bpdf(m, x)
                      : (1.0 - t[0]) * gpdf(t[3], t[4], m.lg1, x - 1.0);
    case 11: {
      const double z1 = maxd(ndtr((t[3] - 1.0) / t[4]), 1e-12);
      return x <= 1.0 ? t[0] * bpdf(m, x)
                      : (1.0 - t[0]) * npdf((t[3] - x) / t[4]) / (t[4] * z1);
    }
    case 12: {
      const double p1 = t[1], mu2 = t[2], s1 = t[3], s2 = t[4];
      return p1 * npdf((x - 1.0) / s1) / (s1 * ndtr(1.0 / s1))
          + (1.0 - p1) * npdf((x - mu2) / s2)
          / (s2 * maxd(ndtr(mu2 / s2), 1e-12));
    }
    default: {
      const double e0 = exp(t[0]), e1 = exp(t[1]);
      const double z = e0 + e1 + 1.0;
      const double f0 = e0 / z, f1 = e1 / z, f2 = 1.0 - f0 - f1;
      const double mu2 = t[2], s0 = t[3], s1 = t[4], s2 = t[5];
      return f0 * 2.0 * npdf(x / s0) / s0
          + f1 * npdf((x - 1.0) / s1) / (s1 * ndtr(1.0 / s1))
          + f2 * npdf((x - mu2) / s2) / (s2 * maxd(ndtr(mu2 / s2), 1e-12));
    }
  }
}

// the next double above v
__device__ __forceinline__ double next_up(double v) {
  return ::nextafter(v, static_cast<double>(INFINITY));
}

__global__ void mix_kernel(int model, const double* __restrict__ theta,
                           int ntheta, int K, double* __restrict__ xout,
                           int* __restrict__ info) {
  const int lane = threadIdx.x, k = blockIdx.x;
  Mix m;
  m.model = model;
  int st = OK, ops = 0;
  for (int j = 0; j < 6; ++j) {
    m.t[j] = j < ntheta ? theta[j] : 0.0;
    if (!isfinite(m.t[j])) st = NONFINITE;
  }
  // the lgamma terms of the beta (p, q) and gamma (shape) parts
  m.lnB = (model == 9 || model == 10 || model == 11)
      ? beta_lnB(m.t[1], m.t[2]) : 0.0;
  m.lg1 = model == 6 ? lgamma(m.t[1])
      : (model == 9 || model == 10 ? lgamma(m.t[3]) : 0.0);
  m.lg2 = model == 6 ? lgamma(m.t[3]) : 0.0;
  const double target = (k + 0.5) / K;
  STAMP(0);
  double lo = MIX_LO, hi = MIX_HI;
  double xe = NAN, step = 0.0;       // the Newton estimate and its step
  bool tight = false;
  int misses = 0;                    // cluster rounds that missed the root
  for (int r = 0; r < MIX_ROUNDS; ++r) {
    const bool cluster = !isnan(xe);
    const double w0 = hi - lo;
    double x;
    if (!cluster) {                  // the first design's 33-section
      x = lo + (lane + 1) * ((hi - lo) / 33.0);
    } else {                         // the estimate, a cluster around it
      const double half = fmax(2.0 * step, 8.0 * (next_up(xe) - xe));
      const double clo = fmax(lo, xe - half), chi = fmin(hi, xe + half);
      x = lane == 0 ? xe : clo + lane * ((chi - clo) / 32.0);
    }
    const double c = mix_cdf(m, x, st, ops);
    if (isnan(c)) st = NONFINITE;
    const double f = c - target;
    narrow(x, f, lo, hi);
    if (r == 0) STAMP(1);
    tight = !(hi > next_up(lo)) || hi - lo <= MIX_WIDTH;
    if (tight) break;
    // a cluster that missed the root (the crossing a few ulps off it, or
    // a flat stretch of F, where the Newton steps wander): one 33-section
    // round after the first miss, only 33-section rounds after the second
    const bool missed = cluster && hi - lo > w0 / 32.0;
    misses += missed;
    // Newton from the point nearest the target (the lowest lane of a tie)
    double best = isnan(f) ? INFINITY : fabs(f);
    int bl = lane;
    for (int o = 16; o; o >>= 1) {
      const double ob = __shfl_xor_sync(FULL, best, o);
      const int ol = __shfl_xor_sync(FULL, bl, o);
      if (ob < best || (ob == best && ol < bl)) {
        best = ob;
        bl = ol;
      }
    }
    const double xb = __shfl_sync(FULL, x, bl);
    const double fb = __shfl_sync(FULL, f, bl);
    // (a finite step kept in the bracket: near the root F's rounding can
    // put the point of least |F - target| a few ulps off the crossing; a
    // point of zero density gives none, and the next round multisects)
    const double xn = xb - fb / mix_pdf(m, xb);
    xe = NAN;
    if (!missed && misses < 2 && r + 1 >= MIX_SECTIONS && isfinite(xn)) {
      xe = clampd(xn, lo, hi);
      step = fabs(xe - xb);
    }
  }
  STAMP(3);
  st = __reduce_max_sync(FULL, st);
  // a bracket wider than the first design's final one did not converge
  if (!tight && st == OK) st = NOCONV;
  if (lane == 0) {
    xout[k] = 0.5 * (lo + hi);
    info[2 * k] = st;
    info[2 * k + 1] = ops;
  }
}

__global__ void polygamma_kernel(const double* __restrict__ x, int n,
                                 double* __restrict__ psi,
                                 double* __restrict__ psi1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  psi[i] = digamma(x[i]);
  psi1[i] = trigamma(x[i]);
}

}  // namespace

// digamma and trigamma as the kernels compute them, for a check against
// torch.special; on no path of the package
extern "C" int paml_polygamma_f64(const double* x, int n, double* psi,
                                  double* psi1, void* stream) {
  if (n <= 0) return 0;
  polygamma_kernel<<<(n + 127) / 128, 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, n, psi, psi1);
  return (int)cudaGetLastError();
}

#ifdef PAML_QPROBE
// the marks of the last launch, copied to `out` [64 x 8] and cleared
extern "C" int paml_quantile_stamps(long long* out) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, paml_stamps);
  if (e == cudaSuccess)
    e = cudaMemcpy(out, p, sizeof(long long) * 64 * 8,
                   cudaMemcpyDeviceToHost);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) * 64 * 8);
  return (int)e;
}
#endif

extern "C" int paml_inc_f64(int kind, int order, const double* a,
                            const double* b, const double* x, int n,
                            double* val, double* d1, double* d2, int* info,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + 127) / 128), block(128);
  switch (order) {
    case 0: inc_kernel<0><<<grid, block, 0, s>>>(kind, a, b, x, n, val, d1,
                                                  d2, info); break;
    case 1: inc_kernel<1><<<grid, block, 0, s>>>(kind, a, b, x, n, val, d1,
                                                  d2, info); break;
    case 2: inc_kernel<2><<<grid, block, 0, s>>>(kind, a, b, x, n, val, d1,
                                                  d2, info); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int paml_inc_inv_f64(int kind, int order, const double* p,
                                const double* q, const double* y, int n,
                                double* x, double* d1, double* d2, int* info,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + 3) / 4), block(128);     // four roots a block
  switch (order) {
    case 0: inc_inv_kernel<0><<<grid, block, 0, s>>>(kind, p, q, y, n, x, d1,
                                                      d2, info); break;
    case 1: inc_inv_kernel<1><<<grid, block, 0, s>>>(kind, p, q, y, n, x, d1,
                                                      d2, info); break;
    case 2: inc_inv_kernel<2><<<grid, block, 0, s>>>(kind, p, q, y, n, x, d1,
                                                      d2, info); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int paml_mix_quantiles_f64(int model, const double* theta,
                                      int ntheta, int K, double* x,
                                      int* info, void* stream) {
  if (K <= 0) return 0;
  if (ntheta > 6) return (int)cudaErrorInvalidValue;
  mix_kernel<<<K, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      model, theta, ntheta, K, x, info);
  return (int)cudaGetLastError();
}
