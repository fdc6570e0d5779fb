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
//   and 1e-30 guards of `_betainc_any` / `_gammainc_any`
//   (paml_tpu_torch/core/dgamma.py); the loop stops once the factor and its
//   partials have been 1 (and 0) to the last bit for EXTRA terms, within
//   N_BETA_CF / N_GAMMA terms.
// - paml_inc_inv: x with I_x(p, q) = y (kind 0, x in [1e-12, 1 - 1e-12]) or
//   P(a, x) = y (kind 1), one warp per root.  Beta: BETA_ROUNDS rounds of
//   multisection on the logit of x (32 lanes, 32 points, 5 bits a round),
//   then guarded Newton; gamma: the JAX package's Wilson-Hilferty or
//   small-x start (the two evaluated on two lanes), Newton on log x, then a
//   plain Newton polish.  Partials by the inverse-function theorem with the
//   JAX package's float64 safeguards (x clipped to [1e-14, 1 - 1e-14], the
//   sensitivities and 1 / pdf capped at 1e14), and their derivatives.
// - paml_mix_quantiles: the K median quantiles of the continuous part of
//   M6, M9-M13 (CDFdN_dS, src/codeml.c:2916-2983) from theta in device
//   memory, one warp per quantile: MIX_ROUNDS rounds of multisection on
//   [1e-7, 99], at least as narrow as cdf_quantiles' 70 halvings; the
//   midpoint is returned (the caller's two Newton steps carry the
//   gradient).
// Each writes info[i] = {status, ops}: status 0 ok, 1 a non-finite input
// or result, 2 a series or continued fraction that did not converge within
// its terms (its last factor further than 1e-12 from 1); ops the FP64
// additions, subtractions, multiplications and divisions of the series /
// fraction terms the element's result needed (Ops<O> below), each distinct
// evaluation counted once: every lane's multisection points, but the
// steps that all lanes of a warp repeat alike (Newton, the partials) once.
// The transcendental set-up of each evaluation is not counted, so this
// is a lower bound (the work count of cuda_quantile.kernel_work).
//
// What bounds it on the H100.  Nothing the card has in quantity: a call is
// at most a few thousand elements (BEB's 10 x 10 x 9 grid; ncatG roots
// for the fits), 34 to 424 operations per term (Ops<O>).  It waits on
// the latency of the fraction's chain of dependent FP64 divisions (up to
// 200 terms, some 20 on the fits' inputs).  So a
// root is spread over a warp: 32 points a round of multisection instead
// of one of bisection, and a few serial Newton evaluations after that.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_BETA_CF = 200;      // terms of the beta continued fraction
constexpr int N_GAMMA = 400;        // terms of the gamma series / fraction
constexpr int EXTRA = 8;            // converged terms before a loop stops
constexpr double CONV_TOL = 1e-12;  // the last factor's distance from 1
constexpr double TINY = 1e-30;
constexpr double X_LO = 1e-12, X_HI = 1.0 - 1e-12;
constexpr double CAP = 1e14;
constexpr int BETA_ROUNDS = 6;      // logit multisection rounds, beta root
constexpr int BETA_NEWTON = 8;
constexpr int LOG_NEWTON = 40;      // gamma root: Newton on log x
constexpr int POLISH = 4;
constexpr int MIX_ROUNDS = 14;      // 33^14 > 2^70
constexpr double MIX_LO = 1e-7, MIX_HI = 99.0;
constexpr unsigned FULL = 0xffffffffu;
constexpr double SQRT2 = 1.4142135623730951, SQRT1_2 = 0.7071067811865476;
// FP64 operations of one term of each loop at partials' order O = 0, 1, 2,
// counted from the code below: a D<O> sum costs 1 / 3 / 6, a product or
// quotient of two D<O> 1 / 7 / 26 (a double divided by a D<O> is one), a
// D<O> times or over a double 1 / 3 / 6, a double added 1, a negation 0
template <int O>
struct Ops {
  static constexpr int beta_cf = O == 0 ? 34 : (O == 1 ? 130 : 424);
  static constexpr int gamma_series = O == 0 ? 7 : (O == 1 ? 23 : 67);
  static constexpr int gamma_cf = O == 0 ? 11 : (O == 1 ? 47 : 151);
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
__device__ __forceinline__ D<O> operator*(double s, const D<O>& u) {
  return D<O>{s * u.v, s * u.a, s * u.b, s * u.aa, s * u.ab, s * u.bb};
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
__device__ __forceinline__ D<O> operator/(const D<O>& u, double s) {
  return D<O>{u.v / s, u.a / s, u.b / s, u.aa / s, u.ab / s, u.bb / s};
}
template <int O>
__device__ __forceinline__ D<O> operator/(double s, const D<O>& w) {
  return cst<O>(s) / w;
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
template <int O>
__device__ __forceinline__ D<O> dlgamma(const D<O>& u) {
  return chain(u, lgamma(u.v), O >= 1 ? digamma(u.v) : 0.0,
               O >= 2 ? trigamma(u.v) : 0.0);
}
// |z| < 1e-30 replaced by 1e-30 (the Lentz safeguard)
template <int O>
__device__ __forceinline__ D<O> guard(const D<O>& u) {
  return fabs(u.v) < TINY ? cst<O>(TINY) : u;
}

// One term of a convergent loop: `cnt` counts the consecutive terms whose
// factor f was 1 to the last bit with partials 0 (the host route's test);
// the loop stops once cnt reaches EXTRA.  `last` keeps the factor's value:
// a loop that ends with it further than CONV_TOL from 1 did not converge
// (rounding keeps a converged factor within a few ulps of 1, not always
// within the stopping test's 4e-16).
template <int O>
__device__ __forceinline__ bool term_done(const D<O>& f, int& cnt,
                                          double& last) {
  bool ok = fabs(f.v - 1.0) < 4e-16;
  if constexpr (O >= 1) ok = ok && fabs(f.a) < 1e-15 && fabs(f.b) < 1e-15;
  if constexpr (O >= 2)
    ok = ok && fabs(f.aa) < 1e-15 && fabs(f.ab) < 1e-15 && fabs(f.bb) < 1e-15;
  cnt = ok ? cnt + 1 : 0;
  last = f.v;
  return cnt >= EXTRA;
}

__device__ __forceinline__ void conv_status(double last, int& st) {
  if (!(fabs(last - 1.0) <= CONV_TOL)) st = max(st, (int)NOCONV);
}

// I_x(a, b) with partials in (a, b); `clamped` set when the result was
// clipped to [0, 1] (its partials then 0)
template <int O>
__device__ D<O> betainc_d(double a, double b, double x, int& st, int& ops,
                          bool& clamped) {
  const bool sym = x > (a + 1.0) / (a + b + 2.0);
  const D<O> A = seed<O>(a, 0), B = seed<O>(b, 1);
  const D<O> aa = sym ? B : A, bb = sym ? A : B;
  const double xx = clampd(sym ? 1.0 - x : x, 0.0, 1.0 - 1e-16);
  const D<O> lnfront = aa * log(maxd(xx, 1e-300)) + bb * log1p(-xx)
      - dlog(aa) - (dlgamma(aa) + dlgamma(bb) - dlgamma(aa + bb));
  const D<O> qab = aa + bb, qap = aa + 1.0, qam = aa - 1.0;
  D<O> c = cst<O>(1.0);
  D<O> d = 1.0 / guard(1.0 - qab * xx / qap);
  D<O> h = d;
  int cnt = 0, n = 0;
  double last = 0.0;
  for (int m = 1; m < N_BETA_CF; ++m) {
    ++n;
    const double fm = m;
    D<O> num = fm * (bb - fm) * xx / ((qam + 2.0 * fm) * (aa + 2.0 * fm));
    d = 1.0 / guard(1.0 + num * d);
    c = 1.0 + num / guard(c);
    h = h * d * c;
    num = -(aa + fm) * (qab + fm) * xx / ((aa + 2.0 * fm) * (qap + 2.0 * fm));
    d = 1.0 / guard(1.0 + num * d);
    c = 1.0 + num / guard(c);
    const D<O> delta = d * c;
    h = h * delta;
    if (term_done(delta, cnt, last)) break;
  }
  ops += n * Ops<O>::beta_cf;
  conv_status(last, st);
  const D<O> res = dexp(lnfront) * h;
  const D<O> out = sym ? 1.0 - res : res;
  clamped = out.v < 0.0 || out.v > 1.0;
  if (out.v < 0.0) return cst<O>(0.0);
  if (out.v > 1.0) return cst<O>(1.0);
  return out;
}

// P(a, x) with partials in a (the b components stay 0): the series for
// x < a + 1, else the continued fraction of Q = 1 - P
template <int O>
__device__ D<O> gammainc_d(double a, double x0, int& st, int& ops,
                           bool& clamped) {
  const D<O> A = seed<O>(a, 0);
  const double x = maxd(x0, 1e-300);
  const double lx = log(x);
  D<O> out;
  int cnt = 0, n = 0;
  double last = 0.0;
  if (x0 < a + 1.0) {
    D<O> ap = A, term = 1.0 / A, total = term;
    for (int k = 0; k < N_GAMMA; ++k) {
      ++n;
      ap = ap + 1.0;
      term = term * x / ap;
      total = total + term;
      if (term_done(1.0 + term / total, cnt, last)) break;
    }
    ops += n * Ops<O>::gamma_series;
    out = total * dexp(-x + A * lx - dlgamma(A));
  } else {
    D<O> bcf = x + 1.0 - A;
    D<O> c = cst<O>(1.0 / TINY);
    D<O> d = 1.0 / guard(bcf);
    D<O> h = d;
    for (int i = 1; i < N_GAMMA; ++i) {
      ++n;
      const double fi = i;
      const D<O> an = -fi * (fi - A);
      bcf = bcf + 2.0;
      d = 1.0 / guard(an * d + bcf);
      c = guard(bcf + an / c);
      const D<O> delta = d * c;
      h = h * delta;
      if (term_done(delta, cnt, last)) break;
    }
    ops += n * Ops<O>::gamma_cf;
    out = 1.0 - dexp(-x + A * lx - dlgamma(A)) * h;
  }
  conv_status(last, st);
  clamped = out.v < 0.0 || out.v > 1.0 || x0 <= 0.0;
  if (x0 <= 0.0 || out.v < 0.0) return cst<O>(0.0);
  if (out.v > 1.0) return cst<O>(1.0);
  return out;
}

template <int O>
__device__ __forceinline__ D<O> inc_d(int kind, double a, double b, double x,
                                      int& st, int& ops, bool& clamped) {
  return kind == 0 ? betainc_d<O>(a, b, x, st, ops, clamped)
                   : gammainc_d<O>(a, x, st, ops, clamped);
}

__device__ __forceinline__ double inc_v(int kind, double a, double b,
                                        double x, int& st, int& ops) {
  bool cl;
  return inc_d<0>(kind, a, b, x, st, ops, cl).v;
}

__device__ __forceinline__ double beta_logpdf(double p, double q, double x) {
  return (p - 1.0) * log(x) + (q - 1.0) * log1p(-x)
      - (lgamma(p) + lgamma(q) - lgamma(p + q));
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
    r = inc_d<O>(kind, a, b, x, st, ops, clamped);
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
// paml_inc_inv: one warp per root
// ---------------------------------------------------------------------------

// `par` counts the operations of this lane's own multisection points, `ser`
// those that every lane repeats alike
__device__ double beta_root(double p, double q, double y, int lane, int& st,
                            int& par, int& ser) {
  double tlo = log(X_LO) - log1p(-X_LO), thi = -tlo;
  for (int r = 0; r < BETA_ROUNDS; ++r) {
    const double w = (thi - tlo) / 33.0;
    const double t = tlo + (lane + 1) * w;
    const double f = inc_v(0, p, q, 1.0 / (1.0 + exp(-t)), st, par);
    const unsigned below = __ballot_sync(FULL, f < y);
    const int first = __ffs(~below) - 1;        // -1: every point below
    const int k = first < 0 ? 32 : first;
    const double nlo = tlo + k * w;
    thi = k == 32 ? thi : tlo + (k + 1) * w;
    tlo = nlo;
  }
  double x = clampd(1.0 / (1.0 + exp(-0.5 * (tlo + thi))), X_LO, X_HI);
  const double lnB = lgamma(p) + lgamma(q) - lgamma(p + q);
  for (int it = 0; it < BETA_NEWTON; ++it) {
    const double f = inc_v(0, p, q, x, st, ser) - y;
    const double logpdf = (p - 1.0) * log(x) + (q - 1.0) * log1p(-x) - lnB;
    double xn = clampd(x - f / maxd(exp(logpdf), 1e-300), X_LO, X_HI);
    if (isnan(xn)) xn = x;
    const bool moved = fabs(xn - x) > 4e-16 * x;
    x = xn;
    if (!moved) break;
  }
  return x;
}

__device__ double gamma_root(double a, double p, int lane, int& st, int& par,
                             int& ser) {
  const double lg = lgamma(a);
  const double z = SQRT2 * erfinv(2.0 * p - 1.0);
  const double g = 2.0 / (9.0 * a);
  const double c = 1.0 - g + z * sqrt(g);
  const double x_wh = maxd(a * (c * c * c), 1e-300);
  const double x_sm = exp((log(p) + lgamma(a + 1.0)) / a);
  // the better of the two starts (lane 0 tries one, lane 1 the other; the
  // other lanes repeat theirs)
  int start = 0;
  const double e = fabs(inc_v(1, a, 0.0, (lane & 1) ? x_sm : x_wh, st,
                              start) - p);
  if (lane < 2) par += start;
  const double e_wh = __shfl_sync(FULL, e, 0), e_sm = __shfl_sync(FULL, e, 1);
  const double x0 = e_sm < e_wh ? x_sm : x_wh;
  double y = log(maxd(x0, 1e-300));
  const double logp = log(p);
  for (int it = 0; it < LOG_NEWTON; ++it) {
    const double x = exp(y);
    const double F = maxd(inc_v(1, a, 0.0, x, st, ser), 1e-300);
    const double step = clampd((log(F) - logp) * F * exp(-(a * y - x - lg)),
                               -2.0, 2.0);
    const double yn = y - step;
    if (isfinite(yn)) y = yn;
    if (!(fabs(step) > 1e-10)) break;
  }
  for (int it = 0; it < POLISH; ++it) {
    const double x = exp(y);
    const double f = inc_v(1, a, 0.0, x, st, ser) - p;
    const double step = clampd(f * exp(-(a * y - x - lg)), -1.0, 1.0);
    const double yn = y - step;
    if (isfinite(yn)) y = yn;
    if (!(fabs(step) > 4e-16 * fmax(1.0, fabs(y)))) break;
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
  if (isfinite(p) && isfinite(q) && isfinite(y))
    x = kind == 0 ? beta_root(p, q, y, lane, st, par, ser)
                  : gamma_root(p, y, lane, st, par, ser);
  if (!isfinite(x)) st = NONFINITE;
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
        const D<O> I = betainc_d<O>(p, q, xc, st, ser, cl);
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
        const D<O> Pd = gammainc_d<O>(p, x, st, ser, cl);
        const double L = (p - 1.0) * log(x) - x - lgamma(p);
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
  st = __reduce_max_sync(FULL, st);
  par = __reduce_add_sync(FULL, par);
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

__device__ __forceinline__ double bcdf(double p, double q, double x, int& st,
                                       int& ops) {
  return inc_v(0, p, q, clampd(x, 1e-12, 1.0 - 1e-12), st, ops);
}

__device__ __forceinline__ double gcdf(double a, double b, double x, int& st,
                                       int& ops) {
  return inc_v(1, a, 0.0, b * maxd(x, 0.0), st, ops);
}

// the CDF of the continuous part of the omega distribution
// (`codeml.nssites_mixture_cdf`, the same parameter layout)
__device__ double mix_cdf(int model, const double* t, double x, int& st,
                          int& ops) {
  switch (model) {
    case 6:    // 2gamma: p0, a1, b1, a2 (= b2)
      return t[0] * gcdf(t[1], t[2], x, st, ops)
          + (1.0 - t[0]) * gcdf(t[3], t[3], x, st, ops);
    case 9:    // beta&gamma: p0, p, q, a, b
      return t[0] * bcdf(t[1], t[2], x, st, ops)
          + (1.0 - t[0]) * gcdf(t[3], t[4], x, st, ops);
    case 10:   // beta&gamma+1
      return x <= 1.0 ? t[0] * bcdf(t[1], t[2], x, st, ops)
                      : t[0] + (1.0 - t[0]) * gcdf(t[3], t[4], x - 1.0, st,
                                                   ops);
    case 11: { // beta&normal>1: p0, p, q, mu, s
      const double z1 = maxd(ndtr((t[3] - 1.0) / t[4]), 1e-12);
      return x <= 1.0 ? t[0] * bcdf(t[1], t[2], x, st, ops)
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

__global__ void mix_kernel(int model, const double* __restrict__ theta,
                           int ntheta, int K, double* __restrict__ xout,
                           int* __restrict__ info) {
  const int lane = threadIdx.x, k = blockIdx.x;
  double t[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int st = OK, ops = 0;
  for (int j = 0; j < ntheta; ++j) {
    t[j] = theta[j];
    if (!isfinite(t[j])) st = NONFINITE;
  }
  const double target = (k + 0.5) / K;
  double lo = MIX_LO, hi = MIX_HI;
  for (int r = 0; r < MIX_ROUNDS; ++r) {
    const double w = (hi - lo) / 33.0;
    const double c = mix_cdf(model, t, lo + (lane + 1) * w, st, ops);
    if (isnan(c)) st = NONFINITE;
    const unsigned below = __ballot_sync(FULL, c < target);
    const int first = __ffs(~below) - 1;
    const int kk = first < 0 ? 32 : first;
    const double nlo = lo + kk * w;
    hi = kk == 32 ? hi : lo + (kk + 1) * w;
    lo = nlo;
  }
  st = __reduce_max_sync(FULL, st);
  ops = __reduce_add_sync(FULL, ops);
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
