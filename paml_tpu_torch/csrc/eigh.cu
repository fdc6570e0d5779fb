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
// Design: one block per matrix of order n <= 64 (codons 61, amino acids
// 20, nucleotides 4), A and the accumulated rotations V in shared memory.
// A sweep is npad - 1 rounds of the round-robin (circle) ordering over
// npad = n rounded up to even indices (a padded index is a zero row and
// column: its rotations are the identity); the npad / 2 rotations of a
// round touch disjoint index pairs, so each round is one phase that
// computes them and one that applies them, A' = J^T A J as 2 x 2 blocks
// over pairs of pairs (the upper block and its transpose written by one
// thread, so A stays exactly symmetric) and V' = V J.  Convergence is
// tested on the card before each sweep: the off-diagonal sum of squares
// at most DBL_EPSILON^2 times the whole.  Every product and sum is rounded
// on its own (no fused multiply-add), in the order of the plain version
// (`cuda_eigh.jacobi_plain`), so the two agree to the last bit when they
// take the same number of sweeps.  Eigenvalues ascending, eigenvectors as
// U's columns, as torch.linalg.eigh.
//
// Bound: about 6 n^3 operations per sweep, a few microseconds of the
// card's FP64 rate for the three to eight matrices of a codon model: the
// kernel is bound by latency (a division and two square roots, then two
// barriers, per round), not by its operations or its bytes.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 64;          // largest order
constexpr int LD = NMAX + 1;      // row stride in shared memory
constexpr int NT = 512;           // threads per block
constexpr int MAX_SWEEPS = 30;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the k-th pair of round r of the circle method over npad indices: index
// npad - 1 fixed, the others turning on a circle of m = npad - 1
__device__ __forceinline__ void pair_of(int r, int k, int m, int* p, int* q) {
  int a, b;
  if (k == 0) {
    a = r;
    b = m;
  } else {
    a = (r + k) % m;
    b = (r - k + m) % m;
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

// sum over the block of each thread's v, in a fixed order (the same bits
// on every run); every thread gets the result
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = add(red[threadIdx.x],
                                                red[threadIdx.x + s]);
    __syncthreads();
  }
  double out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(NT)
jacobi_eigh_kernel(const double* __restrict__ S, double* __restrict__ lam,
                   double* __restrict__ U, int* __restrict__ info, int n) {
  extern __shared__ double smem[];
  double* A = smem;                    // [NMAX][LD]
  double* V = A + NMAX * LD;           // [NMAX][LD]
  double* rc = V + NMAX * LD;          // [NMAX / 2] cosines
  double* rs = rc + NMAX / 2;          // sines
  double* rt = rs + NMAX / 2;          // tangents
  double* red = rt + NMAX / 2;         // [NT] reduction scratch
  int* rp = reinterpret_cast<int*>(red + NT);   // [NMAX / 2] pairs
  int* rq = rp + NMAX / 2;
  int* rank = rq + NMAX / 2;           // [NMAX]

  const int g = blockIdx.x, tid = threadIdx.x;
  const int npad = n + (n & 1), m = npad / 2, rounds = npad - 1;
  const double* Sg = S + (size_t)g * n * n;

  bool bad = false;
  for (int e = tid; e < npad * npad; e += NT) {
    const int i = e / npad, j = e % npad;
    const double v = (i < n && j < n) ? Sg[i * n + j] : 0.0;
    bad = bad || !isfinite(v);
    A[i * LD + j] = v;
    V[i * LD + j] = i == j ? 1.0 : 0.0;
  }
  const bool nonfinite = __syncthreads_or(bad);

  int status = nonfinite ? 1 : 0, sweeps = 0;
  while (!nonfinite) {
    double off = 0.0, tot = 0.0;
    for (int e = tid; e < npad * npad; e += NT) {
      const int i = e / npad, j = e % npad;
      const double a2 = mul(A[i * LD + j], A[i * LD + j]);
      tot = add(tot, a2);
      if (i != j) off = add(off, a2);
    }
    off = block_sum(off, red);
    tot = block_sum(tot, red);
    if (off <= mul(mul(DBL_EPSILON, DBL_EPSILON), tot)) break;
    if (sweeps == MAX_SWEEPS) {
      status = 2;
      break;
    }
    ++sweeps;
    for (int r = 0; r < rounds; ++r) {
      if (tid < m) {
        int p, q;
        pair_of(r, tid, rounds, &p, &q);
        const double apq = A[p * LD + q];
        double c = 1.0, s = 0.0, t = 0.0;
        if (apq != 0.0) {
          const double tau = sub(A[q * LD + q], A[p * LD + p]) / mul(2.0, apq);
          const double sg = tau >= 0.0 ? 1.0 : -1.0;
          t = sg / add(fabs(tau), sqrt(add(1.0, mul(tau, tau))));
          c = 1.0 / sqrt(add(1.0, mul(t, t)));
          s = mul(t, c);
        }
        rp[tid] = p;
        rq[tid] = q;
        rc[tid] = c;
        rs[tid] = s;
        rt[tid] = t;
      }
      __syncthreads();
      // A' = J^T A J, one 2 x 2 block (a, b), a <= b, per task
      for (int w = tid; w < m * m; w += NT) {
        const int a = w / m, b = w % m;
        if (a > b) continue;
        const int pa = rp[a], qa = rq[a], pb = rp[b], qb = rq[b];
        if (a == b) {
          const double apq = A[pa * LD + qa], t = rt[a];
          A[pa * LD + pa] = sub(A[pa * LD + pa], mul(t, apq));
          A[qa * LD + qa] = add(A[qa * LD + qa], mul(t, apq));
          A[pa * LD + qa] = 0.0;
          A[qa * LD + pa] = 0.0;
          continue;
        }
        const double ca = rc[a], sa = rs[a], cb = rc[b], sb = rs[b];
        const double x00 = A[pa * LD + pb], x01 = A[pa * LD + qb];
        const double x10 = A[qa * LD + pb], x11 = A[qa * LD + qb];
        const double r00 = sub(mul(ca, x00), mul(sa, x10));
        const double r01 = sub(mul(ca, x01), mul(sa, x11));
        const double r10 = add(mul(sa, x00), mul(ca, x10));
        const double r11 = add(mul(sa, x01), mul(ca, x11));
        const double n00 = sub(mul(cb, r00), mul(sb, r01));
        const double n01 = add(mul(sb, r00), mul(cb, r01));
        const double n10 = sub(mul(cb, r10), mul(sb, r11));
        const double n11 = add(mul(sb, r10), mul(cb, r11));
        A[pa * LD + pb] = n00;
        A[pa * LD + qb] = n01;
        A[qa * LD + pb] = n10;
        A[qa * LD + qb] = n11;
        A[pb * LD + pa] = n00;
        A[qb * LD + pa] = n01;
        A[pb * LD + qa] = n10;
        A[qb * LD + qa] = n11;
      }
      // V' = V J, one row and one pair per task
      for (int w = tid; w < npad * m; w += NT) {
        const int i = w / m, b = w % m;
        const int pb = rp[b], qb = rq[b];
        const double cb = rc[b], sb = rs[b];
        const double vp = V[i * LD + pb], vq = V[i * LD + qb];
        V[i * LD + pb] = sub(mul(cb, vp), mul(sb, vq));
        V[i * LD + qb] = add(mul(sb, vp), mul(cb, vq));
      }
      __syncthreads();
    }
  }

  // eigenvalues ascending (ties by index), U's columns in the same order
  if (tid < n) {
    const double v = A[tid * LD + tid];
    int k = 0;
    for (int i = 0; i < n; ++i) {
      const double u = A[i * LD + i];
      k += (u < v) || (u == v && i < tid);
    }
    rank[tid] = nonfinite ? tid : k;
  }
  __syncthreads();
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, j = e % n;
    U[(size_t)g * n * n + i * n + rank[j]] = nonfinite ? nan : V[i * LD + j];
  }
  if (tid < n) lam[(size_t)g * n + rank[tid]] =
      nonfinite ? nan : A[tid * LD + tid];
  if (tid == 0) {
    info[2 * g] = status;
    info[2 * g + 1] = sweeps;
  }
}

constexpr int SMEM = (2 * NMAX * LD + 3 * (NMAX / 2) + NT) * sizeof(double) +
                     (2 * (NMAX / 2) + NMAX) * sizeof(int);

}  // namespace

// S [G, n, n] symmetric, contiguous -> lam [G, n], U [G, n, n], info [G, 2]
// (status, sweeps); returns cudaGetLastError() after the launch.
extern "C" int paml_eigh_f64(const double* S, double* lam, double* U,
                             int* info, int G, int n, void* stream) {
  if (n < 1 || n > NMAX || G < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  jacobi_eigh_kernel<<<G, NT, SMEM, (cudaStream_t)stream>>>(S, lam, U, info,
                                                           n);
  return (int)cudaGetLastError();
}
