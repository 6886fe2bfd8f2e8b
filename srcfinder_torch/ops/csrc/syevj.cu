// Batched symmetric eigensolve of small matrices: the CMF's whitened
// covariances (B = 72 bands for CH4 radiance, 82 for CO2), one batch of a
// column chunk's 256 matrices a call, and the PCA's covariances of the
// multimodal background.
//
// Replaces no TPU kernel: the JAX package calls jnp.linalg.eigh, which XLA
// lowers to its own eigensolver. On the card the port called
// torch.linalg.eigh, whose cuSOLVER batched Jacobi (syevjBatched) launches
// every sweep's kernels from the host and reads the convergence test back
// between them: ~144 ms a call of 256 72 x 72 matrices, most of it launches
// and host round trips with the card idle. This kernel solves the whole
// batch in one launch and never returns to the host.
//
// Bound on this card: about 9 B^3 operations a matrix (0.86 GFLOP a call at
// B = 72, ~13 us at 67 TFLOP/s) and 2 B^2 + B elements in and out (16 MB a
// call in f32, ~5 us at 3.35 TB/s). Neither sets the pace: the matrices are
// tiny, so the dependent steps of the iteration (its latency) do.
//
// Design: one thread block a matrix, which it keeps whole in shared memory
// from load to store: A (symmetric, the lower triangle of the input
// mirrored) and V^T, each N x (N + 1) with N = B rounded up to even (an odd
// B gets a zero dummy row and column, whose rotations never fire); the odd
// row stride keeps a column's walk free of bank conflicts. 42 KB in f32
// at B = 72, so a 256-matrix call is resident on the card in one wave;
// 84 KB in f64 (dynamic shared memory above 48 KB).
// Parallel cyclic two-sided Jacobi in the round-robin (tournament) order:
// N/2 disjoint pairs (p, q) a step, N - 1 steps a sweep, every pair once a
// sweep. Step k pairs (N - 1, k) and ((k + P) mod (N - 1), (k - P) mod
// (N - 1)) for P = 1 .. N/2 - 1. At each step:
//  1. one thread a pair computes its rotation by Rutishauser's formulas
//     (theta = (a_qq - a_pp) / (2 a_pq), t = sign(theta) / (|theta| +
//     sqrt(theta^2 + 1)), c = 1 / sqrt(1 + t^2), s = t c, tau = s / (1 +
//     c)) and writes its 2 x 2 diagonal block (a_pp - t a_pq, a_qq + t a_pq, and
//     a_pq exactly 0). It skips the pair when |a_pq| <= eps sqrt(|a_pp|)
//     sqrt(|a_qq|), the relative threshold that keeps Jacobi's accuracy on
//     graded matrices. One barrier (__syncthreads_or) also votes whether
//     any rotation fired;
//  2. the threads update every 2 x 2 block above the block diagonal,
//     A[{p1,q1},{p2,q2}] <- J1^T A J2 (rows, then columns), and write it
//     and its transpose, so A stays symmetric to the bit; in the same pass
//     they rotate rows p and q of V^T. One barrier. A block whose two
//     rotations both skipped is left as it is. Every rotation is applied
//     as a correction, x' = x - s (y + tau x), y' = y + s (x - tau y): with
//     c x - s y, a late sweep's small angles, where c rounds to 1, would
//     grow V's columns a little at every step (V^T V - I 1.4e-5 in f32 at
//     B = 72, against 5.5e-7 this way, on the plain version).
// It stops after a sweep in which no rotation fired, or at the sweep cap of
// its precision (Prec<T>::max_sweeps), and writes the sweeps it ran to
// `sweeps`. Then each thread ranks one eigenvalue (ties by index), so the
// eigenvalues come out ascending, as torch.linalg.eigh gives them, and the
// columns of V follow their eigenvalues. A matrix holding a non-finite
// value gives NaN eigenvalues, an identity V and 0 sweeps.
// No atomics, and every sum has a fixed order: two launches on one input
// give bit-identical outputs. ops/eigh.py::syevj_ref is the same
// iteration in plain PyTorch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;
constexpr int kThreads = 512;     // a block's threads: faster than 256 or 128 at B = 72

template <typename T>
struct Prec;
template <>
struct Prec<float> {
  static constexpr float eps = FLT_EPSILON;
  static constexpr float big = 1e18f;      // theta^2 + 1 stays finite below it
  static constexpr int max_sweeps = 32;
  __device__ static float abs(float x) { return fabsf(x); }
  __device__ static float root(float x) { return sqrtf(x); }
  __device__ static bool finite(float x) { return isfinite(x); }
};
template <>
struct Prec<double> {
  static constexpr double eps = DBL_EPSILON;
  static constexpr double big = 1e150;
  static constexpr int max_sweeps = 48;
  __device__ static double abs(double x) { return fabs(x); }
  __device__ static double root(double x) { return sqrt(x); }
  __device__ static bool finite(double x) { return isfinite(x); }
};

// bytes of dynamic shared memory a block takes for a matrix of (even) size
// N (mirrored by ops/eigh.py::smem_bytes): A and V^T (N x (N + 1) each),
// the rotations' s and tau (N/2 each), then the pairs' p and q (N/2 each) and the sort's
// permutation (N) as int
inline size_t smem_bytes(int N, size_t size) {
  return size * (2 * static_cast<size_t>(N) * (N + 1) + N) + 8 * static_cast<size_t>(N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
syevj_block_kernel(const T* __restrict__ M, T* __restrict__ lam, T* __restrict__ V,
                   int32_t* __restrict__ sweeps, int n) {
  using P_ = Prec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = n + (n & 1);
  const int S = N + 1;                     // row stride of A and V^T
  const int NP = N / 2;                    // pairs a step
  const int m = N - 1;                     // steps a sweep
  T* A = reinterpret_cast<T*>(smem);
  T* Vt = A + N * S;
  T* sn = Vt + N * S;
  T* ta = sn + NP;
  int* pp = reinterpret_cast<int*>(ta + NP);
  int* qq = pp + NP;
  int* perm = qq + NP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t nn = static_cast<int64_t>(n) * n;
  const T* Mb = M + blockIdx.x * nn;
  T* lamb = lam + static_cast<int64_t>(blockIdx.x) * n;
  T* Vb = V + blockIdx.x * nn;

  // A: the lower triangle mirrored, a zero dummy row and column for odd n;
  // V^T = I
  int bad = 0;
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n, j = idx - i * n;
    const T v = Mb[idx];
    bad |= !P_::finite(v);
    if (i >= j) {
      A[i * S + j] = v;
      A[j * S + i] = v;
    }
  }
  if (N != n) {
    for (int j = tid; j < N; j += nt) {
      A[n * S + j] = T(0);
      A[j * S + n] = T(0);
    }
  }
  for (int idx = tid; idx < N * N; idx += nt) {
    const int i = idx / N, j = idx - i * N;
    Vt[i * S + j] = i == j ? T(1) : T(0);
  }
  for (int r = tid; r < N; r += nt) perm[r] = r;
  if (__syncthreads_or(bad)) {
    for (int r = tid; r < n; r += nt) lamb[r] = T(NAN);
    for (int idx = tid; idx < nn; idx += nt) {
      const int i = idx / n;
      Vb[idx] = idx - i * n == i ? T(1) : T(0);
    }
    if (tid == 0) sweeps[blockIdx.x] = 0;
    return;
  }

  int sweep = 0;
  bool quiet = false;
  while (!quiet && sweep < P_::max_sweeps) {
    int fired_sweep = 0;
    for (int k = 0; k < m; ++k) {
      // 1. the rotations of this step's pairs, and their diagonal blocks
      int fired = 0;
      for (int P = tid; P < NP; P += nt) {
        int p = m, q = k;
        if (P > 0) {
          p = k + P;
          if (p >= m) p -= m;
          q = k - P;
          if (q < 0) q += m;
        }
        const T apq = A[p * S + q], app = A[p * S + p], aqq = A[q * S + q];
        T s = T(0), tau = T(0);
        if (P_::abs(apq) > P_::eps * P_::root(P_::abs(app)) * P_::root(P_::abs(aqq))) {
          const T theta = (aqq - app) / (T(2) * apq);
          const T at = P_::abs(theta);
          T t = at < P_::big ? T(1) / (at + P_::root(T(1) + at * at)) : T(0.5) / at;
          if (theta < T(0)) t = -t;
          const T c = T(1) / P_::root(T(1) + t * t);
          s = t * c;
          tau = s / (T(1) + c);
          A[p * S + p] = app - t * apq;
          A[q * S + q] = aqq + t * apq;
          A[p * S + q] = T(0);
          A[q * S + p] = T(0);
          fired = 1;
        }
        pp[P] = p;
        qq[P] = q;
        sn[P] = s;
        ta[P] = tau;
      }
      if (!__syncthreads_or(fired)) continue;
      fired_sweep = 1;
      // 2. the blocks above the block diagonal, J1^T A J2, and their mirror
      for (int idx = tid; idx < NP * NP; idx += nt) {
        const int P1 = idx / NP, P2 = idx - P1 * NP;
        if (P1 >= P2) continue;
        const T s1 = sn[P1], s2 = sn[P2];
        if (s1 == T(0) && s2 == T(0)) continue;
        const T t1 = ta[P1], t2 = ta[P2];
        const int p1 = pp[P1], q1 = qq[P1], p2 = pp[P2], q2 = qq[P2];
        const T x00 = A[p1 * S + p2], x01 = A[p1 * S + q2];
        const T x10 = A[q1 * S + p2], x11 = A[q1 * S + q2];
        const T u00 = x00 - s1 * (x10 + t1 * x00), u01 = x01 - s1 * (x11 + t1 * x01);
        const T u10 = x10 + s1 * (x00 - t1 * x10), u11 = x11 + s1 * (x01 - t1 * x11);
        const T y00 = u00 - s2 * (u01 + t2 * u00), y01 = u01 + s2 * (u00 - t2 * u01);
        const T y10 = u10 - s2 * (u11 + t2 * u10), y11 = u11 + s2 * (u10 - t2 * u11);
        A[p1 * S + p2] = y00;
        A[p2 * S + p1] = y00;
        A[p1 * S + q2] = y01;
        A[q2 * S + p1] = y01;
        A[q1 * S + p2] = y10;
        A[p2 * S + q1] = y10;
        A[q1 * S + q2] = y11;
        A[q2 * S + q1] = y11;
      }
      // rows p and q of V^T (columns of V), within the n real indices
      for (int idx = tid; idx < NP * n; idx += nt) {
        const int P = idx / n, i = idx - P * n;
        const T s = sn[P];
        if (s == T(0)) continue;
        const T tau = ta[P];
        const int p = pp[P], q = qq[P];
        const T x = Vt[p * S + i], y = Vt[q * S + i];
        Vt[p * S + i] = x - s * (y + tau * x);
        Vt[q * S + i] = y + s * (x - tau * y);
      }
      __syncthreads();
    }
    ++sweep;
    quiet = !fired_sweep;
  }

  // ascending order: eigenvalue j goes to rank r, ties by index
  for (int j = tid; j < n; j += nt) {
    const T lj = A[j * S + j];
    int r = 0;
    for (int i = 0; i < n; ++i) {
      const T li = A[i * S + i];
      r += (li < lj) || (li == lj && i < j);
    }
    perm[r] = j;
  }
  __syncthreads();
  for (int r = tid; r < n; r += nt) lamb[r] = A[perm[r] * (S + 1)];
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n, r = idx - i * n;
    Vb[idx] = Vt[perm[r] * S + i];
  }
  if (tid == 0) sweeps[blockIdx.x] = sweep;
}

template <typename T>
int launch(const T* M, T* lam, T* V, int32_t* sweeps, int64_t batch, int n, void* stream) {
  if (batch < 1 || batch > 0x7fffffff || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n + (n & 1), sizeof(T));
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(syevj_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  syevj_block_kernel<T><<<static_cast<unsigned>(batch), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(M, lam, V, sweeps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M (batch, n, n) contiguous, its lower triangle read; lam (batch, n)
// ascending, V (batch, n, n) with the eigenvectors as columns, sweeps
// (batch,) the sweeps each matrix ran. Returns the launch's cudaError_t.
extern "C" int srcf_syevj_f32(const float* M, float* lam, float* V, int32_t* sweeps,
                              int64_t batch, int n, void* stream) {
  return launch(M, lam, V, sweeps, batch, n, stream);
}

extern "C" int srcf_syevj_f64(const double* M, double* lam, double* V, int32_t* sweeps,
                              int64_t batch, int n, void* stream) {
  return launch(M, lam, V, sweeps, batch, n, stream);
}
