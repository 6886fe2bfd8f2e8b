// Masked moments of the columnwise matched filter: per detector column c,
// the valid count n[c], the mean mu[c, :] and the ddof=1 covariance
// S[c, :, :] of the active-band spectra over the lines the mask selects.
//
//   n  = sum_l m[l, c]
//   mu = sum_l m[l, c] x[l, c, :] / max(n, 1)
//   xc = (x[l, c, :] - mu) * m[l, c]
//   S  = sum_l xc xc^T / max(n - 1, 1)
//
// This is the two-pass centered form of
// cmf/matched_filter.py::masked_moments of the JAX package. It replaces
// that package's Pallas kernel ops/moments.py::masked_moments_pallas (git
// f6215a7), which streamed line blocks once and accumulated about a
// shifted centre; here the mean is a separate first pass, so the scatter
// accumulates centred values exactly as the reference does.
//
// Bound on this card: the scatter is 2*L*C*B^2 operations against one read
// of x (4*L*C*B bytes in f32), about 36 operations per byte at B = 72, so
// the f32/f64 arithmetic (no tensor cores) bounds it, not memory.
//
// Design: kernel 1 (one block per column) reduces n and mu over lines.
// Kernel 2 runs one block per (column, 32x32 band tile of the upper
// triangle of S); it stages 32-line tiles of both band ranges of xc in
// shared memory and each thread accumulates a 2x2 register tile over all
// lines, then writes the tile and its mirror. Each column's lines are
// re-read once per band tile pair (from L2 mostly); that and the plain
// FMA loop are what a later version with tensor-core tiles would remove.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 32;   // band tile of S
constexpr int kTileL = 32;   // line tile staged in shared memory

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
    scratch[0] = total;
  }
  __syncthreads();
  total = scratch[0];
  __syncthreads();
  return total;
}

// grid (C), block 256 = 32 bands x 8 line groups
template <typename T>
__global__ void __launch_bounds__(kThreads)
mean_kernel(const T* __restrict__ x, const T* __restrict__ m,
            T* __restrict__ n_out, T* __restrict__ mu_out,
            int L, int B, int64_t sxl, int64_t sxc, int64_t sml, int64_t smc) {
  __shared__ T scratch[kThreads / 32];
  __shared__ T part[8][33];
  const int c = blockIdx.x;
  const T* xcol = x + c * sxc;
  const T* mcol = m + c * smc;

  T cnt = 0;
  for (int l = threadIdx.x; l < L; l += kThreads) cnt += mcol[l * sml];
  const T n = block_sum(cnt, scratch);
  if (threadIdx.x == 0) n_out[c] = n;
  const T denom = n > T(1) ? n : T(1);

  const int tb = threadIdx.x & 31, tl = threadIdx.x >> 5;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + tb;
    T s = 0;
    if (b < B)
      for (int l = tl; l < L; l += 8) s += mcol[l * sml] * xcol[l * sxl + b];
    part[tl][tb] = s;
    __syncthreads();
    if (tl == 0 && b < B) {
      T t = 0;
      for (int k = 0; k < 8; ++k) t += part[k][tb];
      mu_out[c * B + b] = t / denom;
    }
    __syncthreads();
  }
}

// grid (tile pairs of the upper triangle, C), block 256 = 16 x 16 threads,
// each owning a 2x2 tile of the 32x32 output tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
cov_kernel(const T* __restrict__ x, const T* __restrict__ m,
           const T* __restrict__ n_in, const T* __restrict__ mu,
           T* __restrict__ S, int L, int B,
           int64_t sxl, int64_t sxc, int64_t sml, int64_t smc) {
  __shared__ T As[kTileL][kTileB + 1];
  __shared__ T Bs[kTileL][kTileB + 1];
  const int c = blockIdx.y;
  const int nt = (B + kTileB - 1) / kTileB;
  int p = blockIdx.x, bi = 0;
  while (p >= nt - bi) {
    p -= nt - bi;
    ++bi;
  }
  const int bj = bi + p;
  const int i0 = bi * kTileB, j0 = bj * kTileB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* xcol = x + c * sxc;
  const T* mcol = m + c * smc;
  const T* mucol = mu + c * B;

  T acc00 = 0, acc01 = 0, acc10 = 0, acc11 = 0;
  for (int l0 = 0; l0 < L; l0 += kTileL) {
    for (int e = threadIdx.x; e < kTileL * kTileB; e += kThreads) {
      const int ll = e / kTileB, bb = e % kTileB, l = l0 + ll;
      T a = 0, b = 0;
      if (l < L) {
        const T mv = mcol[l * sml];
        const T* row = xcol + l * sxl;
        if (i0 + bb < B) a = (row[i0 + bb] - mucol[i0 + bb]) * mv;
        if (j0 + bb < B) b = (row[j0 + bb] - mucol[j0 + bb]) * mv;
      }
      As[ll][bb] = a;
      Bs[ll][bb] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int ll = 0; ll < kTileL; ++ll) {
      const T a0 = As[ll][2 * ty], a1 = As[ll][2 * ty + 1];
      const T b0 = Bs[ll][2 * tx], b1 = Bs[ll][2 * tx + 1];
      acc00 += a0 * b0;
      acc01 += a0 * b1;
      acc10 += a1 * b0;
      acc11 += a1 * b1;
    }
    __syncthreads();
  }

  const T nm1 = n_in[c] - T(1);
  const T denom = nm1 > T(1) ? nm1 : T(1);
  const T acc[2][2] = {{acc00, acc01}, {acc10, acc11}};
  T* Sc = S + (int64_t)c * B * B;
  for (int r = 0; r < 2; ++r) {
    for (int s = 0; s < 2; ++s) {
      const int i = i0 + 2 * ty + r, j = j0 + 2 * tx + s;
      if (i < B && j < B) {
        const T v = acc[r][s] / denom;
        Sc[(int64_t)i * B + j] = v;
        if (bi != bj) Sc[(int64_t)j * B + i] = v;
      }
    }
  }
}

template <typename T>
int launch(const T* x, const T* m, T* n, T* mu, T* S, int L, int C, int B,
           int64_t sxl, int64_t sxc, int64_t sml, int64_t smc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mean_kernel<T><<<C, kThreads, 0, st>>>(x, m, n, mu, L, B, sxl, sxc, sml, smc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (B + kTileB - 1) / kTileB;
  const dim3 grid(nt * (nt + 1) / 2, C);
  cov_kernel<T><<<grid, kThreads, 0, st>>>(x, m, n, mu, S, L, B, sxl, sxc, sml, smc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srcf_moments_f32(const float* x, const float* m, float* n,
                                float* mu, float* S, int L, int C, int B,
                                int64_t sxl, int64_t sxc, int64_t sml,
                                int64_t smc, void* stream) {
  return launch<float>(x, m, n, mu, S, L, C, B, sxl, sxc, sml, smc, stream);
}

extern "C" int srcf_moments_f64(const double* x, const double* m, double* n,
                                double* mu, double* S, int L, int C, int B,
                                int64_t sxl, int64_t sxc, int64_t sml,
                                int64_t smc, void* stream) {
  return launch<double>(x, m, n, mu, S, L, C, B, sxl, sxc, sml, smc, stream);
}
