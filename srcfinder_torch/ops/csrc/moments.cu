// Masked moments of the columnwise matched filter: per detector column c,
// the valid count n[c], the mean mu[c, :] and the ddof=1 covariance
// S[c, :, :] of the active-band spectra over the lines the mask selects.
//
//   n  = sum_l m[l, c]
//   mu = sum_l m[l, c] x[l, c, :] / max(n, 1)
//   xc = (x[l, c, :] - mu) * m[l, c]
//   S  = sum_l xc xc^T / max(n - 1, 1)
//
// This is the two-pass centred form of cmf/matched_filter.py::
// masked_moments of the JAX package. It replaces that package's Pallas
// kernel ops/moments.py::masked_moments_pallas (git f6215a7), which
// streamed line blocks once and accumulated about a shifted centre; here
// the mean is a pass of its own, so the scatter accumulates centred values
// exactly as the reference does (a shifted or raw one-pass form would
// change f32 rounding in the near-singular columns the CMF's cond gate
// recomputes).
//
// Bound on this card: one read of x is 4*L*C*B bytes in f32 against
// L*C*B*(B+1) operations for the symmetric scatter (B(B+1)/2
// multiply-adds per line), about 18 operations per byte at B = 72, under
// the ~20 of the f32 FMA rate over the memory rate (67 TFLOP/s over
// 3.35 TB/s), so bytes bound it (chip_smoke.py counts both); in f64 bytes
// bound it twice over. The two passes read x twice, so about half of the
// bound is this design's ceiling.
//
// Design, three launches on one stream, grid (line splits, C[, tile
// groups]) with the split count from ops/moments.py::plan so the grid
// fills the card both at a full chunk and at the few columns of the
// cond-gated f64 recompute:
//  1. moments_sum_kernel: each block reads its lines of one column as
//     16-byte vectors (and the mask once per line) and writes the partial
//     count and masked sum to (splits, C[, B]) scratch;
//  2. moments_scatter_kernel: each block first adds the split partials of
//     its column in split order (n and mu; block 0 writes them), then
//     streams its lines and their mask values through a 3-stage ring of
//     16-byte cp.async copies (a 16-byte gap after every 128 bytes of a
//     line keeps the tile reads below free of bank conflicts); each staged
//     tile is centred and masked once, in place.
//     Only the upper triangle is accumulated: 8 x 8 register tiles on or
//     above the diagonal (45 of them at B = 72), each shared by 4 thread
//     groups that take every 4th line, so 180 threads all have work; the
//     groups are added in a fixed order and the packed triangle goes to
//     (splits, C, B(B+1)/2) scratch;
//  3. moments_combine_kernel adds the splits in a fixed order, divides by
//     max(n - 1, 1) and writes S with its mirror.
// No atomics: two launches on one input give bit-identical outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;   // cp.async ring depth of the scatter
constexpr int kGroups = 4;   // line groups sharing one register tile
constexpr int kMaxTiles = 45;
constexpr int kSumThreads = 256;
constexpr int kSmemMax = 232448;

struct Strides {
  int64_t sxl, sxc, sml, smc;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(src), "n"(N), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// grid (splits, C), 256 threads = line groups x vectors of a line
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
moments_sum_kernel(const T* __restrict__ x, const T* __restrict__ m,
                   T* __restrict__ psum, T* __restrict__ pcnt, int L, int B,
                   int lines, int vec, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VW = 16 / sizeof(T);
  const int V = vec ? VW : 1;
  const int split = blockIdx.x, c = blockIdx.y, C = gridDim.y;
  const int l0 = split * lines, l1 = min(L, l0 + lines);
  const int nvec = (B + V - 1) / V;
  const int lgc = max(1, kSumThreads / nvec);
  T* red = reinterpret_cast<T*>(smem);          // [lgc][nvec * V]
  T* cnt = red + lgc * nvec * V;                // [lgc]
  const T* xcol = x + c * st.sxc;
  const T* mcol = m + c * st.smc;

  for (int e = threadIdx.x; e < lgc * nvec; e += kSumThreads) {
    const int lg = e / nvec, v = e - lg * nvec, b = v * V;
    T acc[VW];
    for (int j = 0; j < VW; ++j) acc[j] = T(0);
    T cn = 0;
    // four lines per step, their loads issued before the adds
    for (int lb = l0 + lg; lb < l1; lb += 4 * lgc) {
      T mv[4];
      typename Vec<T>::type xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lb + u * lgc;
        mv[u] = T(0);
        if (l < l1) {
          mv[u] = mcol[l * st.sml];
          const T* row = xcol + l * st.sxl + b;
          if (vec) {
            xv[u] = *reinterpret_cast<const typename Vec<T>::type*>(row);
          } else {
            reinterpret_cast<T*>(&xv[u])[0] = row[0];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (lb + u * lgc >= l1) break;
        const T* xs = reinterpret_cast<const T*>(&xv[u]);
        for (int j = 0; j < V; ++j) acc[j] += mv[u] * xs[j];
        cn += mv[u];
      }
    }
    for (int j = 0; j < V; ++j) red[lg * nvec * V + b + j] = acc[j];
    if (v == 0) cnt[lg] = cn;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kSumThreads) {
    T s = 0;
    for (int g = 0; g < lgc; ++g) s += red[g * nvec * V + b];
    psum[((int64_t)split * C + c) * B + b] = s;
  }
  if (threadIdx.x == 0) {
    T s = 0;
    for (int g = 0; g < lgc; ++g) s += cnt[g];
    pcnt[(int64_t)split * C + c] = s;
  }
}

__device__ __forceinline__ void tile_ij(int t, int nb8, int& I, int& J) {
  I = 0;
  while (t >= nb8 - I) {
    t -= nb8 - I;
    ++I;
  }
  J = I + t;
}

// Position of band b in a staged line: one 16-byte gap after every 128
// bytes, so the 16-byte reads of the 8-band blocks 0..7 of a line fall in
// distinct shared-memory bank groups.
template <typename T>
__device__ __forceinline__ int bpos(int b) {
  return b + (16 / static_cast<int>(sizeof(T))) * (b / (128 / static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ int64_t packed(int i, int j, int B) {
  return (int64_t)i * B - (int64_t)i * (i - 1) / 2 + (j - i);
}

// Copies of the line tile starting at lt0 into one ring slot, and of its
// mask values; lines past l1 and bands past B (up to the 8-band tile edge)
// are zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(T* slot, T* mslot, const T* xcol,
                                           const T* mcol, int lt0, int l1,
                                           int tl, int B, int b8, int kstride,
                                           int vec, const Strides& st) {
  for (int i = threadIdx.x; i < tl; i += blockDim.x) {
    const int l = lt0 + i;
    const bool ok = l < l1;
    cp_async_small<sizeof(T)>(mslot + i, ok ? mcol + l * st.sml : mcol,
                              ok ? (int)sizeof(T) : 0);
  }
  constexpr int VW = 16 / sizeof(T);
  const int V = vec ? VW : 1;
  const int per = b8 / V;
  for (int e = threadIdx.x; e < tl * per; e += blockDim.x) {
    const int ll = e / per, b = (e - ll * per) * V;
    const int l = lt0 + ll;
    const int valid = l < l1 ? min(max(B - b, 0), V) : 0;
    const T* src = valid ? xcol + l * st.sxl + b : xcol;
    T* dst = slot + ll * kstride + bpos<T>(b);
    if (vec)
      cp_async16(dst, src, valid * (int)sizeof(T));
    else
      cp_async_small<sizeof(T)>(dst, src, valid * (int)sizeof(T));
  }
}

// grid (splits, C, tile groups), tpb * kGroups threads; VEC: 16-byte
// copies and centring
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxTiles * kGroups, 2)
moments_scatter_kernel(const T* __restrict__ x, const T* __restrict__ m,
                       const T* __restrict__ psum, const T* __restrict__ pcnt,
                       T* __restrict__ n_out, T* __restrict__ mu_out,
                       T* __restrict__ ptri, int L, int B, int lines, int tl,
                       int kstride, int splits, int tpb, Strides st) {
  constexpr int vec = VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VW = 16 / sizeof(T);
  const int split = blockIdx.x, c = blockIdx.y, C = gridDim.y;
  const int l0 = split * lines, l1 = min(L, l0 + lines);
  const int ntile = l1 > l0 ? (l1 - l0 + tl - 1) / tl : 0;
  const int nb8 = (B + 7) / 8, b8 = nb8 * 8;
  const int ntri = nb8 * (nb8 + 1) / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ti = tid % tpb, grp = tid / tpb;
  const int tg = blockIdx.z * tpb + ti;
  const bool active = tg < ntri;
  int I = 0, J = 0;
  if (active) tile_ij(tg, nb8, I, J);

  T* mu_s = reinterpret_cast<T*>(smem);           // [b8]
  T* ms = mu_s + b8;                              // [kStages][tl]
  T* ring = ms + kStages * tl;                    // [kStages][tl][kstride]
  const T* xcol = x + c * st.sxc;
  const T* mcol = m + c * st.smc;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntile)
      issue_tile(ring + s * tl * kstride, ms + s * tl, xcol, mcol, l0 + s * tl, l1, tl,
                 B, b8, kstride, vec, st);
    cp_commit();
  }
  // n and mu of the column: the split partials added in split order
  T n = 0;
  for (int k = 0; k < splits; ++k) n += pcnt[(int64_t)k * C + c];
  const T denom = n > T(1) ? n : T(1);
  const bool writer = split == 0 && blockIdx.z == 0;
  for (int b = tid; b < b8; b += nt) {
    T mu = 0;
    if (b < B) {
      T s = 0;
      for (int k = 0; k < splits; ++k) s += psum[((int64_t)k * C + c) * B + b];
      mu = s / denom;
      if (writer) mu_out[(int64_t)c * B + b] = mu;
    }
    mu_s[b] = mu;
  }
  if (writer && tid == 0) n_out[c] = n;
  __syncthreads();

  T acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  constexpr int V = VEC ? VW : 1;
  const int per = b8 / V;

  for (int t = 0; t < ntile; ++t) {
    T* xs = ring + (t % kStages) * tl * kstride;
    const T* mv_s = ms + (t % kStages) * tl;
    cp_wait<kStages - 2>();
    __syncthreads();
    // centre and mask the staged tile in place
    for (int e = tid; e < tl * per; e += nt) {
      const int ll = e / per, b = (e - ll * per) * V;
      const T mv = mv_s[ll];
      T* s = xs + ll * kstride + bpos<T>(b);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = (s[j] - mu_s[b + j]) * mv;
    }
    const int tn = t + kStages - 1;
    if (tn < ntile)
      issue_tile(ring + (tn % kStages) * tl * kstride, ms + (tn % kStages) * tl, xcol,
                 mcol, l0 + tn * tl, l1, tl, B, b8, kstride, vec, st);
    cp_commit();
    __syncthreads();
    if (active) {
      const int pi = bpos<T>(8 * I), pj = bpos<T>(8 * J);
#pragma unroll 2
      for (int ll = grp; ll < tl; ll += kGroups) {
        const T* row = xs + ll * kstride;
        T a[8], b[8];
        if constexpr (sizeof(T) == 4) {
          const float4 a0 = *reinterpret_cast<const float4*>(row + pi);
          const float4 a1 = *reinterpret_cast<const float4*>(row + pi + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(row + pj);
          const float4 b1 = *reinterpret_cast<const float4*>(row + pj + 4);
          a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
          b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
          b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const double2 av = *reinterpret_cast<const double2*>(row + pi + 2 * q);
            const double2 bv = *reinterpret_cast<const double2*>(row + pj + 2 * q);
            a[2 * q] = av.x; a[2 * q + 1] = av.y;
            b[2 * q] = bv.x; b[2 * q + 1] = bv.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
  // the kGroups partial tiles, added in group order (aliases the ring)
  T* red = ring;                                  // [kGroups][tpb][64]
  if (active)
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) red[((int64_t)grp * tpb + ti) * 64 + i * 8 + j] = acc[i][j];
  __syncthreads();
  const int P = B * (B + 1) / 2;
  for (int e = tid; e < tpb * 64; e += nt) {
    const int t2 = e / 64, ij = e - t2 * 64;
    const int tt = blockIdx.z * tpb + t2;
    if (tt >= ntri) continue;
    int I2, J2;
    tile_ij(tt, nb8, I2, J2);
    const int i = 8 * I2 + ij / 8, j = 8 * J2 + ij % 8;
    if (i > j || j >= B) continue;
    T s = 0;
    for (int g = 0; g < kGroups; ++g) s += red[((int64_t)g * tpb + t2) * 64 + ij];
    ptri[((int64_t)split * C + c) * P + packed(i, j, B)] = s;
  }
}

// S[c, i, j] = sum over splits (in order) of the packed partial / max(n-1, 1)
template <typename T>
__global__ void moments_combine_kernel(const T* __restrict__ ptri, const T* __restrict__ n,
                                       T* __restrict__ S, int C, int B, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t BB = (int64_t)B * B;
  if (e >= C * BB) return;
  const int c = static_cast<int>(e / BB);
  const int ij = static_cast<int>(e - c * BB);
  const int i = ij / B, j = ij - i * B;
  const int P = B * (B + 1) / 2;
  const int64_t o = packed(min(i, j), max(i, j), B);
  T s = 0;
  for (int k = 0; k < splits; ++k) s += ptri[((int64_t)k * C + c) * P + o];
  const T nm1 = n[c] - T(1);
  S[e] = s / (nm1 > T(1) ? nm1 : T(1));
}

template <typename T>
int launch(const T* x, const T* m, T* n, T* mu, T* S, T* psum, T* pcnt, T* ptri,
           int L, int C, int B, int64_t sxl, int64_t sxc, int64_t sml, int64_t smc,
           int splits, int lines, int tl, int kstride, int tpb, int tgroups, int vec,
           int smem, void* stream) {
  if (smem > kSmemMax || tpb < 1 || tpb > kMaxTiles || splits < 1 || tl % kGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{sxl, sxc, sml, smc};
  const int V = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int nvec = (B + V - 1) / V;
  const int lgc = kSumThreads / nvec > 1 ? kSumThreads / nvec : 1;
  const int smem1 = (lgc * nvec * V + lgc) * static_cast<int>(sizeof(T));
  if (smem1 > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  moments_sum_kernel<T><<<dim3(splits, C), kSumThreads, smem1, s>>>(
      x, m, psum, pcnt, L, B, lines, vec, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto scatter = vec ? moments_scatter_kernel<T, true> : moments_scatter_kernel<T, false>;
  // once per process and instance: allow up to a block's whole shared memory
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(moments_scatter_kernel<T, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax),
      cudaFuncSetAttribute(moments_scatter_kernel<T, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)};
  err = attr[vec ? 1 : 0];
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter<<<dim3(splits, C, tgroups), tpb * kGroups, smem, s>>>(
      x, m, psum, pcnt, n, mu, ptri, L, B, lines, tl, kstride, splits, tpb, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)C * B * B;
  moments_combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      ptri, n, S, C, B, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SRCF_MOMENTS_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* x, const T* m, T* n, T* mu, T* S, T* psum,        \
                      T* pcnt, T* ptri, int L, int C, int B, int64_t sxl,        \
                      int64_t sxc, int64_t sml, int64_t smc, int splits,         \
                      int lines, int tl, int kstride, int tpb, int tgroups,      \
                      int vec, int smem, void* stream) {                         \
    return launch<T>(x, m, n, mu, S, psum, pcnt, ptri, L, C, B, sxl, sxc, sml,   \
                     smc, splits, lines, tl, kstride, tpb, tgroups, vec, smem,   \
                     stream);                                                    \
  }

SRCF_MOMENTS_ENTRY(srcf_moments_f32, float)
SRCF_MOMENTS_ENTRY(srcf_moments_f64, double)
