// GoogLeNet trunk segments of the exact dense CNN, per window batch, NHWC:
//
//   fused_stage12  (N, D, D, 1) windows -> conv1 7x7/2 pad 3 -> ceil-pool 3x3/2
//                  -> conv2 1x1 -> conv3 3x3 pad 1 -> ceil-pool 3x3/2
//                  -> (N, D/8, D/8, 192)
//   trunk_s23      (N, h, h, 64) conv1 output, h = D/2 -> ceil-pool -> conv2
//                  -> conv3 -> ceil-pool -> inception3a -> inception3b
//                  -> ceil-pool -> (N, h/8, h/8, 480)
//   trunk_s45      (N, g, g, 480) -> inception4a..4e -> max-pool 2x2/2
//                  -> inception5a -> inception5b -> global average pool
//                  -> (N, 1024)
//
// Every conv is BN-folded conv + bias + ReLU. They replace the JAX
// package's Pallas kernels ops/trunk_fuse.py::fused_stage12 (git be3cd8d)
// and ops/trunk_fuse.py::fused_trunk_segment (git ca79403), which kept one
// window's whole segment in VMEM. Here a window's s23 input alone is 4.2 MB
// in f32, far above the 227 KB of shared memory a block can use, so each
// layer is its own launch over the whole batch and intermediates go through
// device memory (scratch the caller allocates).
//
// Bound on this card: the convolutions, about 3.6 GFLOP per 256x256 window,
// with under 20 MB of feature maps per window in f32: some 180 operations
// per byte, so the arithmetic bounds the segments, not memory. This first
// version runs it on the f32 FMA pipes (no tensor cores), so its bound is
// the 67 TFLOP/s of f32 outside the tensor cores in both dtypes.
//
// Design:
// - conv_kernel: one implicit GEMM for every conv. Rows are output pixels
//   (the batch folded into them), columns output channels, the reduction
//   runs over (ky, kx, cin) with cin fastest, so an NHWC map is read with
//   channels contiguous and HWIO weights with cout contiguous. A block
//   computes a 128 x 64 tile, each thread an 8 x 4 register tile, over
//   16-deep slices staged in shared memory as f32. Bias and ReLU are
//   applied in f32 in the epilogue, then the value is rounded once to the
//   storage type, which is where the Pallas kernels rounded. The output
//   goes to a channel offset and pixel stride of the concatenated
//   inception output (no concatenation pass), and a channel split sends
//   the first columns to one map and the rest to another: that is how the
//   three 1x1 convs that read an inception's input run as one wide conv.
//   With POOL the input load takes the 3x3/1 max (-inf outside the map)
//   of branch 4 on the fly.
// - maxpool_kernel: k x k / stride windows whose taps outside the map are
//   skipped, which is -inf padding: ceil-mode 3x3/2 and 2x2/2.
// - gap_kernel: mean over pixels in f32, then rounded to the storage type.
// Not yet: tensor cores (mma.sync / wgmma), TMA, and halo tiles that would
// keep a window's pool1 -> conv2 -> conv3 chain in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction slice
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 4;    // channels per thread
constexpr int NT = 256;  // threads per block: (BM / TM) x (BN / TN)

template <typename T>
struct Conv {
  const T* x;    // input map at its first channel; pixel p at x + p * ldx
  int64_t ldx;
  int H, W, Cin;
  int K, stride, pad;
  int Ho, Wo, Cout;
  const T* w;    // (K, K, Cin, Cout)
  const T* b;    // (Cout)
  T* y0;         // channels [0, split), pixel p at y0 + p * ldy0
  int64_t ldy0;
  T* y1;         // channels [split, Cout) at y1 + p * ldy1 + (c - split)
  int64_t ldy1;
  int split;
  int64_t M;     // N * Ho * Wo
};

template <typename T, bool POOL>
__global__ void __launch_bounds__(NT) conv_kernel(const Conv<T> a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int Kd = a.K * a.K * a.Cin;

  // staging: this thread loads reduction column kl of rows ml0 + 16 i
  const int kl = tid % BK;
  const int ml0 = tid / BK;
  int64_t base[TM];  // first pixel of the row's image
  int iy0[TM], ix0[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ml0 + 16 * i;
    base[i] = 0;
    iy0[i] = -(1 << 29);  // rows past M read nothing
    ix0[i] = 0;
    if (m < a.M) {
      const int ox = static_cast<int>(m % a.Wo);
      const int64_t t = m / a.Wo;
      const int oy = static_cast<int>(t % a.Ho);
      base[i] = (t / a.Ho) * a.H * a.W;
      iy0[i] = oy * a.stride - a.pad;
      ix0[i] = ox * a.stride - a.pad;
    }
  }

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kd; k0 += BK) {
    const int k = k0 + kl;
    const bool kv = k < Kd;
    int ci = 0, ky = 0, kx = 0;
    if (kv) {
      ci = k % a.Cin;
      const int r = k / a.Cin;
      kx = r % a.K;
      ky = r / a.K;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      float v = 0.f;
      if (kv && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
        if (POOL) {
          v = -INFINITY;
          for (int yy = max(iy - 1, 0); yy <= min(iy + 1, a.H - 1); ++yy)
            for (int xx = max(ix - 1, 0); xx <= min(ix + 1, a.W - 1); ++xx)
              v = fmaxf(v, to_f(a.x[(base[i] + static_cast<int64_t>(yy) * a.W + xx) * a.ldx + ci]));
        } else {
          v = to_f(a.x[(base[i] + static_cast<int64_t>(iy) * a.W + ix) * a.ldx + ci]);
        }
      }
      As[kl][ml0 + 16 * i] = v;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / NT; ++j) {
      const int kk = tid / BN + (NT / BN) * j, nn = tid % BN;
      const int kb = k0 + kk, nb = n0 + nn;
      Bs[kk][nn] = (kb < Kd && nb < a.Cout)
                       ? to_f(a.w[static_cast<int64_t>(kb) * a.Cout + nb]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= a.Cout) continue;
      const T v = from_f<T>(fmaxf(acc[i][j] + to_f(a.b[n]), 0.f));
      if (n < a.split)
        a.y0[m * a.ldy0 + n] = v;
      else
        a.y1[m * a.ldy1 + (n - a.split)] = v;
    }
  }
}

// (N, H, W, C) -> (N, Ho, Wo, C); taps outside the map are skipped
template <typename T>
__global__ void maxpool_kernel(const T* __restrict__ x, T* __restrict__ y, int H,
                               int W, int C, int Ho, int Wo, int k, int s,
                               int64_t total) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % C);
    int64_t t = e / C;
    const int ox = static_cast<int>(t % Wo);
    t /= Wo;
    const int oy = static_cast<int>(t % Ho);
    const int64_t n = t / Ho;
    float v = -INFINITY;
    for (int yy = oy * s; yy < min(oy * s + k, H); ++yy)
      for (int xx = ox * s; xx < min(ox * s + k, W); ++xx)
        v = fmaxf(v, to_f(x[((n * H + yy) * W + xx) * C + c]));
    y[e] = from_f<T>(v);
  }
}

// (N, P, C) -> (N, C): mean over the P pixels in f32
template <typename T>
__global__ void gap_kernel(const T* __restrict__ x, T* __restrict__ y, int P,
                           int C, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % C);
  const T* px = x + (e / C) * P * C + c;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += to_f(px[static_cast<int64_t>(p) * C]);
  y[e] = from_f<T>(s / P);
}

#define TRY(expr)                      \
  do {                                 \
    const int err_ = (expr);           \
    if (err_ != 0) return err_;        \
  } while (0)

int ceil_out(int h, int k, int s) { return (h - k + s - 1) / s + 1; }

// conv + bias + ReLU of an (n, H, W, Cin) map; see Conv for the outputs
template <typename T>
int conv(cudaStream_t st, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y0,
         int64_t ldy0, int split, T* y1, int64_t ldy1, bool pool) {
  Conv<T> a;
  a.x = x; a.ldx = ldx; a.H = H; a.W = W; a.Cin = Cin;
  a.K = K; a.stride = stride; a.pad = pad;
  a.Ho = (H + 2 * pad - K) / stride + 1;
  a.Wo = (W + 2 * pad - K) / stride + 1;
  a.Cout = Cout; a.w = w; a.b = b;
  a.y0 = y0; a.ldy0 = ldy0; a.y1 = y1; a.ldy1 = ldy1; a.split = split;
  a.M = static_cast<int64_t>(n) * a.Ho * a.Wo;
  const dim3 grid(static_cast<unsigned>((a.M + BM - 1) / BM), (Cout + BN - 1) / BN);
  if (pool)
    conv_kernel<T, true><<<grid, NT, 0, st>>>(a);
  else
    conv_kernel<T, false><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// plain conv: all Cout channels to one map with pixel stride ldy
template <typename T>
int conv(cudaStream_t st, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y,
         int64_t ldy, bool pool = false) {
  return conv(st, n, x, ldx, H, W, Cin, K, stride, pad, w, b, Cout, y, ldy, Cout,
              y, ldy, pool);
}

template <typename T>
int maxpool(cudaStream_t st, int n, const T* x, int H, int W, int C, int k, T* y) {
  const int Ho = ceil_out(H, k, 2), Wo = ceil_out(W, k, 2);
  const int64_t total = static_cast<int64_t>(n) * Ho * Wo * C;
  const int64_t blocks = (total + 255) / 256;
  maxpool_kernel<T><<<static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0, st>>>(
      x, y, H, W, C, Ho, Wo, k, 2, total);
  return static_cast<int>(cudaGetLastError());
}

// inception channel plans (reference: cnn/archs/googlenet1.py:64-79)
struct Plan {
  int cin, ch1, red3, ch3, red5, ch5, proj;
  int out() const { return ch1 + ch3 + ch5 + proj; }
};
constexpr Plan k3a{192, 64, 96, 128, 16, 32, 32};
constexpr Plan k3b{256, 128, 128, 192, 32, 96, 64};
constexpr Plan k4[5] = {{480, 192, 96, 208, 16, 48, 64},
                        {512, 160, 112, 224, 24, 64, 64},
                        {512, 128, 128, 256, 24, 64, 64},
                        {512, 112, 144, 288, 32, 64, 64},
                        {528, 256, 160, 320, 32, 128, 128}};
constexpr Plan k5a{832, 256, 160, 320, 32, 128, 128};
constexpr Plan k5b{832, 384, 192, 384, 48, 128, 128};

// One inception block: (n, h, w, cin) map x -> (n, h, w, out) map y.
// wt: wide 1x1 (cin, ch1 + red3 + red5) and its bias, branch2's 3x3
// (3, 3, red3, ch3) and bias, branch3's 3x3 (3, 3, red5, ch5) and bias,
// branch4's 1x1 (cin, proj) and bias. red: (n, h, w, red3 + red5) scratch.
template <typename T>
int inception(cudaStream_t st, int n, const Plan& p, const T* x, int h, int w,
              const T* const* wt, T* red, T* y) {
  const int cr = p.red3 + p.red5, co = p.out();
  // the three 1x1s as one conv: [0, ch1) -> y, the reductions -> red
  TRY(conv(st, n, x, p.cin, h, w, p.cin, 1, 1, 0, wt[0], wt[1], p.ch1 + cr, y, co,
           p.ch1, red, cr, false));
  TRY(conv(st, n, red, cr, h, w, p.red3, 3, 1, 1, wt[2], wt[3], p.ch3, y + p.ch1, co));
  TRY(conv(st, n, red + p.red3, cr, h, w, p.red5, 3, 1, 1, wt[4], wt[5], p.ch5,
           y + p.ch1 + p.ch3, co));
  // branch 4: 3x3/1 max pool taken in the 1x1's input load
  TRY(conv(st, n, x, p.cin, h, w, p.cin, 1, 1, 0, wt[6], wt[7], p.proj,
           y + p.ch1 + p.ch3 + p.ch5, co, true));
  return 0;
}

// weights: conv1 (7, 7, 1, 64), b1, conv2 (64, 64), b2, conv3 (3, 3, 64, 192), b3
// scratch: c1 (n, d/2, d/2, 64), p1 (n, d/4, d/4, 64), c2 (same), c3 (n, d/4, d/4, 192)
template <typename T>
int fused_stage12(const T* x, T* out, const T* const* wt, T* const* s, int n, int d,
                  cudaStream_t st) {
  const int h1 = (d - 1) / 2 + 1, h2 = ceil_out(h1, 3, 2);
  TRY(conv(st, n, x, 1, d, d, 1, 7, 2, 3, wt[0], wt[1], 64, s[0], 64));
  TRY(maxpool(st, n, s[0], h1, h1, 64, 3, s[1]));
  TRY(conv(st, n, s[1], 64, h2, h2, 64, 1, 1, 0, wt[2], wt[3], 64, s[2], 64));
  TRY(conv(st, n, s[2], 64, h2, h2, 64, 3, 1, 1, wt[4], wt[5], 192, s[3], 192));
  return maxpool(st, n, s[3], h2, h2, 192, 3, out);
}

// weights: conv2, b2, conv3, b3, then 8 per inception block (see inception)
// scratch: p1 (n, h/2, h/2, 64), c2 (same), c3 (n, h/2, h/2, 192),
// p2 (n, h/4, h/4, 192), red (n, h/4, h/4, 160), i3a (n, h/4, h/4, 256),
// i3b (n, h/4, h/4, 480)
template <typename T>
int trunk_s23(const T* x, T* out, const T* const* wt, T* const* s, int n, int h,
              cudaStream_t st) {
  const int h2 = ceil_out(h, 3, 2), h4 = ceil_out(h2, 3, 2);
  TRY(maxpool(st, n, x, h, h, 64, 3, s[0]));
  TRY(conv(st, n, s[0], 64, h2, h2, 64, 1, 1, 0, wt[0], wt[1], 64, s[1], 64));
  TRY(conv(st, n, s[1], 64, h2, h2, 64, 3, 1, 1, wt[2], wt[3], 192, s[2], 192));
  TRY(maxpool(st, n, s[2], h2, h2, 192, 3, s[3]));
  TRY(inception(st, n, k3a, s[3], h4, h4, wt + 4, s[4], s[5]));
  TRY(inception(st, n, k3b, s[5], h4, h4, wt + 12, s[4], s[6]));
  return maxpool(st, n, s[6], h4, h4, k3b.out(), 3, out);
}

// weights: 8 per inception block, 4a..4e, 5a, 5b
// scratch: red (n, g, g, 240), ping and pong (n, g, g, 832)
template <typename T>
int trunk_s45(const T* x, T* out, const T* const* wt, T* const* s, int n, int g,
              cudaStream_t st) {
  T* red = s[0];
  T* buf[2] = {s[1], s[2]};
  const T* cur = x;
  for (int i = 0; i < 5; ++i) {
    TRY(inception(st, n, k4[i], cur, g, g, wt + 8 * i, red, buf[i % 2]));
    cur = buf[i % 2];
  }
  const int g2 = ceil_out(g, 2, 2);
  TRY(maxpool(st, n, buf[0], g, g, k4[4].out(), 2, buf[1]));
  TRY(inception(st, n, k5a, buf[1], g2, g2, wt + 40, red, buf[0]));
  TRY(inception(st, n, k5b, buf[0], g2, g2, wt + 48, red, buf[1]));
  const int64_t total = static_cast<int64_t>(n) * k5b.out();
  gap_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      buf[1], out, g2 * g2, k5b.out(), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ENTRY(NAME, FN, T)                                                           \
  extern "C" int NAME(const void* x, void* out, const void* const* w,               \
                      void* const* s, int n, int h, void* stream) {                  \
    return FN<T>(static_cast<const T*>(x), static_cast<T*>(out),                     \
                 reinterpret_cast<const T* const*>(w), reinterpret_cast<T* const*>(s), \
                 n, h, static_cast<cudaStream_t>(stream));                           \
  }

ENTRY(srcf_fused_stage12_f32, fused_stage12, float)
ENTRY(srcf_fused_stage12_bf16, fused_stage12, __nv_bfloat16)
ENTRY(srcf_trunk_s23_f32, trunk_s23, float)
ENTRY(srcf_trunk_s23_bf16, trunk_s23, __nv_bfloat16)
ENTRY(srcf_trunk_s45_f32, trunk_s45, float)
ENTRY(srcf_trunk_s45_bf16, trunk_s45, __nv_bfloat16)
