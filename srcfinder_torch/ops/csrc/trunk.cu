// GoogLeNet trunk segments of the exact dense CNN, per window batch, NHWC:
//
//   fused_stage12  windows of side D read from a plane (N, D, D, 1 windows, or
//                  a padded scene and each window's origin) -> conv1 7x7/2
//                  pad 3 -> ceil-pool 3x3/2 -> conv2 1x1 -> conv3 3x3 pad 1
//                  -> ceil-pool 3x3/2 -> (N, D/8, D/8, 192)
//   trunk_s23      (N, h, h, 64) conv1 output, h = D/2 -> ceil-pool -> conv2
//                  -> conv3 -> ceil-pool -> trunk_s3
//   trunk_s3       (N, g, g, 192), g = D/8 -> inception3a -> inception3b
//                  -> ceil-pool -> (N, g/2, g/2, 480)
//   trunk_s45      (N, g, g, 480) -> inception4a..4e -> max-pool 2x2/2
//                  -> inception5a -> inception5b -> global average pool
//                  -> (N, 1024)
//   conv           one conv + bias + ReLU with the channel split, offsets
//                  and pixel strides the segments use, through their
//                  dispatch (to hold each conv shape against its plain
//                  version); conv_bf16_tile says which kernel it picks
//
// Every conv is BN-folded conv + bias + ReLU. fused_stage12 replaces the
// JAX package's Pallas kernel ops/trunk_fuse.py::fused_stage12 (git
// be3cd8d, :173, pl.pallas_call at :195); trunk_s23, trunk_s3 and trunk_s45
// replace its two segments of ops/trunk_fuse.py::fused_trunk_segment (git
// ca79403). Those kept one window's whole segment in VMEM. Here a window's
// s23 input alone is 2.1 MB in bf16, far above the 227 KB of shared memory
// a block can use, so from conv2's output on each layer is its own launch
// over the whole batch and intermediates go through device memory
// (scratch the caller allocates).
//
// Bound on this card: the convolutions, about 3.6 GFLOP per 256x256 window,
// against under 10 MB of bf16 feature maps per window: some 370 operations
// per byte, above the H100's 295 for bf16, so the arithmetic bounds the
// segments: operations over 989 TFLOP/s (bf16, tensor cores) or 67 TFLOP/s
// (f32, FMA pipes; TF32 stays off, it is not full precision). P2 alone is
// 1.04 GFLOP per window against the bytes of one window in (64 K pixels)
// and (D/8)^2 * 192 out: operations bound it too.
//
// P2's front (front_kernel): conv1 has one input channel, so its 16-byte
// im2col vectors would cross taps and the tensor-core conv cannot take it;
// on the FMA conv its 103 MFLOP per window outweighed P2's whole bf16
// bound, and its (D/2)^2 * 64 output made a round trip through device
// memory to pool1. front_kernel takes a tile of 8 x 8 pool1 outputs of one
// window: it loads the tile's 39 x 39 input halo straight from the plane
// (pixels outside the window read 0: the window's own zero padding, what
// the reference's crops see), computes conv1 for the 17 x 17 pixels the
// pools read (13% recomputed at the tile edges), pools in shared memory and
// runs conv2 on the pooled tile; only conv2's (D/4)^2 * 64 output reaches
// device memory. In bf16 both convs run on wgmma: conv1 as a GEMM of the
// 289 pixels (five m64 tiles) by 64 channels over its 49 taps padded to 64
// (zero weight rows, zero im2col columns), its im2col rows built in shared
// memory from the staged tile while the previous tile's wgmma runs; conv2
// reads the pooled tile, laid out as wgmma's A operand, straight from
// shared memory. One warpgroup and 72 KB a block, three blocks an SM. In
// f32 the same tiling runs on the FMA pipes (256 threads, 107 KB, two
// blocks an SM).
//
// Design:
// - conv_wgmma_kernel (bf16): an implicit GEMM on the tensor cores. Rows
//   are output pixels (the batch folded in), columns output channels, the
//   reduction runs over (ky, kx, cin) with cin fastest, from NHWC maps and
//   HWIO weights (a (K*K*Cin) x Cout row-major matrix). A block of two
//   warpgroups computes a 128 x BN tile (BN 64 or 128, whichever pads Cout
//   less), each warpgroup 64 rows with wgmma m64nBNk16 (bf16 in, f32
//   accumulate) reading both operands from shared memory: A K-major, B
//   N-major (the HWIO rows as they are, through wgmma's transpose of B),
//   both in the 128-byte swizzle. Every channel count, pixel stride and
//   channel offset of trunk_s23/trunk_s45 is a multiple of 8, so a 16-byte
//   vector of 8 bf16 never crosses a (ky, kx) tap: 64-deep slices of A
//   (im2col rows) and B are staged with 16-byte cp.async, zero-filled
//   (src-size 0) for the conv's padding and the ragged edges, into a ring
//   of 4 stages filled 2 slices ahead, while one wgmma group stays in
//   flight. The epilogue goes through shared memory so that the output
//   leaves in 16-byte chunks.
// - conv_kernel (f32, and bf16 convs the tensor-core kernel does not take):
//   the same GEMM view on the FMA pipes, a 128 x 64 block tile, an 8 x 4
//   register tile a thread, 16-deep slices staged in shared memory as f32.
// - Dispatch (launch(), tc_tile()): a bf16 conv goes to conv_wgmma_kernel
//   when Cin, Cout, the channel split and the input and output pixel
//   strides are multiples of 8 and the input, weight and output pointers
//   16-byte aligned; every conv of trunk_s23/trunk_s45 and P2's conv2/conv3
//   meet it; P2's conv1 runs inside front_kernel. Every f32 conv runs on
//   conv_kernel.
// - Epilogue of both: bias added and ReLU in f32, then one rounding to the
//   storage type, where the Pallas kernels rounded. The output goes to a
//   channel offset and pixel stride of the concatenated inception output
//   (no concatenation pass), and a channel split sends the first columns to
//   one map and the rest to another: that is how the three 1x1 convs that
//   read an inception's input run as one wide conv.
// - Branch 4 as the Pallas kernel ran it: the block input's 3x3/1 max pool
//   (-inf outside the map) is written once to scratch, then a plain 1x1
//   reads it (before, the 1x1's input load took nine taps for every
//   reduction element of every output-channel tile).
// - maxpool_kernel: k x k / stride windows, taps outside the map skipped
//   (-inf padding): ceil-mode 3x3/2, 2x2/2 and branch 4's 3x3/1 pad 1. A
//   thread reads and writes 16 bytes: 8 bf16 or 4 f32 channels.
// - gap_kernel: mean over pixels in f32, then rounded to the storage type.
// Not yet: TMA for the weights and the 1x1 convs' A tiles (plain 2-D boxes
// of an NHWC map) with a producer warp and mbarriers in place of the
// cp.async ring every thread feeds; persistent blocks that overlap one
// tile's epilogue with the next tile's loads; conv3 and pool2 inside P2's
// front kernel (conv3's 64 -> 192 channels over a 10 x 10 halo of the
// pooled tile would need 4x the pooled tile's shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

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

// ---- FMA implicit GEMM ------------------------------------------------------

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction slice
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 4;    // channels per thread
constexpr int NT = 256;  // threads per block: (BM / TM) x (BN / TN)

template <typename T>
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
      if (kv && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = to_f(a.x[(base[i] + static_cast<int64_t>(iy) * a.W + ix) * a.ldx + ci]);
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

// ---- tensor-core implicit GEMM (bf16, wgmma) --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false, 16 zero bytes (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int WG_BM = 128;      // output pixels per block: 64 per warpgroup
constexpr int WG_BK = 64;       // reduction slice: one 128-byte swizzle row
constexpr int WG_STAGES = 4;    // cp.async ring depth
constexpr int WG_THREADS = 256; // two warpgroups

template <int TBN>
struct Wg {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * TBN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = WG_STAGES * STAGE_BYTES + 1024;  // + aligning the ring
  static constexpr int A_ROWS = WG_BM * 8 / WG_THREADS;          // rows a thread stages
  static constexpr int B_CHUNKS = WG_BK * TBN / 8 / WG_THREADS;  // B chunks a thread stages
};

// 128-byte swizzle, the layout wgmma reads: 16-byte chunk c of the
// 128-byte row r at c ^ (r & 7), in 1024-byte atoms of 8 rows
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N, f32) += A (64 x 16, K-major) * B (16 x N, N-major), bf16, one
// warpgroup: scale-d 1 (accumulate), A and B not negated, B transposed
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int TBN>
__global__ void __launch_bounds__(WG_THREADS) conv_wgmma_kernel(const Conv<bf16> a) {
  using S = Wg<TBN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms 1024-aligned
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int tiles_n = (a.Cout + TBN - 1) / TBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / tiles_n) * WG_BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * TBN;
  const int Kd = a.K * a.K * a.Cin;
  const int KT = (Kd + WG_BK - 1) / WG_BK;

  // A staging: this thread copies chunk ac (8 channels) of rows
  // ar0 + i * WG_THREADS / 8 of every slice; all its rows are at the same
  // tap, so a slice costs one tap offset and a bounds test per row
  const int ac = tid & 7, ar0 = tid >> 3;
  int64_t row[S::A_ROWS];  // the row's tap (0, 0), relative to x
  int iy0[S::A_ROWS], ix0[S::A_ROWS];
#pragma unroll
  for (int i = 0; i < S::A_ROWS; ++i) {
    const int64_t m = m0 + ar0 + i * (WG_THREADS / 8);
    row[i] = 0;
    iy0[i] = -(1 << 29);  // rows past M read nothing
    ix0[i] = 0;
    if (m < a.M) {
      const int ox = static_cast<int>(m % a.Wo);
      const int64_t t = m / a.Wo;
      const int oy = static_cast<int>(t % a.Ho);
      iy0[i] = oy * a.stride - a.pad;
      ix0[i] = ox * a.stride - a.pad;
      row[i] = ((t / a.Ho) * a.H * a.W + static_cast<int64_t>(iy0[i]) * a.W + ix0[i]) * a.ldx;
    }
  }
  int k = ac * 8, ci = k % a.Cin, kx = (k / a.Cin) % a.K, ky = (k / a.Cin) / a.K;
  // B staging: chunk bc (8 channels) of reduction rows br0 + j * B_ROW_STEP
  constexpr int B_ROW_STEP = WG_THREADS / (TBN / 8);
  const int bc = tid % (TBN / 8), br0 = tid / (TBN / 8);
  const bool bv = n0 + bc * 8 < a.Cout;
  const bf16* wrow = a.w + static_cast<int64_t>(br0) * a.Cout + n0 + bc * 8;

  // A slice: WG_BM rows of 128 B (K-major); B slice: TBN / 64 atoms of
  // WG_BK rows of 64 channels (N-major)
  auto stage = [&](int slot, int kt) {
    const uint32_t sa = s0 + slot * S::STAGE_BYTES, sb = sa + S::A_BYTES;
    const bool kv = k < Kd;
    const int64_t tap = (static_cast<int64_t>(ky) * a.W + kx) * a.ldx + ci;
#pragma unroll
    for (int i = 0; i < S::A_ROWS; ++i) {
      const bool v = kv && static_cast<unsigned>(iy0[i] + ky) < static_cast<unsigned>(a.H) &&
                     static_cast<unsigned>(ix0[i] + kx) < static_cast<unsigned>(a.W);
      cp_async16(sa + sw128(ar0 + i * (WG_THREADS / 8), ac), v ? a.x + row[i] + tap : a.x, v);
    }
    k += WG_BK;
    ci += WG_BK;
    while (ci >= a.Cin) {
      ci -= a.Cin;
      if (++kx == a.K) {
        kx = 0;
        ++ky;
      }
    }
    const int64_t kb0 = static_cast<int64_t>(kt) * WG_BK;
#pragma unroll
    for (int j = 0; j < S::B_CHUNKS; ++j) {
      const int kk = br0 + j * B_ROW_STEP;
      const bool v = bv && kb0 + kk < Kd;
      cp_async16(sb + (bc >> 3) * (WG_BK * 128) + sw128(kk, bc & 7),
                 v ? wrow + (kb0 + j * B_ROW_STEP) * a.Cout : a.w, v);
    }
  };

  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;

  // slices are staged WG_STAGES - 2 ahead, so the slot being refilled was
  // read by the wgmma two slices back, which has completed
  constexpr int AHEAD = WG_STAGES - 2;
  for (int s = 0; s < AHEAD; ++s) {
    if (s < KT) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<AHEAD - 1>();  // slice kt has landed (this thread's part)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();             // every thread's part
    const uint32_t sa = s0 + (kt % WG_STAGES) * S::STAGE_BYTES, sb = sa + S::A_BYTES;
    // A: this warpgroup's 64 rows, 8-row atoms 1024 B apart; B: atoms of
    // 64 channels WG_BK * 128 B apart, 8-row atoms 1024 B apart
    const uint64_t da = smem_desc(sa + wg * 64 * 128, 16, 1024);
    const uint64_t db = smem_desc(sb, WG_BK * 128, 1024);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // k16 step: 32 B further along A's rows, two 8-row atoms down B
      if constexpr (TBN == 128)
        wgmma_n128(acc, da + 2 * kk, db + 128 * kk);
      else
        wgmma_n64(acc, da + 2 * kk, db + 128 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // slice kt - 1's wgmma has completed: its slot is free from the next
    // barrier on; slice kt's runs on while the next slice is staged
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (kt + AHEAD < KT) stage((kt + AHEAD) % WG_STAGES, kt + AHEAD);
    cp_async_commit();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  cp_async_wait<0>();

  // epilogue: bias, ReLU and the rounding into a bf16 tile in shared
  // memory (rows padded by 16 B against bank conflicts), then out in
  // 16-byte chunks of 8 channels, a row's chunks on neighbouring threads.
  // Accumulator j of 8 columns holds rows (lane >> 2) + 8 hf of the warp's
  // 16, columns 2 (lane & 3) + {0, 1}.
  constexpr int LDT = TBN * 2 + 16;  // tile row in bytes
  __syncthreads();                   // every warp is done with the ring
  unsigned char* tile = smem_raw + (s0 - smem_u32(smem_raw));
#pragma unroll
  for (int j = 0; j < TBN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2, n = n0 + c;
    const float b0 = n < a.Cout ? __bfloat162float(a.b[n]) : 0.f;
    const float b1 = n < a.Cout ? __bfloat162float(a.b[n + 1]) : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + hf * 8;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * LDT + c * 2) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hf] + b0, 0.f),
                                fmaxf(acc[4 * j + 2 * hf + 1] + b1, 0.f));
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = tid; e < WG_BM * (TBN / 8); e += WG_THREADS) {
    const int r = e / (TBN / 8), n = n0 + (e % (TBN / 8)) * 8;
    const int64_t m = m0 + r;
    if (m >= a.M || n >= a.Cout) continue;
    bf16* y = n < a.split ? a.y0 + m * a.ldy0 + n : a.y1 + m * a.ldy1 + (n - a.split);
    *reinterpret_cast<uint4*>(y) = *reinterpret_cast<const uint4*>(tile + r * LDT + (n - n0) * 2);
  }
}

// ---- pools ------------------------------------------------------------------

// (N, H, W, C) -> (N, Ho, Wo, C): window (oy s - pad, ox s - pad) of k x k,
// taps outside the map skipped; a thread takes 16 bytes of channels
template <typename T>
__global__ void maxpool_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                               int C, int Ho, int Wo, int k, int s, int pad,
                               int64_t total) {
  constexpr int V = 16 / sizeof(T);
  const int cv = C / V;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % cv) * V;
    int64_t t = e / cv;
    const int ox = static_cast<int>(t % Wo);
    t /= Wo;
    const int oy = static_cast<int>(t % Ho);
    const int64_t n = t / Ho;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = -INFINITY;
    const int y0 = oy * s - pad, x0 = ox * s - pad;
    for (int yy = max(y0, 0); yy < min(y0 + k, H); ++yy)
      for (int xx = max(x0, 0); xx < min(x0 + k, W); ++xx) {
        const uint4 q = *reinterpret_cast<const uint4*>(x + ((n * H + yy) * W + xx) * C + c);
        const T* p = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = fmaxf(v[i], to_f(p[i]));
      }
    uint4 o;
    T* p = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(y + e * V) = o;
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

// ---- P2's front: window gather, conv1, pool1 and conv2 in one kernel --------

constexpr int FT = 8;             // pool1 outputs per tile side
constexpr int F1 = 2 * FT + 1;    // conv1 outputs per tile side: the pools' halo
constexpr int F1N = F1 * F1;      // conv1 outputs per tile
constexpr int FIN = 4 * FT + 7;   // input pixels per tile side: conv1's halo
constexpr int FP = FT * FT;       // pool1 outputs per tile

// Windows of side d in a plane of rows x cols pixels with row pitch pitch:
// window b's pixel (y, x) is src[(origins[2b] + y) * pitch + origins[2b+1] + x].
// Pixels outside the window read 0 (the window's zero padding), and so do
// pixels outside the plane. y: conv2's output (n, h2, h2, 64).
template <typename T>
struct Front {
  const T* src;
  int64_t pitch, rows, cols;
  const int64_t* origins;
  const T* w1;  // conv1 (49, 64), taps ky * 7 + kx
  const T* b1;
  const T* w2;  // conv2 (64, 64)
  const T* b2;
  T* y;
  int d, h1, h2, tiles;  // window side, conv1 and pool1 sides, tiles a side
};

// Byte offset of 16-byte chunk q of row m of a map of 64 channels a row.
// 128-byte rows (bf16) are wgmma's 128-byte swizzle (sw128); 256-byte rows
// (f32) xor the same bits. A quarter-warp that reads or writes one chunk
// of 8 consecutive rows, or the chunks of one row, meets no bank conflict.
template <typename T>
__device__ __forceinline__ int map_off(int m, int q) {
  return m * static_cast<int>(64 * sizeof(T)) + ((q ^ (m & 7)) << 4);
}

// the tile's FIN x FIN input halo into in[]; input tile row 0 is window row
// 4 FT ty - 3 (conv1's first output row of the tile, 2 FT ty, less its pad)
template <typename T>
__device__ __forceinline__ void front_input(const Front<T>& a, int b, int ty, int tx, T* in,
                                            int nthreads) {
  const int64_t r0 = a.origins[2 * b], c0 = a.origins[2 * b + 1];
  const int iy0 = 4 * FT * ty - 3, ix0 = 4 * FT * tx - 3;
  for (int e = threadIdx.x; e < FIN * FIN; e += nthreads) {
    const int iy = iy0 + e / FIN, ix = ix0 + e % FIN;
    const int64_t r = r0 + iy, c = c0 + ix;
    const bool v = iy >= 0 && iy < a.d && ix >= 0 && ix < a.d && r >= 0 && r < a.rows &&
                   c >= 0 && c < a.cols;
    in[e] = v ? a.src[r * a.pitch + c] : from_f<T>(0.f);
  }
}

// ceil-mode 3x3/2 pool of the F1 x F1 conv1 map into the FT x FT pooled
// tile; taps past conv1's last row or column are skipped (-inf padding),
// pooled pixels past pool1's map are 0 (their conv2 rows are dropped)
template <typename T>
__device__ __forceinline__ void front_pool(const Front<T>& a, int ty, int tx,
                                           const unsigned char* map, unsigned char* pooled,
                                           int nthreads) {
  constexpr int V = 16 / sizeof(T), CH = 64 / V;
  for (int e = threadIdx.x; e < FP * CH; e += nthreads) {
    const int p = e / CH, q = e % CH, py = p / FT, px = p % FT;
    const int gy = FT * ty + py, gx = FT * tx + px;
    const bool inside = gy < a.h2 && gx < a.h2;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = inside ? -INFINITY : 0.f;
    if (inside)
      for (int dy = 0; dy < 3 && 2 * gy + dy < a.h1; ++dy)
        for (int dx = 0; dx < 3 && 2 * gx + dx < a.h1; ++dx) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              map + map_off<T>((2 * py + dy) * F1 + 2 * px + dx, q));
          const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = fmaxf(v[i], to_f(t[i]));
        }
    uint4 o;
    T* t = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(pooled + map_off<T>(p, q)) = o;
  }
}

// bf16: one warpgroup. Shared memory from a 1024-byte-aligned base: two A
// slots of conv1's im2col (64 rows of 64 taps; the pooled tile, conv2's
// A, later takes slot 0), conv1's and conv2's weights as wgmma's B (64
// reduction rows of 64 channels), the conv1 map (later conv2's output on
// its way out), the input tile.
constexpr int FB_THREADS = 128;
constexpr int FB_MT = (F1N + 63) / 64;   // conv1's m64 tiles
constexpr int FB_A = 0, FB_W1 = 2 * 8192, FB_W2 = FB_W1 + 8192, FB_MAP = FB_W2 + 8192;
constexpr int FB_IN = FB_MAP + F1N * 128;
constexpr int FB_SMEM = FB_IN + FIN * FIN * 2 + 1024;

// conv1 tap k's offset in the input tile, or -1 for the padded taps 49..63
__host__ __device__ constexpr int tap_off(int k) { return k < 49 ? (k / 7) * FIN + k % 7 : -1; }

__device__ __forceinline__ void front_bf16(const Front<bf16>& a, unsigned char* raw) {
  const uint32_t s0 = (smem_u32(raw) + 1023) & ~1023u;
  unsigned char* sm = raw + (s0 - smem_u32(raw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = a.tiles * a.tiles;
  const int b = blockIdx.x / per, ty = blockIdx.x % per / a.tiles, tx = blockIdx.x % a.tiles;

  // weights as wgmma's B (N-major, as conv_wgmma_kernel stages them);
  // conv1's reduction rows 49..63 zero
  for (int e = tid; e < 2 * 64 * 8; e += FB_THREADS) {
    const int second = e >= 512, k = e / 8 % 64, q = e % 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (second || k < 49)
      v = *reinterpret_cast<const uint4*>((second ? a.w2 : a.w1) + k * 64 + q * 8);
    *reinterpret_cast<uint4*>(sm + (second ? FB_W2 : FB_W1) + sw128(k, q)) = v;
  }
  front_input(a, b, ty, tx, reinterpret_cast<bf16*>(sm + FB_IN), FB_THREADS);
  // biases of this thread's accumulator columns 8 j + 2 (lane & 3) + {0, 1}
  float bias1[16], bias2[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bias1[2 * j + h] = __bfloat162float(a.b1[8 * j + 2 * (lane & 3) + h]);
      bias2[2 * j + h] = __bfloat162float(a.b2[8 * j + 2 * (lane & 3) + h]);
    }
  __syncthreads();

  // im2col of conv1's m64 tile t into A slot t & 1: this thread writes row
  // tid & 63 (pixel m = r F1 + c, reading input (2r + ky, 2c + kx)),
  // chunks q0 + 2i of 8 taps; a warp's lanes read neighbouring pixels,
  // 4 bytes apart, so the stride-2 reads meet no bank conflict. Rows past
  // the tile's F1N pixels keep an earlier tile's finite values; their
  // outputs are dropped.
  const unsigned short* in16 = reinterpret_cast<const unsigned short*>(sm + FB_IN);
  const int rr = tid & 63, q0 = tid >> 6;
  auto build = [&](int t) {
    const int m = 64 * t + rr;
    if (m >= F1N) return;
    const unsigned short* p = in16 + 2 * (m / F1) * FIN + 2 * (m % F1);
    unsigned char* A = sm + FB_A + (t & 1) * 8192;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * i + 2 * e;
        const int lo = q0 ? tap_off(k + 8) : tap_off(k);
        const int hi = q0 ? tap_off(k + 9) : tap_off(k + 1);
        w[e] = (lo < 0 ? 0u : static_cast<uint32_t>(p[lo])) |
               (hi < 0 ? 0u : static_cast<uint32_t>(p[hi]) << 16);
      }
      *reinterpret_cast<uint4*>(A + sw128(rr, q0 + 2 * i)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  const uint64_t db1 = smem_desc(s0 + FB_W1, 8192, 1024);
  const uint64_t db2 = smem_desc(s0 + FB_W2, 8192, 1024);
  float acc[32];
  build(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int t = 0; t < FB_MT; ++t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t da = smem_desc(s0 + FB_A + (t & 1) * 8192, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64(acc, da + 2 * kk, db1 + 128 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < FB_MT) build(t + 1);  // the other slot, while this tile's wgmma runs
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // bias, ReLU and one rounding into the conv1 map
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = 64 * t + warp * 16 + (lane >> 2) + 8 * hf;
        if (m < F1N)
          *reinterpret_cast<__nv_bfloat162*>(sm + FB_MAP + map_off<bf16>(m, j) + (lane & 3) * 4) =
              __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hf] + bias1[2 * j], 0.f),
                                    fmaxf(acc[4 * j + 2 * hf + 1] + bias1[2 * j + 1], 0.f));
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // pool1 into A slot 0 (its last wgmma has completed), then conv2
  front_pool(a, ty, tx, sm + FB_MAP, sm + FB_A, FB_THREADS);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t da = smem_desc(s0 + FB_A, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64(acc, da + 2 * kk, db2 + 128 * kk);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  // conv2's tile through the (dead) conv1 map, then out in 16-byte chunks:
  // a pixel's 128 bytes on 8 neighbouring threads
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = warp * 16 + (lane >> 2) + 8 * hf;
      *reinterpret_cast<__nv_bfloat162*>(sm + FB_MAP + map_off<bf16>(p, j) + (lane & 3) * 4) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hf] + bias2[2 * j], 0.f),
                                fmaxf(acc[4 * j + 2 * hf + 1] + bias2[2 * j + 1], 0.f));
    }
  __syncthreads();
  for (int e = tid; e < FP * 8; e += FB_THREADS) {
    const int p = e / 8, q = e % 8, gy = FT * ty + p / FT, gx = FT * tx + p % FT;
    if (gy < a.h2 && gx < a.h2)
      *reinterpret_cast<uint4*>(a.y + ((static_cast<int64_t>(b) * a.h2 + gy) * a.h2 + gx) * 64 +
                                q * 8) =
          *reinterpret_cast<const uint4*>(sm + FB_MAP + map_off<bf16>(p, q));
  }
}

// f32: 256 threads on the FMA pipes. Shared memory: conv1's weights and the
// input tile (the pooled tile later takes both), conv2's weights, the
// conv1 map.
constexpr int FF_THREADS = 256;
constexpr int FF_W1 = 0, FF_IN = 49 * 64 * 4, FF_POOL = 0;
constexpr int FF_W2 = (FF_IN + FIN * FIN * 4 + 15) / 16 * 16;
constexpr int FF_MAP = FF_W2 + 64 * 64 * 4;
constexpr int FF_SMEM = FF_MAP + F1N * 256;
static_assert(FP * 256 <= FF_W2, "the pooled tile must fit over conv1's weights and input");

__device__ __forceinline__ void front_f32(const Front<float>& a, unsigned char* sm) {
  const int tid = threadIdx.x;
  const int per = a.tiles * a.tiles;
  const int b = blockIdx.x / per, ty = blockIdx.x % per / a.tiles, tx = blockIdx.x % a.tiles;
  float* w1 = reinterpret_cast<float*>(sm + FF_W1);
  float* w2 = reinterpret_cast<float*>(sm + FF_W2);
  float* in = reinterpret_cast<float*>(sm + FF_IN);
  for (int e = tid; e < 49 * 64; e += FF_THREADS) w1[e] = a.w1[e];
  for (int e = tid; e < 64 * 64; e += FF_THREADS) w2[e] = a.w2[e];
  front_input(a, b, ty, tx, in, FF_THREADS);
  __syncthreads();

  // conv1 in two rounds of 160 pixels: this thread's channels 4 cg + {0..3}
  // and 32 + 4 cg + {0..3} (a quarter-warp reads 128 contiguous weight
  // bytes), pixels 160 round + pg + 32 i
  const int cg = tid & 7, pg = tid >> 3;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias[j] = a.b1[4 * cg + j];
    bias[4 + j] = a.b1[32 + 4 * cg + j];
  }
  for (int round = 0; round < 2; ++round) {
    int base[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int m = 160 * round + pg + 32 * i;
      base[i] = m < F1N ? 2 * (m / F1) * FIN + 2 * (m % F1) : 0;
    }
    float acc[5][8];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < 49; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(w1 + k * 64 + 4 * cg);
      const float4 v = *reinterpret_cast<const float4*>(w1 + k * 64 + 32 + 4 * cg);
      const float wv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float x = in[base[i] + (k / 7) * FIN + k % 7];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int m = 160 * round + pg + 32 * i;
      if (m >= F1N) continue;
      float r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = fmaxf(acc[i][j] + bias[j], 0.f);
      *reinterpret_cast<float4*>(sm + FF_MAP + map_off<float>(m, cg)) =
          make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(sm + FF_MAP + map_off<float>(m, 8 + cg)) =
          make_float4(r[4], r[5], r[6], r[7]);
    }
  }
  __syncthreads();
  front_pool(a, ty, tx, sm + FF_MAP, sm + FF_POOL, FF_THREADS);
  __syncthreads();

  // conv2: this thread's channels 4 cg2 + {0..3}, pixels pg2 + 16 i; out
  // straight to device memory, a pixel's 256 bytes on 16 neighbouring threads
  const int cg2 = tid & 15, pg2 = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int q = 0; q < 16; ++q) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(sm + FF_POOL + map_off<float>(pg2 + 16 * i, q));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(w2 + (4 * q + kk) * 64 + 4 * cg2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
        acc[i][0] = fmaf(xv, w.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg2 + 16 * i, gy = FT * ty + p / FT, gx = FT * tx + p % FT;
    if (gy >= a.h2 || gx >= a.h2) continue;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = fmaxf(acc[i][j] + a.b2[4 * cg2 + j], 0.f);
    *reinterpret_cast<float4*>(a.y + ((static_cast<int64_t>(b) * a.h2 + gy) * a.h2 + gx) * 64 +
                               4 * cg2) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <typename T> struct FrontCfg;
template <> struct FrontCfg<bf16> {
  static constexpr int THREADS = FB_THREADS, SMEM = FB_SMEM, BLOCKS = 3;
};
template <> struct FrontCfg<float> {
  static constexpr int THREADS = FF_THREADS, SMEM = FF_SMEM, BLOCKS = 2;
};

// one block per (window, 8 x 8 tile of pool1 outputs)
template <typename T>
__global__ void __launch_bounds__(FrontCfg<T>::THREADS, FrontCfg<T>::BLOCKS)
    front_kernel(const Front<T> a) {
  extern __shared__ __align__(16) unsigned char front_smem[];
  if constexpr (std::is_same<T, bf16>::value)
    front_bf16(a, front_smem);
  else
    front_f32(a, front_smem);
}

// ---- host side --------------------------------------------------------------

#define TRY(expr)                      \
  do {                                 \
    const int err_ = (expr);           \
    if (err_ != 0) return err_;        \
  } while (0)

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_fma(const Conv<T>& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((a.M + BM - 1) / BM), (a.Cout + BN - 1) / BN);
  conv_kernel<T><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Conv<float>& a, cudaStream_t st) { return launch_fma(a, st); }

// The dispatch rule: the tensor cores take a bf16 conv whose 16-byte
// vectors of 8 channels stay inside one tap and aligned, with the block
// tile width BN that pads Cout less (128 on a tie); 0: conv_kernel.
int tc_tile(const Conv<bf16>& a) {
  const bool tc = a.Cin % 8 == 0 && a.Cout % 8 == 0 && a.split % 8 == 0 && a.ldx % 8 == 0 &&
                  a.ldy0 % 8 == 0 && a.ldy1 % 8 == 0 && aligned16(a.x) && aligned16(a.w) &&
                  aligned16(a.y0) && aligned16(a.y1);
  if (!tc) return 0;
  return a.Cout % 128 == 0 || a.Cout % 128 > 64 ? 128 : 64;
}

template <int TBN>
int launch_wgmma(const Conv<bf16>& a, cudaStream_t st) {
  using S = Wg<TBN>;
  TRY(static_cast<int>(cudaFuncSetAttribute(
      conv_wgmma_kernel<TBN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM)));
  const int64_t blocks = (a.M + WG_BM - 1) / WG_BM * ((a.Cout + TBN - 1) / TBN);
  conv_wgmma_kernel<TBN><<<static_cast<unsigned>(blocks), WG_THREADS, S::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Conv<bf16>& a, cudaStream_t st) {
  switch (tc_tile(a)) {
    case 128: return launch_wgmma<128>(a, st);
    case 64: return launch_wgmma<64>(a, st);
    default: return launch_fma(a, st);
  }
}

int ceil_out(int h, int k, int s) { return (h - k + s - 1) / s + 1; }

template <typename T>
Conv<T> make_conv(int n, const T* x, int64_t ldx, int H, int W, int Cin, int K, int stride,
                  int pad, const T* w, const T* b, int Cout, T* y0, int64_t ldy0, int split,
                  T* y1, int64_t ldy1) {
  Conv<T> a;
  a.x = x; a.ldx = ldx; a.H = H; a.W = W; a.Cin = Cin;
  a.K = K; a.stride = stride; a.pad = pad;
  a.Ho = (H + 2 * pad - K) / stride + 1;
  a.Wo = (W + 2 * pad - K) / stride + 1;
  a.Cout = Cout; a.w = w; a.b = b;
  a.y0 = y0; a.ldy0 = ldy0; a.y1 = y1; a.ldy1 = ldy1; a.split = split;
  a.M = static_cast<int64_t>(n) * a.Ho * a.Wo;
  return a;
}

// conv + bias + ReLU of an (n, H, W, Cin) map; see Conv for the outputs
template <typename T>
int conv(cudaStream_t st, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y0,
         int64_t ldy0, int split, T* y1, int64_t ldy1) {
  return launch(make_conv(n, x, ldx, H, W, Cin, K, stride, pad, w, b, Cout, y0, ldy0, split,
                          y1, ldy1), st);
}

// plain conv: all Cout channels to one map with pixel stride ldy
template <typename T>
int conv(cudaStream_t st, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y,
         int64_t ldy) {
  return conv(st, n, x, ldx, H, W, Cin, K, stride, pad, w, b, Cout, y, ldy, Cout, y, ldy);
}

// k x k / s max pool of a contiguous (n, H, W, C) map, padding pad: ceil
// mode at pad 0; C a multiple of the 16-byte vector
template <typename T>
int maxpool(cudaStream_t st, int n, const T* x, int H, int W, int C, int k, int s, int pad,
            T* y) {
  constexpr int V = 16 / sizeof(T);
  if (C % V != 0 || !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = ceil_out(H + 2 * pad, k, s), Wo = ceil_out(W + 2 * pad, k, s);
  const int64_t total = static_cast<int64_t>(n) * Ho * Wo * (C / V);
  const int64_t blocks = (total + 255) / 256;
  maxpool_kernel<T><<<static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0, st>>>(
      x, y, H, W, C, Ho, Wo, k, s, pad, total);
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
// branch4's 1x1 (cin, proj) and bias. Scratch: red (n, h, w, red3 + red5),
// pooled (n, h, w, cin).
template <typename T>
int inception(cudaStream_t st, int n, const Plan& p, const T* x, int h, int w,
              const T* const* wt, T* red, T* pooled, T* y) {
  const int cr = p.red3 + p.red5, co = p.out();
  // the three 1x1s as one conv: [0, ch1) -> y, the reductions -> red
  TRY(conv(st, n, x, p.cin, h, w, p.cin, 1, 1, 0, wt[0], wt[1], p.ch1 + cr, y, co,
           p.ch1, red, cr));
  TRY(conv(st, n, red, cr, h, w, p.red3, 3, 1, 1, wt[2], wt[3], p.ch3, y + p.ch1, co));
  TRY(conv(st, n, red + p.red3, cr, h, w, p.red5, 3, 1, 1, wt[4], wt[5], p.ch5,
           y + p.ch1 + p.ch3, co));
  // branch 4: the block input's 3x3/1 max pool once, then a plain 1x1
  TRY(maxpool(st, n, x, h, w, p.cin, 3, 1, 1, pooled));
  TRY(conv(st, n, pooled, p.cin, h, w, p.cin, 1, 1, 0, wt[6], wt[7], p.proj,
           y + p.ch1 + p.ch3 + p.ch5, co));
  return 0;
}

template <typename T>
int front(const Front<T>& a, int n, cudaStream_t st) {
  using C = FrontCfg<T>;
  if (!aligned16(a.w1) || !aligned16(a.w2) || !aligned16(a.y))
    return static_cast<int>(cudaErrorInvalidValue);
  TRY(static_cast<int>(cudaFuncSetAttribute(
      front_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)));
  TRY(static_cast<int>(cudaFuncSetAttribute(
      front_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared)));
  const int64_t blocks = static_cast<int64_t>(n) * a.tiles * a.tiles;
  front_kernel<T><<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// windows: see Front (origins (n, 2) of int64)
// weights: conv1 (7, 7, 1, 64), b1, conv2 (64, 64), b2, conv3 (3, 3, 64, 192), b3
// scratch: c2 (n, d/4, d/4, 64), c3 (same, 192)
template <typename T>
int fused_stage12(const T* src, int64_t pitch, int64_t rows, int64_t cols,
                  const int64_t* origins, T* out, const T* const* wt, T* const* s, int n,
                  int d, cudaStream_t st) {
  Front<T> a;
  a.src = src; a.pitch = pitch; a.rows = rows; a.cols = cols; a.origins = origins;
  a.w1 = wt[0]; a.b1 = wt[1]; a.w2 = wt[2]; a.b2 = wt[3]; a.y = s[0];
  a.d = d;
  a.h1 = (d - 1) / 2 + 1;
  a.h2 = ceil_out(a.h1, 3, 2);
  a.tiles = (a.h2 + FT - 1) / FT;
  TRY(front(a, n, st));
  TRY(conv(st, n, s[0], 64, a.h2, a.h2, 64, 3, 1, 1, wt[4], wt[5], 192, s[1], 192));
  return maxpool(st, n, s[1], a.h2, a.h2, 192, 3, 2, 0, out);
}

// weights: 8 per inception block, 3a and 3b (see inception)
// scratch: red (n, g, g, 160), pooled (n, g, g, 256), i3a (n, g, g, 256),
// i3b (n, g, g, 480)
template <typename T>
int trunk_s3(const T* x, T* out, const T* const* wt, T* const* s, int n, int g,
             cudaStream_t st) {
  TRY(inception(st, n, k3a, x, g, g, wt, s[0], s[1], s[2]));
  TRY(inception(st, n, k3b, s[2], g, g, wt + 8, s[0], s[1], s[3]));
  return maxpool(st, n, s[3], g, g, k3b.out(), 3, 2, 0, out);
}

// weights: conv2, b2, conv3, b3, then trunk_s3's
// scratch: p1 (n, h/2, h/2, 64), c2 (same), c3 (n, h/2, h/2, 192),
// p2 (n, h/4, h/4, 192), red (n, h/4, h/4, 160), i3a (n, h/4, h/4, 256),
// i3b (n, h/4, h/4, 480)
template <typename T>
int trunk_s23(const T* x, T* out, const T* const* wt, T* const* s, int n, int h,
              cudaStream_t st) {
  const int h2 = ceil_out(h, 3, 2), h4 = ceil_out(h2, 3, 2);
  TRY(maxpool(st, n, x, h, h, 64, 3, 2, 0, s[0]));
  TRY(conv(st, n, s[0], 64, h2, h2, 64, 1, 1, 0, wt[0], wt[1], 64, s[1], 64));
  TRY(conv(st, n, s[1], 64, h2, h2, 64, 3, 1, 1, wt[2], wt[3], 192, s[2], 192));
  TRY(maxpool(st, n, s[2], h2, h2, 192, 3, 2, 0, s[3]));
  // c2 = s[1] is dead from here; its (h/2)^2 * 64 elements are exactly
  // (h/4)^2 * 256, so it holds branch 4's pooled input of 3a (192
  // channels) and of 3b (256) with no scratch of its own
  T* const s3[4] = {s[4], s[1], s[5], s[6]};
  return trunk_s3(s[3], out, wt + 4, s3, n, h4, st);
}

// weights: 8 per inception block, 4a..4e, 5a, 5b
// scratch: red (n, g, g, 240), ping and pong (n, g, g, 832), pooled (n, g, g, 832)
template <typename T>
int trunk_s45(const T* x, T* out, const T* const* wt, T* const* s, int n, int g,
              cudaStream_t st) {
  T* red = s[0];
  T* buf[2] = {s[1], s[2]};
  T* pooled = s[3];
  const T* cur = x;
  for (int i = 0; i < 5; ++i) {
    TRY(inception(st, n, k4[i], cur, g, g, wt + 8 * i, red, pooled, buf[i % 2]));
    cur = buf[i % 2];
  }
  const int g2 = ceil_out(g, 2, 2);
  TRY(maxpool(st, n, buf[0], g, g, k4[4].out(), 2, 2, 0, buf[1]));
  TRY(inception(st, n, k5a, buf[1], g2, g2, wt + 40, red, pooled, buf[0]));
  TRY(inception(st, n, k5b, buf[0], g2, g2, wt + 48, red, pooled, buf[1]));
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

ENTRY(srcf_trunk_s23_f32, trunk_s23, float)
ENTRY(srcf_trunk_s23_bf16, trunk_s23, bf16)
ENTRY(srcf_trunk_s3_f32, trunk_s3, float)
ENTRY(srcf_trunk_s3_bf16, trunk_s3, bf16)
ENTRY(srcf_trunk_s45_f32, trunk_s45, float)
ENTRY(srcf_trunk_s45_bf16, trunk_s45, bf16)

// P2 over n windows of side d in a plane (see Front)
#define STAGE12_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* src, int64_t pitch, int64_t rows, int64_t cols,      \
                      const void* origins, void* out, const void* const* w,            \
                      void* const* s, int n, int d, void* stream) {                     \
    return fused_stage12<T>(static_cast<const T*>(src), pitch, rows, cols,             \
                            static_cast<const int64_t*>(origins), static_cast<T*>(out), \
                            reinterpret_cast<const T* const*>(w),                       \
                            reinterpret_cast<T* const*>(s), n, d,                       \
                            static_cast<cudaStream_t>(stream));                         \
  }

STAGE12_ENTRY(srcf_fused_stage12_f32, float)
STAGE12_ENTRY(srcf_fused_stage12_bf16, bf16)

// one conv through the segments' dispatch; see Conv for the arguments
#define CONV_ARGS                                                                    \
  const void *x, int64_t ldx, int n, int H, int W, int Cin, int K, int stride,       \
      int pad, const void *w, const void *b, int Cout, void *y0, int64_t ldy0,       \
      int split, void *y1, int64_t ldy1
#define MAKE_CONV(T)                                                                   \
  make_conv<T>(n, static_cast<const T*>(x), ldx, H, W, Cin, K, stride, pad,            \
               static_cast<const T*>(w), static_cast<const T*>(b), Cout,               \
               static_cast<T*>(y0), ldy0, split, static_cast<T*>(y1), ldy1)

extern "C" int srcf_conv_f32(CONV_ARGS, void* stream) {
  return launch(MAKE_CONV(float), static_cast<cudaStream_t>(stream));
}
extern "C" int srcf_conv_bf16(CONV_ARGS, void* stream) {
  return launch(MAKE_CONV(bf16), static_cast<cudaStream_t>(stream));
}
// the tile srcf_conv_bf16 would launch for these arguments (tc_tile):
// 64 or 128 on the tensor cores, 0 on conv_kernel; launches nothing
extern "C" int srcf_conv_bf16_tile(CONV_ARGS) { return tc_tile(MAKE_CONV(bf16)); }
