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
//                  version); conv_f32_tile / conv_bf16_tile say which
//                  kernel it picks
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
// segments: operations over 989 TFLOP/s in bf16 (tensor cores). In f32 the
// FMA pipes give 67 TFLOP/s; single-pass TF32 on the tensor cores (495
// TFLOP/s) keeps 10 mantissa bits, about three decimal digits, so it is not
// full precision and stays off. Three TF32 products of a hi/lo split of each
// operand (3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, the lo_a lo_b term
// below 2^-22 of the product dropped) carry about 22 bits, what an f32 sum
// of products keeps, at 3 x operations / 495 TFLOP/s: 2.5x the FMA pipes'
// ceiling, which bounds the f32 segments. P2 alone is 1.04 GFLOP per window
// against the bytes of one window in (64 K pixels) and (D/8)^2 * 192 out:
// operations bound it too.
//
// P2's front (front_kernel): conv1 has one input channel, so its 16-byte
// im2col vectors would cross taps and the tensor-core conv cannot take it;
// on the FMA pipes its 103 MFLOP per window outweighed P2's whole bf16
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
//   HWIO weights (a (K*K*Cin) x Cout row-major matrix). Every channel
//   count, pixel stride and channel offset of the segments is a multiple
//   of 8, so a 16-byte vector of 8 bf16 never crosses a (ky, kx) tap. A
//   tile is 128 pixels x BN channels, BN from Cout: the fewest column tiles
//   of at most 256, each its share of Cout rounded up to 32, so wherever
//   Cout <= 256 one tile reads each im2col row once (conv3, 3b.branch2 and
//   3a.wide: one tile of 192, where 64-wide tiles staged A three times).
//   A narrow tile was bound by shared memory: at BN 64 its wgmma read 2 KB
//   of A and 2 KB of B for every 1 MFLOP of a k16 step, about 60% of the
//   tensor cores' rate at 128 B a clock; at BN 192, about 95%.
//   Warp-specialised and persistent: one block an SM (384 threads, up to
//   ~215 KB of shared memory) walks the output tiles m-major, the column
//   tiles of one m tile on neighbouring blocks, so their A stays in L2.
//   Warpgroup 0, its registers lowered by setmaxnreg, fills a ring of
//   3-8 stages of 64-deep slices, each guarded by a full and an empty
//   mbarrier: B in boxes of 64 channels by TMA (128-byte swizzle, N-major,
//   as wgmma reads it through its transpose of B; at BN = 32 mod 64 wgmma
//   reads half of the last box), A by TMA where it is a plain 2-D box (a
//   1x1 conv: 128 pixel rows at pixel stride ldx, 128-byte swizzle,
//   K-major), else by 16-byte cp.async of the producer's 128 threads,
//   zero-filled (src-size 0) for the padding and the ragged edges and
//   signalled with cp.async.mbarrier.arrive; TMA fills past the map or the
//   weights with 0. Warpgroups 1 and 2 (registers raised) each run wgmma
//   m64nBNk16 on 64 rows of a slice as soon as its full barrier completes,
//   keep the next slice's group issued behind it, and release a stage once
//   its wgmma has retired: no block-wide barrier in the loop. Each ends a
//   tile with bias, ReLU and the rounding into its own tile in shared
//   memory, then 16-byte stores a row's chunks on neighbouring threads
//   (4-byte stores straight from the accumulators, a quad's 16 B of a row
//   each, took longer than the tile's wgmma), while the producer runs
//   ahead into the next tile. No split-K, no atomics: repeats are
//   bit-identical.
// - conv_tf32x3_kernel (f32): conv_wgmma_kernel's walk, ring, producer and
//   epilogue (the same device functions, ring_init, conv_producer and
//   conv_epilogue, on slices of one 128-byte swizzle row of either type) on
//   wgmma m64nBNk8 with tf32 operands, as 3xTF32: each operand v rounded to
//   hi = tf32(v) and lo = tf32(v - hi) (cvt.rna, low 13 bits cleared), and
//   per k8 step lo_a hi_b, then hi_a lo_b, then hi_a hi_b, small terms
//   first (lo_a lo_b, below 2^-22 of the product, dropped). tf32 wgmma
//   takes no transpose, so B must be K-major, and the HWIO weight rows are
//   N-major: conv_tf32x3_kernel_split splits the weights once a conv into
//   hi and lo, each Cout rows of K*K*Cin, into scratch the caller
//   gives (a segment one for all its convs, as large as its largest conv's
//   pair: 5.3 MB in trunk_s45; stream order keeps a conv from reading what
//   the next conv's split writes), and the producer brings both by TMA in
//   boxes of BN rows x 32 (128-byte swizzle). A lands as loaded, in 32-deep
//   slices (one 128-byte swizzle row of f32), by TMA (1x1) or cp.async;
//   each consumer brings its 64 rows' fragments into registers by ldmatrix
//   while the previous slice's wgmma runs, rounds them into hi and lo
//   there, and runs the slice's 12 wgmma with A from registers: no split
//   pass through shared memory, no block-wide barrier in the loop. The 12
//   steps of a slice start a partial sum of their own: the tensor cores
//   round their accumulation toward zero, a bias that grows with the steps
//   one accumulator takes, so once a slice's wgmma have retired its
//   partial is added into the f32 sum by FADD, rounding to nearest, before
//   the next slice's are issued. A consumer thread holds the sum and the
//   partial, BN registers, beside 32 of A's fragments, so the f32 tile
//   stops at 128 channels (3 stages of 48 KB and two 33 KB epilogue tiles
//   there). What bounds it: shared memory carries a slice's A and B in (16
//   KB + 256 BN bytes), A out once to the registers (16 KB) and B three
//   times to each consumer's wgmma (768 BN bytes): by byte count 0.83x the
//   tensor cores' time a slice at BN 128, 1.0x at 64, 1.33x at 32. No
//   split-K, no atomics: repeats are bit-identical.
// - Dispatch (launch(), tc_ok(), tc_tile()): a conv goes to the tensor-core
//   kernel of its dtype when Cin, Cout, the channel split and the input and
//   output pixel strides are multiples of the 16-byte vector (8 bf16, 4
//   f32) and the input, weight and output pointers 16-byte aligned, so a
//   vector never crosses a (ky, kx) tap; every conv of
//   trunk_s23/trunk_s3/trunk_s45 and P2's conv3 meets it in both dtypes
//   (every channel count, offset and stride is a multiple of 8); P2's conv1
//   and conv2 run inside front_kernel. The tile width, one rule for both:
//   the fewest column tiles of at most 256 channels (bf16) or 128 (f32),
//   each as wide as their share of Cout rounded up to a granule of 32 (bf16:
//   half a B box) or 16 (f32). No kernel takes a conv the rule refuses:
//   launch() returns an error for it, and the wrapper raises. The library
//   counts the conv launches by dtype and tile width
//   (srcf_conv_f32_launches, srcf_conv_bf16_launches).
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
// Not yet: B shared by a cluster of two blocks through TMA multicast (it
// halves the weights' L2 reads, but a first try ran at half speed); two
// blocks an SM for the narrow tiles of both convs; conv3 and pool2 inside
// P2's front kernel (conv3's 64 -> 192 channels over a 10 x 10 halo of the
// pooled tile would need 4x the pooled tile's shared memory); branch 4's
// pool inside its 1x1.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
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

// ---- tensor-core implicit GEMM (bf16, wgmma) --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false, 16 zero bytes (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

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

// wgmma's accumulator operands at n64: 32 f32 registers a thread
#define WG_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])

// d (64 x N, f32) += A (64 x 16, K-major) * B (16 x N, N-major), bf16, one
// warpgroup: scale-d 1 (accumulate), A and B not negated, B transposed
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", %32, %33, p, 1, 1, 0, 1;\n}\n"
               : WG_OUT32 : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- warp-specialised bf16 conv: mbarrier ring, TMA, persistent tiles ------

// mbarrier of the ring: init with the arrivals a phase takes; a wait spins
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of TMA transfers in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one arrival once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// TMA: the box of a 2-D tensor map at (c0 innermost, c1) into shared
// memory, its bytes counted on `bar`; elements outside the tensor read 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// barrier `id` (1, 2: one a consumer warpgroup) over its 128 threads
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma's accumulator operands at n = 32 .. 256: n / 2 f32 registers a thread
#define CW_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CW_R32 \
  CW_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CW_R48 \
  CW_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define CW_R64 \
  CW_R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CW_R80 \
  CW_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define CW_R96 \
  CW_R80 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define CW_R112                                                                           \
  CW_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
         "%110, %111"
#define CW_R128                                                                            \
  CW_R112 ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
          "%125, %126, %127"
#define CW_O16 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define CW_O32 CW_O16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define CW_O48 CW_O32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define CW_O64 CW_O48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), \
    "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), \
    "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define CW_O80 CW_O64, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), \
    "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
    "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define CW_O96 CW_O80, "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
    "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
    "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define CW_O112 CW_O96, "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
    "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), \
    "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define CW_O128 CW_O112, "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
    "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
    "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x n, f32) = A (64 x 16, K-major, 128-byte swizzle) * B (16 x n,
// N-major, 128-byte swizzle) + (acc ? d : 0), bf16, one warpgroup; the
// overload is chosen by the accumulator's length n / 2
#define CW_WGMMA(N, ACC, OUT, A, B, P)                                                     \
  __device__ __forceinline__ void wgmma_bf16(float(&d)[N / 2], uint64_t a, uint64_t b,     \
                                             int acc) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" ACC "}, %" #A \
                 ", %" #B ", p, 1, 1, 0, 1;\n}\n"                                          \
                 : OUT                                                                     \
                 : "l"(a), "l"(b), "r"(acc));                                              \
  }
CW_WGMMA(32, CW_R16, CW_O16, 16, 17, 18)
CW_WGMMA(64, CW_R32, CW_O32, 32, 33, 34)
CW_WGMMA(96, CW_R48, CW_O48, 48, 49, 50)
CW_WGMMA(128, CW_R64, CW_O64, 64, 65, 66)
CW_WGMMA(160, CW_R80, CW_O80, 80, 81, 82)
CW_WGMMA(192, CW_R96, CW_O96, 96, 97, 98)
CW_WGMMA(224, CW_R112, CW_O112, 112, 113, 114)
CW_WGMMA(256, CW_R128, CW_O128, 128, 129, 130)

constexpr int CW_BM = 128;              // output pixels a tile: 64 per consumer warpgroup
constexpr int CW_BK = 64;               // reduction slice: one 128-byte swizzle row of A
constexpr int CW_BOX = 64;              // channels of a B box: one 128-byte swizzle row
constexpr int CW_GRANULE = 32;          // tile widths: multiples of 32 channels
constexpr int CW_PRODUCER = 128;        // warpgroup 0 fills the ring
constexpr int CW_THREADS = 3 * 128;     // then two consumer warpgroups
constexpr int CW_PRODUCER_REGS = 56;    // setmaxnreg: 128 x 56 + 256 x 224 <= 64 K
constexpr int CW_CONSUMER_REGS = 224;

template <int BN>
struct Cw {
  static constexpr int A_BYTES = CW_BM * CW_BK * 2;    // 128 rows of 128 B
  static constexpr int BOX_BYTES = CW_BK * CW_BOX * 2; // 64 rows of 128 B
  static constexpr int B_BYTES = (BN + CW_BOX - 1) / CW_BOX * BOX_BYTES;
  static constexpr int STAGE = A_BYTES + B_BYTES;      // a multiple of 8 KB
  // a consumer's epilogue tile: 64 rows of BN bf16, padded by 16 B against
  // bank conflicts
  static constexpr int LDT = BN * 2 + 16;
  static constexpr int TILE = 64 * LDT;
  static constexpr int FIT = (232448 - 1024 - 2 * TILE - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // + aligning; the ring, the two epilogue tiles, the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * TILE + 16 * STAGES;
  static_assert(BN % CW_GRANULE == 0 && BN <= 256, "wgmma n: a multiple of 32, <= 256");
  static_assert(STAGES >= 3 && SMEM <= 232448, "a block may use 227 KB of shared memory");
};

// A by TMA: a 1x1 conv of stride 1 reads pixel m's channels at x + m ldx,
// a plain 2-D box of the map; every other conv builds im2col rows by cp.async
template <typename T>
__host__ __device__ inline bool a_by_tma(const Conv<T>& a) {
  return a.K == 1 && a.stride == 1 && a.pad == 0;
}

// ---- the warp-specialised convs' ring, producer and epilogue (both dtypes) -
// conv_wgmma_kernel (bf16) and conv_tf32x3_kernel (f32) share them; a
// slice of the reduction is one 128-byte swizzle row of T (64 bf16, 32 f32)

// the ring's STAGES pairs of barriers, before any thread uses them: full
// takes the TMA arrival (+ one a producer thread's cp.async), empty one
// arrival a consumer warpgroup
template <int STAGES>
__device__ __forceinline__ void ring_init(uint32_t full0, uint32_t empty0, bool tma_a) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, tma_a ? 1 : 1 + CW_PRODUCER);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Warpgroup 0 of a warp-specialised conv, its registers lowered: walks the
// block's output tiles of CW_BM pixels x BN channels as the consumers do
// and puts each slice of a tile into the next stage of the ring (S::STAGES
// of S::STAGE bytes, A's S::A_BYTES first, then B) once both consumers
// have released it (empty barrier). Thread 0 expects the stage's bytes on
// its full barrier, issues A's TMA for a 1x1 conv and B's through
// load_b(B's address, n0, the slice's first k, full barrier); for the
// other convs the 128 threads copy A's im2col rows by 16-byte cp.async, 8
// rows each, zero-filled for the padding and the ragged edges.
template <int BN, typename S, typename T, typename LoadB>
__device__ __forceinline__ void conv_producer(const Conv<T>& a, const CUtensorMap* map_a,
                                              uint32_t s0, uint32_t full0, uint32_t empty0,
                                              LoadB load_b) {
  constexpr int BK = 128 / sizeof(T), V = 16 / sizeof(T);
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(CW_PRODUCER_REGS));
  const int tid = threadIdx.x;
  const bool tma_a = a_by_tma(a);
  if (tma_a && tid != 0) return;  // one thread issues every TMA of a 1x1 conv
  const int tiles_n = (a.Cout + BN - 1) / BN;
  const int64_t tiles = (a.M + CW_BM - 1) / CW_BM * tiles_n;
  const int Kd = a.K * a.K * a.Cin;
  const int KT = (Kd + BK - 1) / BK;
  int s = 0;
  uint32_t ph = 0;
  // A by cp.async: this thread copies chunk ac (V channels) of rows
  // ar0 + 16 i of each slice, all at one tap; a row's tap (0, 0)
  // relative to x, and its (iy0, ix0) packed in 16 bits each
  const int ac = tid & 7, ar0 = tid >> 3;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t m0 = t / tiles_n * CW_BM;
    const int n0 = static_cast<int>(t % tiles_n) * BN;
    int64_t row[8];
    int org[8];
    if (!tma_a) {
      // output pixel (img, oy, ox) of row ar0 by division, of the next
      // rows by steps of 16 pixels (M < 2^31)
      int m = static_cast<int>(m0) + ar0;
      int ox = m % a.Wo, oy = m / a.Wo % a.Ho, img = m / a.Wo / a.Ho;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        row[i] = 0;
        org[i] = -(1 << 30);  // rows past M read nothing: iy0 far below 0
        if (m < a.M) {
          const int iy0 = oy * a.stride - a.pad, ix0 = ox * a.stride - a.pad;
          row[i] = ((static_cast<int64_t>(img) * a.H + iy0) * a.W + ix0) * a.ldx;
          org[i] = iy0 * 65536 + (ix0 & 0xFFFF);
        }
        m += 16;
        for (ox += 16; ox >= a.Wo; ox -= a.Wo)
          if (++oy == a.Ho) {
            oy = 0;
            ++img;
          }
      }
    }
    int k = ac * V, ci = k % a.Cin, kx = (k / a.Cin) % a.K, ky = (k / a.Cin) / a.K;
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t sa = s0 + s * S::STAGE, full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ph ^ 1);  // both consumers are done with the stage
      if (tid == 0) {
        mbar_expect_tx(full, tma_a ? S::STAGE : S::STAGE - S::A_BYTES);
        if (tma_a) tma_load(sa, map_a, kt * BK, static_cast<int>(m0), full);
        load_b(sa + S::A_BYTES, n0, kt * BK, full);
      }
      if (!tma_a) {
        const bool kv = k < Kd;
        const int64_t tap = (static_cast<int64_t>(ky) * a.W + kx) * a.ldx + ci;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int iy = (org[i] >> 16) + ky, ix = static_cast<int16_t>(org[i] & 0xFFFF) + kx;
          const bool v = kv && static_cast<unsigned>(iy) < static_cast<unsigned>(a.H) &&
                         static_cast<unsigned>(ix) < static_cast<unsigned>(a.W);
          cp_async16(sa + sw128(ar0 + 16 * i, ac), v ? a.x + row[i] + tap : a.x, v);
        }
        cp_async_arrive(full);
        k += BK;
        ci += BK;
        while (ci >= a.Cin) {
          ci -= a.Cin;
          if (++kx == a.K) {
            kx = 0;
            ++ky;
          }
        }
      }
      if (++s == S::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// two neighbouring channels into the epilogue tile, each rounded once
__device__ __forceinline__ void store2(bf16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}
__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}

// The end of a consumer warpgroup's tile (lt: the thread's index among
// the consumers): bias, ReLU and the rounding to T into the warpgroup's
// tile in shared memory (64 rows, LDT bytes apart), then out in 16-byte
// chunks, a row's chunks on neighbouring threads, to the channel offset
// and split; the stores drain while the next tile's wgmma runs.
// Accumulator j of 8 columns holds rows (lane >> 2) + 8 hf of the warp's
// 16, columns 2 (lane & 3) + {0, 1}.
template <int BN, int LDT, typename T>
__device__ __forceinline__ void conv_epilogue(const Conv<T>& a, const float (&acc)[BN / 2],
                                              unsigned char* tile, int64_t m0, int n0,
                                              int lt) {
  constexpr int V = 16 / sizeof(T), ES = sizeof(T);
  const int wgc = lt >> 7, warp = (lt >> 5) & 3, lane = lt & 31;
  named_sync(1 + wgc);  // the warpgroup is done reading the previous tile
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2, n = n0 + c;
    const float b0 = n < a.Cout ? to_f(a.b[n]) : 0.f;
    const float b1 = n < a.Cout ? to_f(a.b[n + 1]) : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = warp * 16 + (lane >> 2) + 8 * hf;
      store2(reinterpret_cast<T*>(tile + r * LDT + c * ES),
             fmaxf(acc[4 * j + 2 * hf] + b0, 0.f), fmaxf(acc[4 * j + 2 * hf + 1] + b1, 0.f));
    }
  }
  named_sync(1 + wgc);
#pragma unroll
  for (int e = lt & 127; e < 64 * (BN / V); e += 128) {
    const int r = e / (BN / V), n = n0 + e % (BN / V) * V;
    const int64_t m = m0 + wgc * 64 + r;
    if (m >= a.M || n >= a.Cout) continue;
    T* y = n < a.split ? a.y0 + m * a.ldy0 + n : a.y1 + m * a.ldy1 + (n - a.split);
    *reinterpret_cast<uint4*>(y) = *reinterpret_cast<const uint4*>(tile + r * LDT + (n - n0) * ES);
  }
}

// One persistent block an SM walks output tiles of 128 pixels x BN
// channels, m-major (the column tiles of one m tile adjacent).
// Warpgroup 0 produces (conv_producer): each 64-deep slice of a tile into
// the next stage of the ring, B's 64-channel boxes by TMA, A by TMA (1x1)
// or by cp.async; the stage's full barrier completes when every byte has
// landed. Warpgroups 1 and 2 consume: each runs wgmma on its 64 rows of a
// slice once it is full, releases the stage when that wgmma has retired
// (one group in flight behind the one issued), and ends a tile with bias,
// ReLU and one rounding to bf16 through its epilogue tile
// (conv_epilogue), while the producer runs on into the next tile's slices.
template <int BN>
__global__ void __launch_bounds__(CW_THREADS, 1)
    conv_wgmma_kernel(const Conv<bf16> a, const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b) {
  using S = Cw<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms aligned
  const uint32_t tile0 = s0 + S::STAGES * S::STAGE, full0 = tile0 + 2 * S::TILE;
  const uint32_t empty0 = full0 + 8 * S::STAGES;
  const int tid = threadIdx.x;
  const bool tma_a = a_by_tma(a);
  const int tiles_n = (a.Cout + BN - 1) / BN;
  const int64_t tiles = (a.M + CW_BM - 1) / CW_BM * tiles_n;
  const int Kd = a.K * a.K * a.Cin;
  const int KT = (Kd + CW_BK - 1) / CW_BK;
  ring_init<S::STAGES>(full0, empty0, tma_a);

  if (tid < CW_PRODUCER) {
    // B: the HWIO weights in boxes of 64 channels x 64 rows
    conv_producer<BN, S>(a, &map_a, s0, full0, empty0,
                         [&](uint32_t sb, int n0, int k0, uint32_t full) {
#pragma unroll
                           for (int i = 0; i < (BN + CW_BOX - 1) / CW_BOX; ++i)
                             tma_load(sb + i * S::BOX_BYTES, &map_b, n0 + i * CW_BOX, k0, full);
                         });
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CW_CONSUMER_REGS));
    const int lt = tid - CW_PRODUCER, wgc = lt >> 7;
    const bool leader = (lt & 127) == 0;  // arrives for its warpgroup
    int s = 0, prev = 0;
    uint32_t ph = 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t m0 = t / tiles_n * CW_BM;
      const int n0 = static_cast<int>(t % tiles_n) * BN;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full0 + 8 * s, ph);
        // cp.async wrote A through the generic proxy: make it visible to wgmma
        if (!tma_a) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = s0 + s * S::STAGE, sb = sa + S::A_BYTES;
        // A: this warpgroup's 64 rows, 8-row atoms 1024 B apart; B: boxes
        // of 64 channels BOX_BYTES apart, 8-row atoms 1024 B apart (wgmma
        // reads the first BN % 64 channels of the last box)
        const uint64_t da = smem_desc(sa + wgc * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc(sb, S::BOX_BYTES, 1024);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < CW_BK / 16; ++kk)  // k16: 32 B along A's rows, 16 rows of B
          wgmma_bf16(acc, da + 2 * kk, db + 2 * CW_BOX * kk, kt | kk);  // tile's first: d = 0
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous slice's wgmma has retired: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (kt > 0 && leader) mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == S::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (leader) mbar_arrive(empty0 + 8 * prev);

      conv_epilogue<BN, S::LDT>(
          a, acc, smem_raw + (tile0 + wgc * S::TILE - smem_u32(smem_raw)), m0, n0, lt);
    }
  }
}

// ---- warp-specialised f32 conv as 3xTF32: weights split once, persistent ---

constexpr int TF_BK = 32;          // reduction slice: one 128-byte swizzle row of f32
constexpr int TF_GRANULE = 16;     // f32 tile widths: multiples of 16 channels up to 128
constexpr int TF_TILE_MAX = 128;

template <int BN>
struct Tf {
  static constexpr int A_BYTES = CW_BM * TF_BK * 4;  // 128 im2col rows of 128 B, as loaded
  static constexpr int B_BYTES = BN * TF_BK * 4;     // BN rows of 128 B: B's hi or its lo
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;  // a multiple of 1 KB
  // a consumer's epilogue tile: 64 rows of BN f32, padded by 16 B against
  // bank conflicts
  static constexpr int LDT = BN * 4 + 16;
  static constexpr int TILE = 64 * LDT;
  static constexpr int FIT = (232448 - 1024 - 2 * TILE - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // + aligning; the ring, the two epilogue tiles, the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * TILE + 16 * STAGES;
  static_assert(BN % TF_GRANULE == 0 && BN <= TF_TILE_MAX,
                "f32 tile: a multiple of 16 channels, <= 128 (the sum and the slice's "
                "partial take BN registers a consumer thread)");
  static_assert(STAGES >= 3 && SMEM <= 232448, "a block may use 227 KB of shared memory");
};

// v rounded to tf32 (10 mantissa bits, to nearest, ties away from zero)
// with the 13 bits below cleared, as the tensor cores read it
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// v = hi + lo + O(2^-22 |v|): hi = tf32(v), lo = tf32(v - hi) (v - hi exact)
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__uint_as_float(v));
  lo = to_tf32(__uint_as_float(v) - __uint_as_float(hi));
}

// The weights of one f32 conv split once for every block that reads them:
// w (Kd rows of Cout, the HWIO kernel) -> hi and lo, each Cout rows of Kd
// (K-major: tf32 wgmma takes no transpose of B), through a 32 x 32 tile in
// shared memory so that both the reads and the writes are coalesced. Named
// after the conv it feeds, so that a profile's trunk kernels include it.
__global__ void conv_tf32x3_kernel_split(const float* __restrict__ w, float* __restrict__ hi,
                                         float* __restrict__ lo, int Kd, int Cout) {
  __shared__ float t[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32, tx = threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int k = k0 + j, n = n0 + tx;
    t[j][tx] = k < Kd && n < Cout ? w[static_cast<int64_t>(k) * Cout + n] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int n = n0 + j, k = k0 + tx;
    if (n >= Cout || k >= Kd) continue;
    uint32_t h, l;
    split_tf32(__float_as_uint(t[tx][j]), h, l);
    hi[static_cast<int64_t>(n) * Kd + k] = __uint_as_float(h);
    lo[static_cast<int64_t>(n) * Kd + k] = __uint_as_float(l);
  }
}

// four 8 x 4 f32 matrices (8 x 8 of b16 to ldmatrix) from shared memory:
// lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (64 x n, f32) = A (64 x 8, tf32 fragments in registers) * B (8 x n,
// K-major, 128-byte swizzle) + (acc ? d : 0), one warpgroup; the overload is
// chosen by the accumulator's length n / 2
#define TF_WGMMA(N, ACC, OUT, A0, A1, A2, A3, B, P)                                          \
  __device__ __forceinline__ void wgmma_tf32(float(&d)[N / 2], const uint32_t(&a)[4],        \
                                             uint64_t b, int acc) {                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" ACC "}, {%" #A0 \
                 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1;\n}\n"                   \
                 : OUT                                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));            \
  }

// the accumulator operands at n = 16, 48, 80, 112, beside CW_R* / CW_O*
#define TF_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF_R24 CW_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define TF_R40 CW_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define TF_R56 CW_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define TF_O8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define TF_O24 CW_O16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define TF_O40 CW_O32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define TF_O56 CW_O48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
TF_WGMMA(16, TF_R8, TF_O8, 8, 9, 10, 11, 12, 13)
TF_WGMMA(32, CW_R16, CW_O16, 16, 17, 18, 19, 20, 21)
TF_WGMMA(48, TF_R24, TF_O24, 24, 25, 26, 27, 28, 29)
TF_WGMMA(64, CW_R32, CW_O32, 32, 33, 34, 35, 36, 37)
TF_WGMMA(80, TF_R40, TF_O40, 40, 41, 42, 43, 44, 45)
TF_WGMMA(96, CW_R48, CW_O48, 48, 49, 50, 51, 52, 53)
TF_WGMMA(112, TF_R56, TF_O56, 56, 57, 58, 59, 60, 61)
TF_WGMMA(128, CW_R64, CW_O64, 64, 65, 66, 67, 68, 69)

// conv_wgmma_kernel's walk, ring, producer (conv_producer) and epilogue
// (conv_epilogue) in f32, on 32-deep slices: B's hi and lo tiles (BN rows
// of 128 B, K-major) come by TMA from the weights that
// conv_tf32x3_kernel_split split for this conv, A as loaded (f32).
// Warpgroups 1 and 2 consume their 64 rows of a slice: ldmatrix brings A's
// fragments into registers (while the previous slice's wgmma runs), each
// thread rounds its 16 values into hi and lo there, and 12 wgmma (4 k8
// steps of lo_a hi_b, hi_a lo_b, hi_a hi_b, small terms first) read A from
// registers and B from the stage into the slice's partial sum, which the
// next slice adds into the f32 sum by FADD once the wgmma have retired;
// then the stage is released.
template <int BN>
__global__ void __launch_bounds__(CW_THREADS, 1)
    conv_tf32x3_kernel(const Conv<float> a, const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_hi,
                       const __grid_constant__ CUtensorMap map_lo) {
  using S = Tf<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms aligned
  const uint32_t tile0 = s0 + S::STAGES * S::STAGE, full0 = tile0 + 2 * S::TILE;
  const uint32_t empty0 = full0 + 8 * S::STAGES;
  const int tid = threadIdx.x;
  const bool tma_a = a_by_tma(a);
  const int tiles_n = (a.Cout + BN - 1) / BN;
  const int64_t tiles = (a.M + CW_BM - 1) / CW_BM * tiles_n;
  const int Kd = a.K * a.K * a.Cin;
  const int KT = (Kd + TF_BK - 1) / TF_BK;
  ring_init<S::STAGES>(full0, empty0, tma_a);

  if (tid < CW_PRODUCER) {
    // B: hi and lo, each in one box of BN rows x 32
    conv_producer<BN, S>(a, &map_a, s0, full0, empty0,
                         [&](uint32_t sb, int n0, int k0, uint32_t full) {
                           tma_load(sb, &map_hi, k0, n0, full);
                           tma_load(sb + S::B_BYTES, &map_lo, k0, n0, full);
                         });
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CW_CONSUMER_REGS));
    const int lt = tid - CW_PRODUCER, wgc = lt >> 7, warp = (lt >> 5) & 3, lane = lt & 31;
    const bool leader = (lt & 127) == 0;  // arrives for its warpgroup
    // ldmatrix of a k8 step: matrices 0 and 1 the warp's rows 0-7 and 8-15
    // at k 0-3, matrices 2 and 3 the same rows at k 4-7, so register i
    // holds the fragment a_i of wgmma's A layout (row lane / 4 (+ 8), k
    // lane % 4 (+ 4))
    const int lrow = wgc * 64 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int lchunk = lane >> 4;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    // the tensor cores add a wgmma's products to its accumulator rounding
    // toward zero, a bias that grows with the steps one accumulator takes
    // (on an H100, 1.15e-5 of the largest output at K = 1440 with one
    // accumulator over the whole reduction): each slice's 12 wgmma steps
    // start a partial sum of their own, and the partials are added into
    // the f32 sum by FADD, rounding to nearest
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t m0 = t / tiles_n * CW_BM;
      const int n0 = static_cast<int>(t % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full0 + 8 * s, ph);
        const uint32_t sa = s0 + s * S::STAGE;
        uint32_t hi[TF_BK / 8][4], lo[TF_BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < TF_BK / 8; ++kk) ldsm_x4(sa + sw128(lrow, 2 * kk + lchunk), hi[kk]);
        if (kt > 0) {  // slice kt - 1's partial into the sum; its stage is free
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          if (leader) mbar_arrive(empty0 + 8 * prev);
        }
#pragma unroll
        for (int kk = 0; kk < TF_BK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(hi[kk][i], hi[kk][i], lo[kk][i]);
        // B: BN rows of 128 B, 8-row atoms 1024 B apart; a k8 step is 32 B
        // further along them
        const uint64_t dhi = smem_desc(sa + S::A_BYTES, 16, 1024);
        const uint64_t dlo = smem_desc(sa + S::A_BYTES + S::B_BYTES, 16, 1024);
        fence_acc(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TF_BK / 8; ++kk) {  // the slice's first product overwrites
          wgmma_tf32(part, lo[kk], dhi + 2 * kk, kk);
          wgmma_tf32(part, hi[kk], dlo + 2 * kk, 1);
          wgmma_tf32(part, hi[kk], dhi + 2 * kk, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        prev = s;
        if (++s == S::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      if (leader) mbar_arrive(empty0 + 8 * prev);

      conv_epilogue<BN, S::LDT>(
          a, acc, smem_raw + (tile0 + wgc * S::TILE - smem_u32(smem_raw)), m0, n0, lt);
    }
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

// The dispatch rule: the tensor cores take a conv whose 16-byte vectors (8
// bf16 or 4 f32 channels) stay inside one tap and aligned; tc_tile gives
// its block tile width, 0 where no kernel takes it.
template <typename T>
bool tc_ok(const Conv<T>& a) {
  constexpr int V = 16 / sizeof(T);
  return a.Cin % V == 0 && a.Cout % V == 0 && a.split % V == 0 && a.ldx % V == 0 &&
         a.ldy0 % V == 0 && a.ldy1 % V == 0 && aligned16(a.x) && aligned16(a.w) &&
         aligned16(a.y0) && aligned16(a.y1);
}

// the tile widths of a dtype: multiples of a granule up to a most, bf16 32
// (half a B box) and 256, f32 16 and 128 (the sum and the slice's partial
// fill a consumer's registers)
template <typename T>
struct Tiles {
  static constexpr int granule = std::is_same<T, float>::value ? TF_GRANULE : CW_GRANULE;
  static constexpr int most = std::is_same<T, float>::value ? TF_TILE_MAX : 256;
};

// the fewest column tiles of at most `most` channels, each as wide as their
// share of Cout rounded up to the granule; one tile, so A staged once,
// wherever Cout <= most
template <typename T>
int tc_tile(const Conv<T>& a) {
  using W = Tiles<T>;
  if (!tc_ok(a)) return 0;
  const int tiles = (a.Cout + W::most - 1) / W::most;
  return ((a.Cout + tiles - 1) / tiles + W::granule - 1) / W::granule * W::granule;
}

// conv launches by dtype (0 f32, 1 bf16) and tile width (index width /
// granule), since the last srcf_conv_launches_reset; atomic, as shards
// launch from threads
std::atomic<int64_t> conv_launches[2][9];

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no driver library); null if the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const char* name = "cuTensorMapEncodeTiled";
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// a bf16 or f32 matrix of `rows` rows of `cols` elements, `ld` elements
// apart, in boxes of box_rows x box_cols in the 128-byte swizzle; elements
// outside it read 0
template <typename T>
int tensor_map(CUtensorMap* map, const T* base, uint64_t cols, uint64_t rows, int64_t ld,
               uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  const CUresult r = encode(
      map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// one block an SM, or one a tile where there are fewer tiles
int persistent_blocks(int64_t tiles, unsigned* blocks) {
  int dev, sms;
  TRY(static_cast<int>(cudaGetDevice(&dev)));
  TRY(static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)));
  *blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  return 0;
}

// the tensor maps on the host for each launch (no synchronisation), then
// the persistent blocks
template <int BN>
int launch_wgmma(const Conv<bf16>& a, cudaStream_t st) {
  using S = Cw<BN>;
  if (a.M == 0) return 0;
  if (a.M > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);  // pixel indices
  const int Kd = a.K * a.K * a.Cin;
  CUtensorMap map_a, map_b;
  // B: the HWIO weights, Kd rows of Cout, in boxes of 64 rows x 64 channels
  TRY(tensor_map(&map_b, a.w, a.Cout, Kd, a.Cout, CW_BOX, CW_BK));
  // A of a 1x1 conv: M pixel rows of Cin channels, ldx apart, in boxes of
  // 128 rows x 64 channels (the other convs build it by cp.async)
  if (a_by_tma(a)) {
    TRY(tensor_map(&map_a, a.x, a.Cin, a.M, a.ldx, CW_BK, CW_BM));
  } else {
    map_a = map_b;
  }
  TRY(static_cast<int>(cudaFuncSetAttribute(
      conv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM)));
  unsigned blocks;
  TRY(persistent_blocks((a.M + CW_BM - 1) / CW_BM * ((a.Cout + BN - 1) / BN), &blocks));
  conv_wgmma_kernel<BN><<<blocks, CW_THREADS, S::SMEM, st>>>(a, map_a, map_b);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++conv_launches[1][BN / Tiles<bf16>::granule];
  return err;
}

// the weights split into hi and lo in `wsplit` (2 Kd Cout floats, reused
// by every conv of a segment: stream order keeps the conv before from
// reading what the next split writes), then the tensor maps and the
// persistent blocks
template <int BN>
int launch_tf32x3(const Conv<float>& a, float* wsplit, cudaStream_t st) {
  using S = Tf<BN>;
  if (a.M == 0) return 0;
  if (a.M > INT32_MAX || !wsplit || !aligned16(wsplit))  // pixel indices; the split's rows
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kd = a.K * a.K * a.Cin;
  float* hi = wsplit;
  float* lo = wsplit + static_cast<int64_t>(Kd) * a.Cout;
  conv_tf32x3_kernel_split<<<dim3((a.Cout + 31) / 32, (Kd + 31) / 32), dim3(32, 8), 0, st>>>(
      a.w, hi, lo, Kd, a.Cout);
  TRY(static_cast<int>(cudaGetLastError()));
  CUtensorMap map_a, map_hi, map_lo;
  // B: hi and lo, Cout rows of Kd, in boxes of BN rows x 32 (a slice)
  TRY(tensor_map(&map_hi, hi, Kd, a.Cout, Kd, TF_BK, BN));
  TRY(tensor_map(&map_lo, lo, Kd, a.Cout, Kd, TF_BK, BN));
  // A of a 1x1 conv: M pixel rows of Cin channels, ldx apart, in boxes of
  // 128 rows x 32 channels (the other convs build it by cp.async)
  if (a_by_tma(a)) {
    TRY(tensor_map(&map_a, a.x, a.Cin, a.M, a.ldx, TF_BK, CW_BM));
  } else {
    map_a = map_hi;
  }
  TRY(static_cast<int>(cudaFuncSetAttribute(
      conv_tf32x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM)));
  unsigned blocks;
  TRY(persistent_blocks((a.M + CW_BM - 1) / CW_BM * ((a.Cout + BN - 1) / BN), &blocks));
  conv_tf32x3_kernel<BN><<<blocks, CW_THREADS, S::SMEM, st>>>(a, map_a, map_hi, map_lo);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++conv_launches[0][BN / Tiles<float>::granule];
  return err;
}

// the tensor-core kernel of the conv's dtype at the rule's tile width;
// wsplit: the f32 kernel's split weights (unused in bf16)
int launch(const Conv<bf16>& a, bf16*, cudaStream_t st) {
  switch (tc_tile(a)) {
    case 32: return launch_wgmma<32>(a, st);
    case 64: return launch_wgmma<64>(a, st);
    case 96: return launch_wgmma<96>(a, st);
    case 128: return launch_wgmma<128>(a, st);
    case 160: return launch_wgmma<160>(a, st);
    case 192: return launch_wgmma<192>(a, st);
    case 224: return launch_wgmma<224>(a, st);
    case 256: return launch_wgmma<256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // the rule refuses it
  }
}

int launch(const Conv<float>& a, float* wsplit, cudaStream_t st) {
  switch (tc_tile(a)) {
    case 16: return launch_tf32x3<16>(a, wsplit, st);
    case 32: return launch_tf32x3<32>(a, wsplit, st);
    case 48: return launch_tf32x3<48>(a, wsplit, st);
    case 64: return launch_tf32x3<64>(a, wsplit, st);
    case 80: return launch_tf32x3<80>(a, wsplit, st);
    case 96: return launch_tf32x3<96>(a, wsplit, st);
    case 112: return launch_tf32x3<112>(a, wsplit, st);
    case 128: return launch_tf32x3<128>(a, wsplit, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // the rule refuses it
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

// conv + bias + ReLU of an (n, H, W, Cin) map; see Conv for the outputs and
// launch for wsplit
template <typename T>
int conv(cudaStream_t st, T* wsplit, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y0,
         int64_t ldy0, int split, T* y1, int64_t ldy1) {
  return launch(make_conv(n, x, ldx, H, W, Cin, K, stride, pad, w, b, Cout, y0, ldy0, split,
                          y1, ldy1), wsplit, st);
}

// plain conv: all Cout channels to one map with pixel stride ldy
template <typename T>
int conv(cudaStream_t st, T* wsplit, int n, const T* x, int64_t ldx, int H, int W, int Cin,
         int K, int stride, int pad, const T* w, const T* b, int Cout, T* y,
         int64_t ldy) {
  return conv(st, wsplit, n, x, ldx, H, W, Cin, K, stride, pad, w, b, Cout, y, ldy, Cout, y, ldy);
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
// pooled (n, h, w, cin); wsplit: see launch.
template <typename T>
int inception(cudaStream_t st, T* wsplit, int n, const Plan& p, const T* x, int h, int w,
              const T* const* wt, T* red, T* pooled, T* y) {
  const int cr = p.red3 + p.red5, co = p.out();
  // the three 1x1s as one conv: [0, ch1) -> y, the reductions -> red
  TRY(conv(st, wsplit, n, x, p.cin, h, w, p.cin, 1, 1, 0, wt[0], wt[1], p.ch1 + cr, y, co,
           p.ch1, red, cr));
  TRY(conv(st, wsplit, n, red, cr, h, w, p.red3, 3, 1, 1, wt[2], wt[3], p.ch3, y + p.ch1, co));
  TRY(conv(st, wsplit, n, red + p.red3, cr, h, w, p.red5, 3, 1, 1, wt[4], wt[5], p.ch5,
           y + p.ch1 + p.ch3, co));
  // branch 4: the block input's 3x3/1 max pool once, then a plain 1x1
  TRY(maxpool(st, n, x, h, w, p.cin, 3, 1, 1, pooled));
  TRY(conv(st, wsplit, n, pooled, p.cin, h, w, p.cin, 1, 1, 0, wt[6], wt[7], p.proj,
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
// scratch: c2 (n, d/4, d/4, 64), c3 (same, 192), then wsplit (see launch;
// f32: 2 x its convs' largest K*K*Cin*Cout floats, bf16 unused)
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
  TRY(conv(st, s[2], n, s[0], 64, a.h2, a.h2, 64, 3, 1, 1, wt[4], wt[5], 192, s[1], 192));
  return maxpool(st, n, s[1], a.h2, a.h2, 192, 3, 2, 0, out);
}

// weights: 8 per inception block, 3a and 3b (see inception)
// scratch: red (n, g, g, 160), pooled (n, g, g, 256), i3a (n, g, g, 256),
// i3b (n, g, g, 480), wsplit
template <typename T>
int trunk_s3(const T* x, T* out, const T* const* wt, T* const* s, int n, int g,
             cudaStream_t st) {
  TRY(inception(st, s[4], n, k3a, x, g, g, wt, s[0], s[1], s[2]));
  TRY(inception(st, s[4], n, k3b, s[2], g, g, wt + 8, s[0], s[1], s[3]));
  return maxpool(st, n, s[3], g, g, k3b.out(), 3, 2, 0, out);
}

// weights: conv2, b2, conv3, b3, then trunk_s3's
// scratch: p1 (n, h/2, h/2, 64), c2 (same), c3 (n, h/2, h/2, 192),
// p2 (n, h/4, h/4, 192), red (n, h/4, h/4, 160), i3a (n, h/4, h/4, 256),
// i3b (n, h/4, h/4, 480), wsplit
template <typename T>
int trunk_s23(const T* x, T* out, const T* const* wt, T* const* s, int n, int h,
              cudaStream_t st) {
  const int h2 = ceil_out(h, 3, 2), h4 = ceil_out(h2, 3, 2);
  TRY(maxpool(st, n, x, h, h, 64, 3, 2, 0, s[0]));
  TRY(conv(st, s[7], n, s[0], 64, h2, h2, 64, 1, 1, 0, wt[0], wt[1], 64, s[1], 64));
  TRY(conv(st, s[7], n, s[1], 64, h2, h2, 64, 3, 1, 1, wt[2], wt[3], 192, s[2], 192));
  TRY(maxpool(st, n, s[2], h2, h2, 192, 3, 2, 0, s[3]));
  // c2 = s[1] is dead from here; its (h/2)^2 * 64 elements are exactly
  // (h/4)^2 * 256, so it holds branch 4's pooled input of 3a (192
  // channels) and of 3b (256) with no scratch of its own
  T* const s3[5] = {s[4], s[1], s[5], s[6], s[7]};
  return trunk_s3(s[3], out, wt + 4, s3, n, h4, st);
}

// weights: 8 per inception block, 4a..4e, 5a, 5b
// scratch: red (n, g, g, 240), ping and pong (n, g, g, 832), pooled (n, g, g, 832),
// wsplit
template <typename T>
int trunk_s45(const T* x, T* out, const T* const* wt, T* const* s, int n, int g,
              cudaStream_t st) {
  T* red = s[0];
  T* buf[2] = {s[1], s[2]};
  T* pooled = s[3];
  const T* cur = x;
  for (int i = 0; i < 5; ++i) {
    TRY(inception(st, s[4], n, k4[i], cur, g, g, wt + 8 * i, red, pooled, buf[i % 2]));
    cur = buf[i % 2];
  }
  const int g2 = ceil_out(g, 2, 2);
  TRY(maxpool(st, n, buf[0], g, g, k4[4].out(), 2, 2, 0, buf[1]));
  TRY(inception(st, s[4], n, k5a, buf[1], g2, g2, wt + 40, red, pooled, buf[0]));
  TRY(inception(st, s[4], n, k5b, buf[0], g2, g2, wt + 48, red, pooled, buf[1]));
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

// wsplit: 2 K*K*Cin*Cout floats of scratch for the split weights
extern "C" int srcf_conv_f32(CONV_ARGS, void* wsplit, void* stream) {
  return launch(MAKE_CONV(float), static_cast<float*>(wsplit),
                static_cast<cudaStream_t>(stream));
}
extern "C" int srcf_conv_bf16(CONV_ARGS, void* stream) {
  return launch(MAKE_CONV(bf16), nullptr, static_cast<cudaStream_t>(stream));
}
// the tile width srcf_conv_f32 / srcf_conv_bf16 would launch for these
// arguments (tc_tile): a multiple of 16 up to 128 (f32) or of 32 up to 256
// (bf16); 0 for a conv the rule refuses (srcf_conv_* returns an error for
// it); launches nothing
extern "C" int srcf_conv_f32_tile(CONV_ARGS) { return tc_tile(MAKE_CONV(float)); }
extern "C" int srcf_conv_bf16_tile(CONV_ARGS) { return tc_tile(MAKE_CONV(bf16)); }

// conv kernels of one dtype launched at tile width `width` (every conv of
// the segments and of srcf_conv_*) since the last reset; -1 for a width no
// kernel has
template <typename T>
static int launches_at(int width) {
  using W = Tiles<T>;
  if (width <= 0 || width > W::most || width % W::granule) return -1;
  return static_cast<int>(conv_launches[std::is_same<T, bf16>::value][width / W::granule].load());
}
extern "C" int srcf_conv_f32_launches(int width) { return launches_at<float>(width); }
extern "C" int srcf_conv_bf16_launches(int width) { return launches_at<bf16>(width); }
extern "C" int srcf_conv_launches_reset() {
  for (auto& d : conv_launches)
    for (auto& n : d) n.store(0);
  return 0;
}
