// Binary dilation of a seed map by a disk or a diamond: the spectrometer
// masks' flare growth (disk(r)) and cloud buffer (r passes of the 3 x 3
// cross, which give the taxicab ball of radius r).
//
// Replaces no TPU kernel: the JAX package's masks/sds.py dilates on the
// host with scipy (binary_dilation by disk(r); r passes of the cross), and
// so did the port until this kernel. It was added because that host
// morphology held the card idle for most of a masked flightline.
//
// Both elements are symmetric, convex, and the same under a swap of x and
// y: row k and column k of the element are |dx| <= hw[k] and |dy| <=
// hw[k], with hw[k] = isqrt(r^2 - k^2) for the disk and r - k for the
// diamond (the wrapper, ops/morph.py, gives the table, in integers). So a
// pixel is covered exactly when some row y' of its column has a seed within
// hw[|y - y'|] along that row, that is when |y - y'| <= v[d(y', x)], where
// d is the distance along the row to the nearest seed and v[d] = hw[d]
// (-1 past the table: no seed that near). The dilation is then two passes
// of scans, exact:
//   1. along each row, d from a prefix max of the last seed's index and a
//      suffix min of the next one's; e = v[d] (-1 where d is past the table);
//   2. along each column, out[y] = max over y' <= y of (y' + e[y']) >= y, or
//      min over y' >= y of (y' - e[y']) <= y.
// Nothing outside the map is a seed, as scipy's border value 0; for the
// diamond, r passes of the cross with border 0 give the same, since a
// lattice path between two pixels of the map can stay inside it.
//
// Bound on this card: H*W bytes in and H*W out (0.33 MB each way for a
// 554 x 598 block, 1.7 MB for a 2801 x 598 cloud map): a microsecond of
// bandwidth, so launch latency and the scans' dependent steps set the time.
// Design: the row pass gives each row a warp that scans it in 32-column
// chunks with shuffles, carrying the running index from chunk to chunk,
// and writes e (int32 scratch the wrapper allocates); the column pass gives
// each thread one column of a strip of kStrip rows, which it scans down and
// then up from `reach` (the largest e, hw[0] = r) rows beyond the strip,
// since no row farther away covers it; the warp's loads and stores are
// coalesced across its 32 columns. No atomics: two launches on one input
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;       // rows per block of the row pass (a warp each)
constexpr int kColThreads = 64;    // columns per block of the column pass
constexpr int kStrip = 64;         // output rows per block of the column pass
constexpr int kFar = 1 << 30;      // "no seed" index; maps are narrower

// e[y, x] = v[d] where d = distance along row y from x to its nearest seed
// is below nv, else -1
__global__ void row_reach_kernel(const uint8_t* __restrict__ seeds,
                                 const int32_t* __restrict__ v,
                                 int32_t* __restrict__ e, int H, int W, int nv) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (y >= H) return;              // whole warps leave together
  const uint8_t* row = seeds + (int64_t)y * W;
  int32_t* erow = e + (int64_t)y * W;
  int carry = -kFar;               // left to right: the last seed at or before x
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    int s = (x < W && row[x]) ? x : -kFar;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = max(s, u);
    }
    s = max(s, carry);
    carry = __shfl_sync(0xffffffffu, s, 31);
    if (x < W) erow[x] = x - s;
  }
  carry = kFar;                    // right to left: the next seed at or after x
  for (int x0 = (W - 1) / 32 * 32; x0 >= 0; x0 -= 32) {
    const int x = x0 + lane;
    int s = (x < W && row[x]) ? x : kFar;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s = min(s, u);
    }
    s = min(s, carry);
    carry = __shfl_sync(0xffffffffu, s, 0);
    if (x < W) {
      const int d = min(erow[x], s - x);
      erow[x] = d < nv ? __ldg(v + d) : -1;
    }
  }
}

// out[y, x] = (max over y' <= y of y' + e[y', x]) >= y
//          or (min over y' >= y of y' - e[y', x]) <= y
__global__ void column_cover_kernel(const int32_t* __restrict__ e,
                                    uint8_t* __restrict__ out, int H, int W, int reach) {
  const int x = blockIdx.y * kColThreads + threadIdx.x;
  if (x >= W) return;
  const int y0 = blockIdx.x * kStrip;
  const int y1 = min(y0 + kStrip, H);
  int down = -kFar;
#pragma unroll 4
  for (int y = max(0, y0 - reach); y < y1; ++y) {
    down = max(down, y + e[(int64_t)y * W + x]);
    if (y >= y0) out[(int64_t)y * W + x] = down >= y;
  }
  int up = kFar;
#pragma unroll 4
  for (int y = min(H - 1, y1 - 1 + reach); y >= y0; --y) {
    up = min(up, y - e[(int64_t)y * W + x]);
    if (y < y1 && up <= y) out[(int64_t)y * W + x] = 1;
  }
}

int launch(const uint8_t* seeds, uint8_t* out, int32_t* e, const int32_t* v,
           int H, int W, int nv, int reach, void* stream) {
  if (H < 1 || W < 1 || W >= kFar || H >= kFar || nv < 1 || reach < 0 || reach >= kFar)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_reach_kernel<<<(H + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(
      seeds, v, e, H, W, nv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kStrip - 1) / kStrip, (W + kColThreads - 1) / kColThreads);
  column_cover_kernel<<<grid, kColThreads, 0, st>>>(e, out, H, W, reach);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per structuring element, so that the library's launch
// count (CudaKernel.counts) tells the flare growth from the cloud buffer;
// both run the same two passes on the table they are given.
extern "C" int srcf_dilate_disk_u8(const uint8_t* seeds, uint8_t* out, int32_t* e,
                                   const int32_t* v, int H, int W, int nv, int reach,
                                   void* stream) {
  return launch(seeds, out, e, v, H, W, nv, reach, stream);
}

extern "C" int srcf_dilate_diamond_u8(const uint8_t* seeds, uint8_t* out, int32_t* e,
                                      const int32_t* v, int H, int W, int nv, int reach,
                                      void* stream) {
  return launch(seeds, out, e, v, H, W, nv, reach, stream);
}
