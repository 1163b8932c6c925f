// K1: fused FAST-9 corner score + 3x3 non-maximum suppression over every
// level of the image pyramids of S streams in one launch.
//
// Replaces the Pallas TPU kernel `_fast_nms_kernel` / `fast_score_nms`
// (rgbd_visualodometry_tpu/ops/pallas_fast.py:30, launched at :91) and, on
// the main path, the XLA formulation `fast.fast_score` + `image.maxpool3x3`
// that the JAX package computes on every pyramid level (ops/fast.py:105-117).
//
// out[y, x] = s(y, x) if s(y, x) >= max of s over the 3x3 window, else 0,
// where s is the FAST-9 score of the edge-padded image (max over the 16 arcs
// of 9 contiguous ring pixels of the min ring difference, bright and dark,
// clamped at 0) and the NMS window is -inf outside the image.  Only
// subtraction, min and max are used, and the min and max of finite floats do
// not depend on how they are grouped, so the result is bit-identical to the
// plain torch version (ops/fast.py::fast_nms_reference).
//
// What bounds it on an H100: ~185 fp32 sub/min/max per pixel (16 ring
// differences, 128 for the arc windows, 30 for the bright and dark maxima,
// 11 for the clamp and the 3x3 NMS window) over the ~0.95 M pixels of a
// 640x480 pyramid - about 2.6 us at the 67 TFLOP/s fp32 peak - against
// 7.6 MB of device memory read and written once (2.3 us at 3.35 TB/s).
// The peak counts an FMA as two operations and a min or max as one, so
// the arithmetic takes at least twice that in practice.  A launch per level
// costs more than either, and a small level alone fills few SMs.
//
// Design:
// - One launch for the whole pyramid of every stream.  The launch takes a
//   table of up to kMaxLevels (input, output, h, w, input and output stream
//   strides) entries by value; block (b, s) finds its level as the last
//   entry whose first tile is <= b and its tile inside the level, and reads
//   and writes stream s of it, so the small levels' tiles run beside the
//   large ones' and every stream's beside the others'.  The streams share
//   their level shapes, so the table stays at most kMaxLevels rows for any
//   number of streams (72 streams x 8 levels: one launch of 72 x 347 blocks
//   at 640x480).  The streams' pixels count like more levels: at 72 streams
//   ~68 M pixels, ~12.6 G operations, ~0.19 ms at the fp32 peak, against
//   ~547 MB of device memory (~0.16 ms).
// - A block of 256 threads computes a 30x30 output tile.  It stages the
//   tile plus a 4-pixel halo (3 for the Bresenham circle, 1 for the NMS
//   window) in shared memory with edge-clamped indices - the same values as
//   jnp.pad(mode="edge") - and computes the score over the tile plus a
//   1-pixel ring: 32x32 positions, four rows per thread, so the score stage
//   has no idle pass and the halo costs 14% more scores than outputs.  Score
//   positions outside the image hold -inf, the NMS window's padding.
// - Arc minima and maxima by doubling: m2[k] = min(d[k], d[k+1]),
//   m4[k] = min(m2[k], m2[k+2]), m8[k] = min(m4[k], m4[k+4]), and the arc of
//   9 starting at k is min(m8[k], d[k+8]) - 64 min and 64 max per pixel
//   instead of 256 for 16 windows scanned one by one.  The ring offsets are
//   compile-time constants, so every tap is one shared load at a fixed
//   offset.
// - The TPU kernel's 64-row bands over a VMEM-resident image become
//   independent 2-D tiles, since blocks run in parallel and nothing carries
//   between them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kRows = 4;  // score rows per thread
constexpr int kThreads = 256;
constexpr int kScoreW = 32;  // one warp per score row
constexpr int kScoreH = kThreads / kScoreW * kRows;
constexpr int kTileW = kScoreW - 2;
constexpr int kTileH = kScoreH - 2;
constexpr int kHalo = 4;
constexpr int kLoadW = kTileW + 2 * kHalo;
constexpr int kLoadH = kTileH + 2 * kHalo;

struct Level {
  const float* in;
  float* out;
  long long in_stride;  // elements from one stream's level to the next's
  long long out_stride;
  int h;
  int w;
  int tiles_x;
  int first_tile;
};

struct LevelTable {
  Level lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// FAST-9 score of the pixel at (cy, cx) of the staged tile
__device__ __forceinline__ float fast9_score(float (*tile)[kLoadW], int cy, int cx) {
  // the Bresenham circle of radius 3 in circular order; constant offsets
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[cy + kDy[k]][cx + kDx[k]] - c;
  float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn2[k] = fminf(d[k], d[(k + 1) & 15]);
    mx2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn4[k] = fminf(mn2[k], mn2[(k + 2) & 15]);
    mx4[k] = fmaxf(mx2[k], mx2[(k + 2) & 15]);
  }
  float bright = -INFINITY;
  float dark = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float arc_min = fminf(fminf(mn4[k], mn4[(k + 4) & 15]), d[(k + 8) & 15]);
    const float arc_max = fmaxf(fmaxf(mx4[k], mx4[(k + 4) & 15]), d[(k + 8) & 15]);
    bright = fmaxf(bright, arc_min);
    dark = fmaxf(dark, -arc_max);
  }
  return fmaxf(fmaxf(bright, dark), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
fast_nms_pyramid_kernel(const LevelTable table) {
  __shared__ float tile[kLoadH][kLoadW];
  __shared__ float score[kScoreH][kScoreW];

  // this block's level: the last one whose first tile is <= blockIdx.x
  // (selected with constant indices, so the table stays in parameter space)
  Level lv = table.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < table.n && static_cast<int>(blockIdx.x) >= table.lv[i].first_tile) lv = table.lv[i];
  const float* in = lv.in + blockIdx.y * lv.in_stride;  // stream blockIdx.y
  float* out = lv.out + blockIdx.y * lv.out_stride;
  const int t = blockIdx.x - lv.first_tile;
  const int ty0 = t / lv.tiles_x;
  const int x0 = (t - ty0 * lv.tiles_x) * kTileW;
  const int y0 = ty0 * kTileH;
  const int tid = threadIdx.x;

  for (int i = tid; i < kLoadH * kLoadW; i += kThreads) {
    const int ly = i / kLoadW;
    const int lx = i - ly * kLoadW;
    const int gy = clampi(y0 + ly - kHalo, 0, lv.h - 1);
    const int gx = clampi(x0 + lx - kHalo, 0, lv.w - 1);
    tile[ly][lx] = in[gy * lv.w + gx];
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int sy = tid / kScoreW + r * (kThreads / kScoreW);
    const int sx = tid % kScoreW;
    const int gy = y0 + sy - 1;
    const int gx = x0 + sx - 1;
    const bool inside = gy >= 0 && gy < lv.h && gx >= 0 && gx < lv.w;
    score[sy][sx] = inside ? fast9_score(tile, sy - 1 + kHalo, sx - 1 + kHalo) : -INFINITY;
  }
  __syncthreads();

  for (int i = tid; i < kTileW * kTileH; i += kThreads) {
    const int oy = i / kTileW;
    const int ox = i - oy * kTileW;
    const int gx = x0 + ox;
    const int gy = y0 + oy;
    if (gx < lv.w && gy < lv.h) {
      const float c = score[oy + 1][ox + 1];
      float m = c;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, score[oy + dy][ox + dx]);
      out[gy * lv.w + gx] = (c >= m) ? c : 0.0f;
    }
  }
}

}  // namespace

// levels: n rows of (input pointer, output pointer, h, w, input stream
// stride, output stream stride) as int64, on the host, strides in floats;
// 1 <= n <= kMaxLevels, every h and w >= 1; 1 <= streams <= 65535.  One
// launch for every level of every stream.
extern "C" int rgbdvo_fast_nms_pyramid(const int64_t* levels, int n, int streams, void* stream) {
  if (n < 1 || n > kMaxLevels || streams < 1 || streams > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable table{};
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* row = levels + 6 * i;
    Level& lv = table.lv[i];
    lv.in = reinterpret_cast<const float*>(row[0]);
    lv.out = reinterpret_cast<float*>(row[1]);
    lv.h = static_cast<int>(row[2]);
    lv.w = static_cast<int>(row[3]);
    lv.in_stride = row[4];
    lv.out_stride = row[5];
    if (lv.h < 1 || lv.w < 1) return static_cast<int>(cudaErrorInvalidValue);
    lv.tiles_x = (lv.w + kTileW - 1) / kTileW;
    lv.first_tile = tiles;
    tiles += lv.tiles_x * ((lv.h + kTileH - 1) / kTileH);
  }
  table.n = n;
  const dim3 grid(tiles, streams);
  fast_nms_pyramid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}
