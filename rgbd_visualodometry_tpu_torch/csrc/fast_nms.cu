// K1: fused FAST-9 corner score + 3x3 non-maximum suppression.
//
// Replaces the Pallas TPU kernel `_fast_nms_kernel` / `fast_score_nms`
// (rgbd_visualodometry_tpu/ops/pallas_fast.py:30,78) and, on the main path,
// the XLA formulation `fast.fast_score` + `image.maxpool3x3` that the JAX
// package computes on every pyramid level (ops/fast.py:113-117).
//
// out[y, x] = s(y, x) if s(y, x) >= max of s over the 3x3 window, else 0,
// where s is the FAST-9 score of the edge-padded image (max over the 16 arcs
// of 9 contiguous ring pixels of the min ring difference, bright and dark,
// clamped at 0) and the NMS window is -inf outside the image.  Only
// subtraction, min and max are used, so the result is bit-identical to the
// plain torch version (ops/fast.py::fast_nms_reference).
//
// What bounds it on an H100: about 300 min/max/sub operations per pixel on
// 16 neighbours read from shared memory; device memory traffic is one read
// and one write of the image (2.4 MB at 640x480), far below the bandwidth
// bound.  The work is arithmetic on the CUDA cores, in shared memory.
// Design: one thread per output pixel; a 32x16 block stages its tile plus a
// 4-pixel halo (3 for the Bresenham circle, 1 for the NMS window) in shared
// memory with edge-clamped indices - the same values as jnp.pad(mode="edge")
// - computes the score over the tile plus a 1-pixel ring into a second
// shared array, then takes the 3x3 max.  The TPU kernel's 64-row bands with
// a VMEM-resident image become independent 2-D tiles, since blocks run in
// parallel and nothing carries between them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kLoadW = kTileW + 2 * kHalo;
constexpr int kLoadH = kTileH + 2 * kHalo;
constexpr int kScoreW = kTileW + 2;
constexpr int kScoreH = kTileH + 2;

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kTileW * kTileH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w) {
  __shared__ float tile[kLoadH][kLoadW];
  __shared__ float score[kScoreH][kScoreW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthreads = kTileW * kTileH;

  for (int i = tid; i < kLoadH * kLoadW; i += nthreads) {
    const int ty = i / kLoadW;
    const int tx = i - ty * kLoadW;
    const int gy = clampi(y0 + ty - kHalo, 0, h - 1);
    const int gx = clampi(x0 + tx - kHalo, 0, w - 1);
    tile[ty][tx] = img[gy * w + gx];
  }
  __syncthreads();

  for (int i = tid; i < kScoreH * kScoreW; i += nthreads) {
    const int sy = i / kScoreW;
    const int sx = i - sy * kScoreW;
    const int gy = y0 + sy - 1;
    const int gx = x0 + sx - 1;
    float s = -INFINITY;  // the NMS window's padding outside the image
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int cy = sy - 1 + kHalo;
      const int cx = sx - 1 + kHalo;
      const float c = tile[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = tile[cy + c_dy[k]][cx + c_dx[k]] - c;
      float bright = -INFINITY;
      float dark = -INFINITY;
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        float mn = d[a];
        float mx = d[a];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          const float v = d[(a + j) & 15];
          mn = fminf(mn, v);
          mx = fmaxf(mx, v);
        }
        bright = fmaxf(bright, mn);
        dark = fmaxf(dark, -mx);
      }
      s = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  if (gx < w && gy < h) {
    const float c = score[threadIdx.y + 1][threadIdx.x + 1];
    float m = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, score[threadIdx.y + dy][threadIdx.x + dx]);
    out[gy * w + gx] = (c >= m) ? c : 0.0f;
  }
}

}  // namespace

extern "C" int rgbdvo_fast_nms(const float* img, float* out, int h, int w, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
