// K2: nearest valid keypoint by Hamming distance for every map candidate.
//
// Replaces the Pallas TPU kernel `_kernel_T` / `_hamming_packed_pallas_T` /
// `hamming_matrix_packed_T` (rgbd_visualodometry_tpu/ops/pallas_match.py:
// 152,174,193) together with the masked min/argmin that
// `matching.nearest_keypoints_packed` (ops/matching.py:78-101) applies to
// its [N, C] distance matrix.
//
// Inputs: the packed map pool cand [C, 8] uint32 (row-major, 256 bits per
// row, word-major and LSB-first like ops/orb.py), the packed keypoints
// kp [N, 8] uint32 and kp_mask [N] (bytes).  Outputs: kp_index [C] int32 and
// distance [C] int32.  A masked keypoint counts as BIG = 1 << 20
// (matching.py:25); the argmin is a strict '<', so the lowest keypoint index
// wins a tie like jnp.argmin, and a candidate with no valid keypoint gets
// index 0 and distance BIG.  Integer arithmetic: exact equality with the
// plain torch version (ops/matching.py::hamming_nn_reference).
//
// What bounds it on an H100: 2 * 8 * N integer operations (xor, popcount)
// per candidate - 8,000 at N = 500, 131 M for C = 16384 - on the integer
// ALUs; device memory traffic is only the 512 KB pool, read once.  Design: the keypoints (16 KB at N = 500) are staged once per block
// in shared memory, and every thread of a warp reads the same keypoint word
// at the same time (a broadcast, no bank conflicts); one thread per
// candidate keeps its 8 words in registers and the running (min, argmin).
// The [N, C] matrix is never written, and the TPU kernel's bit permutation
// (_TILE_PERM, a Mosaic layout workaround) has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hamming_nn_kernel(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ kp,
                  const uint8_t* __restrict__ kp_mask, int C, int N,
                  int32_t* __restrict__ out_index, int32_t* __restrict__ out_dist) {
  extern __shared__ uint32_t smem[];
  uint32_t* skp = smem;
  uint8_t* smask = reinterpret_cast<uint8_t*>(smem + 8 * N);
  for (int i = threadIdx.x; i < 8 * N; i += blockDim.x) skp[i] = kp[i];
  for (int i = threadIdx.x; i < N; i += blockDim.x) smask[i] = kp_mask[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const uint4* row = reinterpret_cast<const uint4*>(cand + 8 * static_cast<size_t>(c));
  const uint4 lo = row[0];
  const uint4 hi = row[1];
  int best = kBig;
  int best_i = 0;
  for (int n = 0; n < N; ++n) {
    if (!smask[n]) continue;
    const uint32_t* k = skp + 8 * n;
    const int d = __popc(lo.x ^ k[0]) + __popc(lo.y ^ k[1]) + __popc(lo.z ^ k[2]) +
                  __popc(lo.w ^ k[3]) + __popc(hi.x ^ k[4]) + __popc(hi.y ^ k[5]) +
                  __popc(hi.z ^ k[6]) + __popc(hi.w ^ k[7]);
    if (d < best) {
      best = d;
      best_i = n;
    }
  }
  out_index[c] = best_i;
  out_dist[c] = best;
}

}  // namespace

extern "C" int rgbdvo_hamming_nn(const void* cand, const void* kp, const void* kp_mask, int C,
                                 int N, void* out_index, void* out_dist, void* stream) {
  const size_t smem = static_cast<size_t>(N) * (8 * sizeof(uint32_t) + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hamming_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (C == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (C + kThreads - 1) / kThreads;
  hamming_nn_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(kp),
      static_cast<const uint8_t*>(kp_mask), C, N, static_cast<int32_t*>(out_index),
      static_cast<int32_t*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgbdvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
