// K2 and K3: Hamming distances between packed 256-bit ORB descriptors.
//
// Both read descriptors as 8 uint32 words per row (word-major, LSB-first
// like ops/orb.py) and share one xor/popcount distance, `hamming256`.  The
// TPU kernels' bit permutation (_TILE_PERM, a Mosaic layout workaround) has
// no counterpart: xor and popcount read the packed words directly.
// Integer arithmetic: both equal their plain torch versions exactly
// (ops/matching.py).
//
// K2 `hamming_nn`: nearest valid keypoint for every map candidate.
// Replaces the Pallas TPU kernel `_kernel_T` / `_hamming_packed_pallas_T` /
// `hamming_matrix_packed_T` (rgbd_visualodometry_tpu/ops/pallas_match.py:
// 152,174,193) together with the masked min/argmin that
// `matching.nearest_keypoints_packed` (ops/matching.py:78-101) applies to
// its [N, C] distance matrix.  Inputs: the packed map pool cand [C, 8], the
// packed keypoints kp [N, 8] and kp_mask [N] (bytes).  Outputs: kp_index [C]
// int32 and distance [C] int32.  A masked keypoint counts as BIG = 1 << 20
// (matching.py:25); the argmin is a strict '<', so the lowest keypoint index
// wins a tie like jnp.argmin, and a candidate with no valid keypoint gets
// index 0 and distance BIG.
// What bounds it on an H100: 2 * 8 * N integer operations (xor, popcount)
// per candidate - 8,000 at N = 500, 131 M for C = 16384 - on the integer
// ALUs; device memory traffic is only the 512 KB pool, read once.  Design:
// the keypoints (16 KB at N = 500) are staged once per block in shared
// memory, and every thread of a warp reads the same keypoint word at the
// same time (a broadcast, no bank conflicts); one thread per candidate keeps
// its 8 words in registers and the running (min, argmin).  The [N, C] matrix
// is never written.
//
// K3 `hamming_matrix`: the full distance matrix out[c, n] from a row-major
// pool.  Replaces the Pallas TPU kernel `_kernel` / `_hamming_packed_pallas`
// / `hamming_matrix_packed` (rgbd_visualodometry_tpu/ops/pallas_match.py:
// 64,94,116), whose (256 - dot) / 2 it equals.  Inputs: cand [C, 8] and
// kp [N, 8]; output [C, N] int32, no mask, no reduction.
// What bounds it on an H100: at C = 65536, N = 512 the 128 MiB of output
// (~40 us at 3.35 TB/s) and 268 M popcounts (~70 us at 16 per clock per SM).
// Design: lanes of a warp take consecutive n of one candidate row, so each
// row's stores are coalesced (K2's one-thread-per-candidate layout would
// store with a stride of N).  A thread keeps its keypoint's 8 words in
// registers; a block of kMatThreads keypoints stages kMatRows candidate rows
// (1 KB) in shared memory, read as broadcasts, and writes kMatRows rows.
// Ragged C and N are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kThreads = 256;
constexpr int kMatThreads = 128;
constexpr int kMatRows = 32;

// popcount(a ^ b) over 256 bits: a in two 16-byte registers, b as 8 words
__device__ __forceinline__ int hamming256(uint4 lo, uint4 hi, const uint32_t* b) {
  return __popc(lo.x ^ b[0]) + __popc(lo.y ^ b[1]) + __popc(lo.z ^ b[2]) + __popc(lo.w ^ b[3]) +
         __popc(hi.x ^ b[4]) + __popc(hi.y ^ b[5]) + __popc(hi.z ^ b[6]) + __popc(hi.w ^ b[7]);
}

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
    const int d = hamming256(lo, hi, skp + 8 * n);
    if (d < best) {
      best = d;
      best_i = n;
    }
  }
  out_index[c] = best_i;
  out_dist[c] = best;
}

// grid (ceil(C / kMatRows), ceil(N / kMatThreads)): block x takes candidate
// rows [kMatRows * x, +kMatRows), block y keypoints [kMatThreads * y, +kMatThreads)
__global__ void __launch_bounds__(kMatThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ kp, int C,
                      int N, int32_t* __restrict__ out) {
  __shared__ uint32_t scand[kMatRows * 8];
  const size_t c0 = static_cast<size_t>(blockIdx.x) * kMatRows;
  const int rows = min(kMatRows, C - static_cast<int>(c0));
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) scand[i] = cand[c0 * 8 + i];
  __syncthreads();

  const int n = blockIdx.y * kMatThreads + threadIdx.x;
  if (n >= N) return;
  const uint4* k = reinterpret_cast<const uint4*>(kp + 8 * static_cast<size_t>(n));
  const uint4 lo = k[0];
  const uint4 hi = k[1];
  int32_t* o = out + c0 * N + n;
  for (int r = 0; r < rows; ++r) o[static_cast<size_t>(r) * N] = hamming256(lo, hi, scand + 8 * r);
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

extern "C" int rgbdvo_hamming_matrix(const void* cand, const void* kp, int C, int N, void* out,
                                     void* stream) {
  if (C == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((C + kMatRows - 1) / kMatRows, (N + kMatThreads - 1) / kMatThreads);
  hamming_matrix_kernel<<<grid, kMatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(kp), C, N,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgbdvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
