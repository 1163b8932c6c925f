// K2 and K3: Hamming distances between packed 256-bit ORB descriptors.
//
// Both read descriptors as 8 uint32 words per row (word-major, LSB-first
// like ops/orb.py).  The TPU kernels' bit permutation (_TILE_PERM, a Mosaic
// layout workaround) has no counterpart.  Integer arithmetic: both equal
// their plain torch versions exactly (ops/matching.py).
//
// K2 `hamming_nn`: nearest valid keypoint for every map candidate.
// Replaces the Pallas TPU kernel `_kernel_T` / `_hamming_packed_pallas_T` /
// `hamming_matrix_packed_T` (rgbd_visualodometry_tpu/ops/pallas_match.py:
// 152,174,193; launched at :181) together with the masked min/argmin that
// `matching.nearest_keypoints_packed` (ops/matching.py:78-101) applies to
// its [N, C] distance matrix; it is also the counterpart of the default
// int8-dot path `matching.nearest_keypoints` (ops/matching.py:60-75).
// Inputs: the packed map pool cand [C, 8], the packed keypoints kp [N, 8]
// and kp_mask [N] (bytes).  Outputs: kp_index [C] int32 and distance [C]
// int32.  A masked keypoint counts as BIG = 1 << 20 (matching.py:25); the
// lowest keypoint index wins a tie like jnp.argmin, and a candidate with no
// valid keypoint gets index 0 and distance BIG.
// What bounds it on an H100: C * N * 256 products of bits - as the JAX
// default's int8 dot, 4.19 G int8 operations at C = 16384, N = 500, 2.1 us
// at the 1,979 TOP/s int8 tensor-core peak; device memory traffic is
// ~0.7 MB (the pool read once), 0.2 us.  The same distances as xor +
// popcount take 65.5 M popc instructions, ~17 us at 16 per clock per SM.
// Design: single-bit tensor cores.  mma.sync.m16n8k256.b1.and.popc takes a
// [16 candidates x 8 keypoints] tile over all 256 bits in one instruction,
// straight from the packed words: lane (g = lane / 4, t = lane % 4) holds
// words t and t + 4 of candidate rows g and g + 8 as A and of keypoint g as
// B (the fragment layout of the PTX ISA: A register r holds row g + 8 (r & 1),
// bits 32t + 128 (r >> 1) + [0, 32)), so no unpacked or bipolar copy exists
// anywhere.  It counts popc(a & b); the distance is popc(a) + popc(b) -
// 2 popc(a & b).  (The int8 form, eight m16n8k32.s8 steps over +-1 bytes
// built from the words, took longer on the card.)  A block of 512 threads
// takes 128 candidates: 8 warps of 16 rows times 2 warps that split the
// keypoint tiles between them, merged at the end.  The keypoints (32 B
// each, 16 KB at N = 500; the halves of every other group of four rows
// swapped so the two word loads of a tile hit distinct banks), padded to a
// multiple of 8 with masked columns, live in shared memory with (popc, 0 or
// BIG) per keypoint: the masked distance is max(distance, floor).  The
// epilogue keeps a running (distance, index) minimum for the thread's two
// rows in registers - a strict '<' over its columns in increasing order -
// then a shuffle across the four lanes that share a row and a pass over
// the two keypoint splits merge them lexicographically, so the result
// equals the strict-'<' scan of the plain version.  The [N, C] matrix is
// never written.  More than ~1,150 keypoints exceed 48 KB of shared
// memory: the launcher opts in to the larger dynamic size.
//
// K3 `hamming_matrix`: the full distance matrix out[c, n] from a row-major
// pool.  Replaces the Pallas TPU kernel `_kernel` / `_hamming_packed_pallas`
// / `hamming_matrix_packed` (rgbd_visualodometry_tpu/ops/pallas_match.py:
// 64,94,116), whose (256 - dot) / 2 it equals.  Inputs: cand [C, 8] and
// kp [N, 8]; output [C, N] int32, no mask, no reduction.
// What bounds it on an H100: at C = 65536, N = 512 the 128 MiB of output
// (~40 us at 3.35 TB/s) and 268 M popcounts (~70 us at 16 per clock per SM).
// Design: lanes of a warp take consecutive n of one candidate row, so each
// row's stores are coalesced (one thread per candidate would store with a
// stride of N).  The distance is xor + popcount, `hamming256`.  A thread
// keeps its keypoint's 8 words in registers; a block of kMatThreads
// keypoints stages kMatRows candidate rows (1 KB) in shared memory, read as
// broadcasts, and writes kMatRows rows.
// Ragged C and N are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kRowGroups = 8;  // warps across candidates, 16 rows each
constexpr int kSplits = 2;  // warps across keypoint tiles, merged at the end
constexpr int kNnThreads = 32 * kRowGroups * kSplits;
constexpr int kNnRows = 16 * kRowGroups;
constexpr int kMatThreads = 128;
constexpr int kMatRows = 32;

// popcount(a ^ b) over 256 bits: a in two 16-byte registers, b as 8 words
__device__ __forceinline__ int hamming256(uint4 lo, uint4 hi, const uint32_t* b) {
  return __popc(lo.x ^ b[0]) + __popc(lo.y ^ b[1]) + __popc(lo.z ^ b[2]) + __popc(lo.w ^ b[3]) +
         __popc(hi.x ^ b[4]) + __popc(hi.y ^ b[5]) + __popc(hi.z ^ b[6]) + __popc(hi.w ^ b[7]);
}

// acc += popc(A & B) over 256 bits: a [16 x 256] x [256 x 8] single-bit product
__device__ __forceinline__ void mma_b1_and_popc(int (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int popc256(uint4 lo, uint4 hi) {
  return __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) + __popc(hi.x) + __popc(hi.y) +
         __popc(hi.z) + __popc(hi.w);
}

// lexicographic (distance, index) minimum
__device__ __forceinline__ void take_min(int& d, int& i, int od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

// grid ceil(C / kNnRows).  Shared memory: skp [n_pad][8] packed keypoints
// (halves swapped where (n >> 2) & 1), spf [n_pad] (popc, floor), spart
// [kSplits][kNnRows] per-split (distance, index).
__global__ void __launch_bounds__(kNnThreads)
hamming_nn_kernel(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ kp,
                  const uint8_t* __restrict__ kp_mask, int C, int N, int n_pad,
                  int32_t* __restrict__ out_index, int32_t* __restrict__ out_dist) {
  extern __shared__ uint4 smem4[];
  uint4* skp = smem4;
  int2* spf = reinterpret_cast<int2*>(skp + 2 * n_pad);
  int2* spart = spf + n_pad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = tid >> 5;
  const int group = warp % kRowGroups;
  const int split = warp / kRowGroups;
  const int row0 = blockIdx.x * kNnRows + group * 16;
  const uint4 z = make_uint4(0, 0, 0, 0);

  // every global load of the block in flight together: keypoints, mask, rows
  for (int n = tid; n < n_pad; n += kNnThreads) {
    const uint4* k = reinterpret_cast<const uint4*>(kp) + 2 * n;
    const uint4 lo = n < N ? k[0] : z, hi = n < N ? k[1] : z;
    const int swap = (n >> 2) & 1;
    skp[2 * n + swap] = lo;
    skp[2 * n + 1 - swap] = hi;
    spf[n] = make_int2(popc256(lo, hi), (n < N && kp_mask[n]) ? 0 : kBig);
  }
  uint4 rows[2][2];  // candidate rows row0 + g (h = 0) and row0 + g + 8 (h = 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h + g;
    const uint4* pr = reinterpret_cast<const uint4*>(cand + 8 * static_cast<size_t>(r));
    rows[h][0] = r < C ? pr[0] : z;
    rows[h][1] = r < C ? pr[1] : z;
  }
  __syncthreads();

  // A: words t and t + 4 of rows g and g + 8
  const uint32_t w0[8] = {rows[0][0].x, rows[0][0].y, rows[0][0].z, rows[0][0].w,
                          rows[0][1].x, rows[0][1].y, rows[0][1].z, rows[0][1].w};
  const uint32_t w1[8] = {rows[1][0].x, rows[1][0].y, rows[1][0].z, rows[1][0].w,
                          rows[1][1].x, rows[1][1].y, rows[1][1].z, rows[1][1].w};
  uint32_t a[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s == t) {  // constant register indices
      a[0] = w0[s];
      a[1] = w1[s];
      a[2] = w0[s + 4];
      a[3] = w1[s + 4];
    }
  const int pa0 = popc256(rows[0][0], rows[0][1]);
  const int pa1 = popc256(rows[1][0], rows[1][1]);

  int best0 = kBig, idx0 = 0, best1 = kBig, idx1 = 0;  // running minima of rows g, g + 8
  if (row0 < C) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(skp);
    const int sw = ((g >> 2) & 1) << 2;  // n0 is a multiple of 8, so (n >> 2) & 1 = g >> 2
    for (int n0 = 8 * split; n0 < n_pad; n0 += 8 * kSplits) {
      int acc[4] = {0, 0, 0, 0};
      mma_b1_and_popc(acc, a, words[8 * (n0 + g) + (t ^ sw)], words[8 * (n0 + g) + ((t + 4) ^ sw)]);
      const int n = n0 + 2 * t;
      const int4 pf = *reinterpret_cast<const int4*>(spf + n);  // (popc, floor) of n and n + 1
      const int d0 = max(pa0 + pf.x - 2 * acc[0], pf.y);
      const int d1 = max(pa0 + pf.z - 2 * acc[1], pf.w);
      const int d2 = max(pa1 + pf.x - 2 * acc[2], pf.y);
      const int d3 = max(pa1 + pf.z - 2 * acc[3], pf.w);
      if (d0 < best0) { best0 = d0; idx0 = n; }
      if (d1 < best0) { best0 = d1; idx0 = n + 1; }
      if (d2 < best1) { best1 = d2; idx1 = n; }
      if (d3 < best1) { best1 = d3; idx1 = n + 1; }
    }
  }
  // merge the four lanes of a quad (same rows, columns 2t, 2t + 1 of each tile)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    take_min(best0, idx0, __shfl_xor_sync(0xffffffffu, best0, off), __shfl_xor_sync(0xffffffffu, idx0, off));
    take_min(best1, idx1, __shfl_xor_sync(0xffffffffu, best1, off), __shfl_xor_sync(0xffffffffu, idx1, off));
  }
  if (t == 0) {
    spart[split * kNnRows + group * 16 + g] = make_int2(best0, idx0);
    spart[split * kNnRows + group * 16 + g + 8] = make_int2(best1, idx1);
  }
  __syncthreads();
  // merge the splits, each the lexicographic minimum over its own tiles
  const int c = blockIdx.x * kNnRows + tid;
  if (tid < kNnRows && c < C) {
    int2 b = spart[tid];
#pragma unroll
    for (int sp = 1; sp < kSplits; ++sp) {
      const int2 o = spart[sp * kNnRows + tid];
      take_min(b.x, b.y, o.x, o.y);
    }
    out_index[c] = b.y;
    out_dist[c] = b.x;
  }
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
  const int n_pad = (N + 7) / 8 * 8;  // keypoints padded with masked columns to whole tiles
  const size_t smem = static_cast<size_t>(n_pad) * (2 * sizeof(uint4) + sizeof(int2)) +
                      kSplits * kNnRows * sizeof(int2);
  if (smem > 48 * 1024) {  // the opt-in is per device: made on every such launch
    cudaError_t err = cudaFuncSetAttribute(
        hamming_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (C == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (C + kNnRows - 1) / kNnRows;
  hamming_nn_kernel<<<blocks, kNnThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(kp),
      static_cast<const uint8_t*>(kp_mask), C, N, n_pad, static_cast<int32_t*>(out_index),
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
