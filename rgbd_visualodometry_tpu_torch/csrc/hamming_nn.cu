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
// Inputs, for S streams at once: the packed map pools cand [S, C, 8], the
// packed keypoints kp [S, N, 8] and kp_mask [S, N] (bytes).  Outputs:
// kp_index [S, C] int32 and distance [S, C] int32.  Stream s is
// blockIdx.y: its blocks read and write only stream s's rows, so S streams
// are one launch (72 x 128 blocks at C = 16384, where one stream alone
// fills 128 of the 132 SMs once).  A masked keypoint counts as BIG = 1 << 20 (matching.py:25); the
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
// anywhere.  At S = 72 streams of C = 16384, N = 500 the products are
// 302 G int8 operations, ~0.15 ms at the peak.  It counts popc(a & b); the distance is popc(a) + popc(b) -
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
// pool.  Replaces the Pallas TPU kernel `_kernel`
// (rgbd_visualodometry_tpu/ops/pallas_match.py:64), launched at :104 by
// `_hamming_packed_pallas` and reached through `hamming_matrix_packed`
// (:116), whose (256 - dot) / 2 it equals bit for bit.  Inputs: cand [C, 8]
// and kp [N, 8]; output [C, N] int32, no mask, no reduction.
// What bounds it on an H100: the bytes, 4 C N written plus 32 (C + N) read:
// at C = 65536, N = 512 the 128 MiB of output, ~40 us at 3.35 TB/s.  The
// products, counted as 2 C N 256 int8 operations, take ~8.7 us at 1,979
// TOP/s.
// The first port (one thread per keypoint, xor + `__popc` over 8 words
// against staged candidate rows) sent all C N 8 words through the popcount
// pipe - 268 M POPC at that shape, ~70 us at 16 per clock per SM - so it was
// bound by that issue rate, not by its stores.
// Design: the products on single-bit tensor cores as in K2 (the same
// fragments, keypoint staging and distance popc(a) + popc(b) - 2 popc(a & b),
// here with no mask floor), so only the stores are left, and a store path
// built for them.  A persistent grid of 256-thread blocks (at most two per
// SM, each with the same number of tiles) walks output tiles of 16
// candidate rows x one chunk of at most kMatCols keypoints, chunk-major, so
// a block stages a chunk's keypoints (32 B each plus their popcount) once
// and keeps them while it walks the rows.  Per tile each warp holds the A
// fragment of the 16 rows in registers (their popcounts summed over the
// quad by two shuffles; the loads issued one tile ahead, so their latency
// passes while the previous tile is stored) and runs one `mma` per
// 8-keypoint tile over every eighth tile of the chunk.  Its distances go to
// a [16, pitch] int32 tile in shared memory, whose pitch = 8 (mod 32) words
// puts the eight rows of an int2 fragment store on distinct banks (two
// wavefronts per store, the least).  The block then writes the tile row by
// row: 16-byte vector loads of the shared tile and 16-byte streaming stores
// (`st.global.cs`: the output is never re-read and is larger than the 50 MB
// L2), consecutive threads on consecutive addresses, one row's chunks after
// the next.  A block's first row starts at c0 N with c0 a multiple of 16, so
// when N is a multiple of 4 (and the output 16-byte aligned) every row is
// 16-byte aligned; otherwise (N = 37: 148-byte rows) the same walk stores
// one int32 per thread.  Two blocks share an SM, so one block's stores
// overlap the other's `mma`s.  Padded keypoint columns and rows past C are
// computed in shared memory but never stored.
// Measured on the card (tools/k3_variants.py): the `mma`s cost nothing
// measurable (without them it is no faster), the compute alone takes under
// half of the store-only time, and what is left is how the two overlap.
// Plain stores instead of `.cs` are ~10% slower at 65536 x 512.  Up to four
// blocks per SM or four warps per block were slower at one of the two
// shapes.  Bulk copies (`cp.async.bulk`, double-buffered) left the threads
// free of the stores but needed two barriers and a proxy fence per tile and
// more shared memory, and were slower at 16384 x 500.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kRowGroups = 8;  // warps across candidates, 16 rows each
constexpr int kSplits = 2;  // warps across keypoint tiles, merged at the end
constexpr int kNnThreads = 32 * kRowGroups * kSplits;
constexpr int kNnRows = 16 * kRowGroups;
constexpr int kMatSplits = 8;  // warps of a K3 block: each takes every 8th keypoint tile
constexpr int kMatThreads = 32 * kMatSplits;
constexpr int kMatRows = 16;  // candidate rows of a K3 tile: one m16 A fragment
constexpr int kMatCols = 512;  // keypoints of a K3 column chunk, staged in shared memory
constexpr int kMatBlocksPerSm = 2;  // resident K3 blocks per SM, at most

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

// grid (ceil(C / kNnRows), S); the inputs and outputs of stream blockIdx.y
// start at the given pointers plus blockIdx.y times their rows.  Shared memory: skp [n_pad][8] packed keypoints
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
  const size_t stream = blockIdx.y;
  cand += stream * C * 8;
  kp += stream * N * 8;
  kp_mask += stream * N;
  out_index += stream * C;
  out_dist += stream * C;

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

// st.global.cs: evict-first, the output is never read again by the kernel
template <typename T>
__device__ __forceinline__ void store_streaming(T* p, T v) {
  __stcs(p, v);
}

// A fragment of candidate rows c0 + g and c0 + g + 8: words t and t + 4 (zero past C)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* cand, int C, int c0, int g,
                                       int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = c0 + 8 * h + g;
    const uint32_t* pr = cand + 8 * static_cast<size_t>(r);
    a[h] = r < C ? pr[t] : 0u;
    a[h + 2] = r < C ? pr[t + 4] : 0u;
  }
}

// Write rows [0, rows) x columns [0, nc) of the shared tile (row pitch
// `pitch` words) to dst (row stride N words) with streaming stores of T:
// int4 where nc and every row start are 16-byte aligned, else int.  The
// block's threads walk the tile's T-sized pieces in row-major order.
template <typename T>
__device__ __forceinline__ void store_tile(const int* tile, int pitch, int rows, int nc, int N,
                                           int32_t* dst) {
  constexpr int kWords = sizeof(T) / sizeof(int);
  const int per_row = nc / kWords;
  const int dr = kMatThreads / per_row, dq = kMatThreads % per_row;
  int r = threadIdx.x / per_row, q = threadIdx.x % per_row;
  while (r < rows) {
    store_streaming(reinterpret_cast<T*>(dst + static_cast<size_t>(r) * N) + q,
                    reinterpret_cast<const T*>(tile + r * pitch)[q]);
    r += dr;
    q += dq;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of the chunk-major
// order (chunk of kMatCols keypoints, then 16-row tile).  Shared memory:
// skp [kc_pad][8] the chunk's keypoints (halves swapped where (n >> 2) & 1),
// spb [kc_pad] their popcounts, sout [kMatRows][pitch] the tile's distances.
__global__ void __launch_bounds__(kMatThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ kp, int C,
                      int N, int kc_pad, int pitch, int vec, int32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint4* skp = smem4;
  int* spb = reinterpret_cast<int*>(skp + 2 * kc_pad);
  int* sout = spb + kc_pad;  // 16-byte aligned: kc_pad is a multiple of 8

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = tid >> 5;
  const int row_tiles = (C + kMatRows - 1) / kMatRows;
  const int tiles = row_tiles * ((N + kMatCols - 1) / kMatCols);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(skp);
  const int sw = ((g >> 2) & 1) << 2;  // a tile's 8 keypoints start at a multiple of 8
  const uint4 z = make_uint4(0, 0, 0, 0);
  int staged = -1;
  uint32_t a[4];  // the A fragment of the block's next tile, loaded one tile ahead
  const int stride = gridDim.x;
  if (static_cast<int>(blockIdx.x) < tiles) load_a(a, cand, C, blockIdx.x % row_tiles * kMatRows, g, t);

  for (int tile = blockIdx.x; tile < tiles; tile += stride) {
    const int chunk = tile / row_tiles;
    const int c0 = (tile - chunk * row_tiles) * kMatRows;
    const int n0 = chunk * kMatCols;
    const int nc = min(kMatCols, N - n0);
    const int nc_pad = (nc + 7) & ~7;
    if (chunk != staged) {  // after the last tile's closing barrier: no warp reads skp now
#pragma unroll 2
      for (int i = tid; i < nc_pad; i += kMatThreads) {  // at most 2 per thread: loads batched
        const int n = n0 + i;
        const uint4* k = reinterpret_cast<const uint4*>(kp) + 2 * static_cast<size_t>(n);
        const uint4 lo = n < N ? k[0] : z, hi = n < N ? k[1] : z;
        const int swap = (i >> 2) & 1;
        skp[2 * i + swap] = lo;
        skp[2 * i + 1 - swap] = hi;
        spb[i] = popc256(lo, hi);
      }
      staged = chunk;
      __syncthreads();
    }

    int pa0 = __popc(a[0]) + __popc(a[2]);  // popcounts of rows g and g + 8, summed over the quad
    int pa1 = __popc(a[1]) + __popc(a[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      pa0 += __shfl_xor_sync(0xffffffffu, pa0, off);
      pa1 += __shfl_xor_sync(0xffffffffu, pa1, off);
    }
    int* o0 = sout + g * pitch + 2 * t;  // row g, columns 2t, 2t + 1 of each 8-keypoint tile
    int* o1 = o0 + 8 * pitch;  // row g + 8
#pragma unroll 4
    for (int j = 8 * warp; j < nc_pad; j += 8 * kMatSplits) {
      int acc[4] = {0, 0, 0, 0};
      mma_b1_and_popc(acc, a, words[8 * (j + g) + (t ^ sw)], words[8 * (j + g) + ((t + 4) ^ sw)]);
      const int2 pb = *reinterpret_cast<const int2*>(spb + j + 2 * t);
      *reinterpret_cast<int2*>(o0 + j) = make_int2(pa0 + pb.x - 2 * acc[0], pa0 + pb.y - 2 * acc[1]);
      *reinterpret_cast<int2*>(o1 + j) = make_int2(pa1 + pb.x - 2 * acc[2], pa1 + pb.y - 2 * acc[3]);
    }
    // the next tile's A loads run while this tile is stored
    if (tile + stride < tiles) load_a(a, cand, C, (tile + stride) % row_tiles * kMatRows, g, t);
    __syncthreads();

    const int rows = min(kMatRows, C - c0);
    int32_t* dst = out + static_cast<size_t>(c0) * N + n0;
    if (vec)
      store_tile<int4>(sout, pitch, rows, nc, N, dst);
    else
      store_tile<int>(sout, pitch, rows, nc, N, dst);
    __syncthreads();  // sout (and skp, if the next tile restages) free again
  }
}

}  // namespace

// S streams of contiguous [S, C, 8], [S, N, 8], [S, N] inputs and [S, C]
// outputs; 1 <= S <= 65535.  One launch.
extern "C" int rgbdvo_hamming_nn(const void* cand, const void* kp, const void* kp_mask, int S,
                                 int C, int N, void* out_index, void* out_dist, void* stream) {
  if (S < 1 || S > 65535 || C < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = (N + 7) / 8 * 8;  // keypoints padded with masked columns to whole tiles
  const size_t smem = static_cast<size_t>(n_pad) * (2 * sizeof(uint4) + sizeof(int2)) +
                      kSplits * kNnRows * sizeof(int2);
  if (smem > 48 * 1024) {  // the opt-in is per device: made on every such launch
    cudaError_t err = cudaFuncSetAttribute(
        hamming_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (C == 0) return static_cast<int>(cudaGetLastError());
  const dim3 blocks((C + kNnRows - 1) / kNnRows, S);
  hamming_nn_kernel<<<blocks, kNnThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(kp),
      static_cast<const uint8_t*>(kp_mask), C, N, n_pad, static_cast<int32_t*>(out_index),
      static_cast<int32_t*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rgbdvo_hamming_matrix(const void* cand, const void* kp, int C, int N, void* out,
                                     void* stream) {
  if (C == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const int kc_pad = (min(N, kMatCols) + 7) / 8 * 8;  // keypoints of the widest chunk, whole tiles
  const int pitch = kc_pad + ((8 - kc_pad) & 31);  // = 8 (mod 32) words
  const size_t smem = static_cast<size_t>(kc_pad) * (2 * sizeof(uint4) + sizeof(int)) +
                      static_cast<size_t>(kMatRows) * pitch * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // per device, so made on every such launch
    err = cudaFuncSetAttribute(hamming_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_matrix_kernel,
                                                           kMatThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // every resident block the same number of tiles
  const long long tiles =
      static_cast<long long>((C + kMatRows - 1) / kMatRows) * ((N + kMatCols - 1) / kMatCols);
  const long long slots = static_cast<long long>(min(max(per_sm, 1), kMatBlocksPerSm)) * max(sms, 1);
  const long long per_block = (tiles + slots - 1) / slots;
  const int blocks = static_cast<int>((tiles + per_block - 1) / per_block);
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  hamming_matrix_kernel<<<blocks, kMatThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(kp), C, N, kc_pad, pitch,
      vec, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgbdvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
