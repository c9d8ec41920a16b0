// Deterministic per-channel column sums over a contiguous channels-last
// [M, C] view, shared by the reduction kernels of conv_epilogue.cu
// (epilogue backward, channel statistics) and bn_train.cu (BN backward
// sums).
//
// The TPU kernels carry their [2, C] accumulator in VMEM from one
// sequential grid step to the next. Blocks on Hopper run in parallel and
// in no order, so the sum is split in two launches instead:
//
//   1. column_partials_kernel: grid (row chunks, channel tiles). A thread
//      owns VEC neighbouring channels (one 16-byte vector where C and the
//      pointers allow it) and strides the rows of its chunk, so a warp's
//      loads are neighbouring addresses along C. The block's threads that
//      share channels are summed by a fixed tree in shared memory, and
//      the chunk's two sums per channel go to a [chunks, 2, C] f32
//      workspace that the caller allocates.
//   2. column_finalize_kernel: sums the chunks of each channel in a fixed
//      order into the [2, C] output.
//
// No float atomics: the order of every addition depends only on (M, C,
// the vector width), so two launches on the same input give the same
// bits. Accumulation is f32 for every input type, with each product and
// sum rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction), as
// the plain PyTorch versions round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {

constexpr int kReduceThreads = 256;
// at most one warp across the channels (512 contiguous bytes of a row);
// the block's other threads take further rows, so a block keeps row
// parallelism at wide C
constexpr int kMaxChannelThreads = 32;
// enough blocks for about eight waves on the H100's 132 SMs
constexpr int64_t kTargetBlocks = 132 * 8;
// a chunk holds at least 128 bytes of each channel it sums (32 f32 or
// 64 bf16/f16 rows), so the f32 partials it writes, 8 bytes a channel,
// are at most 1/16 of the input it reads, and at least kMinRowsPerThread
// rows for each row thread, so the loads outweigh the block's tree
constexpr int kMinChunkBytes = 128;
constexpr int kMinRowsPerThread = 8;

// ---------------------------------------------------------------------------
// element loads and stores (f32 arithmetic for every storage type)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// VEC elements starting at p: one 16-byte access when VEC * sizeof(T) is
// 16 (the caller guarantees alignment), else scalar accesses.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f(p[v]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) from_f(e + v, in[v]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) from_f(p + v, in[v]);
  }
}

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------
struct ColumnGeom {
  int vec;             // channels per thread
  int bx, by;          // block: channel x row threads (powers of 2)
  int64_t ctiles;      // grid.y
  int64_t chunks;      // grid.x
  int64_t chunk_rows;  // rows per chunk (the last chunk may hold fewer)
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The chunking depends on (M, C, element size) only, so the caller can
// size the workspace before it knows the pointers; `vec` drops to 1 when
// a pointer is not 16-byte aligned, which changes the block shape but
// not the chunks.
inline ColumnGeom column_geom(int64_t M, int64_t C, int elem_bytes,
                              bool aligned) {
  const int full = 16 / elem_bytes;
  const int nominal = (C % full == 0) ? full : 1;
  ColumnGeom g;
  int64_t cv = C / nominal;
  int bx = 1;
  while (bx < cv && bx < kMaxChannelThreads) bx <<= 1;
  const int by = kReduceThreads / bx;
  const int64_t ctiles = (cv + bx - 1) / bx;
  int64_t min_rows = kMinChunkBytes / elem_bytes;
  if (min_rows < (int64_t)kMinRowsPerThread * by)
    min_rows = (int64_t)kMinRowsPerThread * by;
  int64_t max_chunks = (M + min_rows - 1) / min_rows;
  if (max_chunks < 1) max_chunks = 1;
  int64_t chunks = (kTargetBlocks + ctiles - 1) / ctiles;
  if (chunks > max_chunks) chunks = max_chunks;
  g.chunk_rows = (M + chunks - 1) / chunks;
  if (g.chunk_rows < 1) g.chunk_rows = 1;
  g.chunks = (M + g.chunk_rows - 1) / g.chunk_rows;
  if (g.chunks < 1) g.chunks = 1;
  // the launch shape follows the vector width actually used
  g.vec = aligned ? nominal : 1;
  cv = C / g.vec;
  bx = 1;
  while (bx < cv && bx < kMaxChannelThreads) bx <<= 1;
  g.bx = bx;
  g.by = kReduceThreads / bx;
  g.ctiles = (cv + bx - 1) / bx;
  return g;
}

// ---------------------------------------------------------------------------
// pass 1: per-chunk partial sums
// ---------------------------------------------------------------------------
// Op supplies, for one row r and the VEC channels from c0:
//   __device__ void row(int64_t r, int64_t c0, float (&s0)[VEC],
//                       float (&s1)[VEC]) const;
// adding its two terms per channel into s0 and s1 (and writing any
// elementwise output of the same pass), and
//   __device__ void begin(int64_t c0);
// called once per thread, on the thread's own copy of the Op, before the
// row loop (per-channel coefficients into registers).
template <int VEC, class Op>
__global__ void __launch_bounds__(kReduceThreads)
column_partials_kernel(const Op op, float* __restrict__ partials,
                       int64_t M, int64_t C, int64_t chunk_rows) {
  __shared__ float sh[kReduceThreads * 2 * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int64_t c0 = ((int64_t)blockIdx.y * bx + tx) * VEC;
  const int64_t r0 = (int64_t)blockIdx.x * chunk_rows;
  int64_t r1 = r0 + chunk_rows;
  if (r1 > M) r1 = M;
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s0[v] = s1[v] = 0.f;
  if (c0 < C) {
    Op mine_op = op;
    mine_op.begin(c0);
    // unrolled, so a thread has several independent loads in flight
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += by) mine_op.row(r, c0, s0, s1);
  }
  // slot-major: slot k of thread t at sh[k * kReduceThreads + t], so a
  // warp's threads touch neighbouring words (no bank conflicts)
  const int t = ty * bx + tx;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    sh[v * kReduceThreads + t] = s0[v];
    sh[(VEC + v) * kReduceThreads + t] = s1[v];
  }
  __syncthreads();
  for (int s = by / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < 2 * VEC; ++k)
        sh[k * kReduceThreads + t] = __fadd_rn(
            sh[k * kReduceThreads + t], sh[k * kReduceThreads + t + s * bx]);
    }
    __syncthreads();
  }
  if (ty == 0 && c0 < C) {
    float* out = partials + (int64_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      out[c0 + v] = sh[v * kReduceThreads + t];
      out[C + c0 + v] = sh[(VEC + v) * kReduceThreads + t];
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: chunks -> [2, C], in a fixed order
// ---------------------------------------------------------------------------
constexpr int kFinalizeX = 32;   // channels per block
constexpr int kFinalizeY = 32;   // chunk strides per channel

__global__ void __launch_bounds__(kFinalizeX * kFinalizeY)
column_finalize_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int64_t chunks,
                       int64_t two_c) {
  __shared__ float sh[kFinalizeY][kFinalizeX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kFinalizeX + tx;  // k * C + c
  float s = 0.f;
  if (i < two_c) {
    for (int64_t ch = ty; ch < chunks; ch += kFinalizeY)
      s = __fadd_rn(s, partials[ch * two_c + i]);
  }
  sh[ty][tx] = s;
  __syncthreads();
  for (int st = kFinalizeY / 2; st > 0; st >>= 1) {
    if (ty < st) sh[ty][tx] = __fadd_rn(sh[ty][tx], sh[ty + st][tx]);
    __syncthreads();
  }
  if (ty == 0 && i < two_c) out[i] = sh[0][tx];
}

// Launches both passes on `stream`; returns the cudaError_t (0 on
// success). `partials` holds at least geom.chunks * 2 * C floats.
template <int VEC, class Op>
int launch_column_sums(const Op& op, const ColumnGeom& g, float* partials,
                       float* out, int64_t M, int64_t C,
                       cudaStream_t stream) {
  dim3 block(g.bx, g.by);
  dim3 grid((unsigned)g.chunks, (unsigned)g.ctiles);
  column_partials_kernel<VEC, Op><<<grid, block, 0, stream>>>(
      op, partials, M, C, g.chunk_rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t two_c = 2 * C;
  dim3 fblock(kFinalizeX, kFinalizeY);
  const unsigned fgrid = (unsigned)((two_c + kFinalizeX - 1) / kFinalizeX);
  column_finalize_kernel<<<fgrid, fblock, 0, stream>>>(partials, out,
                                                       g.chunks, two_c);
  return (int)cudaGetLastError();
}

}  // namespace dl4j
