// matmul_bias_act: y[M, N] = act(x[M, K] . W[N, K]^T + b[N]), the
// lowering of a pointwise (1x1, stride 1) convolution over a contiguous
// channels-last [M, C_in] view of its input, with the OIHW weight read as
// [C_out, C_in]. Both operands are K-contiguous.
//
// Replaces deeplearning4j_tpu/ops/conv_pallas.py:_matmul_epilogue_kernel
// (launched by _matmul_epilogue's pl.pallas_call; the forward of
// matmul_bias_act). On SqueezeNet it is every fire module's squeeze and
// expand-1x1 convolution and the 1x1 classifier: 17 sites a forward.
//
// Arithmetic: f32 accumulation for f32, bf16 and f16 inputs, in the JAX
// kernel's order: dot (f32 accumulation over k) -> a rounded add of the
// bias -> relu as `y < 0 ? 0 : y` (NaN passes through, as jnp.maximum) ->
// one cast to x's dtype (round to nearest even) and one store. There is
// no split-K: each output is summed in a fixed k order by one thread (or
// one tensor-core tile) and written once, so the result is bitwise
// repeatable across launches.
//
// Bound: at SqueezeNet's batch-32 shapes every 16-bit site but the 1x1
// classifier (K = 512, N = 1000) is bound by bytes (x read once, y
// written once); in f32 the classifier and the wide-K squeeze sites are
// bound by operations (67 TFLOP/s of f32 FMA), the rest by bytes.
// dl4j_matmul_bias_act picks one of three bodies by dtype, shape and
// alignment (plan_for; dl4j_matmul_bias_act_describe names the choice):
//
//   * bf16 / f16, K % 8 == 0, N % 8 == 0, x, W and y 16-byte aligned
//     (every SqueezeNet site): mba_wgmma_kernel, a persistent,
//     warp-specialised Hopper GEMM. One producer warp starts TMA loads
//     (cp.async.bulk.tensor.2d) of x's and W's k slices into a ring of
//     stages guarded by mbarriers (full: bytes landed; empty: the
//     slice's wgmma retired). TMA's cost follows the box rows it fetches
//     more than their bytes, so the design fetches few rows: a slice is
//     16, 32 or 64 wide with the swizzle of its row (32, 64 or 128
//     bytes), K = 16 and 32 taking one slice of their own width (a
//     64-wide box past K measured slower) and K = 48 one 64-wide slice
//     zero-filled past K; and where every tile has the same n tile (N <=
//     BN) and W's slices fit in 64 KB, they are loaded once and stay
//     resident for the block's life, so only x streams. The ring holds
//     about 80 KB of slices in flight an SM (up to 32 stages; deeper
//     rings measured slower). Two consumer warpgroups run wgmma.mma_async m64nBNk16 on the
//     swizzled slices with f32 accumulators in registers, keeping one
//     slice's products in flight while the next slice's are started.
//     They take alternate output tiles of 64 rows ("ping-pong": an
//     mbarrier pair makes their products take turns, so each consumes
//     the ring in order, and one's epilogue overlaps the other's
//     products), except where N > 256 over K >= 256 (the classifier):
//     there both share 128 x 128 tiles ("cooperative"), which reads W's
//     slices from L2 half as often a row as 64 x 256 tiles did (the
//     classifier at 64 x 256 was bound by that L2 traffic). Blocks walk
//     the tiles in a static order (tile = blockIdx.x + i * gridDim.x,
//     the n tiles of one row tile adjacent, so x's rows come from device
//     memory once). The tile's width BN follows N (16, 32, 48, 64, 128,
//     192 or 256, zero-filled past N); 256-wide tiles that would leave
//     SMs idle are split in two, and 64-row tiles give the few-row
//     sites enough tiles ([6272, 512] x [64]: 98 tiles; no split-K).
//     The epilogue adds the bias, applies relu and casts in the
//     accumulator registers, stages the tile in shared memory and writes
//     it in 16-byte row chunks. The tensor maps are encoded on the host
//     for every launch (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, no link flag): dl4j_matmul_tensor_map_ns
//     measures that at 0.12-0.17 us of host time a launch on an H100
//     host (chip_smoke.py's pointwise phase prints it), so nothing is
//     cached.
//   * bf16 / f16 otherwise (K % 8 != 0, N % 8 != 0, a misaligned
//     pointer): mba_mma_kernel, the first design: mma.sync m16n8k16 with
//     f32 accumulation; 32-wide k slices through a two-stage cp.async
//     ring where K % 8 == 0 and x and W are aligned, element by element
//     otherwise; the output tile staged in shared memory.
//   * f32: mba_f32_kernel, SIMT FMAs in full f32 (no TF32). 32-wide k
//     slices of x and W go to shared memory as they lie (K-contiguous
//     rows padded to 36 floats) through a three-stage cp.async ring of
//     16-byte copies with a zero fill for the ragged edges (element by
//     element where K % 4 != 0 or a pointer is misaligned). A thread
//     owns TM rows and TN columns, strided so that a quarter-warp's
//     16-byte shared reads hit eight neighbouring rows (distinct banks),
//     and reads four k steps of each at a time. 8 x 8 thread tiles over
//     128 x 128 where K > 64 (the classifier), 8 x 6 over 128 x 96 for N
//     = 192 and 4 x 6 over 64 x 48 for N = 48 (no idle columns); where K
//     <= 64 the sites are bound by their stores and take 64-row tiles,
//     so more blocks share an SM and overlap them. The output tile is
//     staged in the ring's shared memory and leaves in 16-byte rows. An
//     8 x 8 tile reads 16 floats of shared memory a thread for 64 FMAs a
//     k step; at 16 bytes a read the shared-memory pipe and the FMA pipe
//     then take about as long, which holds the classifier near half the
//     FMA rate.
//
// Left for later: keeping W's slice resident in shared memory for a
// block's life, a TMA store of the output tile, a split over the
// classifier's K (or a thread-block cluster multicasting W's slices) for
// its last partial wave, and larger f32 thread tiles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>
#include <chrono>
#include <type_traits>

#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"

namespace {

__device__ __forceinline__ float epilogue(float acc, float b, bool relu) {
  float y = __fadd_rn(acc, b);
  if (relu) y = y < 0.f ? 0.f : y;
  return y;
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Raise a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ===========================================================================
// f32: SIMT FMAs over a three-stage cp.async ring
// ===========================================================================
constexpr int kF32BK = 32;            // k per stage
constexpr int kF32Row = kF32BK + 4;   // 144-byte rows: 9 16-byte units
constexpr int kF32Stages = 3;

template <int BM, int BN, int TM, int TN>
struct F32Cfg {
  static constexpr int kColThreads = BN / TN;
  static constexpr int kRowThreads = BM / TM;
  static constexpr int kThreads = kColThreads * kRowThreads;
  static constexpr int kStageFloats = (BM + BN) * kF32Row;
  static constexpr int kSmem = kF32Stages * kStageFloats * 4;
};

// One [ROWS, kF32BK] k slice of a K-contiguous [rows, K] operand into
// dst[ROWS][kF32Row]: 16-byte cp.async chunks with a zero fill past
// `rows` and K (VEC: K % 4 == 0 and an aligned base), else element by
// element.
template <int ROWS, int THREADS, bool VEC>
__device__ __forceinline__ void f32_slice(float* dst,
                                          const float* __restrict__ src,
                                          int64_t rows, int64_t K,
                                          int64_t r0, int64_t k0, int tid) {
  if constexpr (VEC) {
    constexpr int kChunks = ROWS * (kF32BK / 4);
    for (int c = tid; c < kChunks; c += THREADS) {
      const int r = c / (kF32BK / 4);
      const int kc = (c % (kF32BK / 4)) * 4;
      const bool valid = (r0 + r < rows) && (k0 + kc < K);
      const float* p = valid ? src + (r0 + r) * K + k0 + kc : src;
      cp_async16(dst + r * kF32Row + kc, p, valid);
    }
  } else {
    for (int e = tid; e < ROWS * kF32BK; e += THREADS) {
      const int r = e / kF32BK;
      const int k = e % kF32BK;
      dst[r * kF32Row + k] = (r0 + r < rows && k0 + k < K)
                                 ? __ldg(src + (r0 + r) * K + k0 + k)
                                 : 0.f;
    }
  }
}

// Tile BM x BN; thread (ty, tx) owns rows ty + i * BM / TM and columns
// tx + j * BN / TN. A quarter-warp's 16-byte reads of W's slice are 8
// neighbouring rows (144-byte stride: 8 distinct 16-byte bank groups)
// and of x's slice one or two rows (a broadcast).
template <int BM, int BN, int TM, int TN, bool RELU, bool VEC>
__global__ void __launch_bounds__(F32Cfg<BM, BN, TM, TN>::kThreads)
mba_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y,
               int64_t M, int64_t N, int64_t K) {
  using Cfg = F32Cfg<BM, BN, TM, TN>;
  constexpr int kThreads = Cfg::kThreads;
  extern __shared__ __align__(16) float f32_smem[];

  const int tid = threadIdx.x;
  const int tx = tid % Cfg::kColThreads;
  const int ty = tid / Cfg::kColThreads;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto stage_a = [&](int s) { return f32_smem + s * Cfg::kStageFloats; };
  auto stage_b = [&](int s) {
    return f32_smem + s * Cfg::kStageFloats + BM * kF32Row;
  };
  auto load = [&](int s, int64_t t) {
    f32_slice<BM, kThreads, VEC>(stage_a(s), x, M, K, m0, t * kF32BK, tid);
    f32_slice<BN, kThreads, VEC>(stage_b(s), w, N, K, n0, t * kF32BK, tid);
  };

  const int64_t tiles = (K + kF32BK - 1) / kF32BK;
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  for (int64_t t = 0; t < tiles; ++t) {
    cp_async_wait<kF32Stages - 2>();  // slice t has landed
    __syncthreads();                  // ... for every thread; t - 1 done
    if (t + kF32Stages - 1 < tiles)
      load((int)((t + kF32Stages - 1) % kF32Stages), t + kF32Stages - 1);
    cp_async_commit();
    const float* As = stage_a((int)(t % kF32Stages));
    const float* Bs = stage_b((int)(t % kF32Stages));
    auto fma_k4 = [&](int k4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            As + (ty + i * Cfg::kRowThreads) * kF32Row + k4);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            Bs + (tx + j * Cfg::kColThreads) * kF32Row + k4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    };
    const int64_t kv = K - t * kF32BK;
    if (kv >= kF32BK) {
#pragma unroll
      for (int k4 = 0; k4 < kF32BK; k4 += 4) fma_k4(k4);
    } else {  // the last slice's zero-filled k steps add exact zeros
      for (int k4 = 0; k4 < kv; k4 += 4) fma_k4(k4);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  // epilogue: + bias, relu into the shared output tile, then the tile
  // goes out in 16-byte row chunks (one store per output)
  constexpr int kOutRow = BN + 4;
  static_assert(BM * kOutRow <= kF32Stages * Cfg::kStageFloats,
                "the output tile fits the ring");
  float* out = f32_smem;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + j * Cfg::kColThreads;
    const float bv = n0 + c < N ? __ldg(bias + n0 + c) : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      out[(ty + i * Cfg::kRowThreads) * kOutRow + c] =
          epilogue(acc[i][j], bv, RELU);
  }
  __syncthreads();
  constexpr int kChunks = BN / 4;
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  for (int c = tid; c < BM * kChunks; c += kThreads) {
    const int rl = c / kChunks;
    const int cl = (c % kChunks) * 4;
    const int64_t m = m0 + rl;
    const int64_t n = n0 + cl;
    if (m >= M || n >= N) continue;
    const float* src = out + rl * kOutRow + cl;
    if (vec) {
      *reinterpret_cast<float4*>(y + m * N + n) =
          *reinterpret_cast<const float4*>(src);
    } else {
      for (int q = 0; q < 4 && n + q < N; ++q) y[m * N + n + q] = src[q];
    }
  }
}

template <int BM, int BN, int TM, int TN, bool RELU, bool VEC>
int launch_f32_cfg(const float* x, const float* w, const float* b,
                   float* y, int64_t M, int64_t N, int64_t K,
                   cudaStream_t stream) {
  using Cfg = F32Cfg<BM, BN, TM, TN>;
  static std::atomic<uint32_t> done{0};
  auto kernel = mba_f32_kernel<BM, BN, TM, TN, RELU, VEC>;
  const cudaError_t err = allow_smem(kernel, Cfg::kSmem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((N + BN - 1) / BN));
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(x, w, b, y, M, N, K);
  return 0;
}

// ===========================================================================
// bf16 / f16 fallback: mma.sync m16n8k16, f32 accumulation
// ===========================================================================
constexpr int kMmaBK = 32;       // k per shared slice: two m16n8k16 steps
constexpr int kRow = kMmaBK + 8;  // padded row: ldmatrix rows hit distinct banks

// cp_async16, ldmatrix_x4, mma_16816 and store2: mma_sm80.cuh

// Copy one [ROWS, kMmaBK] k slice of a K-contiguous [rows, K] operand into
// dst[ROWS][kRow]. VEC: 16-byte cp.async chunks (K % 8 == 0, aligned
// base), zero-filled past `rows` and K; else element by element.
template <typename T, int ROWS, int THREADS, bool VEC>
__device__ __forceinline__ void load_slice(T (*dst)[kRow],
                                           const T* __restrict__ src,
                                           int64_t rows, int64_t K,
                                           int64_t r0, int64_t k0, int tid) {
  if constexpr (VEC) {
    constexpr int kChunks = ROWS * (kMmaBK / 8);
#pragma unroll
    for (int c = tid; c < kChunks; c += THREADS) {
      const int r = c / (kMmaBK / 8);
      const int kc = (c % (kMmaBK / 8)) * 8;
      const bool valid = (r0 + r < rows) && (k0 + kc < K);
      const T* p = valid ? src + (r0 + r) * K + k0 + kc : src;
      cp_async16(&dst[r][kc], p, valid);
    }
  } else {
    for (int e = tid; e < ROWS * kMmaBK; e += THREADS) {
      const int r = e / kMmaBK;
      const int k = e % kMmaBK;
      dst[r][k] = (r0 + r < rows && k0 + k < K) ? src[(r0 + r) * K + k0 + k]
                                                : T(0.f);
    }
  }
}

// Block tile BM x BN; warp tile WM x WN (MI x NI mma tiles of 16 x 8).
template <typename T, int BM, int BN, int WM, int WN, bool RELU, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
mba_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y, int64_t M,
               int64_t N, int64_t K) {
  constexpr int kWarpsN = BN / WN;
  constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  // the k slices (two stages), then the same bytes as the output tile
  constexpr int kOutRow = BN + 8;  // 16-byte rows, ldmatrix-style padding
  constexpr int kSliceBytes = 2 * (BM + BN) * kRow * (int)sizeof(T);
  constexpr int kOutBytes = BM * kOutRow * (int)sizeof(T);
  __shared__ __align__(16)
      unsigned char smem[kSliceBytes > kOutBytes ? kSliceBytes : kOutBytes];
  T(*As)[BM][kRow] = reinterpret_cast<T(*)[BM][kRow]>(smem);
  T(*Bs)[BN][kRow] =
      reinterpret_cast<T(*)[BN][kRow]>(smem + 2 * BM * kRow * sizeof(T));
  T(*Out)[kOutRow] = reinterpret_cast<T(*)[kOutRow]>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int64_t tiles = (K + kMmaBK - 1) / kMmaBK;
  if (VEC && tiles > 0) {
    load_slice<T, BM, kThreads, VEC>(As[0], x, M, K, m0, 0, tid);
    load_slice<T, BN, kThreads, VEC>(Bs[0], w, N, K, n0, 0, tid);
    cp_async_commit();
  }
  for (int64_t t = 0; t < tiles; ++t) {
    const int s = VEC ? (int)(t & 1) : 0;
    if constexpr (VEC) {
      if (t + 1 < tiles) {  // the next slice lands during this one's mma
        load_slice<T, BM, kThreads, VEC>(As[s ^ 1], x, M, K, m0,
                                         (t + 1) * kMmaBK, tid);
        load_slice<T, BN, kThreads, VEC>(Bs[s ^ 1], w, N, K, n0,
                                         (t + 1) * kMmaBK, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_slice<T, BM, kThreads, VEC>(As[0], x, M, K, m0, t * kMmaBK, tid);
      load_slice<T, BN, kThreads, VEC>(Bs[0], w, N, K, n0, t * kMmaBK, tid);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], &As[s][wm * WM + i * 16 + lane % 16]
                                [kk + (lane / 16) * 8]);
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[s][wn * WN + j * 8 + lane % 8 + (lane / 16) * 8]
                          [kk + ((lane / 8) % 2) * 8]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_16816(acc[i][j], a[i], b[j][0], b[j][1], T());
    }
    __syncthreads();
  }

  // epilogue: + bias, relu and one cast per output into the shared output
  // tile (an mma tile's accumulator holds rows lane/4 and lane/4 + 8,
  // columns 2 * (lane % 4) and the next one), then the tile goes out in
  // 16-byte row chunks: one store per output, whole rows per warp.
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int cl = wn * WN + j * 8 + (lane % 4) * 2;
    const int64_t n = n0 + cl;
    const float b0 = n < N ? __ldg(bias + n) : 0.f;
    const float b1 = n + 1 < N ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(&Out[wm * WM + i * 16 + lane / 4 + h * 8][cl],
               epilogue(acc[i][j][2 * h], b0, RELU),
               epilogue(acc[i][j][2 * h + 1], b1, RELU));
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;
  const bool vec_ok =
      (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(y) % 16) == 0);
  for (int c = tid; c < BM * kChunks; c += kThreads) {
    const int rl = c / kChunks;
    const int cl = (c % kChunks) * 8;
    const int64_t m = m0 + rl;
    const int64_t n = n0 + cl;
    if (m >= M || n >= N) continue;
    T* p = y + m * N + n;
    if (vec_ok && n + 7 < N) {
      *reinterpret_cast<uint4*>(p) =
          *reinterpret_cast<const uint4*>(&Out[rl][cl]);
    } else {
      for (int q = 0; q < 8 && n + q < N; ++q) p[q] = Out[rl][cl + q];
    }
  }
}

template <typename T, int BM, int BN, int WM, int WN, bool RELU, bool VEC>
int launch_mma(const T* x, const T* w, const float* b, T* y, int64_t M,
               int64_t N, int64_t K, cudaStream_t stream) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((N + BN - 1) / BN));
  mba_mma_kernel<T, BM, BN, WM, WN, RELU, VEC>
      <<<grid, kThreads, 0, stream>>>(x, w, b, y, M, N, K);
  return 0;
}

// ===========================================================================
// bf16 / f16 on Hopper: TMA + wgmma, persistent and warp-specialised
// ===========================================================================
constexpr int kWgBM = 64;          // rows a consumer warpgroup owns
constexpr int kWgConsumers = 2;    // consumer warpgroups
constexpr int kWgThreads = kWgConsumers * 128 + 32;  // + the producer warp
// the ring: about 80 KB of small slices in flight an SM (up to 32
// stages: 2 KB slices of x at K = 16); deeper rings measured slower
// (the loads then queue in L2 and device memory), larger slices as many
// stages as fit
constexpr int kWgMaxStages = 32;
constexpr int kWgInFlight = 80 * 1024;
constexpr int kWgSmemBudget = 200 * 1024;
constexpr int kWgMaxResident = 64 * 1024;  // W's slices kept for a block
// the barriers (full and empty for every stage, order, W resident), at a
// fixed place after the ring and the output tiles
constexpr int kWgBarriers = 2 * kWgMaxStages + kWgConsumers + 1;
constexpr int kWgSmemMax = 1024 + kWgSmemBudget + kWgBarriers * 8;

constexpr int round1k(int b) { return (b + 1023) / 1024 * 1024; }

// BK: k of a stage, 16, 32 or 64, one swizzled row of 32, 64 or 128
// bytes (the widest that divides K, so the box never runs past K).
// COOP: both consumers share a 128-row tile (and W's slice) instead of
// taking alternate 64-row tiles.
template <int BN, int BK, bool COOP>
struct WgCfg {
  static constexpr int kBM = COOP ? 2 * kWgBM : kWgBM;  // rows of a tile
  static constexpr int kABox = kBM * BK * 2;     // bytes TMA brings
  static constexpr int kBBox = BN * BK * 2;
  static constexpr int kABytes = round1k(kABox);  // slots 1024-aligned
  static constexpr int kBBytes = round1k(kBBox);
  static constexpr int kOutRow = BN + 8;  // padded: conflict-free stores
  static constexpr int kOutBytes = kWgBM * kOutRow * 2;
};

// The shared memory of one launch, in order: W's slices where they stay
// resident (every tile of the launch has the same n tile and they fit),
// the ring of stages (x's slice, and W's where it streams), the
// consumers' output tiles, the barriers.
struct WgRing {
  int wres_bytes;   // 0: W's slices stream through the ring
  int stage_bytes;
  int stages;
  int smem;         // dynamic shared memory used
};

template <int BN, int BK, bool COOP>
WgRing wg_ring(int64_t N, int64_t K) {
  using Cfg = WgCfg<BN, BK, COOP>;
  const int64_t wres = ((K + BK - 1) / BK) * Cfg::kBBytes;
  const int room = kWgSmemBudget - kWgConsumers * Cfg::kOutBytes;
  WgRing r;
  r.wres_bytes = N <= BN && wres <= kWgMaxResident &&
                         room - wres >= 2 * Cfg::kABytes
                     ? (int)wres
                     : 0;
  r.stage_bytes = Cfg::kABytes + (r.wres_bytes ? 0 : Cfg::kBBytes);
  int fit = (room - r.wres_bytes) / r.stage_bytes;
  if (fit > kWgMaxStages) fit = kWgMaxStages;
  const int want = (kWgInFlight + r.stage_bytes - 1) / r.stage_bytes;
  r.stages = r.stage_bytes >= 16 * 1024 || want > fit ? fit
             : want < 4                                ? 4
                                                       : want;
  r.smem = 1024 + r.wres_bytes + r.stages * r.stage_bytes +
           kWgConsumers * Cfg::kOutBytes + kWgBarriers * 8;
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// A K-major operand tile of BK * 2-byte rows written by TMA with the
// swizzle of the same width: layout 1, 2 or 3 (128-, 64- or 32-byte
// swizzle), 8-row groups 8 rows apart (SBO), LBO unused (1). The tile
// starts 1024-byte aligned; a k16 step within a row advances the start
// address by 32 bytes.
template <int BK>
__device__ __forceinline__ uint64_t swizzled_desc(const void* p) {
  constexpr uint64_t kLayout = BK == 64 ? 1 : BK == 32 ? 2 : 3;
  constexpr uint64_t kSbo = 8 * BK * 2;
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((kSbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int BN, int BK, bool COOP>
__global__ void __launch_bounds__(kWgThreads, 1)
mba_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 const float* __restrict__ bias, T* __restrict__ y, int M,
                 int N, int K, int relu, WgRing ring) {
  using Cfg = WgCfg<BN, BK, COOP>;
  constexpr int BM = Cfg::kBM;
  const int S = ring.stages;
  const bool wres = ring.wres_bytes != 0;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  unsigned char* base = wg_smem + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* stages = base + ring.wres_bytes;
  T* outs = reinterpret_cast<T*>(stages + S * ring.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stages + S * ring.stage_bytes + kWgConsumers * Cfg::kOutBytes);
  uint64_t* empty = full + kWgMaxStages;
  // order[w]: the other warpgroup has finished the products of the tile
  // before warpgroup w's next one. The two take the ring's slices in
  // turns, so no warpgroup waits on a slot more than one phase ahead of
  // it (a parity wait cannot tell phases two apart).
  uint64_t* order = empty + kWgMaxStages;
  uint64_t* w_full = order + kWgConsumers;  // W's resident slices landed

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int kt = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], COOP ? kWgConsumers : 1);
    }
    for (int w = 0; w < kWgConsumers; ++w) mbar_init(&order[w], 1);
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers * 4) {
    // ---- producer: one thread keeps the ring full, across tiles ----
    if (threadIdx.x % 32 == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tmw))
                   : "memory");
      if (wres) {  // W's slices once, for the block's life
        mbar_expect_tx(w_full, kt * Cfg::kBBox);
        for (int k = 0; k < kt; ++k)
          tma_load_2d(base + k * Cfg::kBBytes, &tmw, k * BK, 0, w_full);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BM;
        const int n0 = (t % n_tiles) * BN;
        for (int k = 0; k < kt; ++k) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], Cfg::kABox + (wres ? 0 : Cfg::kBBox));
          unsigned char* st = stages + s * ring.stage_bytes;
          tma_load_2d(st, &tmx, k * BK, m0, &full[s]);
          if (!wres)
            tma_load_2d(st + Cfg::kABytes, &tmw, k * BK, n0, &full[s]);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: ping-pong, warpgroup wg takes this block's tiles wg,
  // wg + 2, ...; cooperative, both take every tile, wg its 64 rows
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  T* out = outs + wg * (kWgBM * Cfg::kOutRow);
  float acc[BN / 2];
  if (wres) mbar_wait(w_full, 0);
  constexpr int kStep = COOP ? 1 : kWgConsumers;
  const int j0 = COOP ? 0 : wg;
  for (int j = j0, t = blockIdx.x + j0 * gridDim.x; t < tiles;
       j += kStep, t += kStep * gridDim.x) {
    const int m0 = (t / n_tiles) * BM + (COOP ? wg * kWgBM : 0);
    const int n0 = (t % n_tiles) * BN;
    // this tile's first slice is the ring's (j * kt)-th
    const long long c0 = (long long)j * kt;
    int s = (int)(c0 % S);
    uint32_t phase = (uint32_t)((c0 / S) & 1);
    int prev = -1;
    if (!COOP && j > 0)
      mbar_wait(&order[wg], (uint32_t)((j - 1) / 2) & 1u);
    for (int k = 0; k < kt; ++k) {
      mbar_wait(&full[s], phase);
      const unsigned char* st = stages + s * ring.stage_bytes;
      const uint64_t da =
          swizzled_desc<BK>(st + (COOP ? wg * kWgBM * BK * 2 : 0));
      const uint64_t db = swizzled_desc<BK>(
          wres ? base + k * Cfg::kBBytes : st + Cfg::kABytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64k16<BN, T>(acc, da + 2 * kk, db + 2 * kk,
                            (k | kk) != 0 ? 1u : 0u);
      wgmma_commit();
      fence_acc(acc);
      if (prev >= 0) {  // the previous slice's products have retired
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tid == 0) {
      mbar_arrive(&empty[prev]);
      if (!COOP) mbar_arrive(&order[wg ^ 1]);  // the other's turn
    }

    // epilogue: + bias, relu, one cast, into this warpgroup's staging
    // tile (after its previous tile has left), then 16-byte row chunks
    named_sync(1 + wg, 128);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int cl = q * 8 + (lane % 4) * 2;
      const int n = n0 + cl;
      const float b0 = n < N ? __ldg(bias + n) : 0.f;
      const float b1 = n + 1 < N ? __ldg(bias + n + 1) : 0.f;
      store2(out + row * Cfg::kOutRow + cl, epilogue(acc[4 * q], b0, relu),
             epilogue(acc[4 * q + 1], b1, relu));
      store2(out + (row + 8) * Cfg::kOutRow + cl,
             epilogue(acc[4 * q + 2], b0, relu),
             epilogue(acc[4 * q + 3], b1, relu));
    }
    named_sync(1 + wg, 128);
    constexpr int kChunks = BN / 8;
    for (int c = tid; c < kWgBM * kChunks; c += 128) {
      const int rl = c / kChunks;
      const int cl = (c % kChunks) * 8;
      const int m = m0 + rl;
      const int n = n0 + cl;
      if (m < M && n < N)  // N % 8 == 0: a chunk is whole or outside
        *reinterpret_cast<uint4*>(y + (int64_t)m * N + n) =
            *reinterpret_cast<const uint4*>(out + rl * Cfg::kOutRow + cl);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A [rows, K] K-contiguous 16-bit operand as a 2-D tensor map whose box
// is [box_rows, bk] with the swizzle of bk * 2 bytes; out-of-range rows
// and k read as zeros.
template <typename T>
int encode_operand(CUtensorMap* map, const T* p, int64_t rows, int64_t K,
                   int box_rows, int bk) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 2 &&
                                         std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r =
      fn(map, dt, 2, const_cast<T*>(p), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         bk == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
         : bk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int BN, int BK, bool COOP>
int launch_wgmma(bool relu, const T* x, const T* w, const float* b, T* y,
                 int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
  using Cfg = WgCfg<BN, BK, COOP>;
  static std::atomic<uint32_t> done{0};
  auto kernel = mba_wgmma_kernel<T, BN, BK, COOP>;
  cudaError_t err = allow_smem(kernel, kWgSmemMax, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx, tmw;
  int rc = encode_operand<T>(&tmx, x, M, K, Cfg::kBM, BK);
  if (rc == 0) rc = encode_operand<T>(&tmw, w, N, K, BN, BK);
  if (rc != 0) return rc;
  const int64_t tiles = ((M + Cfg::kBM - 1) / Cfg::kBM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  const WgRing ring = wg_ring<BN, BK, COOP>(N, K);
  kernel<<<grid, kWgThreads, ring.smem, stream>>>(
      tmx, tmw, b, y, (int)M, (int)N, (int)K, relu ? 1 : 0, ring);
  return 0;
}

// ===========================================================================
// the plan: which body, which tile
// ===========================================================================
enum Body { kF32Async, kF32Scalar, kWgmma, kMmaAsync, kMmaScalar };

struct Plan {
  Body body;
  int bm, bn, tm, tn;  // tile, and a thread's (f32) share of it
  int bk;              // k of a stage
  bool coop;           // wgmma: both consumers on one tile
  bool wres;           // wgmma: W's slices resident for the block's life
  int stages;          // ring depth
  int64_t blocks;      // grid size
};

int wgmma_width(int64_t N) {
  if (N <= 16) return 16;
  if (N <= 32) return 32;
  if (N <= 48) return 48;
  if (N <= 64) return 64;
  if (N <= 128) return 128;
  if (N <= 192) return 192;
  return 256;
}

// The k slice: fewest slices a tile (each box row is one TMA request,
// whatever its width), so K = 16 and 32 take one slice of their own width
// and K = 48 one 64-wide slice that TMA zero-fills past K; past 64, the
// widest row that divides K (64 where none does: zero-filled again).
int wgmma_bk(int64_t K) {
  if (K == 16 || K == 32) return (int)K;
  if (K < 64 || K % 64 == 0) return 64;
  if (K % 32 == 0) return 32;
  if (K % 16 == 0) return 16;
  return 64;
}

template <int BK>
WgRing wgmma_ring_bk(int bn, int64_t N, int64_t K) {
  switch (bn) {
    case 16: return wg_ring<16, BK, false>(N, K);
    case 32: return wg_ring<32, BK, false>(N, K);
    case 48: return wg_ring<48, BK, false>(N, K);
    case 64: return wg_ring<64, BK, false>(N, K);
    case 128: return wg_ring<128, BK, false>(N, K);
    case 192: return wg_ring<192, BK, false>(N, K);
    default: return wg_ring<256, BK, false>(N, K);
  }
}

WgRing wgmma_ring(int bn, int bk, bool coop, int64_t N, int64_t K) {
  if (coop) return wg_ring<128, 64, true>(N, K);
  return bk == 64   ? wgmma_ring_bk<64>(bn, N, K)
         : bk == 32 ? wgmma_ring_bk<32>(bn, N, K)
                    : wgmma_ring_bk<16>(bn, N, K);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// dtype 0 = f32, 1 = bf16, 2 = f16. M, N > 0.
Plan plan_for(int dtype, const void* x, const void* w, const void* y,
              int64_t M, int64_t N, int64_t K) {
  Plan p{};
  const int64_t sms = sm_count();
  if (dtype == 0) {
    const bool vec = K % 4 == 0 && aligned16(x) && aligned16(w);
    p.body = vec ? kF32Async : kF32Scalar;
    p.stages = kF32Stages;
    // 128-row tiles (more FMAs a shared read) where K is deep and they
    // still give every SM two blocks; 64-row ones where K <= 64 (one or
    // two k slices: the sites are bound by their stores, and smaller
    // tiles keep more blocks on a SM to overlap them)
    const bool tall = cdiv(M, 128) >= 2 * sms && K > 64;
    const bool deep = K > 64;
    p.bn = N <= 16 ? 16 : N <= 32 ? 32 : N <= 48 ? 48 : N <= 64 ? 64
         : (N <= 96 || (N > 128 && N <= 192)) ? 96 : 128;
    switch (p.bn) {
      case 16: p.bm = 128; p.tm = 4; p.tn = 4; break;
      case 32: p.bm = 128; p.tm = 8; p.tn = 4; break;
      case 48: p.bm = 64; p.tm = 4; p.tn = 6; break;
      case 64: p.bm = tall ? 128 : 64; p.tm = tall ? 8 : 4; p.tn = 4; break;
      case 96: p.bm = deep ? 128 : 64; p.tm = deep ? 8 : 4; p.tn = 6; break;
      default: p.bm = deep ? 128 : 64; p.tm = deep ? 8 : 4; p.tn = 8;
    }
    p.blocks = cdiv(M, p.bm) * cdiv(N, p.bn);
    return p;
  }
  const bool tma = K >= 8 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(y) && M < (1LL << 31) - kWgBM &&
                   N < (1LL << 31) - 256 && K < (1LL << 31) &&
                   encode_tiled() != nullptr;
  if (tma) {
    p.body = kWgmma;
    p.bk = wgmma_bk(K);
    // wide N over deep K (the classifier): 128 x 128 tiles shared by
    // both consumers read W's slices from L2 half as often a row as
    // 64 x 256 ones, and 392 of them fill three waves
    p.coop = N > 256 && K >= 256 && p.bk == 64;
    p.bm = p.coop ? 2 * kWgBM : kWgBM;
    p.bn = p.coop ? 128 : wgmma_width(N);
    // 256-wide tiles split in two where they would leave SMs idle or
    // where K <= 64 (store-bound: a 32 KB epilogue a tile overlapped
    // too little)
    if (p.bn == 256 && (K <= 64 || cdiv(M, p.bm) * cdiv(N, p.bn) < sms))
      p.bn = 128;
    const WgRing ring = wgmma_ring(p.bn, p.bk, p.coop, N, K);
    p.stages = ring.stages;
    p.wres = ring.wres_bytes != 0;
    const int64_t tiles = cdiv(M, p.bm) * cdiv(N, p.bn);
    p.blocks = tiles < sms ? tiles : sms;
    return p;
  }
  const bool vec = K % 8 == 0 && aligned16(x) && aligned16(w);
  p.body = vec ? kMmaAsync : kMmaScalar;
  p.stages = vec ? 2 : 1;
  p.bn = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  // 64-row tiles where 128-row ones would give fewer than two blocks an SM
  p.bm = cdiv(M, 128) * cdiv(N, p.bn) >= 2 * sms ? 128 : 64;
  p.blocks = cdiv(M, p.bm) * cdiv(N, p.bn);
  return p;
}

template <bool RELU, bool VEC>
int launch_f32(const Plan& p, const float* x, const float* w,
               const float* b, float* y, int64_t M, int64_t N, int64_t K,
               cudaStream_t s) {
  if (p.bn == 16)
    return launch_f32_cfg<128, 16, 4, 4, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 32)
    return launch_f32_cfg<128, 32, 8, 4, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 48)
    return launch_f32_cfg<64, 48, 4, 6, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 64 && p.bm == 128)
    return launch_f32_cfg<128, 64, 8, 4, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 64)
    return launch_f32_cfg<64, 64, 4, 4, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 96 && p.bm == 128)
    return launch_f32_cfg<128, 96, 8, 6, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 96)
    return launch_f32_cfg<64, 96, 4, 6, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bm == 128)
    return launch_f32_cfg<128, 128, 8, 8, RELU, VEC>(x, w, b, y, M, N, K, s);
  return launch_f32_cfg<64, 128, 4, 8, RELU, VEC>(x, w, b, y, M, N, K, s);
}

template <typename T, int BK>
int launch_wgmma_bk(const Plan& p, bool relu, const T* x, const T* w,
                    const float* b, T* y, int64_t M, int64_t N, int64_t K,
                    cudaStream_t s) {
  switch (p.bn) {
    case 16:
      return launch_wgmma<T, 16, BK, false>(relu, x, w, b, y, M, N, K, s);
    case 32:
      return launch_wgmma<T, 32, BK, false>(relu, x, w, b, y, M, N, K, s);
    case 48:
      return launch_wgmma<T, 48, BK, false>(relu, x, w, b, y, M, N, K, s);
    case 64:
      return launch_wgmma<T, 64, BK, false>(relu, x, w, b, y, M, N, K, s);
    case 128:
      return launch_wgmma<T, 128, BK, false>(relu, x, w, b, y, M, N, K, s);
    case 192:
      return launch_wgmma<T, 192, BK, false>(relu, x, w, b, y, M, N, K, s);
    default:
      return launch_wgmma<T, 256, BK, false>(relu, x, w, b, y, M, N, K, s);
  }
}

template <typename T, bool RELU, bool VEC>
int launch_mma_plan(const Plan& p, const T* x, const T* w, const float* b,
                    T* y, int64_t M, int64_t N, int64_t K, cudaStream_t s) {
  if (p.bm == 128) {
    if (p.bn == 16)
      return launch_mma<T, 128, 16, 32, 16, RELU, VEC>(x, w, b, y, M, N, K, s);
    if (p.bn == 32)
      return launch_mma<T, 128, 32, 32, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
    if (p.bn == 64)
      return launch_mma<T, 128, 64, 64, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
    return launch_mma<T, 128, 128, 64, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
  }
  if (p.bn == 16)
    return launch_mma<T, 64, 16, 32, 16, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 32)
    return launch_mma<T, 64, 32, 32, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
  if (p.bn == 64)
    return launch_mma<T, 64, 64, 32, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
  return launch_mma<T, 64, 128, 32, 32, RELU, VEC>(x, w, b, y, M, N, K, s);
}

template <typename T, bool RELU>
int launch_16bit(const Plan& p, const void* x, const void* w, const float* b,
                 void* y, int64_t M, int64_t N, int64_t K, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (p.body == kWgmma) {
    if (p.coop)
      return launch_wgmma<T, 128, 64, true>(RELU, xt, wt, b, yt, M, N, K, s);
    if (p.bk == 64)
      return launch_wgmma_bk<T, 64>(p, RELU, xt, wt, b, yt, M, N, K, s);
    if (p.bk == 32)
      return launch_wgmma_bk<T, 32>(p, RELU, xt, wt, b, yt, M, N, K, s);
    return launch_wgmma_bk<T, 16>(p, RELU, xt, wt, b, yt, M, N, K, s);
  }
  if (p.body == kMmaAsync)
    return launch_mma_plan<T, RELU, true>(p, xt, wt, b, yt, M, N, K, s);
  return launch_mma_plan<T, RELU, false>(p, xt, wt, b, yt, M, N, K, s);
}

template <bool RELU>
int launch_plan(const Plan& p, int dtype, const void* x, const void* w,
                const float* b, void* y, int64_t M, int64_t N, int64_t K,
                cudaStream_t s) {
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    if (p.body == kF32Async)
      return launch_f32<RELU, true>(p, xf, wf, b, yf, M, N, K, s);
    return launch_f32<RELU, false>(p, xf, wf, b, yf, M, N, K, s);
  }
  if (dtype == 1)
    return launch_16bit<__nv_bfloat16, RELU>(p, x, w, b, y, M, N, K, s);
  return launch_16bit<__half, RELU>(p, x, w, b, y, M, N, K, s);
}

bool valid_args(int64_t M, int64_t N, int64_t K, int dtype) {
  return M >= 0 && N >= 0 && K >= 0 && dtype >= 0 && dtype <= 2 &&
         (N + 15) / 16 <= 65535;
}

}  // namespace

// x: [M, K], w: [N, K], y: [M, N], all contiguous of `dtype` (0 = float32,
// 1 = bfloat16, 2 = float16); bias: float32 [N]. relu: 0 = identity,
// 1 = relu. Launches one kernel on `stream`, does not synchronise and
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
extern "C" int dl4j_matmul_bias_act(const void* x, const void* w,
                                    const void* bias, void* y, int64_t M,
                                    int64_t N, int64_t K, int dtype, int relu,
                                    void* stream) {
  if (!valid_args(M, N, K, dtype)) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const Plan p = plan_for(dtype, x, w, y, M, N, K);
  const int rc = relu ? launch_plan<true>(p, dtype, x, w, b, y, M, N, K, s)
                      : launch_plan<false>(p, dtype, x, w, b, y, M, N, K, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The body dl4j_matmul_bias_act takes for these arguments, as text in
// `out` (at most `len` bytes with its terminating 0): the kernel, its
// tile, ring depth and grid. Launches nothing. Returns 0, or
// cudaErrorInvalidValue for arguments the kernel refuses.
extern "C" int dl4j_matmul_bias_act_describe(const void* x, const void* w,
                                             const void* y, int64_t M,
                                             int64_t N, int64_t K, int dtype,
                                             char* out, int len) {
  if (!valid_args(M, N, K, dtype) || M == 0 || N == 0 || len <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(dtype, x, w, y, M, N, K);
  static const char* names[] = {"f32 SIMT, cp.async ring",
                                "f32 SIMT, element loads",
                                "wgmma + TMA, persistent",
                                "mma.sync, cp.async ring",
                                "mma.sync, element loads"};
  if (p.body == kF32Async || p.body == kF32Scalar)
    snprintf(out, len, "%s: %dx%d tiles, %dx%d a thread, %d stages, "
             "%lld blocks", names[p.body], p.bm, p.bn, p.tm, p.tn,
             p.stages, (long long)p.blocks);
  else if (p.body == kWgmma)
    snprintf(out, len, "%s: %dx%d tiles (%s), %d-wide k slices, W %s, "
             "%d stages, %lld blocks", names[p.body], p.bm, p.bn,
             p.coop ? "cooperative" : "ping-pong", p.bk,
             p.wres ? "resident" : "streamed", p.stages,
             (long long)p.blocks);
  else
    snprintf(out, len, "%s: %dx%d tiles, %d stage(s), %lld blocks",
             names[p.body], p.bm, p.bn, p.stages, (long long)p.blocks);
  return 0;
}

// The host time of encoding the Hopper body's two tensor maps for an
// [M, K] x [N, K] bf16 product, in ns, averaged over `reps` encodings
// (the pointers are only packed, not dereferenced); -1 where
// cuTensorMapEncodeTiled cannot be reached.
extern "C" double dl4j_matmul_tensor_map_ns(const void* x, const void* w,
                                            int64_t M, int64_t N, int64_t K,
                                            int reps) {
  if (encode_tiled() == nullptr || reps <= 0) return -1.0;
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(w);
  const int bn = wgmma_width(N);
  const int bk = wgmma_bk(K);
  CUtensorMap tmx, tmw;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (encode_operand(&tmx, xt, M, K, kWgBM, bk) != 0 ||
        encode_operand(&tmw, wt, N, K, bn, bk) != 0)
      return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
