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
// Bound: at SqueezeNet's batch-32 shapes most sites are bound by bytes
// (x read once, y written once) and, in f32, the 1x1 classifier (K =
// 512, N = 1000) and the wide squeeze sites by operations (67 TFLOP/s of
// f32 FMA). Two paths, both tiled GEMMs with the tile's width following
// N (16, 32, 64 or 128), so the skinny squeeze sites (N = 16, 32) read x
// once without idle lanes:
//   * f32 (mba_f32_kernel): SIMT FMAs, full f32 (no TF32). A block owns
//     a BM x BN output tile and walks K in steps of 16; x's and W's k
//     slices are staged in shared memory k-major (transposed) so each
//     thread reads its TM rows and TN columns of a k step with 16-byte
//     shared loads into a TM x TN register accumulator; the next slice
//     is loaded into registers while the current one is multiplied.
//     Global loads are scalar, coalesced along k, bounds-checked with a
//     zero fill, which makes ragged M, N and K exact on one path.
//   * bf16 / f16 (mba_mma_kernel): tensor cores through mma.sync
//     m16n8k16 with f32 accumulation (the products of 16-bit inputs are
//     exact in f32; the sums run in the tensor core's f32 adder). 32-wide
//     k slices of x and W go to shared memory as they lie (K-contiguous
//     rows, padded against bank conflicts) through a two-stage cp.async
//     pipeline with a zero fill for the ragged M and N edges, and reach
//     the tensor cores by ldmatrix. Where K is not a multiple of 8 or a
//     pointer not 16-byte aligned, the slices are loaded element by
//     element instead (bounds-checked, no pipeline). The output tile is
//     staged in the same shared memory and leaves in 16-byte row chunks.
// Where 128-row tiles would leave SMs idle (the 14x14 sites, M = 6272 at
// batch 32), the tiles are 64 rows. The epilogue runs on the f32
// accumulator registers; f32 stores are 16-byte vectors where N and the
// pointer allow it. What is left on the table: wgmma and TMA, a deeper
// pipeline, and a persistent schedule for the head site's partial last
// wave. They are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

template <bool RELU>
__device__ __forceinline__ float epilogue(float acc, float b) {
  float y = __fadd_rn(acc, b);
  if (RELU) y = y < 0.f ? 0.f : y;
  return y;
}

// ===========================================================================
// f32: SIMT FMAs
// ===========================================================================
constexpr int kF32Threads = 256;
constexpr int kF32BK = 16;
constexpr int kPad = 4;  // keeps 16-byte alignment, spreads the stores

// One [ROWS, kF32BK] slice of a K-contiguous [rows, K] operand: element
// l = tid + i * kF32Threads of the slice is row l / kF32BK, column
// l % kF32BK, so a warp reads two 16-element row segments; out-of-range
// elements are 0.
template <int ROWS>
struct Slice {
  static constexpr int kPer = ROWS * kF32BK / kF32Threads;
  float v[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int64_t rows, int64_t K, int64_t r0,
                                       int64_t k0, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = tid + i * kF32Threads;
      const int64_t r = r0 + l / kF32BK;
      const int64_t k = k0 + l % kF32BK;
      v[i] = (r < rows && k < K) ? __ldg(src + r * K + k) : 0.f;
    }
  }

  // stored k-major: dst[k][row]
  __device__ __forceinline__ void store(float (*dst)[ROWS + kPad],
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = tid + i * kF32Threads;
      dst[l % kF32BK][l / kF32BK] = v[i];
    }
  }
};

// A thread's T rows (or columns) of a tile of SPAN: T / 4 groups of 4
// consecutive ones, group g at g * SPAN * 4 / T + 4 * t. Neighbouring
// threads hold neighbouring groups, so a warp's 16-byte shared reads
// and its global stores are contiguous.
template <int T, int SPAN>
__device__ __forceinline__ int group_at(int t, int g) {
  return g * (SPAN * 4 / T) + 4 * t;
}

template <int T, int SPAN>
__device__ __forceinline__ void load_frag(const float* row, int t,
                                          float (&v)[T]) {
#pragma unroll
  for (int g = 0; g < T / 4; ++g) {
    const float4 f =
        *reinterpret_cast<const float4*>(row + group_at<T, SPAN>(t, g));
    v[4 * g] = f.x;
    v[4 * g + 1] = f.y;
    v[4 * g + 2] = f.z;
    v[4 * g + 3] = f.w;
  }
}

// Tile BM x BN, thread tile TM x TN; (BM / TM) * (BN / TN) == kF32Threads.
// MIN_BLOCKS an SM caps the registers (2: at most 128 a thread).
template <int BM, int BN, int TM, int TN, int MIN_BLOCKS, bool RELU>
__global__ void __launch_bounds__(kF32Threads, MIN_BLOCKS)
mba_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y,
               int64_t M, int64_t N, int64_t K) {
  static_assert((BM / TM) * (BN / TN) == kF32Threads, "tile/thread mismatch");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "16-byte shared reads");
  __shared__ __align__(16) float As[kF32BK][BM + kPad];
  __shared__ __align__(16) float Bs[kF32BK][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Slice<BM> xa;
  Slice<BN> wb;
  const int64_t tiles = (K + kF32BK - 1) / kF32BK;
  if (tiles > 0) {
    xa.load(x, M, K, m0, 0, tid);
    wb.load(w, N, K, n0, 0, tid);
  }
  for (int64_t t = 0; t < tiles; ++t) {
    xa.store(As, tid);
    wb.store(Bs, tid);
    __syncthreads();
    if (t + 1 < tiles) {  // the next slice is in flight during the FMAs
      xa.load(x, M, K, m0, (t + 1) * kF32BK, tid);
      wb.load(w, N, K, n0, (t + 1) * kF32BK, tid);
    }
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      float a[TM], b[TN];
      load_frag<TM, BM>(As[k], ty, a);
      load_frag<TN, BN>(Bs[k], tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: + bias, relu, one store per output
  const bool vec_ok =
      (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(y) % 16) == 0);
#pragma unroll
  for (int gj = 0; gj < TN / 4; ++gj) {
    const int64_t n = n0 + group_at<TN, BN>(tx, gj);
    float bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = n + q < N ? __ldg(bias + n + q) : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t m = m0 + group_at<TM, BM>(ty, i / 4) + i % 4;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = epilogue<RELU>(acc[i][4 * gj + q], bv[q]);
      float* p = y + m * N + n;
      if (vec_ok && n + 3 < N) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) p[q] = v[q];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS>
void launch_f32(bool relu, const float* x, const float* w, const float* b,
                float* y, int64_t M, int64_t N, int64_t K,
                cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((N + BN - 1) / BN));
  if (relu)
    mba_f32_kernel<BM, BN, TM, TN, MIN_BLOCKS, true>
        <<<grid, kF32Threads, 0, stream>>>(x, w, b, y, M, N, K);
  else
    mba_f32_kernel<BM, BN, TM, TN, MIN_BLOCKS, false>
        <<<grid, kF32Threads, 0, stream>>>(x, w, b, y, M, N, K);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The tile follows N. A site with K >= 256 is bound by operations and
// takes the 128-row tile (more FMAs per shared read) when that still
// gives every SM a block; the others take 64 rows and more blocks in
// flight to hide the loads and stores.
void launch_f32_by_shape(bool relu, const float* x, const float* w,
                         const float* b, float* y, int64_t M, int64_t N,
                         int64_t K, cudaStream_t stream) {
  const int64_t wide = sm_count();
  auto blocks = [&](int64_t bm, int64_t bn) {
    return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (N <= 16)
    launch_f32<256, 16, 4, 4, 2>(relu, x, w, b, y, M, N, K, stream);
  else if (N <= 32)
    launch_f32<256, 32, 8, 4, 2>(relu, x, w, b, y, M, N, K, stream);
  else if (N <= 64 && K >= 256 && blocks(128, 64) >= wide)
    launch_f32<128, 64, 8, 4, 2>(relu, x, w, b, y, M, N, K, stream);
  else if (N <= 64)
    launch_f32<64, 64, 4, 4, 2>(relu, x, w, b, y, M, N, K, stream);
  else if (K >= 256 && blocks(128, 128) >= wide)
    launch_f32<128, 128, 8, 8, 1>(relu, x, w, b, y, M, N, K, stream);
  else
    launch_f32<64, 128, 4, 8, 2>(relu, x, w, b, y, M, N, K, stream);
}

// ===========================================================================
// bf16 / f16: mma.sync m16n8k16, f32 accumulation
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
               epilogue<RELU>(acc[i][j][2 * h], b0),
               epilogue<RELU>(acc[i][j][2 * h + 1], b1));
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

template <typename T, int BM, int BN, int WM, int WN, bool VEC>
void launch_mma(bool relu, const T* x, const T* w, const float* b, T* y,
                int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((N + BN - 1) / BN));
  if (relu)
    mba_mma_kernel<T, BM, BN, WM, WN, true, VEC>
        <<<grid, kThreads, 0, stream>>>(x, w, b, y, M, N, K);
  else
    mba_mma_kernel<T, BM, BN, WM, WN, false, VEC>
        <<<grid, kThreads, 0, stream>>>(x, w, b, y, M, N, K);
}

// The tile's width follows N; 64-row tiles where 128-row ones would give
// fewer than two blocks an SM (the 14x14 sites: M = 6272 at batch 32).
template <typename T, bool VEC, int BM>
void launch_mma_by_n(bool relu, const T* x, const T* w, const float* b,
                     T* y, int64_t M, int64_t N, int64_t K,
                     cudaStream_t stream) {
  constexpr int WM = BM == 128 ? 64 : 32;  // rows a warp, wide tiles
  if (N <= 16)
    launch_mma<T, BM, 16, 32, 16, VEC>(relu, x, w, b, y, M, N, K, stream);
  else if (N <= 32)
    launch_mma<T, BM, 32, 32, 32, VEC>(relu, x, w, b, y, M, N, K, stream);
  else if (N <= 64)
    launch_mma<T, BM, 64, WM, 32, VEC>(relu, x, w, b, y, M, N, K, stream);
  else
    launch_mma<T, BM, 128, WM, 32, VEC>(relu, x, w, b, y, M, N, K, stream);
}

template <typename T, bool VEC>
void launch_mma_by_shape(bool relu, const T* x, const T* w, const float* b,
                         T* y, int64_t M, int64_t N, int64_t K,
                         cudaStream_t stream) {
  const int64_t bn = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  if (((M + 127) / 128) * ((N + bn - 1) / bn) >= 2 * (int64_t)sm_count())
    launch_mma_by_n<T, VEC, 128>(relu, x, w, b, y, M, N, K, stream);
  else
    launch_mma_by_n<T, VEC, 64>(relu, x, w, b, y, M, N, K, stream);
}

template <typename T>
void launch_16bit(bool relu, const void* x, const void* w, const float* b,
                  void* y, int64_t M, int64_t N, int64_t K,
                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  const bool vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  if (vec)
    launch_mma_by_shape<T, true>(relu, xt, wt, b, yt, M, N, K, stream);
  else
    launch_mma_by_shape<T, false>(relu, xt, wt, b, yt, M, N, K, stream);
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
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if ((N + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    launch_f32_by_shape(relu != 0, static_cast<const float*>(x),
                        static_cast<const float*>(w), b,
                        static_cast<float*>(y), M, N, K, s);
  else if (dtype == 1)
    launch_16bit<__nv_bfloat16>(relu != 0, x, w, b, y, M, N, K, s);
  else if (dtype == 2)
    launch_16bit<__half>(relu != 0, x, w, b, y, M, N, K, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
