// scale_shift_act: y = act(x * scale + shift) with per-channel f32
// coefficients over a contiguous channels-last [M, C] view.
//
// Replaces deeplearning4j_tpu/ops/conv_pallas.py:_epilogue_kernel (the
// forward of scale_shift_act, launched by _epilogue_apply_raw's
// pl.pallas_call). On ResNet-50 inference it is every BatchNormalization:
// the running stats fold into (scale, shift) and the relu streams behind
// them, 53 sites per forward.
//
// Bound: bytes. Each element is read once and written once (x and y,
// 4 + 4 bytes in f32, 2 + 2 in bf16 and f16) for one multiply and one add; the
// coefficients are 8*C bytes and stay in L1/L2. At the H100's 3.35 TB/s
// that is far below the card's arithmetic rate, so the design only has
// to keep the memory system busy: every thread moves 16 bytes per load
// and per store (float4 / 8 x bf16 / 8 x f16) when C and the pointers allow it,
// the grid-stride loop keeps a few blocks per SM in flight, and indices
// are 64-bit (the largest ResNet-50 site at batch 32 is 25.7 M elements,
// later batches exceed 2^31). What remains on the table is the round
// trip itself: fusing the epilogue into the convolution's output tile
// removes it, and is later work.
//
// Arithmetic matches the plain PyTorch version bit for bit: a rounded
// multiply, then a rounded add (__fmul_rn / __fadd_rn forbid the FMA
// contraction), then relu as `y < 0 ? 0 : y`, which propagates NaN as
// jnp.maximum does (fmaxf would turn NaN into 0). bf16 and f16 convert
// to f32 on load and round to nearest even on store.
//
// The training half of the file (dl4j_epilogue_backward,
// dl4j_channel_sums, at the end) holds the two reductions of the family:
// the first on column_reduce.cuh (two launches), the second on
// column_reduce_sm90.cuh (one launch); each header says how it sums.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "column_reduce.cuh"
#include "column_reduce_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool RELU>
__device__ __forceinline__ float epilogue(float x, float s, float b) {
  float y = __fadd_rn(__fmul_rn(x, s), b);
  if (RELU) y = y < 0.f ? 0.f : y;
  return y;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Two-lane conversions for the 16-bit vector kernel.
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_float2(__half2 v) {
  return __half22float2(v);
}
__device__ __forceinline__ void from_float2(__nv_bfloat162* p, float lo,
                                            float hi) {
  *p = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void from_float2(__half2* p, float lo, float hi) {
  *p = __floats2half2_rn(lo, hi);
}

// Scalar grid-stride pass over elements [start, n).
template <typename T, bool RELU>
__device__ __forceinline__ void scalar_pass(const T* __restrict__ x,
                                            T* __restrict__ y,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift,
                                            int64_t start, int64_t n,
                                            int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t c = i % C;
    store_f(y + i, epilogue<RELU>(load_f(x + i), __ldg(scale + c),
                                  __ldg(shift + c)));
  }
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
ssa_scalar_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, int64_t n, int64_t C) {
  scalar_pass<T, RELU>(x, y, scale, shift, 0, n, C);
}

// 16-byte vectors: 4 x f32 or 8 x bf16 per load and store. The host
// launches this only when C is a multiple of the vector width (so a
// vector never straddles a channel wrap) and x, y are 16-byte aligned.
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
ssa_vec_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, int64_t n, int64_t C) {
  const int64_t n_vec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const int64_t c = (v * 4) % C;
    const float4 a = xv[v];
    float4 r;
    r.x = epilogue<RELU>(a.x, __ldg(scale + c), __ldg(shift + c));
    r.y = epilogue<RELU>(a.y, __ldg(scale + c + 1), __ldg(shift + c + 1));
    r.z = epilogue<RELU>(a.z, __ldg(scale + c + 2), __ldg(shift + c + 2));
    r.w = epilogue<RELU>(a.w, __ldg(scale + c + 3), __ldg(shift + c + 3));
    yv[v] = r;
  }
  scalar_pass<float, RELU>(x, y, scale, shift, n_vec * 4, n, C);
}

// 8 x bf16 or 8 x f16 per 16-byte vector; T2 is the two-lane type.
template <typename T, typename T2, bool RELU>
__global__ void __launch_bounds__(kThreads)
ssa_vec_16bit_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, int64_t n, int64_t C) {
  const int64_t n_vec = n / 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const int64_t c = (v * 8) % C;
    uint4 a = xv[v];
    uint4 r;
    const T2* ap = reinterpret_cast<const T2*>(&a);
    T2* rp = reinterpret_cast<T2*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = to_float2(ap[k]);
      const int64_t ck = c + 2 * k;
      const float lo =
          epilogue<RELU>(f.x, __ldg(scale + ck), __ldg(shift + ck));
      const float hi =
          epilogue<RELU>(f.y, __ldg(scale + ck + 1), __ldg(shift + ck + 1));
      from_float2(rp + k, lo, hi);
    }
    yv[v] = r;
  }
  scalar_pass<T, RELU>(x, y, scale, shift, n_vec * 8, n, C);
}

int grid_for(int64_t work) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * kBlocksPerSm;
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, typename T2, bool RELU>
void launch(const void* x, void* y, const float* scale, const float* shift,
            int64_t n, int64_t C, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  constexpr int kVec = 16 / sizeof(T);
  if (C % kVec == 0 && aligned16(x) && aligned16(y)) {
    const int grid = grid_for(n / kVec);
    if constexpr (sizeof(T) == 4) {
      ssa_vec_f32_kernel<RELU><<<grid, kThreads, 0, stream>>>(
          xt, yt, scale, shift, n, C);
    } else {
      ssa_vec_16bit_kernel<T, T2, RELU><<<grid, kThreads, 0, stream>>>(
          xt, yt, scale, shift, n, C);
    }
  } else {
    ssa_scalar_kernel<T, RELU><<<grid_for(n), kThreads, 0, stream>>>(
        xt, yt, scale, shift, n, C);
  }
}

template <typename T, typename T2>
void launch_act(bool relu, const void* x, void* y, const float* scale,
                const float* shift, int64_t n, int64_t C,
                cudaStream_t stream) {
  if (relu) launch<T, T2, true>(x, y, scale, shift, n, C, stream);
  else launch<T, T2, false>(x, y, scale, shift, n, C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. relu: 0 = identity,
// 1 = relu. Returns the cudaError_t of the launch (0 on success).
// Launches on `stream`, does not synchronise and allocates nothing: the
// caller owns x, y, scale and shift, all on the current device.
extern "C" int dl4j_scale_shift_act(const void* x, void* y, const void* scale,
                                    const void* shift, int64_t M, int64_t C,
                                    int dtype, int relu, void* stream) {
  const int64_t n = M * C;
  if (n == 0) return 0;
  if (C <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 0) {
    launch_act<float, float>(relu, x, y, sc, sh, n, C, s);
  } else if (dtype == 1) {
    launch_act<__nv_bfloat16, __nv_bfloat162>(relu, x, y, sc, sh, n, C, s);
  } else if (dtype == 2) {
    launch_act<__half, __half2>(relu, x, y, sc, sh, n, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ===========================================================================
// Training: the epilogue's backward and the channel statistics.
// ===========================================================================
//
// epilogue_backward replaces deeplearning4j_tpu/ops/conv_pallas.py:
// _epilogue_bwd_kernel (launched by _epilogue_backward; the backward of
// scale_shift_act). One pass over x and dy gives
//   g  = relu ? (x*s + b > 0 ? dy : 0) : dy      (the forward's rounding)
//   dx = g * s                                   (elementwise, x's dtype)
//   sums[0] = sum_rows g        (dshift)
//   sums[1] = sum_rows g * x    (dscale; the product is not masked, so a
//                                NaN x gives a NaN sum as in the JAX code)
// channel_sums replaces conv_pallas.py:_stats_kernel (launched by
// _channel_sums; the statistics of training BatchNormalization):
//   sums[0] = sum_rows x, sums[1] = sum_rows x * x.
//
// Bound: bytes. channel_sums reads x once (4 bytes an element in f32, 2
// in 16 bit); epilogue_backward reads x and dy and writes dx (12 bytes in
// f32) for about six operations an element, far below the card's f32
// rate. Both read with 16-byte vectors where C and the pointers allow
// it, and dx is written in the same pass, so the backward never re-reads
// its inputs. dx is bitwise equal to the plain version; the sums are
// deterministic and agree with the plain version to rounding.
//
// epilogue_backward sums on column_reduce.cuh: per-chunk partials, then
// a finalize launch. channel_sums is one launch a site on
// column_reduce_sm90.cuh (StatsOp below): a grid of row chunks x channel
// tiles fixed by (M, C, element size), each thread's 16-byte row vectors
// kept raw and converted at use, 32-bit indices where M * C < 2^30, the
// blocks' partials meeting through integer tickets (no finalize launch,
// no float atomic, the same bits from two launches). Its plan is sized
// for one input: a row is one 16-byte vector a thread, half of what
// kernel 5 (x and dy) loads, so a thread keeps StatsPlan::kRows rows in
// flight to have as many bytes in flight as kernel 5 has.
namespace {

// Kernel 3's plan on column_reduce_sm90.cuh, each constant timed against
// its neighbours over a ResNet-50 step's 53 sites (PERF.md §6): 8 rows in
// flight (4, 6, 12 and 16 were slower; 16 spills), groups of 256 chunks,
// more than a site ever has (at most the header's kTargetBlocks), so
// every site takes one ticket level (groups of 16, 32 and 64 were
// slower), and the last block reads the partials as 16-byte vectors, 4
// values a load (scalar loads were slower at one level: 2 lanes a value
// at C = 64 in 16 bit).
struct StatsPlan {
  static constexpr int kRows = 8;
  static constexpr int kGroup = 256;
  static constexpr int kFinalVec = 4;
};

// One row of x for VEC channels, as loaded: a raw 16-byte vector, or VEC
// elements
template <typename T, int VEC, bool kVector = VEC * sizeof(T) == 16>
struct StatsRaw {
  uint4 x;
};
template <typename T, int VEC>
struct StatsRaw<T, VEC, false> {
  T x[VEC];
};

template <typename T, int VEC, typename I>
struct StatsOp {
  using Plan = StatsPlan;
  using Raw = StatsRaw<T, VEC>;
  const T* x;
  I C;
  __device__ __forceinline__ void begin(I) {}
  __device__ __forceinline__ void load(I r, I c0, Raw& raw) const {
    const I off = r * C + c0;
    if constexpr (VEC * sizeof(T) == 16) {
      raw.x = __ldg(reinterpret_cast<const uint4*>(x + off));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) raw.x[v] = x[off + v];
    }
  }
  __device__ __forceinline__ void fold(const Raw& raw, float (&s0)[VEC],
                                       float (&s1)[VEC]) const {
    const T* xe = reinterpret_cast<const T*>(&raw.x);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xv = dl4j::to_f(xe[v]);
      s0[v] = __fadd_rn(s0[v], xv);
      s1[v] = __fadd_rn(s1[v], __fmul_rn(xv, xv));
    }
  }
};

template <typename T, int VEC, bool RELU>
struct EpilogueBwdOp {
  const T* x;
  const T* dy;
  T* dx;
  const float* scale;
  const float* shift;
  int64_t C;
  float s[VEC], b[VEC];
  __device__ __forceinline__ void begin(int64_t c0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s[v] = __ldg(scale + c0 + v);
      b[v] = __ldg(shift + c0 + v);
    }
  }
  __device__ __forceinline__ void row(int64_t r, int64_t c0,
                                      float (&s0)[VEC],
                                      float (&s1)[VEC]) const {
    const int64_t off = r * C + c0;
    float xv[VEC], dv[VEC], out[VEC];
    dl4j::load_vec<T, VEC>(x + off, xv);
    dl4j::load_vec<T, VEC>(dy + off, dv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float g = dv[v];
      if (RELU) {
        const float z = __fadd_rn(__fmul_rn(xv[v], s[v]), b[v]);
        g = z > 0.f ? g : 0.f;
      }
      out[v] = __fmul_rn(g, s[v]);
      s0[v] = __fadd_rn(s0[v], g);
      s1[v] = __fadd_rn(s1[v], __fmul_rn(g, xv[v]));
    }
    dl4j::store_vec<T, VEC>(dx + off, out);
  }
};

template <typename T, int VEC, typename I>
int channel_sums_launch(const T* x, const dl4j::sm90::Geom& g, float* work,
                        float* sums, int64_t M, int64_t C,
                        cudaStream_t stream) {
  return dl4j::sm90::launch_column_sums<VEC, StatsOp<T, VEC, I>, I>(
      StatsOp<T, VEC, I>{x, (I)C}, g, work, sums, M, C, stream);
}

template <typename T>
int channel_sums_typed(const void* x, float* work, int64_t capacity,
                       float* sums, int64_t M, int64_t C,
                       cudaStream_t stream) {
  const dl4j::sm90::Geom g =
      dl4j::sm90::geom<StatsPlan>(M, C, sizeof(T), dl4j::aligned16(x));
  if (dl4j::sm90::workspace_floats(g, C) > capacity)
    return (int)cudaErrorInvalidValue;
  constexpr int kFull = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  if (g.vec == kFull)
    return g.wide_index
               ? channel_sums_launch<T, kFull, int64_t>(xt, g, work, sums, M,
                                                        C, stream)
               : channel_sums_launch<T, kFull, int32_t>(xt, g, work, sums, M,
                                                        C, stream);
  return g.wide_index
             ? channel_sums_launch<T, 1, int64_t>(xt, g, work, sums, M, C,
                                                  stream)
             : channel_sums_launch<T, 1, int32_t>(xt, g, work, sums, M, C,
                                                  stream);
}

template <typename T, int VEC, bool RELU>
int epilogue_bwd_launch(const void* x, const void* dy, void* dx,
                        const float* scale, const float* shift,
                        const dl4j::ColumnGeom& g, float* partials,
                        float* sums, int64_t M, int64_t C,
                        cudaStream_t stream) {
  EpilogueBwdOp<T, VEC, RELU> op{static_cast<const T*>(x),
                                 static_cast<const T*>(dy),
                                 static_cast<T*>(dx), scale, shift, C,
                                 {}, {}};
  return dl4j::launch_column_sums<VEC>(op, g, partials, sums, M, C, stream);
}

template <typename T>
int epilogue_bwd_typed(const void* x, const void* dy, void* dx,
                       const float* scale, const float* shift,
                       float* partials, int64_t capacity, float* sums,
                       int64_t M, int64_t C, bool relu,
                       cudaStream_t stream) {
  const bool aligned = dl4j::aligned16(x) && dl4j::aligned16(dy) &&
                       dl4j::aligned16(dx);
  const dl4j::ColumnGeom g = dl4j::column_geom(M, C, sizeof(T), aligned);
  if (g.chunks > capacity) return (int)cudaErrorInvalidValue;
  constexpr int kFull = 16 / sizeof(T);
  if (g.vec == kFull) {
    return relu ? epilogue_bwd_launch<T, kFull, true>(
                      x, dy, dx, scale, shift, g, partials, sums, M, C,
                      stream)
                : epilogue_bwd_launch<T, kFull, false>(
                      x, dy, dx, scale, shift, g, partials, sums, M, C,
                      stream);
  }
  return relu ? epilogue_bwd_launch<T, 1, true>(x, dy, dx, scale, shift, g,
                                                partials, sums, M, C, stream)
              : epilogue_bwd_launch<T, 1, false>(x, dy, dx, scale, shift, g,
                                                 partials, sums, M, C,
                                                 stream);
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Rows of the [chunks, 2, C] f32 workspace that dl4j_epilogue_backward
// needs for an [M, C] input of `dtype` (0 = float32, 1 = bfloat16,
// 2 = float16).
extern "C" int64_t dl4j_conv_epilogue_chunks(int64_t M, int64_t C,
                                             int dtype) {
  if (M <= 0 || C <= 0) return 1;
  return dl4j::column_geom(M, C, elem_bytes(dtype), true).chunks;
}

// dx = g * scale and sums[2, C] = (sum g, sum g * x) with
// g = relu ? (x * scale + shift > 0 ? dy : 0) : dy. x, dy, dx: [M, C] of
// `dtype`; scale, shift: f32 [C]; partials: f32 [capacity, 2, C]
// workspace; sums: f32 [2, C]. Launches two kernels on `stream`, does not
// synchronise and allocates nothing. Returns the cudaError_t (0 on
// success).
extern "C" int dl4j_epilogue_backward(const void* x, const void* dy,
                                      void* dx, const void* scale,
                                      const void* shift, void* partials,
                                      int64_t capacity, void* sums,
                                      int64_t M, int64_t C, int dtype,
                                      int relu, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* pt = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return epilogue_bwd_typed<float>(x, dy, dx, sc, sh, pt, capacity, out,
                                     M, C, relu != 0, s);
  if (dtype == 1)
    return epilogue_bwd_typed<__nv_bfloat16>(x, dy, dx, sc, sh, pt,
                                             capacity, out, M, C, relu != 0,
                                             s);
  if (dtype == 2)
    return epilogue_bwd_typed<__half>(x, dy, dx, sc, sh, pt, capacity, out,
                                      M, C, relu != 0, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of the f32 workspace dl4j_channel_sums needs for an [M, C] input
// of `dtype`.
extern "C" int64_t dl4j_channel_sums_workspace(int64_t M, int64_t C,
                                               int dtype) {
  if (M <= 0 || C <= 0) return 0;
  return dl4j::sm90::workspace_floats(
      dl4j::sm90::geom<StatsPlan>(M, C, elem_bytes(dtype), true), C);
}

// sums[2, C] = (sum x, sum x * x) over the M rows of x [M, C] of `dtype`;
// work: `capacity` f32 floats (dl4j_channel_sums_workspace); sums: f32
// [2, C]. One launch on `stream`; no synchronisation, no allocation.
// Returns the cudaError_t (0 on success).
extern "C" int dl4j_channel_sums(const void* x, void* work,
                                 int64_t capacity, void* sums, int64_t M,
                                 int64_t C, int dtype, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return channel_sums_typed<float>(x, wk, capacity, out, M, C, s);
  if (dtype == 1)
    return channel_sums_typed<__nv_bfloat16>(x, wk, capacity, out, M, C, s);
  if (dtype == 2)
    return channel_sums_typed<__half>(x, wk, capacity, out, M, C, s);
  return (int)cudaErrorInvalidValue;
}

// The geometry dl4j_channel_sums takes for these arguments, as text in
// `out` (at most `len` bytes with its terminating 0). Launches nothing.
extern "C" int dl4j_channel_sums_describe(const void* x, int64_t M,
                                          int64_t C, int dtype, char* out,
                                          int len) {
  if (M <= 0 || C <= 0 || dtype < 0 || dtype > 2 || len <= 0)
    return (int)cudaErrorInvalidValue;
  const dl4j::sm90::Geom g = dl4j::sm90::geom<StatsPlan>(
      M, C, elem_bytes(dtype), dl4j::aligned16(x));
  dl4j::sm90::describe(g, StatsPlan::kRows, out, len);
  return 0;
}
