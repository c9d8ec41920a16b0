// The backward of training-mode BatchNormalization, in two passes over a
// contiguous channels-last [M, C] view of x and its cotangent dy:
//
//   dl4j_bn_bwd_sums  replaces deeplearning4j_tpu/ops/bn_pallas.py:
//                     _reduce_kernel (pass 1, launched by _bn_bwd_sums):
//                     sums[0] = sum_rows dy, sums[1] = sum_rows dy * xhat
//                     with xhat = (x - mean) * rstd;
//   dl4j_bn_bwd_dx    replaces bn_pallas.py:_dx_kernel (pass 2, launched by
//                     _bn_bwd_dx): dx = (A * dy + D * x) + E.
//
// Between them the caller folds the per-channel coefficients A, D, E from
// the sums and from the mean and variance cotangents (a few [C]-sized
// ops), exactly as bn_pallas.py:_bn_bwd_raw does.
//
// Bound: bytes. Pass 1 reads x and dy (8 bytes an element in f32), pass 2
// reads them again and writes dx (12 bytes), for a handful of operations
// an element: two passes is the least this formulation needs, since every
// dx depends on sums over all rows. Both passes read and write 16-byte
// vectors where C and the pointers allow it. Pass 1 sums as
// column_reduce.cuh describes (deterministic, no float atomics); pass 2
// is elementwise and bitwise equal to the plain PyTorch version: each
// product and sum rounded on its own, in the order (A*dy + D*x) + E.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_reduce.cuh"

namespace {

template <typename T, int VEC>
struct BnSumsOp {
  const T* x;
  const T* dy;
  const float* mean;
  const float* rstd;
  int64_t C;
  float mu[VEC], r[VEC];
  __device__ __forceinline__ void begin(int64_t c0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mu[v] = __ldg(mean + c0 + v);
      r[v] = __ldg(rstd + c0 + v);
    }
  }
  __device__ __forceinline__ void row(int64_t row_i, int64_t c0,
                                      float (&s0)[VEC],
                                      float (&s1)[VEC]) const {
    const int64_t off = row_i * C + c0;
    float xv[VEC], dv[VEC];
    dl4j::load_vec<T, VEC>(x + off, xv);
    dl4j::load_vec<T, VEC>(dy + off, dv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xhat = __fmul_rn(__fsub_rn(xv[v], mu[v]), r[v]);
      s0[v] = __fadd_rn(s0[v], dv[v]);
      s1[v] = __fadd_rn(s1[v], __fmul_rn(dv[v], xhat));
    }
  }
};

template <typename T>
int bn_sums_typed(const void* x, const void* dy, const float* mean,
                  const float* rstd, float* partials, int64_t capacity,
                  float* sums, int64_t M, int64_t C, cudaStream_t stream) {
  const bool aligned = dl4j::aligned16(x) && dl4j::aligned16(dy);
  const dl4j::ColumnGeom g = dl4j::column_geom(M, C, sizeof(T), aligned);
  if (g.chunks > capacity) return (int)cudaErrorInvalidValue;
  constexpr int kFull = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (g.vec == kFull)
    return dl4j::launch_column_sums<kFull>(
        BnSumsOp<T, kFull>{xt, dyt, mean, rstd, C, {}, {}}, g, partials,
        sums, M, C, stream);
  return dl4j::launch_column_sums<1>(
      BnSumsOp<T, 1>{xt, dyt, mean, rstd, C, {}, {}}, g, partials, sums, M,
      C, stream);
}

// ---------------------------------------------------------------------------
// pass 2: dx = (A * dy + D * x) + E, grid-stride over VEC-element vectors
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             T* __restrict__ dx, const float* __restrict__ a,
             const float* __restrict__ d, const float* __restrict__ e,
             int64_t n_vec, int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const int64_t off = i * VEC;
    const int64_t c0 = off % C;   // C % VEC == 0: a vector is one row's
    float xv[VEC], dv[VEC], out[VEC];
    dl4j::load_vec<T, VEC>(x + off, xv);
    dl4j::load_vec<T, VEC>(dy + off, dv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int64_t c = c0 + v;
      out[v] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(a + c), dv[v]),
                                   __fmul_rn(__ldg(d + c), xv[v])),
                         __ldg(e + c));
    }
    dl4j::store_vec<T, VEC>(dx + off, out);
  }
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

template <typename T>
int bn_dx_typed(const void* x, const void* dy, void* dx, const float* a,
                const float* d, const float* e, int64_t M, int64_t C,
                cudaStream_t stream) {
  constexpr int kFull = 16 / sizeof(T);
  const int64_t n = M * C;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (C % kFull == 0 && dl4j::aligned16(x) && dl4j::aligned16(dy) &&
      dl4j::aligned16(dx)) {
    const int64_t n_vec = n / kFull;
    bn_dx_kernel<T, kFull><<<grid_for(n_vec), kThreads, 0, stream>>>(
        xt, dyt, dxt, a, d, e, n_vec, C);
  } else {
    bn_dx_kernel<T, 1><<<grid_for(n), kThreads, 0, stream>>>(
        xt, dyt, dxt, a, d, e, n, C);
  }
  return (int)cudaGetLastError();
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Rows of the [chunks, 2, C] f32 workspace dl4j_bn_bwd_sums needs for an
// [M, C] input of `dtype` (0 = float32, 1 = bfloat16, 2 = float16).
extern "C" int64_t dl4j_bn_train_chunks(int64_t M, int64_t C, int dtype) {
  if (M <= 0 || C <= 0) return 1;
  return dl4j::column_geom(M, C, elem_bytes(dtype), true).chunks;
}

// sums[2, C] = (sum dy, sum dy * (x - mean) * rstd). x, dy: [M, C] of
// `dtype`; mean, rstd: f32 [C]; partials: f32 [capacity, 2, C]; sums: f32
// [2, C]. Two launches on `stream`; no synchronisation, no allocation.
// Returns the cudaError_t (0 on success).
extern "C" int dl4j_bn_bwd_sums(const void* x, const void* dy,
                                const void* mean, const void* rstd,
                                void* partials, int64_t capacity,
                                void* sums, int64_t M, int64_t C, int dtype,
                                void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return bn_sums_typed<float>(x, dy, mu, r, pt, capacity, out, M, C, s);
  if (dtype == 1)
    return bn_sums_typed<__nv_bfloat16>(x, dy, mu, r, pt, capacity, out, M,
                                        C, s);
  if (dtype == 2)
    return bn_sums_typed<__half>(x, dy, mu, r, pt, capacity, out, M, C, s);
  return (int)cudaErrorInvalidValue;
}

// dx = (a * dy + d * x) + e per channel. x, dy, dx: [M, C] of `dtype`;
// a, d, e: f32 [C]. One launch on `stream`. Returns the cudaError_t.
extern "C" int dl4j_bn_bwd_dx(const void* x, const void* dy, void* dx,
                              const void* a, const void* d, const void* e,
                              int64_t M, int64_t C, int dtype,
                              void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  const float* ef = static_cast<const float*>(e);
  if (dtype == 0) return bn_dx_typed<float>(x, dy, dx, af, df, ef, M, C, s);
  if (dtype == 1)
    return bn_dx_typed<__nv_bfloat16>(x, dy, dx, af, df, ef, M, C, s);
  if (dtype == 2) return bn_dx_typed<__half>(x, dy, dx, af, df, ef, M, C, s);
  return (int)cudaErrorInvalidValue;
}
