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
// Bound: bytes. Pass 1 reads x and dy (8 bytes an element in f32, 4 in
// 16 bit), pass 2 reads them again and writes dx (12 bytes an element in
// f32, 6 in 16 bit), for a handful of operations an element: two passes
// is the least this formulation needs, since every dx depends on sums
// over all rows.
//
// Pass 1 (bn_bwd_sums) is one launch a site on column_reduce_sm90.cuh:
// a grid of row chunks x channel tiles fixed by (M, C, dtype), each
// thread's 16-byte row vectors of x and dy in flight as raw vectors
// converted at use, mean and rstd loaded once a thread, 32-bit indices
// where M * C < 2^30; the blocks' partials meet through integer tickets
// (the last block of each group of chunks sums them in chunk order), so
// there is no finalize launch and no float atomic, and two launches give
// the same bits. Its first design (column_reduce.cuh,
// which kernel 2 still uses) paid a second launch, an
// eight-wave grid and a log2(rows) shared-memory tree a site: a fixed
// cost that set the pace of the small sites.
//
// Pass 2 (bn_dx_kernel) is elementwise and bitwise equal to the plain
// PyTorch version: each product and sum rounded on its own, in the order
// (A*dy + D*x) + E, one cast. A thread owns one group of VEC neighbouring
// channels for its whole life (one 16-byte vector: 8 channels in 16 bit,
// 4 in f32) and loads that group's A, D and E into registers once; the
// block's threads span the channel groups along x and rows along y, a
// second grid dimension takes further channel tiles where C / VEC
// exceeds a block's width (C = 2048 in f32), and each thread walks rows
// with four independent 16-byte loads of x and of dy in flight (kept as
// raw vectors and converted at use, registers capped so that three
// blocks fit a SM; the grid is what stays resident, no tail wave), on
// 32-bit indices where M * C < 2^30. So the load units see two data
// loads and one store a vector and no division or coefficient load: at
// wide C in 16 bit, three coefficient loads an element (24 beside 3 data
// accesses a vector) set the pace below the memory's. Where C % VEC != 0
// or a pointer is misaligned, the same kernel runs with VEC = 1 (scalar
// accesses, the same rounding).
//
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "column_reduce.cuh"
#include "column_reduce_sm90.cuh"

namespace {

// One row of x and dy for VEC channels, as loaded: two raw 16-byte
// vectors, or VEC elements each
template <typename T, int VEC, bool kVector = VEC * sizeof(T) == 16>
struct BnSumsRaw {
  uint4 x, dy;
};
template <typename T, int VEC>
struct BnSumsRaw<T, VEC, false> {
  T x[VEC], dy[VEC];
};

// Kernel 5's plan on column_reduce_sm90.cuh: two 16-byte vectors a row,
// so 4 rows in flight keep 128 bytes a thread in flight; groups of 16
// chunks, scalar partial loads.
struct BnSumsPlan {
  static constexpr int kRows = 4;
  static constexpr int kGroup = 16;
  static constexpr int kFinalVec = 1;
};

template <typename T, int VEC, typename I>
struct BnSumsOp {
  using Plan = BnSumsPlan;
  using Raw = BnSumsRaw<T, VEC>;
  const T* x;
  const T* dy;
  const float* mean;
  const float* rstd;
  I C;
  float mu[VEC], r[VEC];
  __device__ __forceinline__ void begin(I c0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mu[v] = __ldg(mean + c0 + v);
      r[v] = __ldg(rstd + c0 + v);
    }
  }
  __device__ __forceinline__ void load(I row_i, I c0, Raw& raw) const {
    const I off = row_i * C + c0;
    if constexpr (VEC * sizeof(T) == 16) {
      raw.x = __ldg(reinterpret_cast<const uint4*>(x + off));
      raw.dy = __ldg(reinterpret_cast<const uint4*>(dy + off));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        raw.x[v] = x[off + v];
        raw.dy[v] = dy[off + v];
      }
    }
  }
  __device__ __forceinline__ void fold(const Raw& raw, float (&s0)[VEC],
                                       float (&s1)[VEC]) const {
    const T* xe = reinterpret_cast<const T*>(&raw.x);
    const T* de = reinterpret_cast<const T*>(&raw.dy);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float dv = dl4j::to_f(de[v]);
      const float xhat =
          __fmul_rn(__fsub_rn(dl4j::to_f(xe[v]), mu[v]), r[v]);
      s0[v] = __fadd_rn(s0[v], dv);
      s1[v] = __fadd_rn(s1[v], __fmul_rn(dv, xhat));
    }
  }
};

template <typename T, int VEC, typename I>
int bn_sums_launch(const T* x, const T* dy, const float* mean,
                   const float* rstd, const dl4j::sm90::Geom& g,
                   float* work, float* sums, int64_t M, int64_t C,
                   cudaStream_t stream) {
  return dl4j::sm90::launch_column_sums<VEC, BnSumsOp<T, VEC, I>, I>(
      BnSumsOp<T, VEC, I>{x, dy, mean, rstd, (I)C, {}, {}}, g, work, sums,
      M, C, stream);
}

template <typename T>
int bn_sums_typed(const void* x, const void* dy, const float* mean,
                  const float* rstd, float* work, int64_t capacity,
                  float* sums, int64_t M, int64_t C, cudaStream_t stream) {
  const bool aligned = dl4j::aligned16(x) && dl4j::aligned16(dy);
  const dl4j::sm90::Geom g =
      dl4j::sm90::geom<BnSumsPlan>(M, C, sizeof(T), aligned);
  if (dl4j::sm90::workspace_floats(g, C) > capacity)
    return (int)cudaErrorInvalidValue;
  constexpr int kFull = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (g.vec == kFull)
    return g.wide_index
               ? bn_sums_launch<T, kFull, int64_t>(xt, dyt, mean, rstd, g,
                                                   work, sums, M, C, stream)
               : bn_sums_launch<T, kFull, int32_t>(xt, dyt, mean, rstd, g,
                                                   work, sums, M, C, stream);
  return g.wide_index
             ? bn_sums_launch<T, 1, int64_t>(xt, dyt, mean, rstd, g, work,
                                             sums, M, C, stream)
             : bn_sums_launch<T, 1, int32_t>(xt, dyt, mean, rstd, g, work,
                                             sums, M, C, stream);
}

// ---------------------------------------------------------------------------
// pass 2: dx = (A * dy + D * x) + E, channel groups held in registers
// ---------------------------------------------------------------------------
constexpr int kDxThreads = 256;
constexpr int kDxUnroll = 4;      // row vectors in flight a thread
constexpr int kDxMinBlocks = 3;   // registers capped at 85: 3 blocks a SM

// 16 bytes of VEC elements rounded from f32 (round to nearest even, two
// at a time in 16 bit: the same bits as one conversion each).
template <typename T, int VEC>
__device__ __forceinline__ uint4 pack16(const float (&v)[VEC]) {
  uint4 raw;
  if constexpr (std::is_same<T, float>::value) {
    raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      if constexpr (std::is_same<T, __half>::value) {
        __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<uint32_t*>(&h);
      } else {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<uint32_t*>(&h);
      }
    }
  }
  return raw;
}

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kDxThreads, kDxMinBlocks)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             T* __restrict__ dx, const float* __restrict__ a,
             const float* __restrict__ d, const float* __restrict__ e,
             I M, I C) {
  const I c0 = ((I)blockIdx.y * (I)blockDim.x + (I)threadIdx.x) * VEC;
  if (c0 >= C) return;
  float av[VEC], dv[VEC], ev[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    av[v] = __ldg(a + c0 + v);
    dv[v] = __ldg(d + c0 + v);
    ev[v] = __ldg(e + c0 + v);
  }
  const I step = (I)gridDim.x * (I)blockDim.y;
  for (I r = (I)blockIdx.x * (I)blockDim.y + (I)threadIdx.y; r < M;
       r += kDxUnroll * step) {
    if constexpr (VEC * sizeof(T) == 16) {
      // the rows' raw vectors first (8 loads in flight), converted at use
      uint4 xr[kDxUnroll], gr[kDxUnroll];
#pragma unroll
      for (int u = 0; u < kDxUnroll; ++u) {
        const I row = r + u * step;
        if (row < M) {
          xr[u] = __ldg(reinterpret_cast<const uint4*>(x + row * C + c0));
          gr[u] = __ldg(reinterpret_cast<const uint4*>(dy + row * C + c0));
        }
      }
#pragma unroll
      for (int u = 0; u < kDxUnroll; ++u) {
        const I row = r + u * step;
        if (row < M) {
          const T* xe = reinterpret_cast<const T*>(&xr[u]);
          const T* ge = reinterpret_cast<const T*>(&gr[u]);
          float out[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            out[v] = __fadd_rn(
                __fadd_rn(__fmul_rn(av[v], dl4j::to_f(ge[v])),
                          __fmul_rn(dv[v], dl4j::to_f(xe[v]))),
                ev[v]);
          *reinterpret_cast<uint4*>(dx + row * C + c0) =
              pack16<T, VEC>(out);
        }
      }
    } else {
      float xv[kDxUnroll][VEC], gv[kDxUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kDxUnroll; ++u) {
        const I row = r + u * step;
        if (row < M) {
          dl4j::load_vec<T, VEC>(x + row * C + c0, xv[u]);
          dl4j::load_vec<T, VEC>(dy + row * C + c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kDxUnroll; ++u) {
        const I row = r + u * step;
        if (row < M) {
          float out[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            out[v] = __fadd_rn(__fadd_rn(__fmul_rn(av[v], gv[u][v]),
                                         __fmul_rn(dv[v], xv[u][v])),
                               ev[v]);
          dl4j::store_vec<T, VEC>(dx + row * C + c0, out);
        }
      }
    }
  }
}

// Blocks of one instantiation that fit on a SM at once (queried once).
template <typename T, int VEC, typename I>
int dx_blocks_per_sm() {
  static const int n = [] {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, bn_dx_kernel<T, VEC, I>, kDxThreads, 0) != cudaSuccess ||
        b < 1) {
      cudaGetLastError();
      b = 1;
    }
    return b;
  }();
  return n;
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

// The block and grid of pass 2: bx threads across the C / vec channel
// groups (at most a block's width), by = kDxThreads / bx across rows;
// grid.y channel tiles, grid.x row blocks: as many as stay resident on
// the card at once (no tail wave), or fewer where M is short.
struct DxGeom {
  int vec, bx, by;
  int64_t row_blocks, ctiles;
  bool wide_index;
};

template <typename T>
DxGeom dx_geom(int64_t M, int64_t C, bool aligned) {
  constexpr int kFull = 16 / sizeof(T);
  DxGeom g;
  g.vec = (C % kFull == 0 && aligned) ? kFull : 1;
  const int64_t groups = C / g.vec;
  g.bx = (int)(groups < kDxThreads ? groups : kDxThreads);
  g.by = kDxThreads / g.bx;
  g.ctiles = (groups + g.bx - 1) / g.bx;
  // 32-bit indices leave room for a row index stepping past M
  g.wide_index = M * C >= (int64_t(1) << 30);
  const int per_sm =
      g.vec == kFull
          ? (g.wide_index ? dx_blocks_per_sm<T, kFull, int64_t>()
                          : dx_blocks_per_sm<T, kFull, int32_t>())
          : (g.wide_index ? dx_blocks_per_sm<T, 1, int64_t>()
                          : dx_blocks_per_sm<T, 1, int32_t>());
  int64_t per = (int64_t)sm_count() * per_sm / g.ctiles;
  if (per < 1) per = 1;
  const int64_t need = (M + (int64_t)g.by * kDxUnroll - 1) /
                       ((int64_t)g.by * kDxUnroll);
  g.row_blocks = need < per ? need : per;
  return g;
}

template <typename T, int VEC>
void launch_dx(const DxGeom& g, const T* x, const T* dy, T* dx,
               const float* a, const float* d, const float* e, int64_t M,
               int64_t C, cudaStream_t stream) {
  const dim3 grid((unsigned)g.row_blocks, (unsigned)g.ctiles);
  const dim3 block((unsigned)g.bx, (unsigned)g.by);
  if (g.wide_index)
    bn_dx_kernel<T, VEC, int64_t><<<grid, block, 0, stream>>>(
        x, dy, dx, a, d, e, M, C);
  else
    bn_dx_kernel<T, VEC, int32_t><<<grid, block, 0, stream>>>(
        x, dy, dx, a, d, e, (int32_t)M, (int32_t)C);
}

template <typename T>
int bn_dx_typed(const void* x, const void* dy, void* dx, const float* a,
                const float* d, const float* e, int64_t M, int64_t C,
                cudaStream_t stream) {
  const bool aligned = dl4j::aligned16(x) && dl4j::aligned16(dy) &&
                       dl4j::aligned16(dx);
  const DxGeom g = dx_geom<T>(M, C, aligned);
  if (g.ctiles > 65535) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  constexpr int kFull = 16 / sizeof(T);
  if (g.vec == kFull)
    launch_dx<T, kFull>(g, xt, dyt, dxt, a, d, e, M, C, stream);
  else
    launch_dx<T, 1>(g, xt, dyt, dxt, a, d, e, M, C, stream);
  return (int)cudaGetLastError();
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Floats of the f32 workspace dl4j_bn_bwd_sums needs for an [M, C] input
// of `dtype` (0 = float32, 1 = bfloat16, 2 = float16).
extern "C" int64_t dl4j_bn_sums_workspace(int64_t M, int64_t C, int dtype) {
  if (M <= 0 || C <= 0) return 0;
  return dl4j::sm90::workspace_floats(
      dl4j::sm90::geom<BnSumsPlan>(M, C, elem_bytes(dtype), true), C);
}

// sums[2, C] = (sum dy, sum dy * (x - mean) * rstd). x, dy: [M, C] of
// `dtype`; mean, rstd: f32 [C]; work: `capacity` f32 floats
// (dl4j_bn_sums_workspace); sums: f32 [2, C]. One launch on `stream`; no
// synchronisation, no allocation. Returns the cudaError_t (0 on success).
extern "C" int dl4j_bn_bwd_sums(const void* x, const void* dy,
                                const void* mean, const void* rstd,
                                void* work, int64_t capacity, void* sums,
                                int64_t M, int64_t C, int dtype,
                                void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* wk = static_cast<float*>(work);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return bn_sums_typed<float>(x, dy, mu, r, wk, capacity, out, M, C, s);
  if (dtype == 1)
    return bn_sums_typed<__nv_bfloat16>(x, dy, mu, r, wk, capacity, out, M,
                                        C, s);
  if (dtype == 2)
    return bn_sums_typed<__half>(x, dy, mu, r, wk, capacity, out, M, C, s);
  return (int)cudaErrorInvalidValue;
}

// The geometry dl4j_bn_bwd_sums takes for these arguments, as text in
// `out` (at most `len` bytes with its terminating 0). Launches nothing.
extern "C" int dl4j_bn_bwd_sums_describe(const void* x, const void* dy,
                                         int64_t M, int64_t C, int dtype,
                                         char* out, int len) {
  if (M <= 0 || C <= 0 || dtype < 0 || dtype > 2 || len <= 0)
    return (int)cudaErrorInvalidValue;
  const dl4j::sm90::Geom g = dl4j::sm90::geom<BnSumsPlan>(
      M, C, elem_bytes(dtype), dl4j::aligned16(x) && dl4j::aligned16(dy));
  dl4j::sm90::describe(g, BnSumsPlan::kRows, out, len);
  return 0;
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

// The geometry dl4j_bn_bwd_dx takes for these arguments, as text in `out`
// (at most `len` bytes with its terminating 0). Launches nothing.
extern "C" int dl4j_bn_bwd_dx_describe(const void* x, const void* dy,
                                       const void* dx, int64_t M, int64_t C,
                                       int dtype, char* out, int len) {
  if (M <= 0 || C <= 0 || dtype < 0 || dtype > 2 || len <= 0)
    return (int)cudaErrorInvalidValue;
  const bool aligned = dl4j::aligned16(x) && dl4j::aligned16(dy) &&
                       dl4j::aligned16(dx);
  const DxGeom g = dtype == 0   ? dx_geom<float>(M, C, aligned)
                   : dtype == 1 ? dx_geom<__nv_bfloat16>(M, C, aligned)
                                : dx_geom<__half>(M, C, aligned);
  snprintf(out, len, "%s: %d channels a thread, block %dx%d, grid %lldx%lld, "
           "%s indices", g.vec > 1 ? "16-byte vectors" : "scalar", g.vec,
           g.bx, g.by, (long long)g.row_blocks, (long long)g.ctiles,
           g.wide_index ? "64-bit" : "32-bit");
  return 0;
}
