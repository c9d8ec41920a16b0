// Flash attention, forward and backward, over contiguous [b*h, t, d]
// queries, keys and values with an optional [b, tk] key mask:
//
//   dl4j_flash_fwd      replaces deeplearning4j_tpu/parallel/sequence.py:
//                       _flash_kernel (launched by _flash_forward):
//                       out = softmax(q k^T / sqrt(d), masked) v, and the
//                       per-row log-sum-exp of the scaled scores;
//   dl4j_flash_bwd_dq   replaces sequence.py:_flash_bwd_dq_kernel:
//                       dq = sum_k p (dO v^T - delta) k / sqrt(d), with p
//                       recomputed from the saved log-sum-exp;
//   dl4j_flash_bwd_dkv  replaces sequence.py:_flash_bwd_dkv_kernel:
//                       dv = p^T dO, dk = ds^T q / sqrt(d).
//
// delta = rowsum(dO * O) - g_lse is the caller's (a few torch ops), as it
// is plain jnp outside the Pallas kernels in the JAX package.
//
// Semantics kept from the TPU kernels: masked scores are NEG_INF = -1e30
// and the exp of a score <= NEG_INF / 2 is exactly 0, so a fully masked
// row has l = 0, an output of exact zeros (l is clamped to 1e-30) and zero
// gradients; the causal mask compares positions q >= k from 0 in both
// sequences, and key tiles wholly in a query tile's future are skipped
// (exact: they would add p = 0 and a correction of 1); a key is kept where
// mask > 0; p is rounded to v's type before p v (to dO's before p^T dO),
// ds to k's before ds k and to q's before ds^T q; every sum is f32
// (f64 for f64 inputs).
//
// Work split, as the JAX package splits it: the forward and dq take one
// block per (b*h, query tile) and loop over key tiles with the running
// max, sum and accumulator in registers; dk/dv take one block per (b*h,
// key tile) and loop over query tiles. Each output element is written
// once: no float atomics, so two launches give the same bits. Rows and
// columns past t and d are zero in shared memory and masked from the
// softmax, so any t and any d run (d is padded to 32, 64, 128 or 256 in
// shared memory up to 256, and streamed in chunks past it).
//
// Bound: operations in f32, bytes in 16 bit. At BERT-base's sites (t =
// 128, d = 64) the forward does 4 t^2 d FLOPs for 4 t d elements moved:
// about 128 FLOPs a byte in f32, above the card's 20 at the f32 FMA rate
// (67 TFLOP/s over 3.35 TB/s), and 256 a byte in bf16, below its 295 at
// the tensor cores' 989 TFLOP/s. So the paths differ by input type:
//
//   * bf16 / f16, d <= 128, forward, dq and dk/dv: tensor cores
//     (mma.sync m16n8k16, f32 accumulation; products of 16-bit inputs are
//     exact), FlashAttention-2's split of 4 warps x 16 rows, K/V (Q/dO)
//     tiles of 64 through a two-stage cp.async ring, scores and gradients
//     kept in the accumulator fragments, P and dS repacked to A fragments
//     in registers (flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel,
//     flash_bwd_dkv_mma_kernel);
//   * f32, d <= 128, forward, dq and dk/dv: full f32 FMAs (no TF32), 256
//     threads each owning a 4 x 4 patch of the score tile, every operand
//     read four d steps at a time by 16-byte shared loads from tiles
//     staged by cp.async (double-buffered in the forward; one buffer and
//     two blocks an SM in dq and dk/dv) (flash_fwd_f32_kernel,
//     flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel);
//   * all three at d in (128, 256]: the first version's SIMT bodies (f32
//     FMAs for every type, one 4-byte shared load per 2 FMAs, tiles
//     reloaded on one stage): left for a later redesign;
//   * all three at d > 256 in every type, and at every d in f64: the wide
//     SIMT bodies (sums in f32, in f64 for f64), which stream d in chunks
//     of 32 through shared memory and split the output's d over blocks
//     (flash_fwd_wide_kernel, flash_bwd_dq_wide_kernel,
//     flash_bwd_dkv_wide_kernel): a first version, left for a redesign.
//
// Every path keeps the semantics above, and each output is written once
// after a fixed sequence of f32 (f64) operations (no split over the
// reduction, no float atomics). wgmma and TMA are for a later version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;  // 16 x 16 threads over a score tile
constexpr int kSide = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T's precision (round to nearest even), as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + R) of a contiguous [t, d] matrix into shared memory
// as f32 with row stride `stride`; zero past t rows and d columns.
template <typename T, int R, int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int t, int d) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int row = row0 + r;
    float v = 0.f;
    if (row < t && c < d) v = to_f(src[(int64_t)row * d + c]);
    dst[r * stride + c] = v;
  }
}

// Shared-memory layout. A tile read by rows (each thread's own rows,
// broadcast across a half-warp) has stride DP + 4, so the two half-warps'
// rows fall in different banks; a tile read by columns (16 threads on 16
// neighbouring rows) has stride DP + 1; score tiles have stride B + 1.
template <int DP>
struct Strides {
  static constexpr int kRow = DP + 4;
  static constexpr int kCol = DP + 1;
};

template <int DP, int BQ, int BK>
constexpr int fwd_smem_floats() {
  return BQ * Strides<DP>::kRow + 2 * BK * Strides<DP>::kCol +
         BQ * (BK + 1);
}
template <int DP, int BQ, int BK>
constexpr int dq_smem_floats() {
  return 2 * BQ * Strides<DP>::kRow + 2 * BK * Strides<DP>::kCol +
         BQ * (BK + 1);
}
template <int DP, int BQ, int BK>
constexpr int dkv_smem_floats() {
  return 2 * BK * Strides<DP>::kRow + 2 * BQ * Strides<DP>::kCol +
         2 * BK * (BQ + 1) + 2 * BQ;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* mask;  // [b, tk] f32, or null
  void* out;          // forward: out; dq: dq; dkv: dk
  void* out2;         // dkv: dv
  float* lse_out;     // forward: [b*h, tq] f32
  int64_t bh;
  int heads, tq, tk, d;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// The first version's SIMT bodies: kernels 7, 8 and 9 at d in (128, 256].
// ---------------------------------------------------------------------------
// kernel 7: forward
// ---------------------------------------------------------------------------
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int heads,
                 int tq, int tk, int d, float scale, int causal) {
  constexpr int RQ = BQ / kSide, RK = BK / kSide, CD = DP / kSide;
  constexpr int AS = Strides<DP>::kRow, BS = Strides<DP>::kCol;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][AS]
  float* Ks = Qs + BQ * AS;     // [BK][BS]
  float* Vs = Ks + BK * BS;     // [BK][BS]
  float* Ps = Vs + BK * BS;     // [BQ][PS]

  const int n_qt = (tq + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * BQ;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;

  load_tile<T, BQ, DP>(Qs, AS, qb, q0, tq, d);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, BK, DP>(Ks, BS, kb, k0, tk, d);
    load_tile<T, BK, DP>(Vs, BS, vb, k0, tk, d);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float a[RQ], b[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty * RQ + i) * AS + dd];
#pragma unroll
      for (int j = 0; j < RK; ++j) b[j] = Ks[(tx + kSide * j) * BS + dd];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    bool keep_k[RK];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int kj = k0 + tx + kSide * j;
      keep_k[j] = kj < tk && (mb == nullptr || mb[kj] > 0.f);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = k0 + tx + kSide * j;
        const bool keep = keep_k[j] && (!causal || qi >= kj);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = row_max16(mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p =
            s[i][j] <= kNegInf * 0.5f ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * RQ + i) * PS + tx + kSide * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * BS + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty * RQ + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + (bh * tq + qi) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kSide * c;
      if (col < d) orow[col] = from_f<T>(acc[i][c] / lc);
    }
    if (tx == 0) lse[bh * tq + qi] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// kernel 8: dq
// ---------------------------------------------------------------------------
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    int heads, int tq, int tk, int d, float scale,
                    int causal) {
  constexpr int RQ = BQ / kSide, RK = BK / kSide, CD = DP / kSide;
  constexpr int AS = Strides<DP>::kRow, BS = Strides<DP>::kCol;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][AS]
  float* Os = Qs + BQ * AS;      // dO [BQ][AS]
  float* Ks = Os + BQ * AS;      // [BK][BS]
  float* Vs = Ks + BK * BS;      // [BK][BS]
  float* Ds = Vs + BK * BS;      // ds [BQ][PS]

  const int n_qt = (tq + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * BQ;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;

  load_tile<T, BQ, DP>(Qs, AS, q + bh * tq * d, q0, tq, d);
  load_tile<T, BQ, DP>(Os, AS, dout + bh * tq * d, q0, tq, d);

  float lse_r[RQ], delta_r[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    lse_r[i] = qi < tq ? lse[bh * tq + qi] : 0.f;
    delta_r[i] = qi < tq ? delta[bh * tq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, BK, DP>(Ks, BS, kb, k0, tk, d);
    load_tile<T, BK, DP>(Vs, BS, vb, k0, tk, d);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float a[RQ], o[RQ], kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = Qs[(ty * RQ + i) * AS + dd];
        o[i] = Os[(ty * RQ + i) * AS + dd];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kv[j] = Ks[(tx + kSide * j) * BS + dd];
        vv[j] = Vs[(tx + kSide * j) * BS + dd];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(a[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int kj = k0 + tx + kSide * j;
      const bool keep_k = kj < tk && (mb == nullptr || mb[kj] > 0.f);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = q0 + ty * RQ + i;
        const bool keep = keep_k && (!causal || qi >= kj);
        const float sv = keep ? s[i][j] * scale : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.f : expf(sv - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]);
        Ds[(ty * RQ + i) * PS + tx + kSide * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    float part[RQ][CD];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) part[i][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * BS + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float g = Ds[(ty * RQ + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) part[i][c] = fmaf(g, kv[c], part[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] += part[i][c] * scale;
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= tq) continue;
    T* row = dq + (bh * tq + qi) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kSide * c;
      if (col < d) row[col] = from_f<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 9: dk and dv. Thread (ty, tx) owns key rows ty * RK + i of the
// tile and query columns tx + 16 j of each query tile.
// ---------------------------------------------------------------------------
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int tq, int tk, int d,
                     float scale, int causal) {
  constexpr int RQ = BQ / kSide, RK = BK / kSide, CD = DP / kSide;
  constexpr int AS = Strides<DP>::kRow, BS = Strides<DP>::kCol;
  constexpr int PS = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][AS]
  float* Vs = Ks + BK * AS;      // [BK][AS]
  float* Qs = Vs + BK * AS;      // [BQ][BS]
  float* Os = Qs + BQ * BS;      // dO [BQ][BS]
  float* Pt = Os + BQ * BS;      // p^T [BK][PS]
  float* Dt = Pt + BK * PS;      // ds^T [BK][PS]
  float* lse_s = Dt + BK * PS;   // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int n_kt = (tk + BK - 1) / BK;
  const int64_t bh = blockIdx.x / n_kt;
  const int k0 = (int)(blockIdx.x % n_kt) * BK;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + bh * tq * d;
  const T* ob = dout + bh * tq * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;

  load_tile<T, BK, DP>(Ks, AS, k + bh * tk * d, k0, tk, d);
  load_tile<T, BK, DP>(Vs, AS, v + bh * tk * d, k0, tk, d);

  bool keep_k[RK];
  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kk = k0 + ty * RK + i;
    keep_k[i] = kk < tk && (mb == nullptr || mb[kk] > 0.f);
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // query tiles wholly before this key tile see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < tq; q0 += BQ) {
    __syncthreads();
    load_tile<T, BQ, DP>(Qs, BS, qb, q0, tq, d);
    load_tile<T, BQ, DP>(Os, BS, ob, q0, tq, d);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int qi = q0 + r;
      lse_s[r] = qi < tq ? lse[bh * tq + qi] : 0.f;
      delta_s[r] = qi < tq ? delta[bh * tq + qi] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ], dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float kr[RK], vr[RK], qc[RQ], oc[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kr[i] = Ks[(ty * RK + i) * AS + dd];
        vr[i] = Vs[(ty * RK + i) * AS + dd];
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        qc[j] = Qs[(tx + kSide * j) * BS + dd];
        oc[j] = Os[(tx + kSide * j) * BS + dd];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          // q * k in the forward's operand order: the same score bits
          s[i][j] = fmaf(qc[j], kr[i], s[i][j]);
          dp[i][j] = fmaf(oc[j], vr[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const int qc_i = tx + kSide * j;
      const int qi = q0 + qc_i;
      const float lse_j = lse_s[qc_i], delta_j = delta_s[qc_i];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kk = k0 + ty * RK + i;
        const bool keep = keep_k[i] && qi < tq && (!causal || qi >= kk);
        const float sv = keep ? s[i][j] * scale : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.f : expf(sv - lse_j);
        const float ds = p * (dp[i][j] - delta_j);
        Pt[(ty * RK + i) * PS + qc_i] = round_to<T>(p);
        Dt[(ty * RK + i) * PS + qc_i] = round_to<T>(ds);
      }
    }
    __syncthreads();

    float part[RK][CD];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) part[i][c] = 0.f;
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float oc[CD], qc[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        oc[c] = Os[qq * BS + tx + kSide * c];
        qc[c] = Qs[qq * BS + tx + kSide * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float p = Pt[(ty * RK + i) * PS + qq];
        const float g = Dt[(ty * RK + i) * PS + qq];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] = fmaf(p, oc[c], dv_acc[i][c]);
          part[i][c] = fmaf(g, qc[c], part[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) dk_acc[i][c] += part[i][c] * scale;
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kk = k0 + ty * RK + i;
    if (kk >= tk) continue;
    T* krow = dk + (bh * tk + kk) * d;
    T* vrow = dv + (bh * tk + kk) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kSide * c;
      if (col < d) {
        krow[col] = from_f<T>(dk_acc[i][c]);
        vrow[col] = from_f<T>(dv_acc[i][c]);
      }
    }
  }
}

// ===========================================================================
// d > 256, and float64 at every d: the wide SIMT bodies
// ===========================================================================
// Neither the tiles nor the accumulators of the bodies above fit past
// d = 256, so here shared memory does not grow with d: the reduction over
// d that makes a score runs in chunks of kWideDc columns staged through
// shared memory, and a grid axis splits the output columns into chunks
// of kWideDo. Each block recomputes its tile's scores over the whole of
// d, so every block of a row computes the same scores, maxima and sums
// in the same order, and each output element is still written once.
// Sums are in the accumulation type A: f32 for f32 / bf16 / f16 inputs,
// f64 for f64 (whose lse and delta rows are f64 too). A first version:
// the score work is repeated once per output chunk (d / 128 times), and
// every load is a 4- or 8-byte one.
constexpr int kWideB = 32;    // query rows and key rows of a tile
constexpr int kWideDc = 32;   // d columns of a staged score chunk
constexpr int kWideDo = 128;  // output columns a block owns

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ float a_exp(float v) { return expf(v); }
__device__ __forceinline__ double a_exp(double v) { return exp(v); }
__device__ __forceinline__ float a_log(float v) { return logf(v); }
__device__ __forceinline__ double a_log(double v) { return log(v); }
__device__ __forceinline__ float a_max(float x, float y) {
  return fmaxf(x, y);
}
__device__ __forceinline__ double a_max(double x, double y) {
  return fmax(x, y);
}
__device__ __forceinline__ float a_fma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double a_fma(double x, double y, double z) {
  return fma(x, y, z);
}

// T -> A and back: f64 passes through, the other types as above
template <typename A, typename T>
__device__ __forceinline__ A to_a(T v) {
  return static_cast<A>(to_f(v));
}
template <>
__device__ __forceinline__ double to_a<double, double>(double v) {
  return v;
}
template <typename T, typename A>
__device__ __forceinline__ T from_a(A v) {
  return from_f<T>(static_cast<float>(v));
}
template <>
__device__ __forceinline__ double from_a<double, double>(double v) {
  return v;
}
template <typename T, typename A>
__device__ __forceinline__ A round_a(A v) {
  return to_a<A>(from_a<T>(v));
}

template <typename A>
__device__ __forceinline__ A row_max16a(A v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = a_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename A>
__device__ __forceinline__ A row_sum16a(A v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + R) and columns [col0, col0 + C) of a contiguous
// [t, d] matrix into shared memory as A with row stride `stride`; zero
// past t rows and d columns.
template <typename A, typename T, int R, int C>
__device__ __forceinline__ void load_chunk(A* dst, int stride,
                                           const T* __restrict__ src,
                                           int row0, int t, int col0,
                                           int d) {
  for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
    const int r = idx / C;
    const int c = idx % C;
    const int row = row0 + r, col = col0 + c;
    A v = A(0);
    if (row < t && col < d) v = to_a<A>(src[(int64_t)row * d + col]);
    dst[r * stride + c] = v;
  }
}

// Shared-memory strides of the wide bodies: score chunks read by rows
// (kWideRow) or by columns (kWideCol), score tiles (kWideP); output
// chunks are read along their rows, unpadded.
constexpr int kWideRow = kWideDc + 4;
constexpr int kWideCol = kWideDc + 1;
constexpr int kWideP = kWideB + 1;

// The block's (b*h, tile, output chunk) from blockIdx.x
struct WideBlock {
  int64_t bh;
  int r0, c0, oc;
};
__device__ __forceinline__ WideBlock wide_block(int t, int d) {
  const int n_t = (t + kWideB - 1) / kWideB;
  const int n_oc = (d + kWideDo - 1) / kWideDo;
  const int oc = (int)(blockIdx.x % n_oc);
  const int64_t rest = blockIdx.x / n_oc;
  return {rest / n_t, (int)(rest % n_t) * kWideB, oc * kWideDo, oc};
}

// ---------------------------------------------------------------------------
// kernel 7, wide
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ out,
                      typename AccOf<T>::type* __restrict__ lse, int heads,
                      int tq, int tk, int d, typename AccOf<T>::type scale,
                      int causal) {
  using A = typename AccOf<T>::type;
  constexpr int B = kWideB, DC = kWideDc, DO = kWideDo;
  constexpr int R = B / kSide, CD = DO / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Qs = reinterpret_cast<A*>(smem_raw);  // [B][kWideRow]
  A* Ks = Qs + B * kWideRow;               // [B][kWideCol]
  A* Vs = Ks + B * kWideCol;               // [B][DO]
  A* Ps = Vs + B * DO;                     // [B][kWideP]

  const WideBlock wb = wide_block(tq, d);
  const int64_t bh = wb.bh;
  const int q0 = wb.r0, c0 = wb.c0;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const A neg = A(-1e30);  // kNegInf, and exact in f64

  A m[R], l[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = neg;
    l[i] = A(0);
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = A(0);
  }

  const int k_end = causal ? min(tk, q0 + B) : tk;
  for (int k0 = 0; k0 < k_end; k0 += B) {
    A s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = A(0);
    for (int d0 = 0; d0 < d; d0 += DC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      load_chunk<A, T, B, DC>(Qs, kWideRow, qb, q0, tq, d0, d);
      load_chunk<A, T, B, DC>(Ks, kWideCol, kb, k0, tk, d0, d);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        A a[R], b[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = Qs[(ty * R + i) * kWideRow + dd];
#pragma unroll
        for (int j = 0; j < R; ++j)
          b[j] = Ks[(tx + kSide * j) * kWideCol + dd];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = a_fma(a[i], b[j], s[i][j]);
      }
    }
    // this key tile's V columns [c0, c0 + DO): the last reads of Vs and
    // Ps were before the chunk loop's barriers
    load_chunk<A, T, B, DO>(Vs, DO, vb, k0, tk, c0, d);

    bool keep_k[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + tx + kSide * j;
      keep_k[j] = kj < tk && (mb == nullptr || mb[kj] > 0.f);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
      A mx = m[i];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + kSide * j;
        const bool keep = keep_k[j] && (!causal || qi >= kj);
        s[i][j] = keep ? s[i][j] * scale : neg;
        mx = a_max(mx, s[i][j]);
      }
      const A m_new = row_max16a(mx);
      const A corr = a_exp(m[i] - m_new);
      A rs = A(0);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const A p = s[i][j] <= neg * A(0.5) ? A(0) : a_exp(s[i][j] - m_new);
        rs += p;
        Ps[(ty * R + i) * kWideP + tx + kSide * j] = round_a<T>(p);
      }
      l[i] = l[i] * corr + row_sum16a(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      A vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * DO + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const A p = Ps[(ty * R + i) * kWideP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = a_fma(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= tq) continue;
    const A lc = a_max(l[i], A(1e-30));
    T* orow = out + (bh * tq + qi) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = c0 + tx + kSide * c;
      if (col < d) orow[col] = from_a<T>(acc[i][c] / lc);
    }
    if (wb.oc == 0 && tx == 0) lse[bh * tq + qi] = m[i] + a_log(lc);
  }
}

// ---------------------------------------------------------------------------
// kernel 8, wide
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const typename AccOf<T>::type* __restrict__ lse,
                         const typename AccOf<T>::type* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dq,
                         int heads, int tq, int tk, int d,
                         typename AccOf<T>::type scale, int causal) {
  using A = typename AccOf<T>::type;
  constexpr int B = kWideB, DC = kWideDc, DO = kWideDo;
  constexpr int R = B / kSide, CD = DO / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Qs = reinterpret_cast<A*>(smem_raw);  // [B][kWideRow]
  A* Os = Qs + B * kWideRow;               // dO [B][kWideRow]
  A* Ks = Os + B * kWideRow;               // [B][kWideCol]
  A* Vs = Ks + B * kWideCol;               // [B][kWideCol]
  A* Ds = Vs + B * kWideCol;               // ds [B][kWideP]
  A* Kc = Ds + B * kWideP;                 // K's output columns [B][DO]

  const WideBlock wb = wide_block(tq, d);
  const int64_t bh = wb.bh;
  const int q0 = wb.r0, c0 = wb.c0;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + bh * tq * d;
  const T* ob = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const A neg = A(-1e30);  // kNegInf, and exact in f64

  A lse_r[R], delta_r[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    lse_r[i] = qi < tq ? lse[bh * tq + qi] : A(0);
    delta_r[i] = qi < tq ? delta[bh * tq + qi] : A(0);
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = A(0);
  }

  const int k_end = causal ? min(tk, q0 + B) : tk;
  for (int k0 = 0; k0 < k_end; k0 += B) {
    A s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = A(0);
    for (int d0 = 0; d0 < d; d0 += DC) {
      __syncthreads();
      load_chunk<A, T, B, DC>(Qs, kWideRow, qb, q0, tq, d0, d);
      load_chunk<A, T, B, DC>(Os, kWideRow, ob, q0, tq, d0, d);
      load_chunk<A, T, B, DC>(Ks, kWideCol, kb, k0, tk, d0, d);
      load_chunk<A, T, B, DC>(Vs, kWideCol, vb, k0, tk, d0, d);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        A a[R], o[R], kv[R], vv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = Qs[(ty * R + i) * kWideRow + dd];
          o[i] = Os[(ty * R + i) * kWideRow + dd];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          kv[j] = Ks[(tx + kSide * j) * kWideCol + dd];
          vv[j] = Vs[(tx + kSide * j) * kWideCol + dd];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = a_fma(a[i], kv[j], s[i][j]);
            dp[i][j] = a_fma(o[i], vv[j], dp[i][j]);
          }
      }
    }
    load_chunk<A, T, B, DO>(Kc, DO, kb, k0, tk, c0, d);

#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + tx + kSide * j;
      const bool keep_k = kj < tk && (mb == nullptr || mb[kj] > 0.f);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qi = q0 + ty * R + i;
        const bool keep = keep_k && (!causal || qi >= kj);
        const A sv = keep ? s[i][j] * scale : neg;
        const A p = sv <= neg * A(0.5) ? A(0) : a_exp(sv - lse_r[i]);
        const A ds = p * (dp[i][j] - delta_r[i]);
        Ds[(ty * R + i) * kWideP + tx + kSide * j] = round_a<T>(ds);
      }
    }
    __syncthreads();

    A part[R][CD];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) part[i][c] = A(0);
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      A kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Kc[kk * DO + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const A g = Ds[(ty * R + i) * kWideP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) part[i][c] = a_fma(g, kv[c], part[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] += part[i][c] * scale;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= tq) continue;
    T* row = dq + (bh * tq + qi) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = c0 + tx + kSide * c;
      if (col < d) row[col] = from_a<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 9, wide. Thread (ty, tx) owns key rows ty * R + i of the tile and
// query columns tx + 16 j of each query tile.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const typename AccOf<T>::type* __restrict__ lse,
                          const typename AccOf<T>::type* __restrict__ delta,
                          const float* __restrict__ mask,
                          T* __restrict__ dk, T* __restrict__ dv, int heads,
                          int tq, int tk, int d,
                          typename AccOf<T>::type scale, int causal) {
  using A = typename AccOf<T>::type;
  constexpr int B = kWideB, DC = kWideDc, DO = kWideDo;
  constexpr int R = B / kSide, CD = DO / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Ks = reinterpret_cast<A*>(smem_raw);  // [B][kWideRow]
  A* Vs = Ks + B * kWideRow;               // [B][kWideRow]
  A* Qs = Vs + B * kWideRow;               // [B][kWideCol]
  A* Os = Qs + B * kWideCol;               // dO [B][kWideCol]
  A* Pt = Os + B * kWideCol;               // p^T [B][kWideP]
  A* Dt = Pt + B * kWideP;                 // ds^T [B][kWideP]
  A* Qc = Dt + B * kWideP;                 // Q's output columns [B][DO]
  A* Oc = Qc + B * DO;                     // dO's output columns [B][DO]
  A* lse_s = Oc + B * DO;                  // [B]
  A* delta_s = lse_s + B;                  // [B]

  const WideBlock wb = wide_block(tk, d);
  const int64_t bh = wb.bh;
  const int k0 = wb.r0, c0 = wb.c0;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const T* qb = q + bh * tq * d;
  const T* ob = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const A neg = A(-1e30);  // kNegInf, and exact in f64

  bool keep_k[R];
  A dk_acc[R][CD], dv_acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = k0 + ty * R + i;
    keep_k[i] = kk < tk && (mb == nullptr || mb[kk] > 0.f);
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = A(0);
  }

  // query tiles wholly before this key tile see none of its keys
  const int q_begin = causal ? (k0 / B) * B : 0;
  for (int q0 = q_begin; q0 < tq; q0 += B) {
    A s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = A(0);
    for (int d0 = 0; d0 < d; d0 += DC) {
      __syncthreads();
      load_chunk<A, T, B, DC>(Ks, kWideRow, kb, k0, tk, d0, d);
      load_chunk<A, T, B, DC>(Vs, kWideRow, vb, k0, tk, d0, d);
      load_chunk<A, T, B, DC>(Qs, kWideCol, qb, q0, tq, d0, d);
      load_chunk<A, T, B, DC>(Os, kWideCol, ob, q0, tq, d0, d);
      if (d0 == 0) {
        for (int r = threadIdx.x; r < B; r += kThreads) {
          const int qi = q0 + r;
          lse_s[r] = qi < tq ? lse[bh * tq + qi] : A(0);
          delta_s[r] = qi < tq ? delta[bh * tq + qi] : A(0);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        A kr[R], vr[R], qc[R], oc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kr[i] = Ks[(ty * R + i) * kWideRow + dd];
          vr[i] = Vs[(ty * R + i) * kWideRow + dd];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qc[j] = Qs[(tx + kSide * j) * kWideCol + dd];
          oc[j] = Os[(tx + kSide * j) * kWideCol + dd];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            // q * k in the forward's operand order: the same score bits
            s[i][j] = a_fma(qc[j], kr[i], s[i][j]);
            dp[i][j] = a_fma(oc[j], vr[i], dp[i][j]);
          }
      }
    }
    load_chunk<A, T, B, DO>(Qc, DO, qb, q0, tq, c0, d);
    load_chunk<A, T, B, DO>(Oc, DO, ob, q0, tq, c0, d);

#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int qc_i = tx + kSide * j;
      const int qi = q0 + qc_i;
      const A lse_j = lse_s[qc_i], delta_j = delta_s[qc_i];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kk = k0 + ty * R + i;
        const bool keep = keep_k[i] && qi < tq && (!causal || qi >= kk);
        const A sv = keep ? s[i][j] * scale : neg;
        const A p = sv <= neg * A(0.5) ? A(0) : a_exp(sv - lse_j);
        const A ds = p * (dp[i][j] - delta_j);
        Pt[(ty * R + i) * kWideP + qc_i] = round_a<T>(p);
        Dt[(ty * R + i) * kWideP + qc_i] = round_a<T>(ds);
      }
    }
    __syncthreads();

    A part[R][CD];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) part[i][c] = A(0);
#pragma unroll 4
    for (int qq = 0; qq < B; ++qq) {
      A oc[CD], qc[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        oc[c] = Oc[qq * DO + tx + kSide * c];
        qc[c] = Qc[qq * DO + tx + kSide * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const A p = Pt[(ty * R + i) * kWideP + qq];
        const A g = Dt[(ty * R + i) * kWideP + qq];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] = a_fma(p, oc[c], dv_acc[i][c]);
          part[i][c] = a_fma(g, qc[c], part[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) dk_acc[i][c] += part[i][c] * scale;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = k0 + ty * R + i;
    if (kk >= tk) continue;
    T* krow = dk + (bh * tk + kk) * d;
    T* vrow = dv + (bh * tk + kk) * d;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = c0 + tx + kSide * c;
      if (col < d) {
        krow[col] = from_a<T>(dk_acc[i][c]);
        vrow[col] = from_a<T>(dv_acc[i][c]);
      }
    }
  }
}

// ===========================================================================
// bf16 / f16, d <= 128: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ===========================================================================
// FlashAttention-2's split: a block of 4 warps owns 64 rows (queries in
// kernels 7 and 8, keys in kernel 9), each warp 16 of them, and walks the
// other sequence in tiles of 64. Tiles are [64][DP + 8] in shared memory as
// they lie in device memory (d-contiguous rows, padded so the 8 row
// addresses of an ldmatrix fall in distinct banks), loaded through a
// two-stage cp.async ring: the next tile lands while this one is
// multiplied. Scores and gradients stay in the mma accumulators; a
// thread holds rows g and g + 8 (g = lane / 4) of its warp's 16, so row
// reductions run over the 4 threads of a quad. P (and dS) are rounded
// to the input type and repacked from accumulator fragments into A
// fragments in registers. Scores run in log2 units (the scale folded
// with log2 e), so each exponential is one exp2; the lse leaves in
// natural units. Where d % 8 != 0 or a pointer is not 16-byte aligned
// (VEC false), tiles are staged element by element instead.
constexpr int kMmaThreads = 128;
constexpr int kTile = 64;  // rows a block owns, and rows of a streamed tile

// A tile's row stride in elements: d padded by 16 bytes, which keeps rows
// 16-byte aligned and puts 8 neighbouring rows' 16-byte chunks in distinct
// banks (ldmatrix here, float4 loads on the f32 path).
template <typename T, int DP>
__host__ __device__ constexpr int tile_stride() {
  return DP + 16 / (int)sizeof(T);
}

// Rows [row0, row0 + 64) of a contiguous [t, d] matrix into
// dst[64][tile_stride]; zero past t rows and d columns. VEC: 16-byte
// cp.async chunks (d a multiple of the chunk, 16-byte aligned base).
template <typename T, int DP, int THREADS, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int row0, int t, int d) {
  constexpr int S = tile_stride<T, DP>();
  constexpr int kVec = 16 / (int)sizeof(T);
  if constexpr (VEC) {
    constexpr int kChunks = kTile * (DP / kVec);
#pragma unroll
    for (int c = threadIdx.x; c < kChunks; c += THREADS) {
      const int r = c / (DP / kVec);
      const int col = (c % (DP / kVec)) * kVec;
      const bool valid = row0 + r < t && col < d;
      const T* p = valid ? src + (int64_t)(row0 + r) * d + col : src;
      cp_async16(dst + r * S + col, p, valid);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DP; e += THREADS) {
      const int r = e / DP;
      const int col = e % DP;
      dst[r * S + col] = (row0 + r < t && col < d)
                             ? src[(int64_t)(row0 + r) * d + col]
                             : from_f<T>(0.f);
    }
  }
}

// The [64][DP+8] tile back to rows [row0, row0 + 64) of a [t, d] matrix,
// in 16-byte row chunks (VEC) or element by element.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void write_rows(T* __restrict__ dst,
                                           const T* tile, int row0, int t,
                                           int d) {
  constexpr int S = tile_stride<T, DP>();
  for (int c = threadIdx.x; c < kTile * (DP / 8); c += kMmaThreads) {
    const int r = c / (DP / 8);
    const int col = (c % (DP / 8)) * 8;
    if (row0 + r >= t || col >= d) continue;
    T* p = dst + (int64_t)(row0 + r) * d + col;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(p) =
          *reinterpret_cast<const uint4*>(tile + r * S + col);
    } else {
      for (int e = 0; e < 8 && col + e < d; ++e) p[e] = tile[r * S + col + e];
    }
  }
}

// A warp's accumulator rows (C fragments of n tiles 0..NT) into a tile.
template <typename T, int DP, int NT>
__device__ __forceinline__ void stage_acc(T* tile, const float (&acc)[NT][4],
                                          int row, int lane) {
  constexpr int S = tile_stride<T, DP>();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + (lane % 4) * 2;
    store2(tile + row * S + c, acc[n][0], acc[n][1]);
    store2(tile + (row + 8) * S + c, acc[n][2], acc[n][3]);
  }
}

// A fragment of rows [row, row + 16), columns [col, col + 16) of a tile.
template <int S, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile,
                                       int row, int col, int lane) {
  ldmatrix_x4(a, tile + (row + lane % 16) * S + col + (lane / 16) * 8);
}

// B fragments of n tiles (n8, n8 + 1) for k step [k16, k16 + 16) from a
// tile whose rows are n and columns k (K in Q K^T): r[0..1] tile n8,
// r[2..3] tile n8 + 1.
template <int S, typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const T* tile,
                                          int n8, int k16, int lane) {
  ldmatrix_x4(r, tile + (n8 * 8 + lane % 8 + (lane / 16) * 8) * S + k16 +
                     ((lane / 8) % 2) * 8);
}

// The same from a tile whose rows are k and columns n (V in P V).
template <int S, typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const T* tile,
                                          int n8, int k16, int lane) {
  ldmatrix_x4_trans(r, tile + (k16 + lane % 8 + ((lane / 8) % 2) * 8) * S +
                           n8 * 8 + (lane / 16) * 8);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int DP>
constexpr int fwd_mma_smem_bytes() {
  return 5 * kTile * tile_stride<T, DP>() * (int)sizeof(T);
}
template <typename T, int DP>
constexpr int dkv_mma_smem_bytes() {
  return 6 * kTile * tile_stride<T, DP>() * (int)sizeof(T) +
         4 * kTile * (int)sizeof(float);
}
template <typename T, int DP>
constexpr int dq_mma_smem_bytes() {
  return 6 * kTile * tile_stride<T, DP>() * (int)sizeof(T);
}

// ---------------------------------------------------------------------------
// kernel 7, 16-bit: one block per (b*h, 64 queries)
// ---------------------------------------------------------------------------
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 2)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int heads,
                     int tq, int tk, int d, float scale, int causal) {
  constexpr int S = tile_stride<T, DP>();
  constexpr int KS = DP / 16;        // k steps of Q K^T
  constexpr int NO = DP / 8;         // n tiles of O
  constexpr int NS = kTile / 8;      // n tiles of S
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [64][S], then the output
  T* Ks = Qs + TILE;                        // [2][64][S]
  T* Vs = Ks + 2 * TILE;                    // [2][64][S]

  const int n_qt = (tq + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int qi[2] = {q0 + row, q0 + row + 8};
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const int k_end = causal ? min(tk, q0 + kTile) : tk;
  const int n_kt = (k_end + kTile - 1) / kTile;

  stage_rows<T, DP, kMmaThreads, VEC>(Qs, q + bh * tq * d, q0, tq, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Ks, kb, 0, tk, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Vs, vb, 0, tk, d);
  if constexpr (VEC) cp_async_commit();

  // scores in log2 units (exp2 is one instruction), m with them; the lse
  // goes back to natural units
  const float scale2 = scale * kLog2e;
  uint32_t qf[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    const int k0 = j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's stage is free
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a<S>(qf[kk], Qs, warp * 16, kk * 16, lane);
    }
    if (j + 1 < n_kt) {
      stage_rows<T, DP, kMmaThreads, VEC>(Ks + (st ^ 1) * TILE, kb,
                                          k0 + kTile, tk, d);
      stage_rows<T, DP, kMmaThreads, VEC>(Vs + (st ^ 1) * TILE, vb,
                                          k0 + kTile, tk, d);
      if constexpr (VEC) cp_async_commit();
    }
    const T* Kt = Ks + st * TILE;
    const T* Vt = Vs + st * TILE;
    // the tile's kept keys as 64 bits in every lane, one ballot a half
    uint32_t keep_bits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = k0 + 32 * h + lane;
      keep_bits[h] = __ballot_sync(
          0xffffffffu, kj < tk && (mb == nullptr || mb[kj] > 0.f));
    }

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t r[4];
        load_b_nk<S>(r, Kt, n, kk * 16, lane);
        mma_16816(s[n], qf[kk], r[0], r[1], T());
        mma_16816(s[n + 1], qf[kk], r[2], r[3], T());
      }

    // online softmax on the accumulators: e < 2 is row `row`, else + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (lane % 4) * 2 + (e & 1);
        const bool keep = ((keep_bits[n / 4] >> (c % 32)) & 1u) &&
                          (!causal || qi[e / 2] >= k0 + c);
        s[n][e] = keep ? s[n][e] * scale2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2f(m[h] - mx[h]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] <= kNegInf * 0.5f
                            ? 0.f
                            : exp2f(s[n][e] - mx[e / 2]);
        rs[e / 2] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + quad_sum(rs[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // O += P V: P rounded to T, C fragments repacked as A fragments
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1], T()),
                              pack2(s[2 * kk][2], s[2 * kk][3], T()),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T())};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t r[4];
        load_b_kn<S>(r, Vt, n, kk * 16, lane);
        mma_16816(acc[n], pa, r[0], r[1], T());
        mma_16816(acc[n + 1], pa, r[2], r[3], T());
      }
    }
  }

  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= lc[e / 2];
  __syncthreads();  // every warp is past its reads of the Q tile
  stage_acc<T, DP, NO>(Qs, acc, row, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a fully masked row keeps m = NEG_INF, as in natural units
      const float mn = m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2;
      if (qi[h] < tq) lse[bh * tq + qi[h]] = mn + logf(lc[h]);
    }
  }
  __syncthreads();
  write_rows<T, DP, VEC>(out + bh * tq * d, Qs, q0, tq, d);
}

// ---------------------------------------------------------------------------
// kernel 9, 16-bit: one block per (b*h, 64 keys). K and V are read as A
// fragments from their shared tiles at each use rather than held in
// registers: at d <= 64 that frees the registers for three blocks an SM
// (168 a thread) against two, and the 12 sites of a BERT-base step took
// 0.347 ms against 0.397 with K and V in registers (H100,
// chip_smoke.py).
// ---------------------------------------------------------------------------
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, int heads, int tq, int tk, int d,
                         float scale, int causal) {
  constexpr int S = tile_stride<T, DP>();
  constexpr int KS = DP / 16;        // k steps of K Q^T and V dO^T
  constexpr int NO = DP / 8;         // n tiles of dK, dV
  constexpr int NS = kTile / 8;   // n tiles of S^T
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [64][S]
  T* Vs = Ks + TILE;                        // [64][S]
  T* Qs = Vs + TILE;                        // [2][64][S], then dK
  T* Os = Qs + 2 * TILE;                    // dO [2][64][S], then dV
  float* lse_s = reinterpret_cast<float*>(Os + 2 * TILE);  // [2][64]
  float* delta_s = lse_s + 2 * kTile;                    // [2][64]

  const int n_kt = (tk + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_kt;
  const int k0 = (int)(blockIdx.x % n_kt) * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = warp * 16 + lane / 4;  // this thread's keys: row, row + 8
  const int kr[2] = {k0 + row, k0 + row + 8};
  const T* qb = q + bh * tq * d;
  const T* ob = dout + bh * tq * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  // query tiles wholly before this key tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < tq ? (tq - q_begin + kTile - 1) / kTile
                                : 0;

  auto stage_q = [&](int st, int q0) {
    stage_rows<T, DP, kMmaThreads, VEC>(Qs + st * TILE, qb, q0, tq, d);
    stage_rows<T, DP, kMmaThreads, VEC>(Os + st * TILE, ob, q0, tq, d);
    for (int c = threadIdx.x; c < kTile; c += kMmaThreads) {
      const int qi = q0 + c;
      // the lse in log2 units, as the scores below
      lse_s[st * kTile + c] = qi < tq ? lse[bh * tq + qi] * kLog2e : 0.f;
      delta_s[st * kTile + c] = qi < tq ? delta[bh * tq + qi] : 0.f;
    }
  };
  const float scale2 = scale * kLog2e;
  stage_rows<T, DP, kMmaThreads, VEC>(Ks, k + bh * tk * d, k0, tk, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Vs, v + bh * tk * d, k0, tk, d);
  if (n_qt > 0) stage_q(0, q_begin);
  if constexpr (VEC) cp_async_commit();

  bool keep_k[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    keep_k[h] = kr[h] < tk && (mb == nullptr || mb[kr[h]] > 0.f);
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int j = 0; j < n_qt; ++j) {
    const int st = j & 1;
    const int q0 = q_begin + j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's stage is free
    if (j + 1 < n_qt) {
      stage_q(st ^ 1, q0 + kTile);
      if constexpr (VEC) cp_async_commit();
    }
    const T* Qt = Qs + st * TILE;
    const T* Ot = Os + st * TILE;
    const float* ls = lse_s + st * kTile;
    const float* dl = delta_s + st * kTile;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<S>(ka, Ks, warp * 16, kk * 16, lane);
      load_a<S>(va, Vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t r[4];
        load_b_nk<S>(r, Qt, n, kk * 16, lane);
        mma_16816(s[n], ka, r[0], r[1], T());
        mma_16816(s[n + 1], ka, r[2], r[3], T());
        load_b_nk<S>(r, Ot, n, kk * 16, lane);
        mma_16816(dp[n], va, r[0], r[1], T());
        mma_16816(dp[n + 1], va, r[2], r[3], T());
      }
    }

    // P^T = exp(S^T scale - lse), masked; dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c0 = n * 8 + (lane % 4) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + c0 + (e & 1);
        const bool keep = keep_k[e / 2] && qi < tq &&
                          (!causal || qi >= kr[e / 2]);
        const float sv = keep ? s[n][e] * scale2 : kNegInf;
        const float p = sv <= kNegInf * 0.5f
                            ? 0.f
                            : exp2f(sv - ((e & 1) ? l2.y : l2.x));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO, P^T rounded to dO's type
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1], T()),
                              pack2(s[2 * kk][2], s[2 * kk][3], T()),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T())};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t r[4];
        load_b_kn<S>(r, Ot, n, kk * 16, lane);
        mma_16816(dv_acc[n], pa, r[0], r[1], T());
        mma_16816(dv_acc[n + 1], pa, r[2], r[3], T());
      }
    }
    // dK += (dS^T Q) scale, dS^T rounded to Q's type; the product of each
    // query tile is scaled before it is added, as the JAX kernel does
    uint32_t da[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      da[kk][0] = pack2(dp[2 * kk][0], dp[2 * kk][1], T());
      da[kk][1] = pack2(dp[2 * kk][2], dp[2 * kk][3], T());
      da[kk][2] = pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1], T());
      da[kk][3] = pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3], T());
    }
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t r[4];
        load_b_kn<S>(r, Qt, n, kk * 16, lane);
        mma_16816(part[0], da[kk], r[0], r[1], T());
        mma_16816(part[1], da[kk], r[2], r[3], T());
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[n][e] += part[0][e] * scale;
        dk_acc[n + 1][e] += part[1][e] * scale;
      }
    }
  }

  if constexpr (VEC) cp_async_wait<0>();  // no copy is left in flight
  __syncthreads();  // every warp is past its reads of the last Q, dO tiles
  stage_acc<T, DP, NO>(Qs, dk_acc, row, lane);
  stage_acc<T, DP, NO>(Os, dv_acc, row, lane);
  __syncthreads();
  write_rows<T, DP, VEC>(dk + bh * tk * d, Qs, k0, tk, d);
  write_rows<T, DP, VEC>(dv + bh * tk * d, Os, k0, tk, d);
}

// ---------------------------------------------------------------------------
// kernel 8, 16-bit: one block per (b*h, 64 queries), the mirror of kernel
// 9: Q and dO are staged once, K and V stream through the two-stage ring,
// and each warp's 16 query rows of S, dP and dS stay in its accumulators.
// Q and dO are read as A fragments from their shared tiles at each use.
// ---------------------------------------------------------------------------
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask, T* __restrict__ dq,
                        int heads, int tq, int tk, int d, float scale,
                        int causal) {
  constexpr int S = tile_stride<T, DP>();
  constexpr int KS = DP / 16;        // k steps of Q K^T and dO V^T
  constexpr int NO = DP / 8;         // n tiles of dQ
  constexpr int NS = kTile / 8;      // n tiles of S
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [64][S], then dQ
  T* Os = Qs + TILE;                        // dO [64][S]
  T* Ks = Os + TILE;                        // [2][64][S]
  T* Vs = Ks + 2 * TILE;                    // [2][64][S]

  const int n_qt = (tq + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int qi[2] = {q0 + row, q0 + row + 8};
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const int k_end = causal ? min(tk, q0 + kTile) : tk;
  const int n_kt = (k_end + kTile - 1) / kTile;

  stage_rows<T, DP, kMmaThreads, VEC>(Qs, q + bh * tq * d, q0, tq, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Os, dout + bh * tq * d, q0, tq, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Ks, kb, 0, tk, d);
  stage_rows<T, DP, kMmaThreads, VEC>(Vs, vb, 0, tk, d);
  if constexpr (VEC) cp_async_commit();

  // the rows' lse in log2 units, as the scores below, and their delta
  const float scale2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = qi[h] < tq ? lse[bh * tq + qi[h]] * kLog2e : 0.f;
    dl[h] = qi[h] < tq ? delta[bh * tq + qi[h]] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    const int k0 = j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's stage is free
    if (j + 1 < n_kt) {
      stage_rows<T, DP, kMmaThreads, VEC>(Ks + (st ^ 1) * TILE, kb,
                                          k0 + kTile, tk, d);
      stage_rows<T, DP, kMmaThreads, VEC>(Vs + (st ^ 1) * TILE, vb,
                                          k0 + kTile, tk, d);
      if constexpr (VEC) cp_async_commit();
    }
    const T* Kt = Ks + st * TILE;
    const T* Vt = Vs + st * TILE;
    // the tile's kept keys as 64 bits in every lane, one ballot a half
    uint32_t keep_bits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = k0 + 32 * h + lane;
      keep_bits[h] = __ballot_sync(
          0xffffffffu, kj < tk && (mb == nullptr || mb[kj] > 0.f));
    }

    // S = Q K^T and dP = dO V^T: rows are queries, columns keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<S>(qa, Qs, warp * 16, kk * 16, lane);
      load_a<S>(oa, Os, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t r[4];
        load_b_nk<S>(r, Kt, n, kk * 16, lane);
        mma_16816(s[n], qa, r[0], r[1], T());
        mma_16816(s[n + 1], qa, r[2], r[3], T());
        load_b_nk<S>(r, Vt, n, kk * 16, lane);
        mma_16816(dp[n], oa, r[0], r[1], T());
        mma_16816(dp[n + 1], oa, r[2], r[3], T());
      }
    }

    // P = exp(S scale - lse), masked; dS = P (dP - delta), in dp
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (lane % 4) * 2 + (e & 1);
        const bool keep = ((keep_bits[n / 4] >> (c % 32)) & 1u) &&
                          (!causal || qi[e / 2] >= k0 + c);
        const float sv = keep ? s[n][e] * scale2 : kNegInf;
        const float p =
            sv <= kNegInf * 0.5f ? 0.f : exp2f(sv - lse2[e / 2]);
        dp[n][e] = p * (dp[n][e] - dl[e / 2]);
      }

    // dQ += (dS K) scale, dS rounded to K's type; the product of each key
    // tile is scaled before it is added, as the JAX kernel does
    uint32_t da[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      da[kk][0] = pack2(dp[2 * kk][0], dp[2 * kk][1], T());
      da[kk][1] = pack2(dp[2 * kk][2], dp[2 * kk][3], T());
      da[kk][2] = pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1], T());
      da[kk][3] = pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3], T());
    }
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t r[4];
        load_b_kn<S>(r, Kt, n, kk * 16, lane);
        mma_16816(part[0], da[kk], r[0], r[1], T());
        mma_16816(part[1], da[kk], r[2], r[3], T());
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] += part[0][e] * scale;
        acc[n + 1][e] += part[1][e] * scale;
      }
    }
  }

  __syncthreads();  // every warp is past its reads of the Q tile
  stage_acc<T, DP, NO>(Qs, acc, row, lane);
  __syncthreads();
  write_rows<T, DP, VEC>(dq + bh * tq * d, Qs, q0, tq, d);
}

// ===========================================================================
// f32, d <= 128: SIMT FMAs in full f32, retiled against the shared-memory
// bound
// ===========================================================================
// 256 threads as 16 x 16 over a 64 x 64 score tile: thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j (i, j < 4). Tiles lie in shared
// memory as in device memory (d-contiguous rows, stride d + 4 floats),
// so cp.async can stage them (it copies, it cannot transpose), and a
// thread reads four d steps of a row at once with one 16-byte load: per
// four d steps a thread makes 8 float4 loads (16 with dS's operands) for
// 64 (128) FMAs, where the first version made one 4-byte load per 2 FMAs.
// Each score is still one fmaf chain over d in order, and each output a
// chain over keys (queries) in order, so the bits do not depend on the
// tiling. P (and dS) go through shared memory once per tile ([row][col],
// stride 68), and the P V (dS K, dS Q, P^T dO) loops read them four
// columns at a time. Output columns of a thread: W neighbouring ones (4,
// or 2 at d <= 32) at g * 16 W + tx W, g < DP / (16 W).
constexpr int kF32Threads = 256;
constexpr int kPS = kTile + 4;  // stride of the P and dS tiles

template <int DP>
struct F32Cols {
  static constexpr int W = DP / 16 < 4 ? DP / 16 : 4;
  static constexpr int N = DP / 16;  // columns a thread
  static __device__ __forceinline__ int col(int tx, int c) {
    return (c / W) * 16 * W + tx * W + c % W;
  }
};

template <int W>
__device__ __forceinline__ void load_cols(float* v, const float* p) {
  if constexpr (W == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}

__device__ __forceinline__ float lane4(const float4& f, int u) {
  return u == 0 ? f.x : u == 1 ? f.y : u == 2 ? f.z : f.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s += a . b over four d steps, in d order
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// A thread's rows of a [64][DP] f32 result to rows row0 + ty + 16 i of a
// [t, d] matrix: W-wide vector stores (VEC) or element by element.
template <int DP, bool VEC>
__device__ __forceinline__ void write_f32(float* __restrict__ dst,
                                          const float (&acc)[4][DP / 16],
                                          int row0, int t, int d, int ty,
                                          int tx) {
  using C = F32Cols<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= t) continue;
    float* row = dst + (int64_t)r * d;
#pragma unroll
    for (int c = 0; c < C::N; c += C::W) {
      const int col = C::col(tx, c);
      if (col >= d) continue;
      if constexpr (VEC && C::W == 4) {
        *reinterpret_cast<float4*>(row + col) = make_float4(
            acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
      } else if constexpr (VEC) {
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[i][c], acc[i][c + 1]);
      } else {
#pragma unroll
        for (int w = 0; w < C::W; ++w)
          if (col + w < d) row[col + w] = acc[i][c + w];
      }
    }
  }
}

// keep[c] = 1 where key k0 + c exists and is not masked, else 0
__device__ __forceinline__ void stage_keep(float* keep,
                                           const float* __restrict__ mb,
                                           int k0, int tk) {
  for (int c = threadIdx.x; c < kTile; c += kF32Threads) {
    const int kj = k0 + c;
    keep[c] = kj < tk && (mb == nullptr || mb[kj] > 0.f) ? 1.f : 0.f;
  }
}

template <int DP>
constexpr int fwd_f32_smem_bytes() {
  return (5 * kTile * tile_stride<float, DP>() + kTile * kPS + 2 * kTile) *
         (int)sizeof(float);
}
template <int DP>
constexpr int dkv_f32_smem_bytes() {
  return (4 * kTile * tile_stride<float, DP>() + 2 * kTile * kPS +
          2 * kTile) *
         (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// kernel 7, f32: one block per (b*h, 64 queries)
// ---------------------------------------------------------------------------
template <int DP, bool VEC>
__global__ void __launch_bounds__(kF32Threads, DP <= 64 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ lse, int heads, int tq, int tk,
                     int d, float scale, int causal) {
  using C = F32Cols<DP>;
  constexpr int S = tile_stride<float, DP>();
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                  // [64][S]
  float* Ks = Qs + TILE;            // [2][64][S]
  float* Vs = Ks + 2 * TILE;        // [2][64][S]
  float* Ps = Vs + 2 * TILE;        // [64][kPS]
  float* keep_s = Ps + kTile * kPS;  // [2][64]

  const int n_qt = (tq + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * kTile;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const int k_end = causal ? min(tk, q0 + kTile) : tk;
  const int n_kt = (k_end + kTile - 1) / kTile;

  stage_rows<float, DP, kF32Threads, VEC>(Qs, q + bh * tq * d, q0, tq, d);
  stage_rows<float, DP, kF32Threads, VEC>(Ks, kb, 0, tk, d);
  stage_rows<float, DP, kF32Threads, VEC>(Vs, vb, 0, tk, d);
  stage_keep(keep_s, mb, 0, tk);
  if constexpr (VEC) cp_async_commit();

  float m[4], l[4], acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    const int k0 = j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's stage and P are free
    if (j + 1 < n_kt) {
      stage_rows<float, DP, kF32Threads, VEC>(Ks + (st ^ 1) * TILE, kb,
                                              k0 + kTile, tk, d);
      stage_rows<float, DP, kF32Threads, VEC>(Vs + (st ^ 1) * TILE, vb,
                                              k0 + kTile, tk, d);
      stage_keep(keep_s + (st ^ 1) * kTile, mb, k0 + kTile, tk);
      if constexpr (VEC) cp_async_commit();
    }
    const float* Kt = Ks + st * TILE;
    const float* Vt = Vs + st * TILE;
    const float* kp = keep_s + st * kTile;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DP; dd += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(Qs + (ty + 16 * i) * S + dd);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = ld4(Kt + (tx + 16 * jj) * S + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dot4(a[i], b[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool keep = kp[c] > 0.f && (!causal || qi >= k0 + c);
        s[i][jj] = keep ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = row_max16(mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p =
            s[i][jj] <= kNegInf * 0.5f ? 0.f : expf(s[i][jj] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * jj] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P is complete

#pragma unroll
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = ld4(Ps + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[C::N];
#pragma unroll
        for (int c = 0; c < C::N; c += C::W)
          load_cols<C::W>(vv + c, Vt + (kk + u) * S + C::col(tx, c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane4(p4[i], u);
#pragma unroll
          for (int c = 0; c < C::N; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  float lc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lc[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] /= lc[i];
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < tq) lse[bh * tq + qi] = m[i] + logf(lc[i]);
  }
  write_f32<DP, VEC>(out + bh * tq * d, acc, q0, tq, d, ty, tx);
}

// ---------------------------------------------------------------------------
// kernel 9, f32: one block per (b*h, 64 keys); thread (ty, tx) owns keys
// ty + 16 i and queries tx + 16 j of each query tile. The Q and dO tiles
// (with their lse and delta rows) have one buffer: at d <= 64 the block
// then takes 105 KB of shared memory and 128 registers a thread, so two
// blocks share an SM and one's loads overlap the other's FMAs. With a
// second buffer (140 KB, one block an SM) the 12 sites of a BERT-base
// step took 1.62 ms against 1.32 on one buffer (H100, chip_smoke.py).
// ---------------------------------------------------------------------------
template <int DP, bool VEC>
__global__ void __launch_bounds__(kF32Threads, DP <= 64 ? 2 : 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int tq, int tk, int d, float scale,
                         int causal) {
  using C = F32Cols<DP>;
  constexpr int S = tile_stride<float, DP>();
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                       // [64][S]
  float* Vs = Ks + TILE;                 // [64][S]
  float* Qs = Vs + TILE;                 // [64][S]
  float* Os = Qs + TILE;                 // dO [64][S]
  float* Pt = Os + TILE;                 // p^T [64][kPS]
  float* Dt = Pt + kTile * kPS;          // ds^T [64][kPS]
  float* lse_s = Dt + kTile * kPS;       // [64]
  float* delta_s = lse_s + kTile;        // [64]

  const int n_kt = (tk + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_kt;
  const int k0 = (int)(blockIdx.x % n_kt) * kTile;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const float* qb = q + bh * tq * d;
  const float* ob = dout + bh * tq * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  // query tiles wholly before this key tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < tq ? (tq - q_begin + kTile - 1) / kTile : 0;

  auto stage_q = [&](int q0) {
    stage_rows<float, DP, kF32Threads, VEC>(Qs, qb, q0, tq, d);
    stage_rows<float, DP, kF32Threads, VEC>(Os, ob, q0, tq, d);
    for (int c = threadIdx.x; c < kTile; c += kF32Threads) {
      const int qi = q0 + c;
      lse_s[c] = qi < tq ? lse[bh * tq + qi] : 0.f;
      delta_s[c] = qi < tq ? delta[bh * tq + qi] : 0.f;
    }
  };
  stage_rows<float, DP, kF32Threads, VEC>(Ks, k + bh * tk * d, k0, tk, d);
  stage_rows<float, DP, kF32Threads, VEC>(Vs, v + bh * tk * d, k0, tk, d);
  if (n_qt > 0) stage_q(q_begin);
  if constexpr (VEC) cp_async_commit();

  bool keep_k[4];
  float dk_acc[4][C::N], dv_acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    keep_k[i] = kk < tk && (mb == nullptr || mb[kk] > 0.f);
#pragma unroll
    for (int c = 0; c < C::N; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_qt; ++j) {
    const int q0 = q_begin + j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < DP; dd += 4) {
      float4 kr[4], vr[4], qc[4], oc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kr[i] = ld4(Ks + (ty + 16 * i) * S + dd);
        vr[i] = ld4(Vs + (ty + 16 * i) * S + dd);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qc[jj] = ld4(Qs + (tx + 16 * jj) * S + dd);
        oc[jj] = ld4(Os + (tx + 16 * jj) * S + dd);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // q * k in the forward's operand order and d order
          s[i][jj] = dot4(qc[jj], kr[i], s[i][jj]);
          dp[i][jj] = dot4(oc[jj], vr[i], dp[i][jj]);
        }
    }

#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      const int qi = q0 + c;
      const float lse_j = lse_s[c], delta_j = delta_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + ty + 16 * i;
        const bool keep = keep_k[i] && qi < tq && (!causal || qi >= kk);
        const float sv = keep ? s[i][jj] * scale : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.f : expf(sv - lse_j);
        Pt[(ty + 16 * i) * kPS + c] = p;
        Dt[(ty + 16 * i) * kPS + c] = p * (dp[i][jj] - delta_j);
      }
    }
    __syncthreads();  // P^T and dS^T are complete

    float part[4][C::N];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) part[i][c] = 0.f;
#pragma unroll 2
    for (int qq = 0; qq < kTile; qq += 4) {
      float4 p4[4], g4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = ld4(Pt + (ty + 16 * i) * kPS + qq);
        g4[i] = ld4(Dt + (ty + 16 * i) * kPS + qq);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float ov[C::N], qv[C::N];
#pragma unroll
        for (int c = 0; c < C::N; c += C::W) {
          load_cols<C::W>(ov + c, Os + (qq + u) * S + C::col(tx, c));
          load_cols<C::W>(qv + c, Qs + (qq + u) * S + C::col(tx, c));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane4(p4[i], u), g = lane4(g4[i], u);
#pragma unroll
          for (int c = 0; c < C::N; ++c) {
            dv_acc[i][c] = fmaf(p, ov[c], dv_acc[i][c]);
            part[i][c] = fmaf(g, qv[c], part[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) dk_acc[i][c] += part[i][c] * scale;
    if (j + 1 < n_qt) {
      __syncthreads();  // every thread is past its reads of this tile
      stage_q(q0 + kTile);
      if constexpr (VEC) cp_async_commit();
    }
  }

  if constexpr (VEC) cp_async_wait<0>();  // no copy is left in flight
  write_f32<DP, VEC>(dk + bh * tk * d, dk_acc, k0, tk, d, ty, tx);
  write_f32<DP, VEC>(dv + bh * tk * d, dv_acc, k0, tk, d, ty, tx);
}

// ---------------------------------------------------------------------------
// kernel 8, f32: one block per (b*h, 64 queries); thread (ty, tx) owns
// queries ty + 16 i and keys tx + 16 j of each key tile. Q and dO are
// staged once; the K and V tiles (with their kept keys) have one buffer:
// at d <= 64 the block then takes 87 KB of shared memory and 128
// registers a thread, so two blocks share an SM and one's loads overlap
// the other's FMAs. With a second buffer (122 KB, one block an SM) the
// 12 sites of a BERT-base step took 1.55 ms against 1.07 on one buffer
// (H100, chip_smoke.py). dS goes through shared memory once per tile,
// and the dS K loop reads it four keys at a time.
// ---------------------------------------------------------------------------
template <int DP>
constexpr int dq_f32_smem_bytes() {
  return (4 * kTile * tile_stride<float, DP>() + kTile * kPS + kTile) *
         (int)sizeof(float);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kF32Threads, DP <= 64 ? 2 : 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask,
                        float* __restrict__ dq, int heads, int tq, int tk,
                        int d, float scale, int causal) {
  using C = F32Cols<DP>;
  constexpr int S = tile_stride<float, DP>();
  constexpr int TILE = kTile * S;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                    // [64][S]
  float* Os = Qs + TILE;              // dO [64][S]
  float* Ks = Os + TILE;              // [64][S]
  float* Vs = Ks + TILE;              // [64][S]
  float* Ds = Vs + TILE;              // ds [64][kPS]
  float* keep_s = Ds + kTile * kPS;   // [64]

  const int n_qt = (tq + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * kTile;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const float* mb = mask ? mask + (bh / heads) * tk : nullptr;
  const int k_end = causal ? min(tk, q0 + kTile) : tk;
  const int n_kt = (k_end + kTile - 1) / kTile;

  auto stage_kv = [&](int k0) {
    stage_rows<float, DP, kF32Threads, VEC>(Ks, kb, k0, tk, d);
    stage_rows<float, DP, kF32Threads, VEC>(Vs, vb, k0, tk, d);
    stage_keep(keep_s, mb, k0, tk);
  };
  stage_rows<float, DP, kF32Threads, VEC>(Qs, q + bh * tq * d, q0, tq, d);
  stage_rows<float, DP, kF32Threads, VEC>(Os, dout + bh * tq * d, q0, tq,
                                          d);
  stage_kv(0);
  if constexpr (VEC) cp_async_commit();

  float lse_r[4], delta_r[4], acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < tq ? lse[bh * tq + qi] : 0.f;
    delta_r[i] = qi < tq ? delta[bh * tq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // tile j has landed

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    // fully unrolled (unrolled twice at d <= 32, which spills otherwise)
#pragma unroll (DP > 32 ? DP / 4 : 2)
    for (int dd = 0; dd < DP; dd += 4) {
      float4 a[4], o[4], kr[4], vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(Qs + (ty + 16 * i) * S + dd);
        o[i] = ld4(Os + (ty + 16 * i) * S + dd);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kr[jj] = ld4(Ks + (tx + 16 * jj) * S + dd);
        vr[jj] = ld4(Vs + (tx + 16 * jj) * S + dd);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = dot4(a[i], kr[jj], s[i][jj]);
          dp[i][jj] = dot4(o[i], vr[jj], dp[i][jj]);
        }
    }

    // P = exp(S scale - lse), masked; dS = P (dP - delta)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool keep = keep_s[c] > 0.f && (!causal || qi >= k0 + c);
        const float sv = keep ? s[i][jj] * scale : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.f : expf(sv - lse_r[i]);
        Ds[(ty + 16 * i) * kPS + c] = p * (dp[i][jj] - delta_r[i]);
      }
    }
    __syncthreads();  // dS is complete

    // dQ += (dS K) scale, the product of each key tile scaled before it
    // is added, as the JAX kernel does
    float part[4][C::N];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) part[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 g4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g4[i] = ld4(Ds + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[C::N];
#pragma unroll
        for (int c = 0; c < C::N; c += C::W)
          load_cols<C::W>(kv + c, Ks + (kk + u) * S + C::col(tx, c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = lane4(g4[i], u);
#pragma unroll
          for (int c = 0; c < C::N; ++c)
            part[i][c] = fmaf(g, kv[c], part[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] += part[i][c] * scale;
    if (j + 1 < n_kt) {
      __syncthreads();  // every thread is past its reads of this tile
      stage_kv(k0 + kTile);
      if constexpr (VEC) cp_async_commit();
    }
  }

  write_f32<DP, VEC>(dq + bh * tq * d, acc, q0, tq, d, ty, tx);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum class Pass { kFwd, kDq, kDkv };

// The dynamic shared-memory opt-in above the 48 KB default, once per
// kernel instantiation; made on the first launch, which is never inside
// a graph capture in this package.
template <typename K>
cudaError_t opt_in(K kern, int smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) configured = true;
  return e;
}

template <Pass P, typename T, int DP, int BQ, int BK>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int floats = P == Pass::kFwd   ? fwd_smem_floats<DP, BQ, BK>()
                         : P == Pass::kDq ? dq_smem_floats<DP, BQ, BK>()
                                          : dkv_smem_floats<DP, BQ, BK>();
  constexpr int smem = floats * (int)sizeof(float);
  const int tiles = P == Pass::kDkv ? (a.tk + BK - 1) / BK
                                    : (a.tq + BQ - 1) / BQ;
  const int64_t blocks = a.bh * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if constexpr (P == Pass::kFwd) {
    auto kern = flash_fwd_kernel<T, DP, BQ, BK>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out),
        a.lse_out, a.heads, a.tq, a.tk, a.d, a.scale, a.causal);
  } else if constexpr (P == Pass::kDq) {
    auto kern = flash_bwd_dq_kernel<T, DP, BQ, BK>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out), a.heads, a.tq,
        a.tk, a.d, a.scale, a.causal);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, DP, BQ, BK>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out),
        static_cast<T*>(a.out2), a.heads, a.tq, a.tk, a.d, a.scale,
        a.causal);
  }
  return (int)cudaGetLastError();
}

// the wide bodies: d > 256 in every type, f64 at every d
template <Pass P, typename T>
int launch_wide(const Args& a, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  constexpr int B = kWideB, DO = kWideDo;
  constexpr int elems =
      P == Pass::kFwd  ? B * (kWideRow + kWideCol + DO + kWideP)
      : P == Pass::kDq ? B * (2 * kWideRow + 2 * kWideCol + kWideP + DO)
                       : B * (2 * kWideRow + 2 * kWideCol + 2 * kWideP +
                              2 * DO + 2);
  constexpr int smem = elems * (int)sizeof(A);
  const int tiles = P == Pass::kDkv ? (a.tk + B - 1) / B : (a.tq + B - 1) / B;
  const int64_t blocks = a.bh * tiles * ((a.d + DO - 1) / DO);
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // f64 takes 1/sqrt(d) in f64, as its plain version does
  const A scale = std::is_same<A, double>::value
                      ? A(1.0 / std::sqrt((double)a.d))
                      : A(a.scale);
  const A* lse_in = reinterpret_cast<const A*>(a.lse_in);
  const A* delta = reinterpret_cast<const A*>(a.delta);
  static bool configured = false;
  if constexpr (P == Pass::kFwd) {
    auto kern = flash_fwd_wide_kernel<T>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out),
        reinterpret_cast<A*>(a.lse_out), a.heads, a.tq, a.tk, a.d, scale,
        a.causal);
  } else if constexpr (P == Pass::kDq) {
    auto kern = flash_bwd_dq_wide_kernel<T>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), lse_in,
        delta, a.mask, static_cast<T*>(a.out), a.heads, a.tq, a.tk, a.d,
        scale, a.causal);
  } else {
    auto kern = flash_bwd_dkv_wide_kernel<T>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), lse_in,
        delta, a.mask, static_cast<T*>(a.out), static_cast<T*>(a.out2),
        a.heads, a.tq, a.tk, a.d, scale, a.causal);
  }
  return (int)cudaGetLastError();
}

// the redesigned kernels on tensor cores (16-bit inputs, d <= 128)
template <Pass P, typename T, int DP, bool VEC>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int tiles = P == Pass::kDkv ? (a.tk + kTile - 1) / kTile
                                    : (a.tq + kTile - 1) / kTile;
  const int64_t blocks = a.bh * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if constexpr (P == Pass::kFwd) {
    constexpr int smem = fwd_mma_smem_bytes<T, DP>();
    auto kern = flash_fwd_mma_kernel<T, DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out),
        a.lse_out, a.heads, a.tq, a.tk, a.d, a.scale, a.causal);
  } else if constexpr (P == Pass::kDq) {
    constexpr int smem = dq_mma_smem_bytes<T, DP>();
    auto kern = flash_bwd_dq_mma_kernel<T, DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out), a.heads, a.tq,
        a.tk, a.d, a.scale, a.causal);
  } else {
    constexpr int smem = dkv_mma_smem_bytes<T, DP>();
    auto kern = flash_bwd_dkv_mma_kernel<T, DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out),
        static_cast<T*>(a.out2), a.heads, a.tq, a.tk, a.d, a.scale,
        a.causal);
  }
  return (int)cudaGetLastError();
}

// the redesigned kernels on f32 inputs, d <= 128
template <Pass P, int DP, bool VEC>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int tiles = P == Pass::kDkv ? (a.tk + kTile - 1) / kTile
                                    : (a.tq + kTile - 1) / kTile;
  const int64_t blocks = a.bh * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  if constexpr (P == Pass::kFwd) {
    constexpr int smem = fwd_f32_smem_bytes<DP>();
    auto kern = flash_fwd_f32_kernel<DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kF32Threads, smem, stream>>>(
        q, k, v, a.mask, static_cast<float*>(a.out), a.lse_out, a.heads,
        a.tq, a.tk, a.d, a.scale, a.causal);
  } else if constexpr (P == Pass::kDq) {
    constexpr int smem = dq_f32_smem_bytes<DP>();
    auto kern = flash_bwd_dq_f32_kernel<DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kF32Threads, smem, stream>>>(
        q, k, v, static_cast<const float*>(a.dout), a.lse_in, a.delta,
        a.mask, static_cast<float*>(a.out), a.heads, a.tq, a.tk, a.d,
        a.scale, a.causal);
  } else {
    constexpr int smem = dkv_f32_smem_bytes<DP>();
    auto kern = flash_bwd_dkv_f32_kernel<DP, VEC>;
    if (cudaError_t e = opt_in(kern, smem, configured)) return (int)e;
    kern<<<(unsigned)blocks, kF32Threads, smem, stream>>>(
        q, k, v, static_cast<const float*>(a.dout), a.lse_in, a.delta,
        a.mask, static_cast<float*>(a.out), static_cast<float*>(a.out2),
        a.heads, a.tq, a.tk, a.d, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

// 16-byte staging needs d to be a whole number of 16-byte chunks and
// every tile pointer 16-byte aligned
template <typename T>
bool vec_ok(const Args& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.out, a.out2};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return a.d % (16 / (int)sizeof(T)) == 0;
}

template <Pass P, typename T, int DP>
int redesigned(const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return vec_ok<T>(a) ? launch_f32<P, DP, true>(a, s)
                        : launch_f32<P, DP, false>(a, s);
  else
    return vec_ok<T>(a) ? launch_mma<P, T, DP, true>(a, s)
                        : launch_mma<P, T, DP, false>(a, s);
}

// head dim -> the padded width in shared memory and the tile sizes
template <Pass P, typename T>
int by_width(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return redesigned<P, T, 32>(a, s);
  if (a.d <= 64) return redesigned<P, T, 64>(a, s);
  if (a.d <= 128) return redesigned<P, T, 128>(a, s);
  // d in (128, 256]: the first version's SIMT bodies, for now
  if (a.d <= 256) return launch<P, T, 256, 32, 32>(a, s);
  return launch_wide<P, T>(a, s);
}

template <Pass P>
int dispatch(const Args& a, int dtype, cudaStream_t s) {
  if (a.bh <= 0 || a.heads <= 0 || a.tq <= 0 || a.tk <= 0 || a.d <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_width<P, float>(a, s);
  if (dtype == 1) return by_width<P, __nv_bfloat16>(a, s);
  if (dtype == 2) return by_width<P, __half>(a, s);
  if (dtype == 3) return launch_wide<P, double>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, 3 = float64 (q, k, v,
// dO and the outputs share it). q, dO, out, dq: [bh, tq, d]; k, v, dk,
// dv: [bh, tk, d]; lse, delta: [bh, tq], f64 for float64 and f32
// otherwise; mask: f32 [bh / heads, tk] or null. All
// contiguous. One launch on `stream` each; no synchronisation, no
// allocation. Each returns the cudaError_t (0 on success).
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse,
                              int64_t bh, int heads, int tq, int tk, int d,
                              float scale, int causal, int dtype,
                              void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr,
         static_cast<const float*>(mask), out, nullptr,
         static_cast<float*>(lse), bh, heads, tq, tk, d, scale, causal};
  return dispatch<Pass::kFwd>(a, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dq, int64_t bh,
                                 int heads, int tq, int tk, int d,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const float*>(mask),
         dq, nullptr, nullptr, bh, heads, tq, tk, d, scale, causal};
  return dispatch<Pass::kDq>(a, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv,
                                  int64_t bh, int heads, int tq, int tk,
                                  int d, float scale, int causal, int dtype,
                                  void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const float*>(mask),
         dk, dv, nullptr, bh, heads, tq, tk, d, scale, causal};
  return dispatch<Pass::kDkv>(a, dtype, static_cast<cudaStream_t>(stream));
}
