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
// ds to k's before ds k and to q's before ds^T q; every sum is f32.
//
// Work split, as the JAX package splits it: the forward and dq take one
// block per (b*h, query tile) and loop over key tiles with the running
// max, sum and accumulator in registers; dk/dv take one block per (b*h,
// key tile) and loop over query tiles. Each output element is written by
// one thread after a fixed sequence of f32 FMAs: no float atomics, so two
// launches give the same bits. Rows and columns past t and d are zero in
// shared memory and masked from the softmax, so any t and any d <= 256
// run (d is padded to 32, 64, 128 or 256 in shared memory).
//
// Bound: operations. At BERT-base's sites (t = 128, d = 64) the forward
// does 4 t^2 d FLOPs for 4 t d elements moved, about 128 FLOPs a byte in
// f32, above the card's 20 FLOPs a byte at the f32 FMA rate (67 TFLOP/s
// over 3.35 TB/s). This first version uses f32 FMAs only: 256 threads a
// block, each owning a 4 x 4 (2 x 2 at d = 256) patch of the score tile
// and the matching rows of the output accumulator, with Q, K, V (and dO)
// tiles staged in shared memory as f32 and padded strides against bank
// conflicts. Tensor-core tiles (wgmma), TMA and a pipelined tile ring are
// for a later version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum class Pass { kFwd, kDq, kDkv };

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
  // one opt-in per instantiation, above the 48 KB default; made on the
  // first launch, which is never inside a graph capture in this package
  static bool configured = false;
  if constexpr (P == Pass::kFwd) {
    auto kern = flash_fwd_kernel<T, DP, BQ, BK>;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out),
        a.lse_out, a.heads, a.tq, a.tk, a.d, a.scale, a.causal);
  } else if constexpr (P == Pass::kDq) {
    auto kern = flash_bwd_dq_kernel<T, DP, BQ, BK>;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out), a.heads, a.tq,
        a.tk, a.d, a.scale, a.causal);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, DP, BQ, BK>;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        a.lse_in, a.delta, a.mask, static_cast<T*>(a.out),
        static_cast<T*>(a.out2), a.heads, a.tq, a.tk, a.d, a.scale,
        a.causal);
  }
  return (int)cudaGetLastError();
}

// head dim -> the padded width in shared memory and the tile sizes
template <Pass P, typename T>
int by_width(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch<P, T, 32, 64, 64>(a, s);
  if (a.d <= 64) return launch<P, T, 64, 64, 64>(a, s);
  if (a.d <= 128) return launch<P, T, 128, 64, 64>(a, s);
  if (a.d <= 256) return launch<P, T, 256, 32, 32>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <Pass P>
int dispatch(const Args& a, int dtype, cudaStream_t s) {
  if (a.bh <= 0 || a.heads <= 0 || a.tq <= 0 || a.tk <= 0 || a.d <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_width<P, float>(a, s);
  if (dtype == 1) return by_width<P, __nv_bfloat16>(a, s);
  if (dtype == 2) return by_width<P, __half>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dO and the
// outputs share it). q, dO, out, dq: [bh, tq, d]; k, v, dk, dv: [bh, tk,
// d]; lse, delta: f32 [bh, tq]; mask: f32 [bh / heads, tk] or null. All
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
