// Paged decode attention: one query token per sequence attending over a
// block-paged KV pool through the sequence's block table.
//
//   dl4j_paged_decode  replaces deeplearning4j_tpu/ops/attention_pallas.py:
//                      _paged_decode_kernel (launched by
//                      paged_decode_attention):
//                      out[b, h] = sum_t softmax_t(q[b, h] . k_t[h] * scale)
//                      v_t[h] over the first lengths[b] tokens of sequence
//                      b, token t at row t % block of pool block
//                      tables[b, t / block].
//
// Layouts: q, out [b, h, d]; k_pool, v_pool [num_blocks, block, h, d] (one
// layer's pool); tables [b, max_blocks] int32; lengths [b] int32. q and
// out share one type, the pools another (f32, bf16 or f16 each); all
// arithmetic is f32.
//
// Semantics kept from the TPU kernel (attention_pallas.py:251-275): s =
// (q . k) * scale; masked scores are NEG_INF = -1e30; p = 0 where s <=
// NEG_INF / 2, before any exp; the running max starts at NEG_INF; l =
// corr * l + sum p and acc = acc * corr + p v; the output is acc / max(l,
// 1e-30). A length past max_blocks * block is clamped to it (the TPU grid
// walks max_blocks blocks); a dead decode slot (an all-zero table, length
// 1) reads row 0 of the scratch block 0 and gives a finite row. The TPU
// grid walks every block of the table, but a block whose tokens are all
// masked leaves m, l and acc unchanged bit for bit, so this kernel reads
// only the min(ceil(len / block), max_blocks) blocks that hold valid
// tokens, and masks the tail of the last one.
//
// Work split: one block of kWarps warps per (head, sequence). Each warp
// folds a group of tokens at a time (16 / DPL of them, 2 at d > 128;
// groups dealt round robin to the warps), loading the whole group's K
// and V rows in the pool's type before converting any, into its own
// online-softmax state; its lanes hold d-slices (lane
// i owns elements i, i + 32, ...), the dot product is a butterfly of warp
// shuffles, so every lane holds the same bits of s, m and l. The warps'
// states then merge through shared memory in warp order, and each output
// element is written once by one thread: no atomics, so two launches give
// the same bits. The block loads its own table entries (what scalar
// prefetch did on the TPU). Any block size, any h, and d up to 256 run
// (d-slices of 1, 2, 4 or 8 elements a lane).
//
// Bound: bytes. A site reads the K and V rows of every valid token once,
// 2 * len * h * d elements a sequence, and does 4 FLOPs per element pair:
// about 1 FLOP a byte in f32, far below the card's 20 FLOPs a byte. This
// first version leaves on the table: split-K over long contexts (one block
// per (head, sequence) is 384 blocks at batch 32, under three waves of 132
// SMs, and a long sequence's block runs alone); 16-byte vector loads (each
// lane loads one element at a time, 4 or 2 bytes); cp.async / TMA staging
// of whole pool blocks into shared memory, so more bytes are in flight
// than a warp's group of rows.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DPL: elements of d a lane holds (d <= 32 * DPL)
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q,
                        const TKV* __restrict__ k_pool,
                        const TKV* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        TQ* __restrict__ out, int heads, int d, int block,
                        int max_blocks, float scale) {
  extern __shared__ float smem[];  // acc [kWarps][d], m [kWarps], l [kWarps]
  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int64_t qoff = ((int64_t)seq * heads + head) * d;
  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? to_f(q[qoff + c]) : 0.f;
  }
  const int len = lengths[seq];
  const int cap = max_blocks * block;
  const int n_tok = len < cap ? len : cap;
  const int* table = tables + (int64_t)seq * max_blocks;
  const int64_t row = (int64_t)heads * d;  // elements from token to token
  const int64_t col = (int64_t)head * d;

  float m = kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  // tokens a warp folds per step: 32 elements of K and V a lane in flight
  constexpr int kUnroll = DPL >= 8 ? 2 : 16 / DPL;
  for (int t0 = warp * kUnroll; t0 < n_tok; t0 += kWarps * kUnroll) {
    // start every load of the group, in the pool's own type, before any
    // conversion or arithmetic: a conversion placed between two loads
    // would wait for the first before the second could start
    TKV k_raw[kUnroll][DPL], v_raw[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < n_tok) {
        const int blk = __ldg(table + t / block);
        const int64_t base = ((int64_t)blk * block + t % block) * row + col;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int c = lane + 32 * i;
          if (c < d) {
            k_raw[u][i] = k_pool[base + c];
            v_raw[u][i] = v_pool[base + c];
          }
        }
      }
    }
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const bool ok = t0 + u < n_tok && lane + 32 * i < d;
        kr[u][i] = ok ? to_f(k_raw[u][i]) : 0.f;
        vr[u][i] = ok ? to_f(v_raw[u][i]) : 0.f;
      }
    }
    float s[kUnroll];
    float s_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) dot = fmaf(qr[i], kr[u][i], dot);
      dot = warp_sum(dot);
      s[u] = t0 + u < n_tok ? dot * scale : kNegInf;
      s_max = fmaxf(s_max, s[u]);
    }
    const float m_new = fmaxf(m, s_max);
    const float corr = expf(m - m_new);
    float p[kUnroll];
    float p_sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = s[u] <= kNegInf * 0.5f ? 0.f : expf(s[u] - m_new);
      p_sum += p[u];
    }
    l = corr * l + p_sum;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) pv = fmaf(p[u], vr[u][i], pv);
      acc[i] = fmaf(acc[i], corr, pv);
    }
    m = m_new;
  }

  float* s_acc = smem;
  float* s_m = smem + kWarps * d;
  float* s_l = s_m + kWarps;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = lane + 32 * i;
    if (c < d) s_acc[warp * d + c] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps' states in warp order
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float c_w[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c_w[w] = expf(s_m[w] - m_all);
    l_all = fmaf(c_w[w], s_l[w], l_all);
  }
  const float denom = fmaxf(l_all, 1e-30f);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(c_w[w], s_acc[w * d + c], o);
    out[qoff + c] = from_f<TQ>(o / denom);
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lengths;
  void* out;
  int batch, heads, d, block, max_blocks;
  float scale;
};

template <typename TQ, typename TKV, int DPL>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((unsigned)a.heads, (unsigned)a.batch);
  const size_t smem = sizeof(float) * (size_t)kWarps * (a.d + 2);
  paged_decode_kernel<TQ, TKV, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.tables, a.lengths,
      static_cast<TQ*>(a.out), a.heads, a.d, a.block, a.max_blocks,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_width(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch<TQ, TKV, 1>(a, s);
  if (a.d <= 64) return launch<TQ, TKV, 2>(a, s);
  if (a.d <= 128) return launch<TQ, TKV, 4>(a, s);
  if (a.d <= 256) return launch<TQ, TKV, 8>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int by_pool_type(const Args& a, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 0) return by_width<TQ, float>(a, s);
  if (kv_dtype == 1) return by_width<TQ, __nv_bfloat16>(a, s);
  if (kv_dtype == 2) return by_width<TQ, __half>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q_dtype for q and
// out, kv_dtype for both pools). All tensors contiguous; table entries must
// name blocks < num_blocks. One launch on `stream`; no synchronisation, no
// allocation. Returns the cudaError_t (0 on success).
extern "C" int dl4j_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, void* out, int batch,
                                 int heads, int d, int block, int max_blocks,
                                 float scale, int q_dtype, int kv_dtype,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || d <= 0 || block <= 0 || max_blocks <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q,
         k_pool,
         v_pool,
         static_cast<const int*>(tables),
         static_cast<const int*>(lengths),
         out,
         batch,
         heads,
         d,
         block,
         max_blocks,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_pool_type<float>(a, kv_dtype, s);
  if (q_dtype == 1) return by_pool_type<__nv_bfloat16>(a, kv_dtype, s);
  if (q_dtype == 2) return by_pool_type<__half>(a, kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}
