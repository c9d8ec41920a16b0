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
// masked leaves m, l and acc unchanged bit for bit, so these kernels fold
// only the min(ceil(len / block), max_blocks) blocks that hold valid
// tokens, and mask the tail of the last one.
//
// Bound: bytes. A site reads the K and V rows of every valid token once,
// 2 * len * h * d elements a sequence, and does 4 FLOPs per element pair:
// about 1 FLOP a byte in f32, far below the card's 20 FLOPs a byte. The
// first design (the general body below) was paced by instructions, not
// bytes: its lanes loaded one element at a time (2-byte loads in bf16),
// every token paid a 5-step shuffle butterfly and an exp in all 32 lanes,
// and one block of 4 warps a (head, sequence) left most of the card's
// warps empty. The staged body answers each:
//
// Staged body (paged_decode_staged_kernel), for a row of d * esize bytes
// that G = d * esize / 16 lanes cover, G a power of 2 up to 32 (d <= 128:
// d = 64 is 8 lanes in 16 bit, 16 in f32), 16-byte aligned pools and a
// stage of at most 16 KB:
//   - whole-row 16-byte loads: a lane holds 16 bytes of a row, so one warp
//     instruction reads 32 / G rows; q . k reduces inside the group
//     (log2 G shuffles), and a warp folds 16 rows a step with one max
//     across its groups, one exp for the correction and one exp a row;
//   - a producer warp stages whole pool blocks of this head (block rows of
//     d elements, h * d apart) into a ring of kStages stages in shared
//     memory with 16-byte cp.async copies, each stage guarded by an
//     mbarrier pair (full: the copies landed, cp.async.mbarrier.arrive;
//     empty: its consumer warp is done), so several pool blocks a warp are
//     in flight outside registers; consumer warp w folds the stages
//     i = w, w + kConsumers, ... into its own online-softmax state (a
//     producer of TMA boxes, one [block, d] box of a 2-D tensor map over
//     the pool a half stage, timed within 2 % of these copies at the
//     GPT-2-small sites, was not kept: it adds two tensor-map encodings a
//     launch on the host);
//   - a thread-block cluster of P blocks a (head, sequence), P fixed on
//     the host from max_blocks alone (ceil(max_blocks / 32), at most 8: 2
//     at a 64-block table; 16 and 8 table blocks a rank, and 8 stages or
//     8 consumer warps, measured slower at the GPT-2-small sites),
//     launched with cudaLaunchKernelEx: rank r folds
//     the valid blocks [r * n / P, (r + 1) * n / P) of the sequence's n
//     (computed on the device from lengths[b]); after the cluster barrier
//     every rank reads the P x kConsumers warp states through distributed
//     shared memory and merges them in (rank, warp) order, writing the
//     output columns c = rank (mod P). A rank or warp that folded nothing
//     holds (NEG_INF, 0, 0), which merges as the identity.
// No float atomics, no second launch, no workspace: the order of every
// float operation depends on (lengths, block, max_blocks, h, d, the
// dtypes) alone, so two launches give the same bits.
//
// General body (paged_decode_kernel): every other shape (d = 80 in 16 bit,
// d > 128, a misaligned pool, a stage past 16 KB). One block of kWarps
// warps a (head, sequence); each warp folds a group of tokens at a time
// (16 / DPL of them, 2 at d > 128; groups dealt round robin to the
// warps), loading the whole group's K and V rows in the pool's type
// before converting any, into its own online-softmax state; its lanes hold
// d-slices (lane i owns elements i, i + 32, ...), the dot product is a
// butterfly of warp shuffles, so every lane holds the same bits of s, m
// and l. The warps' states then merge through shared memory in warp
// order. Any block size, any h, and d up to 256 run (d-slices of 1, 2, 4
// or 8 elements a lane).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>

#include "mma_sm80.cuh"

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// the staged body
// ---------------------------------------------------------------------------
constexpr int kConsumers = 4;                     // consumer warps
constexpr int kStagedThreads = 32 * (kConsumers + 1);
constexpr int kStages = 4;                        // a multiple of kConsumers
constexpr int kMaxRanks = 8;                      // portable cluster size
constexpr int kBlocksPerRank = 32;                // table blocks a rank
constexpr int kMaxStageBytes = 16 * 1024;
static_assert(kStages % kConsumers == 0, "a stage has one consumer warp");

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
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

// 16 bytes of VE pool elements as f32
template <typename TKV, int VE>
__device__ __forceinline__ void unpack16(const unsigned char* p,
                                         float (&out)[VE]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
  for (int i = 0; i < VE; ++i) out[i] = to_f(e[i]);
}

// G: lanes a row (d = G * 16 / sizeof(TKV)). Shared memory: the ring
// (kStages stages of K rows then V rows, each half half_bytes, 128-byte
// aligned), the full and empty mbarriers, then the consumer warps' states
// m [kConsumers], l [kConsumers], acc [kConsumers][d].
template <typename TQ, typename TKV, int G>
__global__ void __launch_bounds__(kStagedThreads)
    paged_decode_staged_kernel(const TQ* __restrict__ q,
                               const TKV* __restrict__ k_pool,
                               const TKV* __restrict__ v_pool,
                               const int* __restrict__ tables,
                               const int* __restrict__ lengths,
                               TQ* __restrict__ out, int heads, int block,
                               int max_blocks, float scale,
                               int half_bytes) {
  constexpr int VE = 16 / sizeof(TKV);   // elements a lane holds
  constexpr int D = G * VE;
  constexpr int TPW = 32 / G;            // rows a warp load covers
  constexpr int U = TPW >= 16 ? 1 : 16 / TPW;  // loads a step: 16 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  const int stage_bytes = 2 * half_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);
  uint64_t* empty = full + kStages;
  float* st_m = reinterpret_cast<float*>(empty + kStages);
  float* st_l = st_m + kConsumers;
  float* st_acc = st_l + kConsumers;

  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / P;
  const int seq = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = lengths[seq];
  const int cap = max_blocks * block;
  const int n_tok = len < cap ? len : cap;
  const int n_blk = n_tok > 0 ? (n_tok + block - 1) / block : 0;
  const int j0 = (int)((int64_t)rank * n_blk / P);
  const int nb = (int)((int64_t)(rank + 1) * n_blk / P) - j0;
  const int64_t qoff = ((int64_t)seq * heads + head) * D;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes
      mbar_init(&empty[s], 1);  // the stage's consumer warp
    }
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: pool block j0 + i into stage i % kStages
    const int* table = tables + (int64_t)seq * max_blocks;
    const int64_t row = (int64_t)heads * D;  // elements token to token
    for (int i = 0; i < nb; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      const int64_t base =
          (int64_t)__ldg(table + j0 + i) * block * row + (int64_t)head * D;
      unsigned char* dst = smem + s * stage_bytes;
      for (int p = lane; p < block * G; p += 32) {
        const int r = p / G, c = p % G;
        const int64_t src = base + r * row + c * VE;
        cp_async16(dst + p * 16, k_pool + src, true);
        cp_async16(dst + half_bytes + p * 16, v_pool + src, true);
      }
      mbar_arrive_cp_async(&full[s]);
    }
  } else {
    // consumer warp: lane = group * G + sub holds elements [sub * VE,
    // sub * VE + VE) of the group's row
    const int grp = lane / G;
    const int sub = lane % G;
    float qr[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) qr[e] = to_f(q[qoff + sub * VE + e]);
    float m = kNegInf, l = 0.f;
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
    for (int i = warp; i < nb; i += kConsumers) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const unsigned char* ks = smem + s * stage_bytes;
      const unsigned char* vs = ks + half_bytes;
      const int rows_left = n_tok - (j0 + i) * block;
      const int rows = rows_left < block ? rows_left : block;
      for (int r0 = 0; r0 < rows; r0 += TPW * U) {
        float sc[U];
        float cmax = kNegInf;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = r0 + u * TPW + grp;
          float dot = 0.f;
          if (r < rows) {
            float kf[VE];
            unpack16<TKV, VE>(ks + (r * G + sub) * 16, kf);
#pragma unroll
            for (int e = 0; e < VE; ++e) dot = fmaf(qr[e], kf[e], dot);
          }
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[u] = r < rows ? dot * scale : kNegInf;
          cmax = fmaxf(cmax, sc[u]);
        }
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        float p_sum = 0.f;
        float pv[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) pv[e] = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = r0 + u * TPW + grp;
          const float p = sc[u] <= kNegInf * 0.5f ? 0.f : expf(sc[u] - m_new);
          p_sum += p;
          if (r < rows) {
            float vf[VE];
            unpack16<TKV, VE>(vs + (r * G + sub) * 16, vf);
#pragma unroll
            for (int e = 0; e < VE; ++e) pv[e] = fmaf(p, vf[e], pv[e]);
          }
        }
        l = corr * l + p_sum;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(acc[e], corr, pv[e]);
        m = m_new;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the groups share m: their l and acc add up
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < VE; ++e) st_acc[warp * D + sub * VE + e] = acc[e];
    }
    if (lane == 0) {
      st_m[warp] = m;
      st_l[warp] = l;
    }
  }
  cluster.sync();

  // merge the P x kConsumers states in (rank, warp) order; this rank
  // writes the columns c = rank (mod P)
  const int c = rank + P * (int)threadIdx.x;
  if (c < D) {
    float m_all = kNegInf;
    for (int rr = 0; rr < P; ++rr) {
      const float* rm = cluster.map_shared_rank(st_m, rr);
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) m_all = fmaxf(m_all, rm[w]);
    }
    float l_all = 0.f, o = 0.f;
    for (int rr = 0; rr < P; ++rr) {
      const float* rm = cluster.map_shared_rank(st_m, rr);
      const float* rl = cluster.map_shared_rank(st_l, rr);
      const float* ra = cluster.map_shared_rank(st_acc, rr);
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) {
        const float cw = expf(rm[w] - m_all);
        l_all = fmaf(cw, rl[w], l_all);
        o = fmaf(cw, ra[w * D + c], o);
      }
    }
    out[qoff + c] = from_f<TQ>(o / fmaxf(l_all, 1e-30f));
  }
  // no block leaves while another reads its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// the general body
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
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

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

// The staged body's plan for these arguments: lanes a row (0 when the
// general body runs), ranks a cluster, the bytes of a stage's K half and
// of the whole shared memory.
struct StagedPlan {
  int lanes, ranks, half_bytes, smem;
};

StagedPlan staged_plan(const Args& a, int kv_dtype) {
  StagedPlan p{0, 1, 0, 0};
  const int esize = elem_bytes(kv_dtype);
  const int row_bytes = a.d * esize;
  const int g = row_bytes / 16;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.k_pool) & 15u) == 0 &&
                       (reinterpret_cast<uintptr_t>(a.v_pool) & 15u) == 0;
  if (a.d > 128 || row_bytes % 16 != 0 || g < 1 || g > 32 ||
      (g & (g - 1)) != 0 || !aligned ||
      2 * a.block * row_bytes > kMaxStageBytes)
    return p;
  p.lanes = g;
  p.ranks = (a.max_blocks + kBlocksPerRank - 1) / kBlocksPerRank;
  if (p.ranks > kMaxRanks) p.ranks = kMaxRanks;
  p.half_bytes = (a.block * row_bytes + 127) / 128 * 128;
  p.smem = 128 + kStages * 2 * p.half_bytes + 2 * kStages * 8 +
           (int)sizeof(float) * kConsumers * (2 + a.d);
  return p;
}

template <typename TQ, typename TKV, int G>
int launch_staged(const Args& a, const StagedPlan& p, cudaStream_t stream) {
  auto kernel = paged_decode_staged_kernel<TQ, TKV, G>;
  static std::atomic<uint32_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint32_t bit = 1u << (dev & 31);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               128 + kStages * kMaxStageBytes + 4096);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ranks * a.heads), (unsigned)a.batch);
  cfg.blockDim = dim3(kStagedThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool),
      a.tables, a.lengths, static_cast<TQ*>(a.out), a.heads, a.block,
      a.max_blocks, a.scale, p.half_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int DPL>
int launch_general(const Args& a, cudaStream_t stream) {
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
int by_width(const Args& a, int kv_dtype, cudaStream_t s) {
  const StagedPlan p = staged_plan(a, kv_dtype);
  switch (p.lanes) {
    case 1: return launch_staged<TQ, TKV, 1>(a, p, s);
    case 2: return launch_staged<TQ, TKV, 2>(a, p, s);
    case 4: return launch_staged<TQ, TKV, 4>(a, p, s);
    case 8: return launch_staged<TQ, TKV, 8>(a, p, s);
    case 16: return launch_staged<TQ, TKV, 16>(a, p, s);
    case 32: return launch_staged<TQ, TKV, 32>(a, p, s);
    default: break;
  }
  if (a.d <= 32) return launch_general<TQ, TKV, 1>(a, s);
  if (a.d <= 64) return launch_general<TQ, TKV, 2>(a, s);
  if (a.d <= 128) return launch_general<TQ, TKV, 4>(a, s);
  if (a.d <= 256) return launch_general<TQ, TKV, 8>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int by_pool_type(const Args& a, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 0) return by_width<TQ, float>(a, kv_dtype, s);
  if (kv_dtype == 1) return by_width<TQ, __nv_bfloat16>(a, kv_dtype, s);
  if (kv_dtype == 2) return by_width<TQ, __half>(a, kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

bool valid_args(int batch, int heads, int d, int block, int max_blocks) {
  return batch > 0 && heads > 0 && d > 0 && block > 0 && max_blocks > 0 &&
         batch <= 65535;
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
  if (!valid_args(batch, heads, d, block, max_blocks))
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

// The body dl4j_paged_decode takes for these arguments, as text in `out`
// (at most `len` bytes with its terminating 0). Launches nothing.
extern "C" int dl4j_paged_decode_describe(const void* k_pool,
                                          const void* v_pool, int batch,
                                          int heads, int d, int block,
                                          int max_blocks, int kv_dtype,
                                          char* out, int len) {
  if (!valid_args(batch, heads, d, block, max_blocks) ||
      kv_dtype < 0 || kv_dtype > 2 || len <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, k_pool, v_pool, nullptr, nullptr,    nullptr,
         batch,   heads,  d,      block,   max_blocks, 1.f};
  const StagedPlan p = staged_plan(a, kv_dtype);
  if (p.lanes > 0)
    snprintf(out, len,
             "staged: %d lanes a row, %d ranks a cluster, %d stages of %d "
             "bytes, %d bytes of shared memory",
             p.lanes, p.ranks, kStages,
             2 * p.half_bytes, p.smem);
  else
    snprintf(out, len, "general: %d warps a (head, sequence), %d elements "
             "a lane", kWarps, d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8);
  return 0;
}
