// Deterministic per-channel column sums over a contiguous channels-last
// [M, C] view in ONE launch, for the H100 (used by bn_train.cu's BN
// backward sums, kernel 5, and conv_epilogue.cu's channel statistics,
// kernel 3; an Op splits a row into a load and a fold, with the index
// type a template parameter).
//
// column_reduce.cuh sums in two launches (per-chunk partials, then a
// finalize kernel over them) on a grid of about eight waves, each block
// ending in a shared-memory tree of log2(rows) steps. At the small sites
// of a ResNet-50 step that fixed cost per site, not the bytes, set the
// pace. This body:
//
//   - grid (chunks, channel tiles), fixed by (M, C, element size) and the
//     Op's plan alone: about kTargetBlocks blocks (1.5 blocks an SM of
//     the H100's 132, a constant, not the device's count), each chunk at
//     least one unrolled pass of its row threads;
//   - a thread owns VEC neighbouring channels (one 16-byte vector where C
//     and the pointers allow it; bx <= 8 vectors make 128 contiguous
//     bytes of a row) and keeps Plan::kRows rows of its inputs in flight in
//     its unrolled row loop; registers capped for three blocks an SM;
//   - the block's rows combine by warp shuffles (lanes of one channel
//     group) and one pass over the warps' sums in shared memory;
//   - across blocks, without a second launch: each block writes its
//     chunk's [2, channels] partial to a workspace and one thread takes
//     an integer ticket of its group of Plan::kGroup chunks (an
//     acquire-release atomic add on an unsigned, not a float atomic); the
//     group's last block sums the group's partials in chunk order (to the
//     output when there is one group, else to a group partial) and
//     resets the ticket; with more than one group, the last group to
//     finish sums the group partials in group order into the output and
//     resets its ticket too. Those sums read Plan::kFinalVec values a load
//     (4: one 16-byte vector, where the tile allows it), so a block has
//     more lanes on a group's rows. (Clusters of 8 chunks meeting in
//     distributed shared memory in place of the first level timed
//     slower for kernel 5.)
//
// The plans (timed over a ResNet-50 step's 53 sites, PERF.md):
//   kernel 5 (x and dy): 4 rows in flight, groups of 16, scalar partial
//     loads (grids of 396, 264, 165 and 132 blocks, 64-chunk groups and
//     32 partial loads in flight were slower);
//   kernel 3 (x alone, half the bytes a row): 8 rows in flight, one
//     ticket level at every site, 16-byte partial loads (grids of 132
//     and 264 blocks were slower too; conv_epilogue.cu says what else
//     was timed).
//
// No float atomics: the order of every addition depends only on (M, C,
// the element size, the vector width) and the Op's plan, so two launches
// give the same bits. f32 accumulation for every input type, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn) inside the
// Op and __fadd_rn here.
//
// Tickets. They live in a zero-initialised device array of this library
// (no memset, no allocation a launch) and every launch leaves its own at
// zero. take_tickets gives each launch a range: an eager launch the range
// of its stream (launches on one stream run one after another), a launch
// captured into a CUDA graph a range of its own (the replays of one graph
// run one after another, and a graph's launches never share a range with
// a stream's). So two launches that can be in flight at once never share
// a ticket. The pool's first three quarters go to eager streams and
// captured launches for good. Past them, a graph's captured ranges are
// owned by one CUDA user object that the graph retains: when the graph
// and every executable instantiated from it are destroyed, its destructor
// returns them to a free list that later launches take from once the
// pool's never-used end is spent, so captures without end never exhaust
// it. The two sides serve two workloads. A graph that retains a user
// object costs a fixed 2.5-3.5 us of device time a replay, whatever it
// holds (scripts/graph_user_object_cost.py: the same with 1, 20 or 200
// launches; the runtime holds the object for each replay in flight):
// 0.5-1.4 % of a 20-launch replay of one of these kernels, as timed in
// chip_smoke.py, and nothing to speak of against a captured training or
// serving step of milliseconds. So processes that capture a bounded
// number of graphs (timing loops, tests, short runs: 3/4 of the pool is
// 12288 captured launches at the largest ResNet-50 site, 64 tickets
// each) keep their replays free of it, and processes that capture
// without end (a graph a step or a bucket, recaptured) pay it once a
// replay and get their ranges back. Each library that includes this
// header has its own array and its own ranges (take_tickets has internal
// linkage).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <iterator>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace dl4j {
namespace sm90 {

constexpr int kThreads = 256;
constexpr int kChannelThreads = 8;  // 8 x 16 bytes: 128 bytes of a row
                                    // (32, whole-row warps, was slower)
constexpr int kMinBlocksPerSm = 3;  // registers capped at 85
constexpr int64_t kTargetBlocks = 198;  // see the note at the top
constexpr int kBatch = 8;           // partial loads in flight a thread
                                    // (32 spilled in kernel 5)
constexpr int kMaxDevices = 64;
constexpr int64_t kTicketPool = int64_t(1) << 20;
// Captures take ranges that no graph owns while the pool's never-used end
// stays below this; past it, a graph's ranges are owned and come back
// (see take_tickets).
constexpr int64_t kUnownedTickets = kTicketPool / 4 * 3;

__device__ unsigned g_tickets[kTicketPool];

struct Geom {
  int vec;             // channels per thread
  int bx, by;          // block: channel x row threads
  int64_t ctiles;      // grid.y
  int64_t chunks;      // grid.x
  int64_t chunk_rows;  // rows per chunk (the last chunk may hold fewer)
  int64_t groups;      // ticket groups of Plan::kGroup chunks
  bool wide_index;     // 64-bit indices (M * C >= 2^30)
};

inline void block_shape(int64_t C, int vec, int& bx, int& by,
                        int64_t& ctiles) {
  const int64_t cv = C / vec;
  bx = 1;
  while (bx < cv && bx < kChannelThreads) bx <<= 1;
  by = kThreads / bx;
  ctiles = (cv + bx - 1) / bx;
}

// The chunking follows the nominal vector width (C % (16 / elem) == 0)
// and the Op's plan P, so for one plan the workspace depends on (M, C,
// element size) alone; `vec` drops to 1 where a pointer is not 16-byte
// aligned, which changes the block and the channel tiles but not the
// chunks.
template <class P>
Geom geom(int64_t M, int64_t C, int elem_bytes, bool aligned) {
  const int full = 16 / elem_bytes;
  const int nominal = (C % full == 0) ? full : 1;
  Geom g;
  int bx, by;
  int64_t ctiles;
  block_shape(C, nominal, bx, by, ctiles);
  const int64_t rows_min = (int64_t)by * P::kRows;
  int64_t max_chunks = (M + rows_min - 1) / rows_min;
  if (max_chunks < 1) max_chunks = 1;
  int64_t chunks = (kTargetBlocks + ctiles - 1) / ctiles;
  if (chunks > max_chunks) chunks = max_chunks;
  g.chunk_rows = (M + chunks - 1) / chunks;
  if (g.chunk_rows < 1) g.chunk_rows = 1;
  g.chunks = (M + g.chunk_rows - 1) / g.chunk_rows;
  if (g.chunks < 1) g.chunks = 1;
  g.groups = (g.chunks + P::kGroup - 1) / P::kGroup;
  g.vec = aligned ? nominal : 1;
  block_shape(C, g.vec, g.bx, g.by, g.ctiles);
  g.wide_index = M * C >= (int64_t(1) << 30);
  return g;
}

// f32 floats of the workspace: the chunk partials [chunks, 2, C], then
// (more than one group) the group partials [groups, 2, C].
inline int64_t workspace_floats(const Geom& g, int64_t C) {
  return (g.chunks + (g.groups > 1 ? g.groups : 0)) * 2 * C;
}

// Tickets of one launch: one a (channel tile, group), then one a channel
// tile where there is more than one group.
inline int64_t ticket_count(const Geom& g) {
  return g.ctiles * (g.groups + (g.groups > 1 ? 1 : 0));
}

// The geometry as text in `out` (at most `len` bytes with its
// terminating 0), for a plan of `rows` rows in flight.
inline void describe(const Geom& g, int rows, char* out, int len) {
  snprintf(out, len, "one launch, %s: %d channels a thread, %d rows in "
           "flight, block %dx%d, grid %lldx%lld (chunks of %lld rows x "
           "channel tiles), %lld ticket group(s), %d ticket level(s), %s "
           "indices", g.vec > 1 ? "16-byte vectors" : "scalar", g.vec, rows,
           g.bx, g.by, (long long)g.chunks, (long long)g.ctiles,
           (long long)g.chunk_rows, (long long)g.groups,
           g.groups > 1 ? 2 : 1, g.wide_index ? "64-bit" : "32-bit");
}

// The ranges a graph's captured launches took, owned by one CUDA user
// object of the graph (one object a graph, however many launches).
struct GraphRanges {
  int dev;
  unsigned long long capture;  // the capture's id
  std::vector<std::pair<int64_t, int64_t>> ranges;  // (offset, size)
};

// The ticket ranges of this library (static: its own, see take_tickets).
// An eager stream keeps its range for good; the ranges taken by launches
// captured into a CUDA graph go back to `free_ranges` when the graph and
// every executable made from it are destroyed.
struct TicketRanges {
  std::mutex mu;
  std::map<std::pair<int, uintptr_t>, std::pair<int64_t, int64_t>>
      eager;                                      // (device, stream) ->
                                                  // (offset, size)
  int64_t next[kMaxDevices] = {};                 // never handed out past
  std::map<int64_t, int64_t> free_ranges[kMaxDevices];  // offset -> size
  std::map<std::pair<int, unsigned long long>, GraphRanges*>
      capturing;                                  // (device, capture id)
  unsigned* base[kMaxDevices] = {};
};

static TicketRanges& ticket_ranges() {
  static TicketRanges r;
  return r;
}

// `n` tickets of `dev`: from the never-used end of the pool while it
// lasts, then first fit among the returned ranges; -1 once both are
// spent. Called with the lock held.
static int64_t claim_range(TicketRanges& r, int dev, int64_t n) {
  if (r.next[dev] + n <= kTicketPool) {
    const int64_t off = r.next[dev];
    r.next[dev] += n;
    return off;
  }
  auto& fr = r.free_ranges[dev];
  for (auto it = fr.begin(); it != fr.end(); ++it) {
    if (it->second < n) continue;
    const int64_t off = it->first, left = it->second - n;
    fr.erase(it);
    if (left > 0) fr[off + n] = left;
    return off;
  }
  return -1;
}

// A range back to the free list, merged with its neighbours. Called with
// the lock held.
static void give_back(std::map<int64_t, int64_t>& fr, int64_t off,
                      int64_t size) {
  auto it = fr.emplace(off, size).first;
  auto nx = std::next(it);
  if (nx != fr.end() && it->first + it->second == nx->first) {
    it->second += nx->second;
    fr.erase(nx);
  }
  if (it != fr.begin()) {
    auto pv = std::prev(it);
    if (pv->first + pv->second == it->first) {
      pv->second += it->second;
      fr.erase(it);
    }
  }
}

// The user object's destructor: the graph's ranges go back to the free
// list. CUDA runs it once the graph and all its executables are gone, on
// a thread of its own, and it may call no CUDA function: it only takes
// the lock.
static void CUDART_CB release_graph_ranges(void* p) {
  GraphRanges* g = static_cast<GraphRanges*>(p);
  TicketRanges& r = ticket_ranges();
  {
    std::lock_guard<std::mutex> lock(r.mu);
    auto it = r.capturing.find({g->dev, g->capture});
    if (it != r.capturing.end() && it->second == g) r.capturing.erase(it);
    for (const auto& rg : g->ranges)
      give_back(r.free_ranges[g->dev], rg.first, rg.second);
  }
  delete g;
}

// `need` tickets for a launch on `stream` (see the note at the top);
// cudaErrorMemoryAllocation once the pool is spent. Under capture, once
// the pool's never-used end has passed kUnownedTickets, the range joins
// the ranges of the graph being captured, which a user object of the
// graph owns, so it returns to the pool when the graph is destroyed.
// Static: its ranges and the array's address are this
// library's own (an inline function's statics would be one object for
// the whole process).
static int take_tickets(cudaStream_t stream, int64_t need,
                        unsigned** out) {
  TicketRanges& r = ticket_ranges();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStreamCaptureStatus st = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  cudaGraph_t graph = nullptr;
  err = cudaStreamGetCaptureInfo(stream, &st, &capture, &graph);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(r.mu);
  if (r.base[dev] == nullptr) {
    err = cudaGetSymbolAddress(reinterpret_cast<void**>(&r.base[dev]),
                               g_tickets);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t off;
  if (st == cudaStreamCaptureStatusActive &&
      r.next[dev] + need <= kUnownedTickets) {
    // the pool's first three quarters go to captures unowned, as eager
    // ranges do, so their graphs replay without a user object's fixed
    // cost (see the note at the top)
    off = claim_range(r, dev, need);
  } else if (st == cudaStreamCaptureStatusActive) {
    GraphRanges*& owner = r.capturing[{dev, capture}];
    if (owner == nullptr) {
      GraphRanges* g = new GraphRanges{dev, capture, {}};
      cudaUserObject_t obj;
      err = cudaUserObjectCreate(&obj, g, release_graph_ranges, 1,
                                 cudaUserObjectNoDestructorSync);
      if (err == cudaSuccess)
        err = cudaGraphRetainUserObject(graph, obj, 1,
                                        cudaGraphUserObjectMove);
      if (err != cudaSuccess) {
        r.capturing.erase({dev, capture});
        delete g;
        return (int)err;
      }
      owner = g;
    }
    off = claim_range(r, dev, need);
    if (off < 0) return (int)cudaErrorMemoryAllocation;
    owner->ranges.emplace_back(off, need);
  } else if (st != cudaStreamCaptureStatusNone) {
    return (int)cudaErrorStreamCaptureInvalidated;
  } else {
    auto& e = r.eager[{dev, reinterpret_cast<uintptr_t>(stream)}];
    if (e.second < need) {
      const int64_t n = need < 4096 ? 4096 : need;
      e.first = claim_range(r, dev, n);
      e.second = e.first < 0 ? 0 : n;
    }
    off = e.first;
    if (off < 0) return (int)cudaErrorMemoryAllocation;
  }
  *out = r.base[dev] + off;
  return 0;
}

// One integer ticket: atomicAdd with acquire-release semantics at GPU
// scope. Its caller is one thread after a block barrier, so the block's
// earlier writes are released with it, and after the next barrier the
// block's later reads see what the other blocks released.
__device__ __forceinline__ unsigned take_ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// rows [first, end) of a [rows, 2, C] f32 array summed in row order for
// this block's channel tile, into dst[which * C + channel]; every thread
// of the block calls it. A thread owns P neighbouring values of the tile
// (P = 4: one 16-byte load a row; the caller guarantees C % 4 == 0 and
// 16-byte aligned arrays); lanes j = 0.. J-1 of a value sum every J-th
// row, kBatch loads in flight at a time, then their sums add in lane
// order. `fin` holds kThreads * P floats.
template <int VEC, int P>
__device__ __forceinline__ void sum_rows(const float* __restrict__ src,
                                         int64_t first, int64_t end,
                                         float* __restrict__ dst,
                                         int64_t C, int bx, int64_t ctile,
                                         float* fin) {
  static_assert(P == 1 || P == 4, "one value or one 16-byte vector");
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int width = bx * VEC;   // channels of the tile
  const int nv = 2 * width / P; // <= 2 * 8 * kChannelThreads <= kThreads / 2
  const int J = kThreads / nv;
  const int i = t % nv, j = t / nv;
  const int which = i * P / width;
  const int64_t ch = ctile * width + (i * P) % width;
  float a[P];
#pragma unroll
  for (int p = 0; p < P; ++p) a[p] = 0.f;
  if (ch < C) {
    for (int64_t r = first + j; r < end; r += kBatch * J) {
      float v[kBatch][P];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float* q = src + ((r + k * J) * 2 + which) * C + ch;
        if constexpr (P == 4) {
          const float4 f = r + k * J < end
                               ? __ldcg(reinterpret_cast<const float4*>(q))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          v[k][0] = f.x;
          v[k][1] = f.y;
          v[k][2] = f.z;
          v[k][3] = f.w;
        } else {
          v[k][0] = r + k * J < end ? __ldcg(q) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (r + k * J < end) {
#pragma unroll
          for (int p = 0; p < P; ++p) a[p] = __fadd_rn(a[p], v[k][p]);
        }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) fin[p * kThreads + t] = a[p];
  __syncthreads();
  // one thread a value of the tile adds its J lanes in lane order
  if (t < nv * P) {
    const int iv = t / P, p = t % P;
    const int k = iv * P + p;
    const int64_t c = ctile * width + k % width;
    if (c < C) {
      float tot = fin[p * kThreads + iv];
      for (int jj = 1; jj < J; ++jj)
        tot = __fadd_rn(tot, fin[p * kThreads + jj * nv + iv]);
      dst[(k / width) * C + c] = tot;
    }
  }
}

// Op supplies its plan, typename Op::Plan, a type with the static
// constexpr members kRows (rows in flight a row thread), kGroup (chunks a
// first-level ticket gathers) and kFinalVec (1 or 4: values a load in
// the partials' sums, 4 taken where VEC >= 4); and, for the VEC channels
// from c0:
//   typename Op::Raw: one row's inputs as loaded (16-byte vectors kept
//       raw, converted at use);
//   __device__ void begin(I c0);  once per thread, on the thread's own
//       copy of the Op, before the row loop (per-channel coefficients
//       into registers);
//   __device__ void load(I r, I c0, Raw& raw) const;  row r's loads;
//   __device__ void fold(const Raw& raw, float (&s0)[VEC],
//       float (&s1)[VEC]) const;  its two terms per channel added into
//       s0 and s1.
// The kernel issues kRows rows' loads before it folds any of them, so
// they are in flight together (a fold between two loads would wait for
// the first before the second could start).
template <int VEC, class Op, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
column_sums_sm90_kernel(const Op op, float* __restrict__ work,
                        float* __restrict__ out,
                        unsigned* __restrict__ tickets, I M, I C,
                        I chunk_rows, int chunks, int groups) {
  constexpr int kWarps = kThreads / 32;
  using Plan = typename Op::Plan;
  constexpr int kRows = Plan::kRows;
  constexpr int kGroup = Plan::kGroup;
  constexpr int kFinal = VEC >= 4 ? Plan::kFinalVec : 1;
  __shared__ float sh[kWarps][2 * VEC * kChannelThreads];
  __shared__ float fin[kThreads * kFinal];
  __shared__ int is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int t = ty * bx + tx;
  const int64_t ctile = blockIdx.y;
  const int chunk = blockIdx.x;
  const I c0 = ((I)ctile * (I)bx + (I)tx) * VEC;
  const I r0 = (I)chunk * chunk_rows;
  const I r1 = r0 + chunk_rows < M ? r0 + chunk_rows : M;
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s0[v] = s1[v] = 0.f;
  if (c0 < C) {
    Op mine = op;
    mine.begin(c0);
    // kRows rows of each input in flight, added in row order
    for (I r = r0 + (I)ty; r < r1; r += (I)(kRows * by)) {
      typename Op::Raw raw[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (r + (I)(u * by) < r1) mine.load(r + (I)(u * by), c0, raw[u]);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (r + (I)(u * by) < r1) mine.fold(raw[u], s0, s1);
    }
  }
  // the warp's row threads of each channel group (lanes bx apart)
  for (int off = bx; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s0[v] = __fadd_rn(s0[v], __shfl_xor_sync(0xffffffffu, s0[v], off));
      s1[v] = __fadd_rn(s1[v], __shfl_xor_sync(0xffffffffu, s1[v], off));
    }
  }
  if ((t & 31) < bx) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh[t >> 5][v * bx + tx] = s0[v];
      sh[t >> 5][(VEC + v) * bx + tx] = s1[v];
    }
  }
  __syncthreads();
  // the warps in order: this chunk's partial, [2, channels of the tile]
  const int width = bx * VEC;
  if (t < 2 * width) {
    const int which = t / width, cl = t % width;
    const int64_t ch = ctile * width + cl;
    const int k = which * VEC + cl % VEC;
    const int x = cl / VEC;
    float a = sh[0][k * bx + x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, sh[w][k * bx + x]);
    if (ch < C) work[((int64_t)chunk * 2 + which) * C + ch] = a;
  }
  __syncthreads();
  const int grp = chunk / kGroup;
  if (t == 0) {
    const int in_grp =
        chunks - grp * kGroup < kGroup ? chunks - grp * kGroup : kGroup;
    unsigned* tk = tickets + ctile * groups + grp;
    is_last = take_ticket(tk) == (unsigned)(in_grp - 1);
    if (is_last) *tk = 0u;  // every block of the group has taken one
  }
  __syncthreads();
  if (!is_last) return;
  const int64_t first = (int64_t)grp * kGroup;
  const int64_t end = first + kGroup < chunks ? first + kGroup : chunks;
  if (groups == 1) {
    sum_rows<VEC, kFinal>(work, first, end, out, C, bx, ctile, fin);
    return;
  }
  float* gwork = work + (int64_t)chunks * 2 * C;
  sum_rows<VEC, kFinal>(work, first, end, gwork + (int64_t)grp * 2 * C, C,
                        bx, ctile, fin);
  __syncthreads();
  if (t == 0) {
    unsigned* tk = tickets + (int64_t)gridDim.y * groups + ctile;
    is_last = take_ticket(tk) == (unsigned)(groups - 1);
    if (is_last) *tk = 0u;
  }
  __syncthreads();
  if (!is_last) return;
  sum_rows<VEC, kFinal>(gwork, 0, groups, out, C, bx, ctile, fin);
}

// One launch on `stream`: `work` holds workspace_floats(g, C) floats,
// `out` 2 * C. Returns the cudaError_t (0 on success).
template <int VEC, class Op, typename I>
int launch_column_sums(const Op& op, const Geom& g, float* work, float* out,
                       int64_t M, int64_t C, cudaStream_t stream) {
  if (g.ctiles > 65535 || g.chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  unsigned* tickets = nullptr;
  const int rc = take_tickets(stream, ticket_count(g), &tickets);
  if (rc != 0) return rc;
  const dim3 block(g.bx, g.by);
  const dim3 grid((unsigned)g.chunks, (unsigned)g.ctiles);
  column_sums_sm90_kernel<VEC, Op, I><<<grid, block, 0, stream>>>(
      op, work, out, tickets, (I)M, (I)C, (I)g.chunk_rows, (int)g.chunks,
      (int)g.groups);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace dl4j
