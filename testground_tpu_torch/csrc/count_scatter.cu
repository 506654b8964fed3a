// The count-mode ordered scatter-add, for Hopper (sm_90a).
//
// The port's own kernel: no TPU kernel stands behind it. The JAX package
// adds count-mode deliveries with XLA's scatter (buf.at[safe_dest].add,
// testground_tpu/sim/net.py:1313, and buf.at[b, safe_dest].add, :1343),
// which on the CPU adds each destination's updates in lane order. A
// float sum depends on that order, and CUDA's index_add_ adds with float
// atomics in an order that changes from run to run. This kernel adds in
// lane order, so the card gives the CPU's and the JAX package's bits.
//
// Function: out = buf, then for every lane i with idx[i] < R (as
// unsigned: other lanes are dropped) out[idx[i]] += upd[i], each row's
// adds in increasing lane order. buf and out f32 [R, 2], idx int32 [L],
// upd f32 [L, 2]. No float atomics; integer atomics only count and place.
//
// What bounds it: memory, and at storm's shapes the chain of block-wide
// steps. The function must read every index, each kept lane's update and
// each touched row, write each touched row, and copy the rest of buf
// (R x 8 B each way: 80 KB at R = 10k, 5.1 MB for the delay wheel). A
// row's fold is sequential (float adds in lane order), so the
// parallelism is across rows. A device-wide sort of all L lanes spends
// most of its time on lanes that are dropped (storm keeps ~5% a tick),
// so neither plan sorts on the device as a whole. The wrapper picks the
// plan from (L, R) alone.
//
// Small plan (L <= kSmallMax, storm's staging row and wheel): ONE launch
// of one 1,024-thread block per SM. Block b owns the rows [b*RB, b*RB +
// RB), copies them into out, and reads all of idx (at most 48 KB, from
// L2) to find the lanes into its rows:
//   1. compacts them in lane order (ballots and one block scan of the
//      per-(step, warp) counts), keys relative to the block's first row;
//   2. up to kScanMax of them (the common case: ~50 at storm's shapes):
//      no sort. Each lane looks for an earlier lane of its row; the first
//      lane of each row folds the row's later lanes, in order, from the
//      block's list in shared memory;
//   3. more (a hot row, a heavy wheel bucket): a stable LSD radix sort of
//      (key, lane) in shared memory over the block's key bits (7 for the
//      staging row, 13 for the wheel; 8-bit digits). Each warp owns a
//      contiguous run of the current order; ballots give a step's ranks
//      and a per-(digit, warp) counter needs no atomics; the counters'
//      digit-major scan gives the stable positions. Then each run's first
//      position folds the run, its loads a batch ahead of the adds.
// Each block writes only the rows it copied, so no block waits on
// another.
//
// Large plan (L > kSmallMax: the 1,000,003 checks): six launches, each
// kernel boundary a grid-wide barrier, no sort:
//   A. out = buf and the per-row counts cleared;
//   B. each kept lane's arrival rank in its row: atomicAdd on the count;
//   C. the first arrival of each row: a row of one lane (two in three
//      touched rows at 1M uniform) is folded at once; a longer row
//      reserves its segment (a block scan of the counts and one atomicAdd
//      a block on a global cursor), and past kShort lanes joins a list;
//   D. each lane of a row of two or more writes its lane id at segment
//      base + rank;
//   E. rows of 2 to kShort lanes, by their first arrival: the segment's
//      lanes smallest first (arrival order is not lane order);
//   F. the listed rows, one block a row: up to kSmallMax lanes are
//      ordered by the block's radix sort on the lane id, gathered and
//      folded from shared memory; a longer row (seven rows at 1M: ~100k
//      lanes each) is found by scanning idx in order in tiles of kTile
//      lanes with an ordered compaction, each tile folded after the last.
//
// Scratch: the wrapper allocates the large plan's index arrays with
// torch.empty; A clears what must start at zero. Built with
// -DSCATTER_TRACE, each small-plan block stamps %globaltimer at its phase
// boundaries into `trace` (chip_smoke.py phase 10 reads them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // an ordering block
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kSmallMax = 12288;  // lanes the ordering block holds
constexpr int kMaxSteps = kSmallMax / kThreads;
constexpr int kScanMax = 256;  // a block's lanes it folds unsorted
constexpr int kMinRowsPerBlock = 64;
constexpr int kShort = 32;  // rows a lone thread orders
constexpr int kTile = 16384;  // lanes a long-row scan takes at a time
constexpr int kTileSteps = kTile / kThreads;
constexpr int kLaneThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTraceStamps = 8;  // a block's: 5 phase boundaries, its lanes

#ifdef SCATTER_TRACE
#define TRACE(k)                                                          \
  do {                                                                    \
    if (threadIdx.x == 0 && trace != nullptr) {                           \
      unsigned long long ns;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));              \
      trace[blockIdx.x * kTraceStamps + (k)] = ns;                        \
    }                                                                     \
  } while (0)
#else
#define TRACE(k) \
  do {           \
  } while (0)
#endif

// The ordering block's dynamic shared memory: two regions of (key, val)
// for the radix sort's ping-pong, and the per-(digit, warp) counters. A
// region free after the sort holds kSmallMax float2 updates; both hold a
// scan tile's kTile updates.
struct Smem {
  int buf[2][2][kSmallMax];  // [region][key, val][position]
  int hist[kBins * (kWarps + 1)];  // digit-major: [digit][warp], padded
};
static_assert(2 * kSmallMax * 2 * sizeof(int) >= kTile * sizeof(float2),
              "a scan tile's updates fit the two regions");
static_assert(kTileSteps * kWarps <= kBins * kWarps, "tile counts fit");
static_assert(kScanMax <= kThreads, "one unsorted lane a thread");

// The lanes of this warp whose digit d (0 <= d < 2 * kBins) equals this
// lane's: one ballot a bit.
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b <= kRadixBits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ bool kept_key(int key, int rows) {
  return (unsigned)key < (unsigned)rows;
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// Exclusive scan of a[0, n) in place by the whole (kThreads) block, each
// thread a contiguous run of odd length (so a warp's runs start in 32
// different banks); returns the total. Begins after and ends with a
// __syncthreads.
__device__ int block_scan(int* a, int n, int* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = ((n + kThreads - 1) / kThreads) | 1;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;  // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = red[lane];
    int v = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    red[lane] = v - w;
    if (lane == 31) red[kWarps] = v;
  }
  __syncthreads();
  int run = red[warp] + x - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = red[kWarps];
  __syncthreads();
  return total;
}

// One stable pass of the LSD sort: the k items of region src, ordered by
// the digit at `shift`, into region src ^ 1. The first nw warps (one
// per 32 items, at most kWarps) sort: warp w owns the contiguous run
// [w * chunk, (w + 1) * chunk) and walks it 32 items a step, in order;
// only warp w places into column w of the counters [digit][nw + 1],
// whose digit-major scan gives the stable positions.
__device__ void radix_pass(Smem& s, int src, int k, int shift, int* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = min(kWarps, (k + 31) / 32);
  const int stride = nw + 1;
  const int n_hist = kBins * stride;
  for (int i = t; i < n_hist; i += kThreads) s.hist[i] = 0;
  __syncthreads();
  const int chunk = ((k + nw - 1) / nw + 31) & ~31;
  const int lo = min(warp * chunk, k), hi = min(lo + chunk, k);
  const int* key = s.buf[src][0];
  const int* val = s.buf[src][1];
  for (int i = lo + lane; i < hi; i += 32)  // counts: order-free
    atomicAdd(&s.hist[((key[i] >> shift) & (kBins - 1)) * stride + warp], 1);
  __syncthreads();
  block_scan(s.hist, n_hist, red);
  int* dkey = s.buf[src ^ 1][0];
  int* dval = s.buf[src ^ 1][1];
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool in = i < hi;
    const int kk = in ? key[i] : 0;
    const int d = in ? (kk >> shift) & (kBins - 1) : kBins;
    const unsigned peers = match_digit(d);
    const int leader = __ffs(peers) - 1;
    int off = 0;
    if (in && lane == leader) {
      off = s.hist[d * stride + warp];
      s.hist[d * stride + warp] = off + __popc(peers);
    }
    off = __shfl_sync(kFull, off, leader);
    if (in) {
      const int p = off + __popc(peers & lanemask_lt());
      dkey[p] = kk;
      dval[p] = val[i];
    }
  }
  __syncthreads();
}

// Stable sort of region 0's k items by the low `bits` bits of the key;
// returns the region that holds the result.
__device__ int radix_sort(Smem& s, int k, int bits, int* red) {
  int r = 0;
  if (k <= 1) return r;
  for (int shift = 0; shift < bits; shift += kRadixBits) {
    radix_pass(s, r, k, shift, red);
    r ^= 1;
  }
  return r;
}

// The first position past p's run of equal keys in the sorted K[0, k):
// one load for a run of one, a galloping then binary search for longer.
__device__ int run_end(const int* K, int p, int k) {
  const int key = K[p];
  int lo = p + 1;  // K[lo - 1] == key
  if (lo >= k || K[lo] != key) return lo;
  int step = 1, hi = lo + 1;  // from here K[lo] == key
  while (hi < k && K[hi] == key) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  hi = min(hi, k);  // K[hi] != key, or hi == k
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (K[mid] == key) lo = mid;
    else hi = mid;
  }
  return hi;
}

// acc + u[s] + u[s + 1] + ... + u[e - 1], in that order. Each batch of
// eight loads is issued before the previous batch's adds, so the chain
// of dependent adds sets the pace.
__device__ float2 fold_range(const float2* u, int s, int e, float2 acc) {
  if (e - s >= 8) {
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = u[s + q];
    for (; s + 16 <= e; s += 8) {
      float2 w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = u[s + 8 + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc = add2(acc, v[q]);
        v[q] = w[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = add2(acc, v[q]);
    s += 8;
  }
  for (; s < e; ++s) acc = add2(acc, u[s]);
  return acc;
}

// out[r] = buf[r] for the rows [r0, r1) split over nb blocks, this being
// block b (four rows a thread in flight)
__device__ void copy_rows(const float2* __restrict__ buf,
                          float2* __restrict__ out, long long r0,
                          long long r1, int b, int nb) {
  const long long stride = (long long)nb * blockDim.x;
  long long r = r0 + (long long)b * blockDim.x + threadIdx.x;
  for (; r + 3 * stride < r1; r += 4 * stride) {
    const float2 v0 = buf[r], v1 = buf[r + stride], v2 = buf[r + 2 * stride],
                 v3 = buf[r + 3 * stride];
    out[r] = v0;
    out[r + stride] = v1;
    out[r + 2 * stride] = v2;
    out[r + 3 * stride] = v3;
  }
  for (; r < r1; r += stride) out[r] = buf[r];
}

// ------------------------------------------------------------ small plan

__global__ void __launch_bounds__(kThreads, 1)
small_kernel(const int* __restrict__ idx, const float2* __restrict__ upd,
             const float2* __restrict__ buf, float2* __restrict__ out, int L,
             int R, int rows_per_block, unsigned long long* trace) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  __shared__ int red[kWarps + 1];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = max(0, min(rows_per_block, R - r0));
  TRACE(0);
  copy_rows(buf, out, r0, r0 + nrows, 0, 1);
  // 1. the lanes into this block's rows, compacted in lane order: lane
  // j * kThreads + t is this thread's step j. Every load first, then the
  // ballots (a ballot between two loads would wait for the first).
  const int steps = (L + kThreads - 1) / kThreads;
  unsigned key[kMaxSteps];
#pragma unroll
  for (int j = 0; j < kMaxSteps; ++j) {
    const int i = j * kThreads + t;
    key[j] = j < steps && i < L ? (unsigned)idx[i] - (unsigned)r0
                                : 0xffffffffu;
  }
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kMaxSteps; ++j) {
    if (j < steps) {
      const bool in = key[j] < (unsigned)nrows;
      const unsigned b = __ballot_sync(kFull, in);
      if (lane == 0) s.hist[j * kWarps + warp] = __popc(b);
      mine |= (unsigned)in << j;
    }
  }
  __syncthreads();
  const int k = block_scan(s.hist, steps * kWarps, red);
#pragma unroll
  for (int j = 0; j < kMaxSteps; ++j) {
    if (j < steps) {
      const bool in = (mine >> j) & 1u;
      const unsigned b = __ballot_sync(kFull, in);
      if (in) {
        const int p = s.hist[j * kWarps + warp] + __popc(b & lanemask_lt());
        s.buf[0][0][p] = (int)key[j];
        s.buf[0][1][p] = j * kThreads + t;
      }
    }
  }
  __syncthreads();
  TRACE(1);
#ifdef SCATTER_TRACE
  if (t == 0 && trace != nullptr) trace[blockIdx.x * kTraceStamps + 7] = k;
#endif
  if (k <= kScanMax) {
    // 2. unsorted: the row's first lane folds the row's later lanes
    const int* K = s.buf[0][0];
    float2* u = reinterpret_cast<float2*>(s.buf[1][0]);
    int key_t = 0;
    float2 row = make_float2(0.f, 0.f);
    if (t < k) {
      key_t = K[t];
      row = buf[r0 + key_t];
      u[t] = upd[s.buf[0][1][t]];
    }
    __syncthreads();
    TRACE(2);
    TRACE(3);
    if (t < k) {  // (no early exit: the loads stay in flight together)
      bool first = true;
#pragma unroll 8
      for (int m = 0; m < t; ++m) first &= K[m] != key_t;
      if (first) {
        float2 acc = add2(row, u[t]);
#pragma unroll 8
        for (int m = t + 1; m < k; ++m)
          if (K[m] == key_t) acc = add2(acc, u[m]);
        out[r0 + key_t] = acc;
      }
    }
  } else {
    // 3. sorted by key, then each run folded by its first position
    int bits = 0;
    while ((1 << bits) < nrows) ++bits;
    const int r = radix_sort(s, k, bits, red);
    TRACE(2);
    const int* K = s.buf[r][0];
    const int* V = s.buf[r][1];
    // the updates in sorted order, the first of each run already added to
    // its row (the fold's first add); four lanes' loads in flight
    float2* u = reinterpret_cast<float2*>(s.buf[r ^ 1][0]);
    for (int p0 = t; p0 < k; p0 += 4 * kThreads) {
      float2 w[4], row[4];
      bool head[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q * kThreads;
        head[q] = p < k && (p == 0 || K[p - 1] != K[p]);
        if (p < k) w[q] = upd[V[p]];
        if (head[q]) row[q] = buf[r0 + K[p]];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q * kThreads;
        if (p < k) u[p] = head[q] ? add2(row[q], w[q]) : w[q];
      }
    }
    __syncthreads();
    TRACE(3);
    for (int p = t; p < k; p += kThreads) {
      if (p > 0 && K[p - 1] == K[p]) continue;
      out[r0 + K[p]] = fold_range(u, p + 1, run_end(K, p, k), u[p]);
    }
  }
#ifdef SCATTER_TRACE
  __syncthreads();
  TRACE(4);
#endif
}

// ------------------------------------------------------------ large plan

// The large plan's per-row state: the row's lane count and, for a row of
// two lanes or more, its segment's base (one sector for both).
__global__ void copy_clear_kernel(const float2* __restrict__ buf,
                                  float2* __restrict__ out, int R,
                                  int2* __restrict__ rows,
                                  int* __restrict__ ctr) {
  copy_rows(buf, out, 0, R, blockIdx.x, gridDim.x);
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += (long long)gridDim.x * blockDim.x)
    rows[r] = make_int2(0, 0);
  if (blockIdx.x == 0 && threadIdx.x < 4) ctr[threadIdx.x] = 0;
}

__global__ void count_kernel(const int* __restrict__ idx, int L, int R,
                             int2* __restrict__ rows,
                             int* __restrict__ rank) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const int d = idx[i];
  if (kept_key(d, R)) rank[i] = atomicAdd(&rows[d].x, 1);
}

// The first arrival of each row: a row of one lane is folded here; a
// longer one reserves its segment (and, past kShort, joins the list).
__global__ void __launch_bounds__(kThreads)
alloc_kernel(const int* __restrict__ idx, const float2* __restrict__ upd,
             const float2* __restrict__ buf, float2* __restrict__ out, int L,
             int R, int2* __restrict__ rows, const int* __restrict__ rank,
             int* __restrict__ ctr, int* __restrict__ list) {
  __shared__ int a[kThreads];
  __shared__ int red[kWarps + 1];
  __shared__ int s_base;
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  const int d = i < L ? idx[i] : R;
  const int k = kept_key(d, R) && rank[i] == 0 ? rows[d].x : 0;
  if (k == 1) out[d] = add2(buf[d], upd[i]);
  a[t] = k > 1 ? k : 0;
  __syncthreads();
  const int total = block_scan(a, kThreads, red);
  if (t == 0) s_base = atomicAdd(&ctr[0], total);
  __syncthreads();
  if (k > 1) {
    rows[d].y = s_base + a[t];
    if (k > kShort) list[atomicAdd(&ctr[1], 1)] = d;
  }
}

__global__ void place_kernel(const int* __restrict__ idx, int L, int R,
                             const int2* __restrict__ rows,
                             const int* __restrict__ rank,
                             int* __restrict__ seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const int d = idx[i];
  if (!kept_key(d, R)) return;
  const int2 row = rows[d];
  if (row.x > 1) seg[row.y + rank[i]] = i;
}

__global__ void short_kernel(const int* __restrict__ idx,
                             const float2* __restrict__ upd,
                             const float2* __restrict__ buf,
                             float2* __restrict__ out, int L, int R,
                             const int2* __restrict__ rows,
                             const int* __restrict__ rank,
                             const int* __restrict__ seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const int d = idx[i];
  if (!kept_key(d, R) || rank[i] != 0) return;
  const int2 row = rows[d];
  if (row.x < 2 || row.x > kShort) return;
  // arrival order is not lane order: take the segment's lanes smallest
  // first, each by a pass over the (cached) segment
  const int* sg = seg + row.y;
  float2 acc = buf[d];
  int prev = -1;
  for (int j = 0; j < row.x; ++j) {
    int next = 0x7fffffff;
    for (int m = 0; m < row.x; ++m) {
      const int x = sg[m];
      if (x > prev && x < next) next = x;
    }
    acc = add2(acc, upd[next]);
    prev = next;
  }
  out[d] = acc;
}

__global__ void __launch_bounds__(kThreads, 1)
long_kernel(const int* __restrict__ idx, const float2* __restrict__ upd,
            const float2* __restrict__ buf, float2* __restrict__ out, int L,
            int lane_bits, const int2* __restrict__ rows,
            const int* __restrict__ seg,
            const int* __restrict__ list, const int* __restrict__ ctr) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  __shared__ int red[kWarps + 1];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_long = ctr[1];
  for (int e = blockIdx.x; e < n_long; e += gridDim.x) {
    const int d = list[e];
    const int k = rows[d].x;
    float2 acc = buf[d];
    if (k <= kSmallMax) {  // the segment, ordered by lane id
      const int b = rows[d].y;
      for (int p = t; p < k; p += kThreads) {
        const int x = seg[b + p];
        s.buf[0][0][p] = x;
        s.buf[0][1][p] = x;
      }
      __syncthreads();
      const int r = radix_sort(s, k, lane_bits, red);
      const int* K = s.buf[r][0];
      float2* u = reinterpret_cast<float2*>(s.buf[r ^ 1][0]);
      for (int p = t; p < k; p += kThreads) u[p] = upd[K[p]];
      __syncthreads();
      if (t == 0) out[d] = fold_range(u, 0, k, acc);
    } else {  // idx scanned in order, a tile at a time
      float2* u = reinterpret_cast<float2*>(s.buf[0][0]);
      for (int t0 = 0; t0 < L; t0 += kTile) {
        unsigned hit = 0;
#pragma unroll
        for (int j = 0; j < kTileSteps; ++j) {
          const int i = t0 + j * kThreads + t;
          const bool in = i < L && idx[i] == d;
          const unsigned bb = __ballot_sync(kFull, in);
          if (lane == 0) s.hist[j * kWarps + warp] = __popc(bb);
          hit |= (unsigned)in << j;
        }
        __syncthreads();
        const int m = block_scan(s.hist, kTileSteps * kWarps, red);
#pragma unroll
        for (int j = 0; j < kTileSteps; ++j) {
          const bool in = (hit >> j) & 1u;
          const unsigned bb = __ballot_sync(kFull, in);
          if (in)
            u[s.hist[j * kWarps + warp] + __popc(bb & lanemask_lt())] =
                upd[t0 + j * kThreads + t];
        }
        __syncthreads();
        if (t == 0) acc = fold_range(u, 0, m, acc);
        __syncthreads();
      }
      if (t == 0) out[d] = acc;
    }
    __syncthreads();  // before the next row reuses shared memory
  }
}

int g_sms = 132;

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int bits_of(long long n) {  // bits that hold every value below n
  int b = 0;
  while (b < 31 && (1ll << b) < n) ++b;
  return b;
}

// Rows a small-plan block owns for R rows: an SM's share, at least
// kMinRowsPerBlock.
int small_rows_per_block(long long R) {
  const int rows = ceil_div(R, g_sms);
  return rows < kMinRowsPerBlock ? kMinRowsPerBlock : rows;
}

}  // namespace

// Sets the ordering kernels' shared-memory limit and reads the SM count;
// once, when the library is loaded (not inside a CUDA-graph capture).
extern "C" int count_scatter_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(small_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(long_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  return (int)err;
}

extern "C" int count_scatter_small_max() { return kSmallMax; }

extern "C" int count_scatter_short() { return kShort; }

// Blocks of the small plan for R rows (at most one per SM); the trace
// build stamps kTraceStamps uint64 a block.
extern "C" int count_scatter_small_grid(long long R) {
  return R <= 0 ? 0 : ceil_div(R, small_rows_per_block(R));
}

// One call of the function on `stream`: the small plan (one launch) when
// L <= kSmallMax, else the large plan (six launches) with `scratch`,
// int32 [2R + 2L + L / (kShort + 1) + 5], uninitialised and 8-byte
// aligned. `trace`: NULL, or (a -DSCATTER_TRACE build, small plan)
// kTraceStamps uint64 a block. Returns the CUDA error of the launches
// (0 = launched).
extern "C" int count_scatter_launch(long long L, long long R, const void* idx,
                                    const void* upd, const void* buf,
                                    void* out, void* scratch, void* trace,
                                    void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const float2* up = (const float2*)upd;
  const float2* in = (const float2*)buf;
  float2* o = (float2*)out;
  if (L <= kSmallMax) {
    small_kernel<<<count_scatter_small_grid(R), kThreads, sizeof(Smem), st>>>(
        ix, up, in, o, (int)L, (int)R, small_rows_per_block(R),
        (unsigned long long*)trace);
    return (int)cudaGetLastError();
  }
  int2* rows = (int2*)scratch;
  int* rank = (int*)(rows + R);
  int* seg = rank + L;
  int* list = seg + L;
  int* ctr = list + L / (kShort + 1) + 1;
  int cgrid = ceil_div(R, 4ll * kLaneThreads);
  if (cgrid > 8 * g_sms) cgrid = 8 * g_sms;
  const int lgrid = ceil_div(L, kLaneThreads);
  copy_clear_kernel<<<cgrid, kLaneThreads, 0, st>>>(in, o, (int)R, rows,
                                                    ctr);
  count_kernel<<<lgrid, kLaneThreads, 0, st>>>(ix, (int)L, (int)R, rows,
                                               rank);
  alloc_kernel<<<ceil_div(L, kThreads), kThreads, 0, st>>>(
      ix, up, in, o, (int)L, (int)R, rows, rank, ctr, list);
  place_kernel<<<lgrid, kLaneThreads, 0, st>>>(ix, (int)L, (int)R, rows, rank,
                                               seg);
  short_kernel<<<lgrid, kLaneThreads, 0, st>>>(ix, up, in, o, (int)L, (int)R,
                                               rows, rank, seg);
  long_kernel<<<g_sms, kThreads, sizeof(Smem), st>>>(
      ix, up, in, o, (int)L, bits_of(L), rows, seg, list, ctr);
  return (int)cudaGetLastError();
}
