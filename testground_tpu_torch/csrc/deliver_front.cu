// The fused entry-mode deliver front, whole, in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel testground_tpu/sim/pallas_front.py:_kernel
// (launched by _front_kernel, dispatched by front, which also runs the
// admission histograms, the lax.cond on max_wait and the fallback
// _front_reference). Its plain torch version is
// testground_tpu_torch/sim/deliver_front.py:front_lanes_plain; the two
// must agree bit for bit.
//
// What it computes, per lane i of the n lanes:
//   - destination viability on the effective dest (pre-admission):
//     net_enabled[i] > 0 and net_enabled[j] > 0 and running[j] at
//     j = clamp(eff_dest, 0, n - 1);
//   - a dead lane's pending send is abandoned; the pending egress slot
//     merges with the new send (effective dest, tag, port, size, payload);
//   - FIFO admission: the send_slots smallest keys among the candidates,
//     ties broken by lane id. The branch is the JAX package's lax.cond:
//     with max_wait = max over wanting lanes of the int32 wraparound
//     wait max(tick - age, 0),
//       * max_wait < 4095 (the two 64-bucket levels are exact): the
//         candidates are the wanting lanes, key 4095 - wait (oldest
//         first), a 12-bit key;
//       * max_wait >= 4095 (starved): the JAX sort admit, every lane a
//         candidate, key = age for a wanting lane and INT32_MAX for the
//         rest, as a 32-bit unsigned key (age ^ 0x80000000);
//   - deferral / stash / overflow write the new pend_* lanes; loss mask
//     u < loss, visibility max(t + max(lat, 0), t + 1), data_ok =
//     deliverable & tag != SYN; counters abandoned, deferred + stash,
//     overflow.
//
// What bounds it: memory. With P = 2 payload words, loss and latency, a
// lane reads ~69 B and writes ~57 B (~126 B/lane; 1.26 MB at N = 10k,
// 0.38 us at 3.35 TB/s; 126 MB at N = 1M, 38 us). At 10k lanes the
// chain of grid-wide steps (each a round trip to L2) bounds it instead,
// so the design counts round trips after the one grid barrier.
//
// The design: one cooperative launch of a persistent grid (no more blocks
// than can be resident together; about 512 lanes a block, so 20 blocks at
// N = 10k and 264 at 1M). Block b owns the contiguous lanes [b*L, b*L + L)
// and keeps their classification inputs (pend_dest, pend_tick, send_dest:
// 12 B/lane) in shared memory, with one flag byte a lane, so every later
// pass reclassifies from shared memory, not from device memory (past ~2M
// lanes the 12 B do not fit and those passes read the three lanes again).
// With one lane a thread (N up to ~67k, the "small" plan) each thread
// also loads its lane's other inputs and its viability gather in pass A
// and holds them in registers across the barrier, so pass D only writes.
// No loop that reads device memory holds a warp collective, so its loads
// stay in flight together.
//   A. one streaming pass: the classification inputs into shared memory
//      and a 4096-bin shared histogram of the 12-bit wait key (the common
//      bin, wait 0, counted in registers). The block writes its whole
//      histogram into its own row of the scratch (the rank of later
//      blocks reads it), and its nonzero bins into a global one with
//      integer atomics (exact and order-free); max_wait by atomicMax, the
//      wanting lanes by atomicAdd. Grid barrier.
//   B. every block reads max_wait, the count and the whole global
//      histogram in one round trip: non-starved with every wanting lane
//      fitting, all are admitted; non-starved otherwise, a block scan of
//      the bins gives the boundary key K, the slots left inside it and
//      the lanes in it; starved, a radix select over the 32-bit age key,
//      digits of 12, 12 and 8 bits, one shared-memory histogram pass and
//      one grid barrier each (the last digit's histogram is the one each
//      block writes into its row). When bin K fits whole (the
//      uncongested tick), C is skipped.
//   C. the in-boundary lane-order rank: bin K of the rows of the blocks
//      before this one, one load a thread, in flight while per-warp
//      ballots give each lane its place in its warp (kept in its flag
//      byte) and a block-wide scan the warps' offsets.
//   D. each lane's admission (and, outside the small plan, the viability
//      gather of admitted lanes only), then every lane output and the
//      counters. (A bulk L2 prefetch of D's inputs, tried, was slower.)
// The non-starved branch costs one histogram pass, one grid barrier and
// two round trips after it (the histogram, the rank base); the starved
// branch four of each. Built with -DFRONT_TRACE, each block stamps
// %globaltimer at the phase boundaries into the scratch (chip_smoke.py
// phase 3a reads them).
//
// Scratch: one persistent buffer per device (kernels/deliver_front.py),
// cleared once when it is allocated. The grid barrier's word gains
// exactly 2^31 at every barrier (the arrival of the last block flips its
// top bit), so it needs no reset; the launch epoch advances by one every
// launch; the accumulators (histograms, max_wait, count) come in two
// copies picked by the epoch's parity, and each launch clears the copy
// the last launch used and the next one will; a block's row is written
// whole before any block reads it. So no launch needs a memset before it.
//
// Float note: the only float arithmetic is the two adds of the
// visibility time; __fadd_rn keeps them single IEEE adds, and the maxima
// propagate NaN as jnp.maximum / torch.maximum do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 4096;  // one 12-bit digit
constexpr int kBinsPerThread = kBins / kThreads;
constexpr int kMaxWait = kBins - 1;  // B*B - 1 of the two 64-bucket levels
constexpr int kTagSyn = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGrid = 2 * kThreads;  // C reads two rows a thread at most
constexpr int kMaxP = 8;
constexpr int kCacheBytesPerLane = 12;
constexpr int kSmemCap = 200 * 1024;
constexpr int kDefaultLanesPerBlock = 512;
// spins of a grid-wide wait before the kernel traps (seconds, where a
// healthy wait takes microseconds): a fault becomes an error, not a hang
constexpr long long kMaxSpins = 1ll << 26;
// the flag byte of a lane: running, viable, admitted (from pass D on),
// and (bits 3-7) the count of boundary lanes before it in its warp
constexpr uint8_t kRun = 1, kViable = 2, kGo = 4;
constexpr int kWarpRankShift = 3;
static_assert(kBinsPerThread == 8, "select_bins holds 8 bins a thread");

struct Acc {  // what a launch accumulates across blocks
  int max_wait;
  int wanting;
  int pad[2];
  int hist[4][kBins];  // [0] the wait key; [1..3] the age key's digits
};

struct Scratch {
  unsigned bar;    // grid barrier word
  unsigned epoch;  // launches so far
  int pad[2];
  Acc acc[2];                // by the epoch's parity
  int rows[kMaxGrid][kBins];  // each block's own last histogram
#ifdef FRONT_TRACE
  unsigned long long trace[kMaxGrid][8];
#endif
};

#ifdef FRONT_TRACE
#define TRACE(k)                                                        \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0) {                                             \
      unsigned long long t_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      a.scratch->trace[blockIdx.x][k] = t_;                             \
    }                                                                   \
  } while (0)
#else
#define TRACE(k) \
  do {           \
  } while (0)
#endif

struct FrontArgs {
  int n, P, send_slots, lanes, tiles;
  const int32_t* pend_dest;
  const int32_t* pend_tick;
  const int32_t* pend_tag;
  const int32_t* pend_port;
  const float* pend_size;
  const float* pend_pay;  // [n, P]
  const int32_t* send_dest;
  const int32_t* send_tag;
  const int32_t* send_port;
  const float* send_size;
  const float* send_pay;
  long long st_dest, st_tag, st_port, st_size, st_pay0, st_pay1;  // strides
  const uint8_t* running;
  const int32_t* net_enabled;
  const float* lat;   // nullable
  const float* loss;  // nullable (then u is null too)
  const float* u;
  const int32_t* tick;  // device scalar
  int32_t* o_pend_dest;
  int32_t* o_pend_tick;
  int32_t* o_pend_tag;
  int32_t* o_pend_port;
  float* o_pend_size;
  float* o_pend_pay;  // [n, P]
  int32_t* o_sd2;
  int32_t* o_eff_tag;
  int32_t* o_eff_port;
  float* o_eff_size;
  float* o_eff_pay;  // [n, P]
  float* o_visible;
  uint8_t* o_data_ok;
  int32_t* counters;  // [3]
  Scratch* scratch;
};

// ---------------------------------------------------------------- memory

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// A load (at L2: its data may come from another block of this launch)
// that the compiler keeps where it is written, where a read-only load may
// sink to its first use, past a barrier: issued early, waited for only
// where its value is used.
__device__ __forceinline__ int ld_here(const int32_t* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_here(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_here(const uint8_t* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Every block of the (co-resident) grid arrives before any leaves. Block 0
// adds 2^31 - (G - 1), the others 1 each: the word's top bit flips when
// the last one arrives, and its low 31 bits return to 0. The arrival
// releases the block's writes; the wait acquires everyone's.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old = atom_add_release(bar, add);
    long long spins = 0;
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {
      if (++spins > kMaxSpins) __trap();
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ block sums

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// sums of x, y and z over the block; valid in every thread
__device__ __forceinline__ void block_sum3(int& x, int& y, int& z,
                                           int* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  if (lane == 0) {
    red[warp] = x;
    red[kWarps + warp] = y;
    red[2 * kWarps + warp] = z;
  }
  __syncthreads();
  x = y = z = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    x += red[w];
    y += red[kWarps + w];
    z += red[2 * kWarps + w];
  }
  __syncthreads();
}

// exclusive prefix sum in thread order; *total is the block's sum
__device__ __forceinline__ int block_scan(int x, int* red, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += red[w];
    all += red[w];
  }
  __syncthreads();
  *total = all;
  return before + v - x;
}

// ------------------------------------------------------------- the lanes

struct Lane {
  bool live, run, abandoned, hp, wants;
  int pd, ptick, sd, eff_dest, age, wait;
};

__device__ __forceinline__ Lane classify(int pd, int ptick, int sd, bool run,
                                         bool live, int tick) {
  Lane l;
  l.live = live;
  l.pd = pd;
  l.ptick = ptick;
  l.sd = sd;
  l.run = run;
  l.abandoned = pd >= 0 && !run;
  int pd0 = l.abandoned ? -1 : pd;
  l.hp = pd0 >= 0;
  l.eff_dest = l.hp ? pd0 : sd;
  l.wants = live && l.eff_dest >= 0 && run;
  l.age = l.hp ? ptick : tick;
  // int32 wraparound subtraction, as the JAX package's
  int w = (int)((unsigned)tick - (unsigned)l.age);
  l.wait = w > 0 ? w : 0;
  return l;
}

// The admission key: the wait key (oldest first) or, starved, the age key
// (a lane that does not want keyed INT32_MAX).
__device__ __forceinline__ unsigned lane_key(const Lane& l, bool starved) {
  if (starved) return l.wants ? ((unsigned)l.age ^ 0x80000000u) : kFull;
  return (unsigned)(kMaxWait - min(l.wait, kMaxWait));
}

// Whether the lane takes a place in the order at all.
__device__ __forceinline__ bool candidate(const Lane& l, bool starved) {
  return starved ? l.live : l.wants;
}

// The block's lanes: their classification inputs in shared memory (or,
// when they do not fit, in device memory) and their flag bytes.
template <bool kCache>
struct Lanes {
  int lo, hi;
  int* c_pd;
  int* c_ptick;
  int* c_sd;
  uint8_t* flag;

  __device__ __forceinline__ Lane get(const FrontArgs& a, int k,
                                      int tick) const {
    int i = lo + k;
    bool live = i < hi;
    int pd = -1, ptick = 0, sd = -1;
    bool run = false;
    if (live) {
      if (kCache) {
        pd = c_pd[k];
        ptick = c_ptick[k];
        sd = c_sd[k];
      } else {
        pd = a.pend_dest[i];
        ptick = a.pend_tick[i];
        sd = a.send_dest[(long long)i * a.st_dest];
      }
      run = flag[k] & kRun;
    }
    return classify(pd, ptick, sd, run, live, tick);
  }
};

// A lane's inputs beyond its classification, as pass D uses them.
struct Vals {
  int stag, sport, ptag, pport;
  float ssize, psize, lat;
  bool lost;
};

// Warp-aggregated shared histogram add: one atomic for each distinct bin
// of the warp (lanes of a warp mostly share a few waits).
__device__ __forceinline__ void hist_add(int* h, bool on, unsigned bin) {
  unsigned m = __ballot_sync(kFull, on);
  if (!m) return;
  unsigned same = __match_any_sync(kFull, on ? bin : 0xffffffffu);
  if (on && (int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(&h[bin], __popc(same));
}

// The block's shared histogram of nb bins (the block synchronised since
// its last add): whole into its row (when `row` is given), and each
// nonzero bin into the global histogram g with an integer atomic. A warp
// covers 32 consecutive bins, so its atomics fall in one 128-byte line.
__device__ __forceinline__ void hist_publish(const int* sh, int* g, int* row,
                                             int nb) {
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int v = sh[k];
    if (row != nullptr) row[k] = v;
    if (v) atomicAdd(g + k, v);
  }
}

// Thread t's 8 bins (8t..8t+7, zero past nb) of a global histogram.
__device__ __forceinline__ void load_bins(const int* g, int nb, int (&v)[8]) {
  const int b0 = threadIdx.x * kBinsPerThread;
  int4 x = make_int4(0, 0, 0, 0), y = x;
  if (b0 < nb) {
    x = __ldcg(reinterpret_cast<const int4*>(g + b0));
    y = __ldcg(reinterpret_cast<const int4*>(g + b0 + 4));
  }
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// The boundary over a histogram of nb bins held 8 a thread (load_bins):
// the smallest d with count(bin <= d) >= T, T - count(bin < d), the
// slots left inside d, and count(d). When the bins hold fewer than T in
// all, d is the last bin and every candidate is admitted. Valid in every
// thread.
__device__ __forceinline__ void select_bins(const int (&v)[8], int nb, int T,
                                            int* red, int* sel, int* d,
                                            int* left, int* count) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += v[j];
  int total;
  int c = block_scan(s, red, &total);
  const int b0 = threadIdx.x * kBinsPerThread;
  if (total < T) {
    if (b0 + 8 == nb) {
      sel[0] = nb - 1;
      sel[1] = T - (total - v[7]);
      sel[2] = v[7];
    }
  } else if ((threadIdx.x == 0 || c < T) && c + s >= T) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c + v[j] >= T) {
        sel[0] = b0 + j;
        sel[1] = T - c;
        sel[2] = v[j];
        break;
      }
      c += v[j];
    }
  }
  __syncthreads();
  *d = sel[0];
  *left = sel[1];
  *count = sel[2];
}

// jnp.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);
  return a > b ? a : b;
}

// ---------------------------------------------------------------- kernel

// Two blocks an SM (64 registers a thread): with three or four the
// compiler spills, and it runs slower. The small plan (one lane a
// thread) holds its lane's inputs in registers, one block an SM.
template <bool kCache, bool kSmall>
__global__ void __launch_bounds__(kThreads, kSmall ? 1 : 2)
    front_kernel(FrontArgs a) {
  static_assert(kCache || !kSmall, "the small plan caches its lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[3 * kWarps];
  __shared__ int sel[3];
  __shared__ int s_acc[2];  // max_wait and the wanting lanes, in pass B
  __shared__ unsigned s_epoch;

  Scratch* sc = a.scratch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.lanes;
  int* s_hist = reinterpret_cast<int*>(smem);  // kBins
  int* s_wcnt = s_hist + kBins;                // tiles * kWarps
  Lanes<kCache> ln;
  ln.lo = blockIdx.x * L;
  ln.hi = min(a.n, ln.lo + L);
  const int nl = max(ln.hi - ln.lo, 0);
  ln.c_pd = s_wcnt + a.tiles * kWarps;
  ln.c_ptick = ln.c_pd + (kCache ? L : 0);
  ln.c_sd = ln.c_ptick + (kCache ? L : 0);
  ln.flag = reinterpret_cast<uint8_t*>(ln.c_sd + (kCache ? L : 0));
  const int tick = __ldg(a.tick);
  const int32_t* __restrict__ pend_dest = a.pend_dest;
  const int32_t* __restrict__ pend_tick = a.pend_tick;
  const int32_t* __restrict__ send_dest = a.send_dest;
  const uint8_t* __restrict__ running = a.running;
  const int32_t* __restrict__ net_enabled = a.net_enabled;
  const int32_t* __restrict__ pend_tag = a.pend_tag;
  const int32_t* __restrict__ pend_port = a.pend_port;
  const float* __restrict__ pend_size = a.pend_size;
  const float* __restrict__ pend_pay = a.pend_pay;
  const int32_t* __restrict__ send_tag = a.send_tag;
  const int32_t* __restrict__ send_port = a.send_port;
  const float* __restrict__ send_size = a.send_size;
  const float* __restrict__ send_pay = a.send_pay;
  const float* __restrict__ lat = a.lat;
  const float* __restrict__ loss = a.loss;
  const float* __restrict__ u = a.u;
  const int P = a.P;

  TRACE(0);
  // ---- A: classification inputs into shared memory; the wait
  // histogram, max_wait and the wanting lanes (and, in the small plan,
  // the thread's lane's other inputs and its viability gather)
  unsigned epoch = 0;
  // written by the last launch, so visible at this one's start
  if (tid == 0) epoch = __ldcg(&sc->epoch);  // used after the loops
  if (blockIdx.x == 0 && tid < 3) a.counters[tid] = 0;
  for (int k = tid; k < kBins; k += kThreads) s_hist[k] = 0;
  __syncthreads();
  // one streaming pass: the lanes into shared memory and the wait
  // histogram; the common bin, wait 0, is counted without an atomic
  int mw = 0, nw = 0, n0 = 0;
  auto pass_a = [&](int k) -> Lane {
    const int i = ln.lo + k;
    const int pd = pend_dest[i], ptick = pend_tick[i];
    const int sd = send_dest[(long long)i * a.st_dest];
    const bool run = running[i] != 0;
    if (kCache) {
      ln.c_pd[k] = pd;
      ln.c_ptick[k] = ptick;
      ln.c_sd[k] = sd;
    }
    ln.flag[k] = run ? kRun : 0;
    const Lane l = classify(pd, ptick, sd, run, true, tick);
    if (l.wants) {
      mw = max(mw, l.wait);
      ++nw;
      if (l.wait == 0)
        ++n0;
      else
        atomicAdd(&s_hist[lane_key(l, false)], 1);
    }
    return l;
  };
  // the small plan's registers: the lane's inputs and viability gather
  Vals v = {0, 0, 0, 0, 0.0f, 0.0f, 0.0f, false};
  float spay[kMaxP], ppay[kMaxP];
  int en_i = 0, en_j = 0, run_j = 0;
  if (kSmall) {
    if (tid < nl) {
      // every load of the lane issued together (one round trip); the
      // gather's loads, which need the lane's dest, are used only in
      // pass D, so their round trip overlaps the barrier
      const int i = ln.lo + tid;
      v.stag = ld_here(send_tag + (long long)i * a.st_tag);
      v.sport = ld_here(send_port + (long long)i * a.st_port);
      v.ssize = ld_here(send_size + (long long)i * a.st_size);
      v.ptag = ld_here(pend_tag + i);
      v.pport = ld_here(pend_port + i);
      v.psize = ld_here(pend_size + i);
      float lv = 0.0f, uv = 1.0f, lossv = 0.0f;
      if (lat != nullptr) lv = ld_here(lat + i);
      if (loss != nullptr) {
        uv = ld_here(u + i);
        lossv = ld_here(loss + i);
      }
#pragma unroll
      for (int p = 0; p < kMaxP; ++p) {
        spay[p] = ppay[p] = 0.0f;
        if (p < P) {
          spay[p] = ld_here(send_pay + (long long)i * a.st_pay0 +
                            (long long)p * a.st_pay1);
          ppay[p] = ld_here(pend_pay + (long long)i * P + p);
        }
      }
      en_i = ld_here(net_enabled + i);
      const Lane l = pass_a(tid);
      if (l.wants) {
        const int j = min(max(l.eff_dest, 0), a.n - 1);
        en_j = ld_here(net_enabled + j);
        run_j = ld_here(running + j);
      }
      v.lat = lv;
      v.lost = loss != nullptr && uv < lossv;
    }
  } else {
#pragma unroll 4
    for (int k = tid; k < nl; k += kThreads) pass_a(k);
  }
  TRACE(1);
  for (int o = 16; o > 0; o >>= 1) mw = max(mw, __shfl_xor_sync(kFull, mw, o));
  nw = warp_sum(nw);
  n0 = warp_sum(n0);
  if (lane == 0) {
    red[warp] = mw;
    red[kWarps + warp] = nw;
    if (n0) atomicAdd(&s_hist[kMaxWait], n0);
  }
  if (tid == 0) s_epoch = epoch;
  __syncthreads();
  mw = nw = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mw = max(mw, red[w]);
    nw += red[kWarps + w];
  }
  epoch = s_epoch;
  Acc* acc = &sc->acc[epoch & 1u];
  if (tid == 0) {
    if (mw) atomicMax(&acc->max_wait, mw);
    if (nw) atomicAdd(&acc->wanting, nw);
  }
  // a block whose own max_wait reaches 4095 knows the launch is starved,
  // where the wait histogram goes unread
  if (mw < kMaxWait)
    hist_publish(s_hist, acc->hist[0], sc->rows[blockIdx.x], kBins);
  TRACE(2);
  grid_barrier(&sc->bar);
  TRACE(3);
  if (blockIdx.x == 0 && tid == 0) atomicAdd(&sc->epoch, 1u);  // all read it

  // ---- B: the branch and the boundary key K, slots left inside it, and
  // the lanes in it
  int bins[kBinsPerThread];
  load_bins(acc->hist[0], kBins, bins);  // with max_wait: one round trip
  if (tid == 0) {
    s_acc[0] = __ldcg(&acc->max_wait);
    s_acc[1] = __ldcg(&acc->wanting);
  }
  __syncthreads();
  const bool starved = s_acc[0] >= kMaxWait;
  unsigned K;
  int left, count_k = 0;  // slots left in the boundary bin K, lanes in it
  if (!starved) {
    if (s_acc[1] <= a.send_slots) {  // every wanting lane fits
      K = (unsigned)kMaxWait;
      left = a.send_slots;
    } else {
      int d;
      select_bins(bins, kBins, a.send_slots, red, sel, &d, &left, &count_k);
      K = (unsigned)d;
    }
  } else {
    int T = a.send_slots;
    unsigned prefix = 0;
    for (int lev = 1; lev <= 3; ++lev) {
      const int shift = lev == 1 ? 20 : (lev == 2 ? 8 : 0);
      const int bits = lev == 3 ? 8 : 12;
      const int nb = 1 << bits;
      __syncthreads();
      for (int k = tid; k < nb; k += kThreads) s_hist[k] = 0;
      __syncthreads();
      for (int t = 0; t < a.tiles; ++t) {
        Lane l = ln.get(a, t * kThreads + tid, tick);
        unsigned key = lane_key(l, true);
        bool on = l.live && (lev == 1 || (key >> (shift + bits)) == prefix);
        hist_add(s_hist, on, (key >> shift) & (unsigned)(nb - 1));
      }
      __syncthreads();
      // the last digit's histogram counts each block's boundary lanes
      hist_publish(s_hist, acc->hist[lev],
                   lev == 3 ? sc->rows[blockIdx.x] : nullptr, nb);
      grid_barrier(&sc->bar);
      load_bins(acc->hist[lev], nb, bins);
      int d;
      select_bins(bins, nb, T, red, sel, &d, &T, &count_k);
      prefix = (prefix << bits) | (unsigned)d;
    }
    K = prefix;
    left = T;
  }
  // When the boundary bin fits whole (the uncongested tick), no lane
  // needs a rank: every block knows it from the same global counts.
  const bool ranked = left < count_k;
  TRACE(4);
  int base = 0;
  if (ranked) {
    // ---- C: the boundary lanes of the blocks before this one (bin K of
    // their rows, or bin K mod 256 of their last age-digit rows), in
    // flight while each lane finds its place among its warp's (in its
    // flag byte) and the block scans the (tile, warp) counts
    const unsigned bk = starved ? (K & 255u) : K;
    int r0 = 0, r1 = 0;
    if (tid < (int)blockIdx.x) r0 = ld_here(&sc->rows[tid][bk]);
    if (tid + kThreads < (int)blockIdx.x)
      r1 = ld_here(&sc->rows[tid + kThreads][bk]);
    for (int t = 0; t < a.tiles; ++t) {
      const int k = t * kThreads + tid;
      Lane l = ln.get(a, k, tick);
      bool inb = candidate(l, starved) && lane_key(l, starved) == K;
      unsigned m = __ballot_sync(kFull, inb);
      if (lane == 0) s_wcnt[t * kWarps + warp] = __popc(m);
      if (inb) ln.flag[k] |= __popc(m & ((1u << lane) - 1u)) << kWarpRankShift;
    }
    __syncthreads();
    {
      const int E = a.tiles * kWarps;
      const int per = (E + kThreads - 1) / kThreads;
      const int e0 = min(E, tid * per), e1 = min(E, e0 + per);
      int s = 0;
      for (int e = e0; e < e1; ++e) s += s_wcnt[e];
      int total;
      int run = block_scan(s, red, &total);
      for (int e = e0; e < e1; ++e) {
        int x = s_wcnt[e];
        s_wcnt[e] = run;
        run += x;
      }
    }
    base = r0 + r1;
    int unused1 = 0, unused2 = 0;
    block_sum3(base, unused1, unused2, red);  // its syncs publish s_wcnt too
  }
  TRACE(5);

  // ---- D: every lane output; clear the other copy of the accumulators
  {
    int* other = reinterpret_cast<int*>(&sc->acc[(epoch & 1u) ^ 1u]);
    const int words = (int)(sizeof(Acc) / sizeof(int));
    const int chunk = (words + gridDim.x - 1) / gridDim.x;
    const int w1 = min(words, (int)(blockIdx.x + 1) * chunk);
    for (int w = blockIdx.x * chunk + tid; w < w1; w += kThreads) other[w] = 0;
  }
  int32_t* __restrict__ o_pend_dest = a.o_pend_dest;
  int32_t* __restrict__ o_pend_tick = a.o_pend_tick;
  int32_t* __restrict__ o_pend_tag = a.o_pend_tag;
  int32_t* __restrict__ o_pend_port = a.o_pend_port;
  float* __restrict__ o_pend_size = a.o_pend_size;
  float* __restrict__ o_pend_pay = a.o_pend_pay;
  int32_t* __restrict__ o_sd2 = a.o_sd2;
  int32_t* __restrict__ o_eff_tag = a.o_eff_tag;
  int32_t* __restrict__ o_eff_port = a.o_eff_port;
  float* __restrict__ o_eff_size = a.o_eff_size;
  float* __restrict__ o_eff_pay = a.o_eff_pay;
  float* __restrict__ o_visible = a.o_visible;
  uint8_t* __restrict__ o_data_ok = a.o_data_ok;
  // admission bits; viability from the small plan's gather, else the
  // gather of admitted lanes (fewer random reads where bandwidth is what
  // counts), in flight together
#pragma unroll 4
  for (int k = tid; k < nl; k += kThreads) {
    const uint8_t fl = ln.flag[k];
    const Lane l = ln.get(a, k, tick);
    const unsigned key = lane_key(l, starved);
    const bool go =
        l.wants &&
        (key < K ||
         (key == K &&
          (!ranked || base + s_wcnt[(k / kThreads) * kWarps + warp] +
                              (fl >> kWarpRankShift) < left)));
    bool viable = false;
    if (kSmall) {
      viable = en_i > 0 && en_j > 0 && run_j != 0;
    } else if (go && l.run) {
      const int i = ln.lo + k;
      const int j = min(max(l.eff_dest, 0), a.n - 1);
      viable = net_enabled[i] > 0 && net_enabled[j] > 0 && running[j] != 0;
    }
    ln.flag[k] = (uint8_t)((fl & kRun) | (viable ? kViable : 0) |
                           (go ? kGo : 0));
  }

  // every lane output and the counters
  const float tf = (float)tick;
  const float one = __fadd_rn(tf, 1.0f);
  int n_abandoned = 0, n_delayed = 0, n_overflow = 0;
#pragma unroll 2
  for (int t = 0; t < a.tiles; ++t) {
    const int k = t * kThreads + tid;
    if (k >= nl) continue;
    const int i = ln.lo + k;
    const uint8_t fl = ln.flag[k];
    const Lane l = ln.get(a, k, tick);
    const bool go = fl & kGo;
    const int stag = kSmall ? v.stag : send_tag[(long long)i * a.st_tag];
    const int sport = kSmall ? v.sport : send_port[(long long)i * a.st_port];
    const float ssize =
        kSmall ? v.ssize : send_size[(long long)i * a.st_size];
    const int eff_tag = l.hp ? (kSmall ? v.ptag : pend_tag[i]) : stag;
    const int eff_port = l.hp ? (kSmall ? v.pport : pend_port[i]) : sport;
    const float eff_size = l.hp ? (kSmall ? v.psize : pend_size[i]) : ssize;
    const float lt = kSmall ? v.lat : (lat != nullptr ? lat[i] : 0.0f);
    const bool lost = kSmall ? v.lost : (loss != nullptr && u[i] < loss[i]);
    const bool nv = l.sd >= 0;
    const bool deferred = l.wants && !go;
    const bool ovf = deferred && l.hp && nv;
    const bool stash = !deferred && l.hp && nv;
    const bool keep = deferred || stash;
    o_pend_tick[i] = keep ? ((deferred && l.hp) ? l.ptick : tick) : 0;
    o_pend_dest[i] = keep ? (deferred ? l.eff_dest : l.sd) : -1;
    o_pend_tag[i] = keep ? (deferred ? eff_tag : stag) : 0;
    o_pend_port[i] = keep ? (deferred ? eff_port : sport) : 0;
    o_pend_size[i] = keep ? (deferred ? eff_size : ssize) : 0.0f;
    auto put_pay = [&](int p, float sp, float ep) {
      o_pend_pay[(size_t)i * P + p] = keep ? (deferred ? ep : sp) : 0.0f;
      o_eff_pay[(size_t)i * P + p] = ep;
    };
    if (kSmall) {
#pragma unroll
      for (int p = 0; p < kMaxP; ++p)
        if (p < P) put_pay(p, spay[p], l.hp ? ppay[p] : spay[p]);
    } else {
      for (int p = 0; p < P; ++p) {
        const float sp =
            send_pay[(long long)i * a.st_pay0 + (long long)p * a.st_pay1];
        put_pay(p, sp, l.hp ? pend_pay[(size_t)i * P + p] : sp);
      }
    }
    o_sd2[i] = go ? l.eff_dest : -1;
    o_eff_tag[i] = eff_tag;
    o_eff_port[i] = eff_port;
    o_eff_size[i] = eff_size;
    o_visible[i] =
        lat != nullptr ? nan_max(__fadd_rn(tf, nan_max(lt, 0.0f)), one) : one;
    o_data_ok[i] =
        go && l.run && (fl & kViable) && !lost && eff_tag != kTagSyn;
    n_abandoned += l.abandoned;
    n_delayed += keep;
    n_overflow += ovf;
  }
  block_sum3(n_abandoned, n_delayed, n_overflow, red);
  if (tid == 0) {
    if (n_abandoned) atomicAdd(&a.counters[0], n_abandoned);
    if (n_delayed) atomicAdd(&a.counters[1], n_delayed);
    if (n_overflow) atomicAdd(&a.counters[2], n_overflow);
  }
  TRACE(6);
  TRACE(7);
}

// ------------------------------------------------------------------ plan

struct Plan {
  int grid, lanes, tiles;
  bool cache, small;
  size_t smem;
};

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

void* kernel_of(bool cache, bool small) {
  if (small) return (void*)front_kernel<true, true>;
  return cache ? (void*)front_kernel<true, false>
               : (void*)front_kernel<false, false>;
}

// Grid size and shared memory for n lanes: about lanes_hint lanes a block,
// never more blocks than can be resident together; the small plan where
// every block has one tile and the grid fits one block an SM.
cudaError_t make_plan(int n, int lanes_hint, Plan* p) {
  static bool attr_set = false;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!attr_set) {
    for (int c = 0; c < 3; ++c) {
      err = cudaFuncSetAttribute(kernel_of(c > 0, c > 1),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
      if (err != cudaSuccess) return err;
    }
    attr_set = true;
  }
  int hint = lanes_hint > 0 ? lanes_hint : kDefaultLanesPerBlock;
  int grid = std::min(std::max(ceil_div(n, hint), 1), kMaxGrid);
  for (int iter = 0; iter < 16; ++iter) {
    int lanes = ceil_div(ceil_div(n, grid), 32) * 32;  // aligned tile starts
    int tiles = std::max(ceil_div(lanes, kThreads), 1);
    // histogram, per-(tile, warp) counts, flag bytes [, cached lanes]
    size_t fixed = (size_t)(kBins + tiles * kWarps) * sizeof(int) +
                   (size_t)lanes;
    size_t cached = fixed + (size_t)lanes * kCacheBytesPerLane;
    bool cache = cached <= (size_t)kSmemCap;
    size_t smem = cache ? cached : fixed;
    if (smem > (size_t)kSmemCap) return cudaErrorInvalidConfiguration;
    for (int small = cache && tiles == 1; small >= 0; --small) {
      int occ = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, kernel_of(cache, small), kThreads, smem);
      if (err != cudaSuccess) return err;
      int resident = std::min(occ * sms, kMaxGrid);
      if (occ > 0 && grid <= resident) {
        *p = Plan{grid, lanes, tiles, cache, small != 0, smem};
        return cudaSuccess;
      }
      if (!small) {
        if (occ <= 0) return cudaErrorInvalidConfiguration;
        grid = resident;
      }
    }
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// The persistent scratch: its size, and its one clearing when allocated.
extern "C" int deliver_front_scratch_bytes() { return (int)sizeof(Scratch); }

extern "C" int deliver_front_scratch_init(void* scratch, void* stream) {
  return (int)cudaMemsetAsync(scratch, 0, sizeof(Scratch),
                              static_cast<cudaStream_t>(stream));
}

// The launch plan for n lanes, for reports: out[0..4] = grid, lanes a
// block, tiles, cache, small.
extern "C" int deliver_front_plan(int n, int lanes_hint, int* out) {
  Plan p;
  cudaError_t err = make_plan(n, lanes_hint, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.lanes;
  out[2] = p.tiles;
  out[3] = p.cache;
  out[4] = p.small;
  return 0;
}

// ptrs, in order: pend_dest, pend_tick, pend_tag, pend_port, pend_size,
// pend_pay, send_dest, send_tag, send_port, send_size, send_pay, running,
// net_enabled, lat, loss, u, tick, then the outputs o_pend_dest,
// o_pend_tick, o_pend_tag, o_pend_port, o_pend_size, o_pend_pay, o_sd2,
// o_eff_tag, o_eff_port, o_eff_size, o_eff_pay, o_visible, o_data_ok,
// counters, and the scratch (32 pointers).
// ints, in order: n, P, send_slots, lanes_hint, and the element strides
// of send_dest, send_tag, send_port, send_size, send_pay (two) (10 ints).
// One cooperative launch on `stream`; returns the CUDA error of the
// launch (0 = launched).
extern "C" int deliver_front_launch(void* const* ptrs, int n_ptrs,
                                    const long long* ints, int n_ints,
                                    void* stream) {
  if (n_ptrs != 32 || n_ints != 10) return (int)cudaErrorInvalidValue;
  FrontArgs a;
  a.n = (int)ints[0];
  a.P = (int)ints[1];
  a.send_slots = (int)ints[2];
  int lanes_hint = (int)ints[3];
  a.st_dest = ints[4];
  a.st_tag = ints[5];
  a.st_port = ints[6];
  a.st_size = ints[7];
  a.st_pay0 = ints[8];
  a.st_pay1 = ints[9];
  if (a.P < 1 || a.P > kMaxP) return (int)cudaErrorInvalidValue;
  int k = 0;
  a.pend_dest = static_cast<const int32_t*>(ptrs[k++]);
  a.pend_tick = static_cast<const int32_t*>(ptrs[k++]);
  a.pend_tag = static_cast<const int32_t*>(ptrs[k++]);
  a.pend_port = static_cast<const int32_t*>(ptrs[k++]);
  a.pend_size = static_cast<const float*>(ptrs[k++]);
  a.pend_pay = static_cast<const float*>(ptrs[k++]);
  a.send_dest = static_cast<const int32_t*>(ptrs[k++]);
  a.send_tag = static_cast<const int32_t*>(ptrs[k++]);
  a.send_port = static_cast<const int32_t*>(ptrs[k++]);
  a.send_size = static_cast<const float*>(ptrs[k++]);
  a.send_pay = static_cast<const float*>(ptrs[k++]);
  a.running = static_cast<const uint8_t*>(ptrs[k++]);
  a.net_enabled = static_cast<const int32_t*>(ptrs[k++]);
  a.lat = static_cast<const float*>(ptrs[k++]);
  a.loss = static_cast<const float*>(ptrs[k++]);
  a.u = static_cast<const float*>(ptrs[k++]);
  a.tick = static_cast<const int32_t*>(ptrs[k++]);
  a.o_pend_dest = static_cast<int32_t*>(ptrs[k++]);
  a.o_pend_tick = static_cast<int32_t*>(ptrs[k++]);
  a.o_pend_tag = static_cast<int32_t*>(ptrs[k++]);
  a.o_pend_port = static_cast<int32_t*>(ptrs[k++]);
  a.o_pend_size = static_cast<float*>(ptrs[k++]);
  a.o_pend_pay = static_cast<float*>(ptrs[k++]);
  a.o_sd2 = static_cast<int32_t*>(ptrs[k++]);
  a.o_eff_tag = static_cast<int32_t*>(ptrs[k++]);
  a.o_eff_port = static_cast<int32_t*>(ptrs[k++]);
  a.o_eff_size = static_cast<float*>(ptrs[k++]);
  a.o_eff_pay = static_cast<float*>(ptrs[k++]);
  a.o_visible = static_cast<float*>(ptrs[k++]);
  a.o_data_ok = static_cast<uint8_t*>(ptrs[k++]);
  a.counters = static_cast<int32_t*>(ptrs[k++]);
  a.scratch = static_cast<Scratch*>(ptrs[k++]);
  if (a.n <= 0) return (int)cudaGetLastError();
  Plan p;
  cudaError_t err = make_plan(a.n, lanes_hint, &p);
  if (err != cudaSuccess) return (int)err;
  a.lanes = p.lanes;
  a.tiles = p.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel_of(p.cache, p.small), dim3(p.grid),
                                    dim3(kThreads), args, p.smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
