// The fused entry-mode deliver front, per lane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel testground_tpu/sim/pallas_front.py:_kernel
// (launched by _front_kernel, dispatched by front). Its plain torch version
// is testground_tpu_torch/sim/deliver_front.py:front_lanes_plain; the two
// must agree bit for bit.
//
// Per lane i (one thread each):
//   - a dead lane's pending send is abandoned;
//   - the pending egress slot merges with the new send (effective dest,
//     tag, port, size, payload);
//   - two-level FIFO admission against the boundary scalars
//     adm = (tick, cstar, fstar, slots_f): wait buckets c = wc / 64 and
//     f = wc % 64 of wc = min(max(tick - age, 0), 4095); a lane in the
//     boundary bucket (c == cstar, f == fstar) is admitted iff its
//     exclusive rank among boundary-bucket lanes, in lane order, is below
//     slots_f;
//   - deferral / stash / overflow write the new pend_* lanes;
//   - loss mask u < loss, visibility max(t + max(lat, 0), t + 1),
//     data_ok = deliverable & tag != SYN;
//   - counters: abandoned, deferred + stash, overflow.
//
// The carry across blocks. The TPU grid ran in order and carried the
// in-bucket count in SMEM; GPU blocks run in no order. So two launches:
// (a) writes each block's count of boundary-bucket lanes to a scratch
// array; (b) has each block sum the counts of the blocks before it, then
// take a block-wide exclusive scan (warp shuffles plus one shared-memory
// pass across warps). Ranks are integers. Counters are per-block partial
// sums added with int32 atomics: exact and order-free.
//
// Bound: memory. For dht (P = 2 payload words, loss + latency) a lane
// reads ~18 and writes ~15 4-byte words (~132 B/lane; the bools are one
// byte each), ~1.3 MB at N = 10k: ~0.4 us at 3.35 TB/s. At 10k lanes the
// two launches cost more than the bytes, so it is launch-bound. This
// first design is simple and right; decoupled look-back (one launch) and
// several lanes per thread are later work.
//
// Float note: the only float arithmetic is the two adds of the
// visibility time; __fadd_rn keeps them single IEEE adds, and the maxima
// propagate NaN as jnp.maximum / torch.maximum do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 64;
constexpr int kMaxWait = kBuckets * kBuckets - 1;
constexpr int kTagSyn = 1;
constexpr unsigned kFull = 0xffffffffu;

struct FrontArgs {
  int n;
  int P;
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
  const float* send_pay;  // [n, P]
  const uint8_t* running;
  const uint8_t* enab_ok;
  const float* lat;   // nullable
  const float* loss;  // nullable (then u is null too)
  const float* u;
  const int32_t* adm;  // tick, cstar, fstar, slots_f
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
  int32_t* counters;      // [3], zeroed by the caller
  int32_t* block_counts;  // [gridDim.x] scratch
};

// jnp.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);
  return a > b ? a : b;
}

struct Lane {
  bool run, abandoned, hp, wants;
  int pd0, eff_dest, c, f;
};

__device__ __forceinline__ Lane classify(const FrontArgs& a, int i, int tick) {
  Lane l;
  int pd = a.pend_dest[i];
  l.run = a.running[i] != 0;
  l.abandoned = pd >= 0 && !l.run;
  l.pd0 = l.abandoned ? -1 : pd;
  l.hp = l.pd0 >= 0;
  l.eff_dest = l.hp ? l.pd0 : a.send_dest[i];
  l.wants = l.eff_dest >= 0 && l.run;
  int age = l.hp ? a.pend_tick[i] : tick;
  // int32 wraparound subtraction, as the JAX package's
  int wait = (int)((unsigned)tick - (unsigned)age);
  wait = wait > 0 ? wait : 0;
  int wc = wait < kMaxWait ? wait : kMaxWait;
  l.c = wc / kBuckets;
  l.f = wc % kBuckets;
  return l;
}

// sum over the block; the result is valid in every thread
__device__ __forceinline__ int block_sum(int x, int* smem) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += smem[w];
  __syncthreads();  // smem is free again on return
  return r;
}

// exclusive prefix sum over the block in thread order
__device__ __forceinline__ int block_exclusive_scan(int x, int* smem) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? smem[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) smem[lane] = w;
  }
  __syncthreads();
  int before = warp > 0 ? smem[warp - 1] : 0;
  __syncthreads();  // smem is free again on return
  return before + v - x;
}

// launch (a): each block's count of boundary-bucket lanes
__global__ void __launch_bounds__(kThreads)
count_boundary_kernel(FrontArgs a) {
  __shared__ int smem[kWarps];
  int i = blockIdx.x * kThreads + threadIdx.x;
  int tick = a.adm[0], cstar = a.adm[1], fstar = a.adm[2];
  int in_bf = 0;
  if (i < a.n) {
    Lane l = classify(a, i, tick);
    in_bf = l.wants && l.c == cstar && l.f == fstar;
  }
  int total = block_sum(in_bf, smem);
  if (threadIdx.x == 0) a.block_counts[blockIdx.x] = total;
}

// launch (b): ranks, admission and every output lane
__global__ void __launch_bounds__(kThreads)
front_kernel(FrontArgs a) {
  __shared__ int smem[kWarps];
  int i = blockIdx.x * kThreads + threadIdx.x;
  int tick = a.adm[0], cstar = a.adm[1], fstar = a.adm[2];
  int slots_f = a.adm[3];
  float t = (float)tick;

  // boundary-bucket lanes in the blocks before this one
  int part = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kThreads)
    part += a.block_counts[j];
  int base = block_sum(part, smem);

  bool live = i < a.n;
  Lane l;
  int in_bf = 0;
  if (live) {
    l = classify(a, i, tick);
    in_bf = l.wants && l.c == cstar && l.f == fstar;
  }
  int pr = base + block_exclusive_scan(in_bf, smem);

  int n_abandoned = 0, n_delayed = 0, n_overflow = 0;
  if (live) {
    int sd = a.send_dest[i];
    bool nv = sd >= 0;
    int ptick = a.pend_tick[i];
    int stag = a.send_tag[i], sport = a.send_port[i];
    float ssize = a.send_size[i];
    int eff_tag = l.hp ? a.pend_tag[i] : stag;
    int eff_port = l.hp ? a.pend_port[i] : sport;
    float eff_size = l.hp ? a.pend_size[i] : ssize;
    bool go = l.wants && (l.c > cstar || (l.c == cstar && l.f > fstar) ||
                          (in_bf && pr < slots_f));
    bool deferred = l.wants && !go;
    bool ovf = deferred && l.hp && nv;
    bool stash = !deferred && l.hp && nv;
    bool keep = deferred || stash;
    a.o_pend_tick[i] = keep ? ((deferred && l.hp) ? ptick : tick) : 0;
    a.o_pend_dest[i] = keep ? (deferred ? l.eff_dest : sd) : -1;
    a.o_pend_tag[i] = keep ? (deferred ? eff_tag : stag) : 0;
    a.o_pend_port[i] = keep ? (deferred ? eff_port : sport) : 0;
    a.o_pend_size[i] = keep ? (deferred ? eff_size : ssize) : 0.0f;
    for (int p = 0; p < a.P; ++p) {
      float spay = a.send_pay[(size_t)i * a.P + p];
      float ep = l.hp ? a.pend_pay[(size_t)i * a.P + p] : spay;
      a.o_pend_pay[(size_t)i * a.P + p] = keep ? (deferred ? ep : spay) : 0.0f;
      a.o_eff_pay[(size_t)i * a.P + p] = ep;
    }
    int sd2 = go ? l.eff_dest : -1;
    bool transmits = sd2 >= 0 && l.run && a.enab_ok[i] != 0;
    bool deliverable = transmits && !(a.loss != nullptr && a.u[i] < a.loss[i]);
    float one = __fadd_rn(t, 1.0f);
    float visible =
        a.lat != nullptr ? nan_max(__fadd_rn(t, nan_max(a.lat[i], 0.0f)), one)
                         : one;
    a.o_sd2[i] = sd2;
    a.o_eff_tag[i] = eff_tag;
    a.o_eff_port[i] = eff_port;
    a.o_eff_size[i] = eff_size;
    a.o_visible[i] = visible;
    a.o_data_ok[i] = deliverable && eff_tag != kTagSyn;
    n_abandoned = l.abandoned;
    n_delayed = deferred || stash;
    n_overflow = ovf;
  }
  int s0 = block_sum(n_abandoned, smem);
  int s1 = block_sum(n_delayed, smem);
  int s2 = block_sum(n_overflow, smem);
  if (threadIdx.x == 0) {
    if (s0) atomicAdd(&a.counters[0], s0);
    if (s1) atomicAdd(&a.counters[1], s1);
    if (s2) atomicAdd(&a.counters[2], s2);
  }
}

}  // namespace

extern "C" int deliver_front_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

// Both launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int deliver_front_launch(
    int n, int P, const int32_t* pend_dest, const int32_t* pend_tick,
    const int32_t* pend_tag, const int32_t* pend_port, const float* pend_size,
    const float* pend_pay, const int32_t* send_dest, const int32_t* send_tag,
    const int32_t* send_port, const float* send_size, const float* send_pay,
    const uint8_t* running, const uint8_t* enab_ok, const float* lat,
    const float* loss, const float* u, const int32_t* adm,
    int32_t* o_pend_dest, int32_t* o_pend_tick, int32_t* o_pend_tag,
    int32_t* o_pend_port, float* o_pend_size, float* o_pend_pay,
    int32_t* o_sd2, int32_t* o_eff_tag, int32_t* o_eff_port,
    float* o_eff_size, float* o_eff_pay, float* o_visible,
    uint8_t* o_data_ok, int32_t* counters, int32_t* block_counts,
    void* stream) {
  FrontArgs a{n,           P,          pend_dest,  pend_tick,   pend_tag,
              pend_port,   pend_size,  pend_pay,   send_dest,   send_tag,
              send_port,   send_size,  send_pay,   running,     enab_ok,
              lat,         loss,       u,          adm,         o_pend_dest,
              o_pend_tick, o_pend_tag, o_pend_port, o_pend_size, o_pend_pay,
              o_sd2,       o_eff_tag,  o_eff_port, o_eff_size,  o_eff_pay,
              o_visible,   o_data_ok,  counters,   block_counts};
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = deliver_front_blocks(n);
  count_boundary_kernel<<<blocks, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  front_kernel<<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
