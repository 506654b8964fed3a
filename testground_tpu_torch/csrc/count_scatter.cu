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
// Inputs: keys int32 [L], the destination row of each lane sorted
// ascending by a stable sort (dropped lanes key R and come last); lanes
// int64 [L], the lane id at each sorted position; upd f32 [L, 2], the
// [count, bytes] update of each lane (indexed by lane id); out f32
// [R, 2], a copy of the buffer, updated in place.
//
// Design: one thread per sorted position. The thread at the start of a
// destination's segment walks the segment in order (lane order, by the
// stable sort) and adds each update into a register that starts from the
// row's current value, then writes the row once. Rows nobody sends to
// are left alone. No atomics. A segment is serial in one thread, which is
// cheap when a destination takes a few updates a tick (storm: one or two)
// and slow only when thousands collide on one row.
//
// Bound: memory. The function reads each update and its key and lane id
// once, and reads and writes each touched row once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void count_scatter_kernel(const int* __restrict__ keys,
                                     const int64_t* __restrict__ lanes,
                                     const float2* __restrict__ upd,
                                     float2* __restrict__ out, int64_t L,
                                     int64_t rows) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < L;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int key = keys[j];
    if (key >= rows || (j > 0 && keys[j - 1] == key)) continue;
    float2 acc = out[key];
    for (int64_t s = j; s < L && keys[s] == key; ++s) {
      const float2 u = upd[lanes[s]];
      acc.x += u.x;
      acc.y += u.y;
    }
    out[key] = acc;
  }
}

}  // namespace

extern "C" int count_scatter_launch(long long L, long long rows,
                                    const void* keys, const void* lanes,
                                    const void* upd, void* out,
                                    void* stream) {
  if (L <= 0 || rows <= 0) return 0;
  int64_t blocks = (L + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 16;  // a few waves on 132 SMs
  if (blocks > max_blocks) blocks = max_blocks;
  count_scatter_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)keys, (const int64_t*)lanes, (const float2*)upd,
      (float2*)out, (int64_t)L, (int64_t)rows);
  return (int)cudaGetLastError();
}
