// The inbox-ring merge of the bounded entry-mode append, for Hopper
// (sm_90a).
//
// Replaces tools/microbench_pallas_append.py:_merge_kernel (launched by
// merge_pallas / _merge_pallas_tiled), the TPU kernel form of the A-pass
// one-hot merge in net._append_messages_bounded. For every inbox row,
// the staged record of rank a lands at ring slot (w + a) mod CAP for
// a < k_eff; every other slot keeps its value.
//
// Inputs: ring f32 [N, CAP, W]; w, k_eff int32 [N]; staging f32 [A*N, W],
// flat and rank-major (row a*N + dest holds dest's rank-a arrival), as
// the append builds it. Output: a fresh f32 [N, CAP, W] ring (out of
// place: the tick loop's identity guard selects the old state back on
// ticks past the end of the run, so the input ring must survive).
//
// Design: a block walks the ring in chunks of kCells ring cells (one cell
// = one row's slot, W floats). First each thread resolves one cell: for
// output slot s of row r, the passes that hit it are the ranks
// a = d (mod CAP) with d = floor_mod(s - w[r], CAP) and
// a < min(k_eff[r], A); the sequential merge lets the last pass win, so
// the cell takes the largest such a (it matters only when A > CAP). Its
// source offset (staging row a*N + r, or -1 = keep the ring's value)
// goes to shared memory. Then the block copies the chunk's floats, one
// thread per float with coalesced reads and writes, at one 32-bit
// divide per float (the first version took three 64-bit divides per
// float and ran compute-bound at a third of its byte bound). No
// transpose to dest-major staging and no padding to a block of rows,
// which the TPU kernel needed for its VMEM tiles.
//
// Bound: memory. Per call the function writes the ring once and reads
// each output cell's floats once, from the staging where a record lands
// and from the ring elsewhere (one ring's worth in all, whatever k_eff
// holds), plus w and k_eff: at dht@10k (CAP 32, W 7, A 8) about 18 MB,
// 5.4 us at 3.35 TB/s; at N = 1M with CAP 64, W 8, A 8 about 4.1 GB,
// 1.2 ms.
//
// Assumes w[r] + A does not overflow int32 (as the JAX function's int32
// w + a does not).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 256;  // ring cells per chunk

__global__ void ring_merge_kernel(const float* __restrict__ ring,
                                  const int* __restrict__ w,
                                  const int* __restrict__ k_eff,
                                  const float* __restrict__ arr,
                                  float* __restrict__ out, int64_t n,
                                  int cap, int width, int a_slots) {
  __shared__ int64_t src[kCells];  // staging float offset, or -1
  const int64_t ncell = n * cap;
  for (int64_t c0 = (int64_t)blockIdx.x * kCells; c0 < ncell;
       c0 += (int64_t)gridDim.x * kCells) {
    const int cells = (int)min((int64_t)kCells, ncell - c0);
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int64_t cell = c0 + c;
      const int64_t row = cell / cap;
      const int slot = (int)(cell - row * cap);
      const int k = min(k_eff[row], a_slots);
      int wm = w[row] % cap;  // floor modulo, in 32 bits
      if (wm < 0) wm += cap;
      int d = slot - wm;
      if (d < 0) d += cap;
      int64_t s = -1;
      if (d < k) {
        const int a = d + ((k - 1 - d) / cap) * cap;  // the last pass
        s = ((int64_t)a * n + row) * width;
      }
      src[c] = s;
    }
    __syncthreads();
    const int floats = cells * width;
    const int64_t base = c0 * width;
    for (int f = threadIdx.x; f < floats; f += blockDim.x) {
      const int c = f / width;
      const int64_t s = src[c];
      out[base + f] = s >= 0 ? arr[s + (f - c * width)] : ring[base + f];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ring_merge_launch(long long n, int cap, int width,
                                 int a_slots, const void* ring, const void* w,
                                 const void* k_eff, const void* arr,
                                 void* out, void* stream) {
  const int64_t ncell = (int64_t)n * cap;
  if (ncell == 0 || width == 0) return 0;
  int64_t blocks = (ncell + kCells - 1) / kCells;
  const int64_t max_blocks = 132 * 16;  // a few waves on 132 SMs
  if (blocks > max_blocks) blocks = max_blocks;
  ring_merge_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ring, (const int*)w, (const int*)k_eff,
      (const float*)arr, (float*)out, (int64_t)n, cap, width, a_slots);
  return (int)cudaGetLastError();
}
