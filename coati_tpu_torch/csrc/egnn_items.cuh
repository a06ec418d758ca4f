// The work split shared by the bf16 bodies of the EGNN message kernels,
// K3 (egnn_messages.cu) and K4 (egnn_messages_bwd.cu).
//
// Both walk work items of (molecule b, tile of 8 atoms i0 .. i0 + 7) with a
// persistent grid: egnn_item_costs_kernel, launched first, prices each item
// by its live pairs (8 for each chunk of 64, rounded up, and 1 for the
// item's own overhead) and turns the costs into their inclusive prefix sums
// (the last of its blocks to finish, counter `done`); then worker q of Q
// takes the items whose cost starts in the q-th of Q equal ranges of the
// sum (item_range). Items differ up to 16x in pairs (molecules of 15-98
// atoms, tiles of padding atoms): handed out round robin, the most loaded
// worker makes the launch longer. The ranges depend only on w, so the
// assignment, and with it each worker's order of sums, is the same on every
// launch.
#pragma once

namespace coati {

constexpr int kItemAtoms = 8;    // atoms i of a work item
constexpr int kItemChunk = 64;   // live pairs of a chunk, the unit of an item's cost
constexpr int kCostWarps = 8;    // warps of a block of the costs kernel: a warp an item

__global__ void __launch_bounds__(32 * kCostWarps) egnn_item_costs_kernel(
    const float* __restrict__ w, long long* __restrict__ cost, unsigned* __restrict__ done,
    int batch, int n) {
  const int tiles = (n + kItemAtoms - 1) / kItemAtoms;
  const int items = batch * tiles;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kCostWarps + (threadIdx.x >> 5);
  if (item < items) {  // a warp an item
    const int b = item / tiles, i0 = (item - b * tiles) * kItemAtoms;
    const int cells = min(kItemAtoms, n - i0) * n;
    const float* wb = w + (static_cast<long long>(b) * n + i0) * n;
    unsigned count = 0;
    for (int e = lane; e < cells; e += 32) count += wb[e] != 0.f;
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) cost[item] = 8LL * ((count + kItemChunk - 1) / kItemChunk) + 1;
  }
  __shared__ bool last;
  __shared__ long long sums[32 * kCostWarps];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a contiguous run of items a thread, then the runs' sums in order
  const int per = (items + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per, hi = min(items, lo + per);
  long long s = 0;
  for (int k = lo; k < hi; ++k) s += __ldcg(cost + k);
  sums[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 1; k < blockDim.x; ++k) sums[k] += sums[k - 1];
  __syncthreads();
  long long run = threadIdx.x ? sums[threadIdx.x - 1] : 0;
  for (int k = lo; k < hi; ++k) {
    run += __ldcg(cost + k);
    cost[k] = run;
  }
}

// Blocks of egnn_item_costs_kernel for `items` work items.
inline int item_cost_blocks(int items) { return (items + kCostWarps - 1) / kCostWarps; }

// The start of item `item` in the costs' prefix sums.
__device__ __forceinline__ long long item_start(const long long* cost, int item) {
  return item == 0 ? 0LL : cost[item - 1];
}

// The items of worker q of `workers`: [*first, *end) are those whose cost
// starts in its range of the costs' sum [lo, hi) (the last worker's range
// includes the end), found by binary search.
__device__ __forceinline__ void item_range(const long long* cost, int items, int q, int workers,
                                           int* first, int* end) {
  const long long all = cost[items - 1];
  const long long lo = all * q / workers;
  const long long hi = q == workers - 1 ? all + 1 : all * (q + 1) / workers;
  auto first_at_or_after = [&](long long x) {  // the first item starting at x or later
    int at = 0;
    for (int span = items; span > 0;) {
      const int half = span / 2;
      if (item_start(cost, at + half) < x) {
        at += half + 1;
        span -= half + 1;
      } else {
        span = half;
      }
    }
    return at;
  };
  *first = first_at_or_after(lo);
  *end = first_at_or_after(hi);
}

}  // namespace coati
