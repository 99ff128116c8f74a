// Persistent warps with dynamic ray fetch for the BVH traversal kernel
// (bvh_traverse.cu).
//
// After Aila & Laine, "Understanding the Efficiency of Ray Traversal on
// GPUs" (HPG 2009).  A launch holds only as many blocks as stay resident
// on the card (resident_grid), so no second wave leaves SMs idle at the
// tail.  Each warp starts with 32 rays of its own and then takes more from
// a global counter: when enough of its lanes hold no ray, lane 0 takes 32
// consecutive ray indices with one atomicAdd and broadcasts the base, and
// the idle lanes take them in order (refill).  A lane's ray index decides
// only where its result goes, so the answer does not depend on the
// schedule.
//
// The walk inside is a while-while loop: an interior phase in which lanes
// step through inner nodes until none has an inner node left, then a leaf
// phase in which the lanes holding a leaf test one triangle per step
// together.  Every loop condition is a warp vote, so all 32 lanes run
// every trip and the votes may use the full mask.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace lumo {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;  // threads per block

// Refill once this many lanes of a warp hold no ray (all 32 at the start).
constexpr int kRefill = 8;

// Walk states of a lane besides a node index (>= 0).
constexpr int kLeaf = -1;  // testing a leaf's triangles
constexpr int kDone = -2;  // the walk is over (or the lane holds no ray)

// Rays taken by a warp at a time: a warp's first kFetch rays are its own
// by its index, later ones come kFetch at a time from the launch's work
// counter.
constexpr int kFetch = 32;

// A warp's queue of ray indices [next, end) (warp-uniform).
struct RayQueue {
  int next, end;
  int first_dynamic;  // the ray index the counter's 0 stands for
  bool drained;       // the counter has nothing left below n
  __device__ bool empty() const { return drained && next >= end; }
};

__device__ __forceinline__ RayQueue make_queue(int n) {
  const int warps = gridDim.x * (kThreads / 32);
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  RayQueue q;
  q.first_dynamic = warps * kFetch;
  q.next = warp * kFetch;
  q.end = min(q.next + kFetch, n);
  q.drained = q.first_dynamic >= n;
  return q;
}

// Hands ray indices to the lanes that hold none (ray < 0), once at least
// kRefill of them do or all do: from the warp's queue, which lane 0 fills
// from the counter with one atomicAdd when it is empty and broadcasts.
// Returns the lane's ray index, -1 where it gets none.
__device__ __forceinline__ int refill(int ray, int* work, int n,
                                      RayQueue& q) {
  const unsigned idle = __ballot_sync(kFullMask, ray < 0);
  const int k = __popc(idle);
  if (k == 0 || (k < kRefill && idle != kFullMask)) return ray;
  if (q.next >= q.end) {
    if (q.drained) return ray;
    int base = 0;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(work, kFetch);
    base = __shfl_sync(kFullMask, base, 0) + q.first_dynamic;
    q.next = min(base, n);
    q.end = min(base + kFetch, n);
    q.drained = base + kFetch >= n;
  }
  const int lane = threadIdx.x & 31;
  const int i = q.next + __popc(idle & ((1u << lane) - 1u));
  const int end = q.end;
  q.next = min(q.next + k, end);
  if (ray >= 0) return ray;
  return i < end ? i : -1;
}

// Blocks of `kernel` that stay resident on one SM of the current device,
// and that many blocks on every SM (the resident grid).  The query runs
// once per device and `slot`; later calls read the cache.
constexpr int kCacheDevices = 16;
constexpr int kCacheSlots = 8;

template <class Kernel>
__host__ int resident_grid(Kernel kernel, int slot, int* blocks_per_sm) {
  static std::atomic<int> cache[kCacheDevices][kCacheSlots][2];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev < kCacheDevices && slot < kCacheSlots;
  int per_sm = cached ? cache[dev][slot][0].load(std::memory_order_acquire)
                      : 0;
  int grid = cached ? cache[dev][slot][1].load(std::memory_order_relaxed) : 0;
  if (per_sm == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    grid = per_sm * sms;
    if (cached && per_sm > 0) {
      cache[dev][slot][1].store(grid, std::memory_order_relaxed);
      cache[dev][slot][0].store(per_sm, std::memory_order_release);
    }
  }
  if (blocks_per_sm != nullptr) *blocks_per_sm = per_sm;
  return grid;
}

// The grid of one launch over n rays: the resident grid, or fewer blocks
// when n rays fill fewer.
template <class Kernel>
__host__ int launch_grid(Kernel kernel, int slot, int n) {
  const int needed = (n + kThreads - 1) / kThreads;
  const int resident = resident_grid(kernel, slot, nullptr);
  return resident < needed ? (resident > 0 ? resident : 1) : needed;
}

}  // namespace lumo
