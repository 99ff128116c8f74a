// Backward of a per-lane read of a material table for Hopper (sm_90a): the
// sum of every lane's cotangent into the table's elements, the same bits
// from run to run.
//
// Replaces no TPU kernel.  The JAX package leaves this backward to XLA's
// scatter-add; on the card autograd's backward of table[index] is
// index_put_(accumulate=True), which sorts the indices and then gives each
// distinct row to one warp that adds its duplicates one after another.
// With 524,288 lanes over about 8 rows that is tens of thousands of serial
// adds a warp, about 13 ms a read on an H100 (PERF.md).
//
// The function: out[key(i) * width + w] = sum over lanes i of
// g[i * width + w], where key(i) = i0(i) for a row index into an
// (M, width) table, or i0(i) * cols + i1(i) (width 1) for a pair of
// indices into an (M, cols) table; negative indices wrap as Python's do.
// Lane i is (i >> kshift, i & (2^kshift - 1)) of a 2-D lane grid, and
// each index is read through its own element strides there, so a
// broadcast index (a stride of 0) is never copied.
//
// Design: resident blocks of ``warps`` warps (the caller's choice, at most
// kMaxWarps), each warp walking the lanes 32 at a time with a grid-stride
// loop.  Each warp owns a copy of the whole table in shared memory (the
// caller decides that ``warps`` copies fit; a launch past the card's
// shared memory fails).  A warp whose 32 lanes share one key (nearly every
// warp here: neighbouring lanes mostly hit one material; one vote tells)
// sums by a shuffle tree into lane 0.  Otherwise each lane finds the lanes
// of its key by a shuffle of every lane's key and sums their values in
// lane order.  (Those two shuffle loops stay rolled: with them unrolled,
// or with __match_any_sync, CUDA 12.8's ptxas fails register allocation
// on this kernel for sm_90a.)  One lane a
// key then adds the sum to the warp's copy.  No two lanes or warps ever
// add to one address, so there are no atomics.  Each block sums its warps'
// copies in warp order into its partial, and a second kernel sums the
// partials in block order.  The grid is fixed by the card, the table's
// size and the lane count, so the same inputs give the same bits.
//
// What bounds it: bytes.  Each lane's index or indices (8 B each) and its
// cotangent (width * sizeof(T)) are read once: at 524,288 float32 lanes
// 6.3 MB (width 1), 12.6 MB (width 4) and 29.4 MB (the pair form's four
// bins a lane), 1.9 to 8.8 us at 3.35 TB/s; the partials (blocks * table)
// are small beside them.  At these sizes the two launches' fixed cost is
// of the same order as the bound.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kSumThreads = 256;

// The lanes' keys: lane i = (n, j) = (i >> kshift, i & (2^kshift - 1)).
struct Index {
  const int64_t* i0;
  int64_t s0n, s0k;
  const int64_t* i1;  // null for a row index
  int64_t s1n, s1k;
  int kshift;
  int64_t rows, cols;
  int elems;          // rows * cols * width: the keys' range is rows * cols

  // The lane's key, or -1 for an index outside the table (the forward's
  // own read has already failed on it; the lane adds nothing).
  __device__ __forceinline__ int key(int64_t i) const {
    const int64_t n = i >> kshift, j = i & ((int64_t{1} << kshift) - 1);
    int64_t r = i0[n * s0n + j * s0k];
    if (r < 0) r += rows;
    if (r < 0 || r >= rows) return -1;
    if (i1 != nullptr) {
      int64_t c = i1[n * s1n + j * s1k];
      if (c < 0) c += cols;
      if (c < 0 || c >= cols) return -1;
      r = r * cols + c;
    }
    return static_cast<int>(r);
  }
};

// The warp's 32 values summed by a fixed tree into lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The values of the lanes in ``group`` summed in lane order (every lane of
// the group gets the same sum).
template <typename T>
__device__ __forceinline__ T group_sum(T v, unsigned group) {
  T s = T(0);
#pragma unroll 1
  for (int src = 0; src < 32; ++src) {
    const T x = __shfl_sync(kFull, v, src);
    if ((group >> src) & 1u) s += x;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    partial_sums(const T* __restrict__ g, Index idx, int64_t lanes,
                 int width, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);  // [warps][elems]
  const int elems = idx.elems, threads = blockDim.x, warps = threads >> 5;
  for (int e = threadIdx.x; e < warps * elems; e += threads) acc[e] = T(0);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* mine = acc + warp * elems;
  const int64_t step = static_cast<int64_t>(gridDim.x) * threads;
  // base is warp-uniform, so every lane runs every trip (full-mask votes)
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * threads + warp * 32;
       base < lanes; base += step) {
    const int64_t i = base + lane;
    const int key = i < lanes ? idx.key(i) : -1;
    unsigned group = kFull;  // the lanes that hold this lane's key
    if (!__all_sync(kFull, key == __shfl_sync(kFull, key, 0))) {
      group = 0;
#pragma unroll 1
      for (int src = 0; src < 32; ++src)
        group |= (__shfl_sync(kFull, key, src) == key ? 1u : 0u) << src;
    }
    const bool leader = key >= 0 && lane == __ffs(group) - 1;
    for (int w = 0; w < width; ++w) {
      const T v = key >= 0 ? g[i * width + w] : T(0);
      const T s = group == kFull ? warp_sum(v) : group_sum(v, group);
      if (leader) mine[key * width + w] += s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < elems; e += threads) {
    T s = acc[e];
    for (int w = 1; w < warps; ++w) s += acc[w * elems + e];
    partials[static_cast<int64_t>(blockIdx.x) * elems + e] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    block_sums(const T* __restrict__ partials, int blocks, int elems,
               T* __restrict__ out) {
  const int e = blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= elems) return;
  T s = T(0);
  for (int b = 0; b < blocks; ++b)
    s += partials[static_cast<int64_t>(b) * elems + e];
  out[e] = s;
}

template <typename T>
int launch(const void* g, const Index& idx, int64_t lanes, int width,
           int warps, int max_blocks, void* partials, void* out,
           cudaStream_t s) {
  const int elems = idx.elems, threads = warps * 32;
  if (elems <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * warps * static_cast<size_t>(elems);
  int blocks = 0;
  if (lanes > 0) {
    cudaError_t rc = cudaFuncSetAttribute(
        partial_sums<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    int dev = 0, sms = 0, per_sm = 0;
    if (rc != cudaSuccess ||
        (rc = cudaGetDevice(&dev)) != cudaSuccess ||
        (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, partial_sums<T>, threads, smem)) != cudaSuccess) {
      // a refused set-up (a table past the card's shared memory) launches
      // nothing and leaves no error for the next call to read
      cudaGetLastError();
      return static_cast<int>(rc);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t want = (lanes + threads - 1) / threads;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    blocks = static_cast<int>(
        std::min({want, resident, static_cast<int64_t>(max_blocks)}));
    partial_sums<T><<<blocks, threads, smem, s>>>(
        static_cast<const T*>(g), idx, lanes, width, static_cast<T*>(partials));
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  block_sums<T><<<(elems + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                  s>>>(static_cast<const T*>(partials), blocks, elems,
                       static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (elems,) = the table's gradient, elems = rows * cols * width, from
// g (lanes, width) contiguous, of dtype 0 float32 or 1 float64.  i0 (and
// i1, or null) are int64 indices read at lane (n, j) = (i >> kshift,
// i & (2^kshift - 1)) through element strides (s0n, s0k) and (s1n, s1k);
// lanes = n * 2^kshift.  partials holds at
// least max_blocks * elems values of g's dtype; a launch takes at most
// max_blocks blocks (fewer where fewer are resident or needed) of warps
// warps (1 to 8), each warp with its own copy of the table in shared
// memory.  With no
// lanes the launch writes zeros.  Returns the cudaError_t of the launches.
int lumo_table_grad(int dtype, const void* g, const void* i0, int64_t s0n,
                    int64_t s0k, const void* i1, int64_t s1n, int64_t s1k,
                    int64_t lanes, int kshift, int64_t rows, int64_t cols,
                    int width, int warps, int max_blocks, void* partials,
                    void* out, void* stream) {
  if (kshift < 0 || kshift > 30 || rows < 1 || cols < 1 || width < 1 ||
      warps < 1 || warps > kMaxWarps || max_blocks < 1 ||
      rows * cols * width > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Index idx{static_cast<const int64_t*>(i0), s0n, s0k,
                  static_cast<const int64_t*>(i1), s1n, s1k, kshift, rows,
                  cols,
                  static_cast<int>(rows * cols * width)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(g, idx, lanes, width, warps, max_blocks,
                                 partials, out, s);
    case 1: return launch<double>(g, idx, lanes, width, warps, max_blocks,
                                  partials, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
