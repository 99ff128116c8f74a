// Cost per trip of a loop that runs inside one kernel, with and without a
// block-wide vote or reduction in it, for Hopper (sm_90a).
//
// Replaces tools/exp_sync.py::make(variant).kern, the TPU microbenchmark
// of a while_loop over one (8, 128) float32 tile.  It computes the same
// outputs: out = float(s) + acc after `iters` trips, where per trip i
//   scalar   nothing;
//   vec      acc += x * 1.000001;
//   reduce1  s += any(x + i > 1.5);
//   branch1  if any(x + i > 1.5): acc += 1;
//   reduce4  s += any(x + (i + k) > 1.5) for k = 0..3;
//   packed2  m = sum((x + i > 1.5) + ((x + i > 1.2) << 12));
//            s += (m & 4095) + (m >> 12).
// The TPU kernel never initialises its acc scratch; here acc starts at 0.
//
// None of the TPU layout carries over: the tile is one block of 1024
// threads, one element each; the any-reduce is the block vote
// __syncthreads_or, and the packed sum is a warp reduction
// (__reduce_add_sync) followed by a 32-word exchange through shared
// memory.  What bounds it on an H100 is neither bytes (8 KB in all) nor
// arithmetic but the latency of one block-wide barrier per trip: the time
// per trip is the result, to set beside the host round trip
// (tensor.any().item()) that a loop on the host pays instead.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;  // threads of the one block

enum Variant { kScalar, kVec, kReduce1, kBranch1, kReduce4, kPacked2 };

template <int V>
__global__ void __launch_bounds__(kTile)
    sync_loop(const float* __restrict__ x_in, float* __restrict__ out,
              int iters) {
  __shared__ int warp_sum[kTile / 32];
  const int tid = threadIdx.x;
  const float x = x_in[tid];
  float acc = 0.f;
  int s = 0;
  for (int i = 0; i < iters; ++i) {
    if (V == kScalar) {
      // keep the empty loop: the counter is opaque to the compiler
      asm volatile("" : "+r"(i));
    } else if (V == kVec) {
      acc = acc + x * 1.000001f;
    } else if (V == kReduce1) {
      s += __syncthreads_or(x + static_cast<float>(i) > 1.5f) ? 1 : 0;
    } else if (V == kBranch1) {
      if (__syncthreads_or(x + static_cast<float>(i) > 1.5f)) acc = acc + 1.0f;
    } else if (V == kReduce4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s += __syncthreads_or(x + static_cast<float>(i + k) > 1.5f) ? 1 : 0;
      }
    } else {
      const float xi = x + static_cast<float>(i);
      const int v = (xi > 1.5f ? 1 : 0) + ((xi > 1.2f ? 1 : 0) << 12);
      const int w = __reduce_add_sync(0xffffffffu, v);
      if ((tid & 31) == 0) warp_sum[tid >> 5] = w;
      __syncthreads();
      int m = 0;
#pragma unroll
      for (int k = 0; k < kTile / 32; ++k) m += warp_sum[k];
      __syncthreads();  // all have read before the next trip writes
      s += (m & 4095) + (m >> 12);
    }
  }
  out[tid] = 0.f + static_cast<float>(s) + acc;
}

template <int V>
int launch(const float* x, float* out, int iters, cudaStream_t s) {
  sync_loop<V><<<1, kTile, 0, s>>>(x, out, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (8, 128) float32 on the device.  variant: 0 scalar, 1 vec,
// 2 reduce1, 3 branch1, 4 reduce4, 5 packed2.  Returns the cudaError_t of
// the launch.
int lumo_exp_sync(int variant, const void* x, void* out, int iters,
                  void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kScalar: return launch<kScalar>(xf, of, iters, s);
    case kVec: return launch<kVec>(xf, of, iters, s);
    case kReduce1: return launch<kReduce1>(xf, of, iters, s);
    case kBranch1: return launch<kBranch1>(xf, of, iters, s);
    case kReduce4: return launch<kReduce4>(xf, of, iters, s);
    case kPacked2: return launch<kPacked2>(xf, of, iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
