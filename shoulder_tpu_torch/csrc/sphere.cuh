// What csrc/sphere_score.cu and csrc/sphere_fit.cu share: the block and
// tile shape of their (tiles, B) grids, the fixed-order sum over a bone's
// tile partials, and the ticket that elects the last block of a bone.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sphere {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // points per block
constexpr unsigned kFull = 0xffffffffu;

// The sum of n partials at p[0], p[stride], ... in a fixed order: kLanes
// interleaved running sums in tile order, then those pairwise, so that no
// sum runs serially over more than n / kLanes + 3 terms.  Reads through
// L2 (the partials are other blocks' stores).
__device__ __forceinline__ float tile_sum(const float* p, int n, int stride) {
  constexpr int kLanes = 8;
  float lane[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) lane[i] = 0.0f;
  for (int t = 0; t < n; t += kLanes) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (t + i < n) {
        lane[i] += __ldcg(p + static_cast<size_t>(t + i) * stride);
      }
    }
  }
#pragma unroll
  for (int w = kLanes / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w; ++i) lane[i] += lane[i + w];
  }
  return lane[0];
}

// Whether this block is the last of bone b's n_tiles blocks to have
// stored its partial: every thread fences its stores, thread 0 takes an
// integer ticket from done[b], and the last block resets done[b] to 0 for
// the next launch.  Every thread of the block gets the answer.
__device__ __forceinline__ bool last_block(unsigned* done, int b,
                                           int n_tiles) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(done + b, 1u) == static_cast<unsigned>(n_tiles - 1);
    if (s_last) done[b] = 0u;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

}  // namespace sphere
