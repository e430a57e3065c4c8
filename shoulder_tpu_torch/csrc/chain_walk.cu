// Contour-chain walk: the Hopper kernel of the slicing stage.
//
// Replaces shoulder_tpu/ops/pallas_chain.py::_walk_kernel (the Pallas TPU
// kernel behind chain_walk / chain_walk_marked).  It computes what that
// kernel computes, not how: none of its Mosaic workarounds (one combined
// SMEM output, a carried `done` flag, a scalar copy loop) are needed here.
//
// Contract, per row r of R rows (one slicing plane each), K = row width:
//   in   succ[r, :]     int32  successor of each compact face slot
//                              (a self-loop where the face is uncrossed)
//   in   crossed[r, :]  int32  {0,1}, crossed faces packed at the front;
//                              only their count nc = sum(crossed[r]) is read
//   out  order[r, :]    int32  face visited at each walk position
//   out  is_start[r, :] uint8  1 where a walk position begins a loop
//   out  n[r]           int32  number of faces visited
// Loops start in order of their smallest unvisited slot h < nc and are
// walked in successor direction until the next slot is already visited;
// a self-successor ends at once.  Positions at or past n hold order 0 and
// is_start 0.  Successor values outside [0, K) end a loop like a visited
// slot does.
//
// What bounds it on this card: each walk step is a chain of dependent
// shared-memory loads (read succ[cur], then the visited mark of the
// successor), about 2 * nc steps per row, so one row is pure latency
// (tens of cycles per step) and no arithmetic or bandwidth limit is near.
// The design keeps many rows in flight instead: one warp per row, four rows
// per block, so a 600-row stack spreads over all 132 SMs and each SM
// overlaps the latency chains of its resident warps.  The warp stages the
// row in shared memory and writes it back with coalesced loads and stores;
// lane 0 walks (walk.cuh's walk_loops; the fused slice-stack kernel gets
// the same walk by list ranking, walk_ranked).
// The kernel is integer-only, so FMA contraction and float summation order
// do not touch it.
//
// The main path no longer launches this kernel: slice_stack.cu walks each
// plane inside its own block.  It stays as the walk's standalone entry
// point, held exactly against its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
chain_walk_kernel(const int32_t* __restrict__ succ,
                  const int32_t* __restrict__ crossed,
                  int32_t* __restrict__ order,
                  uint8_t* __restrict__ is_start,
                  int32_t* __restrict__ n_out,
                  int rows, int k) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warp leaves; no block barrier follows

  // per warp: [0, k) working successors (-1 marks visited), [k, 2k) the
  // walk order, head entries carrying +k
  int32_t* work = smem + warp * 2 * k;
  int32_t* walk = work + k;
  const size_t base = static_cast<size_t>(row) * k;

  int count = 0;
  for (int j = lane; j < k; j += kWarp) {
    work[j] = succ[base + j];
    walk[j] = 0;
    count += crossed[base + j] != 0;
  }
  const int nc = __reduce_add_sync(0xffffffffu, count);
  __syncwarp();

  if (lane == 0) n_out[row] = walk_loops(work, walk, nc, k);
  __syncwarp();

  for (int j = lane; j < k; j += kWarp) {
    const int32_t v = walk[j];
    const bool head = v >= k;
    order[base + j] = head ? v - k : v;
    is_start[base + j] = head ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Largest row width whose staging fits the default 48 KB of shared memory.
int chain_walk_max_k() { return 48 * 1024 / (kRowsPerBlock * 2 * 4); }

// Launches the walk on `stream` (a cudaStream_t) of device `device` and
// returns cudaGetLastError() of the launch: 0 when it was accepted.
int chain_walk_launch(const int32_t* succ, const int32_t* crossed,
                      int32_t* order, uint8_t* is_start, int32_t* n_out,
                      int rows, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (k <= 0 || k > chain_walk_max_k()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * kWarp);
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * 2 * k * sizeof(int32_t);
  chain_walk_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      succ, crossed, order, is_start, n_out, rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
