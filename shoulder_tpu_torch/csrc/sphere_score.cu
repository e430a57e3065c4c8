// Row-weighted Tukey score of every sphere hypothesis of every bone, one
// launch per pick of models/segment.py's sphere_segment.
//
// It replaces, on the card, ops/sphere.py's score_plain (this kernel's
// plain version: the hypotheses scored HYP_CHUNK at a time through
// (B, HYP_CHUNK, P, 3) float32 differences).  In the JAX package that is
// XLA code, `tukey_score` under `pick_best`
// (shoulder_tpu/models/segment.py:174, :214-228), not a Pallas kernel.
//
// Contract, for B bones of P points each and H <= kMaxHyp hypotheses:
//   in   pts (B, P, 3) f32, w_row (P,) f32 (the selection-only row prior),
//        h_rad (B, H) f32, h_cen (B, H, 3) f32, the scale: (B,) f32 or one
//        value for every bone
//   out  scores (B, H) f32,
//        S[b, h] = sum_p w_row[p] (1 - min(| |x_bp - c_bh| - r_bh | / s_b,
//                  1)^2)^2
//   scratch  partial (B, tiles, H) f32, tiles = ceil(P / kTile), written
//        before it is read; done (B,) u32 counters, 0 before the launch
//        and left 0 after it
// The grid is (tiles, B): a block owns one tile of kTile points of one
// bone, kPerThread points a thread in registers, and loops over all H
// hypotheses, which it holds in shared memory.  For each hypothesis a
// thread sums its points in order, the warp sums its lanes by a xor
// butterfly, and after the loop the block sums its warps in order into
// its partial.  The last block of a bone to finish (an integer ticket,
// after a fence: sphere.cuh's last_block, which resets the bone's
// counter) sums that bone's partials, 8 interleaved running sums in tile
// order, then pairwise (tile_sum).  No float atomics: every sum has one
// fixed order, which depends on P alone, so a bone's scores are bit for
// bit the same alone or in any batch.
//
// What bounds it on this card.  The points are read once per call (24 B
// a point with the row weight, 25 MB for a batch of 8 at P = 262,144),
// where the plain version writes and reads (B, 32, P, 3) float32 five
// times a call (805 MB each at B = 8).  The work is ~18 float32
// operations per (point, hypothesis) pair, 4.9 GFLOP per batch of 8 at
// H = 130: the bound is the operations (73 us at 67 TFLOP/s) and the
// bytes are 8 us.  So the design spends nothing on data movement beyond
// one read of a tile, and keeps the per-hypothesis overhead (one shared
// broadcast load, five shuffles) small against kPerThread pairs a thread.
// On an H100 (700 W) a batch of 8 takes 0.29 ms, 25 % of that bound,
// against 12.8 ms for the plain version: what is left is issue, ~22
// instructions a pair without FMA contraction and an IEEE square root.
//
// Numerics.  Built with -fmad=false (ops/kernels.py): each product and
// sum rounds on its own, as PyTorch's separate elementwise kernels do.
// The residual is multiplied by the scale's reciprocal (as PyTorch divides
// by a number; one rounding more than its division by a tensor), and the
// sums run in another order than torch.sum's.  The scores of the
// hypotheses a pick may take (radius in (10, 45) mm) agree with the plain
// version on the card to a relative 1e-5 (chip_smoke.py phase 5c; 2.4e-7
// at phase 4's bones on an H100, each version within 8e-7 of the float64
// sum of its terms), and an argmax over two scores that close may pick
// the other of the two (a tie, counted there).  A hypothesis of four
// nearly coplanar points has a radius of thousands of mm: float32 rounds
// its distances by ~5e-4 mm, and both versions' scores of it differ by
// up to ~1e-5; the pick never takes it.

#include "sphere.cuh"

namespace {

using sphere::kFull;
using sphere::kPerThread;
using sphere::kThreads;
using sphere::kTile;
using sphere::kWarps;

constexpr int kMaxHyp = 256;

__global__ void __launch_bounds__(kThreads)
sphere_score_kernel(const float* __restrict__ pts,
                    const float* __restrict__ w_row,
                    const float* __restrict__ h_rad,
                    const float* __restrict__ h_cen,
                    const float* __restrict__ scale, float scale_value,
                    float* __restrict__ partial, unsigned* __restrict__ done,
                    float* __restrict__ scores, int n_points, int n_hyp) {
  __shared__ float4 s_hyp[kMaxHyp];          // centre x, y, z, radius
  __shared__ float s_warp[kMaxHyp][kWarps];  // each warp's sum per hypothesis
  const int tile = blockIdx.x, n_tiles = gridDim.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int h = threadIdx.x; h < n_hyp; h += kThreads) {
    const size_t bh = static_cast<size_t>(b) * n_hyp + h;
    s_hyp[h] = make_float4(h_cen[bh * 3], h_cen[bh * 3 + 1],
                           h_cen[bh * 3 + 2], h_rad[bh]);
  }
  const float inv_s = 1.0f / (scale != nullptr ? scale[b] : scale_value);

  // this thread's points: tile start + k * kThreads + thread, so that a
  // warp's loads of one k are neighbours; past P a point weighs 0
  float px[kPerThread], py[kPerThread], pz[kPerThread], pw[kPerThread];
  const float* bone = pts + static_cast<size_t>(b) * n_points * 3;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = tile * kTile + k * kThreads + threadIdx.x;
    const bool in = p < n_points;
    px[k] = in ? bone[static_cast<size_t>(p) * 3] : 0.0f;
    py[k] = in ? bone[static_cast<size_t>(p) * 3 + 1] : 0.0f;
    pz[k] = in ? bone[static_cast<size_t>(p) * 3 + 2] : 0.0f;
    pw[k] = in ? w_row[p] : 0.0f;
  }
  __syncthreads();

  for (int h = 0; h < n_hyp; ++h) {
    const float4 hy = s_hyp[h];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float dx = px[k] - hy.x, dy = py[k] - hy.y, dz = pz[k] - hy.z;
      const float d = sqrtf(dx * dx + dy * dy + dz * dz);
      const float u = fminf(fabsf(d - hy.w) * inv_s, 1.0f);
      const float t = 1.0f - u * u;
      acc += pw[k] * (t * t);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0) s_warp[h][warp] = acc;
  }
  __syncthreads();

  float* mine = partial + (static_cast<size_t>(b) * n_tiles + tile) * n_hyp;
  for (int h = threadIdx.x; h < n_hyp; h += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_warp[h][w];
    mine[h] = v;
  }

  // the bone's last block sums its tiles
  if (!sphere::last_block(done, b, n_tiles)) return;
  const float* all = partial + static_cast<size_t>(b) * n_tiles * n_hyp;
  for (int h = threadIdx.x; h < n_hyp; h += kThreads) {
    scores[static_cast<size_t>(b) * n_hyp + h] =
        sphere::tile_sum(all + h, n_tiles, n_hyp);
  }
}

}  // namespace

extern "C" {

int sphere_score_tile() { return kTile; }

int sphere_score_max_hyp() { return kMaxHyp; }

// Launches the (tiles, B) grid on `stream` (a cudaStream_t) of device
// `device` and returns cudaGetLastError() of the launch: 0 when it was
// accepted.  `scale` may be null, and then every bone takes
// `scale_value`.  Arguments the kernel cannot index safely return
// cudaErrorInvalidValue and launch nothing.
int sphere_score_launch(const float* pts, const float* w_row,
                        const float* h_rad, const float* h_cen,
                        const float* scale, float scale_value, float* partial,
                        unsigned* done, float* scores, int n_points,
                        int n_bones, int n_hyp, int device, void* stream) {
  // the current device is left alone when it is already `device`
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bones <= 0 || n_hyp <= 0) return 0;
  if (n_points < 1 || n_hyp > kMaxHyp || n_bones > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_points + kTile - 1) / kTile, n_bones);
  sphere_score_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pts, w_row, h_rad, h_cen, scale, scale_value, partial, done, scores,
      n_points, n_hyp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
