// Weighted sphere moments of every bone's points, the sums behind each
// least-squares sphere of models/segment.py's sphere_segment: the seed
// fits, the IRLS passes with their Tukey weights made here, and the basin
// sigmas.
//
// It replaces, on the card, ops/sphere.py's moments_plain and sums_plain
// (this kernel's plain versions: the weighted mean, then
// utils/fits.gram's (B, P, 4, 5) product; the Tukey weights and the
// sigma's sums as separate (B, P) elementwise kernels).  In the JAX
// package that is XLA code, `fit`, the IRLS `lax.scan` body and
// `basin_sigma` (shoulder_tpu/models/segment.py:145-162, :230-238,
// :251-263), not a Pallas kernel.
//
// Contract, for B bones of P points each, one pass per launch:
//   in   pts (B, P, 3) f32; the weights, one of
//          kGiven  w (B, P) f32, its bone stride 0 (one vector for every
//                  bone) or P;
//          kTukey  w_p = (1 - min(| |x_p - c| - r | / s, 1)^2)^2 from each
//                  bone's centre c (B, 3), radius r (B,) and scale s ((B,)
//                  or one value), the IRLS weight;
//          kSigma  the same weight at one scale, for the basin sigma;
//   pass 1 (every weight)  sums (B, 5) f32 =
//          [sum w, sum w x, sum w y, sum w z, sum w sres^2], sres = |x - c|
//          - r; kGiven and kTukey leave the last 0, kSigma the middle three;
//   pass 2 (kGiven, kTukey)  reads pass 1's sums, takes the weighted mean
//          m = (sum w x) / max(sum w, 1), and writes mean (B, 3) = m and
//          normal (B, 4, 5) = A^T W [A | f], A = [2 q, 1], f = |q|^2,
//          q = x - m: the centred normal equations of the fit.
//   scratch  partial (B, tiles, 14) f32, written before it is read; done
//        (B,) u32 counters, 0 before the launch and left 0 after it.
// The solve of the 4 x 4 system and everything (B,)-sized stays in
// PyTorch.  The two passes keep the JAX package's centring "for f32
// conditioning": raw fourth-order moments in float32 would lose it.
//
// The grid is (tiles, B): a block owns kTile points of one bone,
// kPerThread a thread; each thread sums its points' terms in order, each
// warp its lanes by a xor butterfly, the block its warps in order into its
// partial, and the last block of a bone to finish (an integer ticket after
// a fence: sphere.cuh's last_block, which resets the bone's counter) sums
// that bone's partials, 8 interleaved running sums in tile order, then
// pairwise (tile_sum), and writes the bone's outputs.  No float atomics:
// every sum has one fixed order that depends on P alone, so a bone's
// outputs are bit for bit the same alone or in any batch.
//
// What bounds it on this card.  A pass reads the points once (12 B a
// point, and 4 B of given weights): 25 MB for a batch of 8 at P =
// 262,144, 7.5 us at 3.35 TB/s, and ~50 float32 operations a point, 1.5
// us at 67 TFLOP/s.  So it is bound by bytes, where the plain version
// writes and reads a (B, P, 4, 5) float32 product (168 MB) and a dozen
// (B, P) intermediates a fit.  The design moves nothing but the one read;
// each thread keeps its 14 sums in registers.  On an H100 (700 W) a fit's
// two passes take 0.039 ms at batch 8, 20 % of that bound, against
// 0.66-0.78 ms for the plain version: two launches, each ending in one
// block's pass over the bone's tile partials.
//
// Numerics.  Built with -fmad=false (ops/kernels.py): each product and sum
// rounds on its own, as PyTorch's elementwise kernels do.  The Tukey
// residual is multiplied by the scale's reciprocal (one rounding more than
// the plain version's division by a tensor), and the sums run in another
// order than torch.sum's, so the moments agree with the plain version's
// to float32 rounding of sums over P points (within 1.6e-5 of the
// matrix's largest entry at phase 4's bones on an H100), each fit's
// sphere within 1e-3 mm (2e-5 mm there) and the refined sphere after the
// IRLS within 1e-3 mm (chip_smoke.py phase 5c).

#include "sphere.cuh"

namespace {

using sphere::kFull;
using sphere::kPerThread;
using sphere::kThreads;
using sphere::kTile;
using sphere::kWarps;

constexpr int kMaxSums = 14;

enum Weights { kGiven = 0, kTukey = 1, kSigma = 2 };

// sums a block takes: pass 1 [w, wx, wy, wz] or, for the sigma, [w, w
// sres^2]; pass 2 [w, w q (3), w q_i q_j (6: xx xy xz yy yz zz), w f, w q f
// (3)]
__host__ __device__ constexpr int n_sums(int pass, int weights) {
  return pass == 2 ? 14 : (weights == kSigma ? 2 : 4);
}

// Sums `vals` over the block: each warp by a xor butterfly, then the warps
// in order.  Thread i < N gets sum i in the return value.
template <int N>
__device__ float block_sums(float (&vals)[N], float (*s_red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = vals[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) s_red[i][warp] = v;
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < N) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_red[threadIdx.x][w];
  }
  return total;
}

template <int kPass, int kWeights>
__device__ void fit_block(const float* __restrict__ pts,
                          const float* __restrict__ w, long long w_stride,
                          const float* __restrict__ center,
                          const float* __restrict__ radius,
                          const float* __restrict__ scale, float scale_value,
                          float* __restrict__ partial,
                          unsigned* __restrict__ done,
                          float* __restrict__ sums, float* __restrict__ mean,
                          float* __restrict__ normal, int n_points) {
  constexpr int N = n_sums(kPass, kWeights);
  __shared__ float s_red[kMaxSums][kWarps];
  __shared__ float s_tot[kMaxSums];
  const int tile = blockIdx.x, n_tiles = gridDim.x, b = blockIdx.y;

  float cx = 0.0f, cy = 0.0f, cz = 0.0f, r = 0.0f, inv_s = 0.0f;
  if constexpr (kWeights != kGiven) {
    cx = center[b * 3];
    cy = center[b * 3 + 1];
    cz = center[b * 3 + 2];
    r = radius[b];
    inv_s = 1.0f / (scale != nullptr ? scale[b] : scale_value);
  }
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
  if constexpr (kPass == 2) {
    const float* s1 = sums + b * 5;
    const float den = fmaxf(s1[0], 1.0f);
    mx = s1[1] / den;
    my = s1[2] / den;
    mz = s1[3] / den;
  }

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  const float* bone = pts + static_cast<size_t>(b) * n_points * 3;
  const float* wb = w + (kWeights == kGiven ? b * w_stride : 0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = tile * kTile + k * kThreads + threadIdx.x;
    if (p >= n_points) continue;
    const float x = bone[static_cast<size_t>(p) * 3];
    const float y = bone[static_cast<size_t>(p) * 3 + 1];
    const float z = bone[static_cast<size_t>(p) * 3 + 2];
    float wt, sres = 0.0f;
    if constexpr (kWeights == kGiven) {
      wt = wb[p];
    } else {
      const float dx = x - cx, dy = y - cy, dz = z - cz;
      sres = sqrtf(dx * dx + dy * dy + dz * dz) - r;
      const float u = fminf(fabsf(sres) * inv_s, 1.0f);
      const float t = 1.0f - u * u;
      wt = t * t;
    }
    if constexpr (kPass == 1) {
      acc[0] += wt;
      if constexpr (kWeights == kSigma) {
        acc[1] += wt * (sres * sres);
      } else {
        acc[1] += x * wt;
        acc[2] += y * wt;
        acc[3] += z * wt;
      }
    } else {
      const float qx = x - mx, qy = y - my, qz = z - mz;
      const float wx = qx * wt, wy = qy * wt, wz = qz * wt;
      const float f = qx * qx + qy * qy + qz * qz;
      acc[0] += wt;
      acc[1] += wx;
      acc[2] += wy;
      acc[3] += wz;
      acc[4] += wx * qx;
      acc[5] += wx * qy;
      acc[6] += wx * qz;
      acc[7] += wy * qy;
      acc[8] += wy * qz;
      acc[9] += wz * qz;
      acc[10] += wt * f;
      acc[11] += wx * f;
      acc[12] += wy * f;
      acc[13] += wz * f;
    }
  }

  const float v = block_sums<N>(acc, s_red);
  float* mine = partial + (static_cast<size_t>(b) * n_tiles + tile) * kMaxSums;
  if (threadIdx.x < N) mine[threadIdx.x] = v;

  // the bone's last block sums its tiles
  if (!sphere::last_block(done, b, n_tiles)) return;
  if (threadIdx.x < N) {
    const float* all = partial + static_cast<size_t>(b) * n_tiles * kMaxSums;
    s_tot[threadIdx.x] = sphere::tile_sum(all + threadIdx.x, n_tiles,
                                          kMaxSums);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float* T = s_tot;
  if constexpr (kPass == 1) {
    float* out = sums + b * 5;
    out[0] = T[0];
    if constexpr (kWeights == kSigma) {
      out[1] = out[2] = out[3] = 0.0f;
      out[4] = T[1];
    } else {
      out[1] = T[1];
      out[2] = T[2];
      out[3] = T[3];
      out[4] = 0.0f;
    }
  } else {
  mean[b * 3] = mx;
  mean[b * 3 + 1] = my;
  mean[b * 3 + 2] = mz;
  // A = [2 q, 1]: A^T W A and A^T W f from the centred sums
  float* n = normal + b * 20;
  const float qq[3][3] = {{T[4], T[5], T[6]},
                          {T[5], T[7], T[8]},
                          {T[6], T[8], T[9]}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) n[i * 5 + j] = 4.0f * qq[i][j];
    n[i * 5 + 3] = 2.0f * T[1 + i];
    n[i * 5 + 4] = 2.0f * T[11 + i];
    n[15 + i] = 2.0f * T[1 + i];
  }
  n[18] = T[0];
  n[19] = T[10];
  }
}

template <int kPass, int kWeights>
__global__ void __launch_bounds__(kThreads)
sphere_fit_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                  long long w_stride, const float* __restrict__ center,
                  const float* __restrict__ radius,
                  const float* __restrict__ scale, float scale_value,
                  float* __restrict__ partial, unsigned* __restrict__ done,
                  float* __restrict__ sums, float* __restrict__ mean,
                  float* __restrict__ normal, int n_points) {
  fit_block<kPass, kWeights>(pts, w, w_stride, center, radius, scale,
                             scale_value, partial, done, sums, mean, normal,
                             n_points);
}

// the basin sigma's pass under a name of its own, so that a profile tells
// it from the fits' passes
__global__ void __launch_bounds__(kThreads)
sphere_sigma_kernel(const float* __restrict__ pts,
                    const float* __restrict__ center,
                    const float* __restrict__ radius,
                    const float* __restrict__ scale, float scale_value,
                    float* __restrict__ partial, unsigned* __restrict__ done,
                    float* __restrict__ sums, int n_points) {
  fit_block<1, kSigma>(pts, nullptr, 0, center, radius, scale, scale_value,
                       partial, done, sums, nullptr, nullptr, n_points);
}

}  // namespace

extern "C" {

int sphere_fit_tile() { return kTile; }

int sphere_fit_partials() { return kMaxSums; }

// Launches pass `pass` (1 or 2) of weights `weights` (0 given, 1 Tukey, 2
// sigma: pass 1 only) over the (tiles, B) grid on `stream` (a
// cudaStream_t) of device `device` and returns cudaGetLastError() of the
// launch: 0 when it was accepted.  `w` is read for given weights only;
// `center`, `radius` and the scale for the others (`scale` may be null,
// and then every bone takes `scale_value`).  Arguments the kernel cannot
// index safely return cudaErrorInvalidValue and launch nothing.
int sphere_fit_launch(const float* pts, const float* w, long long w_stride,
                      const float* center, const float* radius,
                      const float* scale, float scale_value, int pass,
                      int weights, float* partial, unsigned* done,
                      float* sums, float* mean, float* normal, int n_points,
                      int n_bones, int device, void* stream) {
  // the current device is left alone when it is already `device`
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bones <= 0) return 0;
  const bool ok =
      n_points >= 1 && n_bones <= 65535 && (pass == 1 || pass == 2) &&
      weights >= kGiven && weights <= kSigma &&
      !(pass == 2 && weights == kSigma) &&
      (weights == kGiven ? w != nullptr
                         : center != nullptr && radius != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_points + kTile - 1) / kTile, n_bones);
  const auto st = static_cast<cudaStream_t>(stream);
  if (weights == kSigma) {
    sphere_sigma_kernel<<<grid, kThreads, 0, st>>>(
        pts, center, radius, scale, scale_value, partial, done, sums,
        n_points);
  } else {
    auto kernel = pass == 1
        ? (weights == kGiven ? &sphere_fit_kernel<1, kGiven>
                             : &sphere_fit_kernel<1, kTukey>)
        : (weights == kGiven ? &sphere_fit_kernel<2, kGiven>
                             : &sphere_fit_kernel<2, kTukey>);
    kernel<<<grid, kThreads, 0, st>>>(pts, w, w_stride, center, radius,
                                      scale, scale_value, partial, done,
                                      sums, mean, normal, n_points);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
