// Fused slice-stack kernel: every cross-section of one slice stack of a
// whole bone batch, one thread block per (bone, plane), one launch per
// stack per batch.
//
// It replaces, on the card, the whole walk branch of ops/slicing.py's
// slice_stack: the window search (_window_starts), the per-plane
// compaction of crossed faces and their oriented segments
// (_compact_slice), the contour-chain walk (the walk of the Pallas kernel
// shoulder_tpu/ops/pallas_chain.py::_walk_kernel, here walk.cuh's
// walk_ranked), and the loop finish (_post_walk with _resample).
// slice_stack's plain PyTorch composition of those functions is this
// kernel's plain version: the integer results (crossings, slots,
// successors, walk order, the chosen loop and its roll) are computed by
// the same rules, and every float is computed by the same expressions in
// the same order where the plain version does elementwise work.
//
// Contract, for B bones of F faces each (padded to one F, SortedGeom
// stacked on a leading bone dim) and S planes zs per bone: window `band`
// (<= F), `k` compact slots (<= band), `interp` samples per contour.
//   in   fvt (B, F, 9) f32, ids (B, F, 4) i32, z_mm (B, F, 2) f32,
//        z_key (B, F) f32, cummax_z_max (B, F) f32, zs (B, S) f32
//   out  contours (B, S, interp, 2) f32, centroids (B, S, 2) f32, areas
//        (B, S), total_areas (B, S), overflow (B, S) u8 (window overflow,
//        or more than k faces crossed), open_edges (B, S) u8
// Block (plane, bone) = (blockIdx.x, blockIdx.y) reads only its bone's
// faces and writes only its row bone * S + plane: the batch is the JAX
// walk kernel's batching rule (pallas_chain.py folds (B, S, K) into
// B·S rows) carried to the whole stage.  A block computes exactly what it
// computes in a launch of its bone alone, so the batched launch equals
// the per-bone launches bit for bit.  Offsets are 64-bit: a CT batch of
// 32 at 300,000 faces is 86 M floats of fvt.
//
// What bounds it on this card.  The bytes are few: each plane reads its
// (band, 2) z window (16 KB at band 2048) and gathers at most k rows of
// fvt/ids (the 1.5 MB face table of a bone sits in L2), and writes
// interp x 8 B of contour.  Inside a plane the stages are short and
// dependent, each ending in a barrier: a search, a compaction scan, the
// walk, scans over the walk and a resampling search.  So a plane is
// latency, and the design keeps everything between the stages in shared
// memory (nothing but the inputs and the final outputs touches device
// memory), gives every stage to the whole block (no stage leaves 255
// threads waiting on one), and runs one block per plane, 200-600 blocks
// per bone and stack (4800 for the proximal stack of a batch of 8) over
// the 132 SMs, several resident on each SM to overlap their latency
// chains.
//
// Stages of one block (256 threads):
//   1. window: the insertion point of z in z_key (searchsorted, side
//      left) counted by the block: while more than kSearchKeys keys per
//      thread are left, one strided probe per thread and
//      __syncthreads_count narrow the range to one stride; then each
//      thread counts its share (two dependent loads at 40,960 and 300,000
//      faces; tests/test_torch_slice_kernel.py states it in PyTorch).
//      The window start lo is clamped, and cummax_z_max[lo - 1] >= z
//      tested;
//   2. compaction: each warp reads a contiguous chunk of the z window,
//      32 positions a step (coalesced), straight into the crossing test
//      z_min < z <= z_max, each lane keeping its bits; one block scan of
//      the warps' counts, then each warp replays its ballots to give each
//      crossed face its slot in window order and build the inverse map
//      window position -> slot, with one barrier.  The window is read once
//      and not staged (cp.async / TMA): staging could save at most this
//      stage's time;
//   3. segments: one thread per slot gathers its fvt/ids row and computes
//      the sign pattern, entry/exit edges and points, and the successor
//      slot through the inverse map;
//   4. injectivity: the smallest-slot predecessor keeps each successor
//      (shared atomicMin on integers: the result does not depend on order);
//   5. walk: list ranking by the block (walk.cuh, walk_ranked): pointer
//      jumping over the predecessor map left by stage 4, ceil(log2 nvalid)
//      rounds of one barrier, then the loops' lengths, offsets (one block
//      scan) and one scatter of the walk and each position's loop start;
//   6. loop moments: block-wide inclusive scans over walk positions (warp
//      shuffles, then the warp totals in warp order: a fixed order, so
//      the result is deterministic; no float atomics anywhere), the best
//      loop by a (value, index) tree reduction, first index on ties;
//   7. roll: the loop's member with the smallest original face id leads;
//   8. resample: a scan of segment lengths gives the knots' arc length;
//      each sample binary-searches its knot max{i : ceil(cum_i/step) <= j}.
//
// Where a block's time goes.  The timed build (slice_stack_launch_timed)
// stamps clock64 at each stage boundary; chip_smoke.py prints the per-stage
// medians.  On an H100 at DEFAULT_CONFIG, in a batch of 8 (4800 blocks on
// the proximal stack, 7 waves of 792), a block takes 18.5-19.6 us: walk
// 4.9-5.4, compaction 1.7-2.8, segments 2.0-2.4, window 2.1, moments 2.0,
// knots 1.8, resample 1.1-1.9, roll 1.0, injectivity 0.7; a bone alone
// 11.7-16.5 us.  At the CT sizes (k 1024, band 6144) 20.3-22.2 us, walk
// 4.3-5.7 and compaction 3.8-4.7.  No stage dominates and none waits on
// one thread, but each still ends in a barrier, and six resident blocks
// share the SM's warp schedulers and L1: every stage runs slower in the
// batch than alone, so what is left is instructions and barriers across
// all stages, not a serial stretch.  The bound counts bytes only (about
// 7 us a stack); the kernel sits at 5-12 % of it.
//
// Numerics.  Built with -fmad=false (ops/kernels.py): nvcc would contract
// a + t * b into an FMA, which PyTorch's separate elementwise kernels
// never do.  Division and sqrt are IEEE (no fast-math).  The float sums
// (moment and arc-length prefix sums, total area) run in another order
// than torch.cumsum / torch.sum, so areas, centroids and contours agree
// with the plain version to rounding, not bit for bit.
//
// Shared memory per block: 64 k + 2 band + 20 bytes dynamic, 28.0 KB at
// k 384 / band 2048 (76.0 KB at k 1024 / band 6144, 2 blocks per SM),
// plus 240 B static; above 48 KB the launch opts in.  The walk's scratch
// reuses arrays that are dead during it.  ptxas -v for sm_90a
// (chip_smoke.py prints it): 40 registers, held there by
// __launch_bounds__(256, 6) (without it 48, which fits 5 blocks), a 56-byte
// stack frame with 16 bytes of spill stores; the timed build 40 registers
// and no spill.  So 6 blocks fit an SM at k 384, 792 on an H100.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks resident per SM at k 384 / band 2048 (28.7 KB of shared memory
// each): ptxas keeps the kernel within the 40 registers this leaves
constexpr int kBlocksPerSm = 6;
constexpr unsigned kFull = 0xffffffffu;
// the window search counts the keys left by each thread directly once
// there are at most this many per thread
constexpr int kSearchKeys = 8;
// window positions a lane tests in the compaction: one bit each of a
// 64-bit mask, so band <= kThreads * kMaxRun
constexpr int kMaxRun = 64;
// The timed build of the kernel records, per block, clock64() at the start
// and after each of the 9 stage boundaries below, then %globaltimer (ns) at
// the start and the end, so that cycles convert to time.
constexpr int kStamps = 12;

size_t smem_bytes(int band, int k) {
  const size_t kk = static_cast<size_t>(k);
  return sizeof(float2) * (3 * kk + 1)          // st, en, closed (k + 1)
         + sizeof(float) * (5 * kk + 2)         // 3 moment sums, knot cum, rank
         + sizeof(int32_t) * (5 * kk + 1)       // orig, work, walk, pos, fpred
         + sizeof(int16_t) * static_cast<size_t>(band);  // inverse map
}

struct Smem {
  float2* st;         // [k] segment start per slot
  float2* en;         // [k] segment end per slot
  float2* closed;     // [k + 1] the rolled, closed best loop
  float* cum_a;       // [k] prefix sums over walk positions: cross term
  float* cum_x;       // [k]   (x_s + x_e) * cross
  float* cum_y;       // [k]   (y_s + y_e) * cross
  float* knot_cum;    // [k + 1] arc length at each knot
  float* knot_rank;   // [k + 1] ceil(knot_cum / step): a knot's first sample
  int32_t* orig;      // [k] original face id per slot
  int32_t* work;      // [k] successor slot; the walk marks visits with -1
  int32_t* walk;      // [k] face per walk position, loop heads + k
  int32_t* pos;       // [k] window position per slot; later the loop start
                      //     position of each walk position
  int32_t* fpred;     // [k + 1] smallest predecessor slot per successor
  int16_t* inv;       // [band] window position -> slot, -1 for none
};

__device__ Smem carve(unsigned char* p, int k) {
  Smem s;
  s.st = reinterpret_cast<float2*>(p);        p += sizeof(float2) * k;
  s.en = reinterpret_cast<float2*>(p);        p += sizeof(float2) * k;
  s.closed = reinterpret_cast<float2*>(p);    p += sizeof(float2) * (k + 1);
  s.cum_a = reinterpret_cast<float*>(p);      p += sizeof(float) * k;
  s.cum_x = reinterpret_cast<float*>(p);      p += sizeof(float) * k;
  s.cum_y = reinterpret_cast<float*>(p);      p += sizeof(float) * k;
  s.knot_cum = reinterpret_cast<float*>(p);   p += sizeof(float) * (k + 1);
  s.knot_rank = reinterpret_cast<float*>(p);  p += sizeof(float) * (k + 1);
  s.orig = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * k;
  s.work = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * k;
  s.walk = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * k;
  s.pos = reinterpret_cast<int32_t*>(p);      p += sizeof(int32_t) * k;
  s.fpred = reinterpret_cast<int32_t*>(p);    p += sizeof(int32_t) * (k + 1);
  s.inv = reinterpret_cast<int16_t*>(p);
  return s;
}

// Inclusive prefix sums of N values per thread over the block, in thread
// order, and the block totals.  Lanes combine by Hillis-Steele shuffles,
// then each thread adds the totals of the warps before its own, in warp
// order.  All threads must call it.
template <int N>
__device__ void block_scan_sum(float (&v)[N], float (&total)[N],
                               float (*wsum)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    for (int c = 0; c < N; ++c) {
      const float up = __shfl_up_sync(kFull, v[c], o);
      if (lane >= o) v[c] = up + v[c];
    }
  }
  if (lane == 31) {
    for (int c = 0; c < N; ++c) wsum[c][warp] = v[c];
  }
  __syncthreads();
  for (int c = 0; c < N; ++c) {
    float before = 0.0f, all = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before = all;
      all = all + wsum[c][w];
    }
    v[c] = before + v[c];
    total[c] = all;
  }
  __syncthreads();
}

// Block-wide (value, index) argmax: the largest value, the smallest index
// among equal values.  Every thread gets the result.
template <typename T>
__device__ void block_argmax(T& val, int& idx, T* wval, int* widx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(kFull, val, o);
    const int oi = __shfl_down_sync(kFull, idx, o);
    if (ov > val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
  if (lane == 0) {
    wval[warp] = val;
    widx[warp] = idx;
  }
  __syncthreads();
  val = wval[0];
  idx = widx[0];
  for (int w = 1; w < kWarps; ++w) {
    if (wval[w] > val || (wval[w] == val && widx[w] < idx)) {
      val = wval[w];
      idx = widx[w];
    }
  }
  __syncthreads();
}

// Point where edge v -> v+1 of a face meets the plane (the plain version's
// t = d / denom and p + t * (p_next - p), per edge).
__device__ __forceinline__ float2 edge_point(const float* gx, const float* gy,
                                             const float* d, int v) {
  const int w = v == 2 ? 0 : v + 1;
  float den = d[v] - d[w];
  if (fabsf(den) < 1e-30f) den = 1.0f;
  const float t = d[v] / den;
  return make_float2(gx[v] + t * (gx[w] - gx[v]), gy[v] + t * (gy[w] - gy[v]));
}

__device__ __forceinline__ int walk_face(const int32_t* walk, int p, int k) {
  const int w = walk[p];
  return w >= k ? w - k : w;
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

template <bool kTimed>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
slice_stack_kernel(const float* __restrict__ fvt,
                   const int4* __restrict__ ids,
                   const float2* __restrict__ z_mm,
                   const float* __restrict__ z_key,
                   const float* __restrict__ cummax_z_max,
                   const float* __restrict__ zs,
                   float2* __restrict__ contours,
                   float2* __restrict__ centroids,
                   float* __restrict__ areas,
                   float* __restrict__ total_areas,
                   uint8_t* __restrict__ overflow,
                   uint8_t* __restrict__ open_edges,
                   long long* __restrict__ stamps,
                   int32_t* __restrict__ walk_out,
                   int32_t* __restrict__ n_out,
                   int n_faces, int band, int k, int interp) {
  // this block's bone and its row of the (B, S) outputs
  const int plane = blockIdx.x;
  const size_t bone = blockIdx.y;
  const size_t row = bone * gridDim.x + plane;
  const size_t face0 = bone * static_cast<size_t>(n_faces);
  fvt += face0 * 9;
  ids += face0;
  z_mm += face0;
  z_key += face0;
  cummax_z_max += face0;
  // thread 0 stamps stage i; called right after a barrier, so every thread
  // has finished the stage before
  auto stamp = [&](int i) {
    if constexpr (kTimed) {
      if (threadIdx.x == 0 && stamps) stamps[row * kStamps + i] = clock64();
    }
  };
  long long ns0 = 0;
  if constexpr (kTimed) ns0 = global_ns();
  stamp(0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wsum[3][kWarps];
  __shared__ int wint[kWarps];
  __shared__ float wval_f[kWarps];
  __shared__ int wval_i[kWarps];
  __shared__ int widx[kWarps];
  __shared__ int s_nc, s_open;

  const Smem sm = carve(smem_raw, k);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float z = zs[row];

  // ---- 1. window: slots [lo, lo + band) end at the insertion point of z
  // (searchsorted, side left), the count of keys below z.  While more than
  // kSearchKeys keys per thread are left, each thread tests one key at a
  // stride and the block's count of keys below z narrows the range to one
  // stride; then each thread counts its share of the rest.
  int a0 = 0, span = n_faces;
  while (span > kThreads * kSearchKeys) {
    const int stride = (span + kThreads - 1) / kThreads;
    const int i = a0 + (tid + 1) * stride - 1;
    const int below = __syncthreads_count(i < a0 + span && z_key[i] < z);
    const int a1 = a0 + below * stride;
    span = min(stride - 1, a0 + span - a1);
    a0 = a1;
  }
  int warp_below = 0;
  for (int i = a0 + tid; i < a0 + span; i += kThreads) {
    warp_below += z_key[i] < z;
  }
  warp_below = __reduce_add_sync(kFull, warp_below);
  if (lane == 0) widx[warp] = warp_below;
  for (int j = tid; j <= k; j += kThreads) sm.fpred[j] = k;
  if (tid == 0) {
    s_nc = 0;
    s_open = 0;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) a0 += widx[w];
  const int lo = max(0, min(a0 - band, n_faces - band));
  // the window overflow test's key: thread 0 loads it now and tests it
  // after stage 2, so the load's latency overlaps the compaction
  const float below_max = tid == 0 && lo > 0 ? cummax_z_max[lo - 1] : 0.0f;
  stamp(1);

  // ---- 2. crossing test and stable compaction into slots [0, min(ncross, k)):
  // each warp takes a contiguous chunk of the window and reads it 32
  // positions at a time (coalesced), each lane keeping its crossing bits;
  // one block scan of the warps' counts gives each chunk its first slot;
  // each warp then replays its ballots to slot its faces in window order
  const int chunk = ((band + kWarps - 1) / kWarps + 31) & ~31;
  const int iters = chunk / 32;  // <= kMaxRun: band <= kThreads * kMaxRun
  const int w0 = warp * chunk + lane;
  unsigned long long bits = 0ull;
  int warp_crossed = 0;
  for (int j = 0; j < iters; ++j) {
    const int i = w0 + j * 32;
    bool c = false;
    if (i < band) {
      const float2 mm = z_mm[lo + i];
      c = (mm.y >= z) && (mm.x < z);
    }
    bits |= static_cast<unsigned long long>(c) << j;
    warp_crossed += __popc(__ballot_sync(kFull, c));
  }
  if (lane == 0) wint[warp] = warp_crossed;
  __syncthreads();
  int slot = 0, ncross = 0;  // ncross: the same in every thread
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) slot += wint[w];
    ncross += wint[w];
  }
  for (int j = 0; j < iters; ++j) {
    const int i = w0 + j * 32;
    const bool c = (bits >> j) & 1ull;
    const unsigned bal = __ballot_sync(kFull, c);
    const int at = slot + __popc(bal & ((1u << lane) - 1u));
    const bool kept = c && at < k;
    if (i < band) sm.inv[i] = kept ? static_cast<int16_t>(at) : int16_t(-1);
    if (kept) sm.pos[at] = i;
    slot += __popc(bal);
  }
  __syncthreads();
  stamp(2);
  const int nvalid = min(ncross, k);
  const bool over = ncross > k;
  const bool win_over = lo > 0 && below_max >= z;  // thread 0's is read

  // ---- 3. segments of the compact slots and their successor slots
  int my_nc = 0;
  bool my_open = false;
  for (int j = tid; j < k; j += kThreads) {
    int succ = -1;  // linked successor slot
    if (j < nvalid) {
      const int f = lo + sm.pos[j];
      const float* g = fvt + static_cast<size_t>(f) * 9;
      float gx[3], gy[3], d[3];
      bool pos[3];
      for (int v = 0; v < 3; ++v) {
        gx[v] = g[v];
        gy[v] = g[3 + v];
        d[v] = g[6 + v] - z;
        if (d[v] == 0.0f) d[v] = 1e-7f;
        pos[v] = d[v] > 0.0f;
      }
      int changes = 0, entry = -1, exit = -1;
      for (int v = 0; v < 3; ++v) {
        const bool pn = pos[v == 2 ? 0 : v + 1];
        changes += pos[v] != pn;
        if (entry < 0 && pos[v] && !pn) entry = v;
        if (exit < 0 && !pos[v] && pn) exit = v;
      }
      entry = max(entry, 0);  // argmax of an all-false row is 0
      exit = max(exit, 0);
      sm.st[j] = edge_point(gx, gy, d, entry);
      sm.en[j] = edge_point(gx, gy, d, exit);
      const int4 gi = ids[f];
      sm.orig[j] = gi.x;
      const int nbr = exit == 0 ? gi.y : (exit == 1 ? gi.z : gi.w);
      const int sw = nbr >= 0 ? nbr - lo : -1;
      const int si = (sw >= 0 && sw < band) ? sm.inv[sw] : -1;
      if (changes == 2) {
        ++my_nc;
        if (si < 0) my_open = true; else succ = si;
      }
    }
    sm.work[j] = succ;
  }
  if (my_nc) atomicAdd(&s_nc, my_nc);
  if (my_open) atomicOr(&s_open, 1);
  __syncthreads();
  stamp(3);

  // ---- 4. injectivity: the smallest-slot predecessor keeps its successor
  for (int j = tid; j < k; j += kThreads) {
    const int t = sm.work[j];
    if (t >= 0) atomicMin(&sm.fpred[t], j);
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    const int t = sm.work[j];
    sm.work[j] = (t >= 0 && sm.fpred[t] == j) ? t : j;
  }
  __syncthreads();
  stamp(4);

  // ---- 5. walk: list ranking by the whole block (walk.cuh) over the
  // nvalid slots, in buffers that are dead until stage 6: the two window
  // arrays over closed and cum_a..cum_y, the loop lengths over knot_cum.
  // It also writes each walk position's loop start into pos.
  const int n = walk_ranked<kThreads>(
      sm.work, sm.fpred, nvalid, s_nc, k, reinterpret_cast<uint2*>(sm.closed),
      reinterpret_cast<uint2*>(sm.cum_a),
      reinterpret_cast<int32_t*>(sm.knot_cum), wint, sm.walk, sm.pos);
  stamp(5);

  // ---- 6. loop moments in walk order
  float carry[3] = {0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 < k; r0 += kThreads) {
    const int p = r0 + tid;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (p < n) {
      const int f = walk_face(sm.walk, p, k);
      const float2 s = sm.st[f], e = sm.en[f];
      const float cr2 = s.x * e.y - e.x * s.y;
      v[0] = cr2;
      v[1] = (s.x + e.x) * cr2;
      v[2] = (s.y + e.y) * cr2;
    }
    float tot[3];
    block_scan_sum<3>(v, tot, wsum);
    if (p < k) {
      sm.cum_a[p] = carry[0] + v[0];
      sm.cum_x[p] = carry[1] + v[1];
      sm.cum_y[p] = carry[2] + v[2];
    }
    for (int c = 0; c < 3; ++c) carry[c] = carry[c] + tot[c];
  }
  __syncthreads();

  // best loop: the largest run-local area over loop ends (a loop ends just
  // before the next head, or at the last position), first on ties
  float best = -INFINITY;
  int e = INT_MAX;
  for (int p = tid; p < k; p += kThreads) {
    float a = -INFINITY;
    if (p < n && (p == n - 1 || sm.walk[p + 1] >= k)) {
      const int s0 = sm.pos[p];
      a = 0.5f * (sm.cum_a[p] - (s0 > 0 ? sm.cum_a[s0 - 1] : 0.0f));
    }
    if (e == INT_MAX || a > best) {
      best = a;
      e = p;
    }
  }
  block_argmax(best, e, wval_f, widx);
  stamp(6);

  const bool is_end = e < n && (e == n - 1 || sm.walk[e + 1] >= k);
  const int sor_e = is_end ? sm.pos[e] : 0;
  const float ba = sor_e > 0 ? sm.cum_a[sor_e - 1] : 0.0f;
  const float bx = sor_e > 0 ? sm.cum_x[sor_e - 1] : 0.0f;
  const float by = sor_e > 0 ? sm.cum_y[sor_e - 1] : 0.0f;
  const float area_e = 0.5f * (sm.cum_a[e] - ba);
  const bool has = is_end && area_e >= 0.0f;
  const float area_best = has ? area_e : 0.0f;
  const float denom = fabsf(area_best) > 1e-12f ? 6.0f * area_best : 1.0f;
  const int n_best = has ? e - sor_e + 1 : 0;
  const int p0 = has ? sor_e : 0;
  const int nb = max(n_best, 1);

  // ---- 7. roll the loop to its member with the smallest original face id
  int off = 0;
  if (n_best > 0) {
    int key = INT_MIN, at = INT_MAX;
    for (int p = tid; p < k; p += kThreads) {
      int kp = -INT_MAX;  // outside the loop: the plain version's int32 max
      if (p >= p0 && p < p0 + n_best) kp = -sm.orig[walk_face(sm.walk, p, k)];
      if (at == INT_MAX || kp > key) {
        key = kp;
        at = p;
      }
    }
    block_argmax(key, at, wval_i, widx);
    off = at - p0;
  }
  stamp(7);

  // ---- 8. arc-length resampling of the closed loop
  const float2 first = n_best > 0
      ? sm.st[walk_face(sm.walk, p0 + off % nb, k)] : make_float2(0.0f, 0.0f);
  for (int i = tid; i <= k; i += kThreads) {
    sm.closed[i] = i < n_best
        ? sm.st[walk_face(sm.walk, p0 + (i + off) % nb, k)] : first;
  }
  __syncthreads();
  float arc = 0.0f;
  for (int r0 = 0; r0 < k; r0 += kThreads) {
    const int i = r0 + tid;
    float v[1] = {0.0f};
    if (i < n_best) {
      const float2 a = sm.closed[i], b = sm.closed[i + 1];
      const float dx = b.x - a.x, dy = b.y - a.y;
      v[0] = sqrtf(dx * dx + dy * dy);
    }
    float tot[1];
    block_scan_sum<1>(v, tot, wsum);
    if (i < k) sm.knot_cum[i + 1] = arc + v[0];
    arc = arc + tot[0];
  }
  if (tid == 0) sm.knot_cum[0] = 0.0f;
  __syncthreads();
  const float total = sm.knot_cum[k];
  float step = total / static_cast<float>(interp - 1);
  if (!(step > 0.0f)) step = 1.0f;
  __syncthreads();  // every thread has read knot_cum[k] before it changes
  // past the loop the knots climb by 1 so that no sample lands there
  for (int i = tid; i <= k; i += kThreads) {
    const float c = i <= n_best
        ? sm.knot_cum[i] : total + static_cast<float>(i - n_best);
    sm.knot_cum[i] = c;
    sm.knot_rank[i] = ceilf(c / step);
  }
  __syncthreads();
  stamp(8);

  float2* out = contours + row * interp;
  for (int j = tid; j < interp; j += kThreads) {
    const float fj = static_cast<float>(j);
    int a = 0, b = k;  // the last knot whose first sample is at or before j
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (sm.knot_rank[mid] <= fj) a = mid; else b = mid - 1;
    }
    const int a1 = min(a + 1, k);
    const float c0 = sm.knot_cum[a], c1 = sm.knot_cum[a1];
    const float2 q0 = sm.closed[a], q1 = sm.closed[a1];
    float t = (fj * step - c0) / (c1 > c0 ? c1 - c0 : 1.0f);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    out[j] = make_float2(q0.x + t * (q1.x - q0.x), q0.y + t * (q1.y - q0.y));
  }

  if (tid == 0) {
    centroids[row] = has
        ? make_float2((sm.cum_x[e] - bx) / denom, (sm.cum_y[e] - by) / denom)
        : make_float2(0.0f, 0.0f);
    areas[row] = area_best;
    total_areas[row] = 0.5f * carry[0];
    overflow[row] = (win_over || over) ? 1 : 0;
    open_edges[row] = (s_open && !over) ? 1 : 0;
  }
  if constexpr (kTimed) {
    __syncthreads();
    stamp(9);
    if (tid == 0 && stamps) {
      stamps[row * kStamps + 10] = ns0;
      stamps[row * kStamps + 11] = global_ns();
    }
    if (walk_out) {  // the walk, head marks included; -1 past n
      for (int p = tid; p < k; p += kThreads) {
        walk_out[row * k + p] = p < n ? sm.walk[p] : -1;
      }
      if (tid == 0) n_out[row] = n;
    }
  }
}

template <bool kTimed>
int launch(const float* fvt, const int32_t* ids, const float* z_mm,
           const float* z_key, const float* cummax_z_max, const float* zs,
           float* contours, float* centroids, float* areas,
           float* total_areas, uint8_t* overflow, uint8_t* open_edges,
           long long* stamps, int32_t* walk_out, int32_t* n_out,
           int n_faces, int n_bones, int n_planes, int band, int k,
           int interp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_planes <= 0 || n_bones <= 0) return 0;
  // the wrapper holds band and k to its limits; this guards the memory
  // the kernel indexes: int16 slot ids, a window inside the faces and
  // within the compaction's runs, a bone per grid row (at most 65535)
  if (k < 1 || k > INT16_MAX || band < k || band > n_faces ||
      band > kThreads * kMaxRun || interp < 2 || n_bones > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(band, k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slice_stack_kernel<kTimed>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_planes, n_bones);
  slice_stack_kernel<kTimed><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      fvt, reinterpret_cast<const int4*>(ids),
      reinterpret_cast<const float2*>(z_mm), z_key, cummax_z_max, zs,
      reinterpret_cast<float2*>(contours), reinterpret_cast<float2*>(centroids),
      areas, total_areas, overflow, open_edges, stamps, walk_out, n_out,
      n_faces, band, k, interp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long slice_stack_smem_bytes(int band, int k) {
  return static_cast<long long>(smem_bytes(band, k));
}

// Blocks of the (untimed) kernel that one SM of device `device` holds at
// once for this band and k, by the runtime's occupancy calculator; a
// negative value is minus the CUDA error.
int slice_stack_blocks_per_sm(int band, int k, int device) {
  cudaError_t err = cudaSetDevice(device);
  const size_t smem = smem_bytes(band, k);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slice_stack_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, slice_stack_kernel<false>, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches one block per (plane, bone), n_planes x n_bones, on `stream`
// (a cudaStream_t) of device `device` and returns cudaGetLastError() of
// the launch: 0 when it was accepted.  Arguments the kernel cannot index
// safely return cudaErrorInvalidValue and launch nothing.
int slice_stack_launch(const float* fvt, const int32_t* ids, const float* z_mm,
                       const float* z_key, const float* cummax_z_max,
                       const float* zs, float* contours, float* centroids,
                       float* areas, float* total_areas, uint8_t* overflow,
                       uint8_t* open_edges, int n_faces, int n_bones,
                       int n_planes, int band, int k, int interp, int device,
                       void* stream) {
  return launch<false>(fvt, ids, z_mm, z_key, cummax_z_max, zs, contours,
                       centroids, areas, total_areas, overflow, open_edges,
                       nullptr, nullptr, nullptr, n_faces, n_bones, n_planes,
                       band, k, interp, device, stream);
}

// The same launch of the timed build, for measurement only; the main path
// never calls it.  Where `stamps` is not null it writes kStamps int64 per
// block there (B·S x 12, row bone * S + plane: clock64 at the start and
// after each stage, then %globaltimer at the start and the end); where
// `walk_out` is not null, each block's walk into its row of walk_out
// (B·S x k int32: the face at each walk position, +k at a loop's head, -1
// at and past n) and n into n_out (B·S int32).
int slice_stack_launch_timed(
    const float* fvt, const int32_t* ids, const float* z_mm,
    const float* z_key, const float* cummax_z_max, const float* zs,
    float* contours, float* centroids, float* areas, float* total_areas,
    uint8_t* overflow, uint8_t* open_edges, long long* stamps,
    int32_t* walk_out, int32_t* n_out, int n_faces, int n_bones,
    int n_planes, int band, int k, int interp, int device, void* stream) {
  return launch<true>(fvt, ids, z_mm, z_key, cummax_z_max, zs, contours,
                      centroids, areas, total_areas, overflow, open_edges,
                      stamps, walk_out, n_out, n_faces, n_bones, n_planes,
                      band, k, interp, device, stream);
}

}  // extern "C"
