// Surgical-neck raw loop: the ordered, unresampled section of one plane per
// bone, one thread block per bone, one launch per batch.
//
// It replaces, on the card, ops/slicing.py's slice_raw_banded_plain, which
// is this kernel's plain version: the window search (_window_starts), the
// compaction of crossed faces and their oriented segments
// (_compact_slice), the min-index loop labels (_label_loops), the
// per-label sums (_loop_stats), the pick of one loop, its member with the
// smallest original face id, and the loop's order by pointer-jumping ranks
// (_order_loop).  In the JAX package that is XLA code
// (shoulder_tpu/ops/slicing.py:937-983, slice_raw_banded), not a Pallas
// kernel.  Stages 1-4 are slice_stack.cu's stages 1-4, copied so that the
// fused kernel's register budget stays as ptxas gives it.
//
// Contract, for B bones of F faces each (SortedGeom stacked on a leading
// bone dim) and one plane z per bone: window `band` (<= F), `k` compact
// slots (<= band), `max_chain` output points, `select` 0 = largest, 1 =
// central.
//   in   fvt (B, F, 9) f32, ids (B, F, 4) i32, z_mm (B, F, 2) f32,
//        z_key (B, F) f32, cummax_z_max (B, F) f32, z (B,) f32
//   out  points (B, max_chain, 2) f32, n (B,) i64, area (B,) f32,
//        centroid (B, 2) f32, overflow (B,) u8 (window overflow, or more
//        than k faces crossed)
// Block b reads only bone b's faces and writes only row b, and nothing in
// it depends on the order in which threads or blocks run (no float
// atomics), so a batched launch equals the bones' own launches bit for bit.
//
// The plain version's rounds are followed literally, because the chains
// that an overflow or an open edge cuts give ranks that run past the
// loop's count and wrap (the JAX package's scatter, mode "drop"): a list
// ranking of the loop alone would place those points elsewhere.
//   5. labels: lab = crossed ? slot : k, ptr = succ; _iters_for(k) rounds
//      of lab = min(lab, crossed ? lab[ptr] : lab), ptr = ptr[ptr], on
//      integers in two shared buffers each (one barrier a round);
//   6. per-label sums in a fixed order: a stable counting sort of the
//      crossed slots by label (integer atomicAdd counts, one block scan
//      for the offsets, then one warp places 32 slots at a time in slot
//      order with __match_any_sync), then a segmented block scan over the
//      sorted slots (warp shuffles, the warps' carries in warp order);
//      a segment's last slot holds its label's sums;
//   7. pick: largest = the first label of the largest area over every
//      label below k (an empty label's area is 0); central = the first
//      label of the smallest |mean x| + |mean y| over labels of at least 3
//      faces, label 0 where there is none (the plain argmin over +inf);
//   8. the loop's smallest original face id (integer atomicMin) marks its
//      start faces;
//   9. ranks: ptr = start ? slot : succ, rnk = start ? 0 : 1;
//      _iters_for(k) rounds of rnk += rnk[ptr], ptr = ptr[ptr]; a member's
//      position is 0 at a start face, else n - rnk, wrapped once by
//      +max_chain where negative and dropped outside [0, max_chain); where
//      positions collide the largest slot wins (the plain version's
//      scatter_reduce amax); every other point is 0.
//
// What bounds it on this card.  The bytes are few (the z window, k
// gathered face rows, max_chain x 8 B out per bone) and a batch is B
// blocks, 8 on the main path: the launch is latency, a chain of short
// stages each ending in a barrier, about 2 log2 k + 20 of them.  The design
// keeps everything between the stages in shared memory and gives every
// stage to the whole block; the only serial stretch is the placement of
// the counting sort, k / 32 steps of one warp.
//
// Numerics.  Built with -fmad=false (ops/kernels.py).  Points are the
// segment starts, computed by the plain version's elementwise expressions,
// so they come out bit for bit.  The per-label sums run in another order
// than the plain version's masked reductions, so area, centroid and the
// central pick's mean points agree to rounding; a near-tie between two
// loops' scores could pick another loop (chip_smoke.py counts such planes).
//
// Shared memory per block: 60 k + 4 max_chain + 2 band + 4 bytes dynamic,
// 43,012 B at k 512 / band 2048 / max_chain 2048, 77,828 B at the CT sizes
// (k 1024, band 6144, max_chain 1024); above 48 KB the launch opts in.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSearchKeys = 8;  // slice_stack.cu's window search
constexpr int kMaxRun = 64;     // slice_stack.cu's compaction runs
constexpr int kSums = 5;        // per label: cross, x cross, y cross, x, y

size_t smem_bytes(int band, int k, int max_chain) {
  const size_t kk = static_cast<size_t>(k);
  return sizeof(float2) * 2 * kk                 // st, en
         + sizeof(float) * 3 * kk                // per-label area, cx, cy
         + sizeof(int32_t) * (8 * kk + 1)        // pos / sorted, orig, work,
                                                 // cnt (k + 1), lab x2, ptr x2
         + sizeof(int32_t) * static_cast<size_t>(max_chain)  // owner
         + sizeof(int16_t) * static_cast<size_t>(band);      // inverse map
}

struct Smem {
  float2* st;       // [k] segment start per slot
  float2* en;       // [k] segment end per slot
  float* l_area;    // [k] per label: sum of cross terms
  float* l_cx;      // [k]   (x_s + x_e) * cross
  float* l_cy;      // [k]   (y_s + y_e) * cross
  int32_t* pos;     // [k] window position per slot; then the sorted slots
  int32_t* orig;    // [k] original face id per slot
  int32_t* work;    // [k] successor slot (self where none)
  int32_t* cnt;     // [k + 1] smallest predecessor (stage 4); then the
                    //     count of each label
  int32_t* lab[2];  // [k] labels, two buffers; then ranks
  int32_t* ptr[2];  // [k] pointers, two buffers; then label offsets
  int32_t* owner;   // [max_chain] slot placed at each output position
  int16_t* inv;     // [band] window position -> slot, -1 for none
};

__device__ Smem carve(unsigned char* p, int k, int max_chain) {
  Smem s;
  s.st = reinterpret_cast<float2*>(p);       p += sizeof(float2) * k;
  s.en = reinterpret_cast<float2*>(p);       p += sizeof(float2) * k;
  s.l_area = reinterpret_cast<float*>(p);    p += sizeof(float) * k;
  s.l_cx = reinterpret_cast<float*>(p);      p += sizeof(float) * k;
  s.l_cy = reinterpret_cast<float*>(p);      p += sizeof(float) * k;
  s.pos = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * k;
  s.orig = reinterpret_cast<int32_t*>(p);    p += sizeof(int32_t) * k;
  s.work = reinterpret_cast<int32_t*>(p);    p += sizeof(int32_t) * k;
  s.cnt = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * (k + 1);
  for (int i = 0; i < 2; ++i) {
    s.lab[i] = reinterpret_cast<int32_t*>(p);  p += sizeof(int32_t) * k;
    s.ptr[i] = reinterpret_cast<int32_t*>(p);  p += sizeof(int32_t) * k;
  }
  s.owner = reinterpret_cast<int32_t*>(p);   p += sizeof(int32_t) * max_chain;
  s.inv = reinterpret_cast<int16_t*>(p);
  return s;
}

// The plain version's _iters_for(k): max(1, ceil(log2(max(k, 2)))).
__host__ __device__ int iters_for(int k) {
  int r = 0;
  while ((1 << r) < (k < 2 ? 2 : k)) ++r;
  return r < 1 ? 1 : r;
}

// Block-wide (value, index) argmax: the largest value, the smallest index
// among equal values (slice_stack.cu's).  Every thread gets the result.
__device__ void block_argmax(float& val, int& idx, float* wval, int* widx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, val, o);
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

// Inclusive segmented sums of kSums values per thread over the block, in
// thread order after `carry` (the running sums of the segment open at the
// end of the previous chunk): `head` starts a new segment.  Lanes combine
// by Hillis-Steele shuffles, then each thread folds in the carry and the
// warps before its own, in warp order, so the order of every sum is fixed.
// Updates carry to the chunk's end.  All threads must call it.
__device__ void block_seg_scan(float (&v)[kSums], bool head,
                               float (&carry)[kSums],
                               float (*wsum)[kWarps], int* whead) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = head;
  for (int o = 1; o < 32; o <<= 1) {
    const int up_f = __shfl_up_sync(kFull, f, o);
    for (int c = 0; c < kSums; ++c) {
      const float up = __shfl_up_sync(kFull, v[c], o);
      if (lane >= o && !f) v[c] = up + v[c];
    }
    if (lane >= o) f |= up_f;
  }
  if (lane == 31) {
    for (int c = 0; c < kSums; ++c) wsum[c][warp] = v[c];
    whead[warp] = f;
  }
  __syncthreads();
  float run[kSums];
  for (int c = 0; c < kSums; ++c) run[c] = carry[c];
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp && !f) {
      for (int c = 0; c < kSums; ++c) v[c] = run[c] + v[c];
    }
    for (int c = 0; c < kSums; ++c) {
      run[c] = whead[w] ? wsum[c][w] : run[c] + wsum[c][w];
    }
  }
  for (int c = 0; c < kSums; ++c) carry[c] = run[c];
  __syncthreads();
}

// Exclusive prefix sums of cnt[0, n) into out[0, n), in place allowed;
// each thread takes a run of consecutive entries.  Returns the total in
// every thread.  All threads must call it.
__device__ int block_exclusive_scan(const int32_t* cnt, int32_t* out, int n,
                                    int* wint) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  int run = 0;
  for (int i = i0; i < i1; ++i) run += cnt[i];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) wint[warp] = incl;
  __syncthreads();
  int before = incl - run, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wint[w];
    total += wint[w];
  }
  for (int i = i0; i < i1; ++i) {
    const int c = cnt[i];
    out[i] = before;
    before += c;
  }
  __syncthreads();
  return total;
}

// Point where edge v -> v+1 of a face meets the plane (slice_stack.cu's).
__device__ __forceinline__ float2 edge_point(const float* gx, const float* gy,
                                             const float* d, int v) {
  const int w = v == 2 ? 0 : v + 1;
  float den = d[v] - d[w];
  if (fabsf(den) < 1e-30f) den = 1.0f;
  const float t = d[v] / den;
  return make_float2(gx[v] + t * (gx[w] - gx[v]), gy[v] + t * (gy[w] - gy[v]));
}

__global__ void __launch_bounds__(kThreads)
slice_raw_kernel(const float* __restrict__ fvt, const int4* __restrict__ ids,
                 const float2* __restrict__ z_mm,
                 const float* __restrict__ z_key,
                 const float* __restrict__ cummax_z_max,
                 const float* __restrict__ zs, float2* __restrict__ points,
                 long long* __restrict__ n_out, float* __restrict__ area_out,
                 float2* __restrict__ centroid_out,
                 uint8_t* __restrict__ overflow, int n_faces, int band, int k,
                 int max_chain, int central) {
  const size_t bone = blockIdx.x;
  const size_t face0 = bone * static_cast<size_t>(n_faces);
  fvt += face0 * 9;
  ids += face0;
  z_mm += face0;
  z_key += face0;
  cummax_z_max += face0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wsum[kSums][kWarps];
  __shared__ int wint[kWarps];
  __shared__ float wval[kWarps];
  __shared__ int widx[kWarps];
  __shared__ int s_min_orig;

  const Smem sm = carve(smem_raw, k, max_chain);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float z = zs[bone];

  // ---- 1. window (slice_stack.cu stage 1): slots [lo, lo + band) end at
  // the insertion point of z in z_key, the count of keys below z
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
  for (int j = tid; j <= k; j += kThreads) sm.cnt[j] = k;  // fpred
  for (int p = tid; p < max_chain; p += kThreads) sm.owner[p] = -1;
  if (tid == 0) s_min_orig = INT_MAX;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) a0 += widx[w];
  const int lo = max(0, min(a0 - band, n_faces - band));
  const float below_max = tid == 0 && lo > 0 ? cummax_z_max[lo - 1] : 0.0f;

  // ---- 2. crossing test and stable compaction (slice_stack.cu stage 2)
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
  int slot = 0, ncross = 0;
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
  const int nvalid = min(ncross, k);
  const bool over = ncross > k;
  const bool win_over = lo > 0 && below_max >= z;  // thread 0's is read

  // ---- 3. segments of the compact slots and their successor slots
  // (slice_stack.cu stage 3); a crossed slot's label starts as itself
  int32_t* lab = sm.lab[0];
  for (int j = tid; j < k; j += kThreads) {
    int succ = -1;  // linked successor slot
    bool crossed = false;
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
      crossed = changes == 2;
      if (crossed && si >= 0) succ = si;
    }
    sm.work[j] = succ;
    lab[j] = crossed ? j : k;
  }
  __syncthreads();

  // ---- 4. injectivity: the smallest-slot predecessor keeps its successor
  for (int j = tid; j < k; j += kThreads) {
    const int t = sm.work[j];
    if (t >= 0) atomicMin(&sm.cnt[t], j);
  }
  __syncthreads();
  int32_t* ptr = sm.ptr[0];
  for (int j = tid; j < k; j += kThreads) {
    const int t = sm.work[j];
    const int s = (t >= 0 && sm.cnt[t] == j) ? t : j;
    sm.work[j] = s;
    ptr[j] = s;
  }
  __syncthreads();

  // ---- 5. min-index labels by pointer doubling (_label_loops), exactly
  // _iters_for(k) rounds; a slot is crossed iff its label is below k
  const int rounds = iters_for(k);
  int32_t* lab_n = sm.lab[1];
  int32_t* ptr_n = sm.ptr[1];
  for (int r = 0; r < rounds; ++r) {
    for (int j = tid; j < k; j += kThreads) {
      const int l = lab[j], p = ptr[j];
      lab_n[j] = l < k ? min(l, lab[p]) : l;
      ptr_n[j] = ptr[p];
    }
    __syncthreads();
    int32_t* t = lab; lab = lab_n; lab_n = t;
    t = ptr; ptr = ptr_n; ptr_n = t;
  }

  // ---- 6. per-label sums in a fixed order.  Counting sort of the crossed
  // slots by label, stable: counts, offsets (into the dead ptr buffer),
  // then warp 0 places 32 slots at a time in slot order
  for (int j = tid; j <= k; j += kThreads) sm.cnt[j] = 0;
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    if (lab[j] < k) atomicAdd(&sm.cnt[lab[j]], 1);
  }
  __syncthreads();
  int32_t* off = ptr;
  const int m = block_exclusive_scan(sm.cnt, off, k, wint);
  int32_t* sorted = sm.pos;
  if (warp == 0) {
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int j = c0 + lane;
      const int l = j < k ? lab[j] : k;
      const unsigned peers = __match_any_sync(kFull, l);
      const int base = l < k ? off[l] : 0;
      __syncwarp();
      if (l < k) {
        sorted[base + __popc(peers & ((1u << lane) - 1u))] = j;
        if ((peers & ((1u << lane) - 1u)) == 0) off[l] = base + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // segmented scan over the sorted slots; each segment's last slot holds
  // its label's sums, and its candidate for the pick
  float carry[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cand = -INFINITY;
  int cand_at = INT_MAX;
  for (int r0 = 0; r0 < m; r0 += kThreads) {
    const int p = r0 + tid;
    float v[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool head = false;
    int l = k;
    if (p < m) {
      const int j = sorted[p];
      l = lab[j];
      head = p == 0 || lab[sorted[p - 1]] != l;
      const float2 s = sm.st[j], e = sm.en[j];
      const float cr2 = s.x * e.y - e.x * s.y;
      v[0] = cr2;
      v[1] = (s.x + e.x) * cr2;
      v[2] = (s.y + e.y) * cr2;
      v[3] = s.x;
      v[4] = s.y;
    }
    block_seg_scan(v, head, carry, wsum, wint);
    if (p < m && (p == m - 1 || lab[sorted[p + 1]] != l)) {
      const float area = 0.5f * v[0];
      sm.l_area[l] = v[0];
      sm.l_cx[l] = v[1];
      sm.l_cy[l] = v[2];
      const int count = sm.cnt[l];
      float score;
      if (central) {
        const float cf = static_cast<float>(max(count, 1));
        score = count >= 3 ? -(fabsf(v[3] / cf) + fabsf(v[4] / cf))
                           : -INFINITY;
      } else {
        score = area;
      }
      if ((!central || count >= 3) &&
          (cand_at == INT_MAX || score > cand || (score == cand && l < cand_at))) {
        cand = score;
        cand_at = l;
      }
    }
  }

  // ---- 7. pick: largest also weighs the empty labels (area 0), the
  // first of them the smallest
  if (!central) {
    for (int l = tid; l < k; l += kThreads) {
      if (sm.cnt[l] == 0 &&
          (cand_at == INT_MAX || 0.0f > cand || (0.0f == cand && l < cand_at))) {
        cand = 0.0f;
        cand_at = l;
      }
    }
  }
  block_argmax(cand, cand_at, wval, widx);
  const int best = cand_at == INT_MAX ? 0 : cand_at;
  const int n_best = sm.cnt[best];

  // ---- 8. the loop's smallest original face id
  for (int j = tid; j < k; j += kThreads) {
    if (lab[j] == best) atomicMin(&s_min_orig, sm.orig[j]);
  }
  __syncthreads();
  const int min_orig = s_min_orig;

  // ---- 9. pointer-jumping ranks (_order_loop), exactly _iters_for(k)
  // rounds, in the dead label buffer and the two pointer buffers
  int32_t* rnk = lab_n;
  int32_t* rnk_n = sorted;  // off (ptr) and sorted are dead
  for (int j = tid; j < k; j += kThreads) {
    const bool rep = lab[j] == best && sm.orig[j] == min_orig;
    ptr[j] = rep ? j : sm.work[j];
    rnk[j] = rep ? 0 : 1;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int j = tid; j < k; j += kThreads) {
      const int p = ptr[j];
      rnk_n[j] = rnk[j] + rnk[p];
      ptr_n[j] = ptr[p];
    }
    __syncthreads();
    int32_t* t = rnk; rnk = rnk_n; rnk_n = t;
    t = ptr; ptr = ptr_n; ptr_n = t;
  }
  for (int j = tid; j < k; j += kThreads) {
    if (lab[j] != best) continue;
    const bool rep = sm.orig[j] == min_orig;
    int q = rep ? 0 : n_best - rnk[j];
    if (q < 0) q += max_chain;
    if (q >= 0 && q < max_chain) atomicMax(&sm.owner[q], j);
  }
  __syncthreads();

  float2* out = points + bone * static_cast<size_t>(max_chain);
  for (int p = tid; p < max_chain; p += kThreads) {
    const int o = sm.owner[p];
    out[p] = o >= 0 ? sm.st[o] : make_float2(0.0f, 0.0f);
  }
  if (tid == 0) {
    float area = 0.0f;
    float2 cen = make_float2(0.0f, 0.0f);
    if (n_best > 0) {
      area = 0.5f * sm.l_area[best];
      const float denom = fabsf(area) > 1e-12f ? 6.0f * area : 1.0f;
      cen = make_float2(sm.l_cx[best] / denom, sm.l_cy[best] / denom);
    }
    n_out[bone] = n_best;
    area_out[bone] = area;
    centroid_out[bone] = cen;
    overflow[bone] = (win_over || over) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

long long slice_raw_smem_bytes(int band, int k, int max_chain) {
  return static_cast<long long>(smem_bytes(band, k, max_chain));
}

// Launches one block per bone on `stream` (a cudaStream_t) of device
// `device` and returns cudaGetLastError() of the launch: 0 when it was
// accepted.  Arguments the kernel cannot index safely return
// cudaErrorInvalidValue and launch nothing.
int slice_raw_launch(const float* fvt, const int32_t* ids, const float* z_mm,
                     const float* z_key, const float* cummax_z_max,
                     const float* zs, float* points, long long* n,
                     float* area, float* centroid, uint8_t* overflow,
                     int n_faces, int n_bones, int band, int k, int max_chain,
                     int central, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bones <= 0) return 0;
  if (k < 1 || k > INT16_MAX || band < k || band > n_faces ||
      band > kThreads * kMaxRun || max_chain < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(band, k, max_chain);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slice_raw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slice_raw_kernel<<<n_bones, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      fvt, reinterpret_cast<const int4*>(ids),
      reinterpret_cast<const float2*>(z_mm), z_key, cummax_z_max, zs,
      reinterpret_cast<float2*>(points), n, area,
      reinterpret_cast<float2*>(centroid), overflow, n_faces, band, k,
      max_chain, central);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
