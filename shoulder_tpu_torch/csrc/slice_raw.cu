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
// kernel.
//
// Contract, for B bones of F faces each (SortedGeom stacked on a leading
// bone dim) and one plane z per bone: window `band` (<= F), `k` compact
// slots (<= band, <= 2048), `max_chain` output points, `select` 0 =
// largest, 1 = central.
//   in   fvt (B, F, 9) f32, ids (B, F, 4) i32, z_mm (B, F, 2) f32,
//        z_key (B, F) f32, cummax_z_max (B, F) f32, z (B,) f32
//   out  points (B, max_chain, 2) f32, n (B,) i64, area (B,) f32,
//        centroid (B, 2) f32, overflow (B,) u8 (window overflow, or more
//        than k faces crossed)
// Block b reads only bone b's faces and writes only row b, and nothing in
// it depends on the order in which threads or blocks run (no float
// atomics; the per-label sums are exact integer sums), so a batched launch
// equals the bones' own launches bit for bit.
//
// The plain version's rounds are followed literally, because the chains
// that an overflow or an open edge cuts give ranks that run past the
// loop's count and wrap (the JAX package's scatter, mode "drop"): a list
// ranking of the loop alone would place those points elsewhere.
//   1. window: searchsorted of z in z_key by rounds of one key per thread
//      at a stride, each counted by one __syncthreads_count, the last one
//      over at most one key per thread;
//   2. compaction: each lane issues up to kLoadGroup z_mm loads of the
//      window before it tests any, then the warps' ballots slot the
//      crossed faces in window order (one scan of the warps' counts);
//   3. segments: one thread per slot gathers its fvt/ids row, computes the
//      entry and exit points and the successor slot through the inverse
//      map window position -> slot, and the block's largest |term| of each
//      kind the sums of 6 take (a warp max, then one integer atomicMax);
//   4. injectivity: the smallest-slot predecessor keeps each successor
//      (shared atomicMin on integers);
//   5. labels: lab = crossed ? slot : k, ptr = succ; _iters_for(k) rounds
//      of lab = min(lab, crossed ? lab[ptr] : lab), ptr = ptr[ptr]; each
//      thread keeps its slots' lab and ptr in registers and publishes them
//      as one 8-byte word into the other of two shared buffers (one
//      barrier a round);
//   6. per label, in one pass: the count, the smallest original face id,
//      and the five sums (cross, (x_s + x_e) cross, (y_s + y_e) cross,
//      x_s, y_s), each exact: a term times 2^e rounded once to an integer,
//      e chosen from the block's largest term of its kind so that any sum
//      of k terms stays within 2^39, summed as integers.  A warp's slots
//      of one label meet by __match_any_sync and reduce by
//      __reduce_add_sync / __reduce_min_sync (a term + 2^39 in two 21-bit
//      limbs), then the label's first lane adds them with 32-bit shared
//      atomics.  Integer sums do not depend on the order of the adds, so
//      the result is fixed without a sort;
//   7. pick: largest = the first label of the largest area over every
//      label below k (an empty label's area is 0); central = the first
//      label of the smallest |mean x| + |mean y| over labels of at least 3
//      faces, label 0 where there is none (the plain argmin over +inf);
//      a block argmax of two warp reductions a level;
//   8. the picked label's smallest original face id marks its start faces;
//      its area and centroid are its sums of 6;
//   9. ranks: ptr = start ? slot : succ, rnk = start ? 0 : 1;
//      _iters_for(k) rounds of rnk += rnk[ptr], ptr = ptr[ptr], (rnk, ptr)
//      words as in 5; a member's position is 0 at a start face, else
//      n - rnk, wrapped once by +max_chain where negative and dropped
//      outside [0, max_chain); where positions collide the largest slot
//      wins (the plain version's scatter_reduce amax); every other point
//      is 0.
//
// What bounds it on this card.  The bytes are few (the z window, k
// gathered face rows, max_chain x 8 B out per bone) and a batch is B
// blocks, 8 on the main path: the launch is latency.  The timed build
// (slice_raw_launch_timed, ops/slicing.py RAW_STAGES) showed where the
// first design's 12.8 us block went on an H100 (k 512): z_mm loads that
// waited for each other in the compaction, 2-4 trips of 256 threads in
// every round of labels, segments and ranks, and a counting sort placed by
// one warp with its segmented scan (3.2 us).  So this design gives each
// slot its own thread (512 threads for k <= 512, 1024 above, two slots per
// thread above 1024), issues a lane's window loads together, keeps each
// slot's round state in registers, and replaces the sort, the scan and the
// pass over the picked loop by one pass of exact integer sums per label.
// Tried and not kept (PERF.md, section 6): 64-bit shared atomics for the
// sums (compare-and-swap loops that the warps queue on, 1.2 us a pass), the
// window staged by cp.async behind the search's last count (the stage is
// issue-bound, not load-bound: 0.15 us slower), and 256 threads of two
// slots at k 512 (12 % slower).  At k 512 the block takes 7.2 us against
// the first design's 12.8 (H100, 700 W): window 1.1, compaction 1.0,
// labels 1.0, counts 1.0, segments 0.85, ranks 0.83, pick 0.66.  What is
// left is a chain of dependent global round trips (2 window rounds, the
// window, the face rows) and about 2 log2 k + 8 block barriers, each met
// by 16 or 32 warps, whose instructions the SM's four schedulers issue
// in turn.
//
// Numerics.  Built with -fmad=false (ops/kernels.py).  Points are the
// segment starts, computed by the plain version's elementwise expressions,
// so they come out bit for bit.  Each per-label sum is the exact sum of
// its terms rounded to multiples of 2^-e, then rounded once to float:
// area, centroid and the central pick's mean points agree with the plain
// version's float sums to rounding; a near-tie between two loops' scores
// could pick another loop (chip_smoke.py counts such planes).
//
// Shared memory per block: 84 k + 4 max_chain + 2 band + 4 bytes dynamic,
// 55,300 B at k 512 / band 2048 / max_chain 2048, 102,404 B at the CT
// sizes (k 1024, band 6144, max_chain 1024); above 48 KB the launch opts
// in, once per device and kernel for the largest size it has met.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRun = 64;     // window positions a lane tests: bits of a u64
constexpr int kLoadGroup = 8;   // z_mm loads a lane issues before testing any
constexpr int kMaxSlots = 2;    // slots per thread: k <= 2 * threads
constexpr int kMaxDevices = 64;
constexpr int kKinds = 5;       // per-label sums: cross, x cross, y cross, x, y
constexpr int kFixedBits = 39;  // a label's fixed-point sum stays within 2^39
// The timed build records, per block, clock64() at the start and after
// each of the 11 stages (ops/slicing.py RAW_STAGES: the nine above, the
// sixth in its two halves, counts and sums, and the output write), then
// %globaltimer (ns) at the start and the end, so that cycles convert to
// time.
constexpr int kStages = 11;
constexpr int kStamps = kStages + 3;

// The block for k slots: a thread per slot up to kNarrowK, else 1024
// threads of up to kMaxSlots.
constexpr int kNarrowK = 512;
__host__ __device__ constexpr int slots_for(int threads) {
  return threads > kNarrowK ? kMaxSlots : 1;
}

size_t smem_bytes(int band, int k, int max_chain) {
  const size_t kk = static_cast<size_t>(k);
  return sizeof(float2) * 2 * kk                  // st, en
         + sizeof(uint32_t) * 2 * kKinds * kk     // acc
         + sizeof(int32_t) * 6 * kk               // pair x2, pos, morig
         + sizeof(int32_t) * (kk + 1)             // cnt
         + sizeof(int32_t) * static_cast<size_t>(max_chain)  // owner
         + sizeof(int16_t) * static_cast<size_t>(band);      // inverse map
}

struct Smem {
  float2* st;       // [k] segment start per slot
  float2* en;       // [k] segment end per slot
  uint32_t* acc;    // [kKinds][2][k] per label and kind: the two limbs'
                    //     sums of its fixed-point terms + 2^39
  int32_t* pos;     // [k] window position per slot (stages 2-3)
  int2* pair[2];    // [k] (label, pointer) per slot, two buffers; then
                    //     (rank, pointer)
  int32_t* morig;   // [k] smallest original face id per label
  int32_t* cnt;     // [k + 1] smallest predecessor (stage 4); then the
                    //     count of each label
  int32_t* owner;   // [max_chain] slot placed at each output position
  int16_t* inv;     // [band] window position -> slot, -1 for none
};

__device__ Smem carve(unsigned char* p, int k, int max_chain) {
  Smem s;
  s.st = reinterpret_cast<float2*>(p);       p += sizeof(float2) * k;
  s.en = reinterpret_cast<float2*>(p);       p += sizeof(float2) * k;
  s.acc = reinterpret_cast<uint32_t*>(p);
  p += sizeof(uint32_t) * 2 * kKinds * k;
  for (int i = 0; i < 2; ++i) {
    s.pair[i] = reinterpret_cast<int2*>(p);    p += sizeof(int2) * k;
  }
  s.pos = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * k;
  s.morig = reinterpret_cast<int32_t*>(p);   p += sizeof(int32_t) * k;
  s.cnt = reinterpret_cast<int32_t*>(p);     p += sizeof(int32_t) * (k + 1);
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

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// Fixed-point exponent of sums of at most k terms whose largest magnitude
// has the float bits `max_bits`: every term times 2^e is within
// 2^kFixedBits / k in magnitude, so every such sum stays within
// 2^kFixedBits.
__device__ __forceinline__ int fixed_exp(unsigned max_bits, int k) {
  // frexpf's exponent from the bits: max < 2^ex; a subnormal's from its
  // mantissa's length; 0 gives 0
  const int field = static_cast<int>(max_bits >> 23);
  const int ex = field ? field - 126
                       : (max_bits ? 32 - __clz(max_bits) - 149 : 0);
  const int log2k = k < 2 ? 0 : 32 - __clz(k - 1);
  return kFixedBits - ex - log2k;
}

// 2^n as a float, n in [-126, 127].
__device__ __forceinline__ float exp2i(int n) {
  return __int_as_float((n + 127) << 23);
}

// v * 2^e (two exact power-of-two factors: e spans more than one float
// exponent), rounded once to the nearest integer, ties to even.
__device__ __forceinline__ long long to_fixed(float v, int e) {
  return __float2ll_rn(v * exp2i(e >> 1) * exp2i(e - (e >> 1)));
}

// A label's sum of kind c from its limbs and count: rounded once to float
// and scaled back by 2^-e.
__device__ __forceinline__ float label_sum(const uint32_t* acc, int c, int l,
                                           int k, int count, int e) {
  const long long s = static_cast<long long>(acc[(2 * c) * k + l]) +
                      (static_cast<long long>(acc[(2 * c + 1) * k + l]) << 21) -
                      (static_cast<long long>(count) << kFixedBits);
  return __ll2float_rn(s) * exp2i(-(e >> 1)) * exp2i((e >> 1) - e);
}

// A segment's term of kind c: cross, (x_s + x_e) cross, (y_s + y_e)
// cross, x_s, y_s (the plain version's expressions).
__device__ __forceinline__ float seg_term(float2 s, float2 e, int c) {
  const float cr2 = s.x * e.y - e.x * s.y;
  switch (c) {
    case 0: return cr2;
    case 1: return (s.x + e.x) * cr2;
    case 2: return (s.y + e.y) * cr2;
    case 3: return s.x;
    default: return s.y;
  }
}

// Block-wide argmax: the index of the largest value, the smallest index
// among equal values (-0.0 counts as 0.0).  A value becomes its
// order-preserving bits, so each level is two warp reductions; every
// thread gets the index.  One barrier.
template <int kThreads>
__device__ int block_argmax(float val, int idx, unsigned* wkey, int* widx) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __float_as_uint(val == 0.0f ? 0.0f : val);
  unsigned key = b & 0x80000000u ? ~b : b | 0x80000000u;
  unsigned top = __reduce_max_sync(kFull, key);
  int at = __reduce_min_sync(kFull, key == top ? idx : INT_MAX);
  if (lane == 0) {
    wkey[warp] = top;
    widx[warp] = at;
  }
  __syncthreads();
  key = lane < kWarps ? wkey[lane] : 0u;
  top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top && lane < kWarps ? widx[lane]
                                                              : INT_MAX);
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

template <int kThreads, bool kTimed>
__global__ void __launch_bounds__(kThreads)
slice_raw_kernel(const float* __restrict__ fvt, const int4* __restrict__ ids,
                 const float2* __restrict__ z_mm,
                 const float* __restrict__ z_key,
                 const float* __restrict__ cummax_z_max,
                 const float* __restrict__ zs, float2* __restrict__ points,
                 long long* __restrict__ n_out, float* __restrict__ area_out,
                 float2* __restrict__ centroid_out,
                 uint8_t* __restrict__ overflow,
                 long long* __restrict__ stamps, int n_faces, int band, int k,
                 int max_chain, int central) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlots = slots_for(kThreads);
  const size_t bone = blockIdx.x;
  // the timed build: a barrier, then thread 0 stamps the end of stage i
  auto stamp = [&](int i) {
    if constexpr (kTimed) {
      __syncthreads();
      if (threadIdx.x == 0 && stamps) stamps[bone * kStamps + i] = clock64();
    }
  };
  long long ns0 = 0;
  if constexpr (kTimed) ns0 = global_ns();
  stamp(0);
  const size_t face0 = bone * static_cast<size_t>(n_faces);
  fvt += face0 * 9;
  ids += face0;
  z_mm += face0;
  z_key += face0;
  cummax_z_max += face0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wint[kWarps];
  __shared__ unsigned wkey[kWarps];
  __shared__ int widx[kWarps];
  __shared__ unsigned wmax[kKinds][kWarps];  // each warp's largest |term|

  const Smem sm = carve(smem_raw, k, max_chain);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float z = zs[bone];
  // slot j = tid + s * kThreads; warp-wide steps over slots s run where
  // the warp's first slot exists
  auto warp_has = [&](int s) { return s * kThreads + (tid - lane) < k; };

  // ---- 1. window: slots [lo, lo + band) end at the insertion point of z
  // in z_key, the count of keys below z.  While more keys than threads are
  // left, each thread tests one key at a stride and the block's count of
  // keys below z narrows the range to one stride; then one key a thread.
  for (int p = tid; p < max_chain; p += kThreads) sm.owner[p] = -1;
  for (int j = tid; j <= k; j += kThreads) sm.cnt[j] = k;  // fpred
  int a0 = 0, span = n_faces;
  while (span > kThreads) {
    const int stride = (span + kThreads - 1) / kThreads;
    const int i = a0 + (tid + 1) * stride - 1;
    const int below = __syncthreads_count(i < a0 + span && z_key[i] < z);
    const int a1 = a0 + below * stride;
    span = min(stride - 1, a0 + span - a1);
    a0 = a1;
  }
  a0 += __syncthreads_count(tid < span && z_key[a0 + tid] < z);
  const int lo = max(0, min(a0 - band, n_faces - band));
  // the window overflow test's key: thread 0 loads it now and tests it
  // after stage 2, so the load's latency overlaps the compaction
  const float below_max = tid == 0 && lo > 0 ? cummax_z_max[lo - 1] : 0.0f;
  stamp(1);

  // ---- 2. crossing test and stable compaction into slots [0, min(ncross,
  // k)): each warp takes a contiguous chunk of the window, 32 positions at
  // a time (coalesced), each lane keeping its crossing bits; its loads go
  // out kLoadGroup at a time before any is tested
  const int chunk = ((band + kWarps - 1) / kWarps + 31) & ~31;
  const int iters = chunk / 32;  // <= kMaxRun: band <= kThreads * kMaxRun
  const int w0 = warp * chunk + lane;
  unsigned long long bits = 0ull;
  for (int j0 = 0; j0 < iters; j0 += kLoadGroup) {
    float2 mm[kLoadGroup];
#pragma unroll
    for (int u = 0; u < kLoadGroup; ++u) {
      const int i = w0 + (j0 + u) * 32;
      mm[u] = j0 + u < iters && i < band ? z_mm[lo + i]
                                         : make_float2(INFINITY, -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < kLoadGroup; ++u) {
      if ((mm[u].y >= z) && (mm[u].x < z)) bits |= 1ull << (j0 + u);
    }
  }
  const int warp_crossed = __reduce_add_sync(kFull, __popcll(bits));
  if (lane == 0) wint[warp] = warp_crossed;
  __syncthreads();
  // the warps' counts, scanned in each warp: my warp's first slot
  const int wc = lane < kWarps ? wint[lane] : 0;
  int incl = wc;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  int slot = __shfl_sync(kFull, incl - wc, warp);
  const int ncross = __shfl_sync(kFull, incl, 31);
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

  // ---- 3. segments of the compact slots and their successor slots; a
  // crossed slot's label starts as itself, and its label's accumulators
  // start empty (only crossed slots are labels).  Each warp's largest
  // |term| of each kind over its crossed slots (non-negative float bits
  // compare as integers) goes to wmax: the block's sets the fixed-point
  // exponents of stage 6.
  int my_lab[kSlots], my_succ[kSlots], my_orig[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = tid + s * kThreads;
    my_lab[s] = k;
    my_succ[s] = -1;  // linked successor slot
    my_orig[s] = INT_MAX;
    float2 st = make_float2(0.0f, 0.0f), en = st;
    if (j < nvalid) {
      const int f = lo + sm.pos[j];
      const float* g = fvt + static_cast<size_t>(f) * 9;
      const int4 gi = ids[f];
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
      st = edge_point(gx, gy, d, entry);
      en = edge_point(gx, gy, d, exit);
      sm.st[j] = st;
      sm.en[j] = en;
      my_orig[s] = gi.x;
      const int nbr = exit == 0 ? gi.y : (exit == 1 ? gi.z : gi.w);
      const int sw = nbr >= 0 ? nbr - lo : -1;
      const int si = (sw >= 0 && sw < band) ? sm.inv[sw] : -1;
      if (changes == 2) {
        my_lab[s] = j;
        if (si >= 0) my_succ[s] = si;
        sm.morig[j] = INT_MAX;
        for (int i = 0; i < 2 * kKinds; ++i) sm.acc[i * k + j] = 0u;
      }
    }
    if (s == 0 || warp_has(s)) {
      for (int c = 0; c < kKinds; ++c) {
        const unsigned b = my_lab[s] < k
            ? __float_as_uint(fabsf(seg_term(st, en, c))) : 0u;
        const unsigned m = __reduce_max_sync(kFull, b);
        if (lane == 0) wmax[c][warp] = s == 0 ? m : max(wmax[c][warp], m);
      }
    }
  }
  stamp(3);

  // ---- 4. injectivity: the smallest-slot predecessor keeps its successor
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (my_succ[s] >= 0) atomicMin(&sm.cnt[my_succ[s]], tid + s * kThreads);
  }
  __syncthreads();
  int2* cur = sm.pair[0];
  int2* nxt = sm.pair[1];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = tid + s * kThreads;
    const int t = my_succ[s];
    my_succ[s] = (t >= 0 && sm.cnt[t] == j) ? t : j;
    if (j < k) cur[j] = make_int2(my_lab[s], my_succ[s]);
  }
  __syncthreads();
  stamp(4);

  // ---- 5. min-index labels by pointer doubling (_label_loops), exactly
  // _iters_for(k) rounds; a slot is crossed iff its label is below k.  The
  // labels stay in registers: after this, a thread reads only its own.
  // A slot's label and pointer are one 8-byte word.
  for (int j = tid; j <= k; j += kThreads) sm.cnt[j] = 0;
  const int rounds = iters_for(k);
  int my_ptr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) my_ptr[s] = my_succ[s];
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = tid + s * kThreads;
      if (j < k) {
        const int2 at = cur[my_ptr[s]];
        if (my_lab[s] < k) my_lab[s] = min(my_lab[s], at.x);
        my_ptr[s] = at.y;
        if (r + 1 < rounds) nxt[j] = make_int2(my_lab[s], my_ptr[s]);
      }
    }
    __syncthreads();
    int2* t = cur; cur = nxt; nxt = t;
  }
  stamp(5);

  // ---- 6. per label, one pass: count, smallest original face id, and
  // the five exact sums.  The slots of one label in a warp reduce
  // together; the label's first lane adds their totals.  Every warp first
  // takes the block's largest |term| of each kind from the warps' maxima.
  int e_kind[kKinds];
  for (int c = 0; c < kKinds; ++c) {
    e_kind[c] = fixed_exp(
        __reduce_max_sync(kFull, lane < kWarps ? wmax[c][lane] : 0u), k);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (!warp_has(s)) continue;
    const int j = tid + s * kThreads;
    const int l = j < k ? my_lab[s] : k;
    const unsigned peers = __match_any_sync(kFull, l);
    const bool first = l < k && (__ffs(peers) - 1) == lane;
    const int mo = __reduce_min_sync(peers, l < k ? my_orig[s] : INT_MAX);
    if (first) {
      atomicAdd(&sm.cnt[l], __popc(peers));
      atomicMin(&sm.morig[l], mo);
    }
    float2 st = make_float2(0.0f, 0.0f), en = st;
    if (l < k) {
      st = sm.st[j];
      en = sm.en[j];
    }
    for (int c = 0; c < kKinds; ++c) {
      const long long q = l < k ? to_fixed(seg_term(st, en, c), e_kind[c])
                                : 0ll;
      // q + 2^39 lies in [0, 2^40]: two 21-bit limbs, each summed over the
      // warp's slots of the label exactly in 32 bits, and over a label's k
      // slots at most
      const unsigned long long u =
          static_cast<unsigned long long>(q + (1ll << kFixedBits));
      const unsigned lo21 =
          __reduce_add_sync(peers, static_cast<unsigned>(u & 0x1fffffu));
      const unsigned hi21 =
          __reduce_add_sync(peers, static_cast<unsigned>(u >> 21));
      if (first) {
        atomicAdd(&sm.acc[(2 * c) * k + l], lo21);
        atomicAdd(&sm.acc[(2 * c + 1) * k + l], hi21);
      }
    }
  }
  __syncthreads();
  stamp(6);
  stamp(7);  // the sums are stage 6's

  // ---- 7. pick: largest also weighs the empty labels (area 0), the
  // first of them the smallest
  // (a label without a count holds no sums: it is never read)
  float cand = -INFINITY;
  int cand_at = INT_MAX;
  for (int l = tid; l < k; l += kThreads) {
    const int count = sm.cnt[l];
    float score = 0.0f;
    bool ok = !central;
    if (central && count >= 3) {
      const float cf = static_cast<float>(count);
      ok = true;
      score = -(fabsf(label_sum(sm.acc, 3, l, k, count, e_kind[3]) / cf) +
                fabsf(label_sum(sm.acc, 4, l, k, count, e_kind[4]) / cf));
    } else if (!central && count > 0) {
      score = 0.5f * label_sum(sm.acc, 0, l, k, count, e_kind[0]);
    }
    if (ok && (cand_at == INT_MAX || score > cand ||
               (score == cand && l < cand_at))) {
      cand = score;
      cand_at = l;
    }
  }
  cand_at = block_argmax<kThreads>(cand, cand_at, wkey, widx);
  const int best = cand_at == INT_MAX ? 0 : cand_at;
  const int n_best = sm.cnt[best];
  stamp(8);

  // ---- 8. the loop's smallest original face id, area and centroid (an
  // empty label's min_orig is never compared: it has no member)
  const int min_orig = n_best > 0 ? sm.morig[best] : INT_MAX;
  if (tid == 0) {
    float area = 0.0f;
    float2 cen = make_float2(0.0f, 0.0f);
    if (n_best > 0) {
      area = 0.5f * label_sum(sm.acc, 0, best, k, n_best, e_kind[0]);
      const float denom = fabsf(area) > 1e-12f ? 6.0f * area : 1.0f;
      cen = make_float2(
          label_sum(sm.acc, 1, best, k, n_best, e_kind[1]) / denom,
          label_sum(sm.acc, 2, best, k, n_best, e_kind[2]) / denom);
    }
    n_out[bone] = n_best;
    area_out[bone] = area;
    centroid_out[bone] = cen;
    overflow[bone] = (win_over || over) ? 1 : 0;
  }
  stamp(9);

  // ---- 9. pointer-jumping ranks (_order_loop), exactly _iters_for(k)
  // rounds, (rank, pointer) words in the dead label buffers
  cur = sm.pair[0];
  nxt = sm.pair[1];
  int my_rnk[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = tid + s * kThreads;
    const bool rep = my_lab[s] == best && my_orig[s] == min_orig;
    my_ptr[s] = rep ? j : my_succ[s];
    my_rnk[s] = rep ? 0 : 1;
    if (j < k) cur[j] = make_int2(my_rnk[s], my_ptr[s]);
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = tid + s * kThreads;
      if (j < k) {
        const int2 at = cur[my_ptr[s]];
        my_rnk[s] += at.x;
        my_ptr[s] = at.y;
        if (r + 1 < rounds) nxt[j] = make_int2(my_rnk[s], my_ptr[s]);
      }
    }
    if (r + 1 < rounds) {
      __syncthreads();
      int2* t = cur; cur = nxt; nxt = t;
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = tid + s * kThreads;
    if (j >= k || my_lab[s] != best) continue;
    const bool rep = my_orig[s] == min_orig;
    int q = rep ? 0 : n_best - my_rnk[s];
    if (q < 0) q += max_chain;
    if (q >= 0 && q < max_chain) atomicMax(&sm.owner[q], j);
  }
  __syncthreads();
  stamp(10);

  float2* out = points + bone * static_cast<size_t>(max_chain);
  for (int p = tid; p < max_chain; p += kThreads) {
    const int o = sm.owner[p];
    out[p] = o >= 0 ? sm.st[o] : make_float2(0.0f, 0.0f);
  }
  if constexpr (kTimed) {
    stamp(11);
    if (tid == 0 && stamps) {
      stamps[bone * kStamps + 12] = ns0;
      stamps[bone * kStamps + 13] = global_ns();
    }
  }
}

// The largest dynamic shared memory each kernel instance has been allowed
// on each device: the attribute is set once per device and larger size,
// not at every launch.
std::mutex g_smem_mutex;
int g_smem_allowed[kMaxDevices][4];

template <int kThreads, bool kTimed>
cudaError_t allow_smem(int device, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  constexpr int instance = (kThreads == 1024 ? 2 : 0) + (kTimed ? 1 : 0);
  const bool cached = device >= 0 && device < kMaxDevices;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (cached &&
      static_cast<size_t>(g_smem_allowed[device][instance]) >= smem) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      slice_raw_kernel<kThreads, kTimed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && cached) {
    g_smem_allowed[device][instance] = static_cast<int>(smem);
  }
  return err;
}

template <int kThreads, bool kTimed>
int launch_width(const float* fvt, const int32_t* ids, const float* z_mm,
                 const float* z_key, const float* cummax_z_max,
                 const float* zs, float* points, long long* n, float* area,
                 float* centroid, uint8_t* overflow, long long* stamps,
                 int n_faces, int n_bones, int band, int k, int max_chain,
                 int central, int device, void* stream) {
  if (k > kThreads * slots_for(kThreads) || band > kThreads * kMaxRun) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(band, k, max_chain);
  const cudaError_t err = allow_smem<kThreads, kTimed>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slice_raw_kernel<kThreads, kTimed>
      <<<n_bones, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fvt, reinterpret_cast<const int4*>(ids),
      reinterpret_cast<const float2*>(z_mm), z_key, cummax_z_max, zs,
      reinterpret_cast<float2*>(points), n, area,
      reinterpret_cast<float2*>(centroid), overflow, stamps, n_faces, band, k,
      max_chain, central);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTimed>
int launch(const float* fvt, const int32_t* ids, const float* z_mm,
           const float* z_key, const float* cummax_z_max, const float* zs,
           float* points, long long* n, float* area, float* centroid,
           uint8_t* overflow, long long* stamps, int n_faces, int n_bones,
           int band, int k, int max_chain, int central, int device,
           void* stream) {
  // the current device is left alone when it is already `device`
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bones <= 0) return 0;
  if (k < 1 || k > INT16_MAX || band < k || band > n_faces ||
      max_chain < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = k <= kNarrowK ? &launch_width<kNarrowK, kTimed>
                          : &launch_width<1024, kTimed>;
  return go(fvt, ids, z_mm, z_key, cummax_z_max, zs, points, n, area,
            centroid, overflow, stamps, n_faces, n_bones, band, k, max_chain,
            central, device, stream);
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
  return launch<false>(fvt, ids, z_mm, z_key, cummax_z_max, zs, points, n,
                       area, centroid, overflow, nullptr, n_faces, n_bones,
                       band, k, max_chain, central, device, stream);
}

// The same launch of the timed build, for measurement only; the main path
// never calls it.  It writes kStamps int64 per block into `stamps` (B x 14:
// clock64 at the start and after each stage, then %globaltimer at the
// start and the end).
int slice_raw_launch_timed(const float* fvt, const int32_t* ids,
                           const float* z_mm, const float* z_key,
                           const float* cummax_z_max, const float* zs,
                           float* points, long long* n, float* area,
                           float* centroid, uint8_t* overflow,
                           long long* stamps, int n_faces, int n_bones,
                           int band, int k, int max_chain, int central,
                           int device, void* stream) {
  return launch<true>(fvt, ids, z_mm, z_key, cummax_z_max, zs, points, n,
                      area, centroid, overflow, stamps, n_faces, n_bones,
                      band, k, max_chain, central, device, stream);
}

}  // extern "C"
