// Contour-chain walk: the Hopper kernel of the walk on its own.
//
// Replaces shoulder_tpu/ops/pallas_chain.py::_walk_kernel (the Pallas TPU
// kernel behind chain_walk / chain_walk_marked).  It computes what that
// kernel computes, not how: the serial walk becomes a closed form that
// every thread of a row's block computes at once.
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
// slot does; a slot whose own successor is negative counts as visited
// from the start (it heads no loop and ends any walk that reaches it).
// Any map is taken, chains that merge included, and slots at or past nc
// may lie on a chain but never head a loop.
//
// The closed form.  Let f(v) be v's successor where the walk may step to
// it (in [0, K), not v itself, its own successor not negative), else none.
// Slot v is visited in the loop of the smallest live slot h < nc whose
// f-sequence reaches v, at the distance from h to v's first occurrence:
// an earlier head that reached any slot on the path h -> v would reach v
// too.  So each slot's (head, distance) is the smallest packed pair
// head << 16 | distance over all heads that reach it, and the loops are
// contiguous runs of positions in head order.
//
// Pointer jumping computes it.  Round r pushes each slot's pair, its
// distance plus 2^r, to the slot 2^r steps on (integer shared atomicMin,
// so the result does not depend on order), and doubles each slot's jump;
// a slot whose chain ends sooner pushes nothing.  Pairs live in two
// buffers: a round reads one and takes the minimum into the other, its
// own slot's pair included, so one barrier ends a round.  A round that
// improves no pair leaves every pair final (a pair at distance d is the
// pair at d - 2^r moved on by 2^r), so the rounds stop there, after at
// most ceil(log2 K).  Then each loop's length (integer atomicMax of the
// distances), one scan of the lengths for the loops' offsets, one scatter
// of the walk into shared memory and one coalesced write of the row.
// Integer-only, so FMA contraction and float summation order do not touch
// it.  tests/test_torch_chain_rank.py states these rounds in PyTorch.
//
// What bounds it on this card: a row is latency, ceil(log2 nc) dependent
// rounds of shared-memory loads and atomics, and no arithmetic or
// bandwidth limit is near (the bound counts bytes).  So a row gets a
// block of 128 threads, three slots a thread at K 384, and a round is one
// block barrier.  A warp per row (four rows a block, no block barrier)
// was measured against it on an H100: 0.0187 against 0.0109 ms at 600 x
// 384, 0.0459 against 0.0480 ms at 4800 x 384, where a block per row
// needs more than two waves of the card (PERF.md, section 6).
//
// The main path does not launch this kernel: slice_stack.cu walks each
// plane inside its own block (walk.cuh's walk_ranked, the same walk where
// chains cannot merge).  It stays as the walk's standalone entry point,
// held exactly against its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 2048;  // chain_walk_max_k(): 16 K bytes per row
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no head reaches the slot

__global__ void __launch_bounds__(kThreads)
chain_walk_kernel(const int32_t* __restrict__ succ,
                  const int32_t* __restrict__ crossed,
                  int32_t* __restrict__ order,
                  uint8_t* __restrict__ is_start,
                  int32_t* __restrict__ n_out, int k) {
  extern __shared__ uint32_t smem[];
  __shared__ int wsum[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = blockIdx.x;

  // two buffers of packed (head, distance) pairs and two of jumps; after
  // the rounds the dead pair buffer holds the loops' lengths and offsets
  // and a jump buffer the walk, heads + k
  uint32_t* pair[2] = {smem, smem + k};
  int32_t* jump[2] = {reinterpret_cast<int32_t*>(smem + 2 * k),
                      reinterpret_cast<int32_t*>(smem + 3 * k)};
  const size_t base = row * k;

  // the row's successors (in jump[1] for now) and its crossed count
  int nc = 0;
  for (int c0 = 0; c0 < k; c0 += kThreads) {
    const int j = c0 + t;
    bool c = false;
    if (j < k) {
      jump[1][j] = succ[base + j];
      c = crossed[base + j] != 0;
    }
    nc += __syncthreads_count(c);
  }
  for (int v = t; v < k; v += kThreads) {
    const int s = jump[1][v];
    pair[0][v] = (s >= 0 && v < nc) ? static_cast<uint32_t>(v) << 16 : kNone;
    pair[1][v] = kNone;
    jump[0][v] = (s >= 0 && s < k && s != v && jump[1][s] >= 0) ? s : -1;
  }
  __syncthreads();

  // pointer jumping: push each pair 2^r slots on, until no pair improves
  int src = 0;
  for (int r = 0; (1 << r) < k; ++r) {
    const uint32_t* p_in = pair[src];
    uint32_t* p_out = pair[src ^ 1];
    const int32_t* j_in = jump[src];
    int32_t* j_out = jump[src ^ 1];
    bool changed = false;
    for (int v = t; v < k; v += kThreads) {
      const uint32_t b = p_in[v];
      const int j = j_in[v];
      if (b != kNone) atomicMin(&p_out[v], b);
      int jj = -1;
      if (j >= 0) {
        jj = j_in[j];
        if (b != kNone) {
          const uint32_t moved = b + (1u << r);
          changed |= moved < p_in[j];
          atomicMin(&p_out[j], moved);
        }
      }
      j_out[v] = jj;
    }
    src ^= 1;
    if (!__syncthreads_or(changed)) break;  // also the round's barrier
  }

  // loop lengths at their heads, then their offsets in place
  const uint32_t* fin = pair[src];
  int32_t* len = reinterpret_cast<int32_t*>(pair[src ^ 1]);
  for (int h = t; h < nc; h += kThreads) len[h] = 0;
  __syncthreads();
  for (int v = t; v < k; v += kThreads) {
    const uint32_t b = fin[v];
    if (b != kNone) atomicMax(&len[b >> 16], static_cast<int>(b & 0xffffu) + 1);
  }
  __syncthreads();
  // each thread a run of consecutive heads; one block scan of the runs
  const int per = (nc + kThreads - 1) / kThreads;
  const int h0 = min(t * per, nc), h1 = min(h0 + per, nc);
  int run = 0;
  for (int h = h0; h < h1; ++h) run += len[h];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = incl - run, n = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += wsum[w];
    n += wsum[w];
  }
  for (int h = h0; h < h1; ++h) {
    const int l = len[h];
    len[h] = before;
    before += l;
  }
  __syncthreads();

  // the walk, heads + k, then the row written out in order
  int32_t* walk = jump[0];
  for (int v = t; v < k; v += kThreads) {
    const uint32_t b = fin[v];
    if (b != kNone) {
      const int d = static_cast<int>(b & 0xffffu);
      walk[len[b >> 16] + d] = v + (d == 0 ? k : 0);
    }
  }
  __syncthreads();
  for (int p = t; p < k; p += kThreads) {
    const int w = p < n ? walk[p] : 0;
    order[base + p] = w >= k ? w - k : w;
    is_start[base + p] = w >= k ? 1 : 0;
  }
  if (t == 0) n_out[row] = n;
}

}  // namespace

extern "C" {

// Largest row width the kernel takes: heads and distances stay within
// 16 bits, and a row's 16 K bytes within the default 48 KB of shared
// memory.
int chain_walk_max_k() { return kMaxK; }

// Launches the walk, one block per row, on `stream` (a cudaStream_t) of
// device `device` and returns cudaGetLastError() of the launch: 0 when it
// was accepted.
int chain_walk_launch(const int32_t* succ, const int32_t* crossed,
                      int32_t* order, uint8_t* is_start, int32_t* n_out,
                      int rows, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  chain_walk_kernel<<<rows, kThreads, static_cast<size_t>(4) * k * 4,
                      static_cast<cudaStream_t>(stream)>>>(
      succ, crossed, order, is_start, n_out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
