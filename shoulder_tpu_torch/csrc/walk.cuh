// The contour-chain walk of one slicing plane by list ranking, the whole
// thread block at once: the walk of the fused slice-stack kernel
// (slice_stack.cu), whose timed build hands it out so that chip_smoke.py
// holds it exactly against the plain walk (ops/chain_walk.py's
// chain_walk_plain).
//
// The serial walk it stands for: loops start in order of their smallest
// unvisited slot h < nc and are walked in successor direction until the
// next slot is already visited; a self-successor ends at once.  Successor
// values outside [0, k) end a loop like a visited slot does.  walk[0, n)
// holds the face visited at each walk position, the first position of
// each loop carrying +k (its head mark).
//
// The standalone walk kernel (chain_walk.cu) takes any successor map,
// chains that merge included, and computes the same walk by its own
// pointer jumping over successors.

#pragma once

#include <stdint.h>

// walk_ranked: the walk by list ranking, for a successor map whose chains
// cannot merge, as the fused kernel's injectivity stage leaves it: every
// slot has at most one predecessor other than itself.  Ignoring
// self-successors the map is then disjoint simple paths and cycles, and
// the serial walk's result has a closed form:
//   - a path x0 -> ... -> xm (x0 without predecessor, xm its own successor)
//     puts xi in the loop headed by the smallest of x0..xi below nc (a
//     prefix minimum); slots with none below nc in their prefix are not
//     visited;
//   - a cycle is one loop headed by its smallest slot below nc, or is not
//     visited when it has none;
//   - loops come in the order of their heads, each in successor order:
//     walk[offset(h) + rank(v)] = v, +k at the head (rank 0), offset(h)
//     the summed lengths of the loops with smaller heads.
// Pointer jumping over the predecessor map computes it.  Each slot v holds
// a window of the slots behind it: its far end (the slot 2^r steps back,
// or none past a path's start), its size, the smallest key in it (a slot's
// key is its own number when it is below nc, else none) and the distance
// from the nearest slot with that key to v.  A round joins each window
// with the window of its far end; on equal keys the nearer one wins.  After
// ceil(log2 nv) rounds a path slot's window is its whole prefix and a cycle
// slot's window covers its cycle, so (key, distance) is (head, rank) for
// every slot, cycles included, without cutting them.  A round is one
// barrier (the windows alternate between two buffers); the rounds end
// early once no window has a far end left.  Then each loop's last slot
// gives the loop's length, one block scan the loops' offsets, and one
// scatter the walk.  Integer-only.
//
// Contract, called by every thread of a block of kThreads:
//   succ[0, nv)   successor of each slot, in [0, nv); itself where a chain
//                 ends; every slot has at most one predecessor u != v
//   pred[0, nv)   that predecessor, or a value outside [0, nv) or v itself
//                 where there is none
//   nc <= nv <= k <= 32767 (slots, distances and window sizes take 16 bits)
//   scratch: ping, pong nv uint2 each, len nc int32, wsum kThreads / 32
// Writes walk[0, n) as the serial walk leaves it and loop_start[p], the position of
// the first slot of p's loop, for p < n; returns n in every thread.  The
// caller's barrier must precede the call; the call ends with one.
namespace walk_detail {

constexpr unsigned kNoKey = 0xffffu;

// x: far end + 1 (0 for none) | window size << 16; y: dist | key << 16
__device__ __forceinline__ uint2 window(int far, unsigned size, unsigned key,
                                        unsigned dist) {
  return make_uint2(static_cast<unsigned>(far + 1) | (size << 16),
                    dist | (key << 16));
}

}  // namespace walk_detail

template <int kThreads>
__device__ int walk_ranked(const int32_t* succ, const int32_t* pred, int nv,
                           int nc, int k, uint2* ping, uint2* pong,
                           int32_t* len, int* wsum, int32_t* walk,
                           int32_t* loop_start) {
  using walk_detail::kNoKey;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rounds = 0;  // ceil(log2 nv): every window then spans 2^rounds >= nv
  while ((1 << rounds) < nv) ++rounds;
  for (int v = tid; v < nv; v += kThreads) {
    const int p = pred[v];
    ping[v] = walk_detail::window(p >= 0 && p < nv && p != v ? p : -1, 1u,
                                  v < nc ? v : kNoKey, 0u);
  }
  for (int h = tid; h < nc; h += kThreads) len[h] = 0;
  __syncthreads();

  // pointer jumping: join each window with the one at its far end
  for (int r = 0; r < rounds; ++r) {
    int more = 0;
    for (int v = tid; v < nv; v += kThreads) {
      uint2 s = ping[v];
      const unsigned far1 = s.x & 0xffffu;
      if (far1 != 0) {
        const uint2 t = ping[far1 - 1];
        const unsigned size = s.x >> 16;
        if ((t.y >> 16) < (s.y >> 16)) {  // a smaller key, farther back
          s.y = (t.y & 0xffff0000u) | ((t.y & 0xffffu) + size);
        }
        s.x = (t.x & 0xffffu) | ((size + (t.x >> 16)) << 16);
        more |= (t.x & 0xffffu) != 0;
      }
      pong[v] = s;
    }
    uint2* tmp = ping;
    ping = pong;
    pong = tmp;
    if (!__syncthreads_or(more)) break;
  }

  // loop lengths, at each loop's last slot: the successor ends the chain
  // or heads the next loop (rank 0)
  for (int v = tid; v < nv; v += kThreads) {
    const uint2 s = ping[v];
    const unsigned key = s.y >> 16;
    if (key != kNoKey) {
      const int w = succ[v];
      if (w == v || (ping[w].y & 0xffffu) == 0) {
        len[key] = static_cast<int>(s.y & 0xffffu) + 1;
      }
    }
  }
  __syncthreads();

  // loop offsets: exclusive prefix sums of len over heads, in place; each
  // thread takes a run of consecutive heads
  const int per = (nc + kThreads - 1) / kThreads;
  const int h0 = min(tid * per, nc), h1 = min(h0 + per, nc);
  int run = 0;
  for (int h = h0; h < h1; ++h) run += len[h];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = incl - run, n = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wsum[w];
    n += wsum[w];
  }
  for (int h = h0; h < h1; ++h) {
    const int l = len[h];
    len[h] = before;
    before += l;
  }
  __syncthreads();

  for (int v = tid; v < nv; v += kThreads) {
    const uint2 s = ping[v];
    const unsigned key = s.y >> 16;
    if (key != kNoKey) {
      const int rank = static_cast<int>(s.y & 0xffffu);
      const int q = len[key] + rank;
      walk[q] = v + (rank == 0 ? k : 0);
      loop_start[q] = len[key];
    }
  }
  __syncthreads();
  return n;
}
