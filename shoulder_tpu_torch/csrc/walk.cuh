// The contour-chain walk of one slicing plane, shared by the standalone
// walk kernel (chain_walk.cu) and the fused slice-stack kernel
// (slice_stack.cu), so the walk that chip_smoke.py holds exactly against
// its plain version is the walk the main path runs.
//
// One thread walks the row in place:
//   work[0, k)  successor of each compact face slot (a self-loop where the
//               face starts no chain); overwritten with -1 as slots are
//               visited
//   walk[0, n)  face visited at each walk position; the first position of
//               each loop carries +k (its head mark)
// Loops start in order of their smallest unvisited slot h < nc and are
// walked in successor direction until the next slot is already visited; a
// self-successor ends at once.  Successor values outside [0, k) end a loop
// like a visited slot does.  Returns n, the number of faces visited.
// Positions at or past n are left as they were.

#pragma once

#include <stdint.h>

__device__ __forceinline__ int walk_loops(int32_t* work, int32_t* walk,
                                          int nc, int k) {
  int pos = 0;
  for (int h = 0; h < nc; ++h) {
    if (work[h] < 0) continue;  // visited by an earlier loop
    int cur = h;
    int mark = k;               // the head entry of a loop
    while (cur >= 0) {
      const int nxt = work[cur];
      work[cur] = -1;
      walk[pos++] = cur + mark;
      mark = 0;
      cur = (nxt < 0 || nxt >= k || work[nxt] < 0) ? -1 : nxt;
    }
  }
  return pos;
}
