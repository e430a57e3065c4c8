#!/usr/bin/env bash
# Profile the batch of another checkout and of this one in turns on one
# card, so that the two are compared within one machine and one call:
#
#   bash tools/ab_profile_torch.sh OTHER_CHECKOUT OUT_DIR [ROUNDS]
#
# OTHER_CHECKOUT is a directory holding an older tree with its own
# tools/profile_torch_batch.py (for example `git archive <commit>` unpacked
# into a directory that .gitignore lists).  Each round runs
# other, this, this, other; ROUNDS defaults to 2.  Each run's full output
# goes to OUT_DIR/ab_<i>_<side>.log; the script prints each run's
# batch times, profiled wall, busy and idle share, launch counts and the
# slicing stages (or, from a tree with the port's spans, the landmark
# stages), then the pooled median and quartiles of the unprofiled
# batch times of each side.
set -euo pipefail
other=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
rounds=${3:-2}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for _ in $(seq "$rounds"); do
  for side in other this this other; do
    i=$((i + 1))
    dir=$here
    if [ "$side" = other ]; then dir=$other; fi
    log=$out/ab_${i}_${side}.log
    (cd "$dir" && python3 tools/profile_torch_batch.py) > "$log" 2>&1 \
      || { tail -30 "$log"; exit 1; }
    echo "== run $i: $side"
    grep -E "unprofiled|profiled batch|host waits|device ops|kernel launches per|^  (slice_stack_kernel|_compact_slice|_post_walk|chain_walk_marked|landmarks\.[a-z_]+) " "$log"
  done
done
python3 - "$out" <<'EOF'
import glob, re, statistics, sys
for side in ("other", "this"):
    xs = []
    for f in glob.glob(f"{sys.argv[1]}/ab_*_{side}.log"):
        line = re.search(r"unprofiled batch ms: (.*)", open(f).read()).group(1)
        xs += [float(x) for x in line.split(",")]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    print(f"{side}: {len(xs)} batches, median {med:.1f} ms, "
          f"quartiles {q1:.1f} / {q3:.1f} ms")
EOF
nvidia-smi --query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu --format=csv,noheader
