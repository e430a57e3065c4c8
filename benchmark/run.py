"""The benchmark of shoulder_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON object on the last line of standard
output (benchmark/harness/main.py says what it holds); exits non-zero,
with no result, without the CUDA cards the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the caches of any compiler a run loads stay inside the checkout, at
# fixed paths, so the first run of a checkout builds and the next ones hit
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
