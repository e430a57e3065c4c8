"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's),
and the reference imports nothing of the port either."""

import ast
import subprocess
import sys

from benchmark.harness import main as M
from benchmark.harness import spec as S

FORBIDDEN_REF = {"jax", "jaxlib", "flax", "shoulder_tpu", "shoulder_tpu_torch"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "shoulder_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "shoulder_tpu_torch_fake" not in M.forbidden_modules()
    monkeypatch.setitem(sys.modules, "shoulder_tpu.fake", object())
    assert "shoulder_tpu.fake" in M.forbidden_modules()


def test_sources_import_no_jax():
    for path in (S.BENCH).rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in M.FORBIDDEN, (path, name)
            if "reference" in path.parts or "inputs" in path.parts \
                    or "work" in path.parts:
                assert top not in FORBIDDEN_REF, (path, name)


def test_loaded_modules_in_a_fresh_process():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.reference import runner, ingest_worker\n"
        "from benchmark.inputs import draw\n"
        "from benchmark.harness import compare, answers\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & %r)\n"
        "assert not bad, bad\n"
        "from benchmark.harness import programs, trace, main\n"
        "from benchmark.loops import batch, cohort, facade\n"
        "assert not main.forbidden_modules(), main.forbidden_modules()\n"
    ) % (str(S.ROOT), FORBIDDEN_REF)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
