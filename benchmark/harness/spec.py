"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose file is
`configs/<config>.json`, and a traffic mix, `traffic/<traffic>.json`.
The mix's `loop` names its closed loop, `loops/<loop>.py`.  An end-to-end
metric is computed by `end_to_end/<name>.py`, a per-layer metric by
`metrics/<reader>.py` (see `reader_of`), a piece of work by
`work/<piece>.py`.  A later cell adds files and entries; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as fh:
        return json.load(fh)


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in "
                       f"BENCHMARK.json")
    return found[0]


def cell(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, parsed (its entry's `file`)."""
    entry = _one(bench["configs"], name, "config")
    with open(ROOT / entry["file"]) as fh:
        conf = json.load(fh)
    if conf["name"] != name:
        raise ValueError(f"{entry['file']} names {conf['name']!r}, not "
                         f"{name!r}")
    return conf


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def reports(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether the cell reports this metric: listed under its
    `workloads`, or, without that key, for a per-layer metric, whenever
    the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = _one(bench["end_to_end"], metric["moves"], "metric")
        return reports(moved, cell_name, bench)
    return True


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell_name, bench)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["per_layer"] if reports(m, cell_name, bench)]


def end_to_end_fn(name: str):
    return importlib.import_module(f"benchmark.end_to_end.{name}").value


def reader_of(name: str):
    """(reader module, argument) of a per-layer metric: the part of its
    name before the first dot names the reader, `metrics/<part>.py`; a
    `<piece>_roofline` is read by `metrics/roofline.py` for the work
    piece `<piece>`."""
    base = name.split(".")[0]
    if base.endswith("_roofline"):
        return (importlib.import_module("benchmark.metrics.roofline"),
                base[: -len("_roofline")])
    return importlib.import_module(f"benchmark.metrics.{base}"), None


def work_piece(piece: str):
    return importlib.import_module(f"benchmark.work.{piece}")


def work_pieces() -> list[str]:
    """Every piece of the work model, by file name."""
    return sorted(p.stem for p in (BENCH / "work").glob("*.py")
                  if not p.stem.startswith("_"))


def pipeline_config(conf: dict, base):
    """`base` (a PipelineConfig) with the configuration's `pipeline`
    fields set; a nested slice-set field is given whole."""
    fields = {}
    for key, val in conf.get("pipeline", {}).items():
        if isinstance(val, dict):
            val = dataclasses.replace(getattr(base, key), **val)
        elif isinstance(val, list):
            val = tuple(val)
        fields[key] = val
    return dataclasses.replace(base, **fields)


def weight(conf: dict, name: str) -> Path:
    return ROOT / conf["weights"][name]
