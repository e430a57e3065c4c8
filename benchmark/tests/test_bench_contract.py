"""BENCHMARK.json against the contract's rules of form, and every file it
names found by name."""

import json
import re

import pytest

from benchmark.harness import spec as S

BENCH = S.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (S.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert ONE_LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert (S.ROOT / path).is_dir() and not path.endswith("_torch")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in
                                   ("end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert ONE_LINE.match(e[key]), (e["name"], key)


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_configs_and_traffic_found_by_name():
    used = set()
    for cell in BENCH["workloads"]:
        assert cell["chips"] in (1, 4)
        conf = S.config(BENCH, cell["config"])
        assert conf["limits"] and conf["weights"] and conf["inputs"]
        traffic = S.traffic(cell["traffic"])
        S.loop(traffic["loop"]).Run
        used.add(cell["config"])
        assert ONE_LINE.match(cell["why"])
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for entry in BENCH["configs"]:
        assert entry["file"].startswith(tuple(BENCH["paths"]))
        assert json.loads((S.ROOT / entry["file"]).read_text())["reduced"] \
            == entry["reduced"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_states_every_pipeline_field(name):
    """A configuration's file sets every field of the PipelineConfig, so
    no size or capacity of a cell comes from the program's defaults, and
    the program's config built from it equals the reference's."""
    import dataclasses

    from benchmark.harness import programs as P
    from benchmark.reference import runner

    conf = S.config(BENCH, name)
    want = runner.frozen_config(conf)
    fields = {f.name for f in dataclasses.fields(want)}
    assert set(conf["pipeline"]) == fields
    for key, val in conf["pipeline"].items():
        if isinstance(val, dict):
            assert set(val) == {f.name for f in
                                dataclasses.fields(getattr(want, key))}
    got = dataclasses.asdict(P.config(conf))
    assert got == dataclasses.asdict(want)


def test_every_metric_has_its_code():
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in S.end_to_end(BENCH, cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        assert S.per_layer(BENCH, cell["name"]), cell["name"]
        for name in e2e:
            assert callable(S.end_to_end_fn(name))
    for m in BENCH["per_layer"]:
        reader, arg = S.reader_of(m["name"])
        assert callable(reader.read)
        if arg is not None:
            assert arg in S.work_pieces()
    for piece in S.work_pieces():
        mod = S.work_piece(piece)
        assert mod.HOOKS and callable(mod.work)


def test_per_layer_cells_report_what_they_move():
    layers = {}
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert len(moved) == 1, m["name"]
        for cell in m.get("workloads", []):
            assert S.reports(moved[0], cell, BENCH), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(ONE_LINE.match(layer) for layer in layers)
