"""``BENCHMARK.json`` against the benchmark's contract, and every part of
every cell found by name."""
from __future__ import annotations

import json
import re

import pytest

from mccm_bench import cells

SPEC = cells.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[part]:
            assert set(e) - {"workloads"} == KEYS[part], e
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[part]:
            assert NAME.match(e["name"]), e["name"]
            assert (part, e["name"]) not in seen
            seen.add((part, e["name"]))
            for k in ("why", "source", "layer"):
                if k in e:
                    assert LINE.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [m["name"] for p in ("end_to_end", "per_layer")
                    for m in SPEC[p]]
    assert len(metric_names) == len(set(metric_names))
    for c in SPEC["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_command_and_paths():
    assert SPEC["command"] == ["python3", "mccm_bench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (cells.ROOT / p).is_dir()
    for word in SPEC["command"][1:]:
        assert any(word.startswith(p + "/") for p in SPEC["paths"])


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_reports_and_resolves(cell):
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer metric; its configuration, mix and readers resolve by
    name."""
    entry = cells.find_cell(SPEC, cell)
    e2e = [m["name"] for m, read in cells.readers(SPEC, cell, False)
           if callable(read)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert e2e == [m["name"] for m in cells.end_to_end(SPEC, cell)]
    layer = cells.readers(SPEC, cell, True)
    assert layer
    for m, read in layer:
        assert callable(read)
        assert m["moves"] in e2e, (m["name"], m["moves"])
    cfg = cells.load_config(SPEC, entry)
    assert cfg["name"] == entry["config"]
    mix = cells.load_mix(entry["traffic"])
    assert mix["designs_per_call"] >= 1


def test_per_layer_moves_an_end_to_end_metric_of_each_listed_cell():
    names = {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", names)) <= names
        for cell in m.get("workloads", names):
            assert m["moves"] in {e["name"] for e in
                                  cells.end_to_end(SPEC, cell)}


def test_layer_names_agree():
    """Metrics of one layer give the same ``layer``, and each layer is
    named in PERF.md's list of layers."""
    perf = (cells.ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_configs_are_files_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_four_chip_cells_at_most_a_quarter():
    four = sum(c["chips"] == 4 for c in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        cells.find_cell(SPEC, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric")


def test_a_mix_key_the_harness_does_not_read_is_refused(tmp_path,
                                                        monkeypatch):
    """A mix that asks for what the harness does not do (an open loop,
    say) is refused rather than run as the closed loop."""
    (tmp_path / "mixes").mkdir()
    mix = dict(cells.load_mix("bulk"), loop="open")
    (tmp_path / "mixes" / "open.json").write_text(json.dumps(mix))
    monkeypatch.setattr(cells, "BENCH_DIR", tmp_path)
    with pytest.raises(ValueError, match="loop"):
        cells.load_mix("open")


def test_a_new_metric_needs_only_its_file(tmp_path, monkeypatch):
    """A per-layer metric added as an entry and a file is found by name,
    with no edit to the harness."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['profile']['calls'])\n")
    monkeypatch.setattr(cells, "BENCH_DIR", tmp_path)
    spec = dict(SPEC, per_layer=[{
        "name": "calls_traced", "unit": "calls", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "designs_per_s"}])
    cell = SPEC["workloads"][0]["name"]
    [(m, read)] = cells.readers(spec, cell, True)
    assert read({"profile": {"calls": 3}}) == 3.0


def test_a_new_end_to_end_metric_needs_only_its_file(tmp_path,
                                                      monkeypatch):
    """An end-to-end metric is found by name as a per-layer one is: the
    harness holds no metric's arithmetic."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx['walls_s']) / ctx['window_s']\n")
    monkeypatch.setattr(cells, "BENCH_DIR", tmp_path)
    spec = dict(SPEC, end_to_end=[{
        "name": "calls_per_s", "unit": "calls/s", "better": "higher",
        "bound": 0.1, "source": "host_clock"}])
    cell = SPEC["workloads"][0]["name"]
    [(m, read)] = cells.readers(spec, cell, False)
    assert read({"walls_s": [0.1] * 8, "window_s": 2.0}) == 4.0
