"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``mixes/<traffic>.json``) and the
reader of each of its metrics, end-to-end and per-layer alike
(``metrics/<name>.py``, a ``read`` function).  A new configuration, mix
or metric is a new file and a new entry, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_spec() -> dict:
    """``BENCHMARK.json`` of the checkout."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    """The workload entry called ``name``."""
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    known = ", ".join(c["name"] for c in spec["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")


def load_config(spec: dict, cell: dict) -> dict:
    """The configuration file of the cell's ``config``."""
    for cfg in spec["configs"]:
        if cfg["name"] == cell["config"]:
            return json.loads((ROOT / cfg["file"]).read_text())
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


#: the keys a mix may hold: what the generator and the closed loop read
MIX_KEYS = frozenset({"about", "designs_per_call", "pool_batches", "family",
                      "family_args", "session", "warmup_calls",
                      "check_rows_per_call", "trace_calls"})


def load_mix(name: str) -> dict:
    """The traffic mix ``mixes/<name>.json``.  A key the harness does not
    read is refused, so that a mix never asks for what it does not get."""
    mix = json.loads((BENCH_DIR / "mixes" / f"{name}.json").read_text())
    unknown = sorted(set(mix) - MIX_KEYS)
    if unknown:
        raise ValueError(f"mix {name!r}: the harness reads no {unknown}")
    return mix


def reports(metric: dict, spec: dict, cell_name: str) -> bool:
    """Whether the cell reports ``metric``: it is listed in the metric's
    ``workloads``, or the metric has none and the cell reports the
    end-to-end metric it moves (or is end-to-end itself)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(m["name"] == moves and reports(m, spec, cell_name)
               for m in spec["end_to_end"])


def end_to_end(spec: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in spec["end_to_end"] if reports(m, spec, cell_name)]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``: it takes the run's
    readings (``bench.run``'s ``ctx``) and returns the metric, or None
    where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"mccm_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def per_layer(spec: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports."""
    return [m for m in spec["per_layer"] if reports(m, spec, cell_name)]


def readers(spec: dict, cell_name: str, trace: bool):
    """The metrics a run of the cell reports, each with its reader: its
    end-to-end metrics, or with ``trace`` its per-layer metrics."""
    ms = per_layer(spec, cell_name) if trace else end_to_end(spec,
                                                             cell_name)
    return [(m, reader(m["name"])) for m in ms]
