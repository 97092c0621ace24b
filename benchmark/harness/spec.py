"""Finds a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells. Everything that
belongs to one configuration, traffic mix, cell or metric sits in a file
of its own under ``benchmark/``:

- ``configs/<config>.json``: the problem's sizes (the file that
  ``BENCHMARK.json`` names for the configuration), with the names of its
  program side, ``problems/<problem>.py``, and of its plain reference,
  ``reference/<reference>.py``;
- ``traffic/<traffic>.json``: the trainer settings and job shape;
- ``limits/<workload>.json``: each number the correctness check compares,
  with its limit and the readings it was set from;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or
  per-layer (see ``metrics/README.txt``).

So a cell, a mix or a metric is added by adding files and entries, and no
existing file changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name, config, traffic, limits, int(w["chips"]), e2e,
                per_layer)


def _module(folder: str, name: str):
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py under {BENCH_DIR}")
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: its ``read`` and the entries it
    states."""
    return _module("metrics", name)


def problem_module(name: str):
    """The module ``problems/<name>.py``: ``build(config, traffic,
    device)``, the program's problem and trainer call."""
    return _module("problems", name)


def reference_module(name: str):
    """The module ``reference/<name>.py``: the plain reference, with
    ``build(config, device, matmul_round)``, ``set_exact_matmul``,
    ``tf32_round``, ``split_times``, ``replay`` and ``follow``."""
    return _module("reference", name)


def chain_kernel_patterns() -> list[str]:
    """Substrings that name the chain kernels in a device trace: every
    line of every ``metrics/chain_kernels/*.txt`` (a later kernel family
    adds a file of its own)."""
    out = []
    for path in sorted((BENCH_DIR / "metrics" / "chain_kernels").glob(
            "*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out
