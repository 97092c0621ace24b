"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result line."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import torch

from . import checking, driver, spec
from .tracing import Profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "diffquantum_tpu")


class NoCard(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return time.time() - (btime + start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time() - _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclasses.dataclass
class RunData:
    """What a metric reader reads."""
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    epochs: int
    intervals_ms: list
    spans: dict
    trace: object = None     # tracing.DeviceTrace in a traced run
    chain_patterns: tuple = ()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def look_for_card(chips: int):
    if chips != 1:
        raise NoCard(f"the cell asks for {chips} cards; the harness drives "
                     f"one and has no launcher across cards")
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} are visible")


def read_metrics(entries, data: RunData) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"]).read(data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", log=None) -> dict:
    """Runs the cell and returns the result line's object. ``device``
    'cpu' skips the look for a card (the tests' rehearsal)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        look_for_card(cell.chips)
        torch.cuda.set_device(0)
    spans = {"import": process_age_s()}
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)
    spans["device_init"] = time.perf_counter() - t
    t = time.perf_counter()
    system = driver.System(cell.config, cell.traffic, device)
    spans["build"] = time.perf_counter() - t
    t = time.perf_counter()
    system.run_job(driver.job_seed(seed, driver.WARMUP_JOB),
                   int(cell.traffic["warmup_epochs"]))
    if cuda:
        torch.cuda.synchronize()
    spans["warmup"] = time.perf_counter() - t
    setup_s = process_age_s()
    parts = ", ".join(f"{k} {v!r} s" for k, v in spans.items())
    log(f"setup: {setup_s!r} s ({parts})")

    clock = driver.StepClock(cuda)
    prof = Profiled() if trace else contextlib.nullcontext()
    with prof:
        jobs, wall, epochs, failed = driver.run_window(system, seed, seconds,
                                                       clock, log)
    intervals = clock.intervals_ms()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded that the benchmark must not "
                           f"load: {bad}")
    log(f"window: {wall!r} s, {len(jobs)} jobs, {epochs} epochs, "
        f"{failed} failed; card: {card_line() if cuda else 'none'}")
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    values = checking.check_window(jobs, cell.config, cell.traffic, seed,
                                   device, log)
    if values is None:
        values = {k: float("nan") for k in checking.NUMBERS}
    correct, checks = checking.judge(values, cell.limits)
    correct = correct and failed == 0

    data = RunData(cell.name, cell.config, cell.traffic, setup_s, wall,
                   epochs, intervals, spans,
                   prof.trace if trace else None,
                   tuple(spec.chain_kernel_patterns()))
    result = {"correct": correct, "attempted": epochs + failed,
              "failed": failed}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    if trace:
        result["metrics"] = read_metrics(cell.per_layer, data)
        device_info.update(busy_s=data.trace.busy_s, window_s=wall)
        result["device"] = device_info
        result["breakdown"] = data.trace.breakdown()
    else:
        result["metrics"] = read_metrics(cell.end_to_end, data)
        result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr, flush=True)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
