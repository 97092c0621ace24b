"""Reads the program's own tracer, ``diffquantum_tpu_torch.utils.profiling``:
the spans and launch counters it recorded while the traced window's
profiler was on (its ``window()``), and the set-up spans it records
always (its ``host_spans()``). It runs in the harness's process after the
window, as the metric readers do. A program without that tracer, or
without those two functions, gives None, and the metrics that read it are
left out of the result line."""
from __future__ import annotations

import importlib
import re

PROGRAM = "diffquantum_tpu_torch.utils.profiling"
CHAIN_SPANS = ("chain.fwd", "chain.bwd")
# one counter per chain kernel family and direction; the batched subsets
# (k5_batched_forward, ...) count again chains counted here
CHAIN_COUNTER = re.compile(r"^k[1-7]_(forward|backward)$")


def tracer(given=None):
    """``given`` (a stand-in in the tests), else the program's tracer
    module; None where it has no ``window`` and ``host_spans``."""
    if given is None:
        try:
            given = importlib.import_module(PROGRAM)
        except ImportError:
            return None
    if not (hasattr(given, "window") and hasattr(given, "host_spans")):
        return None
    return given


def window(given=None):
    """The program's window (spans and counter increases), or None."""
    t = tracer(given)
    return None if t is None else t.window()


def device_ms(win, names) -> float | None:
    """Summed device ms of the window's spans named in ``names``; None
    where none of them has a device time."""
    ms = [s.device_ms for s in win.spans
          if s.name in names and s.device_ms is not None]
    return sum(ms) if ms else None


def self_device_ms(win, name: str) -> float | None:
    """Summed device ms of the spans ``name``, each less the device ms of
    its child spans: the work the span's own code issued."""
    children = {}
    for s in win.spans:
        if s.parent is not None and s.device_ms is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.device_ms
    ms = [s.device_ms - children.get(i, 0.0)
          for i, s in enumerate(win.spans)
          if s.name == name and s.device_ms is not None]
    return sum(ms) if ms else None


def chain_launches(win) -> int | None:
    """The window's chains launched (the family counters' increase), or
    None where no chain was counted."""
    n = sum(v for k, v in win.counters.items() if CHAIN_COUNTER.match(k))
    return n or None


def first_host_s(name: str, given=None) -> float | None:
    """Host seconds of the process's first always-recorded span
    ``name``, or None."""
    t = tracer(given)
    rec = None if t is None else t.host_spans().get(name)
    return None if rec is None else rec.first_s


def per_epoch(value, run):
    """``value`` over the traced window's epochs, or None."""
    if value is None or not run.epochs:
        return None
    return value / run.epochs
