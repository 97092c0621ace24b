"""Tracing / profiling helpers — the port of
:mod:`diffquantum_tpu.utils.profiling`.

The reference has no profiling (SURVEY.md §5). Here: wall timers that
wait for the card's queue (``torch.cuda.synchronize``) when the timed
function returns CUDA tensors, and a ``torch.profiler`` trace context.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


def _cuda_device(out):
    """The device of the first CUDA tensor in ``out`` (tensors, tuples,
    lists, dicts), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (list, tuple)) else ()
    for item in items:
        dev = _cuda_device(item)
        if dev is not None:
            return dev
    return None


def _block(out):
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return out


def timed(fn: Callable, *args, n_warmup: int = 2, n_runs: int = 10,
          **kw) -> dict:
    """Median/p10/p90 wall latency of ``fn(*args)``, each run ending when
    the card has finished the work of the CUDA tensors it returned."""
    for _ in range(n_warmup):
        _block(fn(*args, **kw))
    ts = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        _block(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {
        "median_s": float(np.median(ts)),
        "p10_s": float(np.percentile(ts, 10)),
        "p90_s": float(np.percentile(ts, 90)),
        "n_runs": n_runs,
    }


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels when CUDA is available) and write it as a Chrome
    trace, ``<log_dir>/trace.json``, viewable in Perfetto. The JAX
    package's name is kept.

    Usage::

        with xla_trace("traces"):
            step(x)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def wall_timer(label: str, logger=None):
    """Simple labelled wall-clock block; logs via ``logger`` if given."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"[{label}] {dt * 1e3:.2f} ms"
    if logger is not None:
        logger.write_text_aux(msg)
    else:
        print(msg)
