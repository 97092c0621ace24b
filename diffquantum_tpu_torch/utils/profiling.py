"""Tracing / profiling helpers — the port of
:mod:`diffquantum_tpu.utils.profiling`.

The reference has no profiling (SURVEY.md §5). Here: wall timers that
wait for the card's queue (``torch.cuda.synchronize``) when the timed
function returns CUDA tensors, a ``torch.profiler`` trace context, and
the port's tracer: its spans and its launch counters.

**Spans.** ``with span(name):`` marks a layer's work. While no
``torch.profiler`` profile is on, a span is one flag check
(``torch.autograd.profiler._is_profiler_enabled``) and nothing else.
While one is on, it opens a ``record_function`` range of the same name,
so the span sits in the profiler's trace on its clock (a Chrome trace's
``user_annotation`` event: ``ts * 1000 + baseTimeNanoseconds`` is the
``time.time_ns()`` the span took as it opened), and appends a record to
the window: name, parent, job and epoch, host start and end
(``time.time_ns()``), and, once the program has used the card, a CUDA
event recorded on the current stream at each end, resolved to device ms
only when :func:`window` is read. A span opened on a thread with no
span of its own open (autograd's engine thread in a backward) takes as
parent the innermost span open on any thread: the one that called the
backward. The spans, and the metric (``benchmark/metrics/<name>.py``)
that reads each:

- ``train.job``: one ``parallel.train_energy_seeds`` call, its host
  readout included; the job of the spans under it;
- ``train.optim_init``: ``make_optimizer`` in it, host only, recorded
  always (:func:`host_spans`): ``optim_init_s``;
- ``train.epoch``: one epoch, carrying its index; ``train.energy``: the
  exact energies;
- ``train.grad``: ``torch.autograd.grad`` (adjoint) or the MC
  estimator: ``grad_glue_ms_per_epoch``, its device time less its child
  spans';
- ``train.optim``: ``opt.step()`` with its hooks: ``optim_ms_per_epoch``;
- ``pulse.chain_inputs``: ``dynamics.product.fused_chain_inputs`` /
  ``packed_chain_inputs``: ``pulse_ms_per_epoch``;
- ``chain.fwd`` / ``chain.bwd``: one chain kernel's launch, K1-K7 (the
  plain version on the CPU): ``chain_span_ms_per_epoch``;
- ``build.problem``: ``models.maxcut.build_maxcut``, host only, recorded
  always: ``problem_build_s``.

``xla_trace`` shows the spans over the device's timeline in Perfetto.

**Counters.** ``count(name)`` bumps the process's launch counter
``name`` (``k1_forward`` ... ``k7_backward``, the batched subsets
``k5_batched_forward`` ..., ``apply_recurrence``); :func:`counters` reads
the totals. While a profiler is on the increase is also kept in the
window.

The window is what was recorded while a profiler was on, since the
process started or since :func:`reset_window`. Events come from a pool,
which a span that needs one refills from the oldest closed span whose end
the card has passed (reading its device ms then): a new event costs the
host about twice a reused one under the profiler. So a profiled run holds
the events of the spans the card has not reached yet.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


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


# ---------------------------------------------------------------------------
# the tracer: spans and launch counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    """One span of the window; ``parent`` indexes the window's spans.
    ``device_ms`` is None where no CUDA event was recorded."""
    name: str
    parent: Optional[int]
    job: int
    epoch: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


@dataclasses.dataclass
class Window:
    spans: list       # SpanRecord, in the order they opened
    counters: dict    # counter name -> increase in the window


@dataclasses.dataclass
class HostSpan:
    """An always-recorded span: the host seconds of its first, and how
    many there were."""
    first_s: float
    count: int


_SPANS: list = []          # _Span recorded, in the order they opened
_OPEN: list = []           # _Span recorded and open now, on any thread
_LOCAL = threading.local()
_JOBS = itertools.count()
_EVENTS: list = []         # the pool of free CUDA events
_PENDING = collections.deque()   # closed spans, events unread; oldest first
_TOTALS: dict = {}
_WINDOW_COUNTS: dict = {}
_HOST: dict = {}           # name -> HostSpan
_LOCK = threading.Lock()


class _Off:
    """The span while no profiler is on."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _event():
    """A free CUDA event: from the pool, refilled from the oldest closed
    span whose events the card has passed (read now, a query and an
    elapsed time instead of a new event), else a new one."""
    if not _EVENTS and _PENDING and _PENDING[0].ev[1].query():
        _release(_PENDING.popleft(), True)
    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "epoch", "always", "recorded", "parent", "job",
                 "start_ns", "end_ns", "t0", "ev", "range", "device_ms")

    def __init__(self, name, epoch, always):
        self.name, self.epoch, self.always = name, epoch, always
        self.recorded = False
        self.end_ns = self.ev = self.device_ms = None

    def __enter__(self):
        if self.always:
            self.t0 = time.perf_counter()
            if not _autograd_profiler._is_profiler_enabled:
                return self
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else (_OPEN[-1] if _OPEN else None)
        if parent is None:
            self.job = next(_JOBS)
        else:
            self.job = parent.job
            if self.epoch is None:
                self.epoch = parent.epoch
        self.parent, self.recorded = parent, True
        _SPANS.append(self)
        stack.append(self)
        _OPEN.append(self)
        self.start_ns = time.time_ns()
        self.range = record_function(self.name)
        self.range.__enter__()
        if not self.always and torch.cuda.is_initialized():
            self.ev = (_event(), _event())
            self.ev[0].record()
        return self

    def __exit__(self, *exc):
        if self.recorded:
            if self.ev is not None:
                self.ev[1].record()
                _PENDING.append(self)
            self.range.__exit__(*exc)
            self.end_ns = time.time_ns()
            _LOCAL.stack.pop()
            _OPEN.remove(self)
        if self.always:
            rec = _HOST.get(self.name)
            _HOST[self.name] = HostSpan(time.perf_counter() - self.t0, 1) \
                if rec is None else HostSpan(rec.first_s, rec.count + 1)
        return False


def span(name: str, epoch: Optional[int] = None, always: bool = False):
    """The context of span ``name`` (see the module note). ``epoch``: the
    epoch index that this span and its descendants carry. ``always``:
    record the host seconds even with no profiler on (:func:`host_spans`),
    and no CUDA event."""
    if always:
        return _Span(name, epoch, True)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, epoch, False)


def traced(name: str, always: bool = False):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name, always=always):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Bumps launch counter ``name`` by ``n`` (and its window increase
    while a profiler is on)."""
    with _LOCK:
        _TOTALS[name] = _TOTALS.get(name, 0) + n
        if _autograd_profiler._is_profiler_enabled:
            _WINDOW_COUNTS[name] = _WINDOW_COUNTS.get(name, 0) + n


def counters() -> collections.Counter:
    """The process's total of each counter (0 for one never bumped)."""
    with _LOCK:
        return collections.Counter(_TOTALS)


def host_spans() -> dict:
    """{name: :class:`HostSpan`} of the always-recorded spans."""
    return dict(_HOST)


def _release(sp: _Span, resolve: bool):
    """Returns the span's events to the pool, first reading its device ms
    (waiting for its end event) where ``resolve``."""
    if sp.ev is None:
        return
    if resolve:
        sp.ev[1].synchronize()   # at once where the card has passed it
        sp.device_ms = sp.ev[0].elapsed_time(sp.ev[1])
    _EVENTS.extend(sp.ev)
    sp.ev = None


def window() -> Window:
    """The spans and counter increases recorded while a profiler was on,
    since the process started or :func:`reset_window`; spans still open
    are left out. Resolves the closed spans' device ms and returns their
    events to the pool."""
    _PENDING.clear()
    spans, at = [], {}
    for sp in list(_SPANS):
        if sp.end_ns is None:
            continue
        _release(sp, True)
        at[sp] = len(spans)
        spans.append(SpanRecord(sp.name, at.get(sp.parent), sp.job, sp.epoch,
                                sp.start_ns, sp.end_ns, sp.device_ms))
    with _LOCK:
        return Window(spans, dict(_WINDOW_COUNTS))


def reset_window():
    """Empties the window; the counters' totals and the always-recorded
    spans stay."""
    for sp in _SPANS:
        if sp.end_ns is not None:
            _release(sp, False)
    _SPANS.clear()
    _PENDING.clear()
    with _LOCK:
        _WINDOW_COUNTS.clear()
