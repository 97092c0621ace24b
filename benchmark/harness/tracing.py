"""Reads the ``torch.profiler`` trace of the traced window.

The profiler's Chrome trace is written to a temporary file, read back and
deleted. From it come the device's operations (kernels, copies and fills,
with their names, starts and lengths), the time in which any of them ran
(their union), and the host's operations, by which each idle gap of the
device is named: the innermost host operation around the launch of the
device operation that ends the gap, or around the gap's end where the
launch is not in the trace, else ``(host: no op)``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OP = "(host: no op)"


@dataclasses.dataclass
class DeviceTrace:
    ops: list            # (name, start_us, dur_us), sorted by start
    busy_s: float
    gaps: list           # (host op name, seconds), every idle gap inside

    def time_by_name(self) -> dict:
        out = collections.defaultdict(float)
        for name, _, dur in self.ops:
            out[name] += dur * 1e-6
        return dict(out)

    def ms_matching(self, patterns, matching: bool = True) -> float:
        """Summed device ms of the ops whose names hold one of
        ``patterns`` (with ``matching`` False: of all the others)."""
        return 1e-3 * sum(dur for name, _, dur in self.ops
                          if any(p in name for p in patterns) == matching)

    def breakdown(self, top: int = 10) -> dict:
        gaps = collections.defaultdict(float)
        for name, sec in self.gaps:
            gaps[name] += sec
        by = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in by[:top]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:top]]}


def union_seconds(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def innermost(ops, times) -> list:
    """For each time, the name of the innermost host op that contains it
    (None where none does). Host ops of one thread nest, so a sweep over
    the ops in order of start, with a stack of the open ones, finds it."""
    ops = sorted(ops, key=lambda o: (o[1], -o[2]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out, stack, k = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while k < len(ops) and ops[k][1] <= t:
            while stack and stack[-1][2] < ops[k][1]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def parse(events: list) -> DeviceTrace:
    """A :class:`DeviceTrace` from Chrome-trace events."""
    dev, launches, host = [], {}, collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            dev.append((ev.get("name", "?"), ts, dur, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "cpu_op":
            host[ev.get("tid")].append((ev.get("name", "?"), ts, ts + dur))
    dev.sort(key=lambda o: o[1])
    busy = union_seconds((s, s + d) for _, s, d, _ in dev)
    # the host thread that issued most of the work names the gaps
    main = max(host.values(), key=len) if host else []
    spans, end = [], None
    for name, s, d, corr in dev:
        if end is not None and s > end:
            spans.append((end, s, launches.get(corr, s)))
        end = s + d if end is None else max(end, s + d)
    at_launch = innermost(main, [t for _, _, t in spans])
    at_end = innermost(main, [s for _, s, _ in spans])
    gaps = [(a or b or NO_OP, (s - e) * 1e-6)
            for (e, s, _), a, b in zip(spans, at_launch, at_end)]
    return DeviceTrace([(n, s, d) for n, s, d, _ in dev], busy, gaps)


class Profiled:
    """``with Profiled() as p: ...`` runs the block under torch.profiler
    (host and CUDA activity); ``p.trace`` is then its DeviceTrace."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.trace = parse(events)
        return False
