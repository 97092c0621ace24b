"""The readers of the program's spans and counters
(harness/program_spans.py and the seven metrics that use it) on a
synthetic store, and on a program without one, as at a commit before the
tracer: None, no raise."""
import types

import pytest

from harness import program_spans, spec
from harness.runner import RunData

READERS = ("chain_span_ms_per_epoch", "pulse_ms_per_epoch",
           "grad_glue_ms_per_epoch", "optim_ms_per_epoch",
           "chain_launches_per_epoch", "optim_init_s", "problem_build_s")


def _span(name, parent, device_ms, epoch=0):
    return types.SimpleNamespace(name=name, parent=parent, job=0,
                                 epoch=epoch, start_ns=0, end_ns=1,
                                 device_ms=device_ms)


def synthetic_tracer(device=True):
    """Two epochs: an adjoint one (grad 5 ms with a 3 ms chain.bwd inside)
    and an MC one (grad 9 ms holding a 1 ms pulse and a 6 ms chain.fwd);
    each with a 0.5 ms pulse and a 2 ms chain.fwd under the energy and a
    0.75 ms optimizer step. Without ``device``, no span has a device
    time, as on the CPU."""
    d = (lambda ms: ms) if device else (lambda ms: None)
    spans = [_span("train.job", None, None)]
    for k, (grad, kids) in enumerate((
            (5.0, [("chain.bwd", 3.0)]),
            (9.0, [("pulse.chain_inputs", 1.0), ("chain.fwd", 6.0)]))):
        ep = len(spans)
        spans.append(_span("train.epoch", 0, d(20.0), k))
        en = len(spans)
        spans += [_span("train.energy", ep, d(3.0), k),
                  _span("pulse.chain_inputs", en, d(0.5), k),
                  _span("chain.fwd", en, d(2.0), k)]
        gr = len(spans)
        spans.append(_span("train.grad", ep, d(grad), k))
        spans += [_span(n, gr, d(ms), k) for n, ms in kids]
        spans.append(_span("train.optim", ep, d(0.75), k))
    counters = {"k2_forward": 3, "k2_backward": 1, "k5_forward": 2,
                "k5_batched_forward": 1, "apply_recurrence": 7}
    win = types.SimpleNamespace(spans=spans, counters=counters)
    host = {"train.optim_init": types.SimpleNamespace(first_s=9.5, count=3),
            "build.problem": types.SimpleNamespace(first_s=1.25, count=1)}
    return types.SimpleNamespace(window=lambda: win, host_spans=lambda: host)


def _run(epochs=2):
    return RunData("t", {}, {}, 1.0, 0.1, epochs, [1.0], {}, None, ())


def test_the_readers_arithmetic():
    t = synthetic_tracer()
    got = {name: spec.metric_reader(name).read(_run(), tracer=t)
           for name in READERS}
    assert got == {
        "chain_span_ms_per_epoch": pytest.approx((2 + 3 + 2 + 6) / 2),
        "pulse_ms_per_epoch": pytest.approx((0.5 + 0.5 + 1.0) / 2),
        # train.grad less its children: 5 - 3 and 9 - 1 - 6
        "grad_glue_ms_per_epoch": pytest.approx((2.0 + 2.0) / 2),
        "optim_ms_per_epoch": pytest.approx(0.75),
        # the families only: not the batched subset, not the recurrence
        "chain_launches_per_epoch": pytest.approx(6 / 2),
        "optim_init_s": 9.5,
        "problem_build_s": 1.25}


def test_no_device_time_reads_none():
    t = synthetic_tracer(device=False)
    for name in READERS[:4]:
        assert spec.metric_reader(name).read(_run(), tracer=t) is None
    assert spec.metric_reader("chain_launches_per_epoch").read(
        _run(0), tracer=t) is None


@pytest.mark.parametrize("program", [
    types.SimpleNamespace(),   # no tracer store at all
    # the parent's profiling module: timers and a trace context only
    types.SimpleNamespace(timed=None, xla_trace=None, wall_timer=None)])
def test_a_program_without_a_store_reads_none(program):
    for name in READERS:
        assert spec.metric_reader(name).read(_run(), tracer=program) is None


def test_the_program_tracer_is_found():
    from diffquantum_tpu_torch.utils import profiling
    assert program_spans.tracer() is profiling
