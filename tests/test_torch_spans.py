"""The port's tracer (``utils.profiling``: spans and launch counters) on
the 10-qubit ring MaxCut's seed trainer, the fused engine forced so that
the CPU runs the chains' plain versions: with no profiler on a span is a
flag check and records nothing, under ``torch.profiler`` the spans form
the trainer's tree, and ``xla_trace``'s Chrome trace holds them on the
store's clock. One test needs the card: there the chain spans' device
time is the chain kernels' time in the profiler's trace. Imports no JAX
(the card's run: ``python -m pytest tests/test_torch_spans.py
--noconftest -o addopts="" -q``)."""
import json
import statistics
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffquantum_tpu_torch.models import maxcut
from diffquantum_tpu_torch.parallel import train_energy_seeds
from diffquantum_tpu_torch.train.config import TrainConfig
from diffquantum_tpu_torch.utils import profiling

CHAIN_NAMES = Path(__file__).resolve().parents[1] / "benchmark" / \
    "metrics" / "chain_kernels"


@pytest.fixture(scope="module")
def ring10():
    return maxcut.build_maxcut(10, maxcut.ring_graph(10), n_basis=6,
                               dense=False, device="cpu")


def _job(prob, mode, n_seeds=2, epochs=2, **kw):
    cfg = TrainConfig(n_epoch=epochs, grad_mode=mode, n_step=30, **kw)
    return train_energy_seeds(prob.ham, prob.envelope, prob.measurement,
                              prob.psi0, prob.T, cfg, n_seeds=n_seeds)


class _FakeEvent:
    """A CUDA event's stand-in: its time is the host's at record()."""
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """A card that has been used: spans under a profiler record events."""
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling, "_EVENTS", [])
    return _FakeEvent


def test_no_profiler_records_nothing(ring10, fake_card):
    profiling.reset_window()
    before = profiling.counters()
    opt_inits = profiling.host_spans()["train.optim_init"].count \
        if "train.optim_init" in profiling.host_spans() else 0
    for mode in ("adjoint", "mc"):
        _job(ring10, mode, backend="product_fused")
    win = profiling.window()
    assert win.spans == [] and win.counters == {}
    assert fake_card.made == 0            # no CUDA event made or recorded
    # the CPU runs the chains' plain versions: no launch counted
    assert profiling.counters() == before
    assert profiling.host_spans()["train.optim_init"].count == opt_inits + 2
    profiling.count("spans_test", 3)
    profiling.count("spans_test")
    assert profiling.counters()["spans_test"] == before["spans_test"] + 4
    assert profiling.window().counters == {}


def _tree(win):
    return [(s.name, None if s.parent is None else win.spans[s.parent].name,
             s.epoch) for s in win.spans]


def test_span_tree_under_the_profiler(ring10):
    profiling.reset_window()
    with profile(activities=[ProfilerActivity.CPU]):
        _job(ring10, "adjoint", backend="product_fused")
        _job(ring10, "mc", backend="product_fused")
    win = profiling.window()
    assert win.counters == {}
    assert all(s.device_ms is None and s.end_ns >= s.start_ns
               for s in win.spans)
    jobs = sorted({s.job for s in win.spans})
    assert len(jobs) == 2
    tree = [(t, s.job) for t, s in zip(_tree(win), win.spans)]
    head = [("train.job", None, None),
            ("train.optim_init", "train.job", None)]
    adjoint = [("train.epoch", "train.job", 0),
               ("train.energy", "train.epoch", 0),
               ("pulse.chain_inputs", "train.energy", 0),
               ("chain.fwd", "train.energy", 0),
               ("train.grad", "train.epoch", 0),
               ("chain.bwd", "train.grad", 0),
               ("train.optim", "train.epoch", 0)]
    mc = [("train.epoch", "train.job", 0),
          ("train.energy", "train.epoch", 0),
          ("pulse.chain_inputs", "train.energy", 0),
          ("chain.fwd", "train.energy", 0),
          ("train.grad", "train.epoch", 0),
          ("pulse.chain_inputs", "train.grad", 0),   # leg 1
          ("chain.fwd", "train.grad", 0),
          ("pulse.chain_inputs", "train.grad", 0),   # leg 2
          ("chain.fwd", "train.grad", 0),
          ("train.optim", "train.epoch", 0)]
    for job, epoch in zip(jobs, (adjoint, mc)):
        assert [t for t, j in tree if j == job] == \
            head + epoch + [(n, p, 1) for n, p, _ in epoch]
    profiling.reset_window()
    assert profiling.window().spans == []


def test_device_ms_from_events(fake_card):
    """Under a profiler, with a card in use, each span brackets its work
    with two events, resolved when the window is read and returned to the
    pool."""
    import time
    profiling.reset_window()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.grad"):
            time.sleep(0.004)
            with profiling.span("chain.bwd"):
                time.sleep(0.010)
        with profiling.span("train.optim_init", always=True):
            pass
    assert fake_card.made == 4
    win = profiling.window()
    grad, chain, init = win.spans
    assert chain.parent == 0 and init.device_ms is None
    assert 10.0 <= chain.device_ms < grad.device_ms
    assert grad.device_ms == pytest.approx(grad.host_ms, abs=1.0)
    assert len(profiling._EVENTS) == 4    # back in the pool
    profiling.reset_window()
    # spans one after another reuse the events of those the card passed
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("train.optim"):
                time.sleep(0.001)
    win = profiling.window()
    assert fake_card.made == 4 and len(win.spans) == 5
    assert all(s.device_ms >= 1.0 for s in win.spans)
    profiling.reset_window()


def test_a_span_on_another_thread_takes_the_open_parent():
    """As autograd's engine thread runs a backward on the card: its spans
    hang under the span that called it."""
    profiling.reset_window()
    done = []

    def engine():
        with profiling.span("chain.bwd"):
            done.append(True)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.epoch", epoch=7):
            with profiling.span("train.grad"):
                t = threading.Thread(target=engine)
                t.start()
                t.join(timeout=30)
    assert not t.is_alive() and done
    assert _tree(profiling.window()) == [
        ("train.epoch", None, 7), ("train.grad", "train.epoch", 7),
        ("chain.bwd", "train.grad", 7)]
    profiling.reset_window()


def test_xla_trace_holds_the_spans_on_the_store_clock(tmp_path):
    profiling.reset_window()
    with profiling.xla_trace(str(tmp_path)):
        for k in range(40):
            with profiling.span("train.epoch", epoch=k):
                with profiling.span("train.optim"):
                    torch.ones(256).cumsum(0)
    win = profiling.window()
    profiling.reset_window()
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    for name in ("train.epoch", "train.optim"):
        got = sorted(ev["ts"] * 1000 + base for ev in trace["traceEvents"]
                     if ev.get("cat") == "user_annotation"
                     and ev.get("name") == name)
        mine = sorted(s.start_ns for s in win.spans if s.name == name)
        assert len(got) == len(mine) == 40
        assert statistics.median(abs(a - b) for a, b in zip(got, mine)) \
            < 50e3


@pytest.mark.gpu
def test_chain_spans_time_the_chain_kernels_on_card(tmp_path):
    """On a card-paced 12q job (2048 seeds, K2), the chain spans' device
    ms agree within 3% with the profiler's time of the kernels named in
    benchmark/metrics/chain_kernels/*.txt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain kernels have no CPU mode")
    prob = maxcut.build_maxcut(12, maxcut.ring_graph(12), n_basis=6,
                               dense=False, device="cuda")
    _job(prob, "adjoint", n_seeds=2048, epochs=2)      # builds, warms up
    torch.cuda.synchronize()
    profiling.reset_window()
    with profiling.xla_trace(str(tmp_path)):
        _job(prob, "adjoint", n_seeds=2048, epochs=10)
    win = profiling.window()
    profiling.reset_window()
    span_ms = sum(s.device_ms for s in win.spans
                  if s.name in ("chain.fwd", "chain.bwd"))
    names = [ln.strip() for p in sorted(CHAIN_NAMES.glob("*.txt"))
             for ln in p.read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernel_ms = 1e-3 * sum(ev["dur"] for ev in events
                           if ev.get("cat") == "kernel"
                           and any(n in ev.get("name", "") for n in names))
    assert win.counters == {"k2_forward": 10, "k2_backward": 10}
    assert kernel_ms > 0
    assert span_ms == pytest.approx(kernel_ms, rel=0.03)
