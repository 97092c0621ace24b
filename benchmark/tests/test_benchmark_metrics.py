"""The metric arithmetic on a small synthetic trace, and the frozen work
count against chip_smoke.py's."""
import importlib.util
import os

import pytest

from harness import roofline, spec, tracing
from harness.runner import RunData

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def synthetic_events():
    """Host: an op 0-100 us around launches at 10, 50 and 95; the device:
    a chain kernel 20-60, an Adam kernel 70-80 and a copy 110-120
    (overlapping nothing), launched at 10, 50 and 95."""
    return [
        _ev("cpu_op", "train", 0, 100),
        _ev("cpu_op", "aten::mul", 40, 20),
        _ev("cpu_op", "aten::copy_", 90, 8),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 95, 2, correlation=3),
        _ev("kernel", "void (anonymous namespace)::forward_kernel<3, 0>"
            "(Params)", 20, 40, correlation=1),
        _ev("kernel", "void at::native::adam_kernel", 70, 10,
            correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoD", 110, 10, correlation=3),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 12},
    ]


def run_data(trace, epochs=2, window_s=200e-6, config=None, traffic=None):
    return RunData("t", config or {"n_qubits": 12, "n_controls": 24,
                                   "n_steps": 30},
                   traffic or {"grad_mode": "adjoint", "n_seeds": 64},
                   1.0, window_s, epochs, [1.0, 3.0], {"build": 0.5},
                   trace, tuple(spec.chain_kernel_patterns()))


def test_parse_counts_busy_and_gaps():
    tr = tracing.parse(synthetic_events())
    assert len(tr.ops) == 3
    assert tr.busy_s == pytest.approx(60e-6)
    # gaps 60-70 (ends at the Adam kernel, launched inside aten::mul) and
    # 80-110 (ends at the copy, launched inside aten::copy_)
    assert sorted(tr.gaps) == [("aten::copy_", pytest.approx(30e-6)),
                               ("aten::mul", pytest.approx(10e-6))]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void (anonymous")
    assert bd["idle_gaps"][0] == ["aten::copy_", pytest.approx(30e-6)]


def test_union_and_innermost():
    assert tracing.union_seconds([(0, 10), (5, 20), (30, 31)]) == \
        pytest.approx(21e-6)
    ops = [("a", 0, 100), ("b", 10, 20), ("c", 30, 90), ("d", 40, 50)]
    assert tracing.innermost(ops, [45, 15, 60, 95, 200, -1]) == \
        ["d", "b", "c", "a", None, None]


def test_readers_on_the_synthetic_trace():
    data = run_data(tracing.parse(synthetic_events()))
    read = lambda name: spec.metric_reader(name).read(data)  # noqa: E731
    assert read("device_idle_pct") == pytest.approx(70.0)
    assert read("device_ops_per_epoch") == pytest.approx(1.5)
    assert read("chain_ms_per_epoch") == pytest.approx(0.020)
    assert read("glue_ms_per_epoch") == pytest.approx(0.010)
    assert read("epoch_ms") == pytest.approx(0.1)
    assert read("epoch_ms_p95") == pytest.approx(2.9)
    assert read("setup_s") == 1.0 and read("build_s") == 0.5


def test_readers_without_a_trace_return_nothing():
    data = run_data(None)
    for name in ("device_idle_pct", "device_ops_per_epoch",
                 "chain_ms_per_epoch", "glue_ms_per_epoch",
                 "streamed_roofline_pct", "packed_roofline_pct"):
        assert spec.metric_reader(name).read(data) is None


def _chip_smoke():
    sp = importlib.util.spec_from_file_location(
        "chip_smoke_for_bounds", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,members", [(12, 1), (12, 2048), (16, 8),
                                       (18, 1), (20, 16), (24, 1)])
def test_chain_count_matches_chip_smoke(n, members):
    cs = _chip_smoke()
    for bwd in (False, True):
        assert roofline.packed_bound(n, 30, ["x"] * n, n, 1, bwd, members) \
            == cs.packed_bound(n, 30, ["x"] * n, n, 1, bwd, members)
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_OPS_PER_S) == \
        (cs.HBM_BYTES_PER_S, cs.FP32_OPS_PER_S)


def test_the_count_reads_the_problem_not_a_plan():
    """The least time grows with the members' states and rows, not with a
    [T, B, d] table: at 12 qubits and 2048 members it is the operations'
    (1.3875 ms, forward and backward), and the ring's diagonal terms are
    its edges, n_controls - n_qubits."""
    cfg = {"n_qubits": 12, "n_controls": 24, "n_steps": 30}
    least = roofline.adjoint_epoch_least_ms(cfg, {"n_seeds": 2048})
    assert least == pytest.approx(1.3875008, rel=1e-6)
    assert all(roofline.packed_bound(12, 30, ["x"] * 12, 12, 1, bwd,
                                     2048)[1] == "operations"
               for bwd in (False, True))


@pytest.mark.parametrize("name", ["streamed_roofline_pct",
                                  "packed_roofline_pct"])
def test_roofline_shares_from_a_trace(name):
    """A chain of exactly the least time reads 100%, in whichever cell
    BENCHMARK.json lists the metric."""
    roof = spec.metric_reader(name)
    cfg = {"n_qubits": 12, "n_controls": 24, "n_steps": 30}
    tr = {"grad_mode": "adjoint", "n_seeds": 64}
    least_us = roofline.adjoint_epoch_least_ms(cfg, tr) * 1e3
    ev = [_ev("kernel", "backward_kernel<3, 0>", 0, least_us)]
    data = run_data(tracing.parse(ev), epochs=1, config=cfg, traffic=tr)
    assert roof.read(data) == pytest.approx(100.0)
    data.trace = tracing.parse([_ev("kernel", "adam", 0, 5.0)])
    assert roof.read(data) is None   # no chain kernel in the trace
