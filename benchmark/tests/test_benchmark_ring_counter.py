"""pk_ring_passes_per_epoch on a synthetic store of the program's tracer:
the window's pk_forward_ring increase over its epochs, and None where the
program has no such counter (a commit before it) or no tracer at all."""
import types

import pytest

from harness import spec
from harness.runner import RunData

NAME = "pk_ring_passes_per_epoch"


def _tracer(counters):
    win = types.SimpleNamespace(spans=[], counters=counters)
    return types.SimpleNamespace(window=lambda: win, host_spans=dict)


def _run(epochs=2):
    return RunData("t", {}, {}, 1.0, 0.1, epochs, [1.0], {}, None, ())


@pytest.mark.parametrize("counters,want", [
    # the mc1 epoch's three chains: 201 + 201 + 61, twice
    ({"pk_forward_ring": 926, "k5_forward": 6}, 463.0),
    ({"k5_forward": 6}, None),   # a program without the counter
    ({}, None)])
def test_the_ring_counter_per_epoch(counters, want):
    got = spec.metric_reader(NAME).read(_run(), tracer=_tracer(counters))
    assert got == (pytest.approx(want) if want is not None else None)


def test_no_tracer_reads_none():
    assert spec.metric_reader(NAME).read(
        _run(), tracer=types.SimpleNamespace()) is None


def test_the_entry_names_the_ring20_cells():
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[NAME]
    assert entry["workloads"] == ["maxcut_ring20.seeds16",
                                  "maxcut_ring20.mc1"]
    assert spec.find_cell("maxcut_ring20.mc1").per_layer[-1]["name"] == NAME
    assert NAME not in {m["name"] for m in spec.find_cell(
        "maxcut_ring12.seeds2048").per_layer}


def test_the_ring_kernel_is_a_chain_kernel():
    """The forward passes on the TMA ring count in chain_ms_per_epoch and
    the packed roofline's time, as the pass pair's other kernels do."""
    assert "pass_ring<" in spec.chain_kernel_patterns()
