"""pk_ring_passes_per_epoch: the increase in the traced window of the
program's ``pk_forward_ring`` launch counter (the K3-K6 forward passes
that ran on the pass pair's TMA ring), over the window's epochs: an exact
count, 2T + 1 a forward chain of T steps at 20 qubits. A program without
that counter reads None."""
from harness import program_spans

UNIT, SOURCE, BETTER = "passes", "program_counter", "higher"
LAYER, MOVES = "chain kernels", "epoch_ms"
WORKLOADS = ("maxcut_ring20.seeds16", "maxcut_ring20.mc1")
COUNTER = "pk_forward_ring"


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(win.counters.get(COUNTER) or None, run)
