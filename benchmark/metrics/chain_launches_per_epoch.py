"""chain_launches_per_epoch: the increase in the traced window of the
program's launch counters of the chain kernel families, ``k1_forward``
... ``k7_backward`` (not the ``*_batched_*`` subsets, which count again
chains already counted), over the window's epochs: an exact count."""
from harness import program_spans

UNIT, SOURCE, BETTER = "ops", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "chain kernels", "epoch_ms", None


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(program_spans.chain_launches(win), run)
