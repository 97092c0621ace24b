"""grad_glue_ms_per_epoch: the device self time of the program's
``train.grad`` spans, each one's device ms less that of its child spans
(``chain.*``, and the MC legs' ``pulse.chain_inputs``), over the traced
window's epochs. In the adjoint: the objective's, phase tables' and
envelope's backward; in MC: the gates, the branch measurement and the
envelope's sensitivity."""
from harness import program_spans

UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "glue on the device", "epoch_ms", None


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(
        program_spans.self_device_ms(win, "train.grad"), run)
