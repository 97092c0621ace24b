"""optim_ms_per_epoch: the device ms of the program's ``train.optim``
spans (``opt.step()``: Adam's update, the lr schedule's hook and the
harness's post-step hook) over the traced window's epochs."""
from harness import program_spans

UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "glue on the device", "epoch_ms", None


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(
        program_spans.device_ms(win, ("train.optim",)), run)
