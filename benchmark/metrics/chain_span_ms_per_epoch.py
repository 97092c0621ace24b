"""chain_span_ms_per_epoch: the device ms of the program's ``chain.fwd``
and ``chain.bwd`` spans (each one chain kernel's launch, K1-K7, from a
CUDA event before it to one after it on the current stream) over the
traced window's epochs. Read from the program's tracer
(harness/program_spans.py); the kernel names of chain_kernels/*.txt are
not needed."""
from harness import program_spans

UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "chain kernels", "epoch_ms", None


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(
        program_spans.device_ms(win, program_spans.CHAIN_SPANS), run)
