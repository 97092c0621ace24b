"""pulse_ms_per_epoch: the device ms of the program's
``pulse.chain_inputs`` spans (dynamics/product.py's fused_chain_inputs
and packed_chain_inputs: the envelope's values to the chain's phase and
angle tables, every chain's, the MC legs' too) over the traced window's
epochs."""
from harness import program_spans

UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "glue on the device", "epoch_ms", None


def read(run, tracer=None):
    win = program_spans.window(tracer)
    if win is None:
        return None
    return program_spans.per_epoch(
        program_spans.device_ms(win, ("pulse.chain_inputs",)), run)
