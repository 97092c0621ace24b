"""device_ops_per_epoch: device kernels, copies and fills in the traced
window over its epochs: what the trainer and the host side of the
evolution issue an epoch."""
UNIT, SOURCE, BETTER = "ops", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "trainer and host issue", "epoch_ms", None


def read(run):
    if run.trace is None or not run.epochs:
        return None
    return len(run.trace.ops) / run.epochs
