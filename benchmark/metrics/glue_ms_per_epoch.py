"""glue_ms_per_epoch: device time of everything that is not a chain kernel
(envelope, phase tables, MC gates and measurement, loss, Adam, copies)
over the traced window's epochs."""
UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "glue on the device", "epoch_ms", None


def read(run):
    if run.trace is None or not run.epochs:
        return None
    return run.trace.ms_matching(run.chain_patterns, False) / run.epochs
