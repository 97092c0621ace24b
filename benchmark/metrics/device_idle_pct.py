"""device_idle_pct: the share of the traced window in which the card runs
no kernel, copy or fill (the union of the trace's device operations)."""
UNIT, SOURCE, BETTER = "%", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "device", "epoch_ms", None


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
