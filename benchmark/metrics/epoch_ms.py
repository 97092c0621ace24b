"""epoch_ms: the host's wall time of the whole measured window, which ends
in torch.cuda.synchronize(), over all the epochs completed in it."""
UNIT, SOURCE, BETTER = "ms", "host_clock", "lower"
LAYER, MOVES, WORKLOADS = "end to end", None, None


def read(run):
    return run.window_s * 1e3 / run.epochs if run.epochs else None
