"""setup_s: from the process's start to the first timed epoch: imports,
loading the kernels from the checkout's build/ cache (building them on a
checkout's first run), the problem's build and the warm-up job."""
UNIT, SOURCE, BETTER = "s", "host_clock", "lower"
LAYER, MOVES, WORKLOADS = "end to end", None, None


def read(run):
    return run.setup_s
