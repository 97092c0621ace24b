"""chain_ms_per_epoch: device time of the Strang-chain kernels (every
kernel whose name holds a line of chain_kernels/*.txt: K1/K2 at 12
qubits, the K3-K6 pass pair at 20) over the traced window's epochs."""
UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "chain kernels", "epoch_ms", None


def read(run):
    if run.trace is None or not run.epochs:
        return None
    ms = run.trace.ms_matching(run.chain_patterns)
    return ms / run.epochs if ms > 0 else None
