"""streamed_roofline_pct: the least time the card could take for one
adjoint epoch's Strang chain (forward and backward over the population),
counted from the problem's shapes by harness/roofline.py, over the time
of the chain kernels (chain_ms_per_epoch's) in a cell on the streamed
engine (K1/K2). BENCHMARK.json's entry lists the cells."""
from harness import roofline

UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "chain kernels", "epoch_ms"
WORKLOADS = ("maxcut_ring12.seeds2048",)


def read(run):
    return roofline.share_pct(run)
