"""epoch_ms_p95: the 95th percentile, over all the window's epochs, of the
time between consecutive post-step CUDA events on the device's timeline
(the first from an event recorded at the window's start). An interval
holds any idle gap of the device and the boundary between jobs."""
import numpy as np

UNIT, SOURCE, BETTER = "ms", "device_trace", "lower"
LAYER, MOVES, WORKLOADS = "end to end", None, None


def read(run):
    if not run.intervals_ms:
        return None
    return float(np.percentile(np.asarray(run.intervals_ms), 95.0))
