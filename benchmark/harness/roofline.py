"""The least time of a Strang chain, counted from the problem's own
shapes, whatever kernel carries it: the roofline metrics' yardstick.

The least time is the larger of the bytes over 3.35 TB/s and the fp32
operations over 67 TFLOP/s, the published peaks of one H100 SXM at 700 W
(a run prints the card's power limit beside its numbers). The count is a
frozen copy of chip_smoke.py's ``packed_bound``: each input of the
problem read once and each output written once (the state, its
cotangent, the coefficient rows, the drift and the diagonal terms' sign
planes), and the operations that the chain needs per amplitude and
stage. It counts no table of any engine's plan, such as the streamed
engine's [T, B, d] phase rows.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PLANE_BITS = 30     # sign bits per int32 plane of the diagonal terms


def _rot_pairs(kinds, d):
    return sum(d // 4 if k == "hop" else d // 2 for k in kinds)


def packed_bound(n, n_steps, kinds, n_diag, n_planes, backward, members=1,
                 n_x=None):
    """(bound_ms, bound_by) of one chain over ``members`` states: each
    input read once and each output written once (the state, its
    cotangent, the rows, h0th and the sign planes), and the fp32
    operations the function needs per amplitude and stage: the angle from
    its rows (2 per diagonal term, 2 for the drift and offset), sin and
    cos (one each), the phase (6; backward 12 for y and lambda, 4 for g =
    dL/d angle and S0, 2 per term for S_k), and per op pair the rotation
    (12; backward 32). ``kinds`` are the kinds of one step's op rows and
    ``n_x`` the angle slots a step reads (default: one per row)."""
    d, T = 2**n, n_steps
    pairs = _rot_pairs(kinds, d)
    n_x = len(kinds) if n_x is None else n_x
    rows = members * ((T + 1) * (n_diag + 2) + T * n_x)
    nbytes = 4 * d * (1 + n_planes) + 4 * rows
    angle = 2 * n_diag + 2 + 2
    if not backward:
        nbytes += 16 * d * members
        ops = members * ((T + 1) * d * (angle + 6) + T * 12 * pairs)
    else:
        nbytes += 24 * d * members + 4 * rows
        ops = members * ((T + 1) * d * (angle + 16 + 2 * n_diag)
                         + T * 32 * pairs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adjoint_epoch_least_ms(config: dict, traffic: dict) -> float:
    """Forward plus backward least time of one adjoint epoch of the
    population: an X op a qubit, a diagonal term for each other control
    (an edge of the MaxCut graph)."""
    n, b = int(config["n_qubits"]), int(traffic["n_seeds"])
    n_diag = int(config["n_controls"]) - n
    planes = -(-n_diag // PLANE_BITS)
    return sum(packed_bound(n, int(config["n_steps"]), ["x"] * n, n_diag,
                            planes, bwd, members=b)[0]
               for bwd in (False, True))


def share_pct(run) -> float | None:
    """100 x the least time of the traced window's adjoint epochs over the
    time of its chain kernels; None where the trace holds none."""
    if run.trace is None or not run.epochs:
        return None
    ms = run.trace.ms_matching(run.chain_patterns)
    if ms <= 0:
        return None
    return 100.0 * adjoint_epoch_least_ms(run.config, run.traffic) \
        / (ms / run.epochs)
