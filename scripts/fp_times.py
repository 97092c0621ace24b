"""K1 and K2's times (the streamed-chain pair of csrc/fused_product.cu:
forward and backward) at the main paths' shapes, for one tree of the
port, on a card.

    python3 scripts/fp_times.py [--root DIR] [--label NAME] [--cases TEXT]
                                [--no-steps]

``--root DIR`` takes the port package (``diffquantum_tpu_torch``) from
DIR, a checkout of another commit, so that two commits can be compared
in one run on one card (parent, change, change, parent); the shapes,
inputs, bounds and timing are this checkout's (``CASES`` below, with
``chip_smoke.py``'s inputs, ``chain_bound``, ``one_sm_floor`` and
CUDA-event timing). ``--cases TEXT`` times only the cases whose label
holds TEXT (or one of several, ';'-separated); ``--no-steps`` skips the
grad steps and the host timing. Prints a ``time: fp`` line per case and
direction (ms per launch, ``chain_bound``, the one-SM floor of a member's
chain), the host's time to issue one K1 launch at 12 qubits (the least
over five runs of launches with no sync between them, each direction),
the 12q and 16q/T=1000 adjoint grad steps (``energy_and_grad``), then one
JSON line: ``{"label", "card", "cases": {case: {part: [ms, bound_ms,
bound_by, floor_ms]}}, "host_us": {part: us a launch}, "steps": {step:
ms}}``. Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, qubits, steps, members B (None: K1), angle rows G, plan:
# "ring" MaxCut or chip_smoke's "mixed" X/Y/hop plan, timing iterations)
CASES = (("K1 12q ring, T=30", 12, 30, None, None, "ring", 200),
         ("K1 12q mixed X/Y/hop plan, T=30", 12, 30, None, None, "mixed",
          100),
         ("K1 16q ring, T=1000", 16, 1000, None, None, "ring", 3),
         ("K1 17q ring, T=30", 17, 30, None, None, "ring", 20),
         ("K2 12q ring, T=30, B=64", 12, 30, 64, 64, "ring", 50),
         ("K2 12q ring, T=30, B=288", 12, 30, 288, 288, "ring", 20),
         ("K2 12q ring, T=30, B=3072 on 64 rows", 12, 30, 3072, 64, "ring",
          5),
         ("K2 14q ring, T=30, B=64", 14, 30, 64, 64, "ring", 10),
         ("K2 16q ring, T=30, B=8", 16, 30, 8, 8, "ring", 10),
         ("K2 16q ring, T=30, B=16", 16, 30, 16, 16, "ring", 10),
         ("K2 17q ring, T=30, B=4", 17, 30, 4, 4, "ring", 10))
HOST_CALLS, HOST_RUNS = 200, 5


def case_inputs(cs, n, n_steps, b, rows, drive):
    """(psi CP, theta_half, theta_x, plan, kinds, lambda) of a case, from
    chip_smoke's helpers: K1 [d] tables, K2 [B, d] states on [T, G, ...]
    rows; lambda is the ring MaxCut loss's cotangent (a unit random one
    for the mixed plan)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP
    d = 2**n
    rng = np.random.default_rng(n + n_steps)
    if drive == "ring":
        prob, th, tx, qubits, kinds = cs.maxcut_chain(n, n_steps, seed=n,
                                                      members=rows)
        w = prob.measurement.diag
        psi = prob.psi0 if b is None else cs._random_cp(
            rng, (b, d), 1.0 / np.sqrt(2 * d))
    else:
        th, tx, qubits, kinds = cs.mixed_chain(n, n_steps, seed=n)
        w = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                         device=cs.DEVICE)
        psi = cs._random_cp(rng, (d,) if b is None else (b, d),
                            1.0 / np.sqrt(2 * d))
    plan = tfp._plan_ops(qubits, kinds, n)
    lam = CP(2.0 * w * psi.re, 2.0 * w * psi.im)
    return psi, th, tx, plan, kinds, lam


def case_times(cs, cases):
    """Both directions of K1/K2 (through the wrappers ``_forward_cuda`` /
    ``_backward_cuda``) at ``cases``, each beside ``chain_bound`` and the
    one-SM floor. Returns {label: {part: [ms, bound_ms, bound_by,
    floor_ms]}}."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp

    out = {}
    for label, n, n_steps, b, rows, drive, iters in cases:
        psi, th, tx, plan, kinds, lam = case_inputs(cs, n, n_steps, b, rows,
                                                    drive)
        fwd = lambda: tfp._forward_cuda(  # noqa: E731
            psi.re, psi.im, th, tx, plan, n)
        o_re, o_im = fwd()
        bwd = lambda: tfp._backward_cuda(  # noqa: E731
            o_re, o_im, lam.re, lam.im, th, tx, plan, n)
        res = {}
        for part, fn in (("forward", fwd), ("backward", bwd)):
            backward = part == "backward"
            ms = cs.cuda_ms(fn, iters, warmup=2 if iters > 3 else 1)
            bound = cs.chain_bound(2**n, n_steps, kinds, backward,
                                   b or 1, rows or 1)
            floor = cs.one_sm_floor(2**n, n_steps, kinds, backward)
            cs.log(f"time: fp {label} {part} {ms!r} ms/launch, bound "
                   f"{bound[0]!r} ms ({bound[1]}), one-SM floor {floor!r} "
                   f"ms a member's chain ({floor / ms:.3f} of it)")
            res[part] = [ms, bound[0], bound[1], floor]
        out[label] = res
        del fwd, bwd, o_re, o_im, psi, th, tx, lam
        torch.cuda.empty_cache()
    return out


def host_times(cs):
    """The host's time to issue one K1 launch (12q ring, T=30) through
    ``_forward_cuda`` / ``_backward_cuda``: the wall time of
    ``HOST_CALLS`` launches with no sync between them (the card's queue
    takes them faster than it runs them), in us a launch, the least of
    ``HOST_RUNS`` runs (the host is shared, and its noise only adds)."""
    import time

    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp

    psi, th, tx, plan, _, lam = case_inputs(cs, 12, 30, None, None, "ring")
    o_re, o_im = tfp._forward_cuda(psi.re, psi.im, th, tx, plan, 12)
    out = {}
    for part, fn in (
            ("forward", lambda: tfp._forward_cuda(
                psi.re, psi.im, th, tx, plan, 12)),
            ("backward", lambda: tfp._backward_cuda(
                o_re, o_im, lam.re, lam.im, th, tx, plan, 12))):
        runs = []
        for _ in range(HOST_RUNS):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            runs.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        cs.log(f"time: fp host K1 12q {part} {min(runs)!r} us a launch "
               f"(least of {runs!r}: {HOST_CALLS} launches, no sync)")
        out[part] = min(runs)
    return out


def step_times(cs):
    """The 12q and 16q/T=1000 adjoint grad steps through
    ``energy_and_grad`` (CUDA events over chained calls)."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import maxcut

    out = {}
    rng = np.random.default_rng(0)
    for nq, n_steps, iters in ((12, 30, 100), (16, 1000, 3)):
        p = maxcut.build_maxcut(nq, maxcut.ring_graph(nq), n_basis=6,
                                device=cs.DEVICE)
        c = torch.tensor(1e-3 * rng.standard_normal(p.envelope.coeff_shape),
                         dtype=torch.float32, device=cs.DEVICE)
        ms = cs.cuda_ms(lambda: energy_and_grad(  # noqa: B023
            p.ham, p.envelope, p.measurement, c, p.psi0, p.T, n_steps),
            iters, 3 if nq == 12 else 1)
        label = f"{nq}q {n_steps}-step adjoint grad step"
        cs.log(f"time: fp {label} {ms!r} ms")
        out[label] = ms
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--cases", default="")
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("fp_times: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    # this checkout's chip_smoke.py, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import diffquantum_tpu_torch
    cs.log(f"fp_times [{args.label}]: port package from "
           f"{os.path.dirname(diffquantum_tpu_torch.__file__)}")
    keys = args.cases.split(";")
    cases = tuple(c for c in CASES if any(key in c[0] for key in keys))
    times = case_times(cs, cases)
    host = {} if args.no_steps else host_times(cs)
    steps = {} if args.no_steps else step_times(cs)
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "cases": times, "host_us": host, "steps": steps}),
          flush=True)


if __name__ == "__main__":
    main()
