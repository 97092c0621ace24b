"""The packed-phase pass pair's times (K3, K4, K5, K6: forward and
backward chains) at every shape chip_smoke.py times it, for one tree of
the port, on a card.

    python3 scripts/pk_times.py [--root DIR] [--label NAME] [--passes 2]
                                [--lib PATH ...] [--cases TEXT]

``--root DIR`` takes the port package (``diffquantum_tpu_torch``) from
DIR, a checkout of another commit, so that two commits can be compared
in one run on one card (parent, change, change, parent); the shapes,
inputs, bounds and timing are this checkout's (``CASES`` below, with
``chip_smoke.py``'s inputs, ``packed_bound`` and CUDA-event timing).
``--passes 2`` holds this tree's plan to two passes a step
(``PK_PASSES``); ``--lib PATH ...`` then times, in turn, libraries built
from other copies of ``csrc/packed_phase.cu`` (with ``ops/_build.py``'s
flags: copies with a part removed, to see what bounds the pair);
``--cases TEXT`` times only the cases whose label holds TEXT (or one of
several, ';'-separated). Prints a ``time: pk`` line per case and
direction (ms per chain, ``packed_bound``, the two-pass floor, the HBM
rate the planned passes reach), then one JSON line: ``{"label", "card",
"cases": {case: {part: [ms, bound_ms, bound_by, floor_ms, GB/s]}},
"libs": {path: cases}}``. Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the pair's timed shapes: (label, kernel, qubits, steps, members B or
# None, drive set: "ring" MaxCut or "molecule" hops, timing iterations)
CASES = (("K3 18q ring, T=30", "K3", 18, 30, None, "ring", 50),
         ("K5 19q ring, T=30", "K5", 19, 30, None, "ring", 20),
         ("K5 20q ring, T=30", "K5", 20, 30, None, "ring", 20),
         ("K5 20q ring, T=30, B=8", "K5", 20, 30, 8, "ring", 10),
         # the 20q MaxCut cells' batches: the seed population and the MC
         # estimator's 80 branches
         ("K5 20q ring, T=30, B=16", "K5", 20, 30, 16, "ring", 10),
         ("K5 20q ring, T=100, B=80", "K5", 20, 100, 80, "ring", 3),
         ("K5 24q ring, T=30", "K5", 24, 30, None, "ring", 5),
         ("K4 24q ring, T=1", "K4", 24, 1, None, "ring", 30),
         ("K6 20q molecule set, T=30", "K6", 20, 30, None, "molecule", 10),
         ("K6 20q molecule set, T=30, B=4", "K6", 20, 30, 4, "molecule",
          3),
         ("K6 24q molecule set, T=30", "K6", 24, 30, None, "molecule", 2))


def two_pass_floor(cs, n, n_steps, backward, members=1):
    """The least time of a chain whose every step reads and writes the
    whole state twice (a tile and a strided pass: 2 x 16 bytes an
    amplitude forward, 2 x 32 backward), at the card's HBM rate: what a
    two-pass design can reach while the state does not fit L2."""
    per_amp = 32 if backward else 16
    return 2 * per_amp * members * 2**n * n_steps / cs.HBM_BYTES_PER_S \
        * 1e3


def case_times(cs, cases):
    """Both directions of the pass pair (through the wrappers
    ``_packed_forward_cuda`` / ``_packed_backward_cuda``) at ``cases``,
    each beside ``packed_bound``, ``two_pass_floor`` and the HBM rate its
    passes reach (the state through every planned pass, the tile pass's
    sign planes and a drift: bytes over time). Returns {label: {part:
    [ms, bound_ms, bound_by, floor_ms, GB/s]}}."""
    import torch
    from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    out = {}
    for label, what, n, n_steps, b, drive, iters in cases:
        members = b or 1
        if drive == "ring":
            prob = cs.frontier_problem(n)
            _, ud, tx, h0th, signs, qubits, kinds = cs.packed_inputs(
                prob, n_steps, n, b)
            plan = tfp._packed_plan(qubits, kinds, n)
            psi = CP(prob.psi0.re.expand(members, -1).contiguous(),
                     prob.psi0.im.expand(members, -1).contiguous())
            w = prob.measurement.diag
            n_x, row_kinds = len(kinds), kinds
        else:
            psi, ud, tx, h0th, signs, pos, kinds = cs.hop_kernel_inputs(
                n, n_steps, n, b)
            plan = tmh._hop_plan(pos, kinds, n)
            if b is None:
                psi = CP(psi.re[None], psi.im[None])
            w = cs.card_weights(2**n, n)
            n_x = len(pos)
            row_kinds = [kinds[int(r[0])] for r in plan]
        if b is None:
            ud, tx = ud[:, None].contiguous(), tx[:, None].contiguous()
        udm = tfp.merge_ud_rows(ud)
        n_diag = ud.shape[2] - 1
        fwd = lambda: tfp._packed_forward_cuda(  # noqa: E731
            psi.re, psi.im, udm, tx, h0th, signs, plan, n, what)
        o_re, o_im = fwd()
        lam = CP(2.0 * w * o_re, 2.0 * w * o_im)
        bwd = lambda: tfp._packed_backward_cuda(  # noqa: E731
            o_re, o_im, lam.re, lam.im, udm, tx, h0th, signs, plan, n, what)
        key = tuple(map(tuple, plan.tolist()))
        res = {}
        for part, fn, planes in (("forward", fwd, 2), ("backward", bwd, 4)):
            n_pass = len(tfp._pass_layout(key, n, planes, n_diag, n_x)[2])
            ms = cs.cuda_ms(fn, iters, warmup=2)
            bound = cs.packed_bound(n, n_steps, row_kinds, n_diag,
                                    signs.shape[0], part == "backward",
                                    members, n_x=n_x)
            floor = two_pass_floor(cs, n, n_steps, part == "backward",
                                   members)
            drift = float(torch.count_nonzero(h0th)) > 0
            moved = members * 2**n * (
                8 * planes * (n_steps * n_pass + 1)
                + 4 * (-(-n_diag // 30) + drift) * (n_steps + 1))
            gbs = moved / ms / 1e6
            cs.log(f"time: pk {label} {part} {ms!r} ms/chain, bound "
                   f"{bound[0]!r} ms ({bound[1]}), two-pass floor {floor!r} "
                   f"ms ({100 * floor / ms:.1f}% of the time), {n_pass} "
                   f"passes a step, {gbs!r} GB/s of HBM traffic "
                   f"({100 * gbs / (cs.HBM_BYTES_PER_S / 1e9):.1f}% of "
                   f"3.35 TB/s)")
            res[part] = [ms, bound[0], bound[1], floor, gbs]
        out[label] = res
        del fwd, bwd, o_re, o_im, lam, psi, ud, tx, udm, h0th, signs
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--passes", default=None)
    ap.add_argument("--lib", nargs="*", default=[])
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("pk_times: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    # this checkout's chip_smoke.py, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import diffquantum_tpu_torch
    from diffquantum_tpu_torch.ops import _build
    from diffquantum_tpu_torch.ops import fused_product as tfp
    cs.log(f"pk_times [{args.label}]: port package from "
           f"{os.path.dirname(diffquantum_tpu_torch.__file__)}")
    if args.passes:
        tfp.PK_PASSES = tuple(int(p) for p in args.passes.split(","))
    keys = args.cases.split(";")
    cases = tuple(c for c in CASES if any(key in c[0] for key in keys))
    times = case_times(cs, cases)
    libs = {}
    for path in args.lib:
        import ctypes
        cs.log(f"pk_times [{args.label}]: library {path}")
        _build._LIBS["packed_phase"] = ctypes.CDLL(os.path.abspath(path))
        libs[path] = case_times(cs, cases)
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "cases": times, "libs": libs}), flush=True)


if __name__ == "__main__":
    main()
