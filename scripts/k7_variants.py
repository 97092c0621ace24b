"""Where K7's block-resident configuration stops beating the row-split
one: both forced at the same shapes around ``k7_plan``'s threshold
(``ops/taylor_apply.py::BLOCK_MAX_D``), on a card.

    python3 scripts/k7_variants.py [--ds 16,32,48,64,65,80,96] [--bs 5,16]

Inputs are chip_smoke.py's ``_hermitian_inputs`` (a random Hermitian H,
z = -0.31 i). For each (d, B) and configuration: forward and backward ms
per launch (CUDA events), the forward's max abs error and the backward's
largest relative error against the plain versions; one JSON line per
shape, then the card's name and power limit. Needs a CUDA card; imports
nothing of JAX.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ds", default="16,32,48,64,65,80,96")
    ap.add_argument("--bs", default="5,16")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k7_variants: no CUDA device is available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from diffquantum_tpu_torch.ops import taylor_apply as ta
    threshold = ta.BLOCK_MAX_D

    def timed(h, psi, g, zs, order, sub, ref):
        fwd = lambda: ta._forward_cuda(  # noqa: E731
            h.re, h.im, psi.re, psi.im, zs, order, sub)
        bwd = lambda: ta._backward_cuda(  # noqa: E731
            h.re, h.im, psi.re, psi.im, g.re, g.im, zs, order, sub)
        err = float((fwd()[0] - ref[0].re).abs().max())
        rels = [cs.rel_err(a, b) for a, b in zip(bwd(), ref[1])]
        return {"fwd_ms": cs.cuda_ms(fwd, 20, 2),
                "bwd_ms": cs.cuda_ms(bwd, 20, 2), "fwd_err": err,
                "bwd_rel_err": max(rels)}

    def plain(h, psi, g, zs, order, sub):
        gh, gp = ta.taylor_apply_backward_plain(h, psi, g, zs, order, sub)
        return (ta.taylor_apply_plain(h, psi, zs, order, sub),
                (gh.re, gh.im, gp.re, gp.im))

    try:
        for d in map(int, args.ds.split(",")):
            for b in map(int, args.bs.split(",")):
                inputs = cs._hermitian_inputs(d, b, d)
                ref = plain(*inputs)
                row = {"d": d, "B": b, "order": inputs[4],
                       "substeps": inputs[5]}
                for config, cut in (("block", 1024), ("rows", 0)):
                    ta.BLOCK_MAX_D = cut
                    row[config] = timed(*inputs, ref)
                print(json.dumps(row), flush=True)
    finally:
        ta.BLOCK_MAX_D = threshold
    print(cs.card_line())


if __name__ == "__main__":
    main()
