"""K7's times at every shape of chip_smoke.py's ``dense_kernel_cases``,
and the dense paths' times, for one tree of the port, on a card.

    python3 scripts/k7_times.py [--root DIR] [--label NAME] [--no-paths]

``--root DIR`` takes the port package (``diffquantum_tpu_torch``) from
DIR, a checkout of another commit, so that two commits can be compared
in one run on one card (parent, change, change, parent); the shapes,
inputs, bounds and timing are this checkout's ``chip_smoke.py``
(``k7_case_times``, ``dense_path_times``). Prints chip_smoke's ``time:``
lines, then one JSON line: ``{"label", "card", "cases": {case: {part:
[ms, plain_ms, bound_ms, bound_by, library_ms]}}, "paths": {name: ms}}``.
Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--no-paths", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k7_times: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    # this checkout's chip_smoke.py, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import diffquantum_tpu_torch
    cs.log(f"k7_times [{args.label}]: port package from "
           f"{os.path.dirname(diffquantum_tpu_torch.__file__)}")
    cases = cs.k7_case_times(cs.dense_kernel_cases())
    paths = {} if args.no_paths else cs.dense_path_times()
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "cases": cases, "paths": paths}), flush=True)


if __name__ == "__main__":
    main()
