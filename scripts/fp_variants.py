"""What bounds K1 and K2: copies of csrc/fused_product.cu with one part
taken out (or another register cap), each built with ops/_build.py's
flags and timed at the main paths' shapes, on a card; and the source as
it is under another launch plan.

    python3 scripts/fp_variants.py [--cases TEXT] [--only NAME ...]

Each variant of ``VARIANTS`` replaces text of the source (a variant fails
if its text is missing); each of ``PLANS`` runs the source as it is with
every member block at 2^r amplitudes a thread (r = 3 or 4 wherever one
block a member fits, else the grid at r = 3), in place of ``fp_plan``'s
choice of r. A copy with a part taken out computes
something else: its time says what that part costs, not a result. The
copies go to ``build/fp_variants/`` (git-ignored). Prints each
variant's ``-Xptxas -v`` spill lines and a ``time: variant`` line per
case and direction (ms per launch), then one JSON line ``{"card",
"variants": {name: {case: {part: ms}}}}``. The cases are
``scripts/fp_times.py``'s (default: K1 12q, K2 B=288 and B=3072). Needs
a CUDA card and nvcc; imports nothing of JAX.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "diffquantum_tpu_torch", "csrc",
                      "fused_product.cu")
OUT = os.path.join(ROOT, "build", "fp_variants")

_FWD_OPS = ("for (int o = sh.rounds[r].begin; o < end; ++o) "
            "apply<R, 2>(x, sh, sm.cst, o);")
_BWD_OPS = "warp_sum(apply<R, 4>(x, sh, sm.cst, o));"
_PHASE = "sincosf(merged_angle(sm, k, p.T, i), &s, &c);"
_BOUND = "return bwd ? 512 : R == 3 ? 1024 : 768;"
# name -> [(text, replacement)]
VARIANTS = {
    "all": [],
    "no ops": [(_FWD_OPS, ";"), (_BWD_OPS, "0.f;")],
    "no exchanges": [
        ("exchange<R, MODE, 2>(x, sh, sm.wbase, cur, r, dyn, p, xc);", ";"),
        ("exchange<R, MODE, 4>(x, sh, sm.wbase, cur, r, dyn, p, xc);", ";")],
    "no forward phase": [(_PHASE, "s = 0.f; c = 1.f;")],
    "no forward phase sincos": [
        (_PHASE, "s = merged_angle(sm, k, p.T, i); c = 1.f;")],
    "no angles": [("warp_angles(sm, p);", ";")],
    "forward r=4 at 96 registers": [
        (_BOUND, "return bwd ? 512 : R == 3 ? 1024 : 640;")],
    "forward r=4 at 128 registers": [
        (_BOUND, "return bwd ? 512 : R == 3 ? 1024 : 512;")],
}
PLANS = {"plan r=3": 3, "plan r=4": 4}
DEFAULT_CASES = "K1 12q ring;B=288;B=3072"


def forced_plan(tfp, rbits, own):
    """``fp_plan`` with one block a member at r = ``rbits`` wherever it
    fits, else ``own``'s (``fp_plan``'s) choice."""
    def plan(n, ops, members=1, groups=1, sm_count=None, backward=False):
        try:
            return tfp._fp_geometry(n, ops, members, groups,
                                    sm_count or tfp.H100_SMS, backward,
                                    "block", rbits)
        except ValueError:
            return own(n, ops, members, groups, sm_count, backward)
    return plan


def build(variants):
    """{name: (library path, spill lines)}, one nvcc per variant, all
    started together."""
    from diffquantum_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    src = open(SOURCE).read()
    procs = {}
    for i, name in enumerate(variants):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                sys.exit(f"fp_variants: {name!r}: text not in the source: "
                         f"{old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libv{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"fp_variants: nvcc failed for {name!r}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        out[name] = (lib, spills)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=DEFAULT_CASES)
    ap.add_argument("--only", nargs="*", default=[*VARIANTS, *PLANS])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("fp_variants: no CUDA device is available")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "fp_times", os.path.join(ROOT, "scripts", "fp_times.py"))
    ft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ft)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from diffquantum_tpu_torch.ops import _build
    from diffquantum_tpu_torch.ops import fused_product as tfp
    keys = args.cases.split(";")
    cases = tuple(c for c in ft.CASES if any(k in c[0] for k in keys))
    libs = build([v for v in args.only if v in VARIANTS])
    own_plan = tfp.fp_plan
    result = {}
    for name in args.only:
        if name in PLANS:
            tfp.fp_plan = forced_plan(tfp, PLANS[name], own_plan)
            _build._LIBS.pop("fused_product", None)
        else:
            lib, spills = libs[name]
            cs.log(f"variant [{name}]: spills "
                   f"{[s.split(',')[1].strip() for s in spills]} (the "
                   f"kernels in nvcc's order)")
            tfp.fp_plan = own_plan
            _build._LIBS["fused_product"] = ctypes.CDLL(lib)
        tfp._FP_RECORDS.clear()
        times = ft.case_times(cs, cases)
        result[name] = {c: {part: v[0] for part, v in parts.items()}
                        for c, parts in times.items()}
        for c, parts in result[name].items():
            cs.log(f"time: variant [{name}] {c}: forward "
                   f"{parts['forward']!r} ms, backward "
                   f"{parts['backward']!r} ms")
    print(json.dumps({"card": cs.card_line(), "variants": result}),
          flush=True)


if __name__ == "__main__":
    main()
