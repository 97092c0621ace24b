"""Where the time of the port's 12-qubit MaxCut grad step goes, on a card.

    python3 scripts/profile_torch_step.py [--steps 50]

Runs ``diffquantum_tpu_torch.gradients.adjoint.energy_and_grad`` on the
12-qubit ring MaxCut (30 Strang steps, the fused K1 engine) under
``torch.profiler`` and prints: the card's name and power limit, the wall
time per step, the device time per step by kernel (largest first), the
number of kernel launches per step, and the device's busy and idle share
of the profiled window. The profiler slows the host, so it then times the
same steps with the profiler off and prints the idle share that the
profiled device time leaves in that window: an estimate from two windows,
labelled so. Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import maxcut

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    prob = maxcut.build_maxcut(12, maxcut.ring_graph(12), n_basis=6)
    coeff = torch.tensor(1e-3 * np.random.default_rng(0).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device="cuda")

    def step():
        return energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                               coeff, prob.psi0, prob.T, 30)

    for _ in range(20):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: kernels, copies, memsets
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    n = args.steps
    print(f"wall per step {wall_ms / n!r} ms over {n} profiled steps "
          "(profiler on)")
    print(f"device busy per step {busy_ms / n!r} ms; busy share "
          f"{busy_ms / wall_ms!r}, idle share {1 - busy_ms / wall_ms!r}")
    launches = sum(r[1] for r in rows if r[1]) / n
    print(f"device ops (kernels, copies, memsets) per step {launches!r}")
    print("device time per step by name (us, calls per step, name):")
    for dev_us, count, key in rows[:20]:
        print(f"  {dev_us / n:10.3f}  {count / n:6.2f}  {key[:90]}")
    if not rows:
        print("the profiler recorded no device time")

    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    off_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"wall per step {off_ms!r} ms over {n} steps (profiler off); "
          f"idle share estimated from the two windows (profiled device "
          f"busy over this wall) {1 - busy_ms / n / off_ms!r}")


if __name__ == "__main__":
    main()
