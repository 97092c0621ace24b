"""Where the time of the port's paths goes, on a card.

    python3 scripts/profile_torch_step.py [--steps 50]
        [--path grad|seeds|mc|mc_seeds|fd|grad18|grad20|grad24|grad20hop|
                grad10dense|demo_mc|tfim12|tfim20|mc20|mol12|mol20|mcwf16|
                lindblad12|all]

Paths (the ring MaxCut, n_basis 6, 30 Strang steps; 12 qubits unless
named):
  grad      one ``energy_and_grad`` call (K1 forward and adjoint);
  seeds     one adjoint epoch of ``train_energy_seeds`` over 64 seeds (K2);
  mc        one ``mc_energy_grad`` sample, 30 steps per leg (K1, K2);
  mc_seeds  one MC epoch of ``train_energy_seeds`` over 64 seeds (K2);
  fd        one ``fd_energy_grad`` call, 288 perturbed sets (K2);
  grad18    one ``energy_and_grad`` call at 18 qubits (K3);
  grad20    the same at 20 qubits (K5);
  grad24    the same at 24 qubits (K5);
  grad20hop one ``energy_and_grad`` call on the 20-qubit molecule drive
            set (X and Y on every qubit, hops and ZZ on the pairs (i, i+1)
            and (i, i+2), n_basis 4; chip_smoke.py's ``hop_problem``): K6;
  grad10dense one ``energy_and_grad`` call on the 10-qubit dense ring
            MaxCut ('apply': 30 K7 forward and 30 backward launches);
  demo_mc   one MC epoch of ``train_energy`` on the 4-qubit demo ring,
            dense, 100 steps per leg (K7 on the 16 branches);
  tfim12    one ``energy_and_grad`` call on the 12-qubit TFIM (23 Pauli
            strings measured matrix-free, n_basis 6, 30 steps): K1;
  tfim20    the same at 20 qubits (39 strings): K5;
  mc20      one ``mc_energy_grad`` sample of the 20-qubit ring at a fixed
            split time (K5 to s, one batched K5 launch over 80 branches);
  mol12     one ``energy_and_grad`` call on the H6 chain (12 qubits, 919
            Pauli strings, 66 drives, T 5, n_basis 8, 60 steps,
            ``t_sample='mid'``; chip_smoke.py's ``molecule_chain``): K1;
  mol20     the same on the H10 chain (20 qubits, 7151 strings, 114
            drives, 60 steps): K6 (about a second a step: use --steps 5);
  mcwf16    one value and gradient of ``score_surrogate`` over
            ``evolve_mcwf_structured(backend='fused')`` on the 16-qubit
            ring (n_basis 4, T1 0.1 on every qubit, 8 trajectories, 10
            steps, fresh draws each step): K2 forward and adjoint, one
            launch each a step (the JAX demo's ``--mcwf-scale 16`` epoch
            without the optimizer's update);
  lindblad12 one value and gradient of ``evolve_lindblad_structured`` on
            chip_smoke.py's ``open_structured_problem`` at 12 qubits (rho
            2 x 2^24 floats, T 0.8, 8 steps): no kernel.
A problem is built only for the paths asked for (the 24-qubit one takes
the host tens of seconds).
For each it runs the steps under ``torch.profiler`` and prints: the wall
time per step, the device time per step by kernel (largest first), the
number of device ops per step, the device's busy and idle share of
the profiled window, and the program's own spans (``utils.profiling``:
per span name its count, host ms and device ms a step, and its self
device ms, less its child spans'). The profiler slows the host, so it
then times the same steps with the profiler off and prints the idle
share that the profiled device time leaves in that window: an estimate
from two windows, labelled so. The epoch paths run their steps as one call of
``n_epoch = steps`` (one set-up per window). Needs a CUDA card; imports
nothing of JAX.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("grad", "seeds", "mc", "mc_seeds", "fd", "grad18", "grad20",
         "grad24", "grad20hop", "grad10dense", "demo_mc", "tfim12", "tfim20",
         "mc20", "mol12", "mol20", "mcwf16", "lindblad12")


def make_run(name):
    """run(k), running k steps of the path ``name``."""
    import torch

    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.fd import fd_energy_grad
    from diffquantum_tpu_torch.gradients.mc import mc_energy_grad
    from diffquantum_tpu_torch.models import maxcut, tfim
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    def loop(fn):
        def run(k):
            for _ in range(k):
                fn()
        return run

    if name == "grad20hop":
        from chip_smoke import hop_problem
        hop = hop_problem(20)
        return loop(lambda: energy_and_grad(
            hop.ham, hop.envelope, hop.measurement, hop.coeff, hop.psi0,
            hop.T, 30))
    if name.startswith("mol"):
        from chip_smoke import _coeff, molecule_chain
        from diffquantum_tpu_torch.dynamics.propagator import \
            reference_n_steps
        atoms = int(name[3:]) // 2
        mol, _ = molecule_chain(atoms)
        mc = _coeff(mol.envelope.coeff_shape, atoms, scale=0.3)
        ms = reference_n_steps(10, 0.0, mol.T)
        return loop(lambda: energy_and_grad(
            mol.ham, mol.envelope, mol.measurement, mc, mol.psi0, mol.T, ms,
            t_sample="mid"))
    if name == "mcwf16":
        from chip_smoke import _coeff
        from diffquantum_tpu_torch.dynamics.lindblad import (
            StructuredNoise, evolve_mcwf_structured, score_surrogate)
        prob = maxcut.build_maxcut(16, maxcut.ring_graph(16), n_basis=4,
                                   dense=False)
        noise = StructuredNoise(16, t1=[(q, 0.1) for q in range(16)])
        cc = _coeff(prob.envelope.coeff_shape, 16, scale=0.3)
        cc.requires_grad_(True)
        gen = torch.Generator(device="cuda").manual_seed(7)

        def mcwf_step():
            psis, logps = evolve_mcwf_structured(
                prob.ham, prob.envelope, cc, prob.psi0, noise, 0.0, prob.T,
                horizon=prob.T, n_steps=10, generator=gen, n_traj=8,
                return_logp=True, backend="fused")
            vals = torch.sum((psis.re ** 2 + psis.im ** 2)
                             * prob.measurement.diag, dim=-1)
            return torch.autograd.grad(score_surrogate(vals, logps), cc)
        return loop(mcwf_step)
    if name == "lindblad12":
        from chip_smoke import open_structured_problem
        from diffquantum_tpu_torch.dynamics.lindblad import (
            evolve_lindblad_structured, expectation_rho)
        from diffquantum_tpu_torch.ops.cpx import CP
        ham, env, coeff, noise = open_structured_problem(12, torch.float32,
                                                         seed=5)
        d = 2**12
        rho0 = CP(torch.full((d, d), 1.0 / d, device="cuda"),
                  torch.zeros((d, d), device="cuda"))
        w = torch.cos(torch.linspace(0, 7, d, device="cuda"))
        cl = coeff.clone().requires_grad_(True)
        return loop(lambda: torch.autograd.grad(expectation_rho(
            w, evolve_lindblad_structured(ham, env, cl, rho0, noise, 0.0,
                                          0.8, horizon=0.8, n_steps=8)),
            cl))
    if name == "demo_mc":
        demo = maxcut.demo_problem()
        return lambda k: train_energy(
            demo.ham, demo.envelope, demo.measurement, demo.psi0, demo.T,
            TrainConfig(n_basis=6, n_epoch=k, lr=2e-2, grad_mode="mc"))
    if name.startswith("tfim"):
        prob = tfim.build_tfim(int(name[4:]), dense=False)
        coeff = torch.tensor(0.4 * np.random.default_rng(0).standard_normal(
            prob.envelope.coeff_shape), dtype=torch.float32, device="cuda")
        return loop(lambda: energy_and_grad(
            prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
            prob.T, 30))
    if name == "grad10dense":
        prob = maxcut.build_maxcut(10, maxcut.ring_graph(10), n_basis=6,
                                   dense=True)
    else:
        n = 20 if name == "mc20" else int(name[4:]) \
            if name.startswith("grad") and name != "grad" else 12
        prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6)
    coeff = torch.tensor(1e-3 * np.random.default_rng(0).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    s_fixed = torch.tensor(0.7, dtype=torch.float64, device="cuda")
    common = (prob.ham, prob.envelope, prob.measurement)

    def seeds(**kw):
        return lambda k: train_energy_seeds(
            *common, prob.psi0, prob.T, TrainConfig(n_epoch=k, **kw),
            n_seeds=64)

    if name.startswith("grad"):
        return loop(lambda: energy_and_grad(*common, coeff, prob.psi0,
                                            prob.T, 30))
    return {
        "seeds": seeds(),
        "mc": loop(lambda: mc_energy_grad(*common, coeff, prob.psi0, prob.T,
                                          gen, 30)),
        "mc20": loop(lambda: mc_energy_grad(*common, coeff, prob.psi0,
                                            prob.T, None, 30, s=s_fixed)),
        "mc_seeds": seeds(grad_mode="mc", n_step=30),
        "fd": loop(lambda: fd_energy_grad(*common, coeff, prob.psi0, prob.T,
                                          None, 30)),
    }[name]


def span_table(name, n):
    """Prints the program's spans of the profiled window, a row per name:
    count, host ms, device ms and self device ms, each a step."""
    from diffquantum_tpu_torch.utils import profiling

    win = profiling.window()
    kids = {}
    for s in win.spans:
        if s.parent is not None and s.device_ms is not None:
            kids[s.parent] = kids.get(s.parent, 0.0) + s.device_ms
    rows = {}
    for i, s in enumerate(win.spans):
        r = rows.setdefault(s.name, [0, 0.0, 0.0, 0.0])
        dev = s.device_ms or 0.0
        r[0] += 1
        r[1] += s.host_ms
        r[2] += dev
        r[3] += dev - kids.get(i, 0.0)
    print(f"[{name}] program spans per step (count, host ms, device ms, "
          "self device ms, name):")
    for span, (k, host, dev, own) in sorted(rows.items(),
                                            key=lambda kv: -kv[1][2]):
        print(f"  {k / n:7.2f}  {host / n:10.4f}  {dev / n:10.4f}  "
              f"{own / n:10.4f}  {span}")
    if not rows:
        print(f"[{name}] the path opened no program span")


def profile_path(name, run, n):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffquantum_tpu_torch.utils import profiling

    run(5)
    torch.cuda.synchronize()
    profiling.reset_window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
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
    print(f"[{name}] wall per step {wall_ms / n!r} ms over {n} profiled "
          "steps (profiler on)")
    print(f"[{name}] device busy per step {busy_ms / n!r} ms; busy share "
          f"{busy_ms / wall_ms!r}, idle share {1 - busy_ms / wall_ms!r}")
    launches = sum(r[1] for r in rows if r[1]) / n
    print(f"[{name}] device ops (kernels, copies, memsets) per step "
          f"{launches!r}")
    print(f"[{name}] device time per step by name (us, calls per step, "
          "name):")
    for dev_us, count, key in rows[:20]:
        print(f"  {dev_us / n:10.3f}  {count / n:6.2f}  {key[:90]}")
    if not rows:
        print(f"[{name}] the profiler recorded no device time")
    span_table(name, n)

    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    off_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"[{name}] wall per step {off_ms!r} ms over {n} steps (profiler "
          f"off); idle share estimated from the two windows (profiled "
          f"device busy over this wall) {1 - busy_ms / n / off_ms!r}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--path", choices=PATHS + ("all",), default="grad")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA card")
    sys.path.insert(0, ROOT)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name in (PATHS if args.path == "all" else (args.path,)):
        profile_path(name, make_run(name), args.steps)


if __name__ == "__main__":
    main()
