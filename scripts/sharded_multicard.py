#!/usr/bin/env python3
"""The state-sharded engine on N cards of one host, one rank per card
(NCCL), against one card's unsharded engines.

    torchrun --standalone --nproc-per-node=4 scripts/sharded_multicard.py

``--device cpu`` runs the same program on gloo ranks on the CPU (at a
small ``--qubits``, e.g. 12). On a mesh ``{"state": N}`` each rank holds
2^n / N amplitudes of the n-qubit ring MaxCut (n_basis 6, T = 2):

1. 'xla' (plain PyTorch per rotation; the drives on the log2 N leading
   qubits rotate through block exchanges) at ``--xla-steps`` steps
   against the unsharded eager engine on the rank's own card, value and
   coefficient gradient;
2. 'chunked' (K4 per step on the n - log2 N local qubits) with the X
   drives on the local qubits only, 30 steps, against ``energy_and_grad``
   on the packed engines (K5 at 19-24 qubits) on the rank's own card:
   with no distributed rotation both are the same integrator;
3. 'chunked' with every drive (the exchanges wrap each step at half
   angles, O(dt^2) from 'xla'): its value beside 'xla''s at 30 steps;
4. CUDA-event times of the sharded 'chunked' grad step and of the
   one-card ``energy_and_grad``.

Every rank checks its own readings; rank 0 prints them as one JSON line
after the card's name and power limit. Exits non-zero when a check
fails.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VALUE_ATOL = 5e-5   # as chip_smoke.py's sharded and frontier limits
GRAD_REL = 1e-4


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def ring(n, device, local_drives_from=0):
    """The n-qubit ring MaxCut on ``device``; with ``local_drives_from``
    k > 0 the X drives sit on qubits k..n-1 only."""
    from diffquantum_tpu_torch.dynamics.hamiltonian import \
        ControlledHamiltonian
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6,
                               device=device)
    if not local_drives_from:
        return prob, prob.envelope
    import dataclasses

    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    keep = [i for i, st in enumerate(prob.ham.structure)
            if st.kind == "diag" or st.qubit >= local_drives_from]
    ham = ControlledHamiltonian.create_structured(
        prob.ham.dim, tuple(prob.ham.structure[i] for i in keep),
        h0_structure=prob.ham.h0_structure, dtype=prob.ham.dtype)
    env = SimpleEnvelope(basis=prob.envelope.basis, n_basis=6,
                         omegas=tuple(prob.envelope.omegas[i] for i in keep))
    return dataclasses.replace(prob, ham=ham, envelope=env), env


def sharded_energy(mesh, prob, env, coeff, n_steps, backend):
    from diffquantum_tpu_torch.parallel import (evolve_product_sharded,
                                                sharded_diag_expectation)
    psi = evolve_product_sharded(prob.ham, env, coeff, prob.psi0, 0.0,
                                 prob.T, horizon=prob.T, n_steps=n_steps,
                                 mesh=mesh, local_backend=backend)
    return sharded_diag_expectation(psi, prob.measurement.diag, mesh)


def sharded_grad(mesh, prob, env, coeff, n_steps, backend):
    c = coeff.detach().clone().requires_grad_(True)
    e = sharded_energy(mesh, prob, env, c, n_steps, backend)
    (g,) = torch.autograd.grad(e, c)
    return e.detach(), g


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device, iters):
    fn()
    sync(device)
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--qubits", type=int, default=20)
    ap.add_argument("--xla-steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import torch.distributed as dist

    from diffquantum_tpu_torch.dynamics.product import evolve_product
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.measure import diag_expectation
    from diffquantum_tpu_torch.parallel import make_mesh
    from diffquantum_tpu_torch.utils import profiling

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = make_mesh({"state": world}, device=args.device)
    dev, rank, k = mesh.device, dist.get_rank(), int(np.log2(world))
    n = args.qubits
    out = {"world": world, "qubits": n, "local_qubits": n - k,
           "device": str(dev)}
    failures = []

    def check(name, val, grad, val_r, grad_r):
        dv, dg = abs(float(val) - float(val_r)), rel_err(grad, grad_r)
        out[name] = {"value": float(val), "reference": float(val_r),
                     "value_diff": dv, "grad_rel": dg}
        if not (torch.isfinite(grad).all() and dv <= VALUE_ATOL
                and dg <= GRAD_REL):
            failures.append(f"{name}: value diff {dv}, gradient {dg}")

    t0 = time.perf_counter()
    prob, env = ring(n, dev)
    coeff = torch.tensor(0.4 * np.random.default_rng(n).standard_normal(
        env.coeff_shape), dtype=torch.float32, device=dev)
    out["host_build_s"] = time.perf_counter() - t0

    # 1. 'xla' with exchanges against the unsharded eager engine
    n_x = args.xla_steps
    val, grad = sharded_grad(mesh, prob, env, coeff, n_x, "xla")
    c = coeff.clone().requires_grad_(True)
    psi = evolve_product(prob.ham, env, c, prob.psi0, 0.0, prob.T,
                         horizon=prob.T, n_steps=n_x)
    e = diag_expectation(prob.measurement.diag, psi)
    (g,) = torch.autograd.grad(e, c)
    check("xla_vs_eager", val, grad, e.detach(), g)
    del psi, e, g, c

    # 2. 'chunked' (K4) with local drives against the packed engines
    prob_l, env_l = ring(n, dev, local_drives_from=k)
    coeff_l = torch.tensor(0.4 * np.random.default_rng(n + 1)
                           .standard_normal(env_l.coeff_shape),
                           dtype=torch.float32, device=dev)
    k4 = profiling.counters()
    val, grad = sharded_grad(mesh, prob_l, env_l, coeff_l, 30, "chunked")
    sync(dev)
    now = profiling.counters()
    out["k4_launches"] = [now[k] - k4[k] for k in ("k4_forward",
                                                   "k4_backward")]
    if dev.type == "cuda" and out["k4_launches"] != [30, 30]:
        failures.append(f"'chunked' launched K4 {out['k4_launches']}, "
                        f"expected 30 each way")
    val_r, grad_r = energy_and_grad(prob_l.ham, env_l, prob_l.measurement,
                                    coeff_l, prob_l.psi0, prob_l.T, 30)
    check("chunked_local_drives_vs_energy_and_grad", val, grad, val_r,
          grad_r)

    # 3. 'chunked' with every drive, beside 'xla' (another integrator)
    with torch.no_grad():
        out["chunked_all_drives"] = {
            "value": float(sharded_energy(mesh, prob, env, coeff, 30,
                                          "chunked")),
            "xla_value": float(sharded_energy(mesh, prob, env, coeff, 30,
                                              "xla"))}

    # 4. times
    out["ms_sharded_chunked_grad_step"] = timed_ms(
        lambda: sharded_grad(mesh, prob, env, coeff, 30, "chunked"), dev, 3)
    out["ms_one_card_energy_and_grad"] = timed_ms(
        lambda: energy_and_grad(prob.ham, env, prob.measurement, coeff,
                                prob.psi0, prob.T, 30), dev, 3)
    dist.barrier()
    if rank == 0:
        if dev.type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip(), flush=True)
        print(json.dumps(out), flush=True)
    ok = torch.tensor([0.0 if failures else 1.0], device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    for f in failures:
        print(f"sharded_multicard: rank {rank}: FAIL: {f}", file=sys.stderr,
              flush=True)
    dist.destroy_process_group()
    if float(ok) < 1.0:
        sys.exit(1)


if __name__ == "__main__":
    main()
