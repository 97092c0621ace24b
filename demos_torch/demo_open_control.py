"""Noise-aware quantum control: optimize a pulse UNDER decoherence; the
recipe and flags of demos/demo_open_control.py on the port.

The pulse is trained against the Lindblad master equation
(differentiable through the dissipative propagator), so the optimizer
learns to beat T1 relaxation. Task: |0> -> |1> on a damped qubit
(amplitude damping rate gamma). Compare
  (a) a noise-blind pulse: trained on the closed system, evaluated open;
  (b) a noise-aware pulse: trained directly on the open system
      (``torch.optim.Adam`` at optax's defaults).
The winner is then cross-validated with Monte-Carlo wavefunction
trajectories (the dense MCWF: K7 at d = 2 on the card).

``--mcwf-scale N`` (N >= 10) adds a second act past the density-matrix
wall: T1-aware maxcut pulse training at N qubits through the
score-function MCWF estimator (``evolve_mcwf_structured(return_logp=
True)`` + ``score_surrogate``; 'fused' runs K2, one T = 1 launch a step).

Usage: python demos_torch/demo_open_control.py [--gamma 0.15]
           [--epochs 300] [--mcwf-scale 14] [--device cuda|cpu]
Healthy: the noise-aware fidelity beats the noise-blind one; the MCWF
check agrees with the master equation.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffquantum_tpu_torch.dynamics.lindblad import (  # noqa: E402
    CollapseSet, amplitude_damping, density_from_trajectories,
    evolve_lindblad, evolve_mcwf, expectation_rho)
from diffquantum_tpu_torch.models import control  # noqa: E402
from diffquantum_tpu_torch.ops import cpx  # noqa: E402
from diffquantum_tpu_torch.ops.cpx import CP  # noqa: E402
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_fidelity  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gamma", type=float, default=0.15)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--T", type=float, default=2.0)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--n-traj", type=int, default=2000)
    p.add_argument("--mcwf-scale", type=int, default=0,
                   help="if >= 10: also run T1-aware training at this "
                        "many qubits via the score-function MCWF "
                        "estimator (past the density-matrix wall)")
    p.add_argument("--mcwf-epochs", type=int, default=30)
    p.add_argument("--mcwf-backend", default="auto",
                   choices=["auto", "xla", "fused"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device

    ham, omegas = control.single_qubit_controls(detuning=0.5, device=dev)
    env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    T, n_steps = args.T, 10 * (int(args.T) + 1)
    c = CollapseSet.create([amplitude_damping(args.gamma, 0, 1)], device=dev)
    psi0 = cpx.from_complex(np.array([1.0, 0.0], complex), device=dev)
    rho0 = cpx.from_complex(np.array([[1.0, 0.0], [0.0, 0.0]], complex),
                            device=dev)
    target_diag = np.array([0.0, 1.0])  # <1|rho|1>

    # (a) noise-blind: closed-system training (reference-style objective)
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                      grad_mode="adjoint", seed=0)
    blind = train_fidelity(
        ham, env, CP(psi0.re[None], psi0.im[None]),
        cpx.from_complex(np.array([[0.0, 1.0]], complex), device=dev), T,
        cfg).coeff

    # (b) noise-aware: train through the master equation
    def open_infidelity(coeff):
        rho = evolve_lindblad(ham, env, coeff, rho0, c, 0.0, T,
                              horizon=T, n_steps=n_steps)
        return 1.0 - expectation_rho(target_diag, rho)

    coeff = env.init_coeff(torch.Generator().manual_seed(0), scale=1.0,
                           device=dev).requires_grad_(True)
    opt = torch.optim.Adam([coeff], lr=args.lr)
    for epoch in range(1, args.epochs + 1):
        opt.zero_grad()
        loss = open_infidelity(coeff)
        loss.backward()
        opt.step()
        if epoch % 50 == 0:
            print(f"epoch {epoch:04d}  open-system infidelity "
                  f"{float(loss):.4f}")
    coeff = coeff.detach()

    with torch.no_grad():
        f_blind = 1.0 - float(open_infidelity(blind))
        f_aware = 1.0 - float(open_infidelity(coeff))
    print(f"\ngamma = {args.gamma}, T = {T}")
    print(f"noise-blind pulse, open-system fidelity:  {f_blind:.4f}")
    print(f"noise-aware pulse, open-system fidelity:  {f_aware:.4f}")
    print(f"advantage: {f_aware - f_blind:+.4f}")

    # cross-validate the winner with quantum-jump trajectories
    gen = torch.Generator(device=dev).manual_seed(1)
    psis = evolve_mcwf(ham, env, coeff, psi0, c, 0.0, T, horizon=T,
                       n_steps=n_steps, generator=gen, n_traj=args.n_traj)
    rho_mc = density_from_trajectories(psis)
    f_mc = float(expectation_rho(target_diag, rho_mc))
    print(f"MCWF check ({args.n_traj} trajectories): fidelity {f_mc:.4f} "
          f"(master equation: {f_aware:.4f})")
    out = dict(f_blind=f_blind, f_aware=f_aware, f_mc=f_mc)

    if args.mcwf_scale >= 10:
        out["mcwf"] = mcwf_scale_act(args.mcwf_scale, args.mcwf_epochs,
                                     args.mcwf_backend, dev)
    return out


def mcwf_scale_act(n: int, epochs: int, backend: str = "auto",
                   device="cuda"):
    """T1-aware maxcut training at n qubits — density matrices are d^2
    and impossible here; the score-function MCWF estimator is O(d) per
    trajectory. ``backend='fused'`` runs all trajectories through one
    batched K2 launch a step (10-17 qubits); 'auto' picks 'fused' at >= 14
    qubits, as the JAX demo does."""
    from diffquantum_tpu_torch.dynamics.lindblad import (
        StructuredNoise, evolve_mcwf_structured, score_surrogate)
    from diffquantum_tpu_torch.models import maxcut

    print(f"\n--- T1-aware training at {n} qubits "
          f"(score-function MCWF; rho would be 2^{2 * n} entries) ---")
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=4,
                               dense=False, device=device)
    noise = StructuredNoise(n, t1=[(q, 0.1) for q in range(n)])
    w = prob.measurement.diag
    T, n_steps, n_traj = float(prob.T), 10, 8
    if backend == "auto":
        backend = "fused" if n >= 14 else "xla"
    print(f"(trajectory engine: backend={backend})")
    gen = torch.Generator(device=device).manual_seed(7)

    def loss(cc):
        psis, logps = evolve_mcwf_structured(
            prob.ham, prob.envelope, cc, prob.psi0, noise, 0.0, T,
            horizon=T, n_steps=n_steps, generator=gen, n_traj=n_traj,
            return_logp=True, backend=backend)
        vals = torch.sum(cpx.abs2(psis) * w, dim=-1)
        return score_surrogate(vals, logps)

    cc = prob.envelope.init_coeff(torch.Generator().manual_seed(0),
                                  scale=0.3, device=device)
    cc.requires_grad_(True)
    opt = torch.optim.Adam([cc], lr=5e-2)
    vals = []
    for epoch in range(1, epochs + 1):
        opt.zero_grad()
        val = loss(cc)
        val.backward()
        opt.step()
        vals.append(float(val))
        if epoch % max(1, epochs // 5) == 0:
            print(f"epoch {epoch:04d}  noisy maxcut energy {vals[-1]:.4f}")
    print(f"noisy energy: first {vals[0]:.4f} -> last {vals[-1]:.4f} "
          f"(T1 on every qubit, gamma=0.1)")
    return vals


if __name__ == "__main__":
    main()
