"""Quantum optimal control demos: state transfer, Bell-state preparation
and gate synthesis; the recipes and flags of demos/demo_control.py.

``hadamard`` uses the reference-style pair-based (phase-blind) fidelity;
``gate-hadamard`` / ``gate-cnot`` use the coherent gate objective
``1 - |Tr(G^dag U(T))|^2/d^2`` (:mod:`diffquantum_tpu_torch.train.gate`),
which pins the relative phases the pair objective cannot see.

Usage:
    python demos_torch/demo_control.py
        [--task transfer|bell|hadamard|gate-hadamard|gate-cnot]
        [--grad adjoint|mc] [--device cuda|cpu]
Healthy: hadamard fidelity > 0.999; gate-cnot coherent infidelity ~1e-7.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from diffquantum_tpu_torch.models import control  # noqa: E402
from diffquantum_tpu_torch.ops import cpx  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_fidelity  # noqa: E402
from diffquantum_tpu_torch.utils.logger import Logger  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="transfer",
                   choices=["transfer", "bell", "hadamard",
                            "gate-hadamard", "gate-cnot"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--grad", default="adjoint", choices=["adjoint", "mc"])
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.task.startswith("gate-"):
        return run_gate(args)
    if args.task == "transfer":
        prob = control.state_transfer(n_qubits=1, device=args.device)
    elif args.task == "bell":
        prob = control.bell_state_preparation(device=args.device)
    else:
        prob = control.hadamard_synthesis(device=args.device)

    logger = Logger(name=f"control_{args.task}_{args.grad}")
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                      grad_mode=args.grad, seed=args.seed)
    res = train_fidelity(prob.ham, prob.envelope, prob.initial_states,
                         prob.target_states, prob.T, cfg, logger=logger)

    infid = res.losses_energy[-1]
    print(f"task: {args.task}")
    print(f"final mean infidelity: {infid:.2e} (fidelity {1 - infid:.6f})")
    finals = cpx.to_complex(res.final_state)
    targets = cpx.to_complex(prob.target_states)
    fids = np.abs(np.sum(np.conj(targets) * finals, axis=-1)) ** 2
    for i, f in enumerate(fids):
        print(f"  pair {i}: fidelity {f:.6f}")
    return dict(infidelity=infid, fidelities=fids)


def run_gate(args):
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    from diffquantum_tpu_torch.train import train_gate

    if args.task == "gate-hadamard":
        ham, omegas = control.single_qubit_controls(detuning=0.0,
                                                    device=args.device)
        gate = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
        T = 2.0
    else:  # gate-cnot
        ham, omegas = control.two_qubit_controls(device=args.device)
        gate = np.eye(4)[[0, 1, 3, 2]]  # CNOT (control = qubit 0)
        T = 4.0
    env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    logger = Logger(name=f"control_{args.task}")
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                      grad_mode="adjoint", seed=args.seed)
    res = train_gate(ham, env, gate, T, cfg, logger=logger)
    infid = res.losses_energy[-1]
    print(f"task: {args.task}")
    print(f"final coherent infidelity: {infid:.2e} "
          f"(|Tr(G^dag U)|^2/d^2 = {1 - infid:.6f})")
    U = cpx.to_complex(res.final_state).T  # batch row i = U|i> -> columns
    tr = np.trace(gate.conj().T @ U)
    phase = tr / abs(tr)
    print(f"max |U - e^(i phi) G| = {np.abs(U - phase * gate).max():.2e} "
          f"(global phase {phase:.4f})")
    return dict(infidelity=infid)


if __name__ == "__main__":
    main()
