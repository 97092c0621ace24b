"""Pulse-level QAOA MaxCut demo — the reference's flagship workload
(`demo_maxcut.py`) on the PyTorch/CUDA port; the recipe and flags of
demos/demo_maxcut.py.

Usage:
    python demos_torch/demo_maxcut.py [--qubits 4] [--epochs 202]
        [--grad adjoint|mc|fd] [--device cuda|cpu]
Healthy: cut result 1010 (or 0101), cut value 4.0 / 4.0.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffquantum_tpu_torch.models import maxcut  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_energy  # noqa: E402
from diffquantum_tpu_torch.utils.logger import Logger  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--qubits", type=int, default=4)
    p.add_argument("--epochs", type=int, default=202)
    p.add_argument("--grad", default="adjoint", choices=["adjoint", "mc", "fd"])
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--n-basis", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.qubits == 4:
        prob = maxcut.demo_problem(device=args.device)  # the 4-qubit ring
    else:
        prob = maxcut.build_maxcut(args.qubits, maxcut.ring_graph(args.qubits),
                                   n_basis=args.n_basis, device=args.device)

    logger = Logger(name=f"maxcut_{args.grad}")
    logger.write_text(f"demo_MaxCut n_qubits={args.qubits} ========")
    logger.write_text(f"sim.T: {prob.T}")

    cfg = TrainConfig(n_basis=args.n_basis, n_epoch=args.epochs, lr=args.lr,
                      grad_mode=args.grad, seed=args.seed)
    res = train_energy(prob.ham, prob.envelope, prob.measurement, prob.psi0,
                       prob.T, cfg, logger=logger)

    state, cut = prob.readout(res.final_state)
    print(f"cut result is {bin(state)[2:].zfill(prob.n_qubits)}")
    print(f"cut value: {cut} / max cut: {prob.max_cut}")
    print(f"final optimality gap: {res.losses_energy[-1]:.6f}")
    print(f"wall time: {res.wall_s:.1f}s ({args.epochs} epochs, "
          f"{args.grad} gradients)")
    return dict(state=state, cut=cut, max_cut=prob.max_cut,
                gap=res.losses_energy[-1], wall_s=res.wall_s)


if __name__ == "__main__":
    main()
