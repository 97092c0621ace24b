"""Pulse-level VQE on the transverse-field Ising chain: the matrix-free
Pauli-string measurement, ground truth at any size from the free-fermion
solution (models/tfim.py); the recipe and flags of demos/demo_tfim.py.

Usage: python demos_torch/demo_tfim.py [--n 10] [--epochs 300]
           [--grad adjoint|mc] [--device cuda|cpu]
Healthy: gap a few % of |E0|.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffquantum_tpu_torch.models import tfim  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_energy  # noqa: E402
from diffquantum_tpu_torch.utils.logger import Logger  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--J", type=float, default=1.0)
    p.add_argument("--h", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--grad", default="adjoint", choices=["adjoint", "mc"])
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    prob = tfim.build_tfim(args.n, J=args.J, h=args.h, n_basis=6,
                           n_layers=args.layers, device=args.device)
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                      grad_mode=args.grad, seed=args.seed)
    logger = Logger(name=f"tfim_{args.n}q_{args.grad}")
    res = train_energy(prob.ham, prob.envelope, prob.measurement, prob.psi0,
                       prob.T, cfg, logger=logger,
                       lam_min=prob.exact_ground)

    e_final = res.losses_raw[-1]
    gap = res.losses_energy[-1]
    print(f"TFIM chain: n={args.n}, J={args.J}, h={args.h} "
          f"(criticality J=h)")
    print(f"final energy:        {e_final:.6f}")
    print(f"free-fermion ground: {prob.exact_ground:.6f}")
    print(f"gap: {gap:.6f} ({100 * gap / abs(prob.exact_ground):.2f}% "
          f"of |E0|)")
    return dict(energy=e_final, gap=gap, losses=res.losses_raw)


if __name__ == "__main__":
    main()
