"""VQE for the H2 ground state with analog pulses; the recipe and flags
of demos/demo_vqe_h2.py.

Usage:
    python demos_torch/demo_vqe_h2.py [--epochs 250] [--grad adjoint|mc|fd]
        [--device cuda|cpu]
Healthy: error 0.000-0.5 mHa (chemical accuracy: 1.6 mHa).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffquantum_tpu_torch.models import vqe_h2  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_energy  # noqa: E402
from diffquantum_tpu_torch.utils.logger import Logger  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--grad", default="adjoint", choices=["adjoint", "mc", "fd"])
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    prob = vqe_h2.build_h2(device=args.device)
    logger = Logger(name=f"vqe_h2_{args.grad}")
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                      grad_mode=args.grad, seed=args.seed)
    res = train_energy(prob.ham, prob.envelope, prob.measurement, prob.psi0,
                       prob.T, cfg, logger=logger)

    final = res.losses_raw[-1]
    err_mha = (final - prob.exact_ground_energy) * 1000
    print(f"final energy:  {final:.6f} Ha")
    print(f"exact ground:  {prob.exact_ground_energy:.6f} Ha")
    print(f"error:         {err_mha:.3f} mHa (chemical accuracy: 1.6 mHa)")
    return dict(energy=final, error_mha=err_mha)


if __name__ == "__main__":
    main()
