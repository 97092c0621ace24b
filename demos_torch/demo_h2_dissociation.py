"""H2 dissociation curve by pulse-level VQE — ab initio: STO-3G integrals
-> Jordan-Wigner -> Pauli strings -> analog pulse training at each bond
length, against FCI and RHF; the recipe and flags of
demos/demo_h2_dissociation.py.

Usage: python demos_torch/demo_h2_dissociation.py [--points 7]
           [--epochs 250] [--device cuda|cpu]
Healthy: worst |error| < 1.6 mHa.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from diffquantum_tpu_torch.models import molecule as mol  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig, train_energy  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--points", type=int, default=7)
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--grad", default="adjoint", choices=["adjoint", "mc"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    rs = np.linspace(0.4, 2.2, args.points)
    print(f"{'R (A)':>7} {'E_VQE (Ha)':>12} {'E_FCI (Ha)':>12} "
          f"{'err (mHa)':>10} {'E_RHF (Ha)':>12}")
    worst = 0.0
    init = None  # warm-start each geometry from the previous pulse: the
    # ground state deforms continuously along the curve, and the stretched
    # (strongly correlated) region is hard from a cold start
    for r in rs:
        prob = mol.build_h2_at(float(r), device=args.device)
        cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr,
                          grad_mode=args.grad, seed=0)
        res = train_energy(prob.ham, prob.envelope, prob.measurement,
                           prob.psi0, prob.T, cfg,
                           lam_min=prob.exact_ground_energy,
                           init_coeff=init)
        init = res.coeff
        e_vqe = res.losses_raw[-1] + prob.e_nuc
        e_fci = prob.exact_ground_energy + prob.e_nuc
        err = 1000.0 * (e_vqe - e_fci)
        worst = max(worst, abs(err))
        print(f"{r:7.3f} {e_vqe:12.6f} {e_fci:12.6f} {err:10.3f} "
              f"{mol.rhf_energy(float(r)):12.6f}")
    print(f"\nworst |error|: {worst:.3f} mHa "
          f"(chemical accuracy: 1.6 mHa)")
    return dict(worst_mha=worst)


if __name__ == "__main__":
    main()
