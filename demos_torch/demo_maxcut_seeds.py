"""Seed-fleet pulse-level QAOA: train many independent pulse
initializations at once as one batch (K2 on the card at 10-17 qubits);
the recipe and flags of demos/demo_maxcut_seeds.py.

Usage:
    python demos_torch/demo_maxcut_seeds.py [--qubits 12] [--seeds 64]
        [--epochs 150] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from diffquantum_tpu_torch.models import maxcut  # noqa: E402
from diffquantum_tpu_torch.parallel.mesh import train_energy_seeds  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--qubits", type=int, default=12)
    p.add_argument("--seeds", type=int, default=64)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    prob = maxcut.build_maxcut(args.qubits, maxcut.ring_graph(args.qubits),
                               n_basis=6, device=args.device)
    cfg = TrainConfig(n_basis=6, n_epoch=args.epochs, lr=args.lr, seed=0)

    t0 = time.time()
    res = train_energy_seeds(prob.ham, prob.envelope, prob.measurement,
                             prob.psi0, prob.T, cfg, n_seeds=args.seeds)
    wall = time.time() - t0

    lam_min = float(np.min(prob.cost_diag))
    gaps = np.asarray(res.losses)[-1] - lam_min
    print(f"{args.seeds} seeds x {args.epochs} epochs x {args.qubits} qubits "
          f"in {wall:.1f}s ({wall / args.epochs * 1e3:.1f} ms/epoch for the "
          f"whole fleet)")
    print(f"best seed: #{res.best_seed}, optimality gap "
          f"{res.best_loss - lam_min:.4f}")
    print(f"gap quartiles across seeds: "
          f"{np.percentile(gaps, [0, 25, 50, 75, 100]).round(3)}")
    return dict(best_gap=res.best_loss - lam_min, wall_s=wall)


if __name__ == "__main__":
    main()
