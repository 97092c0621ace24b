"""Hydrogen-chain pulse VQE — the classic strong-correlation benchmark;
the recipe and flags of demos/demo_hydrogen_chain.py.

Four hydrogens in a line (8 spin orbitals = 8 qubits after Jordan-Wigner
in the RHF-MO basis): ab initio from STO-3G integrals + RHF SCF, with the
sector-projected FCI energy as ground truth (models/molecule.py).
``--atoms 6`` runs H6 (12 qubits) matrix-free: symbolic Jordan-Wigner
terms, structure-tagged {X, Y, hop, ZZ} drives on the product engine (K1
and K2 on the card), a strings-projected sector-FCI oracle; ``--atoms 2``
is H2 (4 qubits).

Usage: python demos_torch/demo_hydrogen_chain.py [--atoms 2|4|6]
           [--r 0.9] [--epochs 2000] [--seeds 16] [--device cuda|cpu]
Healthy: the best seed descends below RHF toward FCI.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from diffquantum_tpu_torch.models import molecule as mol  # noqa: E402
from diffquantum_tpu_torch.parallel.mesh import train_energy_seeds  # noqa: E402
from diffquantum_tpu_torch.train import TrainConfig  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--atoms", type=int, default=4, choices=[2, 4, 6])
    p.add_argument("--r", type=float, default=0.9, help="H-H spacing (A)")
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--seeds", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--T", type=float, default=5.0)
    p.add_argument("--n-basis", type=int, default=8)
    p.add_argument("--sampled", action="store_true",
                   help="hardware-realistic mode: MC gradients + "
                        "finite-shot grouped (QWC) Pauli measurement")
    p.add_argument("--shots", type=int, default=200,
                   help="shots per QWC measurement setting (--sampled)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    coords = [(0.0, 0.0, i * args.r) for i in range(args.atoms)]
    prob = mol.build_hydrogen_cluster(coords, T=args.T,
                                      n_basis=args.n_basis,
                                      device=args.device)
    centers = [np.asarray(c) * mol.ANGSTROM_TO_BOHR for c in coords]
    S, h, g, enuc = mol.cluster_integrals(centers)
    e_scf, _ = mol.rhf_scf(S, h, g, args.atoms // 2)
    e_rhf = e_scf + enuc
    e_fci = prob.exact_ground_energy + prob.e_nuc
    print(f"H{args.atoms} chain, R = {args.r} A: {len(prob.terms)} Pauli "
          f"terms, {prob.ham.n_controls} drives")
    print(f"RHF: {e_rhf:.6f} Ha   FCI: {e_fci:.6f} Ha   "
          f"(correlation {1000 * (e_rhf - e_fci):.1f} mHa)")

    if args.sampled:
        # the hardware pipeline: MC pulse gradients with finite-shot
        # grouped Pauli estimation (one basis rotation and one shot batch
        # per qubit-wise commuting family, measure.py::qwc_groups);
        # stratified 4-sample averaging and a gentler lr make it converge
        from diffquantum_tpu_torch.measure import qwc_groups
        st = prob.measurement.strings
        n_groups = len(qwc_groups(st.flips, st.yz_masks))
        print(f"sampled mode: {st.n_terms} Pauli terms -> {n_groups} QWC "
              f"measurement settings x {args.shots} shots")
        cfg = TrainConfig(n_basis=args.n_basis, n_epoch=args.epochs,
                          lr=min(args.lr, 2e-2), grad_mode="mc", seed=0,
                          lr_schedule="cosine", t_sample="mid",
                          sampling_measure=True, per_pauli=args.shots,
                          n_step=40, mc_samples=4,
                          mc_strategy="stratified")
    else:
        cfg = TrainConfig(n_basis=args.n_basis, n_epoch=args.epochs,
                          lr=args.lr, grad_mode="adjoint", seed=0,
                          lr_schedule="cosine", t_sample="mid")
    res = train_energy_seeds(prob.ham, prob.envelope, prob.measurement,
                             prob.psi0, prob.T, cfg, n_seeds=args.seeds)
    e_vqe = float(res.best_loss) + prob.e_nuc
    err = 1000 * (e_vqe - e_fci)
    rec = 100 * (e_rhf - e_vqe) / (e_rhf - e_fci)
    print(f"pulse VQE (best of {args.seeds}): {e_vqe:.6f} Ha — "
          f"{err:.2f} mHa above FCI, {rec:.0f}% of correlation recovered")
    return dict(e_vqe=e_vqe, e_fci=e_fci, e_rhf=e_rhf, err_mha=err)


if __name__ == "__main__":
    main()
