"""Carrier-resolved entangling control with the CHANNEL pulse model; the
recipe and flags of demos/demo_channel_control.py on the port.

The reference's C++ backend carries per-control *channels* with a
carrier frequency and two trainable quadratures,

    u_h(t) = omega (2 sigmoid(N) - 1) / N * (A(t) cos(w t) + B(t) sin(w t)),

with A/B basis expansions of the spectral coefficients
(`diffqc.cc:95-135`). This demo trains that model end to end: two
DETUNED qubits under an always-on ZZ coupling, each driven through its
own resonant carrier, steered into a Bell state,

    H(t) = w1/2 Z1 + w2/2 Z2 + J ZZ + u1(t) X1 + u2(t) X2.

The seeds train as one batch (per-member coefficients of the dense
engine), each with its own Adam state (``torch.optim.Adam`` at optax's
defaults, lr 3e-2), on the sum of their infidelities.

Run:  python demos_torch/demo_channel_control.py [--epochs 400]
          [--seeds 4] [--device cuda|cpu]
Healthy: best Bell fidelity > 0.99.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffquantum_tpu_torch.dynamics.hamiltonian import \
    ControlledHamiltonian  # noqa: E402
from diffquantum_tpu_torch.dynamics.propagator import (  # noqa: E402
    evolve, reference_n_steps)
from diffquantum_tpu_torch.measure import target_overlap_prob  # noqa: E402
from diffquantum_tpu_torch.ops import cpx, linalg  # noqa: E402
from diffquantum_tpu_torch.ops.cpx import CP  # noqa: E402
from diffquantum_tpu_torch.pulses.envelope import ChannelEnvelope  # noqa: E402
from diffquantum_tpu_torch.utils.logger import Logger  # noqa: E402


def build(n_basis=8, func_type=1, device="cuda"):
    w1, w2, jzz = 5.0, 5.8, 0.5
    h0 = (0.5 * w1 * linalg.pauli_string("ZI")
          + 0.5 * w2 * linalg.pauli_string("IZ")
          + jzz * linalg.pauli_string("ZZ"))
    hs = [linalg.pauli_string("XI"), linalg.pauli_string("IX")]
    ham = ControlledHamiltonian.create(h0, hs, dtype=torch.float32,
                                       device=device)
    # one channel per drive line, carrier at the qubit frequency
    # (rows = the reference's channel table [_, omega, w, idx],
    #  diffqc.cc:103-111)
    rows = [[[0.0, 1.2, w1, 0]],
            [[0.0, 1.2, w2, 1]]]
    env = ChannelEnvelope.from_rows(rows, n_basis=n_basis,
                                    func_type=func_type)
    psi0 = cpx.from_complex(linalg.basis_state(0, 4), device=device)
    bell = np.zeros(4, complex)
    bell[0] = bell[3] = 1 / np.sqrt(2)
    return ham, env, psi0, cpx.from_complex(bell, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--T", type=float, default=6.0)
    ap.add_argument("--per-step", type=int, default=120)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    log = Logger("demo_channel_control")
    ham, env, psi0, target = build(device=args.device)
    T = args.T
    # the carrier at w ~ 5-6 rad/time needs ~20 grid points per period
    n_steps = reference_n_steps(args.per_step, 0.0, T)
    batch = CP(psi0.re.expand(args.seeds, -1), psi0.im.expand(args.seeds, -1))
    tgt = CP(target.re.expand(args.seeds, -1), target.im.expand(args.seeds, -1))

    def infidelities(vvs):  # one per seed
        psi = evolve(ham, env, vvs, batch, 0.0, T, horizon=T,
                     n_steps=n_steps, t_sample="mid")
        return 1.0 - target_overlap_prob(tgt, psi)

    gen = torch.Generator().manual_seed(0)
    vvs = torch.stack([env.init_coeff(gen, scale=0.3, device=args.device)
                       for _ in range(args.seeds)]).requires_grad_(True)
    opt = torch.optim.Adam([vvs], lr=args.lr)

    t0 = time.time()
    best = 1.0
    for epoch in range(1, args.epochs + 1):
        opt.zero_grad()
        infidelities(vvs).sum().backward()
        opt.step()
        if epoch % 20 == 0 or epoch == args.epochs:
            with torch.no_grad():
                infs = infidelities(vvs).cpu().numpy()
            best = float(infs.min())
            log.write_text(f"epoch: {epoch:04d}, best infidelity: "
                           f"{best:.6f}, mean: {float(infs.mean()):.6f}")
    log.write_text(f"best Bell fidelity: {1.0 - best:.6f} "
                   f"({args.seeds} seeds, channel/carrier pulse model)")
    log.write_text(f"wall time: {time.time() - t0:.1f}s")
    return 1.0 - best


if __name__ == "__main__":
    main()
