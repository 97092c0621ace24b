"""The program side of the MaxCut cells: diffquantum_tpu_torch's MaxCut
problem, trained by its seed trainer (``parallel.train_energy_seeds``) on
one card.

A configuration names this file by its ``problem`` key. ``build`` makes
the problem that the configuration states and refuses one whose declared
keys (``n_qubits``, ``graph``, ``form``, ``dtype``, ``T``, ``n_steps``,
``n_controls``) do not match what the program built. It returns the
object that the harness drives: ``coeff_shape`` (one member's
coefficients) and ``run_job(seed, epochs, init_coeffs)``, one trainer
call of ``epochs`` epochs from the population ``init_coeffs``.
"""
from __future__ import annotations

import math

GRAPHS = ("ring",)
FORMS = ("structured",)   # the dense form is another engine (K7)


def _graph(name: str, n: int):
    from diffquantum_tpu_torch.models.maxcut import ring_graph
    if name not in GRAPHS:
        raise ValueError(f"graph {name!r}: this problem builds {GRAPHS}")
    return ring_graph(n)


def agree(declared: dict, built: dict):
    """Raises where a key that the configuration declares differs from
    what was built."""
    bad = {k: (declared[k], v) for k, v in built.items()
           if not (math.isclose(float(declared[k]), float(v), rel_tol=1e-12)
                   if isinstance(v, float) else declared[k] == v)}
    if bad:
        raise ValueError("the configuration declares what was not built "
                         "(declared, built): " + repr(bad))


class SeedTrainer:
    """The problem and the trainer call of one cell."""

    def __init__(self, config: dict, traffic: dict, device):
        import torch
        from diffquantum_tpu_torch.dynamics.propagator import (
            reference_n_steps)
        from diffquantum_tpu_torch.models.maxcut import build_maxcut
        if config["form"] not in FORMS:
            raise ValueError(f"form {config['form']!r}: this problem "
                             f"builds {FORMS}")
        n = int(config["n_qubits"])
        self.config, self.traffic = config, traffic
        self.problem = p = build_maxcut(
            n, _graph(config["graph"], n), n_basis=int(config["n_basis"]),
            basis=config["basis"], omega0=config["omega0"],
            omega1=config["omega1"], dtype=getattr(torch, config["dtype"]),
            dense=False, device=device)
        self.coeff_shape = tuple(p.envelope.coeff_shape)
        agree(config, {
            "n_qubits": int(p.psi0.re.shape[-1]).bit_length() - 1,
            "T": float(p.T),
            "n_steps": reference_n_steps(int(config["per_step"]), 0.0,
                                         float(p.T)),
            "n_controls": self.coeff_shape[0],
            "n_basis": self.coeff_shape[1],
            "dtype": str(p.psi0.re.dtype).removeprefix("torch.")})

    def train_config(self, seed: int, epochs: int):
        from diffquantum_tpu_torch.train.config import TrainConfig
        c, t = self.config, self.traffic
        return TrainConfig(
            n_basis=int(c["n_basis"]), basis=c["basis"], n_epoch=epochs,
            lr=float(t["lr"]), per_step=int(c["per_step"]),
            n_step=int(c["mc_steps"]), grad_mode=t["grad_mode"],
            mc_samples=int(t.get("mc_samples", 1)),
            mc_strategy=t.get("mc_strategy", "iid"),
            precision=c["precision"], dtype=c["dtype"], seed=seed)

    def run_job(self, seed: int, epochs: int, init_coeffs):
        from diffquantum_tpu_torch.parallel import train_energy_seeds
        p = self.problem
        return train_energy_seeds(
            p.ham, p.envelope, p.measurement, p.psi0, p.T,
            self.train_config(seed, epochs), int(self.traffic["n_seeds"]),
            init_coeffs=init_coeffs)


def build(config: dict, traffic: dict, device) -> SeedTrainer:
    return SeedTrainer(config, traffic, device)
