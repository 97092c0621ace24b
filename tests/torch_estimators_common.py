"""Helpers shared by the halves of the port's estimator tests:
``test_torch_mc.py`` / ``test_torch_mc_train.py`` (the MC and FD
estimators, sampled measurement and the 'mc' / 'fd' trainers against the
JAX package) and ``test_torch_sampled_frontier.py`` /
``test_torch_sampled_frontier_train.py`` (the 18-24 qubit estimator paths
at 10 qubits, with the router forced onto the packed engines). The files
are split so that ``--dist loadfile`` can balance them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.models import maxcut as tmaxcut

N = 10
KW = dict(n_basis=4, omega0=2 * np.pi, omega1=2 * np.pi)  # T = 1


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _problems(n, dtype_np, n_basis=4, **kw):
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jp = jmaxcut.build_maxcut(n, jmaxcut.ring_graph(n), n_basis=n_basis,
                              dense=False, dtype=jnp.dtype(dtype_np), **kw)
    tp = tmaxcut.build_maxcut(n, tmaxcut.ring_graph(n), n_basis=n_basis,
                              dense=False, dtype=tdt, device="cpu", **kw)
    coeff = (0.5 * np.random.default_rng(n).standard_normal(
        tp.envelope.coeff_shape)).astype(dtype_np)
    return jp, tp, coeff


def _problem(dtype=torch.float64):
    return tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), dense=False,
                                dtype=dtype, device="cpu", **KW)


def _coeffs(shape, seed, lead=()):
    return 0.5 * np.random.default_rng(seed).standard_normal(
        tuple(lead) + tuple(shape))


@pytest.fixture(params=["packed", "mega"])
def forced(request, monkeypatch):
    """The port's router sent to K3 ('packed') or K5 ('mega') at 10
    qubits (their plain paths on the CPU)."""
    monkeypatch.setattr(tprod, "_PACKED_MIN_QUBITS", 0)
    if request.param == "mega":
        monkeypatch.setattr(tprod, "_VMEM_PACKED_MAX", N - 1)
    return request.param
