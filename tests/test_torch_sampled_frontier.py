"""The MC estimator's 18-24 qubit paths of the PyTorch port, on the CPU
at 10 qubits: the MC samples one after another ('map') against all
samples on the batch axis ('vmap') and against the JAX package's single
samples; the router forced onto the packed engines (K3 'packed' and K5
'mega' plain paths), as tests/test_torch_frontier.py forces it, where
'auto' runs the samples one after another and the per-member time-grid
refusal still stands. The trainers on the forced route and FD's chunks
are in ``test_torch_sampled_frontier_train.py``.

Tolerances: float64 eager 'map' against 'vmap' 1e-12 of the max-norm
(the same arithmetic, one sample at a time); float32 packed routes
against the float64 eager engine or JAX's float32 eager engine 1e-4 of
the max-norm, as tests/test_torch_frontier.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.ops.cpx import CP
from torch_estimators_common import KW, N, _coeffs, _problem, _rel_close
from torch_estimators_common import forced  # noqa: F401 (fixture)


@pytest.mark.parametrize("layout", ["shared", "per_sample"])
def test_map_equals_vmap_on_the_eager_engine(layout):
    """Samples one after another equal the batched samples: shared
    coefficients and state, or a coefficient set and a state each."""
    tp = _problem()
    ss = torch.tensor([0.15, 0.5, 0.85], dtype=torch.float64)
    if layout == "shared":
        c, psi0 = torch.tensor(_coeffs(tp.envelope.coeff_shape, 1)), tp.psi0
    else:
        c = torch.tensor(_coeffs(tp.envelope.coeff_shape, 2, (3,)))
        psi0 = CP(tp.psi0.re.expand(3, -1).clone(),
                  tp.psi0.im.expand(3, -1).clone())
        psi0.re[1] = torch.roll(psi0.re[1], 3)
    args = (tp.ham, tp.envelope, tp.measurement, c, psi0, tp.T, ss, 6)
    g_map = tmc.mc_grads_per_sample(*args, sample_mode="map")
    g_vmap = tmc.mc_grads_per_sample(*args, sample_mode="vmap")
    assert g_map.shape == (3,) + tp.envelope.coeff_shape
    _rel_close(g_map.numpy(), g_vmap.numpy(), 1e-12)
    assert tmc._mc_sample_mode(tp.ham, "auto") == "vmap"
    with pytest.raises(ValueError, match="sample_mode"):
        tmc.mc_grads_per_sample(*args, sample_mode="scan")


def test_mc_on_the_forced_route(forced):
    """'auto' runs the samples one after another there: each sample's
    leg 1 one packed chain, its branches one batched packed evolution
    sharing its split time. Against the float64 eager engine's batched
    samples and JAX's float32 eager single samples; 'vmap' on the packed
    engine still meets the per-member time-grid refusal."""
    tp = _problem(torch.float32)
    assert tprod.select_engine(tp.ham) == forced
    assert tmc._mc_sample_mode(tp.ham, "auto") == "map"
    cs = _coeffs(tp.envelope.coeff_shape, 3, (3,))
    ss = np.array([0.2, 0.55, 0.9])
    args = (tp.ham, tp.envelope, tp.measurement,
            torch.tensor(cs, dtype=torch.float32), tp.psi0, tp.T,
            torch.tensor(ss), 6)
    got = tmc.mc_grads_per_sample(*args, backend="product_fused")
    t64 = _problem(torch.float64)
    want = tmc.mc_grads_per_sample(t64.ham, t64.envelope, t64.measurement,
                                   torch.tensor(cs), t64.psi0, t64.T,
                                   torch.tensor(ss), 6, backend="product",
                                   sample_mode="vmap")
    _rel_close(got.numpy(), want.numpy(), 1e-4)
    jp = jmaxcut.build_maxcut(N, jmaxcut.ring_graph(N), dense=False,
                              dtype=jnp.float32, **KW)
    for i in range(3):
        j = jmc.mc_energy_grad(jp.ham, jp.envelope, jp.measurement,
                               jnp.asarray(cs[i], jnp.float32), jp.psi0,
                               jp.T, jax.random.PRNGKey(0), 6, s=ss[i],
                               backend="product")
        _rel_close(got[i].numpy(), np.asarray(j), 1e-4)
    with pytest.raises(NotImplementedError, match="per-member time grids"):
        tmc.mc_grads_per_sample(*args, backend="product_fused",
                                sample_mode="vmap")


def test_per_member_grid_refusal_kept(forced):
    """The packed engines refuse per-member time grids at the source: the
    drift's half-step phase is one plane per launch."""
    tp = _problem(torch.float32)
    c = torch.zeros(tp.envelope.coeff_shape)
    with pytest.raises(NotImplementedError, match="sample_mode='map'"):
        tprod.packed_chain_inputs(tp.ham, tp.envelope, c,
                                  torch.tensor([0.0, 0.1]), tp.T, tp.T, 4)
