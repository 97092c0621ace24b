"""The hop drive sets of the PyTorch port end to end, against the JAX
package on the CPU: the router's engine names for hops at 19-24 qubits,
and ``energy_and_grad`` and ``train_energy_seeds`` with the route forced
onto K6 ('mega_hop') at 10 qubits against JAX ``evolve_product_fused``
with its hop engine in interpret mode.

The route is forced as in ``tests/test_torch_frontier.py`` (the packed
band lowered to 0 qubits, its K3 end below the problem's size) with both
packages' chunk plan patched to (c, f) = (1, 2) at 10 qubits, so the
relabelling, the A/B partition and the half-angle schedule all run.
Tolerances as the other slices' tests: values atol 5e-5, gradients 1e-4
of their max-norm, the seeds' per-epoch losses atol 5e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import hamiltonian as jham
from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.gradients.adjoint import energy_and_grad as j_eag
from diffquantum_tpu.measure import Measurement as JMeasurement
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.ops import fused_mega_hop as jmh
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnvelope
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad as t_eag
from diffquantum_tpu_torch.measure import Measurement as TMeasurement
from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
from diffquantum_tpu_torch.ops import linalg as tlinalg
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope as TEnvelope
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def hop_hams(n, pairs, with_xy=True, with_zz=True):
    """(JAX, port) Hamiltonians of the molecule drive set's shape: X and
    Y on every qubit (optional), a hop and (optional) a ZZ row per pair;
    zero H0."""
    d = 2**n
    out = []
    for mod in (jham, tham):
        st = []
        if with_xy:
            st += [mod.TermStructure(kind="1q", qubit=q, local=loc)
                   for q in range(n) for loc in (jlinalg.X, jlinalg.Y)]
        for i, j in pairs:
            st.append(mod.TermStructure(kind="hop", qubit=i, qubit2=j))
            if with_zz:
                st.append(mod.TermStructure(
                    kind="diag", diag=jlinalg.zz_diagonal(n, i, j)))
        kw = dict(dtype=jnp.float32) if mod is jham else {}
        out.append(mod.ControlledHamiltonian.create_structured(
            d, tuple(st), h0_structure=mod.TermStructure(
                kind="diag", diag=np.broadcast_to(0.0, (d,))), **kw))
    return out


def molecule_pairs(n):
    return [(i, i + 1) for i in range(n - 1)] + \
        [(i, i + 2) for i in range(n - 2)]


# ---------------------------------------------------------------------------
# the router against the JAX package's select_engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [19, 20, 22, 24])
def test_router_names_k6_for_hops_like_jax(n):
    """Hop drive sets at 19-24 qubits: 'mega_hop' where the planner finds
    a layout (the molecule's hop graph, X/Y drives), 'xla' where it does
    not (a random graph of ~100 hops at 24 qubits)."""
    jh, th = hop_hams(n, molecule_pairs(n), with_zz=False)
    assert tprod.select_engine(th) == jprod.select_engine(jh) == "mega_hop"
    if n == 24:
        rng = np.random.default_rng(0)
        dense = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if rng.random() < 0.4]
        jh, th = hop_hams(n, dense, with_xy=False, with_zz=False)
        with pytest.warns(UserWarning):
            got = tprod.select_engine(th)
        with pytest.warns(UserWarning):
            want = jprod.select_engine(jh)
        assert got == want == "xla"


def test_router_hop_relabelling_is_memoized():
    n = 20
    _, th = hop_hams(n, molecule_pairs(n), with_zz=False)
    perm, pos = tprod._hop_layout(th)
    assert tprod._hop_layout(th)[0] is perm
    assert perm == jmh.plan_chunked_hop_layout(
        tuple(molecule_pairs(n)), ("hop",) * len(molecule_pairs(n)), n)
    assert len(pos) == 2 * n + len(molecule_pairs(n))


# ---------------------------------------------------------------------------
# the slice end to end with the route forced onto K6 at 10 qubits
# ---------------------------------------------------------------------------

SMALL = 10


@pytest.fixture
def forced(monkeypatch):
    """Both routers sent to 'mega_hop' at 10 qubits, both chunk plans at
    (1, 2)."""
    def plan(n_qubits):
        row_bits = n_qubits - 7
        ff = min(row_bits, 2)
        return row_bits - ff, ff
    jax.clear_caches()
    for mod in (jprod, tprod):
        monkeypatch.setattr(mod, "_PACKED_MIN_QUBITS", 0)
        monkeypatch.setattr(mod, "_VMEM_PACKED_MAX", SMALL - 1)
    monkeypatch.setattr(jmh, "_plan", plan)
    monkeypatch.setattr(tmh, "_plan", plan)
    yield
    jax.clear_caches()


def _problems(n_basis=3):
    """The 10-qubit molecule drive set in both packages (built after the
    routers are patched: both memoize the engine), its envelopes (bspline,
    omega = pi), psi0 uniform and a random diagonal observable."""
    jh, th = hop_hams(SMALL, molecule_pairs(SMALL))
    assert jprod.select_engine(jh) == tprod.select_engine(th) == "mega_hop"
    omegas = (np.pi,) * th.n_controls
    rng = np.random.default_rng(31)
    w = rng.standard_normal(2**SMALL)
    psi0 = tlinalg.uniform_superposition(SMALL)
    jp = (jh, JEnvelope(basis="bspline", n_basis=n_basis, omegas=omegas),
          JMeasurement.create_diagonal(w), jcpx.from_complex(psi0,
                                                             jnp.float32))
    tp = (th, TEnvelope(basis="bspline", n_basis=n_basis, omegas=omegas),
          TMeasurement.create_diagonal(w, device="cpu"),
          CP(torch.tensor(psi0.real, dtype=torch.float32),
             torch.tensor(psi0.imag, dtype=torch.float32)))
    return jp, tp


def test_energy_and_grad_on_the_k6_route(forced):
    (jh, jenv, jm, jpsi), (th, tenv, tm, tpsi) = _problems()
    coeff = (0.4 * np.random.default_rng(3).standard_normal(
        tenv.coeff_shape)).astype(np.float32)
    jv, jg = j_eag(jh, jenv, jm, jnp.asarray(coeff), jpsi, 1.0, 4,
                   backend="product_fused")
    tv, tg = t_eag(th, tenv, tm, torch.tensor(coeff), tpsi, 1.0, 4,
                   backend="product_fused")
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=5e-5)
    _rel_close(tg.numpy(), np.asarray(jg), 1e-4)
    # K6 is its own integrator: the eager engine agrees only to O(dt^2),
    # so it is no tight reference here; the plain dispatcher (the card's
    # reference) is the same chain
    assert tprod._hop_mega(th) and tmh.K6_FWD_LAUNCHES == 0


def _jax_seed_init(envelope, cfg, n_seeds):
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), n_seeds)
    return np.asarray(jax.vmap(lambda k: envelope.init_coeff(
        k, scale=1e-3, dtype=jnp.float32))(keys))


def test_train_energy_seeds_on_the_k6_route(forced):
    """2 seeds x 2 adjoint epochs on the batched K6 route from the same
    start: per-epoch per-seed losses."""
    (jh, jenv, jm, jpsi), (th, tenv, tm, tpsi) = _problems()
    cfg = dict(n_epoch=2, lr=5e-2, per_step=2, seed=7, dtype="float32",
               backend="product_fused")
    init = _jax_seed_init(jenv, JConfig(**cfg), 2)
    jr = j_seeds(jh, jenv, jm, jpsi, 1.0, JConfig(**cfg), n_seeds=2)
    tr = t_seeds(th, tenv, tm, tpsi, 1.0, TConfig(**cfg), n_seeds=2,
                 init_coeffs=torch.tensor(init))
    assert tr.losses.shape == jr.losses.shape == (2, 2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=5e-5)
    assert tr.best_seed == jr.best_seed
    assert tmh.K6_BATCHED_FWD_LAUNCHES == 0


def test_mega_hop_dispatch_plain_is_the_route(forced):
    """The dispatcher's plain form (chip_smoke's reference for the path)
    gives the fused route's state, single and for a batch of two."""
    (_, _, _, _), (th, tenv, tm, tpsi) = _problems()
    coeff = torch.tensor(0.3 * np.random.default_rng(5).standard_normal(
        (2,) + tenv.coeff_shape), dtype=torch.float32)
    for c, psi in ((coeff[0], tpsi),
                   (coeff, CP(tpsi.re.expand(2, -1).contiguous(),
                              tpsi.im.expand(2, -1).contiguous()))):
        fused = tprod.evolve_product_fused(th, tenv, c, psi, 0.0, 1.0,
                                           horizon=1.0, n_steps=3)
        ud, tx, h0th, signs, pos, kinds = tprod.packed_chain_inputs(
            th, tenv, c, 0.0, 1.0, 1.0, 3)
        if psi.ndim == 2:
            ud, tx = ud.contiguous(), tx.contiguous()
        plain = tprod._mega_hop_dispatch(SMALL, psi, ud, tx, h0th, signs,
                                         pos, kinds, tprod._hop_layout(th)[0],
                                         False, plain=True)
        torch.testing.assert_close(plain.re, fused.re)
        torch.testing.assert_close(plain.im, fused.im)
