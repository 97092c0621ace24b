"""The port's state-sharded engine (``parallel/sharded_state.py``), meshes
and meshed seed populations on 2 CPU gloo ranks (4 in
tests/test_torch_sharded4.py), against the JAX package's
``evolve_product_sharded``, ``sharded_diag_expectation`` and
``train_energy_seeds`` on the same mesh sizes of ``tests/conftest.py``'s
8 virtual devices, and against the port's unsharded engine.

The ranks (tests/test_torch_gloo.py, ``rank_cases``) are spawned once for
the module, and the JAX references computed once. Each
case's loss is the sum of ``sharded_diag_expectation`` over the ranks'
members and its gradient the coefficients'. Tolerances: f32 states and
values atol 1e-5, coefficient gradients 1e-4 of their max-norm; f64 'xla'
1e-10 (value and state absolute, gradient of max-norm); the meshed seed
losses atol 1e-6 (f64). A gradient scaled by the axis size, or one
missing the other shards' share, is off by a factor 2 or 4 and fails each
of them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffquantum_tpu.dynamics.hamiltonian import (ControlledHamiltonian,
                                                  TermStructure)
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.parallel.mesh import make_mesh as j_make_mesh
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.parallel.sharded_state import (
    evolve_product_sharded as j_sharded,
    sharded_diag_expectation as j_diag_exp)
from diffquantum_tpu.pulses.envelope import ChannelEnvelope as JChannelEnvelope
from diffquantum_tpu.pulses.envelope import SimpleEnvelope
from diffquantum_tpu.train.config import TrainConfig as JConfig

import test_torch_gloo as ranks

WORLD = 2
SEEDS_CFG = dict(n_epoch=2, seed=3, dtype="float64")


def _jax_problem(n, dtype, hops):
    d = 2**n
    terms = []
    for kind, args in ranks.structure(n, hops):
        if kind == "zz":
            terms.append(TermStructure(kind="diag",
                                       diag=jlinalg.zz_diagonal(n, *args)))
        elif kind == "hop":
            terms.append(TermStructure(kind="hop", qubit=args[0],
                                       qubit2=args[1]))
        else:
            terms.append(TermStructure(
                kind="1q", qubit=args[0],
                local=jlinalg.X if kind == "x" else jlinalg.Y))
    ham = ControlledHamiltonian.create_structured(
        d, terms, h0_structure=TermStructure(kind="diag", diag=np.zeros(d)),
        dtype=dtype)
    env = SimpleEnvelope(basis="legendre", n_basis=4,
                         omegas=(float(np.pi),) * len(terms))
    return ham, env


def _jax_case(n, dtype, backend, hops, mesh_axes, members=0):
    """(values, coefficient gradient, state as complex) of the JAX
    package's sharded engine on a mesh of the first virtual devices."""
    ham, env = _jax_problem(n, dtype, hops)
    coeff, psi, diag = ranks.problem_inputs(n, members)
    coeff = jnp.asarray(coeff[..., :len(ranks.structure(n, hops)), :],
                        dtype)
    psi0 = jcpx.from_complex(psi, dtype=dtype)
    diag = jnp.asarray(diag, dtype)
    mesh = j_make_mesh(mesh_axes)
    batch = "data" if members else None

    def energy(c):
        out = j_sharded(ham, env, c, psi0, 0.0, ranks.T_END,
                        horizon=ranks.T_END, n_steps=ranks.N_STEPS,
                        mesh=mesh, batch_axis=batch, local_backend=backend)
        e = j_diag_exp(out, diag, mesh, batch_axis=batch)
        return jnp.sum(e), (e, out)

    (_, (e, out)), g = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        coeff)
    return np.asarray(e), np.asarray(g), jcpx.to_complex(out)


def _jax_channel_case(n, dtype, backend, world):
    """(value, vv gradient, state as complex) of the JAX package's
    sharded engine on a channel case (tests/test_torch_gloo.py's
    ``channel_value_and_grad``)."""
    d = 2**n
    terms = [TermStructure(kind="1q", qubit=q, local=jlinalg.X)
             for q in range(n)]
    terms.append(TermStructure(kind="diag",
                               diag=jlinalg.zz_diagonal(n, 0, 1)))
    ham = ControlledHamiltonian.create_structured(
        d, tuple(terms), h0_structure=TermStructure(kind="diag",
                                                    diag=np.zeros(d)),
        dtype=dtype)
    env = JChannelEnvelope.from_rows(ranks.channel_rows(n), n_basis=3,
                                     func_type=0)
    vv, diag = ranks.channel_inputs(n)
    psi0 = jcpx.from_complex(jlinalg.uniform_superposition(n), dtype=dtype)
    mesh = j_make_mesh({"state": world})

    def energy(c):
        out = j_sharded(ham, env, c, psi0, 0.0, ranks.CH_T,
                        horizon=ranks.CH_T, n_steps=ranks.CH_STEPS,
                        mesh=mesh, local_backend=backend)
        return j_diag_exp(out, jnp.asarray(diag, dtype), mesh), out

    (e, out), g = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        jnp.asarray(vv, dtype))
    return np.asarray(e), np.asarray(g), jcpx.to_complex(out)


def jax_channel_refs_of(world):
    return {name: _jax_channel_case(n, getattr(jnp, dt), backend, world)
            for name, n, dt, backend in ranks.channel_cases(world)}


def jax_refs_of(world):
    """{case name: JAX's (values, gradient, state)} at ``world`` ranks."""
    return {name: _jax_case(n, getattr(jnp, dt), backend, hops,
                            {"state": world})
            for name, n, dt, backend, hops in ranks.cases(world)}


def _gather(results, name, members=False):
    """The ranks' state blocks (re, im) of a case, as one complex array:
    rank order is the mesh's row-major order (data, then state)."""
    blocks = [r[name][2] for r in results]
    if not members:
        state = np.concatenate(blocks, axis=-1)
        return state[0] + 1j * state[1]
    rows = [np.concatenate(blocks[2 * i:2 * i + 2], axis=-1)
            for i in range(2)]  # data index i holds members 2i, 2i+1
    state = np.concatenate(rows, axis=1)
    return state[0] + 1j * state[1]


def _grad_close(got, want, rel):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def check_case(results, ref, name):
    """A case's gathered state, and every rank's value and gradient (each
    rank holds them whole), against JAX's."""
    e_j, g_j, psi_j = ref
    atol, grel = (1e-10, 1e-10) if name.endswith("f64") else (1e-5, 1e-4)
    np.testing.assert_allclose(_gather(results, name), psi_j, rtol=0,
                               atol=atol)
    for r in results:
        assert abs(float(r[name][0]) - float(e_j)) < atol
        _grad_close(r[name][1], g_j, grel)


def check_traps(results):
    """f64 'xla' against the port's unsharded eager engine: the value
    matches and the coefficient gradient is neither the axis size times
    the true one (a psum whose backward all-reduces the replicated
    cotangent) nor one shard's share of it (replicated coefficients not
    summed over the axis)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import evolve_product
    ham, env = ranks.torch_problem(11, torch.float64, hops=True)
    coeff, psi0, diag = ranks._torch_inputs(11, torch.float64, hops=True)
    c = coeff.clone().requires_grad_(True)
    psi = evolve_product(ham, env, c, psi0, 0.0, ranks.T_END,
                         horizon=ranks.T_END, n_steps=ranks.N_STEPS)
    e = torch.sum((psi.re ** 2 + psi.im ** 2) * diag)
    (g,) = torch.autograd.grad(e, c)
    g = g.numpy()
    for r in results:
        val, grad, _ = r["xla_f64"]
        assert abs(float(val) - float(e.detach())) < 1e-10
        ratio = float(np.sum(grad * g) / np.sum(g ** 2))
        assert abs(ratio - 1.0) < 1e-9, ratio
        _grad_close(grad, g, 1e-10)


@pytest.fixture(scope="module")
def seeds_init():
    """JAX's train_energy_seeds init for 4 seeds of the 6-qubit ring."""
    p = jmaxcut.build_maxcut(6, jmaxcut.ring_graph(6), dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(SEEDS_CFG["seed"]), 4)
    return np.asarray(jax.vmap(lambda k: p.envelope.init_coeff(
        k, scale=1e-3, dtype=jnp.float64))(keys))


@pytest.fixture(scope="module")
def runs(seeds_init, tmp_path_factory):
    """The results of a spawned gloo world of 2 ranks, in rank order."""
    return ranks.run_ranks(WORLD, str(tmp_path_factory.mktemp("w2")),
                           seeds_init)


@pytest.fixture(scope="module")
def jax_refs():
    return jax_refs_of(WORLD)


@pytest.mark.parametrize("name", [c[0] for c in ranks.cases(WORLD)])
def test_sharded_matches_jax(runs, jax_refs, name):
    check_case(runs, jax_refs[name], name)


def test_gradient_traps_against_unsharded_engine(runs):
    check_traps(runs)


@pytest.mark.parametrize("name", [c[0] for c in ranks.channel_cases(WORLD)])
def test_sharded_channel_envelope_matches_jax(runs, name):
    """The channel envelope through the sharded engine ('xla' float64,
    'fused' float32) against JAX's sharded engine on the same mesh size:
    the gathered state, and every rank's value and vv gradient."""
    n, dt, backend = next(c[1:] for c in ranks.channel_cases(WORLD)
                          if c[0] == name)
    check_case(runs, _jax_channel_case(n, getattr(jnp, dt), backend, WORLD),
               name)


def test_meshed_seeds_match_jax(runs):
    """train_energy_seeds over a data axis of 2 gloo ranks (the 6-qubit
    dense ring, 4 seeds, 2 epochs, f64) against JAX's meshed run from the
    same init: every rank returns the whole, equal result."""
    p = jmaxcut.build_maxcut(6, jmaxcut.ring_graph(6), dtype=jnp.float64)
    jr = j_seeds(p.ham, p.envelope, p.measurement, p.psi0, p.T,
                 JConfig(**SEEDS_CFG), n_seeds=4,
                 mesh=j_make_mesh({"data": 2}))
    for losses, coeffs in (r["seeds"] for r in runs):
        assert losses.shape == (2, 4)
        np.testing.assert_allclose(losses, np.asarray(jr.losses), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(coeffs, np.asarray(jr.coeffs), rtol=0,
                                   atol=1e-8)
