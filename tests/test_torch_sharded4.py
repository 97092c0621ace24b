"""The port's state-sharded engine on 4 CPU gloo ranks: a state axis of
4 (two distributed qubits) and a data x state = 2 x 2 mesh with
per-member coefficients and states, against the JAX package on the same
mesh sizes of ``tests/conftest.py``'s 8 virtual devices, and against the
port's unsharded engine. The helpers, cases and tolerances are
tests/test_torch_sharded.py's; this module spawns its own world."""
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_gloo as ranks
from test_torch_sharded import (_gather, _grad_close, _jax_case,
                                _jax_channel_case, check_case, check_traps,
                                jax_refs_of)

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The results of a spawned gloo world of 4 ranks, in rank order."""
    return ranks.run_ranks(WORLD, str(tmp_path_factory.mktemp("w4")),
                           np.zeros(0))


@pytest.fixture(scope="module")
def jax_refs():
    refs = jax_refs_of(WORLD)
    for backend in ("xla", "fused"):
        refs[f"data2_state2_{backend}"] = _jax_case(
            11, jnp.float32, backend, False, {"data": 2, "state": 2},
            members=4)
    return refs


@pytest.mark.parametrize("name", [c[0] for c in ranks.cases(WORLD)])
def test_sharded_matches_jax(runs, jax_refs, name):
    check_case(runs, jax_refs[name], name)


def test_gradient_traps_against_unsharded_engine(runs):
    check_traps(runs)


@pytest.mark.parametrize("name", [c[0] for c in ranks.channel_cases(WORLD)])
def test_sharded_channel_envelope_matches_jax(runs, name):
    """The channel envelope through 'xla' float64 on a state axis of 4
    (two distributed qubits of 8) against JAX's sharded engine."""
    n, dt, backend = next(c[1:] for c in ranks.channel_cases(WORLD)
                          if c[0] == name)
    check_case(runs, _jax_channel_case(n, getattr(jnp, dt), backend, WORLD),
               name)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_data_state_mesh_per_seed_coefficients(runs, jax_refs, backend):
    """Four members, each with its own coefficients and state, on a
    data x state = 2 x 2 mesh: per-member values, gradients and states
    (f32: atol 1e-5, gradients 1e-4 of their max-norm)."""
    name = f"data2_state2_{backend}"
    e_j, g_j, psi_j = jax_refs[name]
    np.testing.assert_allclose(_gather(runs, name, members=True), psi_j,
                               rtol=0, atol=1e-5)
    for i in range(2):  # data index i: ranks 2i (state 0) and 2i+1
        for r in runs[2 * i:2 * i + 2]:
            np.testing.assert_allclose(r[name][0], e_j[2 * i:2 * i + 2],
                                       rtol=0, atol=1e-5)
            _grad_close(r[name][1], g_j[2 * i:2 * i + 2], 1e-4)
