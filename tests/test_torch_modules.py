"""Modules of the PyTorch port against the JAX package, on the CPU: the
pulse bases and envelope (f64, atol 1e-12), the MaxCut tables (identical),
the engine router on every n <= 17 case of tests/test_router.py, and the
small host helpers. Inputs are made with a seeded numpy generator and
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import hamiltonian as jham
from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.pulses import basis as jbasis
from diffquantum_tpu.pulses import envelope as jenv
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.ops import linalg as tlinalg
from diffquantum_tpu_torch.pulses import basis as tbasis
from diffquantum_tpu_torch.pulses import envelope as tenv


@pytest.mark.parametrize("kind,n_basis", [("poly", 5), ("legendre", 6),
                                          ("fourier", 7), ("bspline", 6),
                                          ("BSpline", 4)])
def test_basis_matrix_matches_jax(kind, n_basis):
    ts = np.linspace(0.0, 2.0, 37)
    want = np.asarray(jbasis.basis_matrix(kind, n_basis, jnp.asarray(ts),
                                          2.0))
    got = tbasis.basis_matrix(kind, n_basis, torch.tensor(ts), 2.0).numpy()
    assert got.shape == want.shape == (37, n_basis)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["bspline", "legendre"])
def test_simple_envelope_amplitudes_match_jax(kind):
    rng = np.random.default_rng(3)
    omegas = (np.pi, 0.5, 2.0)
    coeff = 3.0 * rng.standard_normal((3, 6))
    coeff[0, 2] = 40.0  # drive one control into the saturated sigmoid
    ts = np.arange(30) * (2.0 / 30)
    je = jenv.SimpleEnvelope(basis=kind, n_basis=6, omegas=omegas)
    te = tenv.SimpleEnvelope(basis=kind, n_basis=6, omegas=omegas)
    want = np.asarray(je.amplitudes(jnp.asarray(coeff), jnp.asarray(ts), 2.0))
    got = te.amplitudes(torch.tensor(coeff), torch.tensor(ts), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    x = np.array([-40.0, -32.5, -1.0, 0.0, 2.0, 32.5, 40.0])
    np.testing.assert_allclose(
        tenv.clamped_sigmoid(torch.tensor(x)).numpy(),
        np.asarray(jenv.clamped_sigmoid(jnp.asarray(x))), rtol=0, atol=1e-15)
    assert te.coeff_shape == je.coeff_shape


def test_init_coeff_uses_the_generator():
    te = tenv.SimpleEnvelope(basis="bspline", n_basis=4, omegas=(1.0, 1.0))
    a = te.init_coeff(torch.Generator().manual_seed(7), device="cpu")
    b = te.init_coeff(torch.Generator().manual_seed(7), device="cpu")
    assert a.shape == (2, 4) and a.dtype == torch.float32
    assert torch.equal(a, b) and float(a.abs().max()) < 1e-2


@pytest.mark.parametrize("graph", ["ring", "random"])
def test_build_maxcut_tables_identical(graph):
    n = 10
    g = jmaxcut.ring_graph(n) if graph == "ring" else \
        jmaxcut.random_graph(n, 0.4, seed=2)
    assert g == (tmaxcut.ring_graph(n) if graph == "ring"
                 else tmaxcut.random_graph(n, 0.4, seed=2))
    jp = jmaxcut.build_maxcut(n, g, n_basis=6, dense=False,
                              dtype=jnp.float64)
    tp = tmaxcut.build_maxcut(n, g, n_basis=6, dtype=torch.float64,
                              device="cpu")
    assert tp.T == jp.T == 2.0
    np.testing.assert_array_equal(tp.cost_diag, jp.cost_diag)
    np.testing.assert_array_equal(tp.measurement.diag.numpy(),
                                  np.asarray(jp.measurement.diag))
    np.testing.assert_array_equal(tcpx.to_complex(tp.psi0),
                                  np.asarray(jp.psi0.re))
    assert tp.envelope.omegas == jp.envelope.omegas
    jsplit = jprod.split_structure_ext(jp.ham)
    tsplit = tprod.split_structure_ext(tp.ham)
    for k in (0, 3, 4, 6, 7):  # indices, qubits, hop data
        assert list(tsplit[k]) == list(jsplit[k])
    np.testing.assert_array_equal(np.stack(tsplit[1]), np.stack(jsplit[1]))
    np.testing.assert_array_equal(tsplit[2], jsplit[2])
    diag_t, h0_t = tprod._tables(tp.ham, torch.float64, "cpu")
    np.testing.assert_array_equal(
        diag_t.numpy(),
        np.asarray(jprod.diag_rows_device(jsplit[1], 2**n, jnp.float64)))
    assert tp.ham.hs_norms == jp.ham.hs_norms
    assert tp.max_cut == jp.max_cut
    for s in (0, 5, 341, 1023):
        assert tp.cut_value(s) == jp.cut_value(s)
    assert tp.readout(tp.psi0)[1] == jp.readout(jp.psi0)[1]


def _router_hams(n, structure, h0=None):
    d = 2**n
    h0 = h0 or jham.TermStructure(kind="diag", diag=np.zeros(d))
    th0 = tham.TermStructure(kind=h0.kind, qubit=h0.qubit, local=h0.local,
                             diag=h0.diag)
    jh = jham.ControlledHamiltonian.create_structured(
        d, tuple(structure), h0_structure=h0, dtype=jnp.float32)
    th = tham.ControlledHamiltonian.create_structured(
        d, tuple(tham.TermStructure(kind=s.kind, qubit=s.qubit,
                                    local=s.local, diag=s.diag,
                                    qubit2=s.qubit2) for s in structure),
        h0_structure=th0, dtype=torch.float32)
    return jh, th


def _min_structure(n, hop=False):
    st = [jham.TermStructure(kind="diag", diag=jlinalg.zz_diagonal(n, 0, 1)),
          jham.TermStructure(kind="1q", qubit=0, local=jlinalg.X),
          jham.TermStructure(kind="1q", qubit=n - 1, local=jlinalg.X)]
    if hop:
        st.append(jham.TermStructure(kind="hop", qubit=1, qubit2=2))
    return st


def _many_xy(n, reps):
    return [jham.TermStructure(kind="1q", qubit=q, local=local)
            for _ in range(reps) for q in range(n)
            for local in (jlinalg.X, jlinalg.Y)]


def _three_valued(n):
    r = np.zeros(2**n)
    r[: 2**n // 4] = 2.0
    return [jham.TermStructure(kind="diag", diag=r),
            jham.TermStructure(kind="1q", qubit=0, local=jlinalg.X)]


_HADAMARD = np.array([[1, 1], [1, -1]]) / np.sqrt(2)

ROUTER_CASES = {
    "ring10": (10, lambda: _min_structure(10), None, "streamed"),
    "ring17": (17, lambda: _min_structure(17), None, "streamed"),
    "hop10": (10, lambda: _min_structure(10, hop=True), None, "streamed"),
    "hop17": (17, lambda: _min_structure(17, hop=True), None, "streamed"),
    "below_band": (9, lambda: _min_structure(9), None, "xla"),
    "lanes_60x2": (10, lambda: _many_xy(10, 3), None, "streamed"),
    "lanes_80x2": (10, lambda: _many_xy(10, 4), None, "xla"),
    "hadamard": (10, lambda: [jham.TermStructure(kind="1q", qubit=0,
                                                 local=_HADAMARD)],
                 None, "xla"),
    "diag_1q_folds": (10, lambda: [
        jham.TermStructure(kind="1q", qubit=2, local=jlinalg.Z),
        jham.TermStructure(kind="1q", qubit=0, local=jlinalg.X)],
        None, "streamed"),
    "nondiag_h0": (10, lambda: [jham.TermStructure(kind="1q", qubit=0,
                                                   local=jlinalg.X)],
                   jham.TermStructure(kind="1q", qubit=0, local=jlinalg.X),
                   "xla"),
    "three_valued_17": (17, lambda: _three_valued(17), None, "streamed"),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_select_engine_agrees_with_jax(case):
    n, make, h0, engine = ROUTER_CASES[case]
    jh, th = _router_hams(n, make(), h0)
    assert jprod.select_engine(jh) == engine
    assert tprod.select_engine(th) == engine
    assert tprod.fused_eligible(th) == jprod.fused_eligible(jh)


def test_symmetrize_rots_matches_jax():
    rng = np.random.default_rng(1)
    tx = rng.standard_normal((5, 3))
    args = ((0, 0, (1, 2)), ("x", "y", "hop"))
    jq, jk, jt = jprod._symmetrize_rots(*args, jnp.asarray(tx), axis=1)
    tq, tk, tt = tprod._symmetrize_rots(*args, torch.tensor(tx), dim=1)
    assert (tq, tk) == (jq, jk)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    same = tprod._symmetrize_rots((0, 1), ("x", "x"), torch.tensor(tx[:, :2]),
                                  dim=1)
    assert same[0] == (0, 1) and torch.equal(same[2],
                                             torch.tensor(tx[:, :2]))


def test_linalg_copies_match_jax():
    for (i, j) in ((0, 1), (2, 7), (9, 3)):
        np.testing.assert_array_equal(tlinalg.zz_diagonal(10, i, j),
                                      jlinalg.zz_diagonal(10, i, j))
    np.testing.assert_array_equal(tlinalg.z_diagonal(10, 4),
                                  jlinalg.z_diagonal(10, 4))
    np.testing.assert_array_equal(tlinalg.uniform_superposition(5),
                                  jlinalg.uniform_superposition(5))
    for name in "IXYZ":
        np.testing.assert_array_equal(tlinalg.PAULIS[name],
                                      jlinalg.PAULIS[name])
    psi = np.random.default_rng(0).standard_normal(16) + 0j
    cp = tcpx.from_complex(psi, dtype=torch.float64, device="cpu")
    assert tlinalg.find_state(cp)[0] == jlinalg.find_state(psi)[0]
    np.testing.assert_array_equal(tcpx.to_complex(cp), psi)
