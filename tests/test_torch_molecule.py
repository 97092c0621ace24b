"""The molecule model of the PyTorch port against the JAX package on the
CPU: STO-3G integrals, RHF, the dense and the symbolic Jordan-Wigner
Hamiltonians and their Pauli decompositions, the number penalty, the
sector FCI oracles, the problem build functions (H2; H3+, dense drives;
the H5+ chain, 10 qubits, the smallest cluster on the structured {X, Y,
hop, ZZ} drive set), and ``energy_and_grad`` on them.

Tolerances: the host part is the same numpy in the same order, so its
floats agree to 1e-12 (most are equal); the sector FCI through the
strings (float64 string applications on both sides, then eigvalsh) to
1e-10; the energy at the RHF determinant equals E_RHF to 1e-10 relative
(float64). ``energy_and_grad`` in float32 (at H5+ the port's plain
'streamed' chain with hops, K1's plain version, against the JAX
package's 'auto' route, its fused engine as its own tests run it on the
CPU; dense 'expm' for H2): 1e-5 relative on the value, 1e-4 of the
max-norm on the gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics.propagator import evolve as jevolve
from diffquantum_tpu.gradients import adjoint as jadj
from diffquantum_tpu.models import molecule as jmol
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu_torch.gradients import adjoint as tadj
from diffquantum_tpu_torch.models import molecule as tmol
from diffquantum_tpu_torch.ops import fused_product as tfp

R_EQ = 0.7414
H3P = ([(0, 0, 0), (0.9, 0, 0), (0.45, 0.45 * np.sqrt(3), 0)], 1)
H5P = ([(0.0, 0.0, 0.9 * i) for i in range(5)], 1)
HOST = dict(rtol=0, atol=1e-12)


def _close_terms(got, want, atol=1e-12):
    got, want = dict(got), dict(want)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= atol, k


@pytest.mark.parametrize("r", [R_EQ, 1.5])
def test_h2_host_matches_jax(r):
    rb = r * jmol.ANGSTROM_TO_BOHR
    for got, want in zip(tmol.h2_integrals(rb), jmol.h2_integrals(rb)):
        np.testing.assert_allclose(got, want, **HOST)
    for got, want in zip(tmol.h2_mo_integrals(rb), jmol.h2_mo_integrals(rb)):
        np.testing.assert_allclose(got, want, **HOST)
    ht, et = tmol.h2_electronic_hamiltonian(r)
    hj, ej = jmol.h2_electronic_hamiltonian(r)
    np.testing.assert_allclose(ht, hj, **HOST)
    assert et == ej
    _close_terms(tmol.pauli_decompose(ht), jmol.pauli_decompose(hj))
    _close_terms(tmol.pauli_decompose_fast(ht.real),
                 jmol.pauli_decompose_fast(hj.real))
    assert abs(tmol.rhf_energy(r) - jmol.rhf_energy(r)) <= 1e-12
    assert abs(tmol.fci_energy(r) - jmol.fci_energy(r)) <= 1e-12


def test_build_h2_at_matches_jax():
    tp = tmol.build_h2_at(R_EQ, dtype=torch.float64, device="cpu")
    jp = jmol.build_h2_at(R_EQ, dtype=jnp.float64)
    _close_terms(tp.terms, jp.terms)
    assert tp.exact_ground_energy == jp.exact_ground_energy
    assert tp.e_nuc == jp.e_nuc and tp.T == jp.T
    assert tp.ham.n_controls == jp.ham.n_controls == 14
    assert tp.envelope.omegas == jp.envelope.omegas
    np.testing.assert_allclose(tp.ham.Hs.re.numpy(), np.asarray(jp.ham.Hs.re),
                               **HOST)
    np.testing.assert_allclose(tp.ham.Hs.im.numpy(), np.asarray(jp.ham.Hs.im),
                               **HOST)
    assert int(torch.argmax(tp.psi0.re)) == 0b1100 == \
        int(np.argmax(np.asarray(jp.psi0.re)))
    ts, js = tp.measurement.strings, jp.measurement.strings
    assert (ts.flips, ts.yz_masks, ts.n_ys) == (js.flips, js.yz_masks,
                                                js.n_ys)


def test_h3_plus_host_and_build_match_jax():
    """H3+ (6 spin orbitals, 2 electrons): integrals, RHF, the dense
    Hamiltonian and its sector ground energy, the symbolic JW terms, the
    number penalty, and the dense-drive build."""
    coords, charge = H3P
    centers = [np.asarray(c) * jmol.ANGSTROM_TO_BOHR for c in coords]
    tint, jint = tmol.cluster_integrals(centers), jmol.cluster_integrals(
        centers)
    for got, want in zip(tint, jint):
        np.testing.assert_allclose(got, want, **HOST)
    S, h, g, _ = jint
    et, ct = tmol.rhf_scf(S, h, g, 1)
    ej, cj = jmol.rhf_scf(S, h, g, 1)
    assert abs(et - ej) <= 1e-12
    np.testing.assert_allclose(ct, cj, **HOST)
    ht, nt, rt = tmol.cluster_electronic_hamiltonian(coords, charge)
    hj, nj, rj = jmol.cluster_electronic_hamiltonian(coords, charge)
    np.testing.assert_allclose(ht, hj, **HOST)
    assert (nt, rt) == (nj, rj)
    assert abs(tmol.sector_ground_energy(ht, 2)
               - jmol.sector_ground_energy(hj, 2)) <= 1e-12
    h_mo = cj.T @ h @ cj
    g_mo = np.einsum("ijkl,ip,jq,kr,ls->pqrs", g, cj, cj, cj, cj)
    sym = tmol.jw_pauli_terms(h_mo, g_mo)
    _close_terms(sym, jmol.jw_pauli_terms(h_mo, g_mo))
    _close_terms(tmol.pauli_decompose_fast(ht.real),
                 jmol.pauli_decompose_fast(hj.real))
    _close_terms(sym, tmol.pauli_decompose_fast(ht.real))
    assert tmol.number_penalty_terms(6, 2, 2.0) == \
        jmol.number_penalty_terms(6, 2, 2.0)
    # the port's strings oracle (float64) against the dense sector energy
    fci = tmol.sector_fci_from_strings(sym, 6, 2, device="cpu")
    assert abs(fci - jmol.sector_ground_energy(hj, 2)) <= 1e-10

    tp = tmol.build_hydrogen_cluster(coords, charge=charge,
                                     dtype=torch.float64, device="cpu")
    jp = jmol.build_hydrogen_cluster(coords, charge=charge,
                                     dtype=jnp.float64)
    _close_terms(tp.terms, jp.terms)
    assert tp.exact_ground_energy == jp.exact_ground_energy
    assert tp.e_nuc == jp.e_nuc
    assert tp.ham.n_controls == jp.ham.n_controls == 39  # 12 + 9 pairs x 3
    assert not tp.ham.is_structured_only
    np.testing.assert_allclose(tp.ham.Hs.re.numpy(), np.asarray(jp.ham.Hs.re),
                               **HOST)
    assert int(torch.argmax(tp.psi0.re)) == 0b110000 == \
        int(np.argmax(np.asarray(jp.psi0.re)))


@pytest.fixture(scope="module")
def h5p():
    """The H5+ chain (10 spin orbitals, 4 electrons) built by both
    packages in float64, sector FCI included."""
    coords, charge = H5P
    return (tmol.build_hydrogen_cluster(coords, charge=charge,
                                        dtype=torch.float64, device="cpu"),
            jmol.build_hydrogen_cluster(coords, charge=charge,
                                        dtype=jnp.float64))


def test_h5_plus_chain_build_matches_jax(h5p):
    tp, jp = h5p
    assert len(tp.terms) == 444
    _close_terms(tp.terms, jp.terms)
    assert abs(tp.exact_ground_energy - jp.exact_ground_energy) <= 1e-10
    assert tp.e_nuc == jp.e_nuc
    assert tp.ham.is_structured_only and jp.ham.is_structured_only
    assert tp.ham.n_controls == jp.ham.n_controls == 54  # 20 + 17 x 2
    assert [(s.kind, s.qubit, s.qubit2) for s in tp.ham.structure] == \
        [(s.kind, s.qubit, s.qubit2) for s in jp.ham.structure]
    for st, sj in zip(tp.ham.structure, jp.ham.structure):
        if st.kind == "diag":
            np.testing.assert_array_equal(st.diag, np.asarray(sj.diag))
        elif st.kind == "1q":
            np.testing.assert_array_equal(st.local, np.asarray(sj.local))
    assert tp.envelope.omegas == jp.envelope.omegas
    assert int(torch.argmax(tp.psi0.re)) == 0b1111000000 == \
        int(np.argmax(np.asarray(jp.psi0.re)))
    ts, js = tp.measurement.strings, jp.measurement.strings
    assert (ts.flips, ts.yz_masks, ts.n_ys) == (js.flips, js.yz_masks,
                                                js.n_ys)
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))


def test_h5_plus_energy_at_the_rhf_determinant(h5p):
    """The number penalty vanishes on the RHF determinant, so the strings
    measure E_RHF (electronic) there: an independent check of the
    integrals, the symbolic JW terms and the penalty merge."""
    tp, _ = h5p
    coords, charge = H5P
    centers = [np.asarray(c) * tmol.ANGSTROM_TO_BOHR for c in coords]
    S, h, g, _ = tmol.cluster_integrals(centers)
    e_rhf, _ = tmol.rhf_scf(S, h, g, (len(coords) - charge) // 2)
    e = float(tp.measurement.expectation(tp.psi0))
    assert abs(e - e_rhf) <= 1e-10 * abs(e_rhf), (e, e_rhf)
    assert e_rhf - 0.1 < tp.exact_ground_energy < e_rhf - 1e-3


def _jax_energy_and_grad(jp, coeff, n_steps):
    """JAX's value and gradient at H5+: ``jax.vjp`` of its ``evolve``
    ('auto', its fused engine) at the cotangent 2 M psi(T) from its own
    ``PauliStringSet.apply``, which is the gradient ``energy_and_grad``
    takes (its jit of the 444 strings' own gradient compiles for about a
    minute on the CPU)."""
    psi, vjp = jax.vjp(lambda c: jevolve(jp.ham, jp.envelope, c, jp.psi0,
                                         0.0, jp.T, horizon=jp.T,
                                         n_steps=n_steps), jnp.asarray(coeff))
    mp = jp.measurement.strings.apply(psi)
    (g,) = vjp(jcpx.CP(2.0 * mp.re, 2.0 * mp.im))
    return jp.measurement.expectation(psi), g


@pytest.mark.parametrize("which", ["h2", "h5p"])
def test_energy_and_grad_matches_jax(which):
    """float32; H2 on dense 'expm' through both entry points, H5+ through
    the port's plain 'streamed' chain with hops (K1's plain version on
    the CPU)."""
    if which == "h2":
        tp = tmol.build_h2_at(R_EQ, device="cpu")
        jp = jmol.build_h2_at(R_EQ, dtype=jnp.float32)
        tkw, n_steps = {}, 10
    else:
        coords, charge = H5P
        tp = tmol.build_hydrogen_cluster(coords, charge=charge,
                                         compute_exact=False, device="cpu")
        jp = jmol.build_hydrogen_cluster(coords, charge=charge,
                                         compute_exact=False,
                                         dtype=jnp.float32)
        tkw, n_steps = dict(backend="product_fused"), 4
    coeff = (0.3 * np.random.default_rng(5).standard_normal(
        tp.envelope.coeff_shape)).astype(np.float32)
    if which == "h2":
        jv, jg = jadj.energy_and_grad(jp.ham, jp.envelope, jp.measurement,
                                      jnp.asarray(coeff), jp.psi0, jp.T,
                                      n_steps)
    else:
        jv, jg = _jax_energy_and_grad(jp, coeff, n_steps)
    tv, tg = tadj.energy_and_grad(tp.ham, tp.envelope, tp.measurement,
                                  torch.tensor(coeff), tp.psi0, tp.T,
                                  n_steps, **tkw)
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())
    assert tfp.FWD_LAUNCHES == 0 and tfp.BWD_LAUNCHES == 0  # plain path
