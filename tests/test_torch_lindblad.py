"""The port's open-system dynamics (``dynamics/lindblad.py``) against the
JAX package on the CPU, float64: the builders, the four forms of
``expectation_rho``, the trajectory readouts, ``score_surrogate``, and the
dense and structured master equations with their (checkpointed)
gradients.

Tolerances: values to 1e-9 absolute and gradients to 1e-7 of the
gradient's max-norm, the same arithmetic in another order (the port's
structured backward rebuilds rho by inverse rotations where JAX keeps
it). States stay at 6 qubits or fewer, a dozen steps. The samplers are in
``test_torch_ode_trajectory.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import hamiltonian as jham
from diffquantum_tpu.dynamics import lindblad as jlb
from diffquantum_tpu.measure import Measurement as JMeasurement
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnv
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import lindblad as tlb
from diffquantum_tpu_torch.measure import Measurement as TMeasurement
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.ops import linalg as tlinalg
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope as TEnv

F64 = torch.float64
VAL_ATOL = 1e-9
GRAD_REL = 1e-7


def _grad_close(got, want, rel=GRAD_REL):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


def _t(a, dtype=F64):
    return tcpx.from_complex(a, dtype=dtype, device="cpu")


def _j(a, dtype=jnp.float64):
    return jcpx.from_complex(a, dtype=dtype)


def _random_rho(rng, d):
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


def _terms(n, palindromic):
    """(kind, payload) of the structured test problem: a ZZ chain and X on
    every qubit; ``palindromic`` adds Y on qubit 0, so that two drives
    share a qubit and the rotation block runs palindromically."""
    out = [("diag", jlinalg.zz_diagonal(n, i, (i + 1) % n))
           for i in range(n - 1)]
    out += [("1q", (q, jlinalg.X)) for q in range(n)]
    if palindromic:
        out.append(("1q", (0, jlinalg.Y)))
    return out


def structured_problem(n=2, seed=0, with_t1=True, palindromic=False,
                       dephasing=True, dtype=F64):
    """The JAX tests' driven noisy system (``tests/test_lindblad.py::
    _structured_noisy_problem``) in both packages: dict of (JAX, port)
    pairs: ham, env, noise, and the coefficients as numpy."""
    d = 2**n
    h0 = 0.3 * np.arange(d) / d
    pairs = {}
    for mod, ts in ((jham, "jax"), (tham, "torch")):
        st = []
        for kind, pay in _terms(n, palindromic):
            if kind == "diag":
                st.append(mod.TermStructure(kind="diag", diag=pay))
            else:
                st.append(mod.TermStructure(kind="1q", qubit=pay[0],
                                            local=pay[1]))
        h0s = mod.TermStructure(kind="diag", diag=h0)
        if ts == "jax":
            pairs[ts] = mod.ControlledHamiltonian.create_structured(
                d, tuple(st), h0_structure=h0s, dtype=jnp.float64
                if dtype == F64 else jnp.float32)
        else:
            pairs[ts] = mod.ControlledHamiltonian.create_structured(
                d, tuple(st), h0_structure=h0s, dtype=dtype)
    n_c = len(_terms(n, palindromic))
    omegas = (np.pi,) * n_c
    t1 = [(0, 0.35)] if with_t1 else []
    deph = [(n - 1, 0.4)] if dephasing else []
    coeff = np.random.default_rng(seed).standard_normal((n_c, 4)) * 0.5
    return dict(
        ham=(pairs["jax"], pairs["torch"]),
        env=(JEnv(basis="bspline", n_basis=4, omegas=omegas),
             TEnv(basis="bspline", n_basis=4, omegas=omegas)),
        noise=(jlb.StructuredNoise(n, t1=t1, dephasing=deph),
               tlb.StructuredNoise(n, t1=t1, dephasing=deph)),
        coeff=coeff, n=n)


def dense_twin(p, dtype=F64):
    """Dense Hamiltonians with the structured problem's physics."""
    jh = p["ham"][0]
    n = p["n"]
    hs = [np.diag(np.asarray(st.diag)) if st.kind == "diag" else
          jlinalg.op_on_qubits(np.asarray(st.local), [st.qubit], n)
          for st in jh.structure]
    h0 = np.diag(np.asarray(jh.h0_structure.diag))
    return (jham.ControlledHamiltonian.create(h0, hs, dtype=jnp.float64),
            tham.ControlledHamiltonian.create(h0, hs, dtype=dtype,
                                              device="cpu"))


# ---------------------------------------------------------------------------
# builders and readouts
# ---------------------------------------------------------------------------

def test_builders_match_jax():
    n = 3
    for g, q in ((0.2, 0), (0.7, 2)):
        np.testing.assert_array_equal(tlb.amplitude_damping(g, q, n),
                                      jlb.amplitude_damping(g, q, n))
        np.testing.assert_array_equal(tlb.dephasing(g, q, n),
                                      jlb.dephasing(g, q, n))
    kw = dict(t1=[(0, 0.3), (2, 0.1)], dephasing=[(1, 0.25)])
    jn, tn = jlb.StructuredNoise(n, **kw), tlb.StructuredNoise(n, **kw)
    np.testing.assert_array_equal(tn.k_diag(), jn.k_diag())
    assert tn.k_norm == jn.k_norm
    for a, b in zip(tn.dense_collapse_ops(), jn.dense_collapse_ops()):
        np.testing.assert_array_equal(a, b)
    ops = jn.dense_collapse_ops()
    jc = jlb.CollapseSet.create(ops, dtype=jnp.float64)
    tc = tlb.CollapseSet.create(ops, dtype=F64, device="cpu")
    assert tc.norms == jc.norms and tc.k_norm == jc.k_norm
    np.testing.assert_array_equal(tcpx.to_complex(tc.ops),
                                  jcpx.to_complex(jc.ops))
    np.testing.assert_allclose(tcpx.to_complex(tc.k_op),
                               jcpx.to_complex(jc.k_op), atol=1e-15)
    with pytest.raises(ValueError, match="at least one"):
        tlb.StructuredNoise(n)
    with pytest.raises(ValueError, match="at least one"):
        tlb.CollapseSet.create([], device="cpu")


@pytest.mark.parametrize("form", ["vector", "cp", "diag", "dense", "target",
                                  "strings"])
def test_expectation_rho_matches_jax(form):
    rng = np.random.default_rng(1)
    n, d = 3, 8
    rho = _random_rho(rng, d)
    diag = rng.standard_normal(d)
    mat = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    mat = mat + mat.conj().T
    tgt = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    tgt /= np.linalg.norm(tgt)
    terms = [("ZZI", -1.0), ("XIY", 0.7), ("IYI", -0.3), ("XYZ", 0.2),
             ("YYI", 0.4)]
    cpu = dict(dtype=F64, device="cpu")
    jm, tm = {
        "vector": (jnp.asarray(diag), torch.tensor(diag, dtype=F64)),
        "cp": (_j(mat), _t(mat)),
        "diag": (JMeasurement.create_diagonal(diag, dtype=jnp.float64),
                 TMeasurement.create_diagonal(diag, **cpu)),
        "dense": (JMeasurement.create(mat, dtype=jnp.float64),
                  TMeasurement.create(mat, **cpu)),
        "target": (JMeasurement.create_target(tgt, dtype=jnp.float64),
                   TMeasurement.create_target(tgt, **cpu)),
        "strings": (JMeasurement.create_strings(terms, dtype=jnp.float64),
                    TMeasurement.create_strings(terms, **cpu)),
    }[form]
    want = float(jlb.expectation_rho(jm, _j(rho)))
    got = float(tlb.expectation_rho(tm, _t(rho)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if form == "strings":  # and against the dense operator
        m = sum(w * tlinalg.pauli_string(lb) for lb, w in terms)
        np.testing.assert_allclose(got, np.trace(m @ rho).real, atol=1e-12)


def test_density_and_score_surrogate_match_jax():
    rng = np.random.default_rng(2)
    psis = rng.standard_normal((7, 4)) + 1j * rng.standard_normal((7, 4))
    np.testing.assert_allclose(
        tcpx.to_complex(tlb.density_from_trajectories(_t(psis))),
        jcpx.to_complex(jlb.density_from_trajectories(_j(psis))),
        rtol=0, atol=1e-14)
    a, b = rng.standard_normal(7), rng.standard_normal(7)
    for n_traj in (1, 7):
        def jloss(x):
            return jlb.score_surrogate(jnp.sin(x[:n_traj]) * a[:n_traj],
                                       jnp.cos(x[:n_traj]) * b[:n_traj])
        x0 = rng.standard_normal(7)
        jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x0))
        x = torch.tensor(x0, requires_grad=True)
        tv = tlb.score_surrogate(torch.sin(x[:n_traj]) * torch.tensor(
            a[:n_traj]), torch.cos(x[:n_traj]) * torch.tensor(b[:n_traj]))
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), atol=1e-14)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   atol=1e-14)


# ---------------------------------------------------------------------------
# the master equations
# ---------------------------------------------------------------------------

def _loss_pair(p, w):
    """tr(diag(w) rho) for both packages."""
    return (lambda rho: jlb.expectation_rho(jnp.asarray(w), rho),
            lambda rho: tlb.expectation_rho(torch.tensor(w, dtype=F64),
                                            rho))


def _value_and_grad(jrun, trun, coeff, w, p):
    jloss, tloss = _loss_pair(p, w)
    jv, jg = jax.value_and_grad(lambda c: jloss(jrun(c)))(jnp.asarray(coeff))
    c = torch.tensor(coeff, requires_grad=True)
    out = trun(c)
    tloss(out).backward()
    return out, c.grad, jrun(jnp.asarray(coeff)), jg


def test_evolve_lindblad_matches_jax():
    """The dense engine on the 2-qubit noisy system (T1 + dephasing):
    rho(T) and the checkpointed gradient."""
    p = structured_problem(n=2, seed=3)
    jd, td = dense_twin(p)
    jn, tn = p["noise"]
    ops = jn.dense_collapse_ops()
    jc = jlb.CollapseSet.create(ops, dtype=jnp.float64)
    tc = tlb.CollapseSet.create(ops, dtype=F64, device="cpu")
    rho0 = np.full((4, 4), 0.25)
    T, ns = 1.0, 12
    je, te = p["env"]
    w = np.linspace(-1, 1, 4)
    got, g, want, jg = _value_and_grad(
        lambda c: jlb.evolve_lindblad(jd, je, c, _j(rho0), jc, 0.0, T,
                                      horizon=T, n_steps=ns),
        lambda c: tlb.evolve_lindblad(td, te, c, _t(rho0), tc, 0.0, T,
                                      horizon=T, n_steps=ns),
        p["coeff"], w, p)
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=VAL_ATOL)
    _grad_close(g, jg)
    assert tlb.lindblad_norm_bound(td, te, tc) == \
        jlb.lindblad_norm_bound(jd, je, jc)


@pytest.mark.parametrize("case", ["t1_dephasing", "palindromic",
                                  "t1_only"])
def test_evolve_lindblad_structured_matches_jax(case):
    """The structured master equation at 3 qubits (4 with the
    palindromic drive set): rho(T) and the gradient through the
    checkpointed steps and the unitary block's rebuilding backward."""
    kw = {"t1_dephasing": dict(n=3, seed=2),
          "palindromic": dict(n=4, seed=5, palindromic=True),
          "t1_only": dict(n=3, seed=7, dephasing=False)}[case]
    p = structured_problem(**kw)
    jh, th = p["ham"]
    je, te = p["env"]
    jn, tn = p["noise"]
    n = p["n"]
    d = 2**n
    rho0 = _random_rho(np.random.default_rng(4), d)
    T, ns = 1.2, 10
    w = np.cos(np.linspace(0, 5, d))
    got, g, want, jg = _value_and_grad(
        lambda c: jlb.evolve_lindblad_structured(
            jh, je, c, _j(rho0), jn, 0.0, T, horizon=T, n_steps=ns),
        lambda c: tlb.evolve_lindblad_structured(
            th, te, c, _t(rho0), tn, 0.0, T, horizon=T, n_steps=ns),
        p["coeff"], w, p)
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=VAL_ATOL)
    _grad_close(g, jg)
    np.testing.assert_allclose(np.trace(tcpx.to_complex(got)).real,
                               np.trace(rho0).real, atol=1e-12)


def test_structured_block_backward_equals_autograd():
    """The unitary block's rebuilding backward against autograd through
    the same ops (rho and both angle sets), at 3 qubits."""
    rng = np.random.default_rng(8)
    n, d = 3, 8
    rho0 = torch.tensor(_random_rho(rng, d))
    theta0 = torch.tensor(rng.standard_normal(d), requires_grad=True)
    alphas0 = torch.tensor(rng.standard_normal(4), requires_grad=True)
    ops = tuple((q, torch.tensor(g))
                for q, g in ((0, tlinalg.X), (2, tlinalg.Y), (1, tlinalg.X),
                             (0, tlinalg.Y)))
    gout = torch.tensor(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    rho = rho0.clone().requires_grad_(True)
    out = tlb._UnitaryBlock.apply(rho, theta0, alphas0, ops, n)
    (out.real * gout.real + out.imag * gout.imag).sum().backward()
    got = [x.grad.clone() for x in (rho, theta0, alphas0)]
    for x in (rho, theta0, alphas0):
        x.grad = None
    out = tlb._rho_phase(rho, theta0)
    for i, (q, g) in enumerate(ops):
        out = tlb._rho_1q_rot(out, alphas0[i], q, n, g)
    out = tlb._rho_phase(out, theta0)
    (out.real * gout.real + out.imag * gout.imag).sum().backward()
    for a, x in zip(got, (rho, theta0, alphas0)):
        _grad_close(a.numpy(), x.grad.numpy(), rel=1e-12)
