"""The port's trajectories and the adaptive-ODE engine against the JAX
package on the CPU: ``evolve_product_trajectory``, ``evolve_ode`` and
``fd_energy_grad_ode``, and the three samplers of ``dynamics/lindblad.py``
draw for draw.

The samplers take a ``torch.Generator`` where JAX takes a key, so their
streams differ; each takes its draws injected instead. The tests rebuild
JAX's own key chain (``keys = split(key, n_traj)``, then per step
``k, k_r, k_c = split(k, 3)``, ``uniform(k_r)`` for the jump decision and
``gumbel(k_c, (n_ch,))`` for the channel; the dephasing kicks are
``normal(key, (n_traj, n_steps, n_ch))``) and hand the port the same
numbers, so both take the same jumps.

Tolerances: float64 values to 1e-9 and gradients to 1e-7 of the
gradient's max-norm; the 'fused' backend runs K2's plain version in
float32 against JAX's float32 'xla' path at the tolerances of the JAX
package's own 'fused' vs 'xla' test (states and logps rtol 1e-4, atol
1e-5; the surrogate's gradient rtol 5e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import lindblad as jlb
from diffquantum_tpu.dynamics import ode as jode
from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu_torch.dynamics import lindblad as tlb
from diffquantum_tpu_torch.dynamics import ode as tode
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.utils import profiling
from test_torch_lindblad import (F64, VAL_ATOL, _grad_close, _j, _t,
                                 dense_twin, structured_problem)


def _states_close(got, want, atol=VAL_ATOL, rtol=0.0):
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=rtol, atol=atol)


def _maxcut(n, dtype, dense=False):
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    return (jmaxcut.build_maxcut(n, jmaxcut.ring_graph(n), n_basis=4,
                                 dense=dense, dtype=jdt),
            tmaxcut.build_maxcut(n, tmaxcut.ring_graph(n), n_basis=4,
                                 dense=dense, dtype=dtype, device="cpu"))


# ---------------------------------------------------------------------------
# JAX's key chain, rebuilt
# ---------------------------------------------------------------------------

def jax_mcwf_draws(key, n_traj, n_steps, n_ch, dtype):
    """(uniform [n_steps, n_traj], gumbel [n_steps, n_traj, n_ch], the
    channel keys) of JAX's per-trajectory chain."""
    def one(k):
        def body(k, _):
            k, k_r, k_c = jax.random.split(k, 3)
            return k, (jax.random.uniform(k_r, dtype=dtype),
                       jax.random.gumbel(k_c, (n_ch,), dtype), k_c)
        return jax.lax.scan(body, k, None, length=n_steps)[1]

    uni, gum, k_c = jax.jit(jax.vmap(one))(jax.random.split(key, n_traj))
    return (np.asarray(uni).T, np.asarray(gum).transpose(1, 0, 2),
            k_c.reshape((-1,) + k_c.shape[2:]))


def _port_draws(uni, gum, dtype=F64):
    return tlb.McwfDraws(torch.tensor(uni, dtype=dtype),
                         torch.tensor(gum, dtype=dtype))


def test_gumbel_argmax_is_jax_categorical():
    """The channel rule the port replays, argmax(logits + gumbel), is
    jax.random.categorical for the keys the parity tests use."""
    for key, n_traj, n_steps, n_ch, dt in (
            (jax.random.PRNGKey(11), 16, 12, 2, jnp.float64),
            (jax.random.PRNGKey(9), 6, 12, 7, jnp.float32),
            (jax.random.PRNGKey(13), 32, 12, 2, jnp.float64)):
        _, gum, k_c = jax_mcwf_draws(key, n_traj, n_steps, n_ch, dt)
        logits = jnp.asarray(np.random.default_rng(0).standard_normal(
            (k_c.shape[0], n_ch)), dt)
        want = jax.vmap(jax.random.categorical)(k_c, logits)
        got = np.argmax(np.asarray(logits) + gum.transpose(1, 0, 2).reshape(
            -1, n_ch), axis=-1)
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the product trajectory and the ODE engine
# ---------------------------------------------------------------------------

def test_product_trajectory_matches_jax():
    """10 qubits, 12 steps, float64: every state, the endpoint against
    evolve_product, and the gradient of the summed energies along the
    trajectory."""
    jp, tp = _maxcut(10, F64)
    coeff = np.random.default_rng(3).standard_normal(
        jp.envelope.coeff_shape) * 0.4
    T, ns = jp.T, 12
    w_j, w_t = jp.measurement.diag, tp.measurement.diag

    def jloss(c):
        tr = jprod.evolve_product_trajectory(jp.ham, jp.envelope, c,
                                             jp.psi0, 0.0, T, horizon=T,
                                             n_steps=ns)
        return jnp.sum(jcpx.abs2(tr) * w_j), tr

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(coeff))
    c = torch.tensor(coeff, requires_grad=True)
    got = tprod.evolve_product_trajectory(tp.ham, tp.envelope, c, tp.psi0,
                                          0.0, T, horizon=T, n_steps=ns)
    assert got.shape == (ns + 1, 2**10)
    torch.sum(tcpx.abs2(got) * w_t).backward()
    _states_close(got, want)
    _grad_close(c.grad, jg)
    end = tprod.evolve_product(tp.ham, tp.envelope, c.detach(), tp.psi0,
                               0.0, T, horizon=T, n_steps=ns)
    assert torch.equal(end.re, got.re[-1]) and torch.equal(end.im,
                                                           got.im[-1])
    assert torch.equal(got.re[0], tp.psi0.re)


def _ode_problem():
    jp, tp = _maxcut(3, F64, dense=True)
    coeff = np.random.default_rng(5).standard_normal(
        jp.envelope.coeff_shape) * 0.5
    return jp, tp, coeff


def test_evolve_ode_matches_jax():
    """3 qubits, dense: one state and a batch of two. The integrators run
    at rtol = atol = 1e-12: at the default 1e-10 the two step controllers
    part ways on last-bit differences of u(t), 2e-9 apart."""
    jp, tp, coeff = _ode_problem()
    T = 0.5 * jp.T
    batch = np.stack([tcpx.to_complex(tp.psi0),
                      np.roll(tcpx.to_complex(tp.psi0), 1) * 1j])
    for psi_t, psi_j in ((tp.psi0, jp.psi0), (_t(batch), _j(batch))):
        want = jode.evolve_ode(jp.ham, jp.envelope, jnp.asarray(coeff),
                               psi_j, 0.0, T, horizon=T, rtol=1e-12,
                               atol=1e-12)
        got = tode.evolve_ode(tp.ham, tp.envelope, torch.tensor(coeff),
                              psi_t, 0.0, T, horizon=T, rtol=1e-12,
                              atol=1e-12)
        assert got.dtype == psi_t.dtype and got.shape == psi_t.shape
        _states_close(got, want)


def test_fd_energy_grad_ode_matches_jax():
    """3 qubits, dense, a ZZ chain with X and Y drive sums (6
    coefficients, 12 adaptive runs a side)."""
    from diffquantum_tpu.dynamics.hamiltonian import \
        ControlledHamiltonian as JHam
    from diffquantum_tpu.measure import Measurement as JMeas
    from diffquantum_tpu.ops import linalg
    from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnv
    from diffquantum_tpu_torch.dynamics.hamiltonian import \
        ControlledHamiltonian as THam
    from diffquantum_tpu_torch.measure import Measurement as TMeas
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope as TEnv
    h0 = 0.5 * (linalg.pauli_string("ZZI") + linalg.pauli_string("IZZ"))
    hs = [sum(linalg.pauli_string(lb) for lb in ("XII", "IXI", "IIX")),
          sum(linalg.pauli_string(lb) for lb in ("YII", "IYI", "IIY"))]
    diag = np.linspace(-1.0, 1.0, 8)
    psi0 = np.full(8, 8 ** -0.5)
    coeff = np.random.default_rng(6).standard_normal((2, 3)) * 0.5
    omegas = (np.pi, np.pi)
    T = 1.0
    want = jode.fd_energy_grad_ode(
        JHam.create(h0, hs, dtype=jnp.float64),
        JEnv(basis="bspline", n_basis=3, omegas=omegas),
        JMeas.create_diagonal(diag, dtype=jnp.float64), jnp.asarray(coeff),
        _j(psi0), T)
    got = tode.fd_energy_grad_ode(
        THam.create(h0, hs, dtype=F64, device="cpu"),
        TEnv(basis="bspline", n_basis=3, omegas=omegas),
        TMeas.create_diagonal(diag, dtype=F64, device="cpu"),
        torch.tensor(coeff), _t(psi0), T)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# the samplers, draw for draw
# ---------------------------------------------------------------------------

def test_mcwf_structured_matches_jax():
    """'xla' at 4 qubits, T1 + dephasing, 16 trajectories x 12 steps,
    float64: states, logps and the score-surrogate gradient."""
    p = structured_problem(n=4, seed=3)
    jh, th = p["ham"]
    je, te = p["env"]
    jn, tn = p["noise"]
    d, n_traj, ns, T = 16, 16, 12, 1.0
    plus = np.full(d, d ** -0.5)
    w = np.linspace(-1, 1, d)
    key = jax.random.PRNGKey(11)
    uni, gum, _ = jax_mcwf_draws(key, n_traj, ns, 2, jnp.float64)

    def jloss(c):
        ps, lp = jlb.evolve_mcwf_structured(
            jh, je, c, _j(plus), jn, 0.0, T, horizon=T, n_steps=ns, key=key,
            n_traj=n_traj, return_logp=True)
        vals = jnp.sum(jcpx.abs2(ps) * w, axis=-1)
        return jlb.score_surrogate(vals, lp), (ps, lp)

    (jv, (jps, jlp)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(p["coeff"]))
    c = torch.tensor(p["coeff"], requires_grad=True)
    ps, lp = tlb.evolve_mcwf_structured(
        th, te, c, _t(plus), tn, 0.0, T, horizon=T, n_steps=ns,
        n_traj=n_traj, return_logp=True, draws=_port_draws(uni, gum))
    vals = torch.sum(tcpx.abs2(ps) * torch.tensor(w), dim=-1)
    tv = tlb.score_surrogate(vals, lp)
    tv.backward()
    _states_close(ps, jps)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp),
                               rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(tv.item(), float(jv), atol=VAL_ATOL)
    _grad_close(c.grad, jg)
    # the draws took jumps: not every trajectory followed the no-jump path
    assert np.ptp(np.asarray(jlp)) > 1e-3


def test_mcwf_structured_fused_10q_matches_jax_xla():
    """'fused' at 10 qubits (K2's plain version on the CPU, one shared
    angle row a step) against JAX's float32 'xla' path, the noise of the
    JAX 'fused' vs 'xla' test."""
    jp, tp = _maxcut(10, torch.float32)
    coeff = (np.random.default_rng(3).standard_normal(
        jp.envelope.coeff_shape) * 0.3).astype(np.float32)
    kw = dict(t1=[(q, 0.3) for q in range(0, 10, 2)],
              dephasing=[(1, 0.2), (7, 0.4)])
    jn, tn = jlb.StructuredNoise(10, **kw), tlb.StructuredNoise(10, **kw)
    n_traj, ns, T = 6, 12, float(jp.T)
    key = jax.random.PRNGKey(9)
    uni, gum, _ = jax_mcwf_draws(key, n_traj, ns, 7, jnp.float32)
    w_j, w_t = jp.measurement.diag, tp.measurement.diag

    def jloss(c):
        ps, lp = jlb.evolve_mcwf_structured(
            jp.ham, jp.envelope, c, jp.psi0, jn, 0.0, T, horizon=T,
            n_steps=ns, key=key, n_traj=n_traj, return_logp=True,
            backend="xla")
        return jlb.score_surrogate(jnp.sum(jcpx.abs2(ps) * w_j, axis=-1),
                                   lp), (ps, lp)

    (jv, (jps, jlp)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(coeff))
    c = torch.tensor(coeff, requires_grad=True)
    ps, lp = tlb.evolve_mcwf_structured(
        tp.ham, tp.envelope, c, tp.psi0, tn, 0.0, T, horizon=T, n_steps=ns,
        n_traj=n_traj, return_logp=True, backend="fused",
        draws=_port_draws(uni, gum, torch.float32))
    tv = tlb.score_surrogate(torch.sum(tcpx.abs2(ps) * w_t, dim=-1), lp)
    tv.backward()
    for a, b in ((ps.re, jps.re), (ps.im, jps.im), (lp, jlp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    assert np.isfinite(tv.item())
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-4)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg), rtol=5e-3,
                               atol=1e-5)
    assert np.ptp(np.asarray(jlp)) > 1e-3


def test_dephasing_trajectories_match_jax():
    """3 qubits, dephasing on qubit 2, 24 trajectories x 12 steps, the
    JAX kicks injected: states and the pathwise gradient."""
    p = structured_problem(n=3, seed=4, with_t1=False)
    jh, th = p["ham"]
    je, te = p["env"]
    jn, tn = p["noise"]
    d, n_traj, ns, T = 8, 24, 12, 1.2
    plus = np.full(d, d ** -0.5)
    w = np.linspace(-1, 1, d)
    key = jax.random.PRNGKey(5)
    xi = np.asarray(jax.random.normal(key, (n_traj, ns, 1), jnp.float64))

    def jloss(c):
        ps = jlb.evolve_dephasing_trajectories(
            jh, je, c, _j(plus), jn, 0.0, T, horizon=T, n_steps=ns, key=key,
            n_traj=n_traj)
        return jnp.mean(jnp.sum(jcpx.abs2(ps) * w, axis=-1)), ps

    (_, jps), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(p["coeff"]))
    c = torch.tensor(p["coeff"], requires_grad=True)
    ps = tlb.evolve_dephasing_trajectories(
        th, te, c, _t(plus), tn, 0.0, T, horizon=T, n_steps=ns,
        n_traj=n_traj, xi=torch.tensor(xi))
    torch.mean(torch.sum(tcpx.abs2(ps) * torch.tensor(w), dim=-1)).backward()
    _states_close(ps, jps)
    _grad_close(c.grad, jg)


def test_mcwf_dense_matches_jax():
    """The dense sampler at 2 qubits (T1 + dephasing), 32 trajectories x
    12 steps: states draw for draw and the pathwise gradient; the no-jump
    branch is one 'apply' step a step (the recurrence route on the
    CPU)."""
    p = structured_problem(n=2, seed=3)
    jd, td = dense_twin(p)
    je, te = p["env"]
    ops = p["noise"][0].dense_collapse_ops()
    jc = jlb.CollapseSet.create(ops, dtype=jnp.float64)
    tc = tlb.CollapseSet.create(ops, dtype=F64, device="cpu")
    n_traj, ns, T = 32, 12, 1.0
    plus = np.full(4, 0.5)
    w = np.linspace(-1, 1, 4)
    key = jax.random.PRNGKey(13)
    uni, gum, _ = jax_mcwf_draws(key, n_traj, ns, 2, jnp.float64)

    def jloss(c):
        ps = jlb.evolve_mcwf(jd, je, c, _j(plus), jc, 0.0, T, horizon=T,
                             n_steps=ns, key=key, n_traj=n_traj)
        return jnp.mean(jnp.sum(jcpx.abs2(ps) * w, axis=-1)), ps

    (_, jps), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(p["coeff"]))
    c = torch.tensor(p["coeff"], requires_grad=True)
    before = profiling.counters()["apply_recurrence"]
    ps = tlb.evolve_mcwf(td, te, c, _t(plus), tc, 0.0, T, horizon=T,
                         n_steps=ns, n_traj=n_traj,
                         draws=_port_draws(uni, gum))
    assert profiling.counters()["apply_recurrence"] - before == ns
    torch.mean(torch.sum(tcpx.abs2(ps) * torch.tensor(w), dim=-1)).backward()
    _states_close(ps, jps)
    _grad_close(c.grad, jg)
    # jumps happened: the trajectories are not all alike
    assert np.ptp(np.abs(jcpx.to_complex(jps)) ** 2, axis=0).max() > 1e-2


def test_samplers_draw_from_a_generator():
    """Without draws, each sampler draws from the generator: the same
    seed gives the same trajectories, another seed others."""
    p = structured_problem(n=3, seed=1)
    th, te, tn = p["ham"][1], p["env"][1], p["noise"][1]
    psi0 = _t(np.full(8, 8 ** -0.5))
    c = torch.tensor(p["coeff"])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tlb.evolve_mcwf_structured(th, te, c, psi0, tn, 0.0, 1.0,
                                          horizon=1.0, n_steps=8,
                                          generator=g, n_traj=8)

    a, b, other = run(0), run(0), run(1)
    assert torch.equal(a.re, b.re) and not torch.equal(a.re, other.re)
    with pytest.raises(ValueError, match="Generator or the draws"):
        tlb.evolve_mcwf_structured(th, te, c, psi0, tn, 0.0, 1.0,
                                   horizon=1.0, n_steps=8, n_traj=8)
