"""Guards of the PyTorch port: it imports neither JAX, optax nor the JAX
package (the sharded engine and its collectives, the facades, the native
bindings and the demos_torch scripts included), its entry points refuse
to run on the CPU unless asked (make_mesh, the molecule build functions
and the facades too), what is ported keeps its refusals, the MC and FD
estimators run at 18 qubits, the JAX package's engine names are no
backends, the dense 'auto' rule and the CPU's route of 'apply', a mesh
larger than the world raises, and chip_smoke.py fails without a
card."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffquantum_tpu_torch import convert
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.dynamics import propagator as tprop
from diffquantum_tpu_torch.dynamics.propagator import evolve
from diffquantum_tpu_torch.gradients.fd import fd_energy_grad
from diffquantum_tpu_torch.gradients.mc import (envelope_jacobian,
                                                mc_energy_grad,
                                                mc_energy_grad_batch)
from diffquantum_tpu_torch.measure import Measurement
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import linalg
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel.mesh import make_mesh, train_energy_seeds
from diffquantum_tpu_torch.parallel.sharded_state import \
    sharded_strings_expectation
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
from diffquantum_tpu_torch.train.config import TrainConfig
from diffquantum_tpu_torch.train.energy import train_energy

REPO = pathlib.Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "optax", "diffquantum_tpu"))


def test_port_imports_no_jax():
    files = sorted((REPO / "diffquantum_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_step.py",
              REPO / "scripts" / "sharded_multicard.py"]
    files += [REPO / "scripts" / f"{name}.py" for name in (
        "k7_times", "k7_variants", "grid_barrier_bench", "pk_times",
        "fp_times", "fp_variants")]
    demos = sorted((REPO / "demos_torch").glob("*.py"))
    assert len(demos) == 9
    files += demos
    assert len(files) > 15
    names = {str(f.relative_to(REPO / "diffquantum_tpu_torch"))
             for f in files if "diffquantum_tpu_torch" in f.parts}
    assert {"ops/expm.py", "ops/taylor_apply.py", "train/gate.py",
            "train/fidelity.py", "models/control.py",
            "models/vqe_h2.py", "parallel/comm.py",
            "parallel/sharded_state.py", "models/molecule.py",
            "utils/checkpointing.py", "utils/profiling.py",
            "utils/plotting.py", "dynamics/lindblad.py",
            "dynamics/ode.py", "compat/diffqc.py", "compat/sim_plain.py",
            "native/bindings.py"} <= names
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                bad += [(f.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((f.name, node.module))
    assert not bad, bad


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["build_maxcut", "init_coeff", "convert",
                                   "measurement", "make_mesh", "build_h2_at",
                                   "sector_fci_from_strings",
                                   "collapse_set", "simulator_plain",
                                   "diffqc_set_H"])
def test_entry_points_need_a_card_unless_asked(no_card, entry, tmp_path):
    from diffquantum_tpu_torch.compat import SimulatorPlain, diffqc
    from diffquantum_tpu_torch.dynamics.lindblad import (CollapseSet,
                                                         amplitude_damping)
    from diffquantum_tpu_torch.models import molecule
    env = SimpleEnvelope(basis="bspline", n_basis=4, omegas=(1.0,))
    call = {
        "build_maxcut": lambda: tmaxcut.build_maxcut(
            10, tmaxcut.ring_graph(10)),
        "init_coeff": lambda: env.init_coeff(torch.Generator()),
        "convert": lambda: convert.params_from_numpy(np.zeros((1, 4))),
        "measurement": lambda: Measurement.create_diagonal(np.zeros(4)),
        "make_mesh": lambda: make_mesh({"state": 1}),
        "build_h2_at": lambda: molecule.build_h2_at(0.7414),
        "sector_fci_from_strings": lambda: molecule.sector_fci_from_strings(
            [("ZZ", 1.0)], 2, 1),
        "collapse_set": lambda: CollapseSet.create(
            [amplitude_damping(0.1, 0, 1)]),
        "simulator_plain": lambda: SimulatorPlain(log_dir=str(tmp_path)),
        "diffqc_set_H": lambda: diffqc.set_H(
            np.zeros((2, 2)), [linalg.X], [[[0.0, 1.0, 0.0, 0]]], 1.0, 0),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def _small_problem():
    return tmaxcut.build_maxcut(10, tmaxcut.ring_graph(10), n_basis=4,
                                device="cpu")


@pytest.mark.parametrize("backend,error,match", [
    # engine names, which the JAX package's evolve does not take either
    pytest.param("packed", ValueError, "unknown backend", id="packed"),
    pytest.param("mega", ValueError, "unknown backend", id="mega"),
    pytest.param("mega_hop", ValueError, "unknown backend",
                 id="mega_hop")])
def test_unported_backends_raise(backend, error, match):
    p = _small_problem()
    c = torch.zeros(p.envelope.coeff_shape)
    with pytest.raises(error, match=match):
        evolve(p.ham, p.envelope, c, p.psi0, 0.0, p.T, horizon=p.T,
               n_steps=4, backend=backend)


def _ham(n, hop=False):
    d = 2**n
    terms = [tham.TermStructure(kind="diag", diag=linalg.zz_diagonal(n, 0, 1)),
             tham.TermStructure(kind="1q", qubit=0, local=linalg.X)]
    if hop:
        terms.append(tham.TermStructure(kind="hop", qubit=1, qubit2=2))
    return tham.ControlledHamiltonian.create_structured(d, tuple(terms))


@pytest.mark.parametrize("n", [18, 19])
def test_router_raises_past_the_streamed_band(n):
    """Past the streamed band the router names K3 ('packed', 18 qubits,
    hops too), K5 ('mega', 19-24) and, for hop drive sets at 19-24
    qubits, K6 ('mega_hop'); none of them raises."""
    assert tprod.select_engine(_ham(n)) == ("packed" if n == 18 else "mega")
    assert tprod.select_engine(_ham(n, hop=True)) == \
        ("packed" if n == 18 else "mega_hop")


@pytest.mark.parametrize("what", ["mesh", "batched_18q", "envelope_jacobian",
                                  "strings"])
def test_unported_features_raise(what):
    """The features that are ported keep the one refusal each has: the
    sharded string expectation a state axis that is no power of two, the
    packed engines per-member time grids (the MC estimator's 'vmap' mode
    at 18 qubits), envelope_jacobian split times that are neither 0-dim
    nor [S], and sampled measurement more than torch.multinomial's 2^24
    categories."""
    from diffquantum_tpu_torch.measure import draw_shots
    from diffquantum_tpu_torch.parallel.comm import Axis
    from diffquantum_tpu_torch.parallel.mesh import Mesh
    p = _small_problem()
    three = Mesh(("state",), {"state": 3},
                 {"state": Axis("state", 3, 0, (0, 1, 2), None)},
                 torch.device("cpu"))
    call, (error, match) = {
        "mesh": (lambda: sharded_strings_expectation(
            p.psi0, Measurement.create_strings(
                [("Z" * 4, 1.0)], device="cpu").strings, three),
            (ValueError, "not a power of two")),
        # the MC estimator's batch at 18 qubits on the packed engine
        "batched_18q": (lambda: mc_energy_grad_batch(
            _ham(18), SimpleEnvelope(basis="bspline", n_basis=4,
                                     omegas=(1.0, 1.0)),
            Measurement.create_diagonal(np.zeros(2**18), device="cpu"),
            torch.zeros((2, 4)), CP(torch.zeros(2**18), torch.zeros(2**18)),
            1.0, None, 2, 4, s=torch.full((4,), 0.5),
            backend="product_fused", sample_mode="vmap"),
            (NotImplementedError, "per-member time grids")),
        "envelope_jacobian": (lambda: envelope_jacobian(
            p.envelope, torch.zeros(p.envelope.coeff_shape),
            torch.full((2, 2), 0.5), p.T), (ValueError, "split times")),
        "strings": (lambda: draw_shots(
            torch.ones((1, 1)).expand(1, 2**24 + 1), 4,
            torch.Generator()), (ValueError, "at most")),
    }[what]
    with pytest.raises(error, match=match):
        call()


def _open_problem(n, hop=False, t1=True, dense=False):
    """(ham, envelope, coeff, psi0, rho0, noise) of an open-system problem
    on the CPU: a ZZ coupler and an X drive (``_ham``'s terms); rho0 up to
    6 qubits."""
    from diffquantum_tpu_torch.dynamics.lindblad import StructuredNoise
    d = 2**n
    ham = _ham(n, hop=hop)
    if dense:
        hs = [np.diag(linalg.zz_diagonal(n, 0, 1)),
              linalg.op_on_qubits(linalg.X, [0], n)]
        ham = tham.ControlledHamiltonian.create(np.zeros((d, d)), hs,
                                                device="cpu")
    env = SimpleEnvelope(basis="bspline", n_basis=4,
                         omegas=(1.0,) * ham.n_controls)
    psi0 = CP(torch.full((d,), d ** -0.5), torch.zeros(d))
    rho0 = CP(torch.full((d, d), 1.0 / d), torch.zeros((d, d))) \
        if n <= 6 else None
    noise = StructuredNoise(n, t1=[(0, 0.1)] if t1 else [],
                            dephasing=[(1, 0.2)])
    return ham, env, torch.zeros(env.coeff_shape), psi0, rho0, noise


@pytest.mark.parametrize("n", [9, 18])
def test_fused_mcwf_raises_outside_the_k2_band(n):
    """backend='fused' runs K2 at 10-17 qubits and raises outside, naming
    the band; it never runs 'xla' in its place."""
    from diffquantum_tpu_torch.dynamics.lindblad import evolve_mcwf_structured
    ham, env, c, psi0, _, noise = _open_problem(n)
    with pytest.raises(ValueError, match="10-17 qubits"):
        evolve_mcwf_structured(ham, env, c, psi0, noise, 0.0, 1.0,
                               horizon=1.0, n_steps=2,
                               generator=torch.Generator(), n_traj=2,
                               backend="fused")


@pytest.mark.parametrize("entry", ["lindblad_structured", "dephasing",
                                   "mcwf_structured"])
def test_open_system_engines_refuse_hops(entry):
    from diffquantum_tpu_torch.dynamics import lindblad as tlb
    ham, env, c, psi0, rho0, noise = _open_problem(3, hop=True, t1=False)
    kw = dict(horizon=1.0, n_steps=2)
    call = {
        "lindblad_structured": lambda: tlb.evolve_lindblad_structured(
            ham, env, c, rho0, noise, 0.0, 1.0, **kw),
        "dephasing": lambda: tlb.evolve_dephasing_trajectories(
            ham, env, c, psi0, noise, 0.0, 1.0, generator=torch.Generator(),
            n_traj=2, **kw),
        "mcwf_structured": lambda: tlb.evolve_mcwf_structured(
            ham, env, c, psi0, noise, 0.0, 1.0, generator=torch.Generator(),
            n_traj=2, **kw),
    }[entry]
    with pytest.raises(ValueError, match="'hop'"):
        call()


def test_dephasing_trajectories_refuse_t1():
    from diffquantum_tpu_torch.dynamics.lindblad import \
        evolve_dephasing_trajectories
    ham, env, c, psi0, _, noise = _open_problem(3)
    with pytest.raises(ValueError, match="dephasing only"):
        evolve_dephasing_trajectories(ham, env, c, psi0, noise, 0.0, 1.0,
                                      horizon=1.0, n_steps=2,
                                      generator=torch.Generator(), n_traj=2)


@pytest.mark.parametrize("entry", ["evolve_lindblad", "evolve_mcwf",
                                   "evolve_ode"])
def test_dense_only_entry_points_refuse_a_structured_hamiltonian(entry):
    from diffquantum_tpu_torch.dynamics import lindblad as tlb
    from diffquantum_tpu_torch.dynamics.ode import evolve_ode
    ham, env, c, psi0, rho0, noise = _open_problem(3)
    dense = _open_problem(3, dense=True)[0]
    assert not dense.is_structured_only
    cs = tlb.CollapseSet.create(noise.dense_collapse_ops(), device="cpu")
    kw = dict(horizon=1.0, n_steps=2)
    call = {
        "evolve_lindblad": lambda h: tlb.evolve_lindblad(
            h, env, c, rho0, cs, 0.0, 1.0, **kw),
        "evolve_mcwf": lambda h: tlb.evolve_mcwf(
            h, env, c, psi0, cs, 0.0, 1.0, generator=torch.Generator(),
            n_traj=2, **kw),
        "evolve_ode": lambda h: evolve_ode(h, env, c, psi0, 0.0, 1.0,
                                           horizon=1.0),
    }[entry]
    with pytest.raises(ValueError, match="dense operators"):
        call(ham)
    call(dense)  # the dense twin runs


@pytest.mark.parametrize("entry", ["mc_energy_grad", "mc_energy_grad_batch",
                                   "fd_energy_grad", "train_energy_mc",
                                   "train_energy_fd", "train_energy_seeds_mc"])
def test_sampled_estimators_raise_at_18_qubits(entry):
    """At 18 qubits, where the estimators once stopped, each entry point
    runs on the CPU (the eager engine) and gives finite values of the
    expected shape: the MC samples one after another ('auto' picks
    'map' there), FD in one batch (off the card the chunk is every
    member)."""
    from diffquantum_tpu_torch.gradients import mc as tmc
    from diffquantum_tpu_torch.gradients.fd import fd_chunk_size
    ham = _ham(18)
    assert tmc._mc_sample_mode(ham, "auto") == "map"
    assert tmc._mc_sample_mode(_ham(17), "auto") == "vmap"
    assert fd_chunk_size(ham, 16, "cpu") == 16
    env = SimpleEnvelope(basis="bspline", n_basis=4, omegas=(1.0, 1.0))
    c = torch.full(env.coeff_shape, 0.3)
    d = 2**18
    psi0 = CP(torch.full((d,), d ** -0.5), torch.zeros(d))
    meas = Measurement.create_diagonal(
        linalg.zz_diagonal(18, 0, 1), device="cpu")
    run = lambda mode: train_energy(  # noqa: E731
        ham, env, meas, psi0, 1.0,
        TrainConfig(n_epoch=1, grad_mode=mode, per_step=2, n_step=2))
    call = {
        "mc_energy_grad": lambda: mc_energy_grad(
            ham, env, meas, c, psi0, 1.0, None, 2, s=0.5),
        "mc_energy_grad_batch": lambda: mc_energy_grad_batch(
            ham, env, meas, c, psi0, 1.0, None, 2, 3,
            s=torch.tensor([0.2, 0.5, 0.9], dtype=torch.float64)),
        "fd_energy_grad": lambda: fd_energy_grad(ham, env, meas, c, psi0,
                                                 1.0, None, 2),
        "train_energy_mc": lambda: run("mc").coeff,
        "train_energy_fd": lambda: run("fd").coeff,
        "train_energy_seeds_mc": lambda: train_energy_seeds(
            ham, env, meas, psi0, 1.0,
            TrainConfig(n_epoch=1, grad_mode="mc", per_step=2, n_step=2),
            n_seeds=2).coeffs[1],
    }[entry]
    out = call()
    assert out.shape == env.coeff_shape and torch.isfinite(out).all()


def test_dense_auto_rule_on_cpu():
    """On the CPU, as on the card, 'auto' takes the dense backends for a
    dense Hamiltonian even with structure tags: 'expm' for the demo's
    one state, 'apply' for a batch; a structured one keeps the eager
    Strang engine, and refuses the dense backends."""
    dense = tmaxcut.demo_problem(device="cpu", dtype=torch.float64)
    c = torch.full(dense.envelope.coeff_shape, 0.3, dtype=torch.float64)
    batch = CP(dense.psi0.re.expand(3, -1), dense.psi0.im.expand(3, -1))
    kw = dict(horizon=dense.T, n_steps=8)
    for psi0, want in ((dense.psi0, "expm"), (batch, "apply")):
        assert tprop.dense_backend(dense.ham, psi0.ndim > 1) == want
        auto = evolve(dense.ham, dense.envelope, c, psi0, 0.0, dense.T, **kw)
        named = evolve(dense.ham, dense.envelope, c, psi0, 0.0, dense.T,
                       backend=want, **kw)
        assert torch.equal(auto.re, named.re)
    structured = tmaxcut.demo_problem(device="cpu", dtype=torch.float64,
                                      dense=False)
    auto = evolve(structured.ham, structured.envelope, c, structured.psi0,
                  0.0, structured.T, **kw)
    eager = evolve(structured.ham, structured.envelope, c, structured.psi0,
                   0.0, structured.T, backend="product", **kw)
    assert torch.equal(auto.re, eager.re)
    for backend in ("expm", "apply"):
        with pytest.raises(ValueError, match="dense operators"):
            evolve(structured.ham, structured.envelope, c, structured.psi0,
                   0.0, structured.T, backend=backend, **kw)


def test_apply_on_cpu_never_loads_the_kernels(monkeypatch):
    """'apply' on a CPU state takes the recurrence route and never builds
    or loads a kernel library, forward or backward; nor does K7's wrapper
    (``taylor_apply``, with its launch plan) on CPU tensors."""
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.ops import _build
    from diffquantum_tpu_torch.ops import taylor_apply as ta
    from diffquantum_tpu_torch.ops.cpx import CP

    def refuse(*a, **k):
        raise AssertionError("a CPU path tried to load a kernel library")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    p = tmaxcut.demo_problem(device="cpu")
    c = torch.full(p.envelope.coeff_shape, 0.2)
    val, grad = energy_and_grad(p.ham, p.envelope, p.measurement, c, p.psi0,
                                p.T, 6, backend="apply")
    assert torch.isfinite(grad).all() and np.isfinite(float(val))
    rng = np.random.default_rng(7)
    for d, b in ((16, 16), (65, 3)):   # one shape of each configuration
        plans = [ta.k7_plan(d, b, bw) for bw in (False, True)]
        assert {pl.config for pl in plans} == {"block" if d <= 64 else "rows"}
        h = CP(*(torch.tensor(rng.standard_normal((d, d)) * 0.1,
                              dtype=torch.float32, requires_grad=True)
                 for _ in range(2)))
        psi = CP(*(torch.tensor(rng.standard_normal((b, d)),
                                dtype=torch.float32) for _ in range(2)))
        out = ta.taylor_apply(h, psi, 0.0, -0.3, 8, 2)
        gh = torch.autograd.grad(out.re.sum() + out.im.sum(), [h.re, h.im])
        assert all(torch.isfinite(x).all() for x in gh)


def test_make_mesh_raises():
    """A mesh whose axis sizes do not multiply to the world size raises,
    as the JAX package's does past its devices (here a world of one)."""
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        make_mesh({"data": 4}, device="cpu")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd = REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
