"""The port's state-sharded engine and meshes on CPU gloo ranks — the
rank-side programs, and what one rank shows in-process.

``run_ranks`` spawns a world of gloo ranks (``torch.multiprocessing``,
a ``FileStore`` in a temporary directory: no network) that each run
``rank_cases`` and save their results; tests/test_torch_sharded.py holds
those against the JAX package on the same mesh sizes and against the
port's unsharded engine. This module imports only torch and the port,
so the spawned ranks never import JAX.

In-process, a world of one rank: the engine and the meshed seeds make
no call into ``torch.distributed``, 'xla' and 'chunked' equal the
unsharded engines, and the guards raise as the JAX package's do."""
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.dynamics.hamiltonian import (
    ControlledHamiltonian, TermStructure)
from diffquantum_tpu_torch.ops import linalg
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import (evolve_product_sharded,
                                            make_mesh,
                                            sharded_diag_expectation,
                                            train_energy_seeds)
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
from diffquantum_tpu_torch.train.config import TrainConfig

# The problem of every case: the ring's ZZ couplers, X drives on qubits 0,
# 1, 6 and 9 and Y on 6 (a palindromic plan; 0 and 1 are distributed at
# 4 ranks, 0 at 2), and for 'xla'/'fused' the hops (0, 5) (across the
# shard boundary) and (3, 7) (local). Legendre envelopes, 4 basis
# functions, omega = pi; T = 1.5 in 4 steps.
DRIVES = ((0, "x"), (1, "x"), (6, "x"), (9, "x"), (6, "y"))
HOPS = ((0, 5), (3, 7))
T_END, N_STEPS = 1.5, 4


def cases(world: int):
    """(name, qubits, dtype name, local_backend, hops) run at ``world``
    state ranks: 'fused' keeps 10 local qubits, 'chunked' 10-11."""
    return [("xla_f32", 11, "float32", "xla", True),
            ("xla_f64", 11, "float64", "xla", True),
            ("fused", 11 if world == 2 else 12, "float32", "fused", True),
            ("chunked", 12, "float32", "chunked", False)]


# The channel envelope on the sharded engine, in the shape of the JAX
# package's tests/test_sharded_hop_strings.py::
# test_sharded_channel_envelope_match_product: X on every qubit and ZZ on
# (0, 1), one carrier channel a control (carrier 0.5 q on qubit q, 1.3 on
# the ZZ), Legendre, 3 basis functions, vv ~ 0.4 N(0, 1); T = 1 in 5 steps.
CH_T, CH_STEPS = 1.0, 5


def channel_cases(world: int):
    """(name, qubits, dtype name, local_backend) of the channel cases at
    ``world`` state ranks: 'xla' float64 at 8 qubits, and at 2 ranks
    'fused' float32 at 11 (K1's band starts at 10 local qubits)."""
    out = [("channel_xla_f64", 8, "float64", "xla")]
    if world == 2:
        out.append(("channel_fused", 11, "float32", "fused"))
    return out


def channel_rows(n: int):
    """The reference's nested channel table of the channel problem."""
    return [[[0.0, np.pi, 0.5 * q, q]] for q in range(n)] + \
        [[[0.0, np.pi, 1.3, n]]]


def channel_inputs(n: int):
    """(vv [2, n + 1, 3], the observable's diagonal) on the host."""
    rng = np.random.default_rng(1)
    return 0.4 * rng.standard_normal((2, n + 1, 3)), \
        rng.standard_normal(2**n)


def channel_value_and_grad(mesh, n, dtype, backend):
    """(value, vv gradient, state block) of a channel case on this rank."""
    from diffquantum_tpu_torch.pulses.envelope import ChannelEnvelope
    d = 2**n
    terms = [TermStructure(kind="1q", qubit=q, local=linalg.X)
             for q in range(n)]
    terms.append(TermStructure(kind="diag", diag=linalg.zz_diagonal(n, 0, 1)))
    ham = ControlledHamiltonian.create_structured(d, tuple(terms),
                                                  dtype=dtype)
    env = ChannelEnvelope.from_rows(channel_rows(n), n_basis=3, func_type=0)
    vv, diag = channel_inputs(n)
    c = torch.tensor(vv, dtype=dtype, requires_grad=True)
    psi0 = CP(torch.full((d,), d ** -0.5, dtype=dtype),
              torch.zeros(d, dtype=dtype))
    psi = evolve_product_sharded(ham, env, c, psi0, 0.0, CH_T, horizon=CH_T,
                                 n_steps=CH_STEPS, mesh=mesh,
                                 local_backend=backend)
    e = sharded_diag_expectation(psi, torch.tensor(diag, dtype=dtype), mesh)
    (g,) = torch.autograd.grad(e, c)
    return (e.detach().numpy(), g.numpy(),
            torch.stack([psi.re, psi.im]).detach().numpy())


def structure(n: int, hops: bool):
    """[(kind, args)] of the problem's control terms, in order."""
    out = [("zz", (i, (i + 1) % n)) for i in range(n)]
    out += [(kind, (q,)) for q, kind in DRIVES]
    if hops:
        out += [("hop", pr) for pr in HOPS]
    return out


def problem_inputs(n: int, members: int = 0, seed: int = 0):
    """Host inputs: coefficients [n_c, 4] (or one set per member), psi0
    (uniform, or random per member) and the observable's diagonal."""
    rng = np.random.default_rng(seed)
    n_c = len(structure(n, True))
    d = 2**n
    lead = (members,) if members else ()
    coeff = 0.5 * rng.standard_normal(lead + (n_c, 4))
    if members:
        psi = rng.standard_normal((members, d)) \
            + 1j * rng.standard_normal((members, d))
        psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    else:
        psi = np.full(d, d ** -0.5, dtype=np.complex128)
    diag = np.random.default_rng(seed + 1).standard_normal(d)
    return coeff, psi, diag


def torch_problem(n: int, dtype, hops: bool):
    d = 2**n
    terms = []
    for kind, args in structure(n, hops):
        if kind == "zz":
            terms.append(TermStructure(kind="diag",
                                       diag=linalg.zz_diagonal(n, *args)))
        elif kind == "hop":
            terms.append(TermStructure(kind="hop", qubit=args[0],
                                       qubit2=args[1]))
        else:
            terms.append(TermStructure(
                kind="1q", qubit=args[0],
                local=linalg.X if kind == "x" else linalg.Y))
    ham = ControlledHamiltonian.create_structured(
        d, tuple(terms), dtype=dtype)
    env = SimpleEnvelope(basis="legendre", n_basis=4,
                         omegas=(np.pi,) * len(terms))
    return ham, env


def _torch_inputs(n, dtype, hops, members=0, seed=0):
    coeff, psi, diag = problem_inputs(n, members, seed)
    n_c = len(structure(n, hops))
    coeff = torch.tensor(coeff[..., :n_c, :], dtype=dtype)
    psi0 = CP(torch.tensor(psi.real, dtype=dtype),
              torch.tensor(psi.imag, dtype=dtype))
    return coeff, psi0, torch.tensor(diag, dtype=dtype)


def sharded_value_and_grad(mesh, n, dtype, backend, hops, batch_axis=None,
                           members=0):
    """(value(s), coefficient gradient, state block) of one case on this
    rank: the loss is the sum of ``sharded_diag_expectation`` over this
    rank's members."""
    ham, env = torch_problem(n, dtype, hops)
    coeff, psi0, diag = _torch_inputs(n, dtype, hops, members)
    c = coeff.clone().requires_grad_(True)
    psi = evolve_product_sharded(ham, env, c, psi0, 0.0, T_END,
                                 horizon=T_END, n_steps=N_STEPS, mesh=mesh,
                                 batch_axis=batch_axis, local_backend=backend)
    e = sharded_diag_expectation(psi, diag, mesh, batch_axis=batch_axis)
    (g,) = torch.autograd.grad(e.sum(), c)
    if members:  # a member's gradient is its own block of the coefficients
        d_axis = mesh.axes[batch_axis]
        m = members // d_axis.size
        g = g[d_axis.index * m:(d_axis.index + 1) * m]
    return (e.detach().numpy(), g.numpy(),
            torch.stack([psi.re, psi.im]).detach().numpy())


def seed_population(mesh, init):
    """train_energy_seeds on the 6-qubit ring MaxCut (dense, f64), 4
    seeds x 2 epochs from ``init`` (the JAX package's draw), over
    ``mesh``'s data axis."""
    from diffquantum_tpu_torch.models import maxcut
    p = maxcut.build_maxcut(6, maxcut.ring_graph(6), dtype=torch.float64,
                            device="cpu")
    r = train_energy_seeds(p.ham, p.envelope, p.measurement, p.psi0, p.T,
                           TrainConfig(n_epoch=2, seed=3, dtype="float64"),
                           n_seeds=4, mesh=mesh,
                           init_coeffs=torch.tensor(init))
    return r.losses, r.coeffs.numpy()


def rank_cases(rank: int, world: int, tmp: str):
    """Everything one rank of a ``world``-rank gloo world computes, saved
    to ``tmp/rank{rank}.pt``."""
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)
    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh({"state": world}, device="cpu")
    for name, n, dt, backend, hops in cases(world):
        out[name] = sharded_value_and_grad(mesh, n, getattr(torch, dt),
                                           backend, hops)
    for name, n, dt, backend in channel_cases(world):
        out[name] = channel_value_and_grad(mesh, n, getattr(torch, dt),
                                           backend)
    if world == 4:
        mesh2 = make_mesh({"data": 2, "state": 2}, device="cpu")
        for backend in ("xla", "fused"):
            out[f"data2_state2_{backend}"] = sharded_value_and_grad(
                mesh2, 11, torch.float32, backend, False, batch_axis="data",
                members=4)
    if world == 2:
        out["seeds"] = seed_population(
            make_mesh({"data": 2}, device="cpu"),
            np.load(os.path.join(tmp, "seeds_init.npy")))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def strings_rank(rank: int, world: int, tmp: str):
    """One rank of tests/test_torch_strings.py's sharded Pauli-string
    case: this rank's block of ``tmp/psi.npy`` [3, d] (and of its first
    state), the sharded expectation of ``tmp/terms.npy``, and the
    gradient of the batch's summed value in the block, saved to
    ``tmp/strings{rank}.pt``."""
    from diffquantum_tpu_torch.measure import PauliStringSet
    from diffquantum_tpu_torch.parallel.sharded_state import \
        sharded_strings_expectation
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)
    torch.set_num_threads(1)
    mesh = make_mesh({"state": world}, device="cpu")
    psi = np.load(os.path.join(tmp, "psi.npy"))
    terms = [(str(lb), float(w)) for lb, w in
             np.load(os.path.join(tmp, "terms.npy"), allow_pickle=True)]
    strings = PauliStringSet.create(terms, dtype=torch.float64,
                                    device="cpu")
    blk = psi.shape[-1] // world
    part = psi[:, rank * blk:(rank + 1) * blk]
    re = torch.tensor(part.real, requires_grad=True)
    im = torch.tensor(part.imag, requires_grad=True)
    batch = sharded_strings_expectation(CP(re, im), strings, mesh)
    g_re, g_im = torch.autograd.grad(batch.sum(), (re, im))
    one = sharded_strings_expectation(CP(re[0].detach(), im[0].detach()),
                                      strings, mesh)
    torch.save({"batch": batch.detach().numpy(), "one": one.numpy(),
                "grad_re": g_re.numpy(), "grad_im": g_im.numpy()},
               os.path.join(tmp, f"strings{rank}.pt"))
    dist.destroy_process_group()


def run_ranks(world: int, tmp: str, seeds_init: np.ndarray):
    """Spawn ``world`` gloo ranks running :func:`rank_cases`; returns
    their results in rank order."""
    np.save(os.path.join(tmp, "seeds_init.npy"), seeds_init)
    mp.spawn(rank_cases, args=(world, tmp), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# one rank, in-process
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    """A world of one gloo rank on a FileStore (what make_mesh starts
    when no group exists), torn down after the test."""
    started = not dist.is_initialized()
    mesh = make_mesh({"state": 1}, device="cpu")
    assert dist.get_world_size() == 1
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.fixture
def no_collectives(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a world of one rank called torch.distributed")
    for name in ("all_reduce", "all_gather", "batch_isend_irecv", "isend",
                 "irecv", "send", "recv", "broadcast"):
        monkeypatch.setattr(dist, name, refuse)


@pytest.mark.parametrize("backend", ["xla", "chunked"])
def test_world_of_one_equals_unsharded(world1, no_collectives, backend):
    """At one rank 'xla' (f64) is the eager engine and 'chunked' (f32)
    the packed chain, values and coefficient gradients, without a call
    into torch.distributed."""
    f64 = backend == "xla"
    dtype = torch.float64 if f64 else torch.float32
    n = 11 if f64 else 12
    ham, env = torch_problem(n, dtype, hops=f64)
    coeff, psi0, diag = _torch_inputs(n, dtype, hops=f64)

    def loss(evolve):
        c = coeff.clone().requires_grad_(True)
        psi = evolve(c)
        e = sharded_diag_expectation(psi, diag, world1)
        return e.detach(), torch.autograd.grad(e, c)[0]

    got = loss(lambda c: evolve_product_sharded(
        ham, env, c, psi0, 0.0, T_END, horizon=T_END, n_steps=N_STEPS,
        mesh=world1, local_backend=backend))
    if f64:
        want = loss(lambda c: tprod.evolve_product(
            ham, env, c, psi0, 0.0, T_END, horizon=T_END, n_steps=N_STEPS))
        tol = 1e-12
    else:  # K4 per step is K5's chain step by step: the packed engine
        want = loss(lambda c: tprod.packed_evolve(
            n, psi0, *_packed(ham, env, c)))
        tol = 1e-5
    assert abs(float(got[0]) - float(want[0])) < tol
    scale = float(want[1].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= tol * scale


def _packed(ham, env, c):
    ud, tx, h0th, signs, qubits, kinds = tprod.packed_chain_inputs(
        ham, env, c, 0.0, T_END, T_END, N_STEPS)
    return ud, tx, h0th, signs, qubits, kinds, False


def test_world_of_one_seeds_equal_unmeshed(world1, no_collectives):
    from diffquantum_tpu_torch.models import maxcut
    p = maxcut.build_maxcut(6, maxcut.ring_graph(6), dtype=torch.float64,
                            device="cpu")
    cfg = TrainConfig(n_epoch=2, seed=3, dtype="float64")
    args = (p.ham, p.envelope, p.measurement, p.psi0, p.T, cfg)
    meshed = train_energy_seeds(*args, n_seeds=3, mesh=make_mesh(
        {"data": 1}, device="cpu"))
    plain = train_energy_seeds(*args, n_seeds=3)
    np.testing.assert_array_equal(meshed.losses, plain.losses)
    assert torch.equal(meshed.coeffs, plain.coeffs)


def test_guards(world1):
    """'chunked' refuses hops, float64, batched states and per-seed
    coefficients; 'fused' checks its eligibility; the mesh's sizes must
    multiply to the world size."""
    kw = dict(horizon=T_END, n_steps=2, mesh=world1)
    ham, env = torch_problem(12, torch.float32, hops=True)
    coeff, psi0, _ = _torch_inputs(12, torch.float32, hops=True)
    with pytest.raises(ValueError, match="'hop' terms"):
        evolve_product_sharded(ham, env, coeff, psi0, 0.0, T_END,
                               local_backend="chunked", **kw)
    ham64, env = torch_problem(12, torch.float64, hops=False)
    coeff, psi0, _ = _torch_inputs(12, torch.float64, hops=False)
    with pytest.raises(ValueError, match="f32"):
        evolve_product_sharded(ham64, env, coeff, psi0, 0.0, T_END,
                               local_backend="chunked", **kw)
    ham, env = torch_problem(12, torch.float32, hops=False)
    coeff, psi0, _ = _torch_inputs(12, torch.float32, hops=False)
    batch = CP(torch.stack([psi0.re, psi0.re]), torch.stack([psi0.im,
                                                             psi0.im]))
    with pytest.raises(ValueError, match="unbatched"):
        evolve_product_sharded(ham, env, coeff, batch, 0.0, T_END,
                               local_backend="chunked", **kw)
    with pytest.raises(ValueError, match="needs >= 10 local"):
        small, env9 = torch_problem(9, torch.float32, hops=False)
        c9, p9, _ = _torch_inputs(9, torch.float32, hops=False)
        evolve_product_sharded(small, env9, c9, p9, 0.0, T_END,
                               local_backend="chunked", **kw)
    bad = ControlledHamiltonian.create_structured(
        ham.dim, ham.structure[:-1] + (TermStructure(
            kind="diag", diag=np.arange(ham.dim) / ham.dim),),
        dtype=torch.float32)
    with pytest.raises(ValueError, match="two-valued"):
        evolve_product_sharded(bad, env, coeff, psi0, 0.0, T_END,
                               local_backend="chunked", **kw)
    # 'fused': K1/K2's band of 10-17 local qubits, f32
    for n, dtype in ((9, torch.float32), (18, torch.float32),
                     (11, torch.float64)):
        h, e = torch_problem(n, dtype, hops=False)
        with pytest.raises(ValueError, match="local_backend='fused' needs"):
            evolve_product_sharded(
                h, e, torch.zeros(e.coeff_shape, dtype=dtype),
                CP(torch.zeros(2**n, dtype=dtype),
                   torch.zeros(2**n, dtype=dtype)), 0.0, T_END,
                local_backend="fused", **kw)
    # 'auto' on the CPU takes 'xla'
    h, e = torch_problem(11, torch.float32, hops=True)
    c, p, _ = _torch_inputs(11, torch.float32, hops=True)
    auto = evolve_product_sharded(h, e, c, p, 0.0, T_END,
                                  local_backend="auto", **kw)
    xla = evolve_product_sharded(h, e, c, p, 0.0, T_END,
                                 local_backend="xla", **kw)
    assert torch.equal(auto.re, xla.re)
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        make_mesh({"data": 2, "state": 2}, device="cpu")
    with pytest.raises(ValueError, match="per-seed coeff needs a batch"):
        evolve_product_sharded(h, e, c[None].expand(2, -1, -1), p, 0.0,
                               T_END, **kw)


def test_make_mesh_starts_a_world_of_one(tmp_path, monkeypatch):
    """With no group and no RANK/WORLD_SIZE, make_mesh starts a world of
    one on a FileStore under the temp directory."""
    assert not dist.is_initialized(), "a test left a process group"
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    try:
        mesh = make_mesh({"data": 1, "state": 1}, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert mesh.shape == {"data": 1, "state": 1}
        assert mesh.axes["state"].group is None
        assert any(p.name.startswith("dq_mesh_") for p in tmp_path.iterdir())
    finally:
        dist.destroy_process_group()
        tempfile.tempdir = None
