"""The plain reference against a dense chain of matrix exponentials, and
against the program's plain path on the CPU; and what the benchmark's
modules import."""
import ast
import math
import os

import numpy as np
import pytest
import torch

from harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = spec.reference_module("ring_maxcut")
FORBIDDEN = {"jax", "jaxlib", "flax", "diffquantum_tpu"}


def dense_ops(n):
    """[Z_i Z_j for the ring edges] + [X_q], dense complex128."""
    I, X = np.eye(2), np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])

    def kron(ops):
        out = np.eye(1)
        for o in ops:
            out = np.kron(out, o)
        return out
    zz = [kron([Z if k in (i, (i + 1) % n) else I for k in range(n)])
          for i in range(n)]
    xs = [kron([X if k == q else I for k in range(n)]) for q in range(n)]
    return [torch.as_tensor(m, dtype=torch.complex128) for m in zz + xs]


def dense_chain(prob, c, n_steps, strang=True):
    """psi(T) of one member by dense exponentials: the Strang factors
    exp(-i dt/2 D) exp(-i dt X) exp(-i dt/2 D), or (strang False) the
    step's whole exp(-i dt H)."""
    ops, n = dense_ops(prob.n), prob.n
    z = torch.zeros(1, dtype=torch.float64)
    dt, ts = prob.grid(z, z + prob.T, n_steps)
    u = prob.amplitudes(c[None], ts)[0].to(torch.complex128)
    psi = torch.full((prob.d,), 1 / math.sqrt(prob.d), dtype=torch.complex128)
    dt = float(dt)
    for k in range(n_steps):
        D = sum(u[e, k] * ops[e] for e in range(n))
        Xp = sum(u[n + q, k] * ops[n + q] for q in range(n))
        if strang:
            half = torch.linalg.matrix_exp(-0.5j * dt * D)
            rot = torch.linalg.matrix_exp(-1j * dt * Xp)
            psi = half @ (rot @ (half @ psi))
        else:
            psi = torch.linalg.matrix_exp(-1j * dt * (D + Xp)) @ psi
    return psi


@pytest.mark.parametrize("n", [4, 5, 6])
def test_chain_matches_dense_exponentials(n):
    prob = REF.RingMaxCut(n, 6, 10, 100, dtype=torch.float64)
    c = torch.randn((3, prob.n_controls, 6), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n))
    z = torch.zeros(3, dtype=torch.float64)
    re, im = prob.evolve(c, *prob.psi0(3), z, z + prob.T, prob.n_steps)
    for b in range(3):
        want = dense_chain(prob, c[b], prob.n_steps)
        assert torch.allclose(torch.complex(re[b], im[b]), want, atol=1e-12)
    # and the split against the unsplit step, to second order in dt
    fine = 4 * prob.n_steps
    re, im = prob.evolve(c[:1], *prob.psi0(1), z[:1], z[:1] + prob.T, fine)
    exact = dense_chain(prob, c[0], fine, strang=False)
    assert (torch.complex(re[0], im[0]) - exact).abs().max() < 2e-2


def test_adjoint_and_mc_gradients_agree_with_differences():
    prob = REF.RingMaxCut(4, 6, 10, 100, dtype=torch.float64)
    c = 0.5 * torch.randn((1, prob.n_controls, 6), dtype=torch.float64,
                          generator=torch.Generator().manual_seed(1))
    e, g = prob.energy_and_grad(c)
    assert torch.allclose(e, prob.energies(c))
    h = 1e-6
    for (k, j) in [(0, 1), (5, 3), (7, 4)]:
        dc = torch.zeros_like(c)
        dc[0, k, j] = h
        fd = (prob.energies(c + dc) - prob.energies(c - dc)) / (2 * h)
        assert float(g[0, k, j]) == pytest.approx(float(fd), abs=1e-7)
    # the MC estimator is unbiased for the exact chain's gradient up to
    # the O(dt) of its split: many stratified samples come close
    s = REF.split_times(torch.Generator().manual_seed(3), 1, 512,
                        "stratified", prob.T)
    gm = prob.mc_grad(c, s)
    cos = float((gm * g).sum() / (gm.norm() * g.norm()))
    assert cos > 0.98


def test_adam_matches_torch():
    p = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    ref = REF.Adam(p, 0.02)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=0.02, betas=(0.9, 0.999), eps=1e-8)
    for k in range(4):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(k + 1))
        q.grad = g.clone()
        opt.step()
        assert torch.allclose(ref.step(g), q.detach(), atol=1e-7)


def test_follow_takes_each_update_from_the_programs_own_gradient():
    """A component whose gradient is nought to rounding moves by what its
    rounding decides (Adam's lr g / (|g| + eps)). The check feeds the
    reference's Adam the program's own gradients, so such a move reads
    sound; the same Adam fed another rounding of that one component
    parts from it by far more than a sound run reads."""
    from harness import checking
    prob = REF.RingMaxCut(4, 6, 10, 10)
    gen = torch.Generator().manual_seed(3)
    c0 = torch.randn(2, prob.n_controls, 6, generator=gen)
    grads = 0.1 * torch.randn(3, 2, prob.n_controls, 6, generator=gen)
    grads[0, 0, 5, 2] = 3.2e-8
    q = c0.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=0.02)
    params = []
    for g in grads:
        q.grad = g.clone()
        opt.step()
        params.append(q.detach().clone())
    prog = (None, grads, torch.stack(params))
    cs = torch.cat([c0[None], prog[2]])
    losses, ref_grads, adam = REF.follow(prob, cs, grads, 0.02)
    assert losses.shape == (4, 2) and ref_grads.shape == grads.shape
    sound = checking.numbers((losses, ref_grads, prog[2]),
                             (losses, ref_grads, adam), c0)
    assert sound["change_gap"] < 1e-6
    other = grads.clone()
    other[0, 0, 5, 2] = 1.6e-6
    apart = REF.follow(prob, cs, other, 0.02)[2]
    parted = checking.numbers((losses, ref_grads, prog[2]),
                              (losses, ref_grads, apart), c0)
    assert parted["change_gap"] > 1e-3


def test_tf32_round_keeps_ten_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000001])
    r = REF.tf32_round(x)
    assert r[0] == 1.0 + 2**-10 and r[1] == 1.0 + 2**-10
    assert r[2] == -3.0
    assert bool((REF.tf32_round(r) == r).all())


def _port_problem(n):
    from diffquantum_tpu_torch.models.maxcut import build_maxcut, ring_graph
    return build_maxcut(n, ring_graph(n), n_basis=6, dense=False,
                        device="cpu")


def test_reference_agrees_with_the_port_on_the_cpu():
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.mc import mc_grads_per_sample
    n = 6
    port = _port_problem(n)
    prob = REF.RingMaxCut(n, 6, 10, 100)
    c = torch.randn((4, 2 * n, 6), generator=torch.Generator().manual_seed(2))
    e_ref, g_ref = prob.energy_and_grad(c)
    for b in range(4):
        e, g = energy_and_grad(port.ham, port.envelope, port.measurement,
                               c[b], port.psi0, port.T, prob.n_steps)
        assert float(e) == pytest.approx(float(e_ref[b]), abs=5e-6)
        assert torch.allclose(g, g_ref[b], atol=2e-5)
    s = REF.split_times(torch.Generator().manual_seed(5), 4, 2,
                        "stratified", prob.T)
    g_mc = mc_grads_per_sample(port.ham, port.envelope, port.measurement,
                               c.repeat_interleave(2, 0), port.psi0, port.T,
                               s.reshape(-1), 100)
    g_mc = g_mc.reshape(4, 2, 2 * n, 6).mean(1)
    assert torch.allclose(g_mc, prob.mc_grad(c, s), atol=2e-5)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "tests"]
        for f in files:
            if f.endswith(".py"):
                tops = set(_imports(os.path.join(dirpath, f)))
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
                seen += 1
    assert seen >= 10
    ref_tops = set(_imports(os.path.join(BENCH, "reference",
                                         "ring_maxcut.py")))
    assert ref_tops <= {"__future__", "math", "torch"}
