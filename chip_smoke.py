#!/usr/bin/env python3
"""Drive the PyTorch port (``diffquantum_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. In order, and failing (non-zero exit)
at the first phase that does not hold:

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``csrc/*.cu`` built with nvcc, with its time and the
   ``-Xptxas -v`` register and shared-memory lines;
2. kernels against their plain PyTorch versions on the card, case by
   case, forward and backward: K1 (one state) and K2 (a batch of states
   with per-member angle rows, one shared row, or group rows each
   serving a run of members), at the shapes listed in phase_kernels;
3. the paths through the user's entry points, each with the kernels'
   launch counters set to 0 just before it and read just after:
   a. the 12-qubit ring MaxCut adjoint gradient (``energy_and_grad``)
      and 30 Adam epochs of ``train_energy`` (K1);
   b. ``train_energy_seeds``, 64 seeds, 30 adjoint epochs (K2);
   c. the Monte-Carlo estimator: ``mc_energy_grad`` at a fixed split
      time (K1 to s, one K2 launch over the 48 branches), 64 samples
      with per-seed coefficients and split times
      (``mc_grads_per_sample``, two K2 launches), 256 stratified
      samples (``mc_energy_grad_batch``), 30 epochs of
      ``train_energy(grad_mode='mc')`` and 64 seeds of
      ``train_energy_seeds(grad_mode='mc')`` (K1, K2);
   d. ``fd_energy_grad``: 288 perturbed coefficient sets as one K2
      forward;
   each checked against the eager Strang engine on the card
   (``backend='product'``) or the adjoint gradient, with the limits
   named below;
4. times with CUDA events after warm-up: each kernel at the main path's
   shapes beside its plain version and its bound, and K2's forward at
   the MC epoch's branch leg (3072 members, 64 rows); the 12-qubit grad
   step, the 16-qubit 1000-step grad step, the 64-seed adjoint epoch,
   the MC gradient, the 64-seed MC epoch and the FD gradient, each
   beside the eager engine's time;
5. a JSON line of per-kernel numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.

It needs a card: without one, or outside a checkout, it exits non-zero
and prints no result. It imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 non-tensor
# FLOP/s. The bound of a call is the larger of bytes/HBM and ops/fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# forward atol on the state; gradients relative to their max-norm.
# T=1000 (16q): an H100 run read 1.1e-6 forward and 2.8e-4 on d theta_half
# (the f32 rebuild of the state drifts over 1000 inverse steps), so the
# limits sit about 9x and 3.6x above those readings.
TOL = {"fwd": 5e-5, "grad": 1e-4}
TOL_LONG = {"fwd": 1e-5, "grad": 1e-3}

# The new paths against the eager engine on the card (f32 both sides).
# Seeds: per-epoch per-seed losses over 3 epochs, absolute. MC at a fixed
# split time and FD: the gradient, relative to its max-norm. MC with 256
# stratified samples: cosine with the adjoint gradient (the CPU test
# reads 0.998 at 10 qubits, tests/test_torch_mc.py). FD against the
# adjoint gradient: relative to its max-norm. FD quotients in f32 carry
# energy errors of ~1e-6 over 2 delta = 2e-3: an H100 run read 1.1e-3
# against the eager engine's FD and 2.0e-3 against the adjoint, so those
# limits sit ~4.6x and 5x above; the seeds' losses read 1.7e-5 (3x). MC
# with per-seed coefficients and split times, each sample to its own
# max-norm: an H100 run read 6.6e-6 at worst over 64 samples (15x).
SEEDS_LOSS_ATOL = 5e-5
MC_EAGER_REL = 1e-4
MC_COS_MIN = 0.99
FD_EAGER_REL = 5e-3
FD_ADJ_REL = 1e-2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def rel_err(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


# --------------------------------------------------------------------------
# bounds (least time the card could take), from the call's shapes
# --------------------------------------------------------------------------

def _rot_pairs(kinds, d):
    return sum(d // 4 if k == "hop" else d // 2 for k in kinds)


def chain_bound(d, n_steps, kinds, backward, members=1, rows=1):
    """(bound_ms, bound_by) for one K1 (members = rows = 1) or K2 call of
    ``members`` states reading ``rows`` angle rows: every input read once,
    every output written once (gradients in the rows' shape); the fp32
    operations the function needs (sin and cos one each), the per-member
    state updates once per member and the angle work once per row. Per
    amplitude pair a rotation takes 12 (two complex outputs of c x + s y);
    the adjoint undoes y (12), carries lambda back (12) and forms
    Re<lambda, -iG y> for d theta_x (8): 32. A phase stage takes 6 per
    amplitude forward and 17 backward, plus its sin and cos per row."""
    n_ops, T = len(kinds), n_steps
    f = 4
    pairs = _rot_pairs(kinds, d)
    if not backward:
        nbytes = f * (T * rows * (d + n_ops) + 4 * d * members) + 16 * n_ops
        ops = members * ((T + 1) * d * 6 + T * 12 * pairs) \
            + rows * ((T + 1) * d * 2 + (T - 1) * d + T * 2 * n_ops)
    else:
        nbytes = f * (2 * T * rows * (d + n_ops) + 6 * d * members) \
            + 16 * n_ops
        ops = members * ((T + 1) * d * 17 + T * 32 * pairs) \
            + rows * ((T + 1) * d * 2 + T * 2 * n_ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    from diffquantum_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"build: {len(results)} source(s) in "
        f"{time.perf_counter() - t0:.3f} s wall")
    for name, res in results.items():
        log(f"  {name}.cu: nvcc {res.seconds:.3f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                log(f"    {line.strip()}")


def maxcut_chain(n, n_steps, seed, scale=0.4, members=None):
    """The main path's kernel inputs for an n-qubit ring MaxCut, random
    coefficients from ``seed``: one set (K1's tables [T, d], [T, n_x]) or
    one per member (K2's [T, B, d], [T, B, n_x]). The cotangent is the
    loss's, 2 w psi."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import fused_chain_inputs
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6,
                               device=DEVICE)
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    coeff = torch.tensor(scale * rng.standard_normal(
        lead + prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    th, tx, qubits, kinds = fused_chain_inputs(
        prob.ham, prob.envelope, coeff, 0.0, prob.T, prob.T, n_steps)
    return prob, th, tx, qubits, kinds


def mixed_chain(n, n_steps, seed):
    """A random 12-qubit plan of X, Y and hop ops sharing qubits, made
    palindromic by _symmetrize_rots as the engine makes it."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import _symmetrize_rots
    d = 2**n
    rng = np.random.default_rng(seed)
    qubits = tuple(range(n)) + (0, 5, (1, 2), (3, 9), (0, n - 1))
    kinds = ("x",) * n + ("y", "y", "hop", "hop", "hop")
    tx = torch.tensor(0.3 * rng.standard_normal((n_steps, len(qubits))),
                      dtype=torch.float32, device=DEVICE)
    qubits, kinds, tx = _symmetrize_rots(qubits, kinds, tx, dim=1)
    th = torch.tensor(0.2 * rng.standard_normal((n_steps, d)),
                      dtype=torch.float32, device=DEVICE)
    return th, tx.contiguous(), qubits, kinds


def _random_cp(rng, shape, scale):
    import torch
    from diffquantum_tpu_torch.ops.cpx import CP
    v = scale * rng.standard_normal((2,) + tuple(shape))
    return CP(*(torch.tensor(x, dtype=torch.float32, device=DEVICE)
                for x in v))


def _check_case(label, kernel, tol, out, ref, got, want):
    """Fail unless the kernel's forward ``out`` and backward ``got`` match
    the plain version's ``ref`` and ``want``; returns (forward max abs
    error, backward max abs error, backward relative errors)."""
    fwd_err = max(float((out[0] - ref.re).abs().max()),
                  float((out[1] - ref.im).abs().max()))
    if not (np.isfinite(fwd_err) and fwd_err <= tol["fwd"]):
        fail(f"{label}: {kernel} forward differs from plain by {fwd_err} "
             f"(atol {tol['fwd']})")
    rels = [rel_err(a, b) for a, b in zip(got, want)]
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(np.isfinite(r) and r <= tol["grad"] for r in rels):
        fail(f"{label}: {kernel} backward differs from plain: relative "
             f"errors (dpsi_re, dpsi_im, dtheta_half, dtheta_x) {rels} "
             f"(bound {tol['grad']})")
    return fwd_err, bwd_abs, rels


def phase_kernels():
    """K1 and K2 forward and backward against the plain versions, case by
    case. Returns {kernel: (forward, backward) max abs errors} of each
    kernel's main-path case (the first of its list)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    errs = {}
    k1_cases = [("12q ring MaxCut, T=30", 12, 30, "maxcut", TOL),
                ("16q ring MaxCut, T=1000", 16, 1000, "maxcut", TOL_LONG),
                ("17q ring MaxCut, T=30", 17, 30, "maxcut", TOL),
                ("12q mixed X/Y/hop palindromic plan, T=30", 12, 30, "mixed",
                 TOL),
                ("12q ring MaxCut, T=1", 12, 1, "maxcut", TOL)]
    for label, n, n_steps, kind, tol in k1_cases:
        d = 2**n
        rng = np.random.default_rng(n * 1000 + n_steps)
        if kind == "maxcut":
            prob, th, tx, qubits, kinds = maxcut_chain(n, n_steps, seed=n)
            psi0 = prob.psi0
        else:
            th, tx, qubits, kinds = mixed_chain(n, n_steps, seed=n)
            psi0 = _random_cp(rng, (d,), 1.0 / np.sqrt(2 * d))
        t0 = time.perf_counter()
        out = tfp.fused_product_evolve(psi0, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = tfp.fused_product_evolve_plain(psi0, th, tx, qubits, n, kinds)
        if kind == "maxcut":  # the loss's cotangent, dL/dpsi = 2 w psi
            w = prob.measurement.diag
            lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)
        else:
            lam = _random_cp(rng, (d,), 1.0)
        got = tfp._backward_cuda(out.re, out.im, lam.re, lam.im, th, tx,
                                 tfp._plan_ops(qubits, kinds, n), n)
        torch.cuda.synchronize()
        gp, gth, gtx = tfp._adjoint_plain(ref, lam, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(label, "K1", tol,
                                             (out.re, out.im), ref, got,
                                             (gp.re, gp.im, gth, gtx))
        log(f"kernel check K1 [{label}]: {len(kinds)} ops, forward max abs "
            f"err {fwd_err!r} (atol {tol['fwd']}); backward relative errors "
            f"{rels!r} (bound {tol['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms")
        errs.setdefault("k1", (fwd_err, bwd_abs))

    # (label, qubits, steps, members B, angle rows G, chain): row g serves
    # members g*B/G .. (g+1)*B/G - 1. Each case goes through the wrapper
    # and autograd, as the paths call it.
    k2_cases = [("12q ring MaxCut, T=30, B=64 per-seed angles", 12, 30, 64,
                 64, "maxcut"),
                ("12q mixed X/Y/hop plan, T=30, B=48 on one shared row (G=1)",
                 12, 30, 48, 1, "mixed"),
                ("12q ring MaxCut, T=30, B=3072 on 64 group rows (the 64-seed"
                 " MC epoch's branch leg)", 12, 30, 3072, 64, "maxcut"),
                ("16q ring MaxCut, T=30, B=8 (global-memory mode)", 16, 30, 8,
                 8, "maxcut"),
                ("17q ring MaxCut, T=30, B=4", 17, 30, 4, 4, "maxcut"),
                ("12q ring MaxCut, T=1, B=3", 12, 1, 3, 3, "maxcut")]
    for label, n, n_steps, b, rows, kind in k2_cases:
        d = 2**n
        rng = np.random.default_rng(n * 1000 + n_steps + b)
        if kind == "maxcut":
            prob, th, tx, qubits, kinds = maxcut_chain(n, n_steps, seed=n + b,
                                                       members=rows)
            w = prob.measurement.diag
        else:
            th, tx, qubits, kinds = mixed_chain(n, n_steps, seed=n)
            th, tx = th[:, None].contiguous(), tx[:, None].contiguous()
            w = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                             device=DEVICE)
        if rows == b:
            psi0 = CP(prob.psi0.re.expand(b, -1).contiguous(),
                      prob.psi0.im.expand(b, -1).contiguous())
        else:  # members of one row differ only in their states
            psi0 = _random_cp(rng, (b, d), 1.0 / np.sqrt(2 * d))
        leaves = [t.clone().requires_grad_(True)
                  for t in (psi0.re, psi0.im, th, tx)]
        before = (tfp.K2_FWD_LAUNCHES, tfp.K2_BWD_LAUNCHES)
        t0 = time.perf_counter()
        out = tfp.fused_product_evolve_batched(CP(leaves[0], leaves[1]),
                                               leaves[2], leaves[3], qubits,
                                               n, kinds)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = tfp.fused_product_evolve_batched_plain(psi0, th, tx, qubits, n,
                                                     kinds)
        lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)  # d<w>/dpsi
        got = torch.autograd.grad((out.re, out.im), leaves, (lam.re, lam.im))
        torch.cuda.synchronize()
        ran = (tfp.K2_FWD_LAUNCHES - before[0],
               tfp.K2_BWD_LAUNCHES - before[1])
        if ran != (1, 1):
            fail(f"{label}: the wrapper launched K2 {ran} times (forward, "
                 f"backward), expected (1, 1)")
        gp, gth, gtx = tfp._adjoint_batched_plain(ref, lam, th, tx, qubits, n,
                                                  kinds)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(
            label, "K2", TOL, (out.re.detach(), out.im.detach()), ref, got,
            (gp.re, gp.im, gth, gtx))
        log(f"kernel check K2 [{label}]: {len(kinds)} ops, forward max abs "
            f"err {fwd_err!r} (atol {TOL['fwd']}); backward relative errors "
            f"{rels!r} (bound {TOL['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms")
        errs.setdefault("k2", (fwd_err, bwd_abs))
    return errs


def zero_counts():
    from diffquantum_tpu_torch.ops import fused_product as tfp
    tfp.FWD_LAUNCHES = tfp.BWD_LAUNCHES = 0
    tfp.K2_FWD_LAUNCHES = tfp.K2_BWD_LAUNCHES = 0


def read_counts():
    """{kernel name: launches since zero_counts()} after a sync."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    torch.cuda.synchronize()
    return {"k1_forward": tfp.FWD_LAUNCHES, "k1_backward": tfp.BWD_LAUNCHES,
            "k2_forward": tfp.K2_FWD_LAUNCHES,
            "k2_backward": tfp.K2_BWD_LAUNCHES}


def expect_counts(path, counts, want):
    """Fail unless the path launched exactly ``want`` (kernel -> count;
    kernels not named must not have run)."""
    full = {k: want.get(k, 0) for k in counts}
    log(f"launches [{path}]: {counts}")
    if counts != full:
        fail(f"{path} launched {counts}, expected {full}: not on the "
             f"kernels its entry point routes it to")


def twelve_qubits():
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(12, maxcut.ring_graph(12), n_basis=6,
                               device=DEVICE)
    n_steps = reference_n_steps(10, 0.0, prob.T)
    if select_engine(prob.ham) != "streamed" or n_steps != 30:
        fail(f"12q MaxCut routes to {select_engine(prob.ham)!r} with "
             f"{n_steps} steps, expected 'streamed' with 30")
    return prob, n_steps


def coeff_12q(prob, seed=12, lead=()):
    import torch
    rng = np.random.default_rng(seed)
    return torch.tensor(0.4 * rng.standard_normal(
        tuple(lead) + prob.envelope.coeff_shape), dtype=torch.float32,
        device=DEVICE)


def phase_main_path(total):
    """The 12q MaxCut adjoint step and 30 epochs of training through the
    entry points (K1)."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    prob, n_steps = twelve_qubits()
    coeff = coeff_12q(prob)
    zero_counts()
    val, grad = energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                                coeff, prob.psi0, prob.T, n_steps)
    step_counts = read_counts()
    expect_counts("energy_and_grad, 12q", step_counts,
                  {"k1_forward": 1, "k1_backward": 1})
    zero_counts()
    result = train_energy(prob.ham, prob.envelope, prob.measurement,
                          prob.psi0, prob.T,
                          TrainConfig(n_epoch=30, grad_mode="adjoint"))
    counts = read_counts()
    expect_counts("train_energy adjoint, 12q, 30 epochs", counts,
                  {"k1_forward": 31, "k1_backward": 30})
    for c in (step_counts, counts):
        for k, v in c.items():
            total[k] += v

    # reference: the eager Strang engine on the card (independent code)
    val_e, grad_e = energy_and_grad(prob.ham, prob.envelope,
                                    prob.measurement, coeff, prob.psi0,
                                    prob.T, n_steps, backend="product")
    dv, dg = abs(float(val) - float(val_e)), rel_err(grad, grad_e)
    log(f"main path: 12q grad step value {float(val)!r} (eager engine "
        f"{float(val_e)!r}, diff {dv!r}); gradient relative diff {dg!r}")
    if not (torch.isfinite(grad).all() and dv <= 5e-5 and dg <= 1e-4):
        fail("12q grad step disagrees with the eager engine "
             "(value atol 5e-5, gradient 1e-4 of max-norm)")
    losses = result.losses_raw
    log(f"main path: train_energy 30 epochs, loss {losses[0]!r} -> "
        f"{losses[-1]!r} (min {min(losses)!r}), gap {result.losses_energy[-1]!r}"
        f", wall {result.wall_s:.3f} s")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("train_energy loss did not fall over 30 epochs")
    psi = result.final_state
    norm = float((psi.re.double() ** 2 + psi.im.double() ** 2).sum())
    state, cut = prob.readout(psi)
    log(f"main path: final state norm {norm!r}; readout bitstring "
        f"{state:012b}, cut {cut} of max {prob.max_cut}")
    if not (abs(norm - 1.0) < 1e-4 and 0 <= state < 2**12
            and 0.0 < cut <= prob.max_cut):
        fail("final state is not a normalized state with a valid cut")


def phase_seeds(total):
    """64 seeds of the 12q MaxCut, 30 adjoint epochs (K2 forward and
    backward once per epoch); the first 3 epochs against the eager
    engine."""
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig

    prob, _ = twelve_qubits()
    cfg = TrainConfig(n_epoch=30, lr=2e-2)
    args = (prob.ham, prob.envelope, prob.measurement, prob.psi0, prob.T)
    zero_counts()
    res = train_energy_seeds(*args, cfg, n_seeds=64)
    counts = read_counts()
    expect_counts("train_energy_seeds adjoint, 64 seeds, 30 epochs", counts,
                  {"k2_forward": 30, "k2_backward": 30})
    for k, v in counts.items():
        total[k] += v
    eager = train_energy_seeds(*args, cfg.replace(n_epoch=3,
                                                  backend="product"),
                               n_seeds=64)
    diff = float(np.abs(res.losses[:3] - eager.losses).max())
    first, last = res.losses[0], res.losses[-1]
    log(f"seeds: 64 seeds x 30 epochs, mean loss {float(first.mean())!r} -> "
        f"{float(last.mean())!r}, best seed {res.best_seed} at "
        f"{res.best_loss!r}; first 3 epochs vs the eager engine: max abs "
        f"diff {diff!r} (atol {SEEDS_LOSS_ATOL})")
    if not (res.losses.shape == (30, 64) and np.all(np.isfinite(res.losses))
            and np.all(last < first) and diff <= SEEDS_LOSS_ATOL):
        fail("seed population: losses not finite, not falling for every "
             "seed, or off the eager engine")


def phase_mc(total):
    """The MC estimator through its entry points at 12 qubits."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.mc import (mc_energy_grad,
                                                    mc_energy_grad_batch,
                                                    mc_grads_per_sample)
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    prob, n_steps = twelve_qubits()
    coeff = coeff_12q(prob)
    args = (prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
            prob.T)
    s = torch.tensor(0.7, dtype=torch.float64, device=DEVICE)
    zero_counts()
    g = mc_energy_grad(*args, None, n_steps, s=s)
    counts = read_counts()
    expect_counts("mc_energy_grad, 12q, s=0.7", counts,
                  {"k1_forward": 1, "k2_forward": 1})
    for k, v in counts.items():
        total[k] += v
    g_e = mc_energy_grad(*args, None, n_steps, s=s, backend="product")
    dg = rel_err(g, g_e)
    log(f"mc: 12q gradient at s=0.7 vs the eager engine: relative diff "
        f"{dg!r} (bound {MC_EAGER_REL}); max |g| {float(g.abs().max())!r}")
    if not (torch.isfinite(g).all() and dg <= MC_EAGER_REL):
        fail("MC gradient disagrees with the eager engine")

    # 64 samples, each with its own coefficient set and split time: the
    # 64-seed MC epoch's layout (leg 1 a grid per member, leg 2 3072
    # branches on 64 group rows); each sample against the eager engine
    # relative to its own max-norm
    cs = coeff_12q(prob, seed=13, lead=(64,))
    ss = prob.T * torch.rand(64, dtype=torch.float64, device=DEVICE,
                             generator=torch.Generator(
                                 device=DEVICE).manual_seed(3))
    per_sample = (prob.ham, prob.envelope, prob.measurement, cs, prob.psi0,
                  prob.T, ss, n_steps)
    zero_counts()
    gs = mc_grads_per_sample(*per_sample)
    counts = read_counts()
    expect_counts("mc_grads_per_sample, 12q, 64 seeds x 1 sample", counts,
                  {"k2_forward": 2})
    for k, v in counts.items():
        total[k] += v
    gs_e = mc_grads_per_sample(*per_sample, backend="product")
    dgs = max(rel_err(a, b) for a, b in zip(gs, gs_e))
    log(f"mc: 64 samples with per-seed coefficients and split times vs the "
        f"eager engine: worst per-sample relative diff {dgs!r} (bound "
        f"{MC_EAGER_REL})")
    if not (gs.shape == cs.shape and torch.isfinite(gs).all()
            and dgs <= MC_EAGER_REL):
        fail("per-seed MC samples disagree with the eager engine")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    zero_counts()
    gb = mc_energy_grad_batch(*args, gen, n_steps, 256, strategy="stratified")
    counts = read_counts()
    expect_counts("mc_energy_grad_batch, 12q, 256 stratified", counts,
                  {"k2_forward": 2})
    for k, v in counts.items():
        total[k] += v
    _, adj = energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                             coeff, prob.psi0, prob.T, n_steps)
    cos = float((gb * adj).sum() / (gb.norm() * adj.norm()))
    log(f"mc: 256 stratified samples, cosine with the adjoint gradient "
        f"{cos!r} (limit {MC_COS_MIN}); |mc| / (|adjoint| / T) "
        f"{float(gb.norm() / (adj.norm() / prob.T))!r}")
    if not cos >= MC_COS_MIN:
        fail("MC batch estimate does not point along the adjoint gradient")

    zero_counts()
    r = train_energy(prob.ham, prob.envelope, prob.measurement, prob.psi0,
                     prob.T, TrainConfig(n_epoch=30, grad_mode="mc",
                                         n_step=n_steps))
    counts = read_counts()
    expect_counts("train_energy mc, 12q, 30 epochs", counts,
                  {"k1_forward": 61, "k2_forward": 30})
    for k, v in counts.items():
        total[k] += v
    losses = r.losses_raw
    log(f"mc: train_energy 30 MC epochs, loss {losses[0]!r} -> "
        f"{losses[-1]!r} (min {min(losses)!r}), wall {r.wall_s:.3f} s")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("MC training loss did not fall over 30 epochs")

    zero_counts()
    res = train_energy_seeds(prob.ham, prob.envelope, prob.measurement,
                             prob.psi0, prob.T,
                             TrainConfig(n_epoch=5, grad_mode="mc",
                                         n_step=n_steps), n_seeds=64)
    counts = read_counts()
    expect_counts("train_energy_seeds mc, 64 seeds, 5 epochs", counts,
                  {"k2_forward": 15})
    for k, v in counts.items():
        total[k] += v
    log(f"mc: 64 seeds x 5 MC epochs, mean loss "
        f"{float(res.losses[0].mean())!r} -> {float(res.losses[-1].mean())!r}")
    if not (res.losses.shape == (5, 64) and np.all(np.isfinite(res.losses))):
        fail("MC seed population gave non-finite losses")


def phase_fd(total):
    """FD gradient at 12 qubits: 288 perturbed sets, one K2 forward."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.fd import fd_energy_grad

    prob, n_steps = twelve_qubits()
    coeff = coeff_12q(prob)
    args = (prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
            prob.T, None, n_steps)
    zero_counts()
    g = fd_energy_grad(*args)
    counts = read_counts()
    expect_counts("fd_energy_grad, 12q (288 members)", counts,
                  {"k2_forward": 1})
    for k, v in counts.items():
        total[k] += v
    g_e = fd_energy_grad(*args, backend="product")
    _, adj = energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                             coeff, prob.psi0, prob.T, n_steps)
    de, da = rel_err(g, g_e), rel_err(g, adj)
    log(f"fd: 12q gradient vs the eager engine's FD: relative diff {de!r} "
        f"(bound {FD_EAGER_REL}); vs the adjoint gradient {da!r} (bound "
        f"{FD_ADJ_REL})")
    if not (torch.isfinite(g).all() and de <= FD_EAGER_REL
            and da <= FD_ADJ_REL):
        fail("FD gradient disagrees with the eager engine or the adjoint")


def cuda_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def phase_times():
    """Kernel, plain and path times; returns {kernel: (ms, plain_ms,
    bound_ms, bound_by)}."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.fd import fd_energy_grad
    from diffquantum_tpu_torch.gradients.mc import mc_energy_grad
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig

    n, b = 12, 64
    d = 2**n
    out = {}
    prob, th, tx, qubits, kinds = maxcut_chain(n, 30, seed=n)
    _, th_b, tx_b, _, _ = maxcut_chain(n, 30, seed=n + 1, members=b)
    plan = tfp._plan_ops(qubits, kinds, n)
    psi0 = prob.psi0
    psi_b = CP(psi0.re.expand(b, -1).contiguous(),
               psi0.im.expand(b, -1).contiguous())
    w = prob.measurement.diag
    with torch.no_grad():
        o1 = tfp.fused_product_evolve(psi0, th, tx, qubits, n, kinds)
        ob = tfp.fused_product_evolve_batched(psi_b, th_b, tx_b, qubits, n,
                                              kinds)
    lam1 = CP(2.0 * w * o1.re, 2.0 * w * o1.im)
    lamb = CP(2.0 * w * ob.re, 2.0 * w * ob.im)
    runs = {
        "k1_forward": (
            lambda: tfp._forward_cuda(psi0.re, psi0.im, th, tx, plan, n),
            lambda: tfp.fused_product_evolve_plain(psi0, th, tx, qubits, n,
                                                   kinds), 1),
        "k1_backward": (
            lambda: tfp._backward_cuda(o1.re, o1.im, lam1.re, lam1.im, th, tx,
                                       plan, n),
            lambda: tfp._adjoint_plain(o1, lam1, th, tx, qubits, n, kinds),
            1),
        "k2_forward": (
            lambda: tfp._forward_cuda(psi_b.re, psi_b.im, th_b, tx_b, plan,
                                        n),
            lambda: tfp.fused_product_evolve_batched_plain(
                psi_b, th_b, tx_b, qubits, n, kinds), b),
        "k2_backward": (
            lambda: tfp._backward_cuda(ob.re, ob.im, lamb.re, lamb.im,
                                         th_b, tx_b, plan, n),
            lambda: tfp._adjoint_batched_plain(ob, lamb, th_b, tx_b, qubits,
                                               n, kinds), b),
    }
    for name, (kernel, plain, members) in runs.items():
        ms, plain_ms = cuda_ms(kernel, 200), cuda_ms(plain, 5, 1)
        bound = chain_bound(d, 30, kinds, name.endswith("backward"),
                            members=members, rows=members)
        out[name] = (ms, plain_ms) + bound
        log(f"time: {name} {ms!r} ms/launch, plain version {plain_ms!r} ms, "
            f"bound {bound[0]!r} ms ({bound[1]}) (12q, T=30, {len(kinds)} "
            f"ops, B={members})")
    # the 64-seed MC epoch's branch leg: 3072 members on 64 group rows
    psi_g = _random_cp(np.random.default_rng(3), (48 * b, d),
                       1.0 / np.sqrt(2 * d))
    ms = cuda_ms(lambda: tfp._forward_cuda(psi_g.re, psi_g.im, th_b, tx_b,
                                           plan, n), 20)
    plain_ms = cuda_ms(lambda: tfp.fused_product_evolve_batched_plain(
        psi_g, th_b, tx_b, qubits, n, kinds), 2, 1)
    bound = chain_bound(d, 30, kinds, False, members=48 * b, rows=b)
    log(f"time: k2_forward {ms!r} ms/launch, plain version {plain_ms!r} ms, "
        f"bound {bound[0]!r} ms ({bound[1]}) (12q, T=30, B={48 * b} on {b} "
        f"group rows)")

    rng = np.random.default_rng(0)
    steps = {}
    for nq, n_steps, iters in ((12, 30, 200), (16, 1000, 3)):
        p = prob if nq == 12 else maxcut.build_maxcut(
            nq, maxcut.ring_graph(nq), n_basis=6, device=DEVICE)
        c = torch.tensor(1e-3 * rng.standard_normal(p.envelope.coeff_shape),
                         dtype=torch.float32, device=DEVICE)
        step = lambda: energy_and_grad(p.ham, p.envelope,  # noqa: E731
                                       p.measurement, c, p.psi0, p.T,
                                       n_steps)
        t0 = time.perf_counter()
        warmup = 3 if nq == 12 else 1
        ms = cuda_ms(step, iters, warmup)
        host = (time.perf_counter() - t0) / (iters + warmup) * 1e3
        steps[(nq, n_steps)] = ms
        log(f"time: {nq}q {n_steps}-step adjoint grad step {ms!r} ms "
            f"(CUDA events over {iters} chained calls; host wall "
            f"{host!r} ms/call incl. warm-up)")
    k1_share = (out["k1_forward"][0] + out["k1_backward"][0]) \
        / steps[(12, 30)]
    log(f"time: K1 forward+backward are {k1_share!r} of the 12q grad step")

    # the paths of this slice, each beside the eager engine ('product')
    args = (prob.ham, prob.envelope, prob.measurement, prob.psi0, prob.T)
    coeff = coeff_12q(prob)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    bnd = lambda name, members, rows: chain_bound(  # noqa: E731
        d, 30, kinds, name.endswith("backward"), members, rows)[0]
    paths = {
        "64-seed adjoint epoch": (
            lambda e, bk: train_energy_seeds(
                *args, TrainConfig(n_epoch=e, backend=bk, lr=2e-2),
                n_seeds=b), 20, 2,
            bnd("f", b, b) + bnd("backward", b, b)),
        "12q MC gradient, 1 sample": (
            lambda e, bk: [mc_energy_grad(
                prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
                prob.T, gen, 30, backend=bk) for _ in range(e)], 50, 2,
            bnd("f", 1, 1) + bnd("f", 48, 1)),
        "64-seed MC epoch": (
            lambda e, bk: train_energy_seeds(
                *args, TrainConfig(n_epoch=e, backend=bk, lr=2e-2,
                                   grad_mode="mc", n_step=30), n_seeds=b),
            10, 1, bnd("f", b, b) * 2 + bnd("f", b * 48, b)),
        "12q FD gradient (288 members)": (
            lambda e, bk: [fd_energy_grad(
                prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
                prob.T, None, 30, backend=bk) for _ in range(e)], 10, 1,
            bnd("f", 288, 288)),
    }
    for label, (run, reps, reps_eager, bound) in paths.items():
        ms = cuda_ms(lambda: run(reps, "auto"), 1, warmup=1) / reps
        eager = cuda_ms(lambda: run(reps_eager, "product"), 1,
                        warmup=0) / reps_eager
        log(f"time: {label} {ms!r} ms (CUDA events over {reps} in one "
            f"call), eager engine {eager!r} ms; kernel bound {bound!r} ms")
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available: the port's kernels run only "
             "on the card")
    if not os.path.isfile(os.path.join(ROOT, "diffquantum_tpu_torch", "csrc",
                                       "fused_product.cu")):
        fail("run from the root of a checkout: diffquantum_tpu_torch/ is "
             "missing beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    phase_build()
    errs = phase_kernels()
    launches = {k: 0 for k in ("k1_forward", "k1_backward", "k2_forward",
                               "k2_backward")}
    phase_main_path(launches)
    phase_seeds(launches)
    phase_mc(launches)
    phase_fd(launches)
    log(f"launches over all paths: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was launched no time by the paths")
    times = phase_times()

    replaces = {"k1_forward": 307, "k1_backward": 376, "k2_forward": 672,
                "k2_backward": 733}
    kernels = []
    for name, line in replaces.items():
        ms, plain_ms, bound_ms, bound_by = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "diffquantum_tpu_torch/csrc/fused_product.cu",
            "replaces": f"diffquantum_tpu/ops/fused_product.py:{line}",
            "launches": launches[name],
            "max_abs_err": errs[name[:2]][name.endswith("backward")],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes a chain
        })
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
