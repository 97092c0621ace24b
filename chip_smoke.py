#!/usr/bin/env python3
"""Drive the PyTorch port (``diffquantum_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. In order, and failing (non-zero exit)
at the first phase that does not hold:

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``csrc/*.cu`` built with nvcc (one process each, started
   together), with its time and the ``-Xptxas -v`` register and
   shared-memory lines;
2. kernels against their plain PyTorch versions on the card, case by
   case, forward and backward: K1 (one state) and K2 (a batch of states
   with per-member angle rows, one shared row, or group rows each
   serving a run of members), at the shapes listed in phase_kernels
   (each line naming the plan fp_plan gives it; the main path's K1 and
   K2 backward run twice, bit-identical);
   then the packed-phase pair (csrc/packed_phase.cu) through K3's entry
   point at 18 qubits and K5's single and batched entry points at 19-24,
   the cases listed in phase_packed_kernels (hops inside and across the
   tile boundary, two sign planes, T = 1, B > 1; each line names the
   plan pk_plan gives its shape), and the 24-qubit backward run twice,
   bit-identical; K2 at the 'fused' MCWF step's shape (T = 1, one zero
   phase row and one angle row, 16 and 17 qubits, B = 8); then the same
   pair through K6's entry points (the palindromic A/B schedule of hop drive
   sets, phase_hop_kernels: the molecule drive set at 19, 20 and 24
   qubits, a set whose B ops commute, T = 1, B = 4); K7
   (csrc/taylor_apply.cu, phase_dense_kernels: the paths' shapes, both
   sides of its two launch configurations' boundary, B = 64, and the
   dense MCWF's non-Hermitian M_eff at d = 2, B = 2000 and d = 1024,
   B = 64); and the
   pair through
   K4's entry point, the per-call chain of the sharded engine
   (phase_chunked_kernels: 12 qubits T = 1, the 20-qubit random graph at
   T = 1 and 30, 24 qubits T = 1, a palindromic X/Y plan);
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
   e. the frontier ring MaxCut (n_basis 6, 30 steps, full width): at 18
      qubits ``energy_and_grad`` and 20 epochs of ``train_energy`` (K3,
      no K5); at 20 qubits ``energy_and_grad`` and 8 seeds x 3 epochs of
      ``train_energy_seeds`` (K5 batched), each seed against itself run
      alone (K5 single); at 24 qubits ``energy_and_grad`` and 3 epochs of
      ``train_energy`` (K5), the value against the eager engine at 30
      steps and the gradient at 4;
   f. the 20-qubit molecule drive set (X and Y on every qubit, hops and
      ZZ on the pairs (i, i+1) and (i, i+2); bench.py's
      ``molecule20q_hop_grad_step``): ``energy_and_grad`` (K6 only)
      against the plain K6 chain through the same dispatcher and its
      directional derivative against central differences; 20 epochs of
      ``train_energy``; 4 seeds x 3 epochs of ``train_energy_seeds`` (K6
      batched), each seed against itself run alone; and a 19-qubit set
      of disjoint hops, where K6 and the eager engine coincide, against
      the eager engine;
   g. the dense slice on K7 (phase_dense_paths): the 10-qubit dense
      ring MaxCut, the reference demo with MC gradients, gate synthesis,
      state control and VQE H2;
   h. the state-sharded engine on a mesh of one rank
      (phase_sharded_paths): the 24-qubit ring through 'chunked' (K4
      only) against ``energy_and_grad`` on K5, and 3 Adam epochs; the
      12-qubit ring through 'fused' (K1 only) and 'xla'; 64 seeds on a
      data mesh of one against ``mesh=None``; the dense 'apply' routes:
      the 8-qubit dense seed population on K7, an 11-qubit dense grad
      step and a float64 10-qubit step on the recurrence;
   i. Pauli-string objectives (phase_strings): the 20-qubit TFIM (39
      strings) on K5, its expectation against a diagonal + 1q oracle,
      ``energy_and_grad`` and 20 epochs of ``train_energy`` toward the
      free-fermion energy, sampled strings within 5 standard errors and
      ``sharded_strings_expectation`` on a mesh of one; the 20-qubit
      Heisenberg chain's grad step and 3 epochs (K5); the 24-qubit TFIM
      grad step (K5); the 10-qubit TFIM (K1); the 8-qubit dense TFIM on
      'apply' (K7) against 'expm';
   j. the channel envelope (phase_channel): bench.py's channel12q (K1)
      and channel18q (K3) grad steps against central differences and
      the eager engine, and the 12-qubit channel MC gradient (K1, K2);
   k. MC and FD at 18-24 qubits (phase_sampled_frontier): the 18q (K3)
      and 20q (K5) ring MaxCut's MC gradient at a fixed split time, 32
      stratified samples one after another (cosine with the adjoint)
      and the FD gradient in chunks sized from the card's free memory
      (against the adjoint); 3 MC epochs of ``train_energy`` at 20q;
      one 24q MC sample, 96 branches in one batched K5 launch, against
      the estimator by hand on the eager engine at 4 steps;
   l. ab-initio molecules (phase_molecule; the JAX package's recipes,
      the chains at R = 0.9 A, T = 5, n_basis 8, 60 steps): H2's 300
      float64 epochs on 'expm' to chemical accuracy; the energy at the
      RHF determinant against E_RHF at H4, H6 and H10; 16 H4 seeds x 10
      cosine epochs on 'apply' (K7); H6 (12 qubits): the sector FCI on
      the card, the grad step (K1) against the eager engine, 16 seeds x
      20 cosine epochs (K2), and 6 epochs straight against a run stopped
      after epoch 3's checkpoint and resumed; H10 (20 qubits, 7151
      strings): the grad step (K6) against central differences, its
      time split between K6 and the string measurement, and 3 cosine
      epochs;
   m. open-system dynamics (phase_open; the JAX demo
      demos/demo_open_control.py's recipes): (a) the damped qubit's
      noise-blind against noise-aware control through evolve_lindblad,
      300 epochs each, rho(T) against float64, and 2000 dense MCWF
      trajectories (K7 at d = 2, B = 2000) against the master equation;
      (b) T1-aware MaxCut at 16 qubits through score_surrogate on
      ``evolve_mcwf_structured(backend='fused')`` (K2, one T = 1 launch a
      step each way): 'fused' against 'xla' on one set of draws, 4 Adam
      steps on fixed draws, 30 epochs, 17 qubits, the epoch's time at 8
      and 128 trajectories; (c) evolve_lindblad_structured: 4 Adam
      evaluations at 12 qubits, a forward and backward at 14 (rho 2 GiB,
      its peak memory), 3 qubits against the dense engine in float64;
      (d) 256 dephasing trajectories at 12 qubits against the master
      equation; (e) the dense MCWF on the 10q ring (K7 at d = 1024,
      B = 64) against the same draws in float64; (f) the 16q product
      trajectory, 1000 steps, against K1; (g) evolve_ode at 4 qubits
      against 'expm';
   n. the reference-API facades, the native engine and the GPU demos
      (phase_compat): (a) ``compat.diffqc`` on the card in float64 against
      the port's native C++ engine (built here with the host's c++) on
      the 2-qubit three-channel system and the 10q dense ring with one
      carrier channel a control (no K7: float64 takes the recurrence);
      (b) the reference's demo_maxcut.py line for line through
      ``SimulatorPlain`` (202 MC epochs, K7 on the 16 branches, the max
      cut 0101/1010); (c) the facade on the 10q dense ring (3 MC epochs,
      K7 at d = 1024, B = 40); (d) ``train_fidelity`` and
      ``train_energy_FD``; (e) the host algorithms (closures, MC, FD) on
      the card against the CPU at the same seed and ``trotter`` against
      the native engine; (f) the nine ``demos_torch`` scripts in process
      at their default sizes with the epochs cut;
   each checked against the eager Strang engine on the card
   (``backend='product'``) or the adjoint gradient, with the limits
   named below;
4. times with CUDA events after warm-up: each kernel at the main path's
   shapes beside its plain version and its bound (K1/K2 also beside the
   one-SM floor of a member's chain), and K2's forward at
   the MC epoch's branch leg (3072 members, 64 rows); the 12-qubit grad
   step, the 16-qubit 1000-step grad step, the 64-seed adjoint epoch,
   the MC gradient, the 64-seed MC epoch and the FD gradient, each
   beside the eager engine's time; K3 at 18 qubits and K5 at 20 and 24
   (and batched, B = 8 at 20), the 18/20/24-qubit grad steps and the
   20-qubit 8-seed epoch, with the host's time to enqueue one chain; K6
   on the molecule drive set at 20 qubits (and batched, B = 4) and 24,
   and the 20-qubit molecule grad step; K7 at the eleven shapes of its
   kernel check, forward and backward, each beside its bound, its plain
   version and matrix_exp + product (and that route's VJP), then the 10q
   dense grad step, the CNOT epoch, the 4q demo MC epoch and the 8q dense
   seed epoch; K4 at 24 qubits T = 1 and the 24-qubit sharded grad step
   beside the one on K5; the 20q TFIM and Heisenberg grad steps,
   channel12q and channel18q grad steps, one 20q MC sample and the 20q
   FD gradient (phase_slice_times); the molecule phase's own (H2's
   epochs, the H4 and H6 seed epochs, H6's sector FCI and grad step,
   H10's grad step and its split); phase_open's (K2 at its T = 1 shape,
   the 16q T1-aware epoch at 8 and 128 trajectories, the structured
   master equation at 12 and 14 qubits, the product trajectory);
   phase_compat's, on the host's clock (the 10q float64 diffqc.trotter
   on the card against the native engine on the host, the reference
   demo's 202 epochs through SimulatorPlain, the facade's 10q trotter on
   the card and on the CPU);
5. a JSON line of per-kernel numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.

It needs a card: without one, or outside a checkout, it exits non-zero
and prints no result. It imports nothing of JAX.
"""
import dataclasses
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

# The packed-phase pair (K3, K5) against its plain version: forward atol
# on the state, gradients relative to their max-norm. An H100 run read
# 2.6e-8 forward at worst (K3 18q B=4) and 2.7e-5 on d theta_x (K5 20q,
# two sign planes, T=4), so the limits sit ~4x and ~3.7x above.
TOL_PK = {"fwd": 1e-7, "grad": 1e-4}
# Frontier paths against the eager engine (value atol, gradient relative
# to its max-norm), and each seed of the 20q population against itself
# run alone on single K5 (per-epoch losses, absolute).
FRONTIER_VALUE_ATOL = 5e-5
FRONTIER_GRAD_REL = 1e-4
SEED_ALONE_ATOL = 1e-5

# K6 against its plain version (forward atol on the state, gradients
# relative to their max-norm): an H100 run read 1.8e-8 forward at worst
# (19q molecule set) and 2.4e-5 on d ud (19q disjoint hops), so the limits
# sit ~5x and ~4x above, as TOL_PK. The 20q molecule step's value against
# the plain chain through the same dispatcher, its directional derivative
# against central differences through the path (relative to max(1, |fd|),
# as tests/test_mega_hop.py), and each 20q seed against itself run alone.
TOL_HOP = {"fwd": 1e-7, "grad": 1e-4}
HOP_PLAIN_ATOL = 1e-5
HOP_FD_REL = 5e-3


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


def chain_work(d, n_steps, kinds, backward, members=1, rows=1):
    """(bytes, fp32 operations) of one K1 (members = rows = 1) or K2 call
    of ``members`` states reading ``rows`` angle rows: every input read
    once, every output written once (gradients in the rows' shape); the
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
    return nbytes, ops


def chain_bound(d, n_steps, kinds, backward, members=1, rows=1):
    """(bound_ms, bound_by) of a K1 or K2 call (:func:`chain_work`): the
    larger of its bytes over HBM and its operations over the fp32 rate."""
    nbytes, ops = chain_work(d, n_steps, kinds, backward, members, rows)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


H100_SMS = 132


def one_sm_floor(d, n_steps, kinds, backward):
    """The least time of one member's chain on one SM: its operations
    (:func:`chain_work`, one member, one row) at 1/132 of the card's fp32
    rate, the floor of a chain that one SM carries."""
    ops = chain_work(d, n_steps, kinds, backward)[1]
    return ops / (FP32_OPS_PER_S / H100_SMS) * 1e3


def fp_plan_text(n, plan, members, groups, backward):
    """K1/K2's launch plan for a call, as chip_smoke's lines name it."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    g = tfp.fp_plan(n, tuple(map(tuple, plan.tolist())), members, groups,
                    tfp._sm_count(torch.device(DEVICE)), backward)
    return (f"{'bwd' if backward else 'fwd'} {g.mode} r={g.rbits} "
            f"{g.threads}t x {g.blocks} blocks, {g.launches} launch(es) of "
            f"{g.chunk} members, {len(g.rounds)} rounds, "
            f"{g.exchanges} exchanges a step, bufs {g.bufs}, "
            f"{g.per_sm} a SM")


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


def _check_case(label, kernel, tol, out, ref, got, want,
                names="dpsi_re, dpsi_im, dtheta_half, dtheta_x"):
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
             f"errors ({names}) {rels} (bound {tol['grad']})")
    return fwd_err, bwd_abs, rels


def phase_kernels():
    """K1 and K2 forward and backward against the plain versions, case by
    case. Returns {kernel: (forward, backward) max abs errors} of each
    kernel's main-path case (the first of its list)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    errs = {}
    # the main path's shape first; then both sides of one block a member
    # (13q forward and 12q backward in a block, 14q past it), a grid of
    # blocks (15-17q) and the long chain
    k1_cases = [("12q ring MaxCut, T=30", 12, 30, "maxcut", TOL),
                ("10q ring MaxCut, T=30", 10, 30, "maxcut", TOL),
                ("13q ring MaxCut, T=30", 13, 30, "maxcut", TOL),
                ("14q ring MaxCut, T=30", 14, 30, "maxcut", TOL),
                ("15q ring MaxCut, T=30", 15, 30, "maxcut", TOL),
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
        plan = tfp._plan_ops(qubits, kinds, n)
        got = tfp._backward_cuda(out.re, out.im, lam.re, lam.im, th, tx,
                                 plan, n)
        torch.cuda.synchronize()
        gp, gth, gtx = tfp._adjoint_plain(ref, lam, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(label, "K1", tol,
                                             (out.re, out.im), ref, got,
                                             (gp.re, gp.im, gth, gtx))
        log(f"kernel check K1 [{label}]: {len(kinds)} ops, forward max abs "
            f"err {fwd_err!r} (atol {tol['fwd']}); backward relative errors "
            f"{rels!r} (bound {tol['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms; plan [{fp_plan_text(n, plan, 1, 1, False)}"
            f"; {fp_plan_text(n, plan, 1, 1, True)}]")
        if "k1" not in errs:  # the main path's backward, run again
            _bit_identical(label, "K1", got, tfp._backward_cuda(
                out.re, out.im, lam.re, lam.im, th, tx, plan, n))
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
                ("12q ring MaxCut, T=30, B=3 (SMs left free)", 12, 30, 3, 3,
                 "maxcut"),
                ("12q ring MaxCut, T=30, B=133 (one member past the SMs)",
                 12, 30, 133, 133, "maxcut"),
                ("14q ring MaxCut, T=30, B=64 (a grid in two launches of 32 "
                 "members: one launch's blocks would not all be resident)",
                 14, 30, 64, 64, "maxcut"),
                ("14q ring MaxCut, T=30, B=136 (past the SMs: a grid in five "
                 "launches of 28 members)", 14, 30, 136, 136, "maxcut"),
                ("16q ring MaxCut, T=30, B=8", 16, 30, 8, 8, "maxcut"),
                ("17q ring MaxCut, T=30, B=4", 17, 30, 4, 4, "maxcut"),
                ("17q ring MaxCut, T=30, B=8 (a grid in two launches of 4 "
                 "members)", 17, 30, 8, 8, "maxcut"),
                ("12q ring MaxCut, T=1, B=3", 12, 1, 3, 3, "maxcut"),
                ("16q ring MaxCut, T=1, B=8 on one zero phase row and one "
                 "angle row (the 'fused' MCWF step)", 16, 1, 8, 1, "mcwf"),
                ("17q ring MaxCut, T=1, B=8 on one zero phase row and one "
                 "angle row (the 'fused' MCWF step)", 17, 1, 8, 1, "mcwf")]
    for label, n, n_steps, b, rows, kind in k2_cases:
        d = 2**n
        rng = np.random.default_rng(n * 1000 + n_steps + b)
        if kind == "maxcut":
            prob, th, tx, qubits, kinds = maxcut_chain(n, n_steps, seed=n + b,
                                                       members=rows)
            w = prob.measurement.diag
        elif kind == "mcwf":  # fused_rot_block's inputs: no phase
            prob, _, tx, qubits, kinds = maxcut_chain(n, 1, seed=n + b,
                                                      members=1)
            th = torch.zeros((1, 1, d), dtype=torch.float32, device=DEVICE)
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
        before = read_counts()
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
        after = read_counts()
        ran = (after["k2_forward"] - before["k2_forward"],
               after["k2_backward"] - before["k2_backward"])
        if ran != (1, 1):
            fail(f"{label}: the wrapper launched K2 {ran} times (forward, "
                 f"backward), expected (1, 1)")
        gp, gth, gtx = tfp._adjoint_batched_plain(ref, lam, th, tx, qubits, n,
                                                  kinds)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(
            label, "K2", TOL, (out.re.detach(), out.im.detach()), ref, got,
            (gp.re, gp.im, gth, gtx))
        plan = tfp._plan_ops(qubits, kinds, n)
        log(f"kernel check K2 [{label}]: {len(kinds)} ops, forward max abs "
            f"err {fwd_err!r} (atol {TOL['fwd']}); backward relative errors "
            f"{rels!r} (bound {TOL['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms; plan [{fp_plan_text(n, plan, b, rows, False)}"
            f"; {fp_plan_text(n, plan, b, rows, True)}]")
        if "k2" not in errs:  # the seeds' backward, run twice
            o_re, o_im = out.re.detach(), out.im.detach()
            _bit_identical(label, "K2", *(
                tfp._backward_cuda(o_re, o_im, lam.re, lam.im, th, tx, plan,
                                   n) for _ in range(2)))
        errs.setdefault("k2", (fwd_err, bwd_abs))
    return errs


def _bit_identical(label, kernel, got, again):
    """Fail unless two runs of a backward gave the same bits."""
    import torch
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(got, again)]
    log(f"kernel check {kernel} [{label}, backward run twice]: "
        f"bit-identical {same}")
    if not all(same):
        fail(f"{label}: {kernel} backward differs between two runs")


# --------------------------------------------------------------------------
# the frontier sizes: the packed-phase pair (K3 at 18 qubits, K5 at 19-24)
# --------------------------------------------------------------------------

_PROBLEMS = {}


def frontier_problem(n, graph="ring"):
    """The n-qubit MaxCut at full width (n_basis 6), built once per run;
    'random' is ``random_graph(n, p=0.25, seed=1)`` (two sign planes at
    20 qubits). Logs the host's build and packed-table times and memory."""
    import resource
    from diffquantum_tpu_torch.dynamics.product import (_packed_tables,
                                                        select_engine)
    from diffquantum_tpu_torch.models import maxcut
    key = (n, graph)
    if key not in _PROBLEMS:
        edges = maxcut.ring_graph(n) if graph == "ring" \
            else maxcut.random_graph(n, p=0.25, seed=1)
        t0 = time.perf_counter()
        prob = maxcut.build_maxcut(n, edges, n_basis=6, device=DEVICE)
        t1 = time.perf_counter()
        engine = select_engine(prob.ham)          # pack_diag_signs
        t2 = time.perf_counter()
        signs = _packed_tables(prob.ham, DEVICE)[0]  # parity masks, planes
        t3 = time.perf_counter()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        log(f"host: {n}q {graph} MaxCut ({len(edges)} edges): build_maxcut "
            f"{t1 - t0:.3f} s, select_engine {t2 - t1:.3f} s -> {engine!r}, "
            f"sign planes {tuple(signs.shape)} {t3 - t2:.3f} s; peak host "
            f"RSS so far {rss:.2f} GiB")
        _PROBLEMS[key] = prob
    return _PROBLEMS[key]


def packed_inputs(prob, n_steps, seed, members=None, scale=0.4):
    """(coeff, ud, theta_x, h0th, signs, qubits, kinds) of the packed
    kernels for ``prob`` with random coefficients from ``seed``: one set
    (ud [T, S]) or one per member (ud [T, B, S])."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import packed_chain_inputs
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    coeff = torch.tensor(scale * rng.standard_normal(
        lead + prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    return (coeff,) + packed_chain_inputs(prob.ham, prob.envelope, coeff,
                                          0.0, prob.T, prob.T, n_steps)


def mixed_packed(n, n_steps, seed):
    """An n-qubit plan of X, Y and hop ops sharing qubits (palindromic):
    one hop inside the pass kernels' tile (bits k-1 and 1), one across
    its boundary (bits k+1 and k-2) and one on the strided bits (qubits 0
    and 1), for the tile bits k of both the forward's and the backward's
    plan (``pk_plan``); random rows, a random drift h0th and the ring's
    sign planes. Returns (psi0 [1, d], ud [T, 1, S], theta_x [T, 1,
    n_ops], h0th, signs, qubits, kinds)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import _symmetrize_rots
    from diffquantum_tpu_torch.ops import fused_product as tfp
    d = 2**n
    rng = np.random.default_rng(seed)
    _, _, _, _, signs, _, _ = packed_inputs(frontier_problem(n), 1, seed)
    # qubit q is bit n-1-q; a tile holds bits < k
    ks = [tfp.pk_plan(n, planes, n).k for planes in (2, 4)]
    lo, hi = min(ks), max(ks)
    assert hi + 2 < n
    qubits = tuple(range(n)) + (0, n - 3, (n - lo, n - 2),
                                (n - hi - 2, n - lo + 1), (0, 1))
    kinds = ("x",) * n + ("y", "y", "hop", "hop", "hop")
    f32 = dict(dtype=torch.float32, device=DEVICE)
    tx = torch.tensor(0.3 * rng.standard_normal((n_steps, 1, len(qubits))),
                      **f32)
    qubits, kinds, tx = _symmetrize_rots(qubits, kinds, tx, dim=2)
    ud = torch.tensor(0.2 * rng.standard_normal((n_steps, 1, n + 1)), **f32)
    h0th = torch.tensor(0.1 * rng.standard_normal(d), **f32)
    psi0 = _random_cp(rng, (1, d), 1.0 / np.sqrt(2 * d))
    return psi0, ud, tx.contiguous(), h0th, signs, qubits, kinds


def pk_geometry(n, n_diag, members):
    """The pass kernels' plan (``pk_plan``) at a shape, both directions,
    as one line: the splits k, k2 and columns lc, and per pass kind its
    tile size, register bits, threads, ring stages and blocks per member
    (a pass of one round runs direct, without its ring)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = []
    for part, planes in (("fwd", 2), ("bwd", 4)):
        g = tfp.pk_plan(n, planes, n_diag, members, sms)
        kinds = [(name, p) for name, p in (("tile", g.tile), ("mid", g.mid),
                                           ("strided", g.strided))
                 if p is not None]
        parts.append(f"{part} k={g.k} k2={g.k2} lc={g.lc}: " + ", ".join(
            f"{name} 2^{p.lb} r={p.rbits} {p.threads}t S={p.stages} "
            f"{p.blocks} blocks" for name, p in kinds))
    return "; ".join(parts)


def phase_packed_kernels():
    """K3 and K5 forward and backward through their entry points and
    autograd against the plain versions. Returns {kernel: (forward,
    backward) max abs errors} of each one's main-path case (K3: 18q ring,
    T=30; K5: 24q ring, T=30)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_chunked as tfc
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    k3 = (tfp.fused_product_evolve_packed,
          tfp.fused_product_evolve_packed_plain, tfp._adjoint_packed_plain)
    k5 = (tfc.chunked_evolve_mega, tfc.chunked_evolve_mega_plain,
          tfc._adjoint_mega_plain)
    k5b = (tfc.chunked_evolve_mega_batched,
           tfc.chunked_evolve_mega_batched_plain, tfc._adjoint_mega_plain)
    # (label, kernel, functions, qubits, steps, members B or None, chain,
    # main-path case of its kernel)
    cases = [("K3 18q ring MaxCut, T=30, B=1", "k3", k3, 18, 30, 1, "ring",
              True),
             ("K3 18q mixed X/Y/hop plan (hops in, across and above the "
              "tile), T=4", "k3", k3, 18, 4, 1, "mixed", False),
             ("K3 18q ring MaxCut, T=30, B=4 per-member rows", "k3", k3, 18,
              30, 4, "ring", False),
             ("K3 18q ring MaxCut, T=1", "k3", k3, 18, 1, 1, "ring", False),
             ("K5 19q ring MaxCut, T=30", "k5", k5, 19, 30, None, "ring",
              False),
             ("K5 20q random graph (P=2 sign planes), T=4", "k5", k5, 20, 4,
              None, "random", False),
             ("K5 batched 20q ring MaxCut, T=30, B=8 per-member rows", "k5",
              k5b, 20, 30, 8, "ring", False),
             ("K5 24q ring MaxCut, T=30", "k5", k5, 24, 30, None, "ring",
              True)]
    errs = {}
    for label, kernel, (entry, plain, adjoint), n, n_steps, b, chain, main \
            in cases:
        d = 2**n
        seed = n * 1000 + n_steps + (b or 0)
        rng = np.random.default_rng(seed)
        if chain == "mixed":
            psi0, ud, tx, h0th, signs, qubits, kinds = mixed_packed(
                n, n_steps, seed)
            w = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                             device=DEVICE)
        else:
            prob = frontier_problem(n, chain)
            members = None if b == 1 and kernel == "k3" else b
            _, ud, tx, h0th, signs, qubits, kinds = packed_inputs(
                prob, n_steps, seed, members)
            w = prob.measurement.diag
            psi0 = prob.psi0
            if kernel == "k3":  # K3 takes [B, d] and [T, B, ...] rows
                psi0 = CP(psi0.re.expand(b, -1).contiguous(),
                          psi0.im.expand(b, -1).contiguous())
                if members is None:
                    ud, tx = ud[:, None].contiguous(), tx[:, None].contiguous()
            elif b is not None:
                psi0 = CP(psi0.re.expand(b, -1).contiguous(),
                          psi0.im.expand(b, -1).contiguous())
        args = (h0th, signs, qubits, n, kinds)
        leaves = [t.clone().requires_grad_(True)
                  for t in (psi0.re, psi0.im, ud, tx)]
        before = read_counts()
        t0 = time.perf_counter()
        out = entry(CP(leaves[0], leaves[1]), leaves[2], leaves[3], *args)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = plain(psi0, ud, tx, *args)
        lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)  # d<w>/dpsi
        got = torch.autograd.grad((out.re, out.im), leaves, (lam.re, lam.im))
        after = read_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {f"{kernel}_forward": 1, f"{kernel}_backward": 1}
        if entry is tfc.chunked_evolve_mega_batched:
            want.update(k5_batched_forward=1, k5_batched_backward=1)
        if ran != want:
            fail(f"{label}: the entry point launched {ran}, expected {want}")
        gp, gud, gtx = adjoint(ref, lam, ud, tx, *args)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(
            label, kernel.upper(), TOL_PK,
            (out.re.detach(), out.im.detach()), ref, got,
            (gp.re, gp.im, gud, gtx), "dpsi_re, dpsi_im, dud, dtheta_x")
        log(f"kernel check {kernel.upper()} [{label}]: {len(kinds)} ops, "
            f"{signs.shape[0]} sign plane(s), plan "
            f"[{pk_geometry(n, ud.shape[-1] - 1, b or 1)}], forward max abs "
            f"err {fwd_err!r} (atol {TOL_PK['fwd']}); backward relative "
            f"errors {rels!r} (bound {TOL_PK['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms")
        if main:
            errs[kernel] = (fwd_err, bwd_abs)
        del out, ref, got, leaves, gp, gud, gtx, lam
        torch.cuda.empty_cache()

    # the 24q backward twice on the same inputs: bit-identical gradients
    # (fixed-order sums, no atomics)
    prob = frontier_problem(24)
    _, ud, tx, h0th, signs, qubits, kinds = packed_inputs(prob, 30, 24)
    ud, tx = ud[:, None].contiguous(), tx[:, None].contiguous()
    plan, udm = tfp._packed_plan(qubits, kinds, 24), tfp.merge_ud_rows(ud)
    o_re, o_im = tfp._packed_forward_cuda(
        prob.psi0.re[None].contiguous(), prob.psi0.im[None].contiguous(),
        udm, tx, h0th, signs, plan, 24, "K5")
    w = prob.measurement.diag
    runs = [tfp._packed_backward_cuda(o_re, o_im, 2.0 * w * o_re,
                                      2.0 * w * o_im, udm, tx, h0th, signs,
                                      plan, 24, "K5") for _ in range(2)]
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
    log(f"kernel check K5 [24q ring MaxCut backward, T=30, run twice]: "
        f"dpsi_re, dpsi_im, dud, dtheta_x bit-identical {same}")
    if not all(same):
        fail("the 24q K5 backward is not bitwise reproducible")
    del runs, o_re, o_im, udm
    torch.cuda.empty_cache()
    return errs


COUNTERS = (  # utils.profiling's launch counters, in the order printed
    "k1_forward", "k1_backward", "k2_forward", "k2_backward", "k3_forward",
    "k3_backward",
    # K5's chains of both forms, and the batched form's among them
    "k5_forward", "k5_backward", "k5_batched_forward", "k5_batched_backward",
    # K6's likewise
    "k6_forward", "k6_backward", "k6_batched_forward", "k6_batched_backward",
    "k7_forward", "k7_backward",
    # K4 (the sharded engine's per-call step), and the dense 'apply'
    # backend's recurrence route (plain products, no kernel of its own)
    "k4_forward", "k4_backward", "apply_recurrence",
)
_ZERO = {}   # the counters' totals at the last zero_counts()


def zero_counts():
    from diffquantum_tpu_torch.utils import profiling
    _ZERO.clear()
    _ZERO.update(profiling.counters())


def read_counts():
    """{kernel name: launches since zero_counts()} after a sync."""
    import torch

    from diffquantum_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    now = profiling.counters()
    return {k: now[k] - _ZERO.get(k, 0) for k in COUNTERS}


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


def _add(total, counts):
    for k, v in counts.items():
        total[k] += v


def _valid_cut(prob, psi, label):
    """Fail unless psi is a normalized state whose most probable bitstring
    is a cut of the graph; returns (bitstring, cut)."""
    n = prob.n_qubits
    norm = float((psi.re.double() ** 2 + psi.im.double() ** 2).sum())
    state, cut = prob.readout(psi)
    log(f"{label}: final state norm {norm!r}; readout bitstring "
        f"{state:0{n}b}, cut {cut} of max {prob.max_cut}")
    if not (abs(norm - 1.0) < 1e-4 and 0 <= state < 2**n
            and 0.0 <= cut <= prob.max_cut and cut == int(cut)):
        fail(f"{label}: final state is not a normalized state with a valid "
             f"cut")
    return state, cut


def _eager_check(label, prob, coeff, n_steps, val, grad, **kw):
    """The grad step's value and gradient against the eager engine
    (``kw``: the step's other options, e.g. t_sample)."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    val_e, grad_e = energy_and_grad(prob.ham, prob.envelope,
                                    prob.measurement, coeff, prob.psi0,
                                    prob.T, n_steps, backend="product", **kw)
    dv, dg = abs(float(val) - float(val_e)), rel_err(grad, grad_e)
    log(f"{label}: value {float(val)!r} (eager engine {float(val_e)!r}, "
        f"diff {dv!r}); gradient relative diff {dg!r} ({n_steps} steps)")
    if not (torch.isfinite(grad).all() and dv <= FRONTIER_VALUE_ATOL
            and dg <= FRONTIER_GRAD_REL):
        fail(f"{label} disagrees with the eager engine (value atol "
             f"{FRONTIER_VALUE_ATOL}, gradient {FRONTIER_GRAD_REL} of "
             f"max-norm)")


def phase_frontier(total):
    """The ring MaxCut at 18, 20 and 24 qubits through the entry points:
    18q on K3 only, 20q and 24q on K5 (the 20q seeds batched)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import (evolve,
                                                           reference_n_steps)
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.measure import diag_expectation
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    for n, engine in ((18, "packed"), (20, "mega"), (24, "mega")):
        prob = frontier_problem(n)
        n_steps = reference_n_steps(10, 0.0, prob.T)
        if select_engine(prob.ham) != engine or n_steps != 30:
            fail(f"{n}q MaxCut routes to {select_engine(prob.ham)!r} with "
                 f"{n_steps} steps, expected {engine!r} with 30")
        kernel = "k3" if engine == "packed" else "k5"
        coeff = torch.tensor(0.4 * np.random.default_rng(n).standard_normal(
            prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
        args = (prob.ham, prob.envelope, prob.measurement)
        zero_counts()
        val, grad = energy_and_grad(*args, coeff, prob.psi0, prob.T, n_steps)
        counts = read_counts()
        expect_counts(f"energy_and_grad, {n}q", counts,
                      {f"{kernel}_forward": 1, f"{kernel}_backward": 1})
        _add(total, counts)
        if n < 24:
            _eager_check(f"frontier: {n}q grad step", prob, coeff, n_steps,
                         val, grad)
        else:  # the eager engine's 30-step tape would not fit: value only
            with torch.no_grad():
                psi_e = evolve(prob.ham, prob.envelope, coeff, prob.psi0,
                               0.0, prob.T, horizon=prob.T, n_steps=n_steps,
                               backend="product")
                val_e = diag_expectation(prob.measurement.diag, psi_e)
            dv = abs(float(val) - float(val_e))
            log(f"frontier: 24q grad step value {float(val)!r} (eager "
                f"engine, no grad, {float(val_e)!r}, diff {dv!r})")
            if not (torch.isfinite(grad).all()
                    and dv <= FRONTIER_VALUE_ATOL):
                fail("24q grad step value disagrees with the eager engine")
            del psi_e
            torch.cuda.empty_cache()
            val4, grad4 = energy_and_grad(*args, coeff, prob.psi0, prob.T, 4)
            _eager_check("frontier: 24q grad step", prob, coeff, 4, val4,
                         grad4)
            torch.cuda.empty_cache()

        if n in (18, 24):
            epochs = 20 if n == 18 else 3
            zero_counts()
            res = train_energy(prob.ham, prob.envelope, prob.measurement,
                               prob.psi0, prob.T,
                               TrainConfig(n_epoch=epochs, lr=2e-2))
            counts = read_counts()
            expect_counts(f"train_energy adjoint, {n}q, {epochs} epochs",
                          counts, {f"{kernel}_forward": epochs + 1,
                                   f"{kernel}_backward": epochs})
            _add(total, counts)
            losses = res.losses_raw
            log(f"frontier: {n}q train_energy {epochs} epochs, loss "
                f"{losses[0]!r} -> {losses[-1]!r}, wall {res.wall_s:.3f} s")
            if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
                fail(f"{n}q training loss did not fall")
            _valid_cut(prob, res.final_state, f"frontier: {n}q")
            continue

        # 20q: 8 seeds x 3 epochs (K5 batched), each seed alone (K5 single)
        init = torch.tensor(1e-3 * np.random.default_rng(8).standard_normal(
            (8,) + prob.envelope.coeff_shape), dtype=torch.float32,
            device=DEVICE)
        cfg = TrainConfig(n_epoch=3, lr=2e-2)
        zero_counts()
        res = train_energy_seeds(*args, prob.psi0, prob.T, cfg, n_seeds=8,
                                 init_coeffs=init)
        counts = read_counts()
        expect_counts("train_energy_seeds adjoint, 20q, 8 seeds, 3 epochs",
                      counts, {"k5_forward": 3, "k5_backward": 3,
                               "k5_batched_forward": 3,
                               "k5_batched_backward": 3})
        _add(total, counts)
        zero_counts()
        alone = [train_energy(*args, prob.psi0, prob.T, cfg,
                              init_coeff=init[b]).losses_raw
                 for b in range(8)]
        counts = read_counts()
        expect_counts("train_energy adjoint, 20q, each of the 8 seeds alone",
                      counts, {"k5_forward": 32, "k5_backward": 24})
        _add(total, counts)
        diff = float(np.abs(res.losses - np.asarray(alone).T).max())
        log(f"frontier: 20q 8 seeds x 3 epochs, mean loss "
            f"{float(res.losses[0].mean())!r} -> "
            f"{float(res.losses[-1].mean())!r}; vs each seed alone on single "
            f"K5: max abs diff {diff!r} (atol {SEED_ALONE_ATOL})")
        if not (res.losses.shape == (3, 8) and np.all(np.isfinite(res.losses))
                and np.all(res.losses[-1] < res.losses[0])
                and diff <= SEED_ALONE_ATOL):
            fail("20q seed population: losses not finite, not falling or "
                 "off the seeds run alone")
    torch.cuda.empty_cache()


def packed_bound(n, n_steps, kinds, n_diag, n_planes, backward, members=1,
                 n_x=None):
    """(bound_ms, bound_by) of one packed chain (K3, K5 or K6) over
    ``members`` states: each input read once and each output written once
    (the state, its cotangent, the rows, h0th and the sign planes), and
    the fp32 operations the function needs per amplitude and stage: the
    angle from its rows (2 per diagonal term, 2 for the drift and
    offset), sin and cos (one each), the phase (6; backward 12 for y and
    lambda, 4 for g = dL/d angle and S0, 2 per term for S_k), and per op
    pair the rotation (12; backward 32, as ``chain_bound``). ``kinds`` are
    the kinds of one step's op rows (K6 applies most ops twice, at half
    angle) and ``n_x`` the angle slots a step reads (default: one per
    row)."""
    d, T = 2**n, n_steps
    pairs = _rot_pairs(kinds, d)
    n_x = len(kinds) if n_x is None else n_x
    rows = members * ((T + 1) * (n_diag + 2) + T * n_x)
    nbytes = 4 * d * (1 + n_planes) + 4 * rows
    angle = 2 * n_diag + 2 + 2
    if not backward:
        nbytes += 16 * d * members
        ops = members * ((T + 1) * d * (angle + 6) + T * 12 * pairs)
    else:
        nbytes += 24 * d * members + 4 * rows
        ops = members * ((T + 1) * d * (angle + 16 + 2 * n_diag)
                         + T * 32 * pairs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_frontier_times():
    """K3 at 18q and K5 at 20q and 24q (and batched at 20q, B=8), T=30,
    beside their plain versions and bounds; the host's time to enqueue
    one chain; the frontier grad steps, the 20q 8-seed epoch, and the eager
    engine where its tape fits. Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)} at the JSON line's shapes (K3 18q, K5 24q)."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig

    out = {}
    for kernel, n, b, iters, plain_iters in (("k3", 18, None, 50, 2),
                                             ("k5", 20, None, 20, 2),
                                             ("k5", 20, 8, 10, 1),
                                             ("k5", 24, None, 5, 1)):
        prob = frontier_problem(n)
        _, ud, tx, h0th, signs, qubits, kinds = packed_inputs(prob, 30, n, b)
        if b is None:
            ud, tx = ud[:, None].contiguous(), tx[:, None].contiguous()
        members = b or 1
        psi = CP(prob.psi0.re.expand(members, -1).contiguous(),
                 prob.psi0.im.expand(members, -1).contiguous())
        plan = tfp._packed_plan(qubits, kinds, n)
        udm = tfp.merge_ud_rows(ud)
        what = kernel.upper()
        fwd = lambda: tfp._packed_forward_cuda(  # noqa: E731
            psi.re, psi.im, udm, tx, h0th, signs, plan, n, what)
        o_re, o_im = fwd()
        w = prob.measurement.diag
        lam = CP(2.0 * w * o_re, 2.0 * w * o_im)
        bwd = lambda: tfp._packed_backward_cuda(  # noqa: E731
            o_re, o_im, lam.re, lam.im, udm, tx, h0th, signs, plan, n, what)
        args = (ud, tx, h0th, signs, qubits, n, kinds)
        runs = {
            "forward": (fwd, lambda: tfp.fused_product_evolve_packed_plain(
                psi, *args)),
            "backward": (bwd, lambda: tfp._adjoint_packed_plain(
                CP(o_re, o_im), lam, *args))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fwd()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        shape = (f"{n}q, T=30, {len(kinds)} ops, {ud.shape[2] - 1} diagonal "
                 f"terms, B={members}")
        log(f"time: {kernel}_forward host enqueue {host_ms!r} ms per chain "
            f"(one ctypes call, ~2T+1 pass launches; {shape})")
        for part, (kfn, pfn) in runs.items():
            ms = cuda_ms(kfn, iters, warmup=2)
            plain_ms = cuda_ms(pfn, plain_iters, warmup=1)
            bound = packed_bound(n, 30, kinds, ud.shape[2] - 1, signs.shape[0],
                                 part == "backward", members)
            log(f"time: {kernel}_{part} {ms!r} ms/chain, plain version "
                f"{plain_ms!r} ms, bound {bound[0]!r} ms ({bound[1]}) "
                f"({shape})")
            if (kernel, n, b) in (("k3", 18, None), ("k5", 24, None)):
                out[f"{kernel}_{part}"] = (ms, plain_ms) + bound
        del runs, fwd, bwd, o_re, o_im, lam
        torch.cuda.empty_cache()

    for n, iters, eager in ((18, 20, True), (20, 10, True), (24, 5, False)):
        prob = frontier_problem(n)
        c = torch.tensor(1e-3 * np.random.default_rng(0).standard_normal(
            prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)

        def step(backend="auto", p=prob, c=c):
            return energy_and_grad(p.ham, p.envelope, p.measurement, c,
                                   p.psi0, p.T, 30, backend=backend)
        ms = cuda_ms(step, iters, warmup=2)
        line = f"time: {n}q 30-step adjoint grad step {ms!r} ms"
        if eager:
            line += f", eager engine {cuda_ms(lambda: step('product'), 1, 1)!r} ms"
        log(line + f" (CUDA events over {iters} chained calls)")
        torch.cuda.empty_cache()

    prob = frontier_problem(20)
    args = (prob.ham, prob.envelope, prob.measurement, prob.psi0, prob.T)
    ms = cuda_ms(lambda: train_energy_seeds(
        *args, TrainConfig(n_epoch=5, lr=2e-2), n_seeds=8), 1, warmup=1) / 5
    log(f"time: 20q 8-seed adjoint epoch {ms!r} ms (CUDA events over 5 "
        f"epochs in one call)")
    return out


# --------------------------------------------------------------------------
# hop drive sets at 19-24 qubits: K6 (the palindromic A/B schedule)
# --------------------------------------------------------------------------

def molecule_pairs(n):
    """The molecule drive set's pairs: (i, i+1) and (i, i+2)."""
    return [(i, i + 1) for i in range(n - 1)] + \
        [(i, i + 2) for i in range(n - 2)]


def hop_ops(n, pairs, drives=None):
    """(entries, kinds) of a hop drive set's rotation ops in qubit space,
    in the router's order: the 1q drives ((qubit, 'x' | 'y') pairs;
    default X and Y on every qubit), then one hop per pair."""
    if drives is None:
        drives = [(q, k) for q in range(n) for k in ("x", "y")]
    return (tuple(q for q, _ in drives) + tuple(pairs),
            tuple(k for _, k in drives) + ("hop",) * len(pairs))


# tests/test_mega_hop.py's disjoint hops, with an X and a Y drive on two
# other qubits and a ZZ row on those two beside the hops' own: every
# rotation sits on its own qubits, so K6's schedule and the eager
# engine's product coincide, and no gradient vanishes by symmetry (a ZZ
# row on a hop's own pair commutes with everything here)
DISJOINT = dict(pairs=[(0, 1), (4, 9), (12, 17)], drives=[(2, "x"), (7, "y")],
                zz_pairs=[(0, 1), (4, 9), (12, 17), (2, 7)])


def hop_kernel_inputs(n, n_steps, seed, members=None, pairs=None,
                      drives=None, zz_pairs=None):
    """K6's inputs for a hop drive set (see :func:`hop_ops`; the molecule
    set's pairs unless ``pairs`` is given, a ZZ row per pair unless
    ``zz_pairs`` is given), built on the card: the ops relabelled by the
    planner, sign planes from the relabelled ZZ parity masks, random rows
    (ud 0.2, theta_x 0.3 times N(0, 1)) and, from a generator on the
    card, h0th (0.1 N(0, 1)) and a random state. Returns (psi0 [(B,) d],
    ud [T, (B,) S], theta_x [T, (B,) n_x], h0th, signs, position entries,
    kinds)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.ops.fused_product import signs_planes_device
    d = 2**n
    pairs = molecule_pairs(n) if pairs is None else pairs
    zz_pairs = pairs if zz_pairs is None else zz_pairs
    entries, kinds = hop_ops(n, pairs, drives)
    perm = tmh.plan_chunked_hop_layout(entries, kinds, n)
    pos_of = tmh.invert_perm(perm)
    pos = tuple((min(pos_of[e[0]], pos_of[e[1]]),
                 max(pos_of[e[0]], pos_of[e[1]]))
                if isinstance(e, tuple) else pos_of[e] for e in entries)
    signs = signs_planes_device(
        tuple(tmh.relabel_mask((1 << (n - 1 - i)) | (1 << (n - 1 - j)),
                               perm, n) for i, j in zz_pairs), d, DEVICE)
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    ud = torch.tensor(0.2 * rng.standard_normal(
        (n_steps,) + lead + (len(zz_pairs) + 1,)), **f32)
    tx = torch.tensor(0.3 * rng.standard_normal(
        (n_steps,) + lead + (len(pos),)), **f32)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h0th = 0.1 * torch.randn(d, generator=gen, **f32)
    psi0 = CP(*(torch.randn(lead + (d,), generator=gen, **f32)
                / np.sqrt(2 * d) for _ in range(2)))
    return psi0, ud, tx, h0th, signs, pos, kinds


def card_weights(d, seed):
    """An observable's diagonal w [d] ~ N(0, 1) drawn on the card."""
    import torch
    return torch.randn(d, generator=torch.Generator(
        device=DEVICE).manual_seed(seed), device=DEVICE)


def phase_hop_kernels():
    """K6 forward and backward through its entry points and autograd
    against the plain versions. Returns {"k6": (forward, backward) max abs
    errors} of its main-path case (the 20q molecule set, T=30)."""
    import torch
    from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
    from diffquantum_tpu_torch.ops.cpx import CP

    single = (tmh.chunked_evolve_mega_hop, tmh.chunked_evolve_mega_hop_plain)
    batched = (tmh.chunked_evolve_mega_hop_batched,
               tmh.chunked_evolve_mega_hop_batched_plain)
    # (label, functions, qubits, steps, members B or None, drive set
    # (hop_kernel_inputs' keywords; the molecule set if empty), main-path
    # case)
    cases = [("19q molecule set (c=2), T=30", single, 19, 30, None, {},
              False),
             ("20q molecule set (c=3), T=30", single, 20, 30, None, {}, True),
             ("19q disjoint hops, X and Y on two other qubits (B ops "
              "commute), T=30", single, 19, 30, None, DISJOINT, False),
             ("20q molecule set, T=1", single, 20, 1, None, {}, False),
             ("batched 20q molecule set, T=30, B=4 per-member rows",
              batched, 20, 30, 4, {}, False),
             ("24q molecule set (c=7), T=4", single, 24, 4, None, {}, False)]
    errs = {}
    for label, (entry, plain), n, n_steps, b, drive_set, main in cases:
        seed = n * 1000 + n_steps + (b or 0)
        psi0, ud, tx, h0th, signs, pos, kinds = hop_kernel_inputs(
            n, n_steps, seed, b, **drive_set)
        n_rows = len(tmh._hop_plan(pos, kinds, n))
        args = (h0th, signs, pos, n, kinds)
        leaves = [t.clone().requires_grad_(True)
                  for t in (psi0.re, psi0.im, ud, tx)]
        before = read_counts()
        t0 = time.perf_counter()
        out = entry(CP(leaves[0], leaves[1]), leaves[2], leaves[3], *args)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = plain(psi0, ud, tx, *args)
        w = card_weights(ref.re.shape[-1], seed)
        lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)  # d<w>/dpsi
        got = torch.autograd.grad((out.re, out.im), leaves, (lam.re, lam.im))
        after = read_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {"k6_forward": 1, "k6_backward": 1}
        if b is not None:
            want.update(k6_batched_forward=1, k6_batched_backward=1)
        if ran != want:
            fail(f"K6 {label}: the entry point launched {ran}, expected "
                 f"{want}")
        gp, gud, gtx = tmh._adjoint_mega_hop_plain(ref, lam, ud, tx, *args)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(
            f"K6 {label}", "K6", TOL_HOP, (out.re.detach(), out.im.detach()),
            ref, got, (gp.re, gp.im, gud, gtx),
            "dpsi_re, dpsi_im, dud, dtheta_x")
        log(f"kernel check K6 [{label}]: {len(pos)} angle slots, {n_rows} "
            f"rows per step, {signs.shape[0]} sign plane(s), plan "
            f"[{pk_geometry(n, ud.shape[-1] - 1, b or 1)}], forward max "
            f"abs err {fwd_err!r} (atol {TOL_HOP['fwd']}); backward "
            f"relative errors {rels!r} (bound {TOL_HOP['grad']}); first "
            f"launch + sync {t_k * 1e3:.3f} ms")
        if main:
            errs["k6"] = (fwd_err, bwd_abs)
        del out, ref, got, leaves, gp, gud, gtx, lam, psi0, h0th, signs, w
        torch.cuda.empty_cache()
    return errs


_HOP_PROBLEMS = {}


def hop_problem(n, pairs=None, drives=None, zz_pairs=None,
                coeff_scale=1e-3, seed=0, random_state=False):
    """A hop drive set as bench.py builds ``molecule20q_hop_grad_step``:
    1q drives (``drives``, (qubit, 'x' | 'y') pairs; default X and Y on
    every qubit), a hop on each pair (the molecule set's unless ``pairs``
    is given) and a ZZ row on each of ``zz_pairs`` (default: the same
    pairs), omega = pi for every control, bspline envelopes with 4 basis
    functions, T = 2, zero H0, psi0 uniform (or, with ``random_state``, a
    random state), the observable w ~ N(0, 1) and coefficients
    coeff_scale x N(0, 1), all from ``seed``. Built once per run; logs
    the host's build time."""
    import resource
    import types

    import torch
    from diffquantum_tpu_torch.dynamics import hamiltonian as tham
    from diffquantum_tpu_torch.dynamics.product import (_packed_tables,
                                                        select_engine)
    from diffquantum_tpu_torch.measure import Measurement
    from diffquantum_tpu_torch.ops import linalg
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    key = (n, tuple(pairs or ()), tuple(drives or ()),
           tuple(zz_pairs or ()), coeff_scale, seed, random_state)
    if key in _HOP_PROBLEMS:
        return _HOP_PROBLEMS[key]
    d = 2**n
    pairs = molecule_pairs(n) if pairs is None else pairs
    zz_pairs = pairs if zz_pairs is None else zz_pairs
    if drives is None:
        drives = [(q, k) for q in range(n) for k in ("x", "y")]
    t0 = time.perf_counter()
    st = [tham.TermStructure(kind="1q", qubit=q,
                             local=linalg.X if k == "x" else linalg.Y)
          for q, k in drives]
    for i, j in pairs:
        st.append(tham.TermStructure(kind="hop", qubit=i, qubit2=j))
        if (i, j) in zz_pairs:
            st.append(tham.TermStructure(kind="diag",
                                         diag=linalg.zz_diagonal(n, i, j)))
    st += [tham.TermStructure(kind="diag", diag=linalg.zz_diagonal(n, i, j))
           for i, j in zz_pairs if (i, j) not in pairs]
    ham = tham.ControlledHamiltonian.create_structured(
        d, tuple(st), h0_structure=tham.TermStructure(kind="diag",
                                                      diag=np.zeros(d)))
    env = SimpleEnvelope(basis="bspline", n_basis=4,
                         omegas=(np.pi,) * len(st))
    rng = np.random.default_rng(seed)
    meas = Measurement.create_diagonal(rng.standard_normal(d), device=DEVICE)
    coeff = torch.tensor(coeff_scale * rng.standard_normal(env.coeff_shape),
                         dtype=torch.float32, device=DEVICE)
    amp = linalg.uniform_superposition(n)
    if random_state:
        amp = rng.standard_normal(d) + 1j * rng.standard_normal(d)
        amp /= np.linalg.norm(amp)
    psi0 = CP(torch.tensor(amp.real, dtype=torch.float32, device=DEVICE),
              torch.tensor(amp.imag, dtype=torch.float32, device=DEVICE))
    t1 = time.perf_counter()
    engine = select_engine(ham)
    signs = _packed_tables(ham, DEVICE)[0]
    t2 = time.perf_counter()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"host: {n}q hop drive set ({len(st)} controls, {len(pairs)} hops): "
        f"build {t1 - t0:.3f} s; select_engine, relabelling and sign planes "
        f"{tuple(signs.shape)} {t2 - t1:.3f} s -> {engine!r}; peak host RSS "
        f"so far {rss:.2f} GiB")
    prob = types.SimpleNamespace(ham=ham, envelope=env, measurement=meas,
                                 psi0=psi0, T=2.0, coeff=coeff, n_qubits=n)
    _HOP_PROBLEMS[key] = prob
    return prob


def phase_hop_paths(total):
    """The 20q molecule drive set through the entry points (K6 only; the
    seeds on K6 batched), and the 19q disjoint-hop set against the eager
    engine."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import (_hop_layout,
                                                        _mega_hop_dispatch,
                                                        packed_chain_inputs,
                                                        select_engine)
    from diffquantum_tpu_torch.dynamics.propagator import evolve
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.measure import diag_expectation
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    n_steps = 30
    prob = hop_problem(20)
    if select_engine(prob.ham) != "mega_hop":
        fail(f"20q molecule drive set routes to "
             f"{select_engine(prob.ham)!r}, expected 'mega_hop'")
    args = (prob.ham, prob.envelope, prob.measurement)
    zero_counts()
    val, grad = energy_and_grad(*args, prob.coeff, prob.psi0, prob.T,
                                n_steps)
    counts = read_counts()
    expect_counts("energy_and_grad, 20q molecule drive set", counts,
                  {"k6_forward": 1, "k6_backward": 1})
    _add(total, counts)
    with torch.no_grad():  # the plain K6 chain through the same dispatcher
        ud, tx, h0th, signs, pos, kinds = packed_chain_inputs(
            prob.ham, prob.envelope, prob.coeff, 0.0, prob.T, prob.T,
            n_steps)
        psi_p = _mega_hop_dispatch(prob.n_qubits, prob.psi0, ud, tx, h0th,
                                   signs, pos, kinds,
                                   _hop_layout(prob.ham)[0], False,
                                   plain=True)
        val_p = float(diag_expectation(prob.measurement.diag, psi_p))
    dv = abs(float(val) - val_p)

    def energy(c):
        with torch.no_grad():
            psi = evolve(prob.ham, prob.envelope, c, prob.psi0, 0.0, prob.T,
                         horizon=prob.T, n_steps=n_steps)
            return float(diag_expectation(prob.measurement.diag, psi))

    direction = torch.tensor(np.random.default_rng(23).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    eps = 1e-3
    zero_counts()
    fd = (energy(prob.coeff + eps * direction)
          - energy(prob.coeff - eps * direction)) / (2 * eps)
    counts = read_counts()
    expect_counts("central differences, 20q molecule drive set", counts,
                  {"k6_forward": 2})
    _add(total, counts)
    an = float((grad * direction).sum())
    log(f"hop: 20q molecule grad step value {float(val)!r} (plain K6 chain "
        f"{val_p!r}, diff {dv!r}, atol {HOP_PLAIN_ATOL}); directional "
        f"derivative {an!r}, central difference (eps {eps}) {fd!r}, diff "
        f"{abs(fd - an)!r} (bound {HOP_FD_REL} x max(1, |fd|)); "
        f"|grad| max {float(grad.abs().max())!r}")
    if not (torch.isfinite(grad).all() and dv <= HOP_PLAIN_ATOL
            and abs(fd - an) <= HOP_FD_REL * max(1.0, abs(fd))):
        fail("20q molecule grad step disagrees with the plain K6 chain or "
             "with central differences")

    # the disjoint set from a random state (from the uniform state the
    # hops only phase their {01, 10} parts, and the loss is flat)
    p19 = hop_problem(19, **DISJOINT, coeff_scale=0.4, seed=20,
                      random_state=True)
    if select_engine(p19.ham) != "mega_hop":
        fail(f"19q disjoint-hop set routes to {select_engine(p19.ham)!r}")
    zero_counts()
    v19, g19 = energy_and_grad(p19.ham, p19.envelope, p19.measurement,
                               p19.coeff, p19.psi0, p19.T, n_steps)
    counts = read_counts()
    expect_counts("energy_and_grad, 19q disjoint hops", counts,
                  {"k6_forward": 1, "k6_backward": 1})
    _add(total, counts)
    _eager_check("hop: 19q disjoint-hop grad step", p19, p19.coeff, n_steps,
                 v19, g19)

    epochs = 20
    zero_counts()
    res = train_energy(*args, prob.psi0, prob.T,
                       TrainConfig(n_epoch=epochs, lr=2e-2))
    counts = read_counts()
    expect_counts(f"train_energy adjoint, 20q molecule drive set, {epochs} "
                  f"epochs", counts, {"k6_forward": epochs + 1,
                                      "k6_backward": epochs})
    _add(total, counts)
    losses = res.losses_raw
    psi = res.final_state
    norm = float((psi.re.double() ** 2 + psi.im.double() ** 2).sum())
    log(f"hop: 20q train_energy {epochs} epochs, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, final state norm {norm!r}, wall {res.wall_s:.3f} s")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            and abs(norm - 1.0) < 1e-4):
        fail("20q molecule training: loss did not fall or the state is not "
             "normalized")

    b = 4
    init = torch.tensor(1e-3 * np.random.default_rng(8).standard_normal(
        (b,) + prob.envelope.coeff_shape), dtype=torch.float32,
        device=DEVICE)
    cfg = TrainConfig(n_epoch=3, lr=2e-2)
    zero_counts()
    res = train_energy_seeds(*args, prob.psi0, prob.T, cfg, n_seeds=b,
                             init_coeffs=init)
    counts = read_counts()
    expect_counts(f"train_energy_seeds adjoint, 20q molecule drive set, {b} "
                  f"seeds, 3 epochs", counts,
                  {"k6_forward": 3, "k6_backward": 3,
                   "k6_batched_forward": 3, "k6_batched_backward": 3})
    _add(total, counts)
    zero_counts()
    alone = [train_energy(*args, prob.psi0, prob.T, cfg,
                          init_coeff=init[i]).losses_raw for i in range(b)]
    counts = read_counts()
    expect_counts(f"train_energy adjoint, 20q molecule drive set, each of "
                  f"the {b} seeds alone", counts,
                  {"k6_forward": 4 * b, "k6_backward": 3 * b})
    _add(total, counts)
    diff = float(np.abs(res.losses - np.asarray(alone).T).max())
    log(f"hop: 20q {b} seeds x 3 epochs, mean loss "
        f"{float(res.losses[0].mean())!r} -> "
        f"{float(res.losses[-1].mean())!r}; vs each seed alone on single "
        f"K6: max abs diff {diff!r} (atol {SEED_ALONE_ATOL})")
    if not (res.losses.shape == (3, b) and np.all(np.isfinite(res.losses))
            and diff <= SEED_ALONE_ATOL):
        fail("20q molecule seeds: losses not finite or off the seeds run "
             "alone")
    torch.cuda.empty_cache()


def phase_hop_times():
    """K6 on the molecule drive set at 20q (single and batched, B=4) and
    24q, T=30, beside the plain versions (at the checked shapes: 24q at
    T=4) and the bounds; the host's time to enqueue one chain; the 20q
    molecule grad step. Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)} at the main path's shape (20q, T=30, B=1)."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    out = {}
    for n, b, iters, plain_steps in ((20, None, 10, 30), (20, 4, 3, 30),
                                     (24, None, 2, 4)):
        psi0, ud, tx, h0th, signs, pos, kinds = hop_kernel_inputs(
            n, 30, n, b)
        if b is None:
            ud, tx = ud[:, None].contiguous(), tx[:, None].contiguous()
            psi0 = CP(psi0.re[None], psi0.im[None])
        members = b or 1
        plan = tmh._hop_plan(pos, kinds, n)
        udm = tfp.merge_ud_rows(ud)
        fwd = lambda: tfp._packed_forward_cuda(  # noqa: E731
            psi0.re, psi0.im, udm, tx, h0th, signs, plan, n, "K6")
        o_re, o_im = fwd()
        w = card_weights(o_re.shape[-1], n)
        lam = CP(2.0 * w * o_re, 2.0 * w * o_im)
        bwd = lambda: tfp._packed_backward_cuda(  # noqa: E731
            o_re, o_im, lam.re, lam.im, udm, tx, h0th, signs, plan, n, "K6")
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # one chain: more would fill the queue
        fwd()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        n_pass = len(tfp._pass_layout(tuple(map(tuple, plan.tolist())), n,
                                      2, ud.shape[2] - 1, len(pos))[2])
        shape = (f"{n}q molecule set, T=30, {len(pos)} angle slots, "
                 f"{len(plan)} rows and {n_pass} forward passes per step, "
                 f"{ud.shape[2] - 1} diagonal terms, B={members}")
        log(f"time: k6_forward host enqueue {host_ms!r} ms per chain (one "
            f"ctypes call; {shape})")
        pu, pt = ud[:plain_steps].contiguous(), tx[:plain_steps].contiguous()
        pargs = (h0th, signs, plan, len(pos), n)
        p_out = tfp.packed_chain_plain(psi0, pu, pt, *pargs)
        p_lam = CP(2.0 * w * p_out.re, 2.0 * w * p_out.im)
        plain = {"forward": lambda: tfp.packed_chain_plain(psi0, pu, pt,
                                                           *pargs),
                 "backward": lambda: tfp.packed_adjoint_plain(
                     p_out, p_lam, pu, pt, *pargs)}
        row_kinds = [kinds[int(r[0])] for r in plan]
        for part, kfn in (("forward", fwd), ("backward", bwd)):
            ms = cuda_ms(kfn, iters, warmup=1)
            plain_ms = cuda_ms(plain[part], 1, warmup=0)
            bound = packed_bound(n, 30, row_kinds, ud.shape[2] - 1,
                                 signs.shape[0], part == "backward", members,
                                 n_x=len(pos))
            log(f"time: k6_{part} {ms!r} ms/chain, plain version "
                f"{plain_ms!r} ms at T={plain_steps}, bound {bound[0]!r} ms "
                f"({bound[1]}) ({shape})")
            if (n, b) == (20, None):
                out[f"k6_{part}"] = (ms, plain_ms) + bound
        del fwd, bwd, o_re, o_im, lam, plain, p_out, p_lam, psi0, h0th, signs
        torch.cuda.empty_cache()

    prob = hop_problem(20)

    def step():
        return energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                               prob.coeff, prob.psi0, prob.T, 30)
    ms = cuda_ms(step, 5, warmup=1)
    log(f"time: 20q molecule drive set 30-step adjoint grad step {ms!r} ms "
        f"(CUDA events over 5 chained calls; the eager engine is not timed: "
        f"its autograd tape would hold 30 steps x 154 rotations of 2^20 "
        f"amplitudes)")
    return out


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
        backward = name.endswith("backward")
        bound = chain_bound(d, 30, kinds, backward, members=members,
                            rows=members)
        floor = one_sm_floor(d, 30, kinds, backward)
        out[name] = (ms, plain_ms) + bound
        log(f"time: {name} {ms!r} ms/launch, plain version {plain_ms!r} ms, "
            f"bound {bound[0]!r} ms ({bound[1]}), one-SM floor {floor!r} ms "
            f"a member's chain (12q, T=30, {len(kinds)} ops, B={members}; "
            f"{fp_plan_text(n, plan, members, members, backward)})")
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
        f"group rows; {fp_plan_text(n, plan, 48 * b, b, False)})")

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
        kinds_q = ("x",) * nq
        bound = sum(chain_bound(2**nq, n_steps, kinds_q, bw)[0]
                    for bw in (False, True))
        floor = sum(one_sm_floor(2**nq, n_steps, kinds_q, bw)
                    for bw in (False, True))
        log(f"time: {nq}q {n_steps}-step adjoint grad step {ms!r} ms "
            f"(CUDA events over {iters} chained calls; host wall "
            f"{host!r} ms/call incl. warm-up); K1 forward + backward bound "
            f"{bound!r} ms, one-SM floor {floor!r} ms")
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


# --------------------------------------------------------------------------
# the dense slice: K7 (csrc/taylor_apply.cu) and its paths
# --------------------------------------------------------------------------

# K7 against its plain version on the card: forward atol on states of unit
# norm, gradients (gH, gpsi) relative to their max-norm. An H100 run read
# 8.9e-8 forward at worst (CNOT columns, d = 4) and 2.6e-6 on dH_im (10q
# MC branches, d = 1024, B = 40), so the limits sit ~4.5x and ~3.8x above;
# the two-configuration kernels read 1.1e-7 (d = 64, B = 5) and 2.7e-6
# (d = 1024, B = 64) at the nine shapes, ~3.7x below both.
TOL_K7 = {"fwd": 4e-7, "grad": 1e-5}
# The dense paths through K7 ('apply') against the dense 'expm' backend
# (torch.matmul, no kernel) on the card, f32 both: value atol, gradient
# relative to its max-norm. The two integrate the same piecewise-constant
# steps; f32 'expm' carries the larger error (its squarings amplify
# rounding). An H100 run read 8.9e-5 on the 10q step's value and 2.3e-5
# at most on a gradient (the MC one), so the limits sit ~4.5x and ~4.4x
# above. Against the same step in float64 ('expm', exact operators) the
# K7 path read 7.6e-6 on the value and 2.2e-6 on the gradient (f32 'expm'
# 9.6e-5 and 2.1e-5): limits ~3.9x and ~4.5x above.
DENSE_VALUE_ATOL = 4e-4
DENSE_GRAD_REL = 1e-4
DENSE_F64_VALUE_ATOL = 3e-5
DENSE_F64_GRAD_REL = 1e-5
CNOT = np.eye(4)[[0, 1, 3, 2]]  # control = qubit 0


def taylor_bound(d, b, order, substeps, backward):
    """(bound_ms, bound_by) of one K7 call on [B, d] states: bytes of H
    read once, psi (and, backward, the cotangent) read once, the outputs
    (out; gH and gpsi) written once; operations: a term is a complex
    product, 8 B d^2, plus its scale and sum, 8 B d. The backward
    recomputes the forward's terms but the last (n - 1 products, n =
    order x substeps), carries the cotangent back through H^dagger (n
    products) and adds each term's rank-B update to gH (n times
    8 B d^2)."""
    n = order * substeps
    per = 8 * b * d * d + 8 * b * d
    if backward:
        nbytes, ops = 4 * (4 * d * d + 6 * b * d), (3 * n - 1) * per
    else:
        nbytes, ops = 4 * (2 * d * d + 4 * b * d), n * per
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_DENSE = {}


def dense_problems():
    """The dense problems of this slice on the card, built once: the
    10-qubit ring MaxCut (dense=True, n_basis 6), the reference demo
    (4-qubit ring, dense by default), the control problems and H2."""
    if not _DENSE:
        from diffquantum_tpu_torch.models import control, maxcut, vqe_h2
        t0 = time.perf_counter()
        ring = maxcut.build_maxcut(10, maxcut.ring_graph(10), n_basis=6,
                                   dense=True, device=DEVICE)
        log(f"host: 10q dense ring MaxCut (20 controls of 1024 x 1024, "
            f"11 measurement terms): build_maxcut "
            f"{time.perf_counter() - t0:.3f} s (the norms' and the term "
            f"table's eigendecompositions)")
        _DENSE.update(
            ring=ring, demo=maxcut.demo_problem(device=DEVICE),
            two=control.two_qubit_controls(device=DEVICE),
            transfer=control.state_transfer(1, device=DEVICE),
            bell=control.bell_state_preparation(device=DEVICE),
            hadamard=control.hadamard_synthesis(device=DEVICE),
            h2=vqe_h2.build_h2(device=DEVICE))
    return _DENSE


def _a_bound(ham, envelope, T, n_steps):
    from diffquantum_tpu_torch.dynamics.propagator import _amplitude_bound
    return T / n_steps * ham.norm_bound(_amplitude_bound(envelope))


def k7_inputs(ham, envelope, T, n_steps, b, seed):
    """One step's K7 inputs at a path's shape: H(t) at amplitudes drawn
    within the envelope's bounds, B random unit states, a random unit
    cotangent, and the path's z = -i T/n_steps with its order and
    substeps."""
    import torch
    from diffquantum_tpu_torch.ops import taylor_apply as ta
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.ops.expm import taylor_params
    rng = np.random.default_rng(seed)
    omg = np.asarray(envelope.omegas)
    u = torch.tensor(omg * rng.uniform(-1, 1, omg.shape), dtype=torch.float32,
                     device=DEVICE)
    h = ham.at(u)
    d = h.shape[-1]
    order, s = taylor_params(_a_bound(ham, envelope, T, n_steps))
    psi = _random_cp(rng, (b, d), 1.0 / np.sqrt(2 * d))
    g = _random_cp(rng, (b, d), 1.0 / np.sqrt(2 * d))
    zs = ta.substep_z(0.0, -T / n_steps, 2**s, psi.re)
    return CP(h.re.contiguous(), h.im.contiguous()), psi, g, zs, order, 2**s


def _hermitian_inputs(d, b, seed):
    """A random Hermitian H [d, d], B random states and cotangents, z =
    -0.31 i: tests/test_pallas.py's unaligned case at d = 48, B = 5,
    seed 0."""
    import torch
    from diffquantum_tpu_torch.ops import taylor_apply as ta
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.ops.expm import taylor_params
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    h = (a + a.conj().T) / 2
    order, s = taylor_params(0.31 * np.linalg.norm(h, 2))
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=DEVICE)  # noqa
    psi = _random_cp(rng, (b, d), 0.1)
    g = _random_cp(rng, (b, d), 0.1)
    zs = ta.substep_z(0.0, -0.31, 2**s, psi.re)
    return CP(f(h.real), f(h.imag)), psi, g, zs, order, 2**s


def open_dense_problems():
    """The dense MCWF problems of phase_open, built once: (ham, envelope,
    float32 CollapseSet, float64 CollapseSet, T, n_steps) of the damped
    qubit (the JAX demo's act one: detuning 0.5, amplitude damping gamma
    0.15, T = 2, 30 steps) and of the 10q dense ring (T1 gamma 0.1 on
    every qubit, 30 steps)."""
    ring = dense_problems()["ring"]  # before _DENSE gains other keys
    if "qubit" not in _DENSE:
        from diffquantum_tpu_torch.dynamics.lindblad import (
            CollapseSet, amplitude_damping)
        from diffquantum_tpu_torch.models import control
        from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope

        def collapse(ops):
            import torch
            c64 = CollapseSet.create(ops, dtype=torch.float64, device=DEVICE)
            f32 = lambda x: x.astype(torch.float32)  # noqa: E731
            return CollapseSet(f32(c64.ops), f32(c64.k_op), c64.norms), c64

        ham, omegas = control.single_qubit_controls(detuning=0.5,
                                                    device=DEVICE)
        env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
        _DENSE["qubit"] = (ham, env) + collapse(
            [amplitude_damping(0.15, 0, 1)]) + (2.0, 30)
        n, t0 = ring.n_qubits, time.perf_counter()
        _DENSE["ring_t1"] = (ring.ham, ring.envelope) + collapse(
            [amplitude_damping(0.1, q, n) for q in range(n)]) + (ring.T, 30)
        log(f"host: {n} T1 collapse operators of {2**n} x {2**n} (K and "
            f"the norms) in {time.perf_counter() - t0:.3f} s")
    return _DENSE


def meff_inputs(which, b, seed):
    """One step's K7 inputs of the dense MCWF's no-jump branch: M_eff =
    -i H(t) - K/2 (not Hermitian) at amplitudes drawn within the
    envelope's bounds, B random unit states and cotangents, z = dt and
    the order and substeps evolve_mcwf takes from its H_eff bound."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import _amplitude_bound
    from diffquantum_tpu_torch.ops import cpx
    from diffquantum_tpu_torch.ops import taylor_apply as ta
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.ops.expm import taylor_params
    ham, env, c, _, T, n_steps = open_dense_problems()[which]
    rng = np.random.default_rng(seed)
    omg = np.asarray(env.omegas)
    u = torch.tensor(omg * rng.uniform(-1, 1, omg.shape), dtype=torch.float32,
                     device=DEVICE)
    m_eff = cpx.add(cpx.mulmi(ham.at(u)), cpx.rscale(c.k_op, -0.5))
    d = m_eff.shape[-1]
    order, s = taylor_params(T / n_steps * (
        ham.norm_bound(_amplitude_bound(env)) + 0.5 * c.k_norm))
    psi = _random_cp(rng, (b, d), 1.0 / np.sqrt(2 * d))
    g = _random_cp(rng, (b, d), 1.0 / np.sqrt(2 * d))
    zs = ta.substep_z(T / n_steps, 0.0, 2**s, psi.re)
    return (CP(m_eff.re.contiguous(), m_eff.im.contiguous()), psi, g, zs,
            order, 2**s)


def dense_kernel_cases():
    """(label, inputs) of K7 at the shapes of this slice's paths, the
    boundary of its two launch configurations (d = 64 block-resident,
    d = 65 row-split), the 10q MC branches at B = 64, and the dense MCWF's
    non-Hermitian M_eff at its two shapes (phase_open (a) and (e))."""
    p = dense_problems()
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    had, two, demo, ring = p["hadamard"], p["two"], p["demo"], p["ring"]
    cnot_env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=two[1])
    return [
        ("Hadamard MC branches, d=2 B=4",
         k7_inputs(had.ham, had.envelope, had.T, 100, 4, 2)),
        ("CNOT columns, d=4 B=4",
         k7_inputs(two[0], cnot_env, 4.0, 50, 4, 4)),
        ("4q demo MC branches, d=16 B=16",
         k7_inputs(demo.ham, demo.envelope, demo.T, 100, 16, 16)),
        ("unaligned, d=48 B=5", _hermitian_inputs(48, 5, 0)),
        ("boundary, d=64 B=5", _hermitian_inputs(64, 5, 64)),
        ("boundary, d=65 B=5", _hermitian_inputs(65, 5, 65)),
        ("10q dense MaxCut state, d=1024 B=1",
         k7_inputs(ring.ham, ring.envelope, ring.T, 30, 1, 10)),
        ("10q MC branches, d=1024 B=40",
         k7_inputs(ring.ham, ring.envelope, ring.T, 30, 40, 40)),
        ("10q branches, d=1024 B=64",
         k7_inputs(ring.ham, ring.envelope, ring.T, 30, 64, 64)),
        ("open (a): M_eff of the damped qubit, 2000 trajectories, d=2 "
         "B=2000", meff_inputs("qubit", 2000, 2)),
        ("open (e): M_eff of the 10q ring with T1 on every qubit, 64 "
         "trajectories, d=1024 B=64", meff_inputs("ring_t1", 64, 1064)),
    ]


def phase_dense_kernels():
    """K7 forward and backward against the plain versions on the card, at
    the eleven shapes of dense_kernel_cases. Returns {'k7': (forward,
    backward) max abs errors} at the 10q state's shape."""
    import torch
    from diffquantum_tpu_torch.ops import taylor_apply as ta

    errs, t_phase = {}, time.perf_counter()
    for label, (h, psi, g, zs, order, sub) in dense_kernel_cases():
        t0 = time.perf_counter()
        out = ta._forward_cuda(h.re, h.im, psi.re, psi.im, zs, order, sub)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = ta.taylor_apply_plain(h, psi, zs, order, sub)
        got = ta._backward_cuda(h.re, h.im, psi.re, psi.im, g.re, g.im, zs,
                                order, sub)
        gh, gp = ta.taylor_apply_backward_plain(h, psi, g, zs, order, sub)
        torch.cuda.synchronize()
        fwd, bwd, rels = _check_case(label, "K7", TOL_K7, out, ref, got,
                                     (gh.re, gh.im, gp.re, gp.im),
                                     "dH_re, dH_im, dpsi_re, dpsi_im")
        log(f"kernel check K7 [{label}]: order {order}, {sub} substeps, "
            f"forward max abs err {fwd!r} (atol {TOL_K7['fwd']}); backward "
            f"relative errors {rels!r} (bound {TOL_K7['grad']}); first "
            f"launch + sync {t_k * 1e3:.3f} ms")
        if label.startswith("10q dense MaxCut state"):
            errs["k7"] = (fwd, bwd)
    log(f"kernel check K7: {time.perf_counter() - t_phase:.1f} s with the "
        f"dense problems' build")
    return errs


def _counted(total, label, want, fn):
    """fn() with the launch counters set to 0 before and checked after."""
    zero_counts()
    out = fn()
    counts = read_counts()
    expect_counts(label, counts, want)
    _add(total, counts)
    return out


def phase_dense_paths(total):
    """The dense slice through the entry points: the 10q dense ring
    MaxCut (K7 at d = 1024), the reference demo with MC gradients (K7 on
    the branches), CNOT gate synthesis (K7 at d = 4), state transfer,
    Bell and Hadamard-MC control, and VQE H2."""
    for path in (dense_ring_path, dense_demo_path, dense_control_paths):
        t0 = time.perf_counter()
        path(total)
        log(f"dense: {path.__name__} took {time.perf_counter() - t0:.1f} s")


def dense_ring_path(total):
    """The 10q dense ring MaxCut: the grad step and an MC gradient on K7
    against 'expm', and 5 epochs of training."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import (dense_backend,
                                                           reference_n_steps)
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.mc import mc_energy_grad
    from diffquantum_tpu_torch.train import TrainConfig, train_energy

    ring = dense_problems()["ring"]
    n_steps = reference_n_steps(10, 0.0, ring.T)
    if dense_backend(ring.ham, batched=False) != "apply" or n_steps != 30:
        fail("the 10q dense ring MaxCut does not route to 'apply' at 30 "
             "steps")
    coeff = coeff_12q(ring, seed=10)
    args = (ring.ham, ring.envelope, ring.measurement)
    val, grad = _counted(
        total, "energy_and_grad, 10q dense",
        {"k7_forward": n_steps, "k7_backward": n_steps},
        lambda: energy_and_grad(*args, coeff, ring.psi0, ring.T, n_steps))
    val_e, grad_e = energy_and_grad(*args, coeff, ring.psi0, ring.T, n_steps,
                                    backend="expm")
    dv, dg = abs(float(val) - float(val_e)), rel_err(grad, grad_e)
    log(f"dense: 10q grad step value {float(val)!r} ('expm' "
        f"{float(val_e)!r}, diff {dv!r}); gradient relative diff {dg!r}")
    if not (torch.isfinite(grad).all() and dv <= DENSE_VALUE_ATOL
            and dg <= DENSE_GRAD_REL):
        fail(f"10q dense grad step on K7 disagrees with 'expm' (value atol "
             f"{DENSE_VALUE_ATOL}, gradient {DENSE_GRAD_REL} of max-norm)")
    # the same step in float64 ('expm'; the operators' entries are exact
    # in float32, so the cast changes nothing but the arithmetic)
    f64 = torch.float64
    ham64 = dataclasses.replace(
        ring.ham, dtype=f64, H0=ring.ham.H0.astype(f64),
        Hs=ring.ham.Hs.astype(f64))
    m64 = dataclasses.replace(ring.measurement,
                              matrix=ring.measurement.matrix.astype(f64))
    val_d, grad_d = energy_and_grad(ham64, ring.envelope, m64, coeff.to(f64),
                                    ring.psi0.astype(f64), ring.T, n_steps,
                                    backend="expm")
    errs = [(abs(float(v) - float(val_d)), rel_err(g.to(f64), grad_d))
            for v, g in ((val, grad), (val_e, grad_e))]
    log(f"dense: against float64 'expm' ({float(val_d)!r}): K7 path value "
        f"error {errs[0][0]!r}, gradient {errs[0][1]!r}; float32 'expm' "
        f"{errs[1][0]!r}, {errs[1][1]!r}")
    if not (errs[0][0] <= DENSE_F64_VALUE_ATOL
            and errs[0][1] <= DENSE_F64_GRAD_REL):
        fail(f"10q dense grad step on K7 is off the float64 step (value atol "
             f"{DENSE_F64_VALUE_ATOL}, gradient {DENSE_F64_GRAD_REL})")
    s = torch.tensor(0.7, dtype=torch.float64, device=DEVICE)
    g_k7 = _counted(total, "mc_energy_grad, 10q dense, s = 0.7",
                    {"k7_forward": 2 * n_steps},
                    lambda: mc_energy_grad(*args, coeff, ring.psi0, ring.T,
                                           None, n_steps, s=s))
    g_ex = mc_energy_grad(*args, coeff, ring.psi0, ring.T, None, n_steps, s=s,
                          backend="expm")
    dg = rel_err(g_k7, g_ex)
    log(f"dense: 10q MC gradient at s = 0.7 (K7 on the state and the 40 "
        f"branches) against 'expm': relative diff {dg!r}")
    if not (torch.isfinite(g_k7).all() and dg <= DENSE_GRAD_REL):
        fail(f"10q dense MC gradient on K7 disagrees with 'expm' ("
             f"{DENSE_GRAD_REL} of max-norm)")
    cfg = TrainConfig(n_basis=6, n_epoch=5, lr=2e-2)
    res = _counted(total, "train_energy adjoint, 10q dense, 5 epochs",
                   {"k7_forward": 6 * n_steps, "k7_backward": 5 * n_steps},
                   lambda: train_energy(*args, ring.psi0, ring.T, cfg,
                                        init_coeff=coeff))
    losses = res.losses_raw
    log(f"dense: 10q train_energy 5 epochs, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, wall {res.wall_s:.3f} s")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("10q dense train_energy loss did not fall over 5 epochs")
    _valid_cut(ring, res.final_state, "dense: 10q")


def dense_demo_path(total):
    """The reference demo (4q ring, dense by default) with MC gradients
    and its defaults reaches the max cut."""
    from diffquantum_tpu_torch.train import TrainConfig, train_energy

    demo = dense_problems()["demo"]
    cfg = TrainConfig(n_basis=6, n_epoch=202, lr=2e-2, grad_mode="mc")
    res = _counted(total, "train_energy MC, 4q demo, 202 epochs",
                   {"k7_forward": cfg.n_epoch * cfg.n_step},
                   lambda: train_energy(demo.ham, demo.envelope,
                                        demo.measurement, demo.psi0, demo.T,
                                        cfg))
    state, cut = _valid_cut(demo, res.final_state, "dense: 4q demo MC")
    log(f"dense: 4q demo MC 202 epochs, loss {res.losses_raw[0]!r} -> "
        f"{res.losses_raw[-1]!r}, gap {res.losses_energy[-1]!r}, wall "
        f"{res.wall_s:.3f} s")
    if cut != demo.max_cut or state not in (0b0101, 0b1010):
        fail(f"the 4q demo with MC gradients read out {state:04b} (cut "
             f"{cut}), not the max cut 0101/1010")


def dense_control_paths(total):
    """CNOT gate synthesis, state transfer, Bell, Hadamard with MC, VQE
    H2."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.ops import cpx
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    from diffquantum_tpu_torch.train import (TrainConfig, gate_infidelity,
                                             train_energy, train_fidelity,
                                             train_gate)

    p = dense_problems()
    # CNOT gate synthesis (demos/demo_control.py::run_gate)
    ham, omegas = p["two"]
    env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    cfg = TrainConfig(n_basis=6, n_epoch=200, lr=0.1)
    g_steps = reference_n_steps(cfg.per_step, 0.0, 4.0)
    res = _counted(total, "train_gate CNOT, 200 epochs",
                   {"k7_forward": (cfg.n_epoch + 1) * g_steps,
                    "k7_backward": cfg.n_epoch * g_steps},
                   lambda: train_gate(ham, env, CNOT, 4.0, cfg))
    U = cpx.to_complex(res.final_state).T
    tr = np.trace(CNOT.conj().T @ U)
    dev = float(np.abs(U - tr / abs(tr) * CNOT).max())
    log(f"dense: CNOT train_gate 200 epochs, coherent infidelity "
        f"{res.losses_raw[0]!r} -> {res.losses_raw[-1]!r}, max |U - e^(i "
        f"phi) G| {dev!r}, wall {res.wall_s:.3f} s")
    if not (np.all(np.isfinite(res.losses_raw))
            and res.losses_raw[-1] < res.losses_raw[0]):
        fail("CNOT train_gate loss did not fall")
    gate_dag = cpx.from_complex(CNOT.conj().T, device=DEVICE)
    cols = cpx.eye(4, device=DEVICE)
    vals = []  # at a random start, away from the optimum's cancellation
    start = torch.tensor(np.random.default_rng(4).standard_normal(
        env.coeff_shape), dtype=torch.float32, device=DEVICE)
    for backend in ("apply", "expm"):
        c = start.clone().requires_grad_(True)
        v = gate_infidelity(ham, env, c, gate_dag, cols, 4.0, g_steps,
                            backend=backend)
        vals.append((float(v.detach()), torch.autograd.grad(v, c)[0]))
    dv, dg = abs(vals[0][0] - vals[1][0]), rel_err(vals[0][1], vals[1][1])
    log(f"dense: gate_infidelity 'apply' (K7) {vals[0][0]!r} against "
        f"'expm' {vals[1][0]!r}: diff {dv!r}, gradient relative diff {dg!r}")
    if not (dv <= DENSE_VALUE_ATOL and dg <= DENSE_GRAD_REL):
        fail("gate_infidelity on K7 disagrees with 'expm'")

    # state transfer and Bell (adjoint); Hadamard with MC
    for name, epochs, mode in (("transfer", 100, "adjoint"),
                               ("bell", 100, "adjoint"),
                               ("hadamard", 100, "mc")):
        prob = p[name]
        cfg = TrainConfig(n_basis=6, n_epoch=epochs, lr=0.1, grad_mode=mode)
        n_pairs = prob.initial_states.shape[0]
        steps = reference_n_steps(cfg.per_step, 0.0, prob.T)
        # the final states evolve as one batch of pairs ('apply'); MC adds
        # the branches of every pair and epoch (the single states of the
        # losses and the adjoint run 'expm')
        branches = epochs * n_pairs * cfg.n_step if mode == "mc" else 0
        want = {"k7_forward": steps + branches}
        res = _counted(total,
                       f"train_fidelity {mode}, {name}, {epochs} epochs",
                       want, lambda: train_fidelity(
                           prob.ham, prob.envelope, prob.initial_states,
                           prob.target_states, prob.T, cfg))
        fids = np.abs(np.sum(np.conj(cpx.to_complex(prob.target_states))
                             * cpx.to_complex(res.final_state), axis=-1)) ** 2
        log(f"dense: {name} train_fidelity ({mode}) {epochs} epochs, loss "
            f"{res.losses_raw[0]!r} -> {res.losses_raw[-1]!r}, final "
            f"fidelities {fids.tolist()!r}")
        if not (np.all(np.isfinite(res.losses_raw))
                and res.losses_raw[-1] < res.losses_raw[0]):
            fail(f"{name} train_fidelity loss did not fall")

    # VQE H2, adjoint
    h2 = p["h2"]
    cfg = TrainConfig(n_basis=6, n_epoch=250, lr=0.1)
    res = _counted(total, "train_energy adjoint, H2, 250 epochs", {},
                   lambda: train_energy(h2.ham, h2.envelope, h2.measurement,
                                        h2.psi0, h2.T, cfg))
    err = (res.losses_raw[-1] - h2.exact_ground_energy) * 1e3
    log(f"dense: H2 VQE 250 epochs, energy {res.losses_raw[0]!r} -> "
        f"{res.losses_raw[-1]!r} Ha, exact {h2.exact_ground_energy!r}, "
        f"error {err!r} mHa")
    if not (np.isfinite(err) and res.losses_raw[-1] < res.losses_raw[0]):
        fail("H2 VQE energy did not fall")


def k7_case_times(cases, iters=20):
    """K7 forward and backward at each (label, inputs) of ``cases``, beside
    the plain versions, the bound and the library route (matrix_exp of
    z H to rounding, then one product; for the backward that route's VJP
    in dH and dpsi by autograd). Returns {label: {"forward": (ms,
    plain_ms, bound_ms, bound_by, library_ms), "backward": (...)}}."""
    import torch
    from diffquantum_tpu_torch.ops import taylor_apply as ta

    out = {}
    for label, (h, psi, g, zs, order, sub) in cases:
        b, d = psi.re.shape
        zc = complex(float(zs[0]), float(zs[1])) * sub
        hc = torch.complex(h.re, h.im).requires_grad_(True)
        pc = torch.complex(psi.re, psi.im).requires_grad_(True)
        gc = torch.complex(g.re, g.im)
        lib = {"forward": lambda: pc @ torch.linalg.matrix_exp(zc * hc).T,
               "backward": lambda: torch.autograd.grad(
                   pc @ torch.linalg.matrix_exp(zc * hc).T, (hc, pc), gc)}
        runs = {
            "forward": (lambda: ta._forward_cuda(h.re, h.im, psi.re, psi.im,
                                                 zs, order, sub),
                        lambda: ta.taylor_apply_plain(h, psi, zs, order,
                                                      sub)),
            "backward": (lambda: ta._backward_cuda(h.re, h.im, psi.re, psi.im,
                                                   g.re, g.im, zs, order,
                                                   sub),
                         lambda: ta.taylor_apply_backward_plain(
                             h, psi, g, zs, order, sub)),
        }
        out[label] = {}
        for part, (kfn, pfn) in runs.items():
            ms = cuda_ms(kfn, iters, 2)
            plain_ms = cuda_ms(pfn, 3, 1)
            lib_ms = cuda_ms(lib[part], 10, 2)
            bound = taylor_bound(d, b, order, sub, part == "backward")
            what = "matrix_exp + product" + (
                ", forward and VJP" if part == "backward" else "")
            log(f"time: k7_{part} [{label}] {ms!r} ms/launch, plain version "
                f"{plain_ms!r} ms, bound {bound[0]!r} ms ({bound[1]}), "
                f"{what} {lib_ms!r} ms (order {order}, {sub} substeps)")
            out[label][part] = (ms, plain_ms) + bound + (lib_ms,)
    return out


def dense_path_times():
    """The 10q dense grad step (and its H(t) build), a CNOT train_gate
    epoch, a 4q demo MC epoch and an 8q dense seed epoch (4 seeds,
    'apply'); returns {name: ms}."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    from diffquantum_tpu_torch.train import TrainConfig, train_energy
    from diffquantum_tpu_torch.train import train_gate

    p = dense_problems()
    ring = p["ring"]
    out = {}
    coeff = coeff_12q(ring, seed=10)
    args = (ring.ham, ring.envelope, ring.measurement, coeff, ring.psi0,
            ring.T, 30)
    out["grad10dense"] = ms = cuda_ms(lambda: energy_and_grad(*args), 5, 1)
    ms_x = cuda_ms(lambda: energy_and_grad(*args, backend="expm"), 3, 1)
    u = ring.envelope.amplitudes(coeff, torch.arange(30, dtype=torch.float64,
                                                     device=DEVICE) * (
                                                         ring.T / 30),
                                 ring.T)
    h_ms = cuda_ms(lambda: ring.ham.at(u.transpose(-1, -2)), 10, 2)
    bound = sum(taylor_bound(1024, 1, 8, 8, bw)[0] for bw in (False, True))
    log(f"time: 10q dense grad step {ms!r} ms ('apply', K7; 'expm' "
        f"{ms_x!r} ms), of which the H(t) build for the 30 steps {h_ms!r} "
        f"ms; K7 bound of the step {30 * bound!r} ms")
    two_ham, omegas = p["two"]
    env = SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    out["cnot_epoch"] = ms = cuda_ms(lambda: train_gate(
        two_ham, env, CNOT, 4.0, TrainConfig(n_basis=6, n_epoch=20,
                                             lr=0.1)), 1, 1) / 20
    log(f"time: CNOT train_gate epoch {ms!r} ms (20 epochs in one call, "
        f"with the final evolution; 50 K7 forward and 50 backward launches "
        f"at d=4, B=4 per epoch)")
    demo = p["demo"]
    out["demo_mc_epoch"] = ms = cuda_ms(lambda: train_energy(
        demo.ham, demo.envelope, demo.measurement, demo.psi0, demo.T,
        TrainConfig(n_basis=6, n_epoch=10, lr=2e-2, grad_mode="mc")),
        1, 1) / 10
    log(f"time: 4q demo MC epoch {ms!r} ms (10 epochs in one call; 100 K7 "
        f"launches at d=16, B=16 per epoch)")
    p8 = maxcut.build_maxcut(8, maxcut.ring_graph(8), device=DEVICE)
    n8 = reference_n_steps(10, 0.0, p8.T)
    init = torch.tensor(1e-3 * np.random.default_rng(8).standard_normal(
        (4,) + p8.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    out["seeds8dense_epoch"] = ms = cuda_ms(lambda: train_energy_seeds(
        p8.ham, p8.envelope, p8.measurement, p8.psi0, p8.T,
        TrainConfig(n_epoch=3, backend="apply"), n_seeds=4,
        init_coeffs=init), 1, 1) / 3
    log(f"time: 8q dense seed epoch {ms!r} ms (4 seeds, 3 epochs in one "
        f"call; {4 * n8} K7 forward and backward launches at d=256, B=1 per "
        f"epoch)")
    return out


def phase_dense_times():
    """K7 at every shape of dense_kernel_cases and the dense paths' times
    (k7_case_times, dense_path_times). Returns {kernel: (ms, plain_ms,
    bound_ms, bound_by, library_ms)} at the 10q state's shape (d = 1024,
    B = 1)."""
    t_phase = time.perf_counter()
    times = k7_case_times(dense_kernel_cases())
    dense_path_times()
    log(f"time: the dense times took {time.perf_counter() - t_phase:.1f} s")
    main = times["10q dense MaxCut state, d=1024 B=1"]
    return {f"k7_{part}": main[part] for part in ("forward", "backward")}


# --------------------------------------------------------------------------
# the sharded engine's local step: K4 (the per-call packed chain, on the
# pass pair) and the paths of evolve_product_sharded at world size 1
# --------------------------------------------------------------------------

# The sharded 24q 'chunked' grad step against energy_and_grad on K5 (one
# integrator at k = 0: K4's T = 1 chains leave the half-phases unmerged),
# value atol and gradient relative to its max-norm, as the frontier's
# limits; the meshed seeds against mesh=None (per-epoch losses, absolute).
SHARDED_VALUE_ATOL = 5e-5
SHARDED_GRAD_REL = 1e-4
MESH_SEEDS_ATOL = 1e-6


def xy_palindromic(n, n_steps, seed):
    """An n-qubit X/Y plan sharing qubits 0 and n - 3 (palindromic, half
    angles mirrored) with the ring's sign planes and random rows, in K4's
    single form: (psi0 [d], ud [T, S], theta_x [T, n_ops], h0th, signs,
    qubits, kinds)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import _symmetrize_rots
    rng = np.random.default_rng(seed)
    _, _, _, _, signs, _, _ = packed_inputs(frontier_problem(n), 1, seed)
    qubits = tuple(range(n)) + (0, n - 3)
    kinds = ("x",) * n + ("y", "y")
    f32 = dict(dtype=torch.float32, device=DEVICE)
    tx = torch.tensor(0.3 * rng.standard_normal((n_steps, len(qubits))),
                      **f32)
    qubits, kinds, tx = _symmetrize_rots(qubits, kinds, tx, dim=1)
    ud = torch.tensor(0.2 * rng.standard_normal((n_steps, n + 1)), **f32)
    h0th = torch.tensor(0.1 * rng.standard_normal(2**n), **f32)
    psi0 = _random_cp(rng, (2**n,), 1.0 / np.sqrt(2**(n + 1)))
    return psi0, ud, tx.contiguous(), h0th, signs, qubits, kinds


def phase_chunked_kernels():
    """K4 (``chunked_evolve``) forward and backward through its entry
    point and autograd against its plain versions: 12q T=1 (no chunk
    bits in the JAX package's plan), the 20q random graph (two sign
    planes) at T=1 and T=30, 24q T=1 (the sharded path's call) and a
    palindromic X/Y plan. Returns {"k4": (forward, backward) max abs
    errors} of the 24q T=1 case."""
    import torch
    from diffquantum_tpu_torch.ops import fused_chunked as tfc
    from diffquantum_tpu_torch.ops.cpx import CP

    cases = [("K4 12q ring MaxCut, T=1 (no chunk bits)", 12, 1, "ring"),
             ("K4 20q random graph (P=2 sign planes), T=1", 20, 1, "random"),
             ("K4 20q random graph (P=2 sign planes), T=30", 20, 30,
              "random"),
             ("K4 24q ring MaxCut, T=1", 24, 1, "ring"),
             ("K4 20q palindromic X/Y plan (X and Y on qubits 0 and 17), "
              "T=1", 20, 1, "xy")]
    errs = {}
    for label, n, n_steps, chain in cases:
        seed = 4000 + n * 10 + n_steps
        rng = np.random.default_rng(seed)
        if chain == "xy":
            psi0, ud, tx, h0th, signs, qubits, kinds = xy_palindromic(
                n, n_steps, seed)
            w = torch.tensor(rng.standard_normal(2**n), dtype=torch.float32,
                             device=DEVICE)
        else:
            prob = frontier_problem(n, chain)
            _, ud, tx, h0th, signs, qubits, kinds = packed_inputs(
                prob, n_steps, seed)
            psi0, w = prob.psi0, prob.measurement.diag
        args = (h0th, signs, qubits, n, kinds)
        leaves = [t.clone().requires_grad_(True)
                  for t in (psi0.re, psi0.im, ud, tx)]
        before = read_counts()
        t0 = time.perf_counter()
        out = tfc.chunked_evolve(CP(leaves[0], leaves[1]), leaves[2],
                                 leaves[3], *args)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = tfc.chunked_evolve_plain(psi0, ud, tx, *args)
        lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)  # d<w>/dpsi
        got = torch.autograd.grad((out.re, out.im), leaves, (lam.re, lam.im))
        after = read_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if ran != {"k4_forward": 1, "k4_backward": 1}:
            fail(f"{label}: the entry point launched {ran}, expected one K4 "
                 f"chain each way")
        gp, gud, gtx = tfc._adjoint_chunked_plain(ref, lam, ud, tx, *args)
        torch.cuda.synchronize()
        fwd_err, bwd_abs, rels = _check_case(
            label, "K4", TOL_PK, (out.re.detach(), out.im.detach()), ref,
            got, (gp.re, gp.im, gud, gtx), "dpsi_re, dpsi_im, dud, dtheta_x")
        log(f"kernel check K4 [{label}]: {len(kinds)} ops, "
            f"{signs.shape[0]} sign plane(s), plan "
            f"[{pk_geometry(n, ud.shape[-1] - 1, 1)}], forward max abs err "
            f"{fwd_err!r} (atol {TOL_PK['fwd']}); backward relative errors "
            f"{rels!r} (bound {TOL_PK['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms")
        if n == 24:
            errs["k4"] = (fwd_err, bwd_abs)
        del out, ref, got, leaves, gp, gud, gtx, lam
        torch.cuda.empty_cache()
    return errs


def _sharded_grad(mesh, prob, coeff, n_steps, backend):
    """(value, coefficient gradient) of ``evolve_product_sharded`` and
    ``sharded_diag_expectation`` at ``prob``'s diagonal objective."""
    import torch
    from diffquantum_tpu_torch.parallel import (evolve_product_sharded,
                                                sharded_diag_expectation)
    c = coeff.detach().clone().requires_grad_(True)
    psi = evolve_product_sharded(prob.ham, prob.envelope, c, prob.psi0, 0.0,
                                 prob.T, horizon=prob.T, n_steps=n_steps,
                                 mesh=mesh, local_backend=backend)
    e = sharded_diag_expectation(psi, prob.measurement.diag, mesh)
    (g,) = torch.autograd.grad(e, c)
    return e.detach(), g


def _against(label, val, grad, val_r, grad_r, atol, grel):
    import torch
    dv, dg = abs(float(val) - float(val_r)), rel_err(grad, grad_r)
    log(f"{label}: value {float(val)!r} (reference {float(val_r)!r}, diff "
        f"{dv!r}); gradient relative diff {dg!r}")
    if not (torch.isfinite(grad).all() and dv <= atol and dg <= grel):
        fail(f"{label} disagrees with its reference (value atol {atol}, "
             f"gradient {grel} of max-norm)")


def phase_sharded_paths(total):
    """The sharded engine on a mesh of one rank (one card): the 24q ring
    through 'chunked' (K4 only), the 12q ring through 'fused' (K1 only)
    and 'xla' (no kernel), the meshed seed population, and the dense
    'apply' routes of this slice (K7 for a seed population at d = 256;
    the recurrence at d = 2048 and in float64)."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.parallel import make_mesh, train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig

    t_phase = time.perf_counter()
    mesh = make_mesh({"state": 1})
    log(f"sharded: mesh {mesh.shape} on {mesh.device} (world size 1)")
    prob = frontier_problem(24)
    n_steps = reference_n_steps(10, 0.0, prob.T)
    coeff = torch.tensor(0.4 * np.random.default_rng(24).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    val, grad = _counted(total, "sharded 'chunked', 24q grad step",
                         {"k4_forward": n_steps, "k4_backward": n_steps},
                         lambda: _sharded_grad(mesh, prob, coeff, n_steps,
                                               "chunked"))
    val_r, grad_r = _counted(
        total, "energy_and_grad, 24q (K5, the reference)",
        {"k5_forward": 1, "k5_backward": 1},
        lambda: energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                                coeff, prob.psi0, prob.T, n_steps))
    _against("sharded: 24q 'chunked' grad step against energy_and_grad on "
             "K5", val, grad, val_r, grad_r, SHARDED_VALUE_ATOL,
             SHARDED_GRAD_REL)
    epochs = 3

    def train():
        c = coeff.clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=2e-2)
        losses = []
        for _ in range(epochs):
            e, g = _sharded_grad(mesh, prob, c, n_steps, "chunked")
            c.grad = g
            opt.step()
            losses.append(float(e))
        return losses

    losses = _counted(total, f"sharded 'chunked', 24q, {epochs} Adam epochs",
                      {"k4_forward": epochs * n_steps,
                       "k4_backward": epochs * n_steps}, train)
    log(f"sharded: 24q 'chunked' {epochs} Adam epochs, loss {losses[0]!r} "
        f"-> {losses[-1]!r}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("the sharded 24q training loss did not fall")
    torch.cuda.empty_cache()

    ring, n12 = twelve_qubits()
    c12 = coeff_12q(ring)
    val_r, grad_r = energy_and_grad(ring.ham, ring.envelope,
                                    ring.measurement, c12, ring.psi0, ring.T,
                                    n12)
    for backend, want in (("fused", {"k1_forward": n12,
                                     "k1_backward": n12}),
                          ("xla", {})):
        val, grad = _counted(total, f"sharded {backend!r}, 12q grad step",
                             want, lambda b=backend: _sharded_grad(
                                 mesh, ring, c12, n12, b))
        _against(f"sharded: 12q {backend!r} grad step against "
                 f"energy_and_grad on K1", val, grad, val_r, grad_r, 5e-5,
                 1e-4)

    init = torch.tensor(1e-3 * np.random.default_rng(64).standard_normal(
        (64,) + ring.envelope.coeff_shape), dtype=torch.float32,
        device=DEVICE)
    cfg = TrainConfig(n_epoch=3, lr=2e-2)
    args = (ring.ham, ring.envelope, ring.measurement, ring.psi0, ring.T, cfg)
    meshed = _counted(total, "train_energy_seeds, 12q, 64 seeds, data mesh "
                      "of 1, 3 epochs", {"k2_forward": 3, "k2_backward": 3},
                      lambda: train_energy_seeds(
                          *args, n_seeds=64, init_coeffs=init,
                          mesh=make_mesh({"data": 1})))
    plain = train_energy_seeds(*args, n_seeds=64, init_coeffs=init)
    diff = float(np.abs(meshed.losses - plain.losses).max())
    log(f"sharded: 64 seeds on a data mesh of 1 against mesh=None: max abs "
        f"loss diff {diff!r} (atol {MESH_SEEDS_ATOL})")
    if not (meshed.losses.shape == plain.losses.shape == (3, len(init))
            and diff <= MESH_SEEDS_ATOL
            and np.all(meshed.losses[-1] < meshed.losses[0])):
        fail("the meshed seed population differs from mesh=None or its "
             "losses did not fall")
    log(f"sharded: the sharded paths took {time.perf_counter() - t_phase:.1f}"
        f" s")
    dense_routes(total)


def _dense_11q(dtype):
    """An 11-qubit dense problem (d = 2048): ZZ(0, 1), X on qubit 0 and
    Y on qubit 10, a diagonal drift 0.3 Z_5 (norms known exactly: no host
    eigendecomposition of 2048 x 2048 operators); psi0, a diagonal
    objective and coefficients from fixed seeds."""
    import torch
    from diffquantum_tpu_torch.dynamics.hamiltonian import \
        ControlledHamiltonian
    from diffquantum_tpu_torch.ops import cpx, linalg
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    n = 11
    d = 2**n
    hs = np.stack([np.diag(linalg.zz_diagonal(n, 0, 1)),
                   linalg.op_on_qubits(linalg.X, [0], n),
                   linalg.op_on_qubits(linalg.Y, [10], n)])
    h0 = np.diag(0.3 * linalg.z_diagonal(n, 5)).astype(np.complex128)
    ham = ControlledHamiltonian(
        h0_norm=0.3, hs_norms=(1.0, 1.0, 1.0), structure=None,
        h0_structure=None, n_qubits=n, dtype=dtype,
        H0=cpx.from_complex(h0, dtype=dtype, device=DEVICE),
        Hs=cpx.from_complex(hs, dtype=dtype, device=DEVICE))
    env = SimpleEnvelope(basis="bspline", n_basis=4, omegas=(1.0, 0.8, 0.6))
    rng = np.random.default_rng(11)
    psi = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    psi0 = cpx.from_complex(psi / np.linalg.norm(psi), dtype=dtype,
                            device=DEVICE)
    w = torch.tensor(rng.standard_normal(d), dtype=dtype, device=DEVICE)
    c = torch.tensor(0.4 * rng.standard_normal((3, 4)), dtype=dtype,
                     device=DEVICE)
    return ham, env, psi0, w, c


def dense_routes(total):
    """The dense 'apply' routes on the card: the 8q dense ring MaxCut's
    seed population on K7 (backend 'apply': one launch per seed and step,
    each seed its own H(t)) against 'auto' (the JAX package's per-seed
    rule takes 'expm' below d = 512); on the recurrence route, one 11q
    dense grad step (d = 2048, against the float64 recurrence; the CPU
    tests hold the recurrence against the JAX package's 'apply') and one
    float64 10q step against float64 'expm'."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig

    t_phase = time.perf_counter()
    p8 = maxcut.build_maxcut(8, maxcut.ring_graph(8), device=DEVICE)
    n8 = reference_n_steps(10, 0.0, p8.T)
    n_seeds, epochs = 4, 3
    init = torch.tensor(1e-3 * np.random.default_rng(8).standard_normal(
        (n_seeds,) + p8.envelope.coeff_shape), dtype=torch.float32,
        device=DEVICE)
    args = (p8.ham, p8.envelope, p8.measurement, p8.psi0, p8.T)
    k7 = _counted(total, f"train_energy_seeds, 8q dense, {n_seeds} seeds, "
                  f"backend 'apply'",
                  {"k7_forward": epochs * n_seeds * n8,
                   "k7_backward": epochs * n_seeds * n8},
                  lambda: train_energy_seeds(
                      *args, TrainConfig(n_epoch=epochs, backend="apply"),
                      n_seeds=n_seeds, init_coeffs=init))
    auto = _counted(total, f"train_energy_seeds, 8q dense, {n_seeds} seeds, "
                    f"'auto' ('expm')", {},
                    lambda: train_energy_seeds(
                        *args, TrainConfig(n_epoch=epochs), n_seeds=n_seeds,
                        init_coeffs=init))
    diff = float(np.abs(k7.losses - auto.losses).max())
    log(f"dense: 8q seed population on K7, mean loss "
        f"{float(k7.losses[0].mean())!r} -> {float(k7.losses[-1].mean())!r};"
        f" against 'expm' max abs diff {diff!r} (atol {DENSE_VALUE_ATOL})")
    if not (diff <= DENSE_VALUE_ATOL
            and np.all(k7.losses[-1] < k7.losses[0])):
        fail("the 8q dense seed population on K7 differs from 'expm' or "
             "its losses did not fall")

    f64 = torch.float64
    n_steps, T = 10, 1.0
    ham, env, psi0, w, c = _dense_11q(torch.float32)
    val, grad = _counted(total, "energy_and_grad, 11q dense (d = 2048), "
                         "'apply' on the recurrence", {"apply_recurrence":
                                                       n_steps},
                         lambda: energy_and_grad(ham, env, w, c, psi0, T,
                                                 n_steps, backend="apply"))
    del ham
    ham64, env, psi64, w64, c64 = _dense_11q(f64)
    val_d, grad_d = energy_and_grad(ham64, env, w64, c64, psi64, T, n_steps,
                                    backend="apply")
    _against("dense: 11q f32 'apply' (recurrence) against the float64 "
             "recurrence", val, grad.to(f64), val_d, grad_d,
             DENSE_F64_VALUE_ATOL, DENSE_F64_GRAD_REL)
    del ham64, grad_d
    torch.cuda.empty_cache()

    ring = dense_problems()["ring"]
    n10 = reference_n_steps(10, 0.0, ring.T)
    ham64 = dataclasses.replace(ring.ham, dtype=f64,
                                H0=ring.ham.H0.astype(f64),
                                Hs=ring.ham.Hs.astype(f64))
    m64 = dataclasses.replace(ring.measurement,
                              matrix=ring.measurement.matrix.astype(f64))
    c10 = coeff_12q(ring, seed=10).to(f64)
    step = lambda b: energy_and_grad(  # noqa: E731
        ham64, ring.envelope, m64, c10, ring.psi0.astype(f64), ring.T, n10,
        backend=b)
    val, grad = _counted(total, "energy_and_grad, 10q dense float64, "
                         "'apply' on the recurrence",
                         {"apply_recurrence": n10}, lambda: step("apply"))
    val_d, grad_d = step("expm")
    _against("dense: 10q float64 'apply' (recurrence) against float64 "
             "'expm'", val, grad, val_d, grad_d, DENSE_F64_VALUE_ATOL,
             DENSE_F64_GRAD_REL)
    log(f"dense: the 'apply' routes took {time.perf_counter() - t_phase:.1f}"
        f" s")


def phase_sharded_times():
    """K4 at 24q T=1 (the sharded path's call) beside its plain version
    and bound, and 30 such calls as a chain; the 24q sharded 'chunked'
    grad step beside energy_and_grad on K5. Returns {kernel: (ms,
    plain_ms, bound_ms, bound_by)} for K4."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.ops import fused_chunked as tfc
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.parallel import make_mesh

    out = {}
    prob = frontier_problem(24)
    n = 24
    _, ud, tx, h0th, signs, qubits, kinds = packed_inputs(prob, 1, n)
    plan = tfp._packed_plan(qubits, kinds, n)
    udm = tfp.merge_ud_rows(ud[:, None].contiguous())
    tx3 = tx[:, None].contiguous()
    psi = CP(prob.psi0.re[None].contiguous(), prob.psi0.im[None].contiguous())
    fwd = lambda: tfp._packed_forward_cuda(  # noqa: E731
        psi.re, psi.im, udm, tx3, h0th, signs, plan, n, "K4")
    o_re, o_im = fwd()
    w = prob.measurement.diag
    lam = CP(2.0 * w * o_re, 2.0 * w * o_im)
    bwd = lambda: tfp._packed_backward_cuda(  # noqa: E731
        o_re, o_im, lam.re, lam.im, udm, tx3, h0th, signs, plan, n, "K4")
    args = (ud, tx, h0th, signs, qubits, n, kinds)
    runs = {"forward": (fwd, lambda: tfc.chunked_evolve_plain(
                prob.psi0, *args)),
            "backward": (bwd, lambda: tfc._adjoint_chunked_plain(
                CP(o_re[0], o_im[0]), CP(lam.re[0], lam.im[0]), *args))}
    shape = (f"24q, T=1, {len(kinds)} ops, {ud.shape[1] - 1} diagonal terms, "
             f"B=1")
    for part, (kfn, pfn) in runs.items():
        ms = cuda_ms(kfn, 30, warmup=3)
        plain_ms = cuda_ms(pfn, 3, warmup=1)
        bound = packed_bound(n, 1, kinds, ud.shape[1] - 1, signs.shape[0],
                             part == "backward")
        log(f"time: k4_{part} {ms!r} ms/chain (30 chains: {30 * ms!r} ms), "
            f"plain version {plain_ms!r} ms, bound {bound[0]!r} ms "
            f"({bound[1]}) ({shape})")
        out[f"k4_{part}"] = (ms, plain_ms) + bound
    del runs, fwd, bwd, o_re, o_im, lam
    torch.cuda.empty_cache()

    mesh = make_mesh({"state": 1})
    coeff = torch.tensor(1e-3 * np.random.default_rng(0).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(lambda: _sharded_grad(mesh, prob, coeff, 30, "chunked"), 3,
                 warmup=1)
    ms_k5 = cuda_ms(lambda: energy_and_grad(
        prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0, prob.T,
        30), 3, warmup=1)
    log(f"time: 24q sharded 'chunked' 30-step grad step {ms!r} ms (30 K4 "
        f"chains each way, world size 1), energy_and_grad on K5 {ms_k5!r} "
        f"ms (CUDA events over 3 chained calls)")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Pauli-string objectives, the channel envelope, MC and FD at 18-24 qubits
# --------------------------------------------------------------------------

# Limits of the slice's paths, beside their first H100 readings (NVIDIA
# H100 80GB HBM3, 700 W). The 20q string expectation against its
# diagonal + 1q oracle on the same K5-evolved state, absolute: read
# 1.8e-7 (limit 5.4x above). The 8q dense TFIM on K7 against 'expm':
# value 1.5e-6, gradient 7.7e-6 of its max-norm (limits ~4x above). The
# channel grad step's directional derivative against central
# differences, relative to max(1, |fd|): 1.3e-4 at 12q, 2.1e-3 at 18q,
# held to tpu_tests/test_tpu_kernels.py's 5e-3. The 12q channel MC
# gradient against the eager engine, relative to its max-norm: 3.3e-6
# (4.6x). 32 stratified MC samples one after another, cosine with the
# adjoint: 0.9989 at 18q and 0.9977 at 20q (1 - cos 4.4x below the
# limit's). A sampled estimate within 5 standard errors of the exact
# value. The slice's other checks reuse the limits above (the eager
# engine: FRONTIER_*, MC_EAGER_REL; FD: FD_ADJ_REL).
STRINGS_ORACLE_ATOL = 1e-6
STRINGS_DENSE_ATOL = 6e-6
STRINGS_DENSE_GRAD_REL = 3e-5
CHANNEL_FD_REL = 5e-3
CHANNEL_MC_REL = 1.5e-5
SAMPLED_COS_MIN = 0.99
SAMPLED_SE = 5.0


def _counted_path(total, label, want, fn):
    """Run ``fn`` with the counters at 0, hold its launches to ``want``,
    add them to ``total``; returns fn's result."""
    zero_counts()
    out = fn()
    counts = read_counts()
    expect_counts(label, counts, want)
    _add(total, counts)
    return out


def _coeff(shape, seed, scale=0.4):
    import torch
    return torch.tensor(scale * np.random.default_rng(seed).standard_normal(
        shape), dtype=torch.float32, device=DEVICE)


def _model(kind, n, **kw):
    """A TFIM or Heisenberg problem on the card, built once per run."""
    from diffquantum_tpu_torch.models import heisenberg, tfim
    key = (kind, n, tuple(sorted(kw.items())))
    if key not in _PROBLEMS:
        t0 = time.perf_counter()
        _PROBLEMS[key] = tfim.build_tfim(n, device=DEVICE, **kw) \
            if kind == "tfim" else heisenberg.build_heisenberg(
                n, device=DEVICE, **kw)
        p = _PROBLEMS[key]
        log(f"host: {n}q {kind} ({p.envelope.n_controls} controls, "
            f"{p.measurement.strings.n_terms} strings) built in "
            f"{time.perf_counter() - t0:.3f} s")
    return _PROBLEMS[key]


def _strings_oracle(prob, psi):
    """The TFIM cost by hand: the ZZ part from the diagonal, the X part
    from 1q applications (tpu_tests/test_tpu_kernels.py:286-321)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import apply_1q_operator
    from diffquantum_tpu_torch.ops import linalg
    n = prob.n_qubits
    zz = np.zeros(2**n)
    for i in range(n - 1):
        zz -= prob.J * linalg.zz_diagonal(n, i, i + 1)
    p64 = psi.astype(torch.float64)
    e = float(torch.sum((p64.re ** 2 + p64.im ** 2) * torch.tensor(
        zz, dtype=torch.float64, device=DEVICE)))
    xr = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=torch.float64,
                      device=DEVICE)
    xi = torch.zeros((2, 2), dtype=torch.float64, device=DEVICE)
    for q in range(n):
        xp = apply_1q_operator(p64, q, n, xr, xi)
        e -= prob.h * float(torch.sum(p64.re * xp.re + p64.im * xp.im))
    return e


def phase_strings(total):
    """Pauli-string objectives through the entry points: the 20q TFIM and
    Heisenberg (K5), the 24q TFIM (K5), the 10q TFIM (K1), the 8q dense
    TFIM ('apply', K7), sampled strings and the sharded expectation at
    world size 1."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import (evolve,
                                                           reference_n_steps)
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.parallel import make_mesh
    from diffquantum_tpu_torch.parallel.sharded_state import \
        sharded_strings_expectation
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    prob = _model("tfim", 20, dense=False)
    n_steps = reference_n_steps(10, 0.0, prob.T)
    if select_engine(prob.ham) != "mega" or n_steps != 30:
        fail(f"20q TFIM routes to {select_engine(prob.ham)!r} with "
             f"{n_steps} steps, expected 'mega' with 30")
    coeff = _coeff(prob.envelope.coeff_shape, 20)
    with torch.no_grad():
        psi = _counted_path(total, "evolve, 20q TFIM", {"k5_forward": 1},
                            lambda: evolve(prob.ham, prob.envelope, coeff,
                                           prob.psi0, 0.0, prob.T,
                                           horizon=prob.T, n_steps=n_steps))
        e_str = float(prob.measurement.expectation(psi))
    e_ora = _strings_oracle(prob, psi)
    log(f"strings: 20q TFIM on a K5 state: {prob.measurement.strings.n_terms}"
        f" strings {e_str!r}, diagonal + 1q oracle (f64) {e_ora!r}, diff "
        f"{abs(e_str - e_ora)!r} (atol {STRINGS_ORACLE_ATOL})")
    if not abs(e_str - e_ora) <= STRINGS_ORACLE_ATOL:
        fail("20q string expectation disagrees with its oracle")
    args = (prob.ham, prob.envelope, prob.measurement)
    val, grad = _counted_path(
        total, "energy_and_grad, 20q TFIM",
        {"k5_forward": 1, "k5_backward": 1},
        lambda: energy_and_grad(*args, coeff, prob.psi0, prob.T, n_steps))
    _eager_check("strings: 20q TFIM grad step", prob, coeff, n_steps, val,
                 grad)
    res = _counted_path(
        total, "train_energy adjoint, 20q TFIM, 20 epochs",
        {"k5_forward": 21, "k5_backward": 20},
        lambda: train_energy(*args, prob.psi0, prob.T,
                             TrainConfig(n_epoch=20, lr=5e-2),
                             lam_min=prob.exact_ground))
    gaps = res.losses_energy
    log(f"strings: 20q TFIM 20 epochs, gap to the free-fermion ground "
        f"energy {prob.exact_ground!r}: {gaps[0]!r} -> {gaps[-1]!r}, wall "
        f"{res.wall_s:.3f} s")
    if not (np.all(np.isfinite(gaps)) and gaps[-1] < gaps[0]
            and min(gaps) >= -1e-3):
        fail("20q TFIM gap did not fall (or fell below the ground energy)")

    # sampled strings on the trained state: 20 estimates of 1000 shots
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    from diffquantum_tpu_torch.measure import stochastic_measure_strings
    with torch.no_grad():
        psi_t = res.final_state
        exact = float(prob.measurement.expectation(psi_t))
        est = torch.stack([stochastic_measure_strings(
            prob.measurement.strings, psi_t, gen, 1000)
            for _ in range(20)]).double().cpu().numpy()
    se = float(est.std() / np.sqrt(len(est)))
    log(f"strings: sampled 20q TFIM, 20 x 1000 shots per QWC group: mean "
        f"{float(est.mean())!r}, exact {exact!r}, standard error {se!r}")
    if not abs(float(est.mean()) - exact) <= SAMPLED_SE * se:
        fail("sampled strings estimate is off the exact value")

    # world size 1: the sharded expectation is the unsharded one
    mesh = make_mesh({"state": 1}, device=DEVICE)
    with torch.no_grad():
        sh = float(sharded_strings_expectation(psi_t, prob.measurement.strings,
                                               mesh))
    log(f"strings: sharded_strings_expectation on a mesh of one {sh!r}, "
        f"unsharded {exact!r}, diff {abs(sh - exact)!r} (atol 1e-6)")
    if not abs(sh - exact) <= 1e-6:
        fail("the sharded expectation at world size 1 is not the unsharded")

    hb = _model("heisenberg", 20, dense=False)
    hn = reference_n_steps(10, 0.0, hb.T)
    if select_engine(hb.ham) != "mega":
        fail(f"20q Heisenberg routes to {select_engine(hb.ham)!r}")
    hc = _coeff(hb.envelope.coeff_shape, 21, scale=0.3)
    hargs = (hb.ham, hb.envelope, hb.measurement)
    val, grad = _counted_path(
        total, f"energy_and_grad, 20q Heisenberg ({hn} steps)",
        {"k5_forward": 1, "k5_backward": 1},
        lambda: energy_and_grad(*hargs, hc, hb.psi0, hb.T, hn))
    _eager_check("strings: 20q Heisenberg grad step", hb, hc, hn, val, grad)
    res = _counted_path(
        total, "train_energy adjoint, 20q Heisenberg, 3 epochs",
        {"k5_forward": 4, "k5_backward": 3},
        lambda: train_energy(*hargs, hb.psi0, hb.T,
                             TrainConfig(n_epoch=3, lr=5e-2),
                             init_coeff=hc))
    log(f"strings: 20q Heisenberg 3 epochs, loss {res.losses_raw[0]!r} -> "
        f"{res.losses_raw[-1]!r}")
    if not (np.all(np.isfinite(res.losses_raw))
            and res.losses_raw[-1] < res.losses_raw[0]):
        fail("20q Heisenberg loss did not fall")
    del psi, psi_t, res
    torch.cuda.empty_cache()

    big = _model("tfim", 24, dense=False)
    bn = reference_n_steps(10, 0.0, big.T)
    bc = _coeff(big.envelope.coeff_shape, 24)
    val, grad = _counted_path(
        total, "energy_and_grad, 24q TFIM", {"k5_forward": 1,
                                             "k5_backward": 1},
        lambda: energy_and_grad(big.ham, big.envelope, big.measurement, bc,
                                big.psi0, big.T, bn))
    with torch.no_grad():
        psi_e = evolve(big.ham, big.envelope, bc, big.psi0, 0.0, big.T,
                       horizon=big.T, n_steps=bn, backend="product")
        val_e = float(big.measurement.expectation(psi_e))
    dv = abs(float(val) - val_e)
    log(f"strings: 24q TFIM grad step value {float(val)!r} (eager engine, no "
        f"grad, {val_e!r}, diff {dv!r}); peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB so far")
    if not (torch.isfinite(grad).all() and dv <= FRONTIER_VALUE_ATOL):
        fail("24q TFIM grad step value disagrees with the eager engine")
    del psi_e
    torch.cuda.empty_cache()

    small = _model("tfim", 10)
    sn = reference_n_steps(10, 0.0, small.T)
    sc = _coeff(small.envelope.coeff_shape, 10)
    val, grad = _counted_path(
        total, "energy_and_grad, 10q TFIM", {"k1_forward": 1,
                                             "k1_backward": 1},
        lambda: energy_and_grad(small.ham, small.envelope, small.measurement,
                                sc, small.psi0, small.T, sn))
    _eager_check("strings: 10q TFIM grad step", small, sc, sn, val, grad)

    dense = _model("tfim", 8)
    dc = _coeff(dense.envelope.coeff_shape, 8)
    dargs = (dense.ham, dense.envelope, dense.measurement, dc, dense.psi0,
             dense.T, sn)
    val, grad = _counted_path(
        total, "energy_and_grad, 8q dense TFIM, 'apply'",
        {"k7_forward": sn, "k7_backward": sn},
        lambda: energy_and_grad(*dargs, backend="apply"))
    val_x, grad_x = energy_and_grad(*dargs, backend="expm")
    dv, dg = abs(float(val) - float(val_x)), rel_err(grad, grad_x)
    log(f"strings: 8q dense TFIM on K7 value {float(val)!r} ('expm' "
        f"{float(val_x)!r}, diff {dv!r}); gradient relative diff {dg!r}")
    if not (dv <= STRINGS_DENSE_ATOL and dg <= STRINGS_DENSE_GRAD_REL):
        fail("8q dense TFIM on 'apply' disagrees with 'expm'")


_CHANNEL = {}


def channel_problem(n):
    """bench.py's channel model (`bench.py:389-433`): the n-qubit ring,
    ZZ and X controls, one carrier channel each (Legendre, n_basis 6),
    the cut cost as a diagonal, T = 2."""
    import torch
    from diffquantum_tpu_torch.dynamics.hamiltonian import (
        ControlledHamiltonian, TermStructure)
    from diffquantum_tpu_torch.measure import Measurement
    from diffquantum_tpu_torch.ops import linalg
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.pulses.envelope import ChannelEnvelope
    if n not in _CHANNEL:
        d = 2**n
        edges = [(i, (i + 1) % n) for i in range(n)]
        structure, nested = [], []
        cost = np.zeros(d)
        for idx, (i, j) in enumerate(edges):
            diag = linalg.zz_diagonal(n, i, j)
            cost += -0.5 * (1.0 - diag)
            structure.append(TermStructure(kind="diag", diag=diag))
            nested.append([[0.0, np.pi, 0.7 * idx, idx]])
        for q in range(n):
            structure.append(TermStructure(kind="1q", qubit=q,
                                           local=linalg.X))
            nested.append([[0.0, np.pi, 3.0 + 0.5 * q, len(edges) + q]])
        ham = ControlledHamiltonian.create_structured(
            d, tuple(structure),
            h0_structure=TermStructure(kind="diag", diag=np.zeros(d)))
        env = ChannelEnvelope.from_rows(nested, n_basis=6, func_type=0)
        psi0 = CP(torch.full((d,), d ** -0.5, device=DEVICE),
                  torch.zeros(d, device=DEVICE))
        meas = Measurement.create_diagonal(cost, device=DEVICE)
        _CHANNEL[n] = dataclasses.make_dataclass(
            "ChannelProblem", ["ham", "envelope", "measurement", "psi0",
                               "T", "n_qubits"])(ham, env, meas, psi0, 2.0, n)
    return _CHANNEL[n]


def phase_channel(total):
    """The channel model at 12q (K1) and 18q (K3): the grad step against
    central differences and the eager engine; the 12q MC gradient at a
    fixed split time against the eager engine."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import evolve
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.mc import mc_energy_grad
    from diffquantum_tpu_torch.measure import diag_expectation

    n_steps = 30
    for n, engine, kernel in ((12, "streamed", "k1"), (18, "packed", "k3")):
        p = channel_problem(n)
        if select_engine(p.ham) != engine:
            fail(f"{n}q channel model routes to {select_engine(p.ham)!r}")
        vv = _coeff(p.envelope.coeff_shape, 100 + n, scale=0.7)
        args = (p.ham, p.envelope, p.measurement)
        val, grad = _counted_path(
            total, f"energy_and_grad, channel{n}q",
            {f"{kernel}_forward": 1, f"{kernel}_backward": 1},
            lambda: energy_and_grad(*args, vv, p.psi0, p.T, n_steps))
        direction = _coeff(vv.shape, 52 + n, scale=1.0)
        eps = 1e-3

        def loss(c):
            with torch.no_grad():
                psi = evolve(p.ham, p.envelope, c, p.psi0, 0.0, p.T,
                             horizon=p.T, n_steps=n_steps)
                return float(diag_expectation(p.measurement.diag, psi))
        fd = (loss(vv + eps * direction) - loss(vv - eps * direction)) \
            / (2 * eps)
        an = float((grad * direction).sum())
        drel = abs(fd - an) / max(1.0, abs(fd))
        log(f"channel: {n}q grad step directional derivative {an!r}, "
            f"central differences {fd!r}, relative diff {drel!r} (bound "
            f"{CHANNEL_FD_REL})")
        if not (torch.isfinite(grad).all() and drel <= CHANNEL_FD_REL):
            fail(f"{n}q channel gradient disagrees with central differences")
        _eager_check(f"channel: {n}q grad step", p, vv, n_steps, val, grad)

    p = channel_problem(12)
    vv = _coeff(p.envelope.coeff_shape, 112, scale=0.7)
    s = torch.tensor(0.7, dtype=torch.float64, device=DEVICE)
    margs = (p.ham, p.envelope, p.measurement, vv, p.psi0, p.T, None,
             n_steps)
    g = _counted_path(total, "mc_energy_grad, channel12q, s=0.7",
                      {"k1_forward": 1, "k2_forward": 1},
                      lambda: mc_energy_grad(*margs, s=s))
    g_e = mc_energy_grad(*margs, s=s, backend="product")
    dg = rel_err(g, g_e)
    log(f"channel: 12q MC gradient at s=0.7 {tuple(g.shape)} vs the eager "
        f"engine: relative diff {dg!r} (bound {CHANNEL_MC_REL})")
    if not (torch.isfinite(g).all() and dg <= CHANNEL_MC_REL):
        fail("channel MC gradient disagrees with the eager engine")


def eager_mc_sample(prob, coeff, s, n_steps, r=0.5, chunk=16):
    """One MC sample of a diagonal cost by hand on the eager engine, its
    2 n_Hs branches evolved ``chunk`` at a time (at 24 qubits the eager
    engine's temporaries for all 96 at once would not fit the card)."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import apply_structured_terms
    from diffquantum_tpu_torch.dynamics.propagator import evolve
    from diffquantum_tpu_torch.gradients.mc import envelope_sensitivity
    from diffquantum_tpu_torch.measure import diag_expectation
    from diffquantum_tpu_torch.ops.cpx import CP
    T = prob.T
    kw = dict(horizon=T, n_steps=n_steps, backend="product")
    with torch.no_grad():
        phi = evolve(prob.ham, prob.envelope, coeff, prob.psi0, 0.0, s, **kw)
        h_re, h_im = apply_structured_terms(prob.ham, phi)
        sc = 1.0 / (1.0 + r * r) ** 0.5
        br_re = torch.cat([phi.re - r * h_im, phi.re + r * h_im]) * sc
        br_im = torch.cat([phi.im + r * h_re, phi.im - r * h_re]) * sc
        del h_re, h_im
        ps = []
        for lo in range(0, br_re.shape[0], chunk):
            kets = evolve(prob.ham, prob.envelope, coeff,
                          CP(br_re[lo:lo + chunk], br_im[lo:lo + chunk]), s,
                          T, **kw)
            ps.append(diag_expectation(prob.measurement.diag, kets))
            del kets
        ps = torch.cat(ps)
        n_hs = ps.shape[0] // 2
        ps_k = (1.0 + r * r) / (2.0 * r) * (ps[n_hs:] - ps[:n_hs])
        return ps_k[:, None] * envelope_sensitivity(prob.envelope, coeff, s,
                                                    T)


def phase_sampled_frontier(total):
    """MC and FD at 18-24 qubits on the ring MaxCut (n_basis 6, 30
    steps): samples one after another, FD in chunks sized from the
    card's free memory."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.fd import fd_chunk_size, \
        fd_energy_grad
    from diffquantum_tpu_torch.gradients.mc import (mc_energy_grad,
                                                    mc_energy_grad_batch)
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    n_steps = 30
    n_samples = 32
    for n in (18, 20):
        k = "k3" if n == 18 else "k5"
        prob = frontier_problem(n)
        coeff = _coeff(prob.envelope.coeff_shape, n)
        args = (prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
                prob.T)
        s = torch.tensor(0.7, dtype=torch.float64, device=DEVICE)
        one = {f"{k}_forward": 2} if n == 18 else \
            {"k5_forward": 2, "k5_batched_forward": 1}
        g = _counted_path(total, f"mc_energy_grad, {n}q, s=0.7", one,
                          lambda: mc_energy_grad(*args, None, n_steps, s=s))
        g_e = mc_energy_grad(*args, None, n_steps, s=s, backend="product")
        dg = rel_err(g, g_e)
        log(f"sampled: {n}q MC gradient at s=0.7 vs the eager engine: "
            f"relative diff {dg!r} (bound {MC_EAGER_REL})")
        if not (torch.isfinite(g).all() and dg <= MC_EAGER_REL):
            fail(f"{n}q MC gradient disagrees with the eager engine")
        gen = torch.Generator(device=DEVICE).manual_seed(n)
        batch = {f"{k}_forward": 2 * n_samples} if n == 18 else \
            {"k5_forward": 2 * n_samples, "k5_batched_forward": n_samples}
        gb = _counted_path(
            total, f"mc_energy_grad_batch, {n}q, {n_samples} stratified, "
            f"one after another", batch,
            lambda: mc_energy_grad_batch(*args, gen, n_steps, n_samples,
                                         strategy="stratified"))
        _, adj = energy_and_grad(*args, n_steps)
        cos = float((gb * adj).sum() / (gb.norm() * adj.norm()))
        log(f"sampled: {n}q {n_samples} stratified samples, cosine with the "
            f"adjoint {cos!r} (limit {SAMPLED_COS_MIN})")
        if not cos >= SAMPLED_COS_MIN:
            fail(f"{n}q MC batch does not point along the adjoint gradient")
        n_members = 2 * coeff.numel()
        chunk = fd_chunk_size(prob.ham, n_members, DEVICE)
        n_chunks = -(-n_members // chunk)
        fdw = {f"{k}_forward": n_chunks} if n == 18 else \
            {"k5_forward": n_chunks, "k5_batched_forward": n_chunks}
        gf = _counted_path(total, f"fd_energy_grad, {n}q ({n_members} "
                           f"members)", fdw,
                           lambda: fd_energy_grad(*args, None, n_steps))
        da = rel_err(gf, adj)
        log(f"sampled: {n}q FD gradient, {n_members} members in {n_chunks} "
            f"chunk(s) of <= {chunk}: relative diff to the adjoint {da!r} "
            f"(bound {FD_ADJ_REL})")
        if not (torch.isfinite(gf).all() and da <= FD_ADJ_REL):
            fail(f"{n}q FD gradient disagrees with the adjoint")
    res = _counted_path(
        total, "train_energy mc, 20q, 3 epochs",
        {"k5_forward": 10, "k5_batched_forward": 3},
        lambda: train_energy(prob.ham, prob.envelope, prob.measurement,
                             prob.psi0, prob.T,
                             TrainConfig(n_epoch=3, grad_mode="mc",
                                         n_step=n_steps, lr=5e-2)))
    log(f"sampled: 20q train_energy 3 MC epochs, loss {res.losses_raw[0]!r}"
        f" -> {res.losses_raw[-1]!r}")
    if not np.all(np.isfinite(res.losses_raw)):
        fail("20q MC training gave non-finite losses")
    del res
    torch.cuda.empty_cache()

    # one MC sample at 24q: 96 branches in one batched K5 forward
    prob = frontier_problem(24)
    coeff = _coeff(prob.envelope.coeff_shape, 24)
    args = (prob.ham, prob.envelope, prob.measurement, coeff, prob.psi0,
            prob.T, None)
    s = torch.tensor(0.9, dtype=torch.float64, device=DEVICE)
    g = _counted_path(total, "mc_energy_grad, 24q, s=0.9, 30 steps",
                      {"k5_forward": 2, "k5_batched_forward": 1},
                      lambda: mc_energy_grad(*args, n_steps, s=s))
    torch.cuda.empty_cache()
    g4 = mc_energy_grad(*args, 4, s=s)
    torch.cuda.empty_cache()
    g4_e = eager_mc_sample(prob, coeff, s, 4)
    dg = rel_err(g4, g4_e)
    log(f"sampled: 24q MC sample (96 branches) finite "
        f"{bool(torch.isfinite(g).all())}; at 4 steps vs the eager engine "
        f"relative diff {dg!r} (bound {MC_EAGER_REL}); peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (torch.isfinite(g).all() and dg <= MC_EAGER_REL):
        fail("24q MC sample is not finite or disagrees with the eager engine")
    del g4_e
    torch.cuda.empty_cache()


# The molecule phase (the JAX package's molecule recipes). H2: the gap
# after the JAX test's 300 epochs (tests/test_molecule.py:66). The energy
# of the RHF determinant against E_RHF from rhf_scf, relative to |E_RHF|
# (float32 strings; the penalty vanishes there): an H100 run read 4.7e-8
# to 1.0e-7 at H4-H10, so the limit sits ~5x above. H6's sector FCI
# below RHF by tests/test_molecule.py:204's range. A resumed run against
# the straight one: bit-identical expected (K1's reruns are); else
# losses and coefficients within the atol. H10's directional derivative
# against central differences: CHANNEL_FD_REL of max(1, |fd|).
MOL_R = 0.9            # Angstrom: the JAX hydrogen-chain demo's spacing
MOL_H2_GAP = 1.6e-3
MOL_RHF_REL = 5e-7
MOL_CORR = (0.06, 0.11)
MOL_RESUME_ATOL = 1e-6
# From the recipe's start (the RHF determinant, coefficients 1e-3) Adam
# at lr 5e-2 first climbs off the RHF saddle (the CPU's H6 chain: -8.27,
# 1.84, 11.46 Ha in 3 epochs), so the single-state descent check at H10
# starts from the gradient check's point at a tenth of that rate.
MOL_DESCENT_LR = 5e-3
_MOLECULES = {}


def molecule_chain(atoms):
    """(problem, E_RHF electronic) of the JAX hydrogen-chain demo's chain
    of ``atoms`` atoms (R = 0.9 A, T = 5, n_basis 8,
    ``demos/demo_hydrogen_chain.py:81-85``) on the card, without its
    sector FCI, built once per run; logs the host's times."""
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.models import molecule
    if atoms not in _MOLECULES:
        coords = [(0.0, 0.0, MOL_R * i) for i in range(atoms)]
        t0 = time.perf_counter()
        p = molecule.build_hydrogen_cluster(coords, T=5.0, n_basis=8,
                                            compute_exact=False,
                                            device=DEVICE)
        t1 = time.perf_counter()
        centers = [np.asarray(c) * molecule.ANGSTROM_TO_BOHR
                   for c in coords]
        S, h, g, _ = molecule.cluster_integrals(centers)
        e_rhf, _ = molecule.rhf_scf(S, h, g, atoms // 2)
        engine = select_engine(p.ham) if p.ham.is_structured_only \
            else "dense"
        log(f"host: H{atoms} chain ({2 * atoms} qubits): "
            f"{len(p.terms)} Pauli terms, {p.ham.n_controls} drives, "
            f"engine {engine!r}; build {t1 - t0:.3f} s (integrals, RHF, "
            f"Jordan-Wigner, strings and drives on the card), integrals "
            f"and RHF again for E_RHF {time.perf_counter() - t1:.3f} s; "
            f"E_RHF (electronic) {e_rhf!r} Ha, E_nuc {p.e_nuc!r} Ha")
        _MOLECULES[atoms] = (p, e_rhf)
    return _MOLECULES[atoms]


def _mol_h2(total, card):
    """The JAX test's H2 recipe on dense 'expm' in float64 (no kernel)."""
    import torch
    from diffquantum_tpu_torch.models import molecule
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy
    p = molecule.build_h2_at(0.7414, dtype=torch.float64, device=DEVICE)
    cfg = TrainConfig(n_basis=6, n_epoch=300, lr=5e-2, grad_mode="adjoint",
                      dtype="float64", seed=0)
    t0 = time.perf_counter()
    res = _counted_path(
        total, "train_energy adjoint, H2 at 0.7414 A, float64, 300 epochs",
        {}, lambda: train_energy(p.ham, p.envelope, p.measurement, p.psi0,
                                 p.T, cfg, lam_min=p.exact_ground_energy))
    wall = time.perf_counter() - t0
    gap = res.losses_energy[-1]
    log(f"molecule: H2 at 0.7414 A ({len(p.terms)} strings, 14 drives, "
        f"'expm' d=16): gap to FCI {res.losses_energy[0]!r} -> {gap!r} Ha "
        f"after 300 epochs (limit {MOL_H2_GAP})")
    log(f"time: H2 300 float64 epochs {wall:.3f} s, "
        f"{wall / 300 * 1e3:.3f} ms an epoch [{card}]")
    if not (np.all(np.isfinite(res.losses_energy)) and gap < MOL_H2_GAP):
        fail("H2 did not reach chemical accuracy")


def _mol_rhf_energies():
    """E at the RHF determinant equals E_RHF at H4, H6 and H10."""
    import torch
    for atoms in (4, 6, 10):
        p, e_rhf = molecule_chain(atoms)
        with torch.no_grad():
            e = float(p.measurement.expectation(p.psi0))
        rel = abs(e - e_rhf) / abs(e_rhf)
        log(f"molecule: H{atoms} energy at the RHF determinant {e!r}, E_RHF "
            f"{e_rhf!r}, relative diff {rel!r} (limit {MOL_RHF_REL})")
        if not rel <= MOL_RHF_REL:
            fail(f"H{atoms}: the strings at the RHF determinant are not "
                 f"E_RHF")


def _mol_h4(total, card):
    """16 seeds of H4 under the cosine schedule, dense 'apply' (K7)."""
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    p, e_rhf = molecule_chain(4)
    n_steps = reference_n_steps(10, 0.0, p.T)
    n_seeds, epochs = 16, 10
    init = _coeff((n_seeds,) + p.envelope.coeff_shape, 4, scale=1e-3)
    cfg = TrainConfig(n_basis=8, n_epoch=epochs, lr=5e-2,
                      lr_schedule="cosine", t_sample="mid", backend="apply")
    launches = epochs * n_seeds * n_steps
    t0 = time.perf_counter()
    res = _counted_path(
        total, f"train_energy_seeds, H4 chain, {n_seeds} seeds, {epochs} "
        f"cosine epochs, 'apply'", {"k7_forward": launches,
                                    "k7_backward": launches},
        lambda: train_energy_seeds(p.ham, p.envelope, p.measurement,
                                   p.psi0, p.T, cfg, n_seeds=n_seeds,
                                   init_coeffs=init))
    wall = time.perf_counter() - t0
    best = res.losses.min(axis=1)
    log(f"molecule: H4 {n_seeds} seeds x {epochs} cosine epochs on K7, best "
        f"loss per epoch {best.tolist()}; E_RHF {e_rhf!r}, sector FCI "
        f"{p.exact_ground_energy!r} Ha")
    log(f"time: H4 {n_seeds}-seed epoch {wall / epochs * 1e3:.3f} ms "
        f"({epochs} epochs in one call; {n_seeds * n_steps} K7 forward and "
        f"backward launches at d=256, B=1 an epoch) [{card}]")
    if not (np.all(np.isfinite(res.losses)) and best[-1] < best[1]):
        fail("H4 seeds: losses not finite, or the best did not fall after "
             "the first update")


def _mol_h6(total, card):
    """H6 on K1/K2: the sector FCI on the card, one grad step against
    the eager engine and timed, 16 cosine seeds, checkpoint/resume."""
    import tempfile

    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import molecule
    from diffquantum_tpu_torch.parallel import train_energy_seeds
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy
    p, e_rhf = molecule_chain(6)
    n_steps = reference_n_steps(10, 0.0, p.T)
    if select_engine(p.ham) != "streamed" or n_steps != 60:
        fail(f"H6 routes to {select_engine(p.ham)!r} with {n_steps} steps")
    t0 = time.perf_counter()
    fci = molecule.sector_fci_from_strings(p.terms, 12, 6, device=DEVICE)
    t_fci = time.perf_counter() - t0
    corr = e_rhf - fci
    log(f"molecule: H6 sector FCI on the card (924 determinants x 4096 "
        f"amplitudes, float64) {fci!r} Ha, {corr!r} Ha below RHF (range "
        f"{MOL_CORR})")
    log(f"time: H6 sector FCI {t_fci:.3f} s [{card}]")
    if not MOL_CORR[0] < corr < MOL_CORR[1]:
        fail("H6 sector FCI is not a sensible correlation energy below RHF")
    args = (p.ham, p.envelope, p.measurement)
    coeff = _coeff(p.envelope.coeff_shape, 6, scale=0.3)
    kw = dict(t_sample="mid")
    val, grad = _counted_path(
        total, "energy_and_grad, H6 chain (60 steps)",
        {"k1_forward": 1, "k1_backward": 1},
        lambda: energy_and_grad(*args, coeff, p.psi0, p.T, n_steps, **kw))
    _eager_check("molecule: H6 grad step", p, coeff, n_steps, val, grad,
                 **kw)
    ms = cuda_ms(lambda: energy_and_grad(*args, coeff, p.psi0, p.T, n_steps,
                                         **kw), 5, warmup=1)
    log(f"time: H6 chain 60-step grad step {ms!r} ms ({len(p.terms)} "
        f"strings; CUDA events over 5 chained calls) [{card}]")

    n_seeds, epochs = 16, 20
    init = _coeff((n_seeds,) + p.envelope.coeff_shape, 6, scale=1e-3)
    cfg = TrainConfig(n_basis=8, n_epoch=epochs, lr=5e-2,
                      lr_schedule="cosine", t_sample="mid")
    t0 = time.perf_counter()
    res = _counted_path(
        total, f"train_energy_seeds, H6 chain, {n_seeds} seeds, {epochs} "
        f"cosine epochs", {"k2_forward": epochs, "k2_backward": epochs},
        lambda: train_energy_seeds(*args, p.psi0, p.T, cfg, n_seeds=n_seeds,
                                   init_coeffs=init))
    wall = time.perf_counter() - t0
    best = res.losses.min(axis=1)
    log(f"molecule: H6 {n_seeds} seeds x {epochs} cosine epochs on K2, best "
        f"loss per epoch {best.tolist()}; FCI {fci!r} Ha")
    log(f"time: H6 {n_seeds}-seed epoch {wall / epochs * 1e3:.3f} ms "
        f"({epochs} epochs in one call) [{card}]")
    if not (np.all(np.isfinite(res.losses)) and best[-1] < best[1]):
        fail("H6 seeds: losses not finite, or the best did not fall after "
             "the first update")

    # checkpoint/resume: 6 epochs straight against a run of the same
    # config stopped after epoch 3's checkpoint and resumed in a fresh call
    cfg = TrainConfig(n_basis=8, n_epoch=6, lr=5e-2, lr_schedule="cosine",
                      t_sample="mid")
    targs = (*args, p.psi0, p.T)
    straight = _counted_path(
        total, "train_energy, H6 chain, 6 cosine epochs",
        {"k1_forward": 7, "k1_backward": 6},
        lambda: train_energy(*targs, cfg))

    class Interrupt(Exception):
        pass

    def stop_after_3(epoch, **_):
        if epoch == 4:
            raise Interrupt

    def interrupted_and_resumed(ckpt):
        try:
            train_energy(*targs, cfg.replace(checkpoint_dir=ckpt,
                                             checkpoint_every=3),
                         callback=stop_after_3)
        except Interrupt:
            pass
        return train_energy(*targs, cfg.replace(checkpoint_dir=ckpt,
                                                checkpoint_every=3))
    with tempfile.TemporaryDirectory(prefix="dq_ckpt_") as ckpt:
        resumed = _counted_path(
            total, "train_energy, H6 chain, stopped after epoch 4 and "
            "resumed from epoch 3's checkpoint", {"k1_forward": 8,
                                                  "k1_backward": 7},
            lambda: interrupted_and_resumed(ckpt))
    same = (resumed.losses_raw == straight.losses_raw[3:]
            and bool(torch.equal(resumed.coeff, straight.coeff)))
    dl = float(np.abs(np.subtract(resumed.losses_raw,
                                  straight.losses_raw[3:])).max())
    dc = float((resumed.coeff - straight.coeff).abs().max())
    log(f"molecule: H6 resumed at epoch 4 vs straight: losses "
        f"{resumed.losses_raw} vs {straight.losses_raw[3:]}; bit-identical "
        f"{same}; max abs diff losses {dl!r}, coefficients {dc!r} (atol "
        f"{MOL_RESUME_ATOL})")
    if not (len(resumed.losses_raw) == 3 and dl <= MOL_RESUME_ATOL
            and dc <= MOL_RESUME_ATOL):
        fail("H6 resumed run differs from the straight run")


def _mol_energy_f64(p, c, n_steps):
    """The energy at coefficients ``c`` on the K6 state, measured in
    float64 on the normalised state (the f32 state's norm drift would
    otherwise reach central differences through the identity string)."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import evolve
    with torch.no_grad():
        psi = evolve(p.ham, p.envelope, c, p.psi0, 0.0, p.T, horizon=p.T,
                     n_steps=n_steps, t_sample="mid").astype(torch.float64)
        n2 = float((psi.re ** 2 + psi.im ** 2).sum())
        return float(p.measurement.strings.expectation(psi)) / n2


def _mol_h10(total, card):
    """H10 at 20 qubits on K6: the grad step, its K6 / strings split,
    central differences, and 3 cosine epochs."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import (evolve,
                                                           reference_n_steps)
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy
    p, e_rhf = molecule_chain(10)
    n_steps = reference_n_steps(10, 0.0, p.T)
    if select_engine(p.ham) != "mega_hop" or n_steps != 60:
        fail(f"H10 routes to {select_engine(p.ham)!r} with {n_steps} steps, "
             f"expected 'mega_hop' with 60")
    strings = p.measurement.strings
    args = (p.ham, p.envelope, p.measurement)
    coeff = _coeff(p.envelope.coeff_shape, 10, scale=0.3)

    def step():
        return energy_and_grad(*args, coeff, p.psi0, p.T, n_steps,
                               t_sample="mid")
    val, grad = _counted_path(total, "energy_and_grad, H10 chain (60 steps)",
                              {"k6_forward": 1, "k6_backward": 1}, step)
    direction = _coeff(p.envelope.coeff_shape, 110, scale=1.0)
    eps = 2e-3

    def central(h):
        return (_mol_energy_f64(p, coeff + h * direction, n_steps)
                - _mol_energy_f64(p, coeff - h * direction, n_steps)) / (2 * h)
    # Richardson's extrapolation of two central differences: along a
    # random direction of all 912 coefficients the energy is curved
    # enough that one central difference at eps 1e-3 is off by ~4e-3
    # relative (the H6 chain on the CPU, in float64 as in float32)
    fd = _counted_path(
        total, "central differences, H10 chain", {"k6_forward": 4},
        lambda: (4.0 * central(eps / 2) - central(eps)) / 3.0)
    an = float((grad * direction).sum())
    drel = abs(fd - an) / max(1.0, abs(fd))
    log(f"molecule: H10 grad step value {float(val)!r} Ha; directional "
        f"derivative {an!r}, central differences at eps {eps} and "
        f"{eps / 2} extrapolated (float64 energies of the normalised K6 "
        f"states) {fd!r}, relative diff {drel!r} (bound {CHANNEL_FD_REL}); "
        f"|grad| max {float(grad.abs().max())!r}")
    if not (torch.isfinite(grad).all() and drel <= CHANNEL_FD_REL):
        fail("H10 gradient disagrees with central differences")

    ms_step = cuda_ms(step, 3, warmup=1)
    with torch.no_grad():
        psi = evolve(p.ham, p.envelope, coeff, p.psi0, 0.0, p.T, horizon=p.T,
                     n_steps=n_steps, t_sample="mid")
        ms_fwd = cuda_ms(lambda: evolve(
            p.ham, p.envelope, coeff, p.psi0, 0.0, p.T, horizon=p.T,
            n_steps=n_steps, t_sample="mid"), 3, warmup=1)
        ms_exp = cuda_ms(lambda: strings.expectation(psi), 3, warmup=1)
        ms_vjp = cuda_ms(lambda: strings.apply(psi), 3, warmup=1)
    rest = ms_step - ms_fwd - ms_exp - ms_vjp
    masks = len(set(strings.flips))
    log(f"time: H10 chain 60-step grad step {ms_step!r} ms ({strings.n_terms}"
        f" strings, {masks} distinct flip masks; CUDA events over 3 chained "
        f"calls) [{card}]")
    log(f"time: H10 grad step split: K6 forward with its phase tables "
        f"{ms_fwd!r} ms, strings expectation {ms_exp!r} ms, strings VJP (M "
        f"psi) {ms_vjp!r} ms, the rest (K6 backward, the tables' VJP, "
        f"autograd) {rest!r} ms [{card}]")
    del psi
    cfg = TrainConfig(n_basis=8, n_epoch=3, lr=MOL_DESCENT_LR,
                      lr_schedule="cosine", t_sample="mid")
    res = _counted_path(
        total, "train_energy adjoint, H10 chain, 3 cosine epochs",
        {"k6_forward": 4, "k6_backward": 3},
        lambda: train_energy(*args, p.psi0, p.T, cfg, init_coeff=coeff))
    log(f"molecule: H10 3 cosine epochs (lr {MOL_DESCENT_LR}, from the "
        f"gradient check's coefficients), loss {res.losses_raw}, wall "
        f"{res.wall_s:.3f} s; E_RHF {e_rhf!r} Ha")
    if not (np.all(np.isfinite(res.losses_raw))
            and res.losses_raw[-1] < res.losses_raw[0]):
        fail("H10 loss did not fall")
    torch.cuda.empty_cache()


def phase_molecule(total):
    """Ab-initio hydrogen molecules through the entry points: H2 (dense
    'expm', float64), the energy at the RHF determinant at H4/H6/H10, H4
    seeds on K7, H6 on K1/K2 with checkpoint/resume, H10 on K6."""
    card = card_line()
    _mol_h2(total, card)
    _mol_rhf_energies()
    _mol_h4(total, card)
    _mol_h6(total, card)
    _mol_h10(total, card)


# --------------------------------------------------------------------------
# open-system dynamics (dynamics/lindblad.py), the adaptive-ODE engine and
# the product trajectory, at the JAX demo's sizes
# (demos/demo_open_control.py)
# --------------------------------------------------------------------------

# (a) 2000 trajectories against the master equation: 5 standard errors
# plus 0.01 for the O(dt) bias of the first-order jump rule at 30 steps;
# the float32 master equation against float64 on the card, rho atol.
OPEN_MC_SE, OPEN_MC_BIAS = 5.0, 0.01
OPEN_RHO_F64_ATOL = 1e-5
# (b) 'fused' (K2) against 'xla' on one set of draws: states and logps
# rtol/atol, the surrogate's gradient rtol, as tests/test_lindblad.py::
# test_structured_mcwf_fused_backend_matches_xla holds the JAX package.
OPEN_FUSED_RTOL, OPEN_FUSED_ATOL, OPEN_FUSED_GRAD_RTOL = 1e-4, 1e-5, 5e-3
# (c) the structured master equation against the dense one in float64 at
# 3 qubits and 400 steps (the O(dt^2) splitting difference), as
# tests/test_lindblad.py::test_lindblad_structured_matches_dense.
OPEN_SPLIT_ATOL = 5e-5
# (d) the dephasing trajectories' mean against the master equation
OPEN_DEPH_SE = 5.0
# (e) the dense MCWF on K7 against the same draws on the recurrence in
# float64, states atol; (f) the product trajectory's endpoint against K1,
# and every state's norm: over 1000 steps of 16 rotations and two phase
# products the eager engine's float32 rounding moves a norm by ~1e-4 (an
# H100 run read 8.8e-5 at 16q, where K1's own chain read 7.7e-6; on the
# CPU the eager chain read 5.6e-5 at 10q and 8.7e-5 at 12q, K1's plain
# version 5.2e-5 and 8.1e-5), so the limit sits ~2.3x above the card's
# reading; (g) the adaptive ODE against 'expm' at 2000 midpoint steps in
# float64.
OPEN_K7_F64_ATOL = 1e-5
OPEN_TRAJ_ATOL, OPEN_NORM_ATOL = 5e-5, 2e-4
OPEN_ODE_ATOL = 1e-5


def _allclose_excess(a, b, rtol, atol) -> float:
    """max(|a - b| - (atol + rtol |b|)): <= 0 where numpy's allclose
    holds."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def _timed(label, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"open: {label} took {time.perf_counter() - t0:.2f} s")
    return out


def _open_control(total, card):
    """(a) The JAX demo's act one: noise-blind (closed-system
    train_fidelity) against noise-aware (Adam through evolve_lindblad)
    control of a damped qubit, 300 epochs each; the final rho against
    float64; 2000 dense MCWF trajectories (K7, d = 2, B = 2000, one
    launch a step) against the master equation."""
    import torch
    from diffquantum_tpu_torch.dynamics.lindblad import (
        density_from_trajectories, evolve_lindblad, evolve_mcwf,
        expectation_rho)
    from diffquantum_tpu_torch.models import control
    from diffquantum_tpu_torch.ops import cpx
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.train import TrainConfig, train_fidelity
    ham, env, c, c64, T, n_steps = open_dense_problems()["qubit"]
    epochs, lr, n_traj = 300, 0.1, 2000
    psi0 = cpx.from_complex(np.array([1.0, 0.0]), device=DEVICE)
    rho0 = cpx.from_complex(np.array([[1.0, 0.0], [0.0, 0.0]]),
                            device=DEVICE)
    target = np.array([0.0, 1.0])  # <1|rho|1>

    def open_infidelity(coeff, h=ham, cs=c, r0=rho0):
        rho = evolve_lindblad(h, env, coeff, r0, cs, 0.0, T, horizon=T,
                              n_steps=n_steps)
        return 1.0 - expectation_rho(target, rho), rho

    def train():
        cfg = TrainConfig(n_basis=6, n_epoch=epochs, lr=lr,
                          grad_mode="adjoint", seed=0)
        blind = train_fidelity(
            ham, env, CP(psi0.re[None], psi0.im[None]),
            cpx.from_complex(np.array([[0.0, 1.0]]), device=DEVICE), T,
            cfg).coeff.detach()
        coeff = env.init_coeff(torch.Generator().manual_seed(0), scale=1.0,
                               device=DEVICE).requires_grad_(True)
        opt = torch.optim.Adam([coeff], lr=lr)
        for _ in range(epochs):
            opt.zero_grad()
            open_infidelity(coeff)[0].backward()
            opt.step()
        return blind, coeff.detach()

    # train_fidelity's epochs run 'expm' (d = 2, one state); its final
    # states, the [1, d] pair batch, take 'apply': K7, one launch a step
    blind, aware = _timed("(a) noise-blind + noise-aware training", lambda:
                          _counted_path(total, "open (a): 300 noise-blind "
                                        "epochs ('expm') + 300 noise-aware "
                                        "epochs (evolve_lindblad)",
                                        {"k7_forward": n_steps}, train))
    with torch.no_grad():
        f_blind = 1.0 - float(open_infidelity(blind)[0])
        inf_aware, rho = open_infidelity(aware)
        f_aware = 1.0 - float(inf_aware)
        ham64 = control.single_qubit_controls(
            detuning=0.5, dtype=torch.float64, device=DEVICE)[0]
        rho64 = open_infidelity(aware.double(), ham64, c64,
                                rho0.astype(torch.float64))[1]
    err64 = max(float((rho.re.double() - rho64.re).abs().max()),
                float((rho.im.double() - rho64.im).abs().max()))
    log(f"open (a): gamma 0.15, T = {T}: open-system fidelity noise-blind "
        f"{f_blind!r}, noise-aware {f_aware!r} (advantage "
        f"{f_aware - f_blind:+.4f}); rho(T) against float64 max abs "
        f"{err64!r} (atol {OPEN_RHO_F64_ATOL})")
    if not f_aware > f_blind:
        fail("open (a): the noise-aware pulse does not beat the noise-blind "
             "one under decoherence")
    if not err64 <= OPEN_RHO_F64_ATOL:
        fail(f"open (a): float32 evolve_lindblad differs from float64 by "
             f"{err64} (atol {OPEN_RHO_F64_ATOL})")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    psis = _timed("(a) 2000 MCWF trajectories", lambda: _counted_path(
        total, "open (a): evolve_mcwf, 2000 trajectories x 30 steps (K7 at "
        "d=2, B=2000)", {"k7_forward": n_steps},
        lambda: evolve_mcwf(ham, env, aware, psi0, c, 0.0, T, horizon=T,
                            n_steps=n_steps, generator=gen, n_traj=n_traj)))
    p1 = (psis.re[:, 1] ** 2 + psis.im[:, 1] ** 2).double()
    f_mc, se = float(p1.mean()), float(p1.std() / np.sqrt(n_traj))
    f_rho = float(expectation_rho(target, density_from_trajectories(psis)))
    lim = float(OPEN_MC_SE * se + OPEN_MC_BIAS)
    log(f"open (a): MCWF fidelity {f_mc!r} (standard error {se!r}; from "
        f"the trajectories' rho {f_rho!r}) against the master equation "
        f"{f_aware!r}: diff {abs(f_mc - f_aware)!r} (limit {lim!r})")
    if not (np.isfinite(f_mc) and abs(f_mc - f_aware) <= lim
            and abs(f_rho - f_mc) < 1e-5):
        fail("open (a): the MCWF trajectories disagree with the master "
             "equation")


def _open_mcwf_maxcut(total, card, sizes=(16, 17), trajs=(8, 128)):
    """(b) The demo's act two, ``--mcwf-scale 16 --mcwf-backend fused``:
    T1-aware MaxCut training at 16 qubits through score_surrogate on K2
    (one forward and one adjoint launch a step); 'fused' against 'xla' on
    one set of draws; 4 Adam steps on fixed draws; 17 qubits; the epoch's
    time at 8 and 128 trajectories."""
    import torch
    from diffquantum_tpu_torch.dynamics.lindblad import (
        StructuredNoise, draw_mcwf, evolve_mcwf_structured, score_surrogate)
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.ops import cpx
    n_steps, n_traj, epochs, lr = 10, trajs[0], 30, 5e-2
    n, top_n = sizes
    probs = {m: maxcut.build_maxcut(m, maxcut.ring_graph(m), n_basis=4,
                                    dense=False, device=DEVICE)
             for m in sizes}
    noise = {m: StructuredNoise(m, t1=[(q, 0.1) for q in range(m)])
             for m in probs}
    prob = probs[n]
    T = float(prob.T)

    def loss(cc, n=n, backend="fused", draws=None, gen=None, traj=n_traj):
        p = probs[n]
        psis, logps = evolve_mcwf_structured(
            p.ham, p.envelope, cc, p.psi0, noise[n], 0.0, T, horizon=T,
            n_steps=n_steps, generator=gen, n_traj=traj, return_logp=True,
            backend=backend, draws=draws)
        vals = torch.sum(cpx.abs2(psis) * p.measurement.diag, dim=-1)
        return score_surrogate(vals, logps), psis, logps

    k2 = lambda k: {"k2_forward": k, "k2_backward": k}  # noqa: E731
    cc = _coeff(prob.envelope.coeff_shape, n, scale=0.3).requires_grad_(True)
    draws = draw_mcwf(torch.Generator(device=DEVICE).manual_seed(9), n_steps,
                      n_traj, n)
    runs = {}
    for backend, want in (("fused", k2(n_steps)), ("xla", {})):
        def run(backend=backend):
            v, ps, lp = loss(cc, backend=backend, draws=draws)
            return v, ps, lp, torch.autograd.grad(v, cc)[0]
        runs[backend] = _counted_path(
            total, f"open (b): {n}q score-surrogate value and gradient, "
            f"'{backend}', {n_traj} trajectories x 10 steps", want, run)
    (vf, psf, lpf, gf), (vx, psx, lpx, gx) = runs["fused"], runs["xla"]
    ex = max(_allclose_excess(a.detach(), b.detach(), OPEN_FUSED_RTOL,
                              OPEN_FUSED_ATOL)
             for a, b in ((psf.re, psx.re), (psf.im, psx.im), (lpf, lpx)))
    exg = _allclose_excess(gf, gx, OPEN_FUSED_GRAD_RTOL, OPEN_FUSED_ATOL)
    jumps = int((lpx.detach() - lpx.detach().max()).abs().gt(1e-3).sum())
    log(f"open (b): {n}q 'fused' against 'xla' (one set of draws, {jumps} "
        f"of {n_traj} trajectories off the likeliest path): value "
        f"{vf.item()!r} vs {vx.item()!r}; states and logps excess over rtol "
        f"{OPEN_FUSED_RTOL} / atol {OPEN_FUSED_ATOL}: {ex!r}; gradient "
        f"excess over rtol {OPEN_FUSED_GRAD_RTOL}: {exg!r}; gradient max "
        f"rel diff {rel_err(gf, gx)!r}")
    if not (ex <= 0 and exg <= 0 and torch.isfinite(gf).all()):
        fail("open (b): the 'fused' MCWF (K2) disagrees with 'xla'")

    def crn():  # common random numbers: the same draws every step
        c = cc.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=lr)
        losses = []
        for _ in range(4):
            opt.zero_grad()
            v = loss(c, draws=draws)[0]
            v.backward()
            opt.step()
            losses.append(v.item())
        with torch.no_grad():
            losses.append(loss(c, draws=draws)[0].item())
        return losses
    losses = _counted_path(total, "open (b): 4 Adam steps on fixed draws",
                           {"k2_forward": 5 * n_steps,
                            "k2_backward": 4 * n_steps}, crn)
    log(f"open (b): fixed draws, loss over 4 Adam steps {losses!r}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("open (b): 4 Adam steps on fixed draws did not lower the "
             "surrogate")

    def train(traj=n_traj, n_epochs=epochs, seed=7):
        c = prob.envelope.init_coeff(torch.Generator().manual_seed(0),
                                     scale=0.3, device=DEVICE)
        c.requires_grad_(True)
        opt = torch.optim.Adam([c], lr=lr)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        vals = []
        for _ in range(n_epochs):
            opt.zero_grad()
            v = loss(c, gen=gen, traj=traj)[0]
            v.backward()
            opt.step()
            vals.append(v.detach())
        return [float(v) for v in vals], c.detach()
    t0 = time.perf_counter()
    vals, c_end = _counted_path(
        total, f"open (b): 30 epochs of T1-aware training, {n}q, {n_traj} "
        "trajectories x 10 steps", k2(epochs * n_steps), train)
    wall = time.perf_counter() - t0
    log(f"open (b): noisy MaxCut energy first {vals[0]!r} -> last "
        f"{vals[-1]!r} (T1 gamma 0.1 on every qubit; 30 epochs in {wall:.2f} "
        f"s)")
    if not (np.all(np.isfinite(vals)) and torch.isfinite(c_end).all()):
        fail("open (b): T1-aware training gave non-finite values")

    c17 = _coeff(probs[top_n].envelope.coeff_shape, top_n, scale=0.3)
    c17.requires_grad_(True)

    def top():
        v = loss(c17, n=top_n,
                 gen=torch.Generator(device=DEVICE).manual_seed(3))
        return v[0], torch.autograd.grad(v[0], c17)[0]
    v17, g17 = _counted_path(total, f"open (b): {top_n}q value and gradient "
                             "(the top of K2's band)", k2(n_steps), top)
    log(f"open (b): {top_n}q surrogate {v17.item()!r}, gradient max-norm "
        f"{float(g17.abs().max())!r}")
    if not (torch.isfinite(v17) and torch.isfinite(g17).all()):
        fail(f"open (b): the {top_n}q step is not finite")
    for traj in trajs:
        ms = cuda_ms(lambda: train(traj, 1, seed=11), 3, warmup=1)
        log(f"time: open (b) {n}q T1-aware epoch, {traj} trajectories x 10 "
            f"steps (K2 forward + adjoint a step, jump logic, Adam) {ms!r} "
            f"ms [{card}]")


def open_structured_problem(n, dtype, seed, t1=True):
    """The JAX tests' driven noisy system (tests/test_lindblad.py::
    _structured_noisy_problem): a ZZ chain, X on every qubit, a drift
    0.3 j / d, T1 0.35 on qubit 0 and dephasing 0.4 on the last; the
    coefficients from ``seed``."""
    import torch
    from diffquantum_tpu_torch.dynamics.hamiltonian import (
        ControlledHamiltonian, TermStructure)
    from diffquantum_tpu_torch.dynamics.lindblad import StructuredNoise
    from diffquantum_tpu_torch.ops import linalg
    from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
    d = 2**n
    st = [TermStructure(kind="diag", diag=linalg.zz_diagonal(n, i, i + 1))
          for i in range(n - 1)]
    st += [TermStructure(kind="1q", qubit=q, local=linalg.X)
           for q in range(n)]
    ham = ControlledHamiltonian.create_structured(
        d, tuple(st), h0_structure=TermStructure(
            kind="diag", diag=0.3 * np.arange(d) / d), dtype=dtype)
    env = SimpleEnvelope(basis="bspline", n_basis=4,
                         omegas=(np.pi,) * len(st))
    coeff = torch.tensor(0.5 * np.random.default_rng(seed).standard_normal(
        env.coeff_shape), dtype=dtype, device=DEVICE)
    noise = StructuredNoise(n, t1=[(0, 0.35)] if t1 else [],
                            dephasing=[(n - 1, 0.4)])
    return ham, env, coeff, noise


def _open_structured(total, card, sizes=(12, 14)):
    """(c) evolve_lindblad_structured: 4 Adam evaluations at 12 qubits
    (rho 128 MiB), one forward and backward at 14 (rho 2 GiB) with its
    peak memory, and 3 qubits against the dense engine in float64."""
    import torch
    from diffquantum_tpu_torch.dynamics.hamiltonian import \
        ControlledHamiltonian
    from diffquantum_tpu_torch.dynamics.lindblad import (
        CollapseSet, evolve_lindblad, evolve_lindblad_structured,
        expectation_rho)
    from diffquantum_tpu_torch.ops import linalg
    from diffquantum_tpu_torch.ops.cpx import CP
    T, n_steps = 0.8, 8

    def setup(n):
        ham, env, coeff, noise = open_structured_problem(n, torch.float32,
                                                         seed=5)
        d = 2**n
        rho0 = CP(torch.full((d, d), 1.0 / d, device=DEVICE),
                  torch.zeros((d, d), device=DEVICE))
        w = torch.cos(torch.linspace(0, 7, d, device=DEVICE))
        run = lambda cc: expectation_rho(w, evolve_lindblad_structured(  # noqa
            ham, env, cc, rho0, noise, 0.0, T, horizon=T, n_steps=n_steps))
        return coeff, run

    coeff, run = setup(sizes[0])

    def adam():
        c = coeff.clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=5e-2)
        losses = []
        for _ in range(4):
            opt.zero_grad()
            v = run(c)
            v.backward()
            opt.step()
            losses.append(v.item())
        return losses
    t0 = time.perf_counter()
    losses = _counted_path(total, f"open (c): {sizes[0]}q structured master "
                           "equation, 4 Adam evaluations", {}, adam)
    ms = (time.perf_counter() - t0) / 4 * 1e3
    log(f"open (c): {sizes[0]}q losses {losses!r}")
    log(f"time: open (c) {sizes[0]}q structured master-equation epoch (8 "
        f"steps, "
        f"forward + backward + Adam) {ms:.3f} ms (host clock over 4) "
        f"[{card}]")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("open (c): the noisy objective did not fall")
    del run
    coeff, run = setup(sizes[1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fwd_bwd():
        c = coeff.clone().requires_grad_(True)
        v = run(c)
        return v.detach(), torch.autograd.grad(v, c)[0]
    t0 = time.perf_counter()
    v14, g14 = _counted_path(total, f"open (c): {sizes[1]}q forward and "
                             "backward", {}, fwd_bwd)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"open (c): {sizes[1]}q value {float(v14)!r}, gradient max-norm "
        f"{float(g14.abs().max())!r}")
    log(f"time: open (c) {sizes[1]}q structured master equation forward + "
        f"backward (8 steps, rho {2 * 4**sizes[1] * 4 / 2**30:.3f} GiB) "
        f"{wall * 1e3:.3f} ms, peak memory {peak:.2f} GiB [{card}]")
    if not (torch.isfinite(v14) and torch.isfinite(g14).all()):
        fail(f"open (c): the {sizes[1]}q step is not finite")
    del run
    torch.cuda.empty_cache()

    f64 = torch.float64
    ham, env, coeff, noise = open_structured_problem(3, f64, seed=2)
    hs = [np.diag(st.diag) if st.kind == "diag" else
          linalg.op_on_qubits(st.local, [st.qubit], 3)
          for st in ham.structure]
    dense = ControlledHamiltonian.create(np.diag(ham.h0_structure.diag), hs,
                                         dtype=f64, device=DEVICE)
    cs = CollapseSet.create(noise.dense_collapse_ops(), dtype=f64,
                            device=DEVICE)
    psi = np.zeros(8)
    psi[5] = 1.0
    rho0 = CP(torch.tensor(np.outer(psi, psi), dtype=f64, device=DEVICE),
              torch.zeros((8, 8), dtype=f64, device=DEVICE))
    kw = dict(horizon=1.2, n_steps=400)

    def both():
        return (evolve_lindblad(dense, env, coeff, rho0, cs, 0.0, 1.2, **kw),
                evolve_lindblad_structured(ham, env, coeff, rho0, noise, 0.0,
                                           1.2, **kw))
    want, got = _counted_path(total, "open (c): 3q structured against dense, "
                              "float64, 400 steps", {}, both)
    err = max(float((got.re - want.re).abs().max()),
              float((got.im - want.im).abs().max()))
    tr = float(torch.diagonal(got.re).sum())
    log(f"open (c): 3q structured against dense max abs {err!r} (atol "
        f"{OPEN_SPLIT_ATOL}); trace {tr!r}")
    if not (err <= OPEN_SPLIT_ATOL and abs(tr - 1.0) < 1e-8):
        fail("open (c): the structured master equation disagrees with the "
             "dense one at 3 qubits")


def _open_dephasing(total, card, n=12):
    """(d) 256 dephasing trajectories of the 12q ring (dephasing 0.2 on
    every qubit, 30 steps): their mean cost within 5 standard errors of
    evolve_lindblad_structured on the same noise."""
    import torch
    from diffquantum_tpu_torch.dynamics.lindblad import (
        StructuredNoise, evolve_dephasing_trajectories,
        evolve_lindblad_structured, expectation_rho)
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6,
                               dense=False, device=DEVICE)
    d, n_traj, n_steps = 2**n, 256, 30
    T = float(prob.T)
    noise = StructuredNoise(n, dephasing=[(q, 0.2) for q in range(n)])
    coeff = _coeff(prob.envelope.coeff_shape, n)
    w = prob.measurement.diag
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rho0 = CP(torch.full((d, d), 1.0 / d, device=DEVICE),
              torch.zeros((d, d), device=DEVICE))

    def both():
        with torch.no_grad():
            psis = evolve_dephasing_trajectories(
                prob.ham, prob.envelope, coeff, prob.psi0, noise, 0.0, T,
                horizon=T, n_steps=n_steps, generator=gen, n_traj=n_traj)
            rho = evolve_lindblad_structured(
                prob.ham, prob.envelope, coeff, rho0, noise, 0.0, T,
                horizon=T, n_steps=n_steps)
        return psis, float(expectation_rho(prob.measurement, rho))
    psis, e_rho = _counted_path(total, f"open (d): {n}q dephasing "
                                "trajectories and master equation", {}, both)
    vals = torch.sum((psis.re ** 2 + psis.im ** 2) * w, dim=-1).double()
    mean, se = float(vals.mean()), float(vals.std() / np.sqrt(n_traj))
    log(f"open (d): {n}q mean cost over {n_traj} dephasing trajectories "
        f"{mean!r} (standard error {se!r}) against the master equation "
        f"{e_rho!r}: diff {abs(mean - e_rho)!r}")
    if not (np.isfinite(mean) and abs(mean - e_rho) <= OPEN_DEPH_SE * se):
        fail("open (d): the dephasing trajectories disagree with the master "
             "equation")


def _open_dense_mcwf(total, card):
    """(e) The dense MCWF on the 10q ring, T1 0.1 on every qubit, 64
    trajectories x 30 steps: K7 at d = 1024, B = 64 on M_eff, one launch
    a step; the same draws on the recurrence in float64."""
    import dataclasses

    import torch
    from diffquantum_tpu_torch.dynamics.lindblad import draw_mcwf, evolve_mcwf
    ham, env, c, c64, T, n_steps = open_dense_problems()["ring_t1"]
    n_traj = 64
    psi0 = dense_problems()["ring"].psi0
    coeff = _coeff(env.coeff_shape, 10)
    draws = draw_mcwf(torch.Generator(device=DEVICE).manual_seed(5), n_steps,
                      n_traj, c.ops.re.shape[0])
    f64 = torch.float64
    ham64 = dataclasses.replace(ham, dtype=f64, H0=ham.H0.astype(f64),
                                Hs=ham.Hs.astype(f64))

    def run(h, cs, cc, p0):
        with torch.no_grad():
            return evolve_mcwf(h, env, cc, p0, cs, 0.0, T, horizon=T,
                               n_steps=n_steps, n_traj=n_traj, draws=draws)
    got = _timed("(e) 64 trajectories on K7", lambda: _counted_path(
        total, "open (e): evolve_mcwf, 10q ring, 64 trajectories x 30 steps "
        "(K7 at d=1024, B=64)", {"k7_forward": n_steps},
        lambda: run(ham, c, coeff, psi0)))
    want = _counted_path(total, "open (e): the same draws in float64 (the "
                         "recurrence)", {"apply_recurrence": n_steps},
                         lambda: run(ham64, c64, coeff.double(),
                                     psi0.astype(f64)))
    err = max(float((got.re.double() - want.re).abs().max()),
              float((got.im.double() - want.im).abs().max()))
    apart = int(((got.re - got.re[:1]).abs().amax(-1) > 1e-3).sum())
    log(f"open (e): K7 against float64 max abs {err!r} (atol "
        f"{OPEN_K7_F64_ATOL}); {apart} of {n_traj} trajectories end apart "
        f"from the first (the jumps)")
    if not err <= OPEN_K7_F64_ATOL:
        fail("open (e): the dense MCWF on K7 disagrees with float64")


def _open_trajectory(total, card, n=16, n_steps=1000):
    """(f) evolve_product_trajectory on the 16q ring, 1000 steps (1001
    states, 0.5 GB): the endpoint against evolve_product_fused (K1) and
    every state's norm."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import (
        evolve_product_fused, evolve_product_trajectory)
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6,
                               device=DEVICE)
    coeff = _coeff(prob.envelope.coeff_shape, n)
    args = (prob.ham, prob.envelope, coeff, prob.psi0, 0.0, prob.T)
    kw = dict(horizon=prob.T, n_steps=n_steps)
    with torch.no_grad():
        t0 = time.perf_counter()
        traj = _counted_path(total, f"open (f): {n}q product trajectory, "
                             f"{n_steps} steps", {},
                             lambda: evolve_product_trajectory(*args, **kw))
        wall = time.perf_counter() - t0
        ref = _counted_path(total, "open (f): its reference on K1",
                            {"k1_forward": 1},
                            lambda: evolve_product_fused(*args, **kw))
    err = max(float((traj.re[-1] - ref.re).abs().max()),
              float((traj.im[-1] - ref.im).abs().max()))
    norms = (traj.re.double() ** 2 + traj.im.double() ** 2).sum(-1)
    dn = float((norms - 1.0).abs().max())
    dk = abs(float((ref.re.double() ** 2 + ref.im.double() ** 2).sum()) - 1)
    log(f"open (f): {tuple(traj.shape)} states; endpoint against K1 max abs "
        f"{err!r} (atol {OPEN_TRAJ_ATOL}); norms within {dn!r} of 1 (atol "
        f"{OPEN_NORM_ATOL}; K1's endpoint {dk!r})")
    log(f"time: open (f) {n}q product trajectory, {n_steps} steps, eager "
        f"engine {wall * 1e3:.3f} ms [{card}]")
    if not (err <= OPEN_TRAJ_ATOL and dn <= OPEN_NORM_ATOL):
        fail("open (f): the product trajectory disagrees with K1 or loses "
             "norm")


def _open_ode(total, card):
    """(g) evolve_ode (scipy DOP853 on the host) on the 4q dense ring
    against 'expm' at 2000 midpoint steps, float64 on the card."""
    import torch
    from diffquantum_tpu_torch.dynamics.ode import evolve_ode
    from diffquantum_tpu_torch.dynamics.propagator import evolve
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(4, maxcut.ring_graph(4), n_basis=4,
                               dense=True, dtype=torch.float64, device=DEVICE)
    coeff = torch.tensor(0.5 * np.random.default_rng(3).standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float64, device=DEVICE)
    args = (prob.ham, prob.envelope, coeff, prob.psi0, 0.0, prob.T)
    t0 = time.perf_counter()
    ode = evolve_ode(*args, horizon=prob.T)
    wall = time.perf_counter() - t0
    ref = _counted_path(total, "open (g): 'expm', 2000 midpoint steps", {},
                        lambda: evolve(*args, horizon=prob.T, n_steps=2000,
                                       backend="expm", t_sample="mid"))
    err = max(float((ode.re - ref.re).abs().max()),
              float((ode.im - ref.im).abs().max()))
    log(f"open (g): evolve_ode ({wall:.2f} s on the host) against 'expm' "
        f"at 2000 midpoint steps max abs {err!r} (atol {OPEN_ODE_ATOL}); "
        f"result on {ode.re.device} in {ode.re.dtype}")
    if not (err <= OPEN_ODE_ATOL and ode.re.is_cuda):
        fail("open (g): evolve_ode disagrees with the fine trotter chain")


def _open_k2_times(card):
    """K2 at the 'fused' MCWF step's shape (T = 1, one zero phase row and
    one angle row, B = 8 at 16 qubits) beside its plain version and
    bound."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    n, b = 16, 8
    d = 2**n
    prob, _, tx, qubits, kinds = maxcut_chain(n, 1, seed=n, members=1)
    th = torch.zeros((1, 1, d), dtype=torch.float32, device=DEVICE)
    psi = _random_cp(np.random.default_rng(16), (b, d), 1.0 / np.sqrt(2 * d))
    plan = tfp._plan_ops(qubits, kinds, n)
    with torch.no_grad():
        out = tfp.fused_product_evolve_batched(psi, th, tx, qubits, n, kinds)
    w = prob.measurement.diag
    lam = type(out)(2.0 * w * out.re, 2.0 * w * out.im)
    runs = {
        "forward": (lambda: tfp._forward_cuda(psi.re, psi.im, th, tx, plan,
                                              n),
                    lambda: tfp.fused_product_evolve_batched_plain(
                        psi, th, tx, qubits, n, kinds)),
        "backward": (lambda: tfp._backward_cuda(out.re, out.im, lam.re,
                                                lam.im, th, tx, plan, n),
                     lambda: tfp._adjoint_batched_plain(
                         out, lam, th, tx, qubits, n, kinds)),
    }
    for part, (kfn, pfn) in runs.items():
        ms, plain_ms = cuda_ms(kfn, 200), cuda_ms(pfn, 5, 1)
        bound = chain_bound(d, 1, kinds, part == "backward", members=b,
                            rows=1)
        log(f"time: k2_{part} [open (b): 16q T=1, B=8 on one zero phase row "
            f"and one angle row] {ms!r} ms/launch, plain version "
            f"{plain_ms!r} ms, bound {bound[0]!r} ms ({bound[1]}) [{card}]")


def phase_open(total):
    """Open-system dynamics, the adaptive-ODE engine and the product
    trajectory through the entry points, at the JAX demo's sizes: (a) the
    damped qubit's noise-aware control and its 2000 MCWF trajectories (K7
    only), (b) T1-aware MaxCut at 16-17 qubits on K2 only, (c) the
    structured master equation at 12, 14 and 3 qubits, (d) dephasing
    trajectories at 12 (no kernel), (e) the dense MCWF at 10 qubits (K7
    only), (f) the 16q product trajectory (K1 only, its reference), (g)
    evolve_ode at 4 qubits (no kernel)."""
    card = card_line()
    for part in (_open_control, _open_mcwf_maxcut, _open_structured,
                 _open_dephasing, _open_dense_mcwf, _open_trajectory,
                 _open_ode):
        t0 = time.perf_counter()
        part(total, card)
        log(f"open: {part.__name__} took {time.perf_counter() - t0:.1f} s")
    _open_k2_times(card)


COMPAT_NATIVE_ATOL = 1e-9  # diffqc (float64, card) against the native engine
COMPAT_HOST_REL = 1e-9     # host algorithms: card against CPU, same draws
COMPAT_VQE_MHA = 1.6       # chemical accuracy, the VQE demo's healthy line


def _compat_ring_ops(n):
    """The ring MaxCut's dense operators on the host: H0 = 0, ZZ on every
    edge and X on every qubit (the 10q dense ring's 20 controls)."""
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.ops import linalg
    hs = [np.diag(linalg.zz_diagonal(n, i, j)).astype(np.complex128)
          for i, j in maxcut.ring_graph(n)]
    hs += [linalg.op_on_qubits(linalg.X, [q], n) for q in range(n)]
    return np.zeros((2**n, 2**n), np.complex128), hs


def _compat_diffqc(total, card, tmp):
    """(a) ``diffqc.set_H`` / ``trotter`` on the card in float64 against
    the port's native C++ engine, built here on the host: the JAX tests'
    2-qubit three-channel system at func_type 0 and 1, and the 10q dense
    ring with one carrier channel a control (per_step 10, T = 2: 30
    steps; the plain recurrence from d = 512, so no K7)."""
    from diffquantum_tpu_torch.compat import diffqc
    from diffquantum_tpu_torch.native import bindings
    from diffquantum_tpu_torch.ops import linalg
    t0 = time.perf_counter()
    lib = bindings.build()
    native = bindings.NativeSystem()
    log(f"compat (a): native engine {lib.name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (version {bindings.version()})")
    rng = np.random.default_rng(0)
    two = (0.2 * linalg.pauli_string("ZI"),
           [linalg.pauli_string("XI"), linalg.pauli_string("IX")],
           [[[0.0, np.pi, 5.0, 0], [0.0, 0.5 * np.pi, 9.0, 1]],
            [[0.0, np.pi, 4.0, 2]]], 2.0, rng.standard_normal((2, 3, 5)) * 0.7,
           linalg.uniform_superposition(2))
    h0, hs = _compat_ring_ops(10)
    ring = (h0, hs, [[[0.0, np.pi, 0.3 * k, k]] for k in range(len(hs))], 2.0,
            0.5 * rng.standard_normal((2, len(hs), 6)),
            linalg.uniform_superposition(10))
    for label, system, func_type, want in (
            ("2q three-channel", two, 0, {}),
            ("2q three-channel", two, 1, {}),
            ("10q dense ring, 20 channels", ring, 1,
             {"apply_recurrence": 30})):
        H0, Hs, channels, duration, vv, psi0 = system
        diffqc.set_H(H0, Hs, channels, duration, func_type, device=DEVICE)
        t0 = time.perf_counter()
        got = np.asarray(_counted_path(
            total, f"compat (a): diffqc.trotter, {label}, func_type "
            f"{func_type}", want, lambda: diffqc.trotter(
                psi0, 0.0, duration, 10, vv)))
        t_card = time.perf_counter() - t0
        native.set_system(H0, Hs, [(h,) + tuple(r[1:]) for h, rows in
                                   enumerate(channels) for r in rows],
                          duration, func_type)
        t0 = time.perf_counter()
        ref = native.trotter(psi0, 0.0, duration, 10, vv)
        t_native = time.perf_counter() - t0
        err = float(np.abs(got - ref).max())
        log(f"compat (a): {label}, func_type {func_type}: diffqc on the card "
            f"against the native engine max abs {err!r} (atol "
            f"{COMPAT_NATIVE_ATOL}); norm {float(np.linalg.norm(got))!r}")
        if not (np.all(np.isfinite(got)) and err <= COMPAT_NATIVE_ATOL):
            fail(f"compat (a): diffqc.trotter ({label}) disagrees with the "
                 f"native engine")
    log(f"time: compat (a) 10q diffqc.trotter float64, 30 steps: on the card "
        f"{t_card * 1e3:.1f} ms (first call, host table build included); "
        f"native engine on the host {t_native * 1e3:.1f} ms [{card}]")
    t0 = time.perf_counter()
    diffqc.trotter(psi0, 0.0, duration, 10, vv)
    log(f"time: compat (a) 10q diffqc.trotter float64, second call "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")


def _facade(tmp, **kw):
    """A SimulatorPlain on the card (its logger's echo kept out of this
    script's output)."""
    from diffquantum_tpu_torch.compat import SimulatorPlain
    return _quiet(lambda: SimulatorPlain(log_dir=tmp, **kw))[0]


def _compat_reference_demo(tmp):
    """The reference's demo_maxcut.py through the facade, line for line
    (SURVEY.md 3.1, C17): returns (sim, H_cost, H0, Hs, superposition)."""
    from diffquantum_tpu_torch.ops import linalg
    sim = _facade(tmp, lr=2e-2, n_basis=6, n_epoch=202, device=DEVICE)
    n_qubit = 4
    graph = [[0, 1], [0, 3], [1, 2], [2, 3]]
    I, Z, X = linalg.I2, linalg.Z, linalg.X
    II = sim.multi_kron(*[I] * n_qubit)
    H_cost = II * 0.0
    sim.Pauli_M = []
    for e in graph:
        curr = sim.multi_kron(*[Z if j in e else I for j in range(n_qubit)])
        evals, estates = np.linalg.eigh(curr)
        sim.Pauli_M.append([curr, 0.5, (evals, list(estates.T))])
        H_cost = H_cost + II - curr
    H_cost = -H_cost * 0.5
    evals, estates = np.linalg.eigh(II)
    sim.Pauli_M.append([II, -0.5 * len(graph), (evals, list(estates.T))])
    omega0 = omega1 = np.pi
    Hs, omegas = [], []
    for e in graph:
        Hs.append(sim.multi_kron(*[Z if j in e else I
                                   for j in range(n_qubit)]))
        omegas.append(omega0)
    for q in range(n_qubit):
        Hs.append(sim.multi_kron(*[X if j == q else I
                                   for j in range(n_qubit)]))
        omegas.append(omega1)
    sim.omegas = omegas
    sim.T = np.pi * (1.0 / omega0 + 1.0 / omega1)
    superposition = linalg.uniform_superposition(n_qubit)
    return sim, H_cost, II * 0.0, Hs, superposition, graph


def _cut(graph, state, n):
    return float(sum(((state >> (n - 1 - i)) & 1) != ((state >> (n - 1 - j))
                                                      & 1) for i, j in graph))


def _quiet(fn):
    """fn() with its standard output (the loggers' epoch lines) kept out
    of this script's."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _compat_facade(total, card, tmp):
    """(b)-(d): the reference demo through SimulatorPlain (202 MC epochs,
    K7 on the 16 branches), the facade at full width (the 10q dense ring,
    3 epochs, K7 at d = 1024, B = 40), train_fidelity and
    train_energy_FD."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.ops import linalg
    sim, M, H0, Hs, psi0, graph = _compat_reference_demo(tmp)
    t0 = time.perf_counter()
    coeff, _ = _counted_path(
        total, "compat (b): SimulatorPlain.train_energy, the reference demo, "
        "202 MC epochs", {"k7_forward": sim.n_epoch * sim.n_step},
        lambda: _quiet(lambda: sim.train_energy(M, H0, Hs, psi0)))
    wall = time.perf_counter() - t0
    state, prob = sim.find_state(sim.final_state)
    cut = _cut(graph, state, 4)
    losses = sim.losses_energy
    log(f"compat (b): reference demo through the facade: cut result is "
        f"{state:04b}, cut value {cut} / max cut 4.0; loss gap {losses[0]!r} "
        f"-> {losses[-1]!r}; coefficients {tuple(coeff.shape)} on "
        f"{coeff.device}, requires_grad {coeff.requires_grad}")
    log(f"time: compat (b) the reference demo, 202 epochs through "
        f"SimulatorPlain.train_energy {wall:.3f} s [{card}]")
    if not (state in (0b0101, 0b1010) and cut == 4.0
            and losses[-1] < losses[0] and coeff.requires_grad):
        fail("compat (b): the reference demo through the facade did not "
             "read out the max cut 0101/1010 with a falling loss")

    h0, hs = _compat_ring_ops(10)
    cost = np.zeros(1024)
    for i, j in [(i, (i + 1) % 10) for i in range(10)]:
        cost += -0.5 * (1.0 - linalg.zz_diagonal(10, i, j))
    big = _facade(tmp, lr=2e-2, n_basis=6, n_epoch=3, device=DEVICE)
    big.omegas, big.T = [np.pi] * 20, 2.0
    steps = reference_n_steps(big.per_step, 0.0, big.T)
    t0 = time.perf_counter()
    _counted_path(
        total, "compat (c): SimulatorPlain.train_energy, 10q dense ring, "
        "3 MC epochs", {"k7_forward": big.n_epoch * (steps + 2 * big.n_step)
                        + steps},
        lambda: _quiet(lambda: big.train_energy(
            np.diag(cost), h0, hs, linalg.uniform_superposition(10))))
    losses = big.losses_energy
    log(f"compat (c): 10q dense ring through the facade (20 controls, MC "
        f"branches B = 40 on K7 at d = 1024), 3 epochs in "
        f"{time.perf_counter() - t0:.2f} s (host build included): gap "
        f"{losses!r}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("compat (c): the 10q facade's loss did not fall over 3 epochs")

    fid = _facade(tmp, lr=1e-1, n_basis=6, n_epoch=3, device=DEVICE)
    fid.omegas, fid.T = [np.pi, np.pi], 2.0
    steps = reference_n_steps(fid.per_step, 0.0, fid.T)
    _counted_path(
        total, "compat (d): SimulatorPlain.train_fidelity, |0> -> |1>, 3 "
        "epochs", {"k7_forward": fid.n_epoch * fid.n_step + steps},
        lambda: _quiet(lambda: fid.train_fidelity(
            0.5 * linalg.Z, [linalg.X, linalg.Y], [linalg.basis_state(0, 2)],
            [linalg.basis_state(1, 2)])))
    fids = np.abs(fid.final_state[:, 1]) ** 2
    log(f"compat (d): train_fidelity 3 MC epochs, infidelity "
        f"{fid.losses_energy!r}, final fidelity {fids.tolist()!r}")
    sim.n_epoch = 3
    sim.spectral_coeff = None
    _counted_path(
        total, "compat (d): SimulatorPlain.train_energy_FD, the reference "
        "demo, 3 epochs ('expm': 96 single-state groups)", {},
        lambda: _quiet(lambda: sim.train_energy_FD(M, H0, Hs, psi0)))
    log(f"compat (d): train_energy_FD 3 epochs, gap {sim.losses_energy!r}")
    if not (np.all(np.isfinite(fid.losses_energy))
            and np.all(np.isfinite(sim.losses_energy))
            and sim.losses_energy[-1] < sim.losses_energy[0]
            and torch.isfinite(sim.spectral_coeff).all()):
        fail("compat (d): train_fidelity / train_energy_FD not finite, or "
             "the FD loss did not fall")


def _compat_host(total, card, tmp):
    """(e) The host algorithms on the card against the same calls with
    device='cpu' at the same seed: ``trotter`` with ``generate_u``
    closures at 10 qubits (also against the native engine's
    trotter_simple), ``compute_energy_grad_MC`` / ``_FD`` on the
    reference demo with noise on."""
    from diffquantum_tpu_torch.native import bindings
    from diffquantum_tpu_torch.ops import linalg
    h0, hs = _compat_ring_ops(10)
    psi0 = linalg.uniform_superposition(10)
    c = 0.5 * np.random.default_rng(10).standard_normal((20, 6))
    outs = {}
    for dev in (DEVICE, "cpu"):
        s = _facade(tmp, n_basis=6, device=dev)
        s.omegas, s.T = [np.pi] * 20, 2.0
        H = [h0] + [[hs[i], s.generate_u(i, c)] for i in range(20)]
        t0 = time.perf_counter()
        if dev == DEVICE:
            outs[dev] = _counted_path(
                total, "compat (e): SimulatorPlain.trotter, 10q, generate_u "
                "closures (float64: the plain recurrence)",
                {"apply_recurrence": 30}, lambda: s.trotter(H, psi0, 0, s.T))
        else:
            outs[dev] = s.trotter(H, psi0, 0, s.T)
        log(f"time: compat (e) 10q facade trotter on {dev} (30 steps, 600 "
            f"closure calls) {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"[{card}]")
    native = bindings.NativeSystem()
    native.set_system(h0, hs, [], 2.0, 1)
    t0 = time.perf_counter()
    ref = native.trotter_simple(psi0, 0.0, 2.0, 10, c, [np.pi] * 20,
                                "bspline")
    log(f"time: compat (e) 10q native trotter_simple on the host "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
    errs = (float(np.abs(outs[DEVICE] - outs["cpu"]).max()),
            float(np.abs(outs[DEVICE] - ref).max()))
    log(f"compat (e): 10q trotter with closures, card against CPU max abs "
        f"{errs[0]!r}, against native trotter_simple {errs[1]!r} (atol "
        f"{COMPAT_NATIVE_ATOL})")
    if not max(errs) <= COMPAT_NATIVE_ATOL:
        fail("compat (e): the facade's trotter on the card disagrees with "
             "the CPU or the native engine")
    grads = {}
    for dev in (DEVICE, "cpu"):
        sim, M, H0, Hs, psi, _ = _compat_reference_demo(tmp)
        s = _facade(tmp, n_basis=6, seed=5, is_noisy=True, device=dev)
        s.omegas, s.T, s.Pauli_M = sim.omegas, sim.T, sim.Pauli_M
        s.spectral_coeff = 0.3 * np.random.default_rng(4).standard_normal(
            (8, 6))
        H = [H0] + [[Hs[i], s.generate_u(i, s.spectral_coeff)]
                    for i in range(8)]
        def run(s=s, H=H, M=M, psi=psi):
            return [s.compute_energy_grad_MC(M, H, psi),
                    s.compute_energy_grad_MC(M, H, psi),
                    s.compute_energy_grad_FD(M, H, psi)]
        grads[dev] = _counted_path(
            total, "compat (e): two MC gradients and the FD gradient, 4q "
            "demo ('expm')", {}, run) if dev == DEVICE else run()
    errs = [rel_err(g.detach().cpu(), h.detach())
            for g, h in zip(grads[DEVICE], grads["cpu"])]
    log(f"compat (e): 4q demo, noisy, seed 5: two MC gradients and the FD "
        f"gradient, card against CPU relative max diff {errs!r} (limit "
        f"{COMPAT_HOST_REL}); MC max-norm "
        f"{float(grads['cpu'][0].detach().abs().max())!r}")
    if not max(errs) <= COMPAT_HOST_REL:
        fail("compat (e): the host algorithms on the card disagree with the "
             "CPU at the same seed")


# demo -> (argv at its default size with epochs cut, launches)
COMPAT_DEMOS = {
    "maxcut": (["--epochs", "202"], {}),
    "maxcut_seeds": (["--epochs", "5"], {"k2_forward": 5, "k2_backward": 5}),
    "vqe_h2": ([], {}),
    "control": (["--epochs", "20"], {"k7_forward": 30}),
    "tfim": (["--epochs", "5"], {"k1_forward": 6, "k1_backward": 5}),
    "h2_dissociation": (["--epochs", "5"], {}),
    "hydrogen_chain": (["--epochs", "3"], {}),
    "channel_control": (["--epochs", "5"], {}),
    "open_control": (["--epochs", "20"], {"k7_forward": 60}),
}


def _compat_demos(total, card, tmp):
    """(f) Each demos_torch script's main() on the card in process, at its
    default size with the epochs cut; the 4q MaxCut reads out the max cut
    and the VQE H2 error is below chemical accuracy."""
    import importlib.util
    cwd = os.getcwd()
    os.chdir(tmp)  # the loggers write under ./logs
    try:
        for name, (argv, want) in COMPAT_DEMOS.items():
            spec = importlib.util.spec_from_file_location(
                f"demos_torch_{name}",
                os.path.join(ROOT, "demos_torch", f"demo_{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            t0 = time.perf_counter()
            out, text = _counted_path(
                total, f"compat (f): demos_torch/demo_{name}.py "
                f"{' '.join(argv)}", want,
                lambda: _quiet(lambda: mod.main(argv)))
            last = [ln for ln in text.splitlines() if ln.strip()][-1]
            log(f"compat (f): demo_{name} {' '.join(argv)} took "
                f"{time.perf_counter() - t0:.2f} s; last line: {last}")
            if name == "maxcut" and out["cut"] != 4.0:
                fail(f"compat (f): demo_maxcut read out cut {out['cut']}, "
                     "not 4.0")
            if name == "vqe_h2" and not abs(out["error_mha"]) < \
                    COMPAT_VQE_MHA:
                fail(f"compat (f): demo_vqe_h2 error {out['error_mha']} mHa")
    finally:
        os.chdir(cwd)


def phase_compat(total):
    """The reference-API facades, the native engine and the GPU demos:
    (a) diffqc on the card against the native engine (K7 0), (b) the
    reference demo through SimulatorPlain (K7 202 x n_step), (c) the
    facade on the 10q dense ring (K7 at d = 1024, B = 40), (d)
    train_fidelity and train_energy_FD, (e) the host algorithms on the
    card against the CPU, (f) the nine demos_torch scripts."""
    import tempfile
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        for part in (_compat_diffqc, _compat_facade, _compat_host,
                     _compat_demos):
            t0 = time.perf_counter()
            part(total, card, tmp)
            log(f"compat: {part.__name__} took "
                f"{time.perf_counter() - t0:.1f} s")


def phase_slice_times():
    """time: lines of the slice's paths, with the card's name and power
    limit."""
    import torch
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.gradients.fd import fd_energy_grad
    from diffquantum_tpu_torch.gradients.mc import mc_energy_grad
    card = card_line()
    rows = []
    for kind in ("tfim", "heisenberg"):
        p = _model(kind, 20, dense=False)
        ns = reference_n_steps(10, 0.0, p.T)
        c = _coeff(p.envelope.coeff_shape, 20)
        rows.append((f"20q {kind} grad step ({ns} steps)", lambda p=p, c=c,
                     ns=ns: energy_and_grad(p.ham, p.envelope,
                                            p.measurement, c, p.psi0, p.T,
                                            ns), 10))
    for n in (12, 18):
        p = channel_problem(n)
        vv = _coeff(p.envelope.coeff_shape, 100 + n, scale=0.7)
        rows.append((f"channel{n}q_grad_step (30 steps)",
                     lambda p=p, vv=vv: energy_and_grad(
                         p.ham, p.envelope, p.measurement, vv, p.psi0, p.T,
                         30), 20 if n == 12 else 10))
    p = frontier_problem(20)
    c = _coeff(p.envelope.coeff_shape, 20)
    args = (p.ham, p.envelope, p.measurement, c, p.psi0, p.T, None, 30)
    s = torch.tensor(0.7, dtype=torch.float64, device=DEVICE)
    rows.append(("20q MC sample (80 branches, 30 steps)",
                 lambda: mc_energy_grad(*args, s=s), 5))
    rows.append(("20q FD gradient (480 members, 30 steps)",
                 lambda: fd_energy_grad(*args), 2))
    for label, fn, iters in rows:
        ms = cuda_ms(fn, iters, warmup=1)
        log(f"time: {label} {ms:.3f} ms [{card}]")
    torch.cuda.empty_cache()


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
    errs.update(phase_packed_kernels())
    errs.update(phase_hop_kernels())
    errs.update(phase_dense_kernels())
    errs.update(phase_chunked_kernels())
    launches = {k: 0 for k in COUNTERS}
    phase_main_path(launches)
    phase_seeds(launches)
    phase_mc(launches)
    phase_fd(launches)
    phase_frontier(launches)
    phase_hop_paths(launches)
    phase_dense_paths(launches)
    phase_sharded_paths(launches)
    for phase in (phase_strings, phase_channel, phase_sampled_frontier,
                  phase_molecule, phase_open, phase_compat):
        t_phase = time.perf_counter()
        phase(launches)
        log(f"time: {phase.__name__} took "
            f"{time.perf_counter() - t_phase:.1f} s")
    log(f"launches over all paths: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was launched no time by the paths")
    times = phase_times()
    times.update(phase_frontier_times())
    times.update(phase_hop_times())
    times.update(phase_dense_times())
    times.update(phase_sharded_times())
    phase_slice_times()
    import torch.distributed as dist
    if dist.is_initialized():  # the one-rank world make_mesh started
        dist.destroy_process_group()

    # kernel -> (source, TPU kernel it replaces)
    k12 = "diffquantum_tpu_torch/csrc/fused_product.cu"
    pk = "diffquantum_tpu_torch/csrc/packed_phase.cu"
    k7 = "diffquantum_tpu_torch/csrc/taylor_apply.cu"
    fk = "diffquantum_tpu/ops/pallas_kernels.py"
    fp, fc, fh = "diffquantum_tpu/ops/fused_product.py", \
        "diffquantum_tpu/ops/fused_chunked.py", \
        "diffquantum_tpu/ops/fused_mega_hop.py"
    replaces = {"k1_forward": (k12, f"{fp}:307"),
                "k1_backward": (k12, f"{fp}:376"),
                "k2_forward": (k12, f"{fp}:672"),
                "k2_backward": (k12, f"{fp}:733"),
                "k3_forward": (pk, f"{fp}:1285"),
                "k3_backward": (pk, f"{fp}:1364"),
                "k4_forward": (pk, f"{fc}:202"),
                "k4_backward": (pk, f"{fc}:327"),
                "k5_forward": (pk, f"{fc}:695"),
                "k5_backward": (pk, f"{fc}:766"),
                "k6_forward": (pk, f"{fh}:612"),
                "k6_backward": (pk, f"{fh}:685"),
                "k7_forward": (k7, f"{fk}:40"),
                "k7_backward": (k7, f"{fk}:40")}
    kernels = []
    for name, (source, line) in replaces.items():
        # no single PyTorch call computes a chain; K7's yardstick is
        # matrix_exp of the generator and one product
        ms, plain_ms, bound_ms, bound_by, *library = times[name] + (None,)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": line,
            "launches": launches[name],
            "max_abs_err": errs[name[:2]][name.endswith("backward")],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[0],
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
