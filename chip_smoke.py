#!/usr/bin/env python3
"""Drive the PyTorch port (``diffquantum_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. In order, and failing (non-zero exit)
at the first phase that does not hold:

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``csrc/*.cu`` built with nvcc, with its time and the
   ``-Xptxas -v`` register and shared-memory lines;
2. kernels against their plain PyTorch versions on the card, case by
   case, forward and backward, at the shapes listed in phase_kernels;
3. the main path through the user's entry points: the 12-qubit ring
   MaxCut adjoint gradient (``energy_and_grad``, routed by ``evolve`` to
   the fused engine) and 30 Adam epochs of ``train_energy``, with the
   kernels' launch counters set to 0 just before and read just after;
4. times with CUDA events after warm-up: each kernel at the main path's
   shapes beside its plain version and its bound, the whole 12-qubit grad
   step, and the 16-qubit 1000-step grad step;
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


def k1_bound(d, n_steps, kinds, backward):
    """(bound_ms, bound_by) for one K1 call: every input read once, every
    output written once; the fp32 operations the function needs (sin and
    cos one each). Per amplitude pair a rotation takes 12 (two complex
    outputs of c x + s y); the adjoint undoes y (12), carries lambda back
    (12) and forms Re<lambda, -iG y> for d theta_x (8): 32."""
    n_ops, T = len(kinds), n_steps
    f = 4
    if not backward:
        nbytes = f * (T * d + T * n_ops + 4 * d) + 16 * n_ops
        ops = (T + 1) * d * 8 + (T - 1) * d + T * (12 * _rot_pairs(kinds, d)
                                                    + 2 * n_ops)
    else:
        nbytes = f * (2 * T * d + 2 * T * n_ops + 6 * d) + 16 * n_ops
        ops = (T + 1) * d * 19 + T * (32 * _rot_pairs(kinds, d) + 2 * n_ops)
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


def maxcut_chain(n, n_steps, seed, scale=0.4):
    """The main path's K1 inputs for an n-qubit ring MaxCut, random
    coefficients from ``seed``; the cotangent is the loss's, 2 w psi."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import fused_chain_inputs
    from diffquantum_tpu_torch.models import maxcut
    prob = maxcut.build_maxcut(n, maxcut.ring_graph(n), n_basis=6,
                                 device=DEVICE)
    rng = np.random.default_rng(seed)
    coeff = torch.tensor(scale * rng.standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)
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


def phase_kernels():
    """K1 forward and backward against the plain versions, case by case.
    Returns the main-path case's (forward, backward) max abs errors."""
    import torch
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    cases = [("12q ring MaxCut, T=30", 12, 30, "maxcut", TOL),
             ("16q ring MaxCut, T=1000", 16, 1000, "maxcut", TOL_LONG),
             ("17q ring MaxCut, T=30", 17, 30, "maxcut", TOL),
             ("12q mixed X/Y/hop palindromic plan, T=30", 12, 30, "mixed",
              TOL),
             ("12q ring MaxCut, T=1", 12, 1, "maxcut", TOL)]
    main_errs = None
    for label, n, n_steps, kind, tol in cases:
        d = 2**n
        rng = np.random.default_rng(n * 1000 + n_steps)
        if kind == "maxcut":
            prob, th, tx, qubits, kinds = maxcut_chain(n, n_steps, seed=n)
            psi0 = prob.psi0
        else:
            th, tx, qubits, kinds = mixed_chain(n, n_steps, seed=n)
            v = rng.standard_normal((2, d)) / np.sqrt(2 * d)
            psi0 = CP(*(torch.tensor(x, dtype=torch.float32, device=DEVICE)
                        for x in v))
        t0 = time.perf_counter()
        out = tfp.fused_product_evolve(psi0, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        ref = tfp.fused_product_evolve_plain(psi0, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        fwd_err = max(float((out.re - ref.re).abs().max()),
                      float((out.im - ref.im).abs().max()))
        if not (np.isfinite(fwd_err) and fwd_err <= tol["fwd"]):
            fail(f"{label}: K1 forward differs from plain by {fwd_err} "
                 f"(atol {tol['fwd']})")
        if kind == "maxcut":  # the loss's cotangent, dL/dpsi = 2 w psi
            w = prob.measurement.diag
            lam = CP(2.0 * w * ref.re, 2.0 * w * ref.im)
        else:
            v = rng.standard_normal((2, d))
            lam = CP(*(torch.tensor(x, dtype=torch.float32, device=DEVICE)
                       for x in v))
        got = tfp._backward_cuda(out.re, out.im, lam.re, lam.im, th, tx,
                                 tfp._plan_ops(qubits, kinds, n), n)
        torch.cuda.synchronize()
        gp, gth, gtx = tfp._adjoint_plain(ref, lam, th, tx, qubits, n, kinds)
        torch.cuda.synchronize()
        want = (gp.re, gp.im, gth, gtx)
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        bwd_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(np.isfinite(r) and r <= tol["grad"] for r in rels):
            fail(f"{label}: K1 backward differs from plain: relative "
                 f"errors (dpsi_re, dpsi_im, dtheta_half, dtheta_x) {rels} "
                 f"(bound {tol['grad']})")
        log(f"kernel check [{label}]: {len(kinds)} ops, forward max abs err "
            f"{fwd_err!r} (atol {tol['fwd']}); backward relative errors "
            f"{rels!r} (bound {tol['grad']}); first launch + sync "
            f"{t_k * 1e3:.3f} ms")
        if main_errs is None:
            main_errs = (fwd_err, bwd_abs)
    return main_errs


def phase_main_path():
    """The 12q MaxCut adjoint step and 30 epochs of training through the
    entry points; returns the (forward, backward) launch counts."""
    import torch
    from diffquantum_tpu_torch.dynamics.product import select_engine
    from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.models import maxcut
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.train.config import TrainConfig
    from diffquantum_tpu_torch.train.energy import train_energy

    prob = maxcut.build_maxcut(12, maxcut.ring_graph(12), n_basis=6,
                                device=DEVICE)
    n_steps = reference_n_steps(10, 0.0, prob.T)
    if select_engine(prob.ham) != "streamed" or n_steps != 30:
        fail(f"12q MaxCut routes to {select_engine(prob.ham)!r} with "
             f"{n_steps} steps, expected 'streamed' with 30")
    rng = np.random.default_rng(12)
    coeff = torch.tensor(0.4 * rng.standard_normal(
        prob.envelope.coeff_shape), dtype=torch.float32, device=DEVICE)

    tfp.FWD_LAUNCHES = tfp.BWD_LAUNCHES = 0
    val, grad = energy_and_grad(prob.ham, prob.envelope, prob.measurement,
                                coeff, prob.psi0, prob.T, n_steps)
    torch.cuda.synchronize()
    step_counts = (tfp.FWD_LAUNCHES, tfp.BWD_LAUNCHES)
    result = train_energy(prob.ham, prob.envelope, prob.measurement,
                          prob.psi0, prob.T,
                          TrainConfig(n_epoch=30, grad_mode="adjoint"))
    torch.cuda.synchronize()
    counts = (tfp.FWD_LAUNCHES, tfp.BWD_LAUNCHES)

    if step_counts != (1, 1):
        fail(f"energy_and_grad launched K1 (forward, backward) "
             f"{step_counts} times, expected (1, 1): not on the kernel")
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
    if counts[0] <= 0 or counts[1] <= 0:
        fail(f"main path launched K1 (forward, backward) {counts} times")
    psi = result.final_state
    norm = float((psi.re.double() ** 2 + psi.im.double() ** 2).sum())
    state, cut = prob.readout(psi)
    log(f"main path: final state norm {norm!r}; readout bitstring "
        f"{state:012b}, cut {cut} of max {prob.max_cut}")
    if not (abs(norm - 1.0) < 1e-4 and 0 <= state < 2**12
            and 0.0 < cut <= prob.max_cut):
        fail("final state is not a normalized state with a valid cut")
    log(f"main path: K1 launches forward {counts[0]}, backward {counts[1]}")
    return counts


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
    """Kernel, plain and grad-step times; returns per-kernel numbers."""
    import torch
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    from diffquantum_tpu_torch.ops import fused_product as tfp
    from diffquantum_tpu_torch.ops.cpx import CP

    n = 12
    prob, th, tx, qubits, kinds = maxcut_chain(n, 30, seed=n)
    plan = tfp._plan_ops(qubits, kinds, n)
    psi0 = prob.psi0
    with torch.no_grad():
        out = tfp.fused_product_evolve(psi0, th, tx, qubits, n, kinds)
    w = prob.measurement.diag
    lam = CP(2.0 * w * out.re, 2.0 * w * out.im)

    def fwd():
        tfp._forward_cuda(psi0.re, psi0.im, th, tx, plan, n)

    def bwd():
        tfp._backward_cuda(out.re, out.im, lam.re, lam.im, th, tx, plan, n)

    times = {
        "k1_forward": (cuda_ms(fwd, 200), cuda_ms(
            lambda: tfp.fused_product_evolve_plain(psi0, th, tx, qubits, n,
                                                   kinds), 5, 1)),
        "k1_backward": (cuda_ms(bwd, 200), cuda_ms(
            lambda: tfp._adjoint_plain(out, lam, th, tx, qubits, n, kinds),
            5, 1)),
    }
    for name, (ms, plain_ms) in times.items():
        log(f"time: {name} {ms!r} ms/launch, plain version {plain_ms!r} ms "
            f"(12q, T=30, {len(kinds)} ops)")

    rng = np.random.default_rng(0)
    steps = {}
    for nq, n_steps, iters in ((12, 30, 200), (16, 1000, 5)):
        from diffquantum_tpu_torch.models import maxcut
        p = prob if nq == 12 else maxcut.build_maxcut(
            nq, maxcut.ring_graph(nq), n_basis=6, device=DEVICE)
        c = torch.tensor(1e-3 * rng.standard_normal(p.envelope.coeff_shape),
                         dtype=torch.float32, device=DEVICE)
        step = lambda: energy_and_grad(p.ham, p.envelope,  # noqa: E731
                                       p.measurement, c, p.psi0, p.T,
                                       n_steps)
        t0 = time.perf_counter()
        ms = cuda_ms(step, iters)
        host = (time.perf_counter() - t0) / (iters + 3) * 1e3
        steps[(nq, n_steps)] = ms
        log(f"time: {nq}q {n_steps}-step adjoint grad step {ms!r} ms "
            f"(CUDA events over {iters} chained calls; host wall "
            f"{host!r} ms/call incl. warm-up)")
    k1_share = (times["k1_forward"][0] + times["k1_backward"][0]) \
        / steps[(12, 30)]
    log(f"time: K1 forward+backward are {k1_share!r} of the 12q grad step")
    return times, (2**n, 30, kinds)


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
    fwd_err, bwd_err = phase_kernels()
    launches = phase_main_path()
    times, (d, n_steps, kinds) = phase_times()

    kernels = []
    for i, (name, line) in enumerate((("k1_forward", 307),
                                      ("k1_backward", 376))):
        bound_ms, bound_by = k1_bound(d, n_steps, kinds, backward=i == 1)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "diffquantum_tpu_torch/csrc/fused_product.cu",
            "replaces": f"diffquantum_tpu/ops/fused_product.py:{line}",
            "launches": launches[i],
            "max_abs_err": (fwd_err, bwd_err)[i],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes K1
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
