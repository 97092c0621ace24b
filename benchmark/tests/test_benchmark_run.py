"""Runs of the harness: without a card it fails; on the CPU, at a small
size, a sound program reads correct, and each fault that a cell can
have, planted in the trainer underneath, reads not correct; so does the
lower-precision control."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_cases import small_cell
from harness import checking, runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = ("maxcut_ring12.seeds2048", "maxcut_ring20.seeds16",
         "maxcut_ring12.mc64x8", "maxcut_ring20.mc1")


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(["--workload", CELLS[0], "--seed", "3000000011", "--seconds",
                "1", "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _cpu_run(cell, seed=2**31 + 11):
    return runner.run_cell(cell, seed, 0.5, False, device="cpu",
                           log=lambda msg: None)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    n_seeds = 1 if workload.endswith("mc1") else 8
    res = _cpu_run(small_cell(workload, n_seeds=n_seeds))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] % 4 == 0
    assert {"epoch_ms", "epoch_ms_p95", "setup_s"} == set(res["metrics"])


def _plant(monkeypatch, fault, traffic):
    from diffquantum_tpu_torch.parallel import mesh
    if fault == "unchanged":
        orig = mesh.make_optimizer
        monkeypatch.setattr(mesh, "make_optimizer",
                            lambda cfg, ps: orig(cfg.replace(lr=0.0), ps))
    elif fault == "alter":
        orig = mesh._objective
        monkeypatch.setattr(mesh, "_objective", lambda m, psi: (
            lambda e: e + 1e-3 * e.detach())(orig(m, psi)))
    elif traffic["grad_mode"] == "adjoint":   # half of the batch left out
        orig = mesh._objective

        def half(m, psi):
            e = orig(m, psi)
            h = e.shape[0] // 2
            return torch.cat([e[:h], e[h:].detach()])
        monkeypatch.setattr(mesh, "_objective", half)
    else:
        orig = mesh.mc_grads_per_sample
        n = int(traffic["mc_samples"])

        def half(*a, **k):
            g = orig(*a, **k)
            if n > 1:   # each seed's mean over the first half of its samples
                g = g.reshape((-1, n) + g.shape[1:]).clone()
                g[:, n // 2:] = g[:, :n // 2]
                return g.reshape((-1,) + g.shape[2:])
            g = g.clone()   # one sample: half of the controls' branches
            g[:, g.shape[1] // 2:] = 0.0
            return g
        monkeypatch.setattr(mesh, "mc_grads_per_sample", half)


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_reads_not_correct(monkeypatch, workload, fault):
    n_seeds = 1 if workload.endswith("mc1") else 8
    cell = small_cell(workload, n_seeds=n_seeds)
    _plant(monkeypatch, fault, cell.traffic)
    res = _cpu_run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_lower_precision_control_reads_not_correct(workload):
    """The reference with TF32 products in the program's place, against
    the cell's limits, on three seeds."""
    n_seeds = 1 if workload.endswith("mc1") else 8
    cell = small_cell(workload, n_seeds=n_seeds)
    tr = cell.traffic
    exact = checking.Replay(cell.config, tr, "cpu")
    low = checking.Replay(cell.config, tr, "cpu", ref=exact.ref,
                          matmul_round=exact.ref.tf32_round)
    for seed in (7, 8, 9):
        (_, members), = checking.choose(1, int(tr["n_seeds"]), tr, seed)
        c0 = exact.start(seed, members)
        stand_in = low.run(seed, members, c0)
        values = checking.numbers(
            stand_in, exact.follow(seed, members, c0, stand_in), c0)
        assert not checking.judge(values, cell.limits)[0], values


@pytest.mark.gpu
def test_a_cell_on_the_card(card):
    cell = small_cell(CELLS[0], n_qubits=12, n_seeds=64, epochs=10)
    res = runner.run_cell(cell, 12345, 1.0, True, device="cuda",
                          log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "chain_ms_per_epoch" in res["metrics"]
