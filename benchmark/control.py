"""Readings that the correctness limits are set from (not part of a run).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3
        [--control-seeds 4,5,6] [--faults control,half,alter,unchanged]
        [--out FILE]

For each of ``--seeds`` it runs the cell's first job (the trainer at the
cell's own sizes, the hook of a run copying what the check reads, three
updates and the fourth loss) and compares it with the plain reference as
a run's check does, step by step from the job's own state: the
program's sound readings. For each of ``--control-seeds`` it puts the
reference, run on its own, in the program's place, and judges it the
same way against the plain reference:

- ``control``: the reference with each matrix product's inputs rounded
  to TF32 (10 mantissa bits), the precision below the configuration's
  float32 with TF32 off;
- ``half``: half of the batch left out: the members in the second half
  of the population get no gradient (adjoint), or each seed's gradient
  is the mean over the first half of its split times, or, with one
  sample, the branches of the second half of the controls are left out
  (Monte-Carlo);
- ``alter``: every loss altered by one part in a thousand where it is
  produced;
- ``unchanged``: the update returns the coefficients unchanged.

Prints one JSON line per seed and reading, and last the largest sound
reading and the smallest of each fault's readings, per number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))

from harness import checking, driver, spec  # noqa: E402


FAULTS = ("control", "half", "alter", "unchanged")


class HalfBatch:
    """The reference problem with half of the batch left out."""

    def __init__(self, problem, members, n_seeds):
        self.p = problem
        self.second = torch.as_tensor(members, device=problem.device) \
            >= n_seeds // 2

    def __getattr__(self, name):
        return getattr(self.p, name)

    def energy_and_grad(self, c):
        e, g = self.p.energy_and_grad(c)
        return e, torch.where(self.second[:, None, None], 0.0, g)

    def mc_grad(self, c, s):
        if s.shape[1] > 1:
            return self.p.mc_grad(c, s[:, :s.shape[1] // 2])
        g = self.p.mc_grad(c, s).clone()
        g[:, g.shape[1] // 2:] = 0.0
        return g


def program_job(system, seed, members):
    """The trainer's first job of ``seed`` at the cell's sizes, four
    epochs, read as a run's check reads the window."""
    clock = driver.StepClock(system.device.type == "cuda")
    job = driver.Job(0, driver.job_seed(seed, 0))
    with driver.hooked(clock):
        clock.start_job(job)
        job.losses = system.run_job(job.seed, checking.CHECK_EPOCHS + 1).losses
    return job, checking.program_readings(job, members)


def stand_in(name, replay, low, js, members, c0, n_seeds):
    """The reference run on its own in the program's place, as the
    control or with a fault: (losses, gradients, coefficients after each
    update), as the check reads a job."""
    if name == "control":
        return low.run(js, members, c0)
    if name == "half":
        half = checking.Replay(replay.config, replay.traffic, replay.device,
                               ref=replay.ref)
        half.problem = HalfBatch(replay.problem, members, n_seeds)
        return half.run(js, members, c0)
    if name == "alter":
        losses, grads, params = replay.run(js, members, c0)
        return losses * (1.0 + 1e-3), grads, params
    if name == "unchanged":
        # the energy and gradient at the start, every epoch
        at_start = c0[None].expand(checking.CHECK_EPOCHS, -1, -1, -1)
        losses, grads, _ = replay.follow(
            js, members, c0, (None, torch.zeros_like(at_start), at_start))
        return losses, grads, at_start
    raise ValueError(f"unknown reading {name!r}")


def readings(cell, seeds, control_seeds, device, emit, faults=FAULTS):
    cfg, tr = cell.config, cell.traffic
    n_seeds = int(tr["n_seeds"])
    replay = checking.Replay(cfg, tr, device)
    low = checking.Replay(cfg, tr, device, ref=replay.ref,
                          matmul_round=replay.ref.tf32_round)
    out = {"sound": [], "control": [], "half": [], "alter": [],
           "unchanged": []}
    if seeds:
        system = driver.System(cfg, tr, device)
        system.run_job(driver.job_seed(0, driver.WARMUP_JOB),
                       int(tr["warmup_epochs"]))
        for seed in seeds:
            (_, members), = checking.choose(1, n_seeds, tr, seed)
            job, prog = program_job(system, seed, members)
            c0 = replay.start(job.seed, members)
            ref = replay.follow(job.seed, members, c0, prog)
            out["sound"].append(checking.numbers(prog, ref, c0))
            emit({"seed": seed, "reading": "sound", **out["sound"][-1]})
        del system
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        (_, members), = checking.choose(1, n_seeds, tr, seed)
        js = driver.job_seed(seed, 0)
        c0 = replay.start(js, members)
        for name in faults:
            reading = stand_in(name, replay, low, js, members, c0, n_seeds)
            ref = replay.follow(js, members, c0, reading)
            out[name].append(checking.numbers(reading, ref, c0))
            emit({"seed": seed, "reading": name, **out[name][-1]})
    summary = {}
    for name, rows in out.items():
        if rows:
            pick = max if name == "sound" else min
            summary[name] = {k: pick(r[k] for r in rows)
                             for k in checking.NUMBERS}
            summary[name]["seeds"] = len(rows)
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default=",".join(FAULTS),
                    help="the readings to take on --control-seeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parse = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = spec.find_cell(args.workload)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    summary = readings(cell, parse(args.seeds), parse(args.control_seeds),
                       args.device, emit, args.faults.split(","))
    emit({"workload": args.workload, "summary": summary})
    if args.out:
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")


if __name__ == "__main__":
    main()
