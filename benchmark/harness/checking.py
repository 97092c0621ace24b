"""Decides ``correct``: the window's own training against the plain
reference.

From jobs of the window drawn from the run's seed, and members of each
drawn the same way, the reference follows the job's first three epochs
step by step from the program's own state: at each coefficients that
the program held before an update (and after the third), it works out
the energy and the gradient again, for the Monte-Carlo mixes at the
same split times (drawn again by the trainer's rule); and it runs its
own Adam from the job's start (the harness's own draw, made again from
the job's seed) on the gradients that the program's optimizer got. The
start, each gradient, each update and each loss are so checked link by
link. Three numbers are compared over the checked members:

- ``loss_gap``: the energies before updates 1-4 (the trainer's losses
  0-3), the worst |program - reference| / max(|reference|, 1);
- ``grad_gap``: the gradient of each of the three epochs as Adam got it
  (worked out from its first moments), per leaf (one member's
  coefficients of one control): the worst | |g_program| - |g_reference| |
  over the larger of the reference's norm and the epoch's median leaf's;
  leaves whose reference gradient is under a thousandth of the median
  leaf's are left out (their norm is round-off);
- ``change_gap``: the coefficients' change after each of the three
  updates, per leaf, against the reference's Adam fed the same
  gradients, measured the same way, at the worst leaf.

Why step by step: Adam's first update of a component is lr g / (|g| +
1e-8), so a component whose gradient is nought to float32 rounding
moves by anything up to lr as its rounding decides, and from there two
sound float32 trajectories part. A sound H100 run read a loss gap of
7.5e-5 and a change gap of 4.1e-3 so, against the reference run on its
own, where most runs read 1e-6 and 1e-5: one component's first
gradient was 3.2e-8 in the program, 1.6e-6 in the float32 reference and
1.9e-7 in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from . import spec
from .driver import population

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
CHECK_EPOCHS = 3


def choose(n_jobs: int, n_seeds: int, traffic: dict, seed: int):
    """[(job index, member indices)] drawn from ``seed``."""
    rng = np.random.default_rng([seed % 2**64, 0xC0FFEE])
    n_j = min(int(traffic["check_jobs"]), n_jobs)
    n_m = min(int(traffic["check_members"]), n_seeds)
    return [(int(j), np.sort(rng.choice(n_seeds, n_m, replace=False)))
            for j in np.sort(rng.choice(n_jobs, n_j, replace=False))]


class Replay:
    """The reference beside chosen members of a job."""

    def __init__(self, config: dict, traffic: dict, device, matmul_round=None,
                 ref=None):
        self.ref = ref or spec.reference_module(config["reference"])
        self.ref.set_exact_matmul()
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.lr = float(traffic["lr"])
        self.problem = self.ref.build(config, self.device, matmul_round)

    def split_times(self, job_seed: int, members):
        """None for the adjoint; else a callable epoch -> the members'
        split times, drawn by the trainer's rule (all seeds' rows each
        epoch, in epoch order)."""
        t = self.traffic
        if t["grad_mode"] == "adjoint":
            return None
        n = int(t.get("mc_samples", 1))
        strategy = t.get("mc_strategy", "iid") if n > 1 else "iid"
        gen = torch.Generator(device=self.device).manual_seed(job_seed + 1)
        idx = torch.as_tensor(members, device=self.device)

        def draw(epoch):
            s = self.ref.split_times(gen, int(t["n_seeds"]), n, strategy,
                                     self.problem.T)
            return s[idx]
        return draw

    def run(self, job_seed: int, members, c0=None):
        """The reference on its own, in the program's place (the control
        and the faults): (losses [4, M], gradients [3, M, n_c, n_b],
        coefficients after each update [3, M, n_c, n_b])."""
        if c0 is None:
            c0 = self.start(job_seed, members)
        return self.ref.replay(self.problem, c0, self.lr, CHECK_EPOCHS,
                               self.split_times(job_seed, members))

    def follow(self, job_seed: int, members, c0, prog):
        """The reference step by step from ``prog``'s own state, ``prog``
        as :func:`program_readings` gives it: (energies at its
        coefficients [4, M], gradients there [3, M, n_c, n_b], Adam from
        ``c0`` fed its gradients [3, M, n_c, n_b])."""
        c0 = torch.as_tensor(c0, device=self.device)
        cs = torch.cat([c0[None].to(prog[2].dtype),
                        torch.as_tensor(prog[2], device=self.device)])
        return self.ref.follow(
            self.problem, cs, torch.as_tensor(prog[1], device=self.device),
            self.lr, self.split_times(job_seed, members))

    def start(self, job_seed: int, members):
        shape = (int(self.traffic["n_seeds"]), self.problem.n_controls,
                 self.problem.n_basis)
        pop = population(job_seed, shape, float(self.traffic["init_scale"]),
                         self.device)
        return pop[torch.as_tensor(members, device=self.device)]


def program_readings(job, members):
    """The window's own (losses [4, M], the gradients that Adam got [3, M,
    n_c, n_b], worked out from its first moments after steps 1-3, and
    the coefficients after each of those steps [3, M, n_c, n_b]) for the
    chosen members of ``job``."""
    idx = torch.as_tensor(members, device=job.moments[0].device)
    m = [x[idx].double() for x in job.moments[:CHECK_EPOCHS]]
    b = job.beta1
    g = [m[0] / (1.0 - b)] + [(m[k] - b * m[k - 1]) / (1.0 - b)
                               for k in range(1, CHECK_EPOCHS)]
    return (torch.as_tensor(job.losses[:CHECK_EPOCHS + 1, members]),
            torch.stack(g),
            torch.stack([p[idx] for p in job.params[:CHECK_EPOCHS]]))


def _np(x):
    return np.asarray(torch.as_tensor(x).detach().cpu().double())


def _leaf_gap(a, b, keep=None):
    """Per-leaf | |a| - |b| | over max(|b|, median |b|), worst over the
    leaves (norms over the last axis), the kept ones where given."""
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    scale = np.maximum(np.maximum(nb, np.median(nb)), np.finfo(float).tiny)
    gap = np.abs(na - nb) / scale
    return float(np.max(gap if keep is None else gap[keep]))


def numbers(prog, ref, c0) -> dict:
    """The three numbers for one job's members: ``prog`` as
    :func:`program_readings` gives it, ``ref`` as :meth:`Replay.follow`
    gives it beside ``prog``."""
    lp, gp, pp = (_np(x) for x in prog)
    lr, gr, pr = (_np(x) for x in ref)
    c0 = _np(c0)
    loss_gap = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1.0)))
    grad_gap = 0.0
    for e in range(gr.shape[0]):
        ngr = np.linalg.norm(gr[e], axis=-1)           # [M, n_c] leaves
        keep = ngr >= 1e-3 * np.median(ngr)
        grad_gap = max(grad_gap, _leaf_gap(gp[e], gr[e], keep))
    change_gap = max(_leaf_gap(pp[k] - c0, pr[k] - c0)
                     for k in range(pr.shape[0]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def worst(readings) -> dict:
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def judge(values: dict, limits: dict):
    """(correct, {name: [value, limit]}): every number at or under its
    limit, and a number that is not finite fails."""
    checks = {k: [values[k], float(limits[k]["limit"])] for k in NUMBERS}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return bool(ok), checks


def check_window(jobs, config, traffic, seed, device, log=print):
    """The numbers of the window's chosen jobs and members, worst over
    jobs; None where no job finished."""
    done = [j for j in jobs if not j.error]
    if not done:
        return None
    replay = Replay(config, traffic, device)
    readings = []
    for i, members in choose(len(done), int(traffic["n_seeds"]), traffic,
                             seed):
        job = done[i]
        c0 = replay.start(job.seed, members)
        prog = program_readings(job, members)
        ref = replay.follow(job.seed, members, c0, prog)
        readings.append(numbers(prog, ref, c0))
        log(f"check: job {job.index}, {len(members)} members: "
            f"{readings[-1]}")
    return worst(readings)
