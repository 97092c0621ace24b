"""Drives the system under test in back-to-back jobs.

The configuration names the program's problem and trainer call by its
``problem`` key (``problems/<name>.py``). A job is one trainer call of
``epochs_per_job`` epochs from a fresh population drawn from the run's
seed and the job's index, on the device, and ends in the trainer's own
host readout of its losses. The
harness adds no synchronisation inside a job: a hook that runs after
every optimizer step records a CUDA event on the current stream (the
epoch's end on the device's timeline) and, at each of a job's first
three steps, copies Adam's first moment and the coefficients on the
device for the correctness check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from . import spec


WARMUP_JOB = 2**40   # the warm-up job's index, outside the window's


def job_seed(seed: int, job: int) -> int:
    """A 63-bit seed for job ``job`` of a run seeded ``seed``."""
    a, b = np.random.SeedSequence([seed % 2**64, job]).generate_state(2)
    return (int(a) << 31) | (int(b) >> 1)


def population(seed: int, shape, scale: float, device) -> torch.Tensor:
    """N(0, scale^2) coefficients [n_seeds, n_controls, n_basis], drawn
    on ``device`` from a generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return scale * torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32)


@dataclasses.dataclass
class Job:
    index: int
    seed: int
    losses: np.ndarray = None       # [epochs, n_seeds], host
    moments: list = dataclasses.field(default_factory=list)  # exp_avg
    params: list = dataclasses.field(default_factory=list)   # after steps 1-3
    beta1: float = 0.9
    error: str = ""


class StepClock:
    """Post-step hook of every optimizer: an event (or, without a card, a
    host time) per step, and the check's copies at steps 1 to 3."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []
        self.job = None
        self.k = 0

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def start_job(self, job: Job):
        self.job, self.k = job, 0

    def __call__(self, opt, args, kwargs):
        self.mark()
        self.k += 1
        if self.job is None or self.k > 3:
            return
        p = opt.param_groups[0]["params"][0]
        self.job.moments.append(opt.state[p]["exp_avg"].detach().clone())
        self.job.params.append(p.detach().clone())
        self.job.beta1 = float(opt.param_groups[0]["betas"][0])

    def intervals_ms(self) -> list[float]:
        """Times between consecutive marks, in ms."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


@contextlib.contextmanager
def hooked(clock: StepClock):
    """``clock`` runs after every optimizer step inside the block."""
    handle = register_optimizer_step_post_hook(clock)
    try:
        yield clock
    finally:
        handle.remove()
        clock.start_job(None)


class System:
    """The problem and the trainer call of one cell: the module
    ``problems/<config["problem"]>.py``, and the population of each job
    drawn from the job's seed."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.program = spec.problem_module(config["problem"]).build(
            config, traffic, self.device)
        self.n_seeds = int(traffic["n_seeds"])
        self.shape = (self.n_seeds,) + tuple(self.program.coeff_shape)

    def run_job(self, seed: int, epochs: int):
        pop = population(seed, self.shape, float(self.traffic["init_scale"]),
                         self.device)
        return self.program.run_job(seed, epochs, pop)


def run_window(system: System, seed: int, seconds: float, clock: StepClock,
               log=print):
    """Jobs back to back: a first one, then each next one while the mean
    job time so far says that it ends within ``seconds`` of the host
    clock. The window closes when the last job has read out its losses,
    so it lasts at most ``seconds``, or one job where that is longer.
    Returns (jobs, wall seconds, epochs completed, epochs failed)."""
    epochs = int(system.traffic["epochs_per_job"])
    jobs, failed = [], 0
    with hooked(clock):
        if clock.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        clock.mark()
        while not jobs or (time.perf_counter() - t0) * (len(jobs) + 1) \
                / len(jobs) <= seconds:
            job = Job(len(jobs), job_seed(seed, len(jobs)))
            clock.start_job(job)
            try:
                res = system.run_job(job.seed, epochs)
                job.losses = res.losses
                if not np.all(np.isfinite(res.losses)):
                    job.error = "non-finite loss"
            except Exception:   # a job that raises counts as failed
                job.error = traceback.format_exc()
                log(job.error)
            if job.error:
                failed += epochs
            jobs.append(job)
        if clock.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return jobs, wall, epochs * len(jobs) - failed, failed
