"""Reference-compatible ``SimulatorPlain`` facade on the port's engine —
the port of :mod:`diffquantum_tpu.compat.sim_plain`.

A drop-in stand-in for the reference's ``sim_plain.SimulatorPlain``
(`sim_plain.py:14-505`): the same constructor keywords (plus ``seed`` and
``device``), the same attribute contract (``sim.T``, ``sim.omegas``,
``sim.Pauli_M`` assigned after construction, `demo_maxcut.py:44,
69-79, 47-65`; ``my_solver``, ``losses_energy``, ``final_state``) and the
same methods (``trotter``, ``generate_u``, ``stochastic_measure``,
``compute_energy_grad_MC``, ``compute_energy_grad_FD``, ``train_energy``,
``train_energy_FD``, ``train_fidelity``, ``save_plot``, ``sigmoid``,
``multi_kron``, ``multi_dot``, ``find_state``).

Everything runs on ``device`` (default ``"cuda"``; without a card the
constructor raises unless ``device="cpu"``):

- the trainers build a dense float32 ``ControlledHamiltonian`` and a
  ``Measurement`` with the ``Pauli_M`` terms and call the port's
  ``train_energy`` / ``train_fidelity`` (MC and FD estimators, Adam), so
  the MC branches run on K7 on the card;
- the host algorithms (``trotter`` with Python envelope closures,
  ``stochastic_measure``, ``compute_energy_grad_MC`` / ``_FD``) keep the
  reference's contract: the closures are evaluated on the host, one
  scalar per step and control, on the reference's grid (``n_steps =
  int(per_step (|T - T0| + 1))``, ``t`` accumulated from T0 by ``dt``).
  The evolution runs on the device in float64: H(t_k) of all steps
  stacked as one [n_steps, d, d] tensor and stepped through the dense
  engine ('expm' below d = 512, the Taylor recurrence from 512 up; the
  Taylor truncation ``TAYLOR_TOL`` a step). The MC estimator's 2 n_hs
  branch kets share one grid and evolve as one batch; FD's 2 n_hs n_basis
  coefficient sets evolve as one batch of Hamiltonian stacks.

Random draws (the MC split time, the shots and the measurement noise)
come from one ``np.random.default_rng(seed)`` on the host, in the
reference's order: s first, then per branch the shots and the noise, p
before m, i ascending; shot probabilities are computed on the device and
drawn on the host. The trainers keep their ``torch.Generator`` (seeded
from ``TrainConfig.seed``).

Interface notes / conscious divergences (as in the JAX facade):
- operators and states are numpy arrays (no QuTiP ``Qobj``);
- coefficients and gradients come back as torch tensors on ``device``
  with ``requires_grad=True`` (reference parity, `sim_plain.py:305`);
- ``Pauli_M`` entries may be ``[matrix, weight]``; the eigensystem the
  reference precomputes (`demo_maxcut.py:64-65`) is used when given as
  the third item, else taken by ``torch.linalg.eigh`` on the device;
- for poly/Fourier bases the MC rows use the raw basis values, with no
  sigmoid chain factor (the reference's quirk, `sim_plain.py:224-230`);
- ``measure_sample_times`` is accepted and ignored like the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian
from ..dynamics.propagator import APPLY_MIN_DIM, _dense_steps
from ..measure import Measurement
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.basis import basis_matrix, canonical_kind
from ..pulses.envelope import SimpleEnvelope
from ..train.config import TrainConfig
from ..train.energy import train_energy as _train_energy
from ..train.fidelity import train_fidelity as _train_fidelity
from ..utils.device import resolve_device
from ..utils.logger import Logger
from .diffqc import TAYLOR_TOL

F64 = torch.float64


def _host(a) -> np.ndarray:
    """A numpy copy of a tensor (on any device) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


class SimulatorPlain:
    """See module docstring. Constructor mirrors `sim_plain.py:20-22`."""

    def __init__(self, n_basis=5, basis="BSpline", n_epoch=200, log_dir=None,
                 n_step=100, lr=2e-2, is_noisy=False,
                 measure_sample_times=1000, method_name="Ours",
                 sampling_measure=False, per_step=10, seed=None,
                 device="cuda"):
        # ``seed`` (the JAX facade's extension): one persistent generator
        # drives the MC split times, shot draws and noise; None keeps
        # OS-entropy behaviour. ``device``: where everything runs.
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.n_basis = n_basis
        self.basis = basis
        self.log_name = basis
        self.n_epoch = n_epoch
        self.n_step = n_step
        self.lr = lr
        self.is_noisy = is_noisy
        self.sampling_measure = sampling_measure
        self.per_step = per_step
        self.measure_sample_times = measure_sample_times  # dead (ref parity)
        self.logger = Logger(name=method_name, path=log_dir)
        self.logger.write_text("arguments ========")
        for k, v in dict(n_basis=n_basis, basis=basis, n_epoch=n_epoch,
                         n_step=n_step, lr=lr, is_noisy=is_noisy,
                         sampling_measure=sampling_measure,
                         per_step=per_step).items():
            self.logger.write_text(f"{k}: {v}")
        self.my_solver = self.trotter
        # attributes assigned by user code after construction (ref contract)
        self.T = 1.0
        self.omegas = []
        self.Pauli_M = []
        self.spectral_coeff = None
        self.final_state = None
        self.losses_energy = []

    # ---- small helpers (reference surface) ---------------------------
    @staticmethod
    def sigmoid(x):
        return 1.0 / (1.0 + math.exp(-x))

    multi_kron = staticmethod(linalg.multi_kron)
    multi_dot = staticmethod(linalg.multi_dot)
    find_state = staticmethod(linalg.find_state)

    def _envelope(self):
        return SimpleEnvelope(basis=self.basis, n_basis=self.n_basis,
                              omegas=tuple(float(w) for w in self.omegas))

    def _basis(self, ts) -> torch.Tensor:
        """phi_j(t) [..., n_basis] on the host in float64, horizon T."""
        return basis_matrix(self.basis, self.n_basis,
                            torch.as_tensor(ts, dtype=F64), self.T)

    def generate_u(self, i, spectral_coeff):
        """Closure u_i(t, args) matching `sim_plain.py:73-99`, evaluated
        on the host."""
        coeff = _host(spectral_coeff).astype(np.float64)

        def _u(t, args=None):
            a = float(coeff[i] @ self._basis(float(t)).numpy())
            return (self.sigmoid(a) * 2 - 1) * self.omegas[i]

        return _u

    def _tensor(self, a) -> torch.Tensor:
        """A leaf tensor on the device with requires_grad (ref parity)."""
        if isinstance(a, torch.Tensor):
            return a.detach().to(self.device).clone().requires_grad_(True)
        return torch.tensor(np.asarray(a), device=self.device,
                            requires_grad=True)

    # ---- propagation on the device ------------------------------------
    def _state(self, psi) -> CP:
        """A state (numpy, tensor or CP) as a float64 CP [d] on the
        device."""
        if isinstance(psi, CP):
            return psi.astype(F64).reshape(-1)
        return cpx.from_complex(_host(psi).astype(np.complex128).reshape(-1),
                                dtype=F64, device=self.device)

    def _operators(self, H_):
        """(H0 CP [d, d], controls CP [k, d, d], closures) of a QuTiP-style
        list ``[H0, [H1, u1], ...]`` on the device."""
        H0, mats, fns = None, [], []
        for h in H_:
            if isinstance(h, (list, tuple)):
                mats.append(np.asarray(h[0], dtype=np.complex128))
                fns.append(h[1])
            else:
                H0 = np.asarray(h, dtype=np.complex128)
        if H0 is None:
            H0 = np.zeros_like(mats[0])
        d = H0.shape[0]
        hs = np.stack(mats) if mats else np.zeros((0, d, d), np.complex128)
        return (cpx.from_complex(H0, dtype=F64, device=self.device),
                cpx.from_complex(hs, dtype=F64, device=self.device), fns)

    def _grid(self, T0, T) -> tuple[list, float]:
        """The reference's left-endpoint grid: t accumulated from T0."""
        n_steps = int(self.per_step * (abs(T - T0) + 1))
        dt = (T - T0) / n_steps
        ts, t = [], T0
        for _ in range(n_steps):
            ts.append(t)
            t += dt
        return ts, dt

    def _evolve(self, h0: CP, hs: CP, u, psi: CP, dt: float) -> CP:
        """psi CP [G, m, d] through H_g(t_k) = H0 + sum_k u[g, t, k] H_k,
        u [G, n_steps, k] (host or device), all steps of all groups as
        one [G, n_steps, d, d] stack in float64."""
        u = torch.as_tensor(u, dtype=F64, device=self.device)
        n_groups, n_steps, d = u.shape[0], u.shape[1], h0.shape[-1]
        if hs.shape[0]:
            mix = cpx.tensordot_weights(u, hs)
            h = CP(h0.re + mix.re, h0.im + mix.im)
        else:
            h = CP(h0.re.expand(n_groups, n_steps, d, d),
                   h0.im.expand(n_groups, n_steps, d, d))
        # ||dt H(t)|| <= |dt| max_t ||H(t)||_inf (H Hermitian)
        h_inf = float(torch.sqrt(h.re ** 2 + h.im ** 2).sum(-1).max())
        backend = "expm" if d < APPLY_MIN_DIM else "apply"
        return _dense_steps(h, psi, torch.tensor(dt, dtype=F64,
                                                 device=self.device),
                            abs(dt) * h_inf, TAYLOR_TOL, backend)

    def _run(self, ops, psi: CP, T0, T) -> CP:
        """States CP [m, d] over [T0, T] through ``ops`` (of
        :meth:`_operators`), the closures evaluated on the grid."""
        h0, hs, fns = ops
        ts, dt = self._grid(T0, T)
        u = np.array([[float(f(t, None)) for f in fns] for t in ts],
                     dtype=np.float64).reshape(len(ts), len(fns))
        return self._evolve(h0, hs, u[None], psi.reshape(1, -1, psi.shape[-1]),
                            dt)[0]

    def trotter(self, H_, psi0_, T0, T, **kw):
        """QuTiP-style list-of-[H, u] propagation (`sim_plain.py:119-153`),
        numpy in and out; arbitrary Python envelope closures are
        supported (as in the reference), evaluated on the host."""
        psi = self._run(self._operators(H_), self._state(psi0_), T0, T)
        return cpx.to_complex(psi)[0]

    # ---- measurement ---------------------------------------------------
    def _pauli_terms(self):
        return [(np.asarray(entry[0], dtype=np.complex128), float(entry[1]))
                for entry in self.Pauli_M]

    def _eigensystem(self, entry):
        """(eigenvalues on the host, eigenvectors as columns [d, n] on
        the device, complex128): the third item of a ``Pauli_M`` entry
        when given, else ``torch.linalg.eigh``."""
        if len(entry) > 2:
            evals, estates = entry[2]
            vecs = np.stack([_host(e).reshape(-1) for e in estates], axis=1)
            return np.asarray(evals, dtype=np.float64), torch.as_tensor(
                vecs.astype(np.complex128), device=self.device)
        m = torch.as_tensor(np.asarray(entry[0], dtype=np.complex128),
                            device=self.device)
        evals, vecs = torch.linalg.eigh(m)
        return evals.cpu().numpy(), vecs

    def stochastic_measure(self, psi, per_Pauli=100):
        """Shot-based Pauli estimation (`sim_plain.py:101-117`): the Born
        probabilities on the device, the shots drawn on the host."""
        rng = self._rng
        p = self._state(psi)
        z = torch.complex(p.re, p.im)
        ans = 0.0
        for entry in self.Pauli_M:
            weight = float(entry[1])
            evals, vecs = self._eigensystem(entry)
            probs = (vecs.conj().T @ z).abs().square().cpu().numpy()
            probs = probs / probs.sum()
            draws = rng.choice(len(evals), per_Pauli, p=probs)
            freqs = np.bincount(draws, minlength=len(evals)) / per_Pauli
            ans += weight * float(evals @ freqs)
        return ans

    def _measure(self, M: torch.Tensor, psi: CP, rng):
        """<psi|M|psi> (M complex128 on the device), shot-sampled and/or
        noisy as the facade's flags say."""
        if self.sampling_measure:
            v = self.stochastic_measure(psi)
        else:
            z = torch.complex(psi.re, psi.im)
            v = float(torch.vdot(z, M @ z).real)
        if self.is_noisy:
            v += rng.normal(scale=abs(v) / 5)
        return v

    def _observable(self, M) -> torch.Tensor:
        return torch.as_tensor(np.asarray(M, dtype=np.complex128),
                               device=self.device)

    # ---- gradients (reference algorithms, batched on the device) -------
    def compute_energy_grad_MC(self, M, H, initial_state, coeff=1.0):
        """The paper's MC estimator, the reference algorithm
        (`sim_plain.py:156-231`): the 2 n_hs branch kets evolve from s to
        T as one batch."""
        rng = self._rng
        s = rng.uniform() * self.T
        sc = self._coeff_np()
        n_hs = len(H) - 1

        phi_s = self._basis(float(s)).numpy()
        if canonical_kind(self.basis) in ("legendre", "bspline"):
            a = sc @ phi_s
            sig = 1.0 / (1.0 + np.exp(-a))
            dDdv = (2 * sig * (1 - sig) * np.asarray(self.omegas))[:, None] \
                * phi_s[None, :]
        else:
            # the reference's quirk, `sim_plain.py:224-230`: poly/Fourier
            # rows use the RAW basis values (no sigmoid chain factor)
            dDdv = np.broadcast_to(phi_s[None, :], sc.shape).copy()

        ops = self._operators(H)
        phi = self._run(ops, self._state(initial_state)[None], 0, s)[0]
        r = 0.5
        gates = cpx.from_complex(np.stack([np.asarray(H[i + 1][0])
                                           for i in range(n_hs)]),
                                 dtype=F64, device=self.device)
        hphi = cpx.matvec(gates, CP(phi.re.expand(n_hs, 1, -1),
                                    phi.im.expand(n_hs, 1, -1)))[:, 0]
        norm = 1.0 / math.sqrt(1 + r**2)
        # (I +- i r H_k) phi / sqrt(1 + r^2): p rows, then m rows
        kets = CP(norm * torch.cat([phi.re - r * hphi.im,
                                    phi.re + r * hphi.im]),
                  norm * torch.cat([phi.im + r * hphi.re,
                                    phi.im - r * hphi.re]))
        out = self._run(ops, kets, s, self.T)
        Md = self._observable(M)
        grad = np.zeros_like(sc)
        for i in range(n_hs):
            ps_p = self._measure(Md, out[i], rng)
            ps_m = self._measure(Md, out[n_hs + i], rng)
            ps = coeff * (1 + r**2) / (2 * r) * (ps_m - ps_p)
            grad[i] = ps * dDdv[i]
        return self._tensor(grad)

    def compute_energy_grad_FD(self, M, H, initial_state, delta=1e-3,
                               coeff=1.0):
        """Central finite differences (`sim_plain.py:308-353`): the pulses
        of ``generate_u`` at each perturbed coefficient set, all 2 n_hs
        n_basis sets evolved as one batch, measured in the reference's
        order."""
        rng = self._rng
        sc = self._coeff_np()
        n_hs = len(H) - 1
        sets = []
        for i in range(n_hs):
            for j in range(self.n_basis):
                for sign in (1.0, -1.0):
                    cf = sc.copy()
                    cf[i, j] += sign * delta
                    sets.append(cf)
        h0, hs, _ = self._operators([H[0]] + [[H[i + 1][0], None]
                                              for i in range(n_hs)])
        ts, dt = self._grid(0, self.T)
        a = torch.as_tensor(np.stack(sets)) @ self._basis(ts).T
        omg = torch.as_tensor(np.asarray(self.omegas, dtype=np.float64))
        u = ((torch.sigmoid(a) * 2 - 1) * omg[:, None]).transpose(1, 2)
        psi0 = self._state(initial_state)
        batch = CP(psi0.re.expand(len(sets), 1, -1),
                   psi0.im.expand(len(sets), 1, -1))
        out = self._evolve(h0, hs, u, batch, dt)
        Md = self._observable(M)
        vals = [self._measure(Md, out[g, 0], rng) for g in range(len(sets))]
        grad = np.zeros_like(sc)
        for i in range(n_hs):
            for j in range(self.n_basis):
                k = 2 * (i * self.n_basis + j)
                grad[i, j] = (vals[k] - vals[k + 1]) / (2 * delta)
        return self._tensor(grad)

    def _coeff_np(self) -> np.ndarray:
        c = self.spectral_coeff
        if c is None:
            raise RuntimeError("no spectral_coeff yet")
        return _host(c).astype(np.float64)

    # ---- training (the port's engine) ----------------------------------
    def _build(self, M, H0, Hs):
        ham = ControlledHamiltonian.create(np.asarray(H0),
                                           [np.asarray(h) for h in Hs],
                                           dtype=torch.float32,
                                           device=self.device)
        terms = self._pauli_terms() if self.Pauli_M else None
        meas = Measurement.create(np.asarray(M, dtype=np.complex128),
                                  terms=terms,
                                  dtype=torch.float32, device=self.device,
                                  sampling=self.sampling_measure,
                                  noisy=self.is_noisy)
        return ham, self._envelope(), meas

    def _config(self, grad_mode):
        return TrainConfig(n_basis=self.n_basis, basis=self.basis,
                           n_epoch=self.n_epoch, lr=self.lr,
                           is_noisy=self.is_noisy,
                           sampling_measure=self.sampling_measure,
                           per_step=self.per_step, n_step=self.n_step,
                           grad_mode=grad_mode)

    def _states(self, states) -> CP:
        return cpx.from_complex(np.stack([_host(p).reshape(-1)
                                          for p in states]).astype(
                                              np.complex128),
                                dtype=torch.float32, device=self.device)

    def _finish(self, res):
        self.losses_energy = res.losses_energy
        self.final_state = cpx.to_complex(res.final_state)
        self.spectral_coeff = self._tensor(res.coeff)
        return self.spectral_coeff

    def _fit_energy(self, M, H0, Hs, initial_state, cfg):
        ham, env, meas = self._build(M, H0, Hs)
        psi0 = cpx.from_complex(
            _host(initial_state).astype(np.complex128).reshape(-1),
            dtype=torch.float32, device=self.device)
        return self._finish(_train_energy(ham, env, meas, psi0, self.T, cfg,
                                          logger=self.logger))

    def train_energy(self, M, H0, Hs, initial_state):
        """Reference `sim_plain.py:245-305` — MC gradients, Adam."""
        return self._fit_energy(M, H0, Hs, initial_state,
                                  self._config("mc"))

    def train_energy_FD(self, M, H0, Hs, initial_state, delta=1e-3):
        """Reference `sim_plain.py:355-412` — FD gradients."""
        return self._fit_energy(M, H0, Hs, initial_state,
                                  self._config("fd").replace(fd_delta=delta))

    def train_fidelity(self, H0, Hs, initial_states, target_states):
        """Reference `sim_plain.py:414-475` — per-pair MC steps."""
        ham = ControlledHamiltonian.create(np.asarray(H0),
                                           [np.asarray(h) for h in Hs],
                                           dtype=torch.float32,
                                           device=self.device)
        return self._finish(_train_fidelity(
            ham, self._envelope(), self._states(initial_states),
            self._states(target_states), self.T, self._config("mc"),
            logger=self.logger, per_pair=True))

    def save_plot(self, plot_name):
        """Waveform plot — ENABLED (the reference's is dead code behind an
        early return, `sim_plain.py:233-243`)."""
        if self.spectral_coeff is None:
            return
        from ..utils.plotting import save_pulse_plot
        save_pulse_plot(self._envelope(), self._coeff_np(), self.T,
                        f"{self.log_name}_{plot_name}.png")
