"""Plain reference of the pulse-level ring MaxCut trainer.

Written from the problem's definition in plain PyTorch, with no kernel
and nothing of the program under test (nor of JAX). It computes, in the
real dtype it is given (float32 in the benchmark, float64 in the tests'
oracle checks), what one job of the seed trainer computes:

- the ring graph on n qubits (qubit 0 is the most significant bit), one
  Z_i Z_j control per edge (strength omega0) and one X control per qubit
  (omega1), the cost M = -1/2 sum_e (1 - Z_i Z_j) and the uniform
  superposition as the initial state; horizon T = pi (1/omega0 +
  1/omega1);
- the envelope u_k(t) = (2 sigmoid(sum_j c_kj phi_j(t / T)) - 1) omega_k
  on the quadratic B-spline bump basis (tau = 1 / (n_basis - 2), centre
  tau (j - 1.5), support +-1.5 tau, peak 1), sampled at the left end of
  each of the n_steps equal segments of [t0, t1];
- the Strang chain: per step exp(-i dt/2 D) prod_q exp(-i dt u_q X_q)
  exp(-i dt/2 D), D = sum_e u_e Z_i Z_j;
- the exact objective <psi|M|psi> and its gradient by autograd, each
  step recomputed in the backward pass (checkpointed), so that 20 qubits
  fit;
- the Monte-Carlo estimator: split time s, leg 0 -> s, the gates
  (1 +- r i H_k) / sqrt(1 + r^2) with r = 1/2, leg s -> T for each
  branch, ps_k = (1 + r^2) / (2 r) (<M>_- - <M>_+), times
  dD_k(s)/dc_kj = 2 sigmoid'(a_k) omega_k phi_j(s), averaged over the
  samples; split times drawn as the trainer draws them: u ~ U[0, 1)
  float64 from a generator on the state's device seeded with seed + 1,
  [seeds, samples] an epoch, s = u T ('iid') or (i + u_i) T / N
  ('stratified');
- Adam (beta 0.9, 0.999, eps 1e-8, bias-corrected), written out.

``matmul_round`` rounds both inputs of each matrix product (the envelope
expansion and the diagonal phase table) to a narrower mantissa: the
benchmark's lower-precision control passes :func:`tf32_round`, which
keeps TF32's 10 bits, as the tensor cores do in a TF32 product.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


def set_exact_matmul():
    """Turn TF32 off for float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits; the
    gradient passes through unchanged."""
    if x.dtype != torch.float32:
        raise ValueError("tf32_round takes float32")
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x1000) & -0x2000  # -0x2000 is the mask 0xFFFFE000
    return x + (i.view(torch.float32) - x).detach()


def _keep(x):
    return x


class RingMaxCut:
    """The problem and its evolution on ``device`` in ``dtype``."""

    def __init__(self, n_qubits: int, n_basis: int, per_step: int,
                 mc_steps: int, omega0: float = math.pi,
                 omega1: float = math.pi, dtype=torch.float32,
                 device="cpu", matmul_round=None):
        self.n, self.d = n_qubits, 2**n_qubits
        self.n_basis, self.dtype = n_basis, dtype
        self.device = torch.device(device)
        self.T = math.pi * (1.0 / omega0 + 1.0 / omega1)
        # int(per_step * (T + 1)), the trainer's step-count rule
        self.n_steps = int(per_step * (self.T + 1.0))
        self.mc_steps = mc_steps
        self.edges = [(i, (i + 1) % n_qubits) for i in range(n_qubits)]
        self.n_controls = len(self.edges) + n_qubits
        self.omegas = torch.tensor([omega0] * len(self.edges)
                                   + [omega1] * n_qubits, dtype=dtype,
                                   device=self.device)
        j = torch.arange(self.d, device=self.device)
        bit = [((j >> (n_qubits - 1 - q)) & 1) for q in range(n_qubits)]
        zz = torch.stack([torch.where(bit[a] == bit[b], 1.0, -1.0)
                          for a, b in self.edges]).to(dtype)
        self.zz = zz                                     # [E, d]
        self.cost = -0.5 * (1.0 - zz).sum(0)             # [d]
        self.rnd = matmul_round or _keep

    # --- envelope -----------------------------------------------------
    def basis(self, t: torch.Tensor) -> torch.Tensor:
        """phi_j(t / T), float64 t [...] -> [..., n_basis] in dtype."""
        tn = (t / self.T)[..., None]
        tau = 1.0 / (self.n_basis - 2.0)
        centre = tau * (torch.arange(self.n_basis, dtype=torch.float64,
                                     device=t.device) - 1.5)
        lo, hi = centre - 1.5 * tau, centre + 1.5 * tau
        val = (tn - lo) * (tn - hi) / (-(1.5 * tau) ** 2)
        val = torch.where((tn > lo) & (tn < hi), val, torch.zeros_like(val))
        return val.to(self.dtype)

    def grid(self, t0: torch.Tensor, t1: torch.Tensor, n_steps: int):
        """(dt [G], left-end times [G, n_steps]) in float64 for per-member
        ends t0, t1 [G]."""
        dt = (t1 - t0) / n_steps
        k = torch.arange(n_steps, dtype=torch.float64, device=t0.device)
        return dt, t0[:, None] + dt[:, None] * k

    def amplitudes(self, c: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """u [G, n_controls, n_t] for coefficients c [G, n_controls,
        n_basis] on times ts [G, n_t]."""
        phi = self.basis(ts)                              # [G, n_t, nb]
        a = torch.matmul(self.rnd(c), self.rnd(phi.transpose(1, 2)))
        return (2.0 * torch.sigmoid(a) - 1.0) * self.omegas[:, None]

    # --- chain ----------------------------------------------------------
    def psi0(self, batch: int):
        amp = 1.0 / math.sqrt(self.d)
        re = torch.full((batch, self.d), amp, dtype=self.dtype,
                        device=self.device)
        return re, torch.zeros_like(re)

    def _rx(self, re, im, theta, q):
        """exp(-i theta X_q) on a batch [B, d] with angles theta [B]."""
        shape = (re.shape[0], 2**q, 2, 2 ** (self.n - q - 1))
        r, i = re.reshape(shape), im.reshape(shape)
        c = torch.cos(theta).reshape(-1, 1, 1, 1)
        s = torch.sin(theta).reshape(-1, 1, 1, 1)
        fr, fi = r.flip(2), i.flip(2)   # X swaps the pair
        # cos psi - i sin X psi
        return ((c * r + s * fi).reshape(re.shape),
                (c * i - s * fr).reshape(im.shape))

    def _step(self, re, im, dt, u_diag, u_x):
        """One Strang step; dt [B], u_diag [B, E], u_x [B, n]."""
        half = (0.5 * dt)[:, None] * torch.matmul(self.rnd(u_diag),
                                                  self.rnd(self.zz))
        pc, ps = torch.cos(half), -torch.sin(half)
        re, im = pc * re - ps * im, pc * im + ps * re
        for q in range(self.n):
            re, im = self._rx(re, im, dt * u_x[:, q], q)
        return pc * re - ps * im, pc * im + ps * re

    def evolve(self, c, re, im, t0, t1, n_steps: int, taped: bool = False):
        """Evolve the batch (re, im) [B, d] from t0 to t1 (float64 [B])
        under coefficients c [B, n_controls, n_basis]."""
        dt, ts = self.grid(t0, t1, n_steps)
        u = self.amplitudes(c, ts)                       # [B, n_c, T]
        dtc = dt.to(self.dtype)
        n_e = len(self.edges)
        for k in range(n_steps):
            args = (re, im, dtc, u[:, :n_e, k], u[:, n_e:, k])
            if taped:
                re, im = checkpoint(self._step, *args, use_reentrant=False)
            else:
                re, im = self._step(*args)
        return re, im

    def energy(self, re, im) -> torch.Tensor:
        return ((re * re + im * im) * self.cost).sum(-1)

    def energies(self, c: torch.Tensor) -> torch.Tensor:
        """Exact <M> at T of each member of c [B, n_controls, n_basis]."""
        b = c.shape[0]
        z = torch.zeros(b, dtype=torch.float64, device=self.device)
        re, im = self.evolve(c, *self.psi0(b), z, z + self.T, self.n_steps)
        return self.energy(re, im)

    def energy_and_grad(self, c: torch.Tensor):
        """(<M> [B], d sum<M> / dc [B, n_controls, n_basis]) by autograd."""
        c = c.detach().requires_grad_(True)
        b = c.shape[0]
        z = torch.zeros(b, dtype=torch.float64, device=self.device)
        with torch.enable_grad():
            re, im = self.evolve(c, *self.psi0(b), z, z + self.T,
                                 self.n_steps, taped=True)
            e = self.energy(re, im)
            (g,) = torch.autograd.grad(e.sum(), c)
        return e.detach(), g

    # --- Monte-Carlo estimator ------------------------------------------
    def apply_terms(self, re, im):
        """H_k psi for every control k: [B, n_controls, d] (re, im)."""
        out_re = [self.zz[e] * re for e in range(len(self.edges))]
        out_im = [self.zz[e] * im for e in range(len(self.edges))]
        for q in range(self.n):
            shape = (re.shape[0], 2**q, 2, 2 ** (self.n - q - 1))
            out_re.append(re.reshape(shape).flip(2).reshape(re.shape))
            out_im.append(im.reshape(shape).flip(2).reshape(im.shape))
        return torch.stack(out_re, 1), torch.stack(out_im, 1)

    def mc_grad(self, c: torch.Tensor, s: torch.Tensor, r: float = 0.5,
                chunk: int = 1 << 27):
        """MC gradient of each member, averaged over its samples: c [B,
        n_c, n_b], split times s float64 [B, S]. The branches evolve in
        blocks of at most ``chunk`` amplitudes."""
        b, n_s = s.shape
        cs = c.repeat_interleave(n_s, 0)                 # [B S, n_c, n_b]
        sf = s.reshape(-1)
        z = torch.zeros_like(sf)
        re, im = self.evolve(cs, *self.psi0(b * n_s), z, sf, self.mc_steps)
        h_re, h_im = self.apply_terms(re, im)            # [BS, n_c, d]
        k = 1.0 / math.sqrt(1.0 + r * r)
        plus = ((re[:, None] - r * h_im) * k, (im[:, None] + r * h_re) * k)
        minus = ((re[:, None] + r * h_im) * k, (im[:, None] - r * h_re) * k)
        nc = self.n_controls
        e_pm = []
        for br_re, br_im in (plus, minus):
            vals = []
            per = max(1, chunk // (nc * self.d))
            for i in range(0, b * n_s, per):
                j = min(b * n_s, i + per)
                m = (j - i) * nc
                o_re, o_im = self.evolve(
                    cs[i:j].repeat_interleave(nc, 0),
                    br_re[i:j].reshape(m, self.d),
                    br_im[i:j].reshape(m, self.d),
                    sf[i:j].repeat_interleave(nc),
                    torch.full((m,), self.T, dtype=torch.float64,
                               device=self.device), self.mc_steps)
                vals.append(self.energy(o_re, o_im).reshape(j - i, nc))
            e_pm.append(torch.cat(vals))
        ps = (1.0 + r * r) / (2.0 * r) * (e_pm[1] - e_pm[0])  # [BS, n_c]
        phi = self.basis(sf)                               # [BS, n_b]
        a = (cs * phi[:, None, :]).sum(-1)
        sig = torch.sigmoid(a)
        dd = (2.0 * sig * (1.0 - sig) * self.omegas)[..., None] \
            * phi[:, None, :]
        g = ps[..., None] * dd
        return g.reshape(b, n_s, nc, self.n_basis).mean(1)


def split_times(generator: torch.Generator, n_seeds: int, n_samples: int,
                strategy: str, T: float) -> torch.Tensor:
    """One epoch's split times [n_seeds, n_samples], float64, drawn on
    the generator's device."""
    u = torch.rand((n_seeds, n_samples), generator=generator,
                   dtype=torch.float64, device=generator.device)
    if strategy == "iid":
        return u * T
    if strategy == "stratified":
        i = torch.arange(n_samples, dtype=torch.float64, device=u.device)
        return (i + u) * (T / n_samples)
    raise ValueError(f"unknown split-time strategy {strategy!r}")


class Adam:
    """Adam over one tensor, as torch.optim.Adam defines it."""

    def __init__(self, p: torch.Tensor, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.p = p.detach().clone()
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = torch.zeros_like(self.p)
        self.v = torch.zeros_like(self.p)
        self.t = 0

    def step(self, g: torch.Tensor) -> torch.Tensor:
        self.t += 1
        self.m = self.b1 * self.m + (1.0 - self.b1) * g
        self.v = self.b2 * self.v + (1.0 - self.b2) * g * g
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        denom = self.v.sqrt() / math.sqrt(bc2) + self.eps
        self.p = self.p - (self.lr / bc1) * self.m / denom
        return self.p


GRAPHS = ("ring",)


def build(config: dict, device, matmul_round=None) -> RingMaxCut:
    """The problem that a benchmark configuration states, in its dtype;
    refuses a configuration whose declared keys (``graph``, ``T``,
    ``n_steps``, ``n_controls``) differ from what it builds."""
    if config["graph"] not in GRAPHS:
        raise ValueError(f"graph {config['graph']!r}: the reference builds "
                         f"{GRAPHS}")
    p = RingMaxCut(int(config["n_qubits"]), int(config["n_basis"]),
                   int(config["per_step"]), int(config["mc_steps"]),
                   omega0=float(config["omega0"]),
                   omega1=float(config["omega1"]),
                   dtype=getattr(torch, config["dtype"]), device=device,
                   matmul_round=matmul_round)
    built = {"T": p.T, "n_steps": p.n_steps, "n_controls": p.n_controls}
    bad = {k: (config[k], v) for k, v in built.items()
           if not math.isclose(float(config[k]), float(v), rel_tol=1e-12)}
    if bad:
        raise ValueError("the configuration declares what the reference "
                         "does not build (declared, built): " + repr(bad))
    return p


def replay(problem: RingMaxCut, c0: torch.Tensor, lr: float, epochs: int,
           mc=None):
    """The first ``epochs`` epochs of one job for the members c0 [B, n_c,
    n_b], the reference on its own: (losses [epochs + 1, B] with the
    energy after the last update last, the gradient of each epoch
    [epochs, B, n_c, n_b], coefficients after each update [epochs, B,
    n_c, n_b]). ``mc``: None for the adjoint, else a callable epoch ->
    split times [B, S] (the members' own rows), called once an epoch in
    epoch order."""
    opt = Adam(c0, lr)
    losses, grads, params = [], [], []
    for e in range(epochs):
        loss, g = _loss_and_grad(problem, opt.p, mc, e)
        losses.append(loss)
        grads.append(g)
        params.append(opt.step(g))
    with torch.no_grad():
        losses.append(problem.energies(opt.p))
    return torch.stack(losses), torch.stack(grads), torch.stack(params)


def follow(problem: RingMaxCut, cs: torch.Tensor, grads: torch.Tensor,
           lr: float, mc=None):
    """The reference beside a program's job, step by step from the
    program's own state: ``cs`` [epochs + 1, B, n_c, n_b] the program's
    coefficients before each update and after the last, ``grads``
    [epochs, B, n_c, n_b] the gradients its optimizer got. Returns (the
    energy at each of ``cs`` [epochs + 1, B], the gradient at each but
    the last [epochs, B, n_c, n_b], and Adam from ``cs[0]`` fed
    ``grads``: the coefficients after each update [epochs, B, n_c,
    n_b]). ``mc`` as for :func:`replay`."""
    cs = cs.to(problem.dtype)
    losses, ref_grads = [], []
    for e in range(grads.shape[0]):
        loss, g = _loss_and_grad(problem, cs[e], mc, e)
        losses.append(loss)
        ref_grads.append(g)
    with torch.no_grad():
        losses.append(problem.energies(cs[-1]))
    opt = Adam(cs[0], lr)
    params = [opt.step(g) for g in grads.to(problem.dtype)]
    return torch.stack(losses), torch.stack(ref_grads), torch.stack(params)


def _loss_and_grad(problem: RingMaxCut, c: torch.Tensor, mc, epoch: int):
    if mc is None:
        return problem.energy_and_grad(c)
    with torch.no_grad():
        return problem.energies(c), problem.mc_grad(c, mc(epoch))
