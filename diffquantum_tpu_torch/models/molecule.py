"""Ab-initio molecular VQE — the port of
:mod:`diffquantum_tpu.models.molecule`: H2 at any bond length and
hydrogen clusters (chains, H3+, ...) in STO-3G, from integrals to
pulse-level training.

The host part is a copy of the JAX package's numpy, so it computes the
same floats in the same order:

  1. STO-3G s-type Gaussian integrals (overlap / kinetic / nuclear
     attraction / ERI) in closed form via the Boys function;
  2. molecular orbitals: the symmetry orbitals of H2, restricted
     Hartree-Fock (:func:`rhf_scf`) for a cluster;
  3. the second-quantized electronic Hamiltonian, dense through
     Jordan-Wigner ladder matrices up to 8 spin orbitals, as Pauli strings
     by symbolic Jordan-Wigner (:func:`jw_pauli_terms`) past that;
  4. Pauli-string decompositions feeding the matrix-free
     :class:`..measure.PauliStringSet`, plus a particle-number penalty;
  5. a pulse-level VQE problem with hardware-style drives on ``device``:
     dense operators up to 8 spin orbitals, the structured {X, Y, hop,
     ZZ} set past that (the fused engines: K1/K2 at 10-17 qubits, K6 at
     19-24).

Oracles: the dense FCI ground energy, the sector-projected FCI from the
strings (:func:`sector_fci_from_strings`, on the device in float64), and
the RHF energy, which the strings reproduce on the RHF determinant.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.special import erf

from ..dynamics.hamiltonian import ControlledHamiltonian, TermStructure
from ..measure import Measurement, PauliStringSet, _parse_pauli_label
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.envelope import SimpleEnvelope
from ..utils.device import resolve_device

ANGSTROM_TO_BOHR = 1.8897259886

# STO-3G hydrogen 1s: (exponent, contraction) with zeta = 1.24 scaling
STO3G_H = [(3.42525091, 0.15432897),
           (0.62391373, 0.53532814),
           (0.16885540, 0.44463454)]


def _boys0(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, dtype=float)
    small = t < 1e-12
    ts = np.where(small, 1.0, t)
    return np.where(small, 1.0, 0.5 * np.sqrt(np.pi / ts)
                    * erf(np.sqrt(ts)))


def _prims():
    """Normalized primitive (exponent, coefficient) pairs."""
    return [(a, c * (2.0 * a / np.pi) ** 0.75) for a, c in STO3G_H]


def h2_integrals(r_bohr: float):
    """AO integrals for two H 1s STO-3G functions separated by r (bohr):
    (S12, h_core [2,2], eri [2,2,2,2] chemist (ij|kl), E_nuc)."""
    centers = [np.zeros(3), np.array([0.0, 0.0, r_bohr])]
    prims = _prims()

    def s_kin_nuc(ca, cb):
        A, B = centers[ca], centers[cb]
        ab2 = float(np.dot(A - B, A - B))
        s = t = v = 0.0
        for a, na in prims:
            for b, nb in prims:
                p = a + b
                mu = a * b / p
                k = np.exp(-mu * ab2)
                pref = na * nb * (np.pi / p) ** 1.5 * k
                s += pref
                t += pref * mu * (3.0 - 2.0 * mu * ab2)
                P = (a * A + b * B) / p
                for C in centers:  # both nuclei, Z = 1
                    pc2 = float(np.dot(P - C, P - C))
                    v -= na * nb * 2.0 * np.pi / p * k * _boys0(p * pc2)
        return s, t + v

    s11, h11 = s_kin_nuc(0, 0)
    s12, h12 = s_kin_nuc(0, 1)
    h = np.array([[h11, h12], [h12, h11]])

    def eri(ci, cj, ck, cl):
        """(ij|kl) chemist notation."""
        A, B, C, D = (centers[x] for x in (ci, cj, ck, cl))
        out = 0.0
        for a, na in prims:
            for b, nb in prims:
                p = a + b
                P = (a * A + b * B) / p
                kab = np.exp(-a * b / p * float(np.dot(A - B, A - B)))
                for c, nc in prims:
                    for d, nd in prims:
                        q = c + d
                        Q = (c * C + d * D) / q
                        kcd = np.exp(-c * d / q
                                     * float(np.dot(C - D, C - D)))
                        t = p * q / (p + q) * float(np.dot(P - Q, P - Q))
                        out += (na * nb * nc * nd
                                * 2.0 * np.pi ** 2.5
                                / (p * q * np.sqrt(p + q))
                                * kab * kcd * _boys0(t))
        return out

    g = np.zeros((2, 2, 2, 2))
    for i in range(2):
        for j in range(2):
            for k in range(2):
                for l in range(2):
                    g[i, j, k, l] = eri(i, j, k, l)
    e_nuc = 1.0 / r_bohr
    return s12, h, g, e_nuc


def h2_mo_integrals(r_bohr: float):
    """Spatial MO integrals using the exact symmetry orbitals
    g = (1+2)/sqrt(2(1+S)), u = (1-2)/sqrt(2(1-S)):
    (h_mo [2,2] diagonal, g_mo [2,2,2,2] chemist, E_nuc)."""
    s12, h, g, e_nuc = h2_integrals(r_bohr)
    cg = np.array([1.0, 1.0]) / np.sqrt(2.0 * (1.0 + s12))
    cu = np.array([1.0, -1.0]) / np.sqrt(2.0 * (1.0 - s12))
    c = np.stack([cg, cu], axis=1)           # [ao, mo]
    h_mo = c.T @ h @ c
    g_mo = np.einsum("ijkl,ip,jq,kr,ls->pqrs", g, c, c, c, c)
    return h_mo, g_mo, e_nuc


def h2_electronic_hamiltonian(r_angstrom: float):
    """Dense 16 x 16 electronic Hamiltonian in the 4-spin-orbital Fock
    space (Jordan-Wigner order: g-up, g-down, u-up, u-down), plus E_nuc.

    H = sum h_pq a+_p a_q + 1/2 sum <pq|rs> a+_p a+_q a_s a_r with
    <pq|rs> = (pr|qs) spin-matched."""
    h_mo, g_mo, e_nuc = h2_mo_integrals(r_angstrom * ANGSTROM_TO_BOHR)
    n_so = 4

    def spatial(p):
        return p // 2

    def spin(p):
        return p % 2

    # dense JW ladder operators on 4 qubits (qubit p = spin orbital p)
    sm = np.array([[0.0, 1.0], [0.0, 0.0]])   # |0><1| annihilates
    z = np.diag([1.0, -1.0])
    eye = np.eye(2)

    def ann(p):
        ops = [z] * p + [sm] + [eye] * (n_so - p - 1)
        out = np.array([[1.0 + 0j]])
        for o in ops:
            out = np.kron(out, o)
        return out

    a = [ann(p) for p in range(n_so)]
    ad = [m.conj().T for m in a]

    H = np.zeros((2**n_so, 2**n_so), dtype=complex)
    for p in range(n_so):
        for q in range(n_so):
            if spin(p) == spin(q):
                H += h_mo[spatial(p), spatial(q)] * (ad[p] @ a[q])
    for p in range(n_so):
        for q in range(n_so):
            for r in range(n_so):
                for s in range(n_so):
                    if spin(p) == spin(r) and spin(q) == spin(s):
                        v = g_mo[spatial(p), spatial(r),
                                 spatial(q), spatial(s)]
                        H += 0.5 * v * (ad[p] @ ad[q] @ a[s] @ a[r])
    return H, e_nuc


_PAULIS = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
           "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1.0, -1.0])}


def pauli_decompose(H: np.ndarray, tol: float = 1e-10):
    """Numerically exact (label, weight) decomposition of a Hermitian
    matrix on n qubits: w_P = tr(P H) / 2^n."""
    n = int(round(np.log2(H.shape[0])))
    import itertools
    terms = []
    for labels in itertools.product("IXYZ", repeat=n):
        p = np.array([[1.0 + 0j]])
        for ch in labels:
            p = np.kron(p, _PAULIS[ch])
        w = np.real_if_close(np.trace(p @ H)) / 2**n
        if abs(w) > tol:
            if abs(np.imag(w)) > 1e-9:
                raise ValueError("non-Hermitian input")
            terms.append(("".join(labels), float(np.real(w))))
    return terms


@dataclasses.dataclass
class MoleculeProblem:
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    measurement: Measurement
    psi0: CP
    T: float
    exact_ground_energy: float   # electronic (add e_nuc for total)
    e_nuc: float
    terms: list


def build_h2_at(r_angstrom: float, n_basis: int = 6, basis: str = "bspline",
                T: float = 2.0, omega: float = np.pi, dtype=torch.float32,
                sampling: bool = False, noisy: bool = False,
                device="cuda") -> MoleculeProblem:
    """Pulse-level VQE problem for H2 at bond length ``r_angstrom`` (4-qubit
    Jordan-Wigner encoding, matrix-free string measurement) on
    ``device``. The initial state is the Hartree-Fock determinant |1100>
    (sigma_g doubly occupied)."""
    dev = resolve_device(device)
    H, e_nuc = h2_electronic_hamiltonian(r_angstrom)
    terms = pauli_decompose(H)
    exact = float(np.linalg.eigvalsh(H)[0])

    meas = Measurement.create_strings(terms, dtype=dtype, device=dev,
                                      sampling=sampling, noisy=noisy)
    # hardware-style drives: X and Y per qubit + nearest-neighbor XX/ZZ
    Hs, omegas = [], []
    for q in range(4):
        for ax in ("X", "Y"):
            Hs.append(linalg.pauli_string("".join(
                ax if p == q else "I" for p in range(4))))
            omegas.append(omega)
    for i in range(3):
        for kind in ("XX", "ZZ"):
            Hs.append(linalg.pauli_string("".join(
                kind[0] if p in (i, i + 1) else "I" for p in range(4))))
            omegas.append(omega)
    ham = ControlledHamiltonian.create(np.zeros((16, 16)), Hs, dtype=dtype,
                                       device=dev)
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=tuple(omegas))
    psi0 = cpx.from_complex(linalg.basis_state(0b1100, 16), dtype=dtype,
                            device=dev)
    return MoleculeProblem(ham=ham, envelope=env, measurement=meas,
                           psi0=psi0, T=float(T),
                           exact_ground_energy=exact, e_nuc=e_nuc,
                           terms=terms)


# ---------------------------------------------------------------------------
# general hydrogen clusters (H3+, H4 chains, ...): arbitrary centers, RHF SCF
# ---------------------------------------------------------------------------

def cluster_integrals(centers_bohr, charges=None):
    """STO-3G AO integrals for hydrogen 1s functions at arbitrary centers:
    (S [m,m], h_core [m,m], eri [m,m,m,m] chemist (ij|kl), E_nuc)."""
    centers = [np.asarray(c, dtype=float) for c in centers_bohr]
    if charges is None:
        charges = [1.0] * len(centers)
    m = len(centers)
    prims = _prims()

    S = np.zeros((m, m))
    h = np.zeros((m, m))
    for i in range(m):
        for j in range(i, m):
            A, B = centers[i], centers[j]
            ab2 = float(np.dot(A - B, A - B))
            s = t = v = 0.0
            for a, na in prims:
                for b, nb in prims:
                    p = a + b
                    mu = a * b / p
                    k = np.exp(-mu * ab2)
                    pref = na * nb * (np.pi / p) ** 1.5 * k
                    s += pref
                    t += pref * mu * (3.0 - 2.0 * mu * ab2)
                    P = (a * A + b * B) / p
                    for C, Z in zip(centers, charges):
                        pc2 = float(np.dot(P - C, P - C))
                        v -= Z * na * nb * 2.0 * np.pi / p * k \
                            * _boys0(p * pc2)
            S[i, j] = S[j, i] = s
            h[i, j] = h[j, i] = t + v

    g = np.zeros((m, m, m, m))
    done = np.zeros((m, m, m, m), dtype=bool)
    for i in range(m):
        for j in range(m):
            for k_ in range(m):
                for l in range(m):
                    if done[i, j, k_, l]:
                        continue
                    A, B, C, D = centers[i], centers[j], centers[k_], \
                        centers[l]
                    out = 0.0
                    for a, na in prims:
                        for b, nb in prims:
                            p = a + b
                            P = (a * A + b * B) / p
                            kab = np.exp(-a * b / p
                                         * float(np.dot(A - B, A - B)))
                            for c, nc in prims:
                                for d, nd in prims:
                                    q = c + d
                                    Q = (c * C + d * D) / q
                                    kcd = np.exp(
                                        -c * d / q
                                        * float(np.dot(C - D, C - D)))
                                    t = p * q / (p + q) \
                                        * float(np.dot(P - Q, P - Q))
                                    out += (na * nb * nc * nd
                                            * 2.0 * np.pi ** 2.5
                                            / (p * q * np.sqrt(p + q))
                                            * kab * kcd * _boys0(t))
                    # 8-fold permutational symmetry
                    for (w, x, y, z) in ((i, j, k_, l), (j, i, k_, l),
                                         (i, j, l, k_), (j, i, l, k_),
                                         (k_, l, i, j), (l, k_, i, j),
                                         (k_, l, j, i), (l, k_, j, i)):
                        g[w, x, y, z] = out
                        done[w, x, y, z] = True
    e_nuc = sum(charges[i] * charges[j]
                / float(np.linalg.norm(centers[i] - centers[j]))
                for i in range(m) for j in range(i + 1, m))
    return S, h, g, e_nuc


def rhf_scf(S, h, g, n_occ, max_iter: int = 200, tol: float = 1e-12):
    """Closed-shell restricted Hartree-Fock by fixed-point Fock iteration
    with symmetric orthogonalization. Returns (E_elec, C [ao, mo])."""
    ev, U = np.linalg.eigh(S)
    X = U @ np.diag(ev ** -0.5) @ U.T          # S^{-1/2}
    C = None
    D = np.zeros_like(S)
    e_old = 0.0
    for _ in range(max_iter):
        J = np.einsum("ijkl,kl->ij", g, D)
        K = np.einsum("ikjl,kl->ij", g, D)
        F = h + J - 0.5 * K
        _, Cp = np.linalg.eigh(X.T @ F @ X)
        C = X @ Cp
        occ = C[:, :n_occ]
        D = 2.0 * occ @ occ.T
        e = np.sum(D * (h + F)) / 2.0
        if abs(e - e_old) < tol:
            break
        e_old = e
    return float(e), C


def cluster_electronic_hamiltonian(coords_angstrom, charge: int = 0):
    """(dense 2^{2m} x 2^{2m} electronic Hamiltonian in the RHF-MO
    spin-orbital basis, E_nuc, E_RHF_total) for a hydrogen cluster with
    ``m`` atoms and ``m - charge`` electrons (JW order: mo0-up, mo0-down,
    mo1-up, ...)."""
    centers = [np.asarray(c, dtype=float) * ANGSTROM_TO_BOHR
               for c in coords_angstrom]
    m = len(centers)
    n_elec = m - charge
    if n_elec % 2:
        raise ValueError("closed-shell RHF needs an even electron count")
    S, h, g, e_nuc = cluster_integrals(centers)
    e_rhf, C = rhf_scf(S, h, g, n_elec // 2)
    h_mo = C.T @ h @ C
    g_mo = np.einsum("ijkl,ip,jq,kr,ls->pqrs", g, C, C, C, C)

    n_so = 2 * m
    sm = np.array([[0.0, 1.0], [0.0, 0.0]])
    z = np.diag([1.0, -1.0])
    eye2 = np.eye(2)

    def ann(p):
        ops = [z] * p + [sm] + [eye2] * (n_so - p - 1)
        out = np.array([[1.0 + 0j]])
        for o in ops:
            out = np.kron(out, o)
        return out

    a = [ann(p) for p in range(n_so)]
    ad = [x.conj().T for x in a]
    H = np.zeros((2**n_so, 2**n_so), dtype=complex)
    for p in range(n_so):
        for q in range(n_so):
            if p % 2 == q % 2:
                H += h_mo[p // 2, q // 2] * (ad[p] @ a[q])
    # precompute pair products to keep the two-body loop O(n^4) matmuls
    for p in range(n_so):
        for q in range(n_so):
            if p == q:
                continue
            left = ad[p] @ ad[q]
            for r in range(n_so):
                if p % 2 != r % 2:
                    continue
                for s in range(n_so):
                    if q % 2 != s % 2 or s == r:
                        continue
                    v = g_mo[p // 2, r // 2, q // 2, s // 2]
                    if abs(v) < 1e-14:
                        continue
                    H += 0.5 * v * (left @ (a[s] @ a[r]))
    return H, e_nuc, float(e_rhf + e_nuc)


def pauli_decompose_fast(H: np.ndarray, tol: float = 1e-10):
    """(label, weight) decomposition via the signed-permutation form of each
    Pauli string: tr(P H) = sum_k f(k xor m) H[k xor m, k] — O(d) per string
    instead of a dense d x d matmul (needed at 8+ qubits)."""
    import itertools

    n = int(round(np.log2(H.shape[0])))
    d = 2**n
    ks = np.arange(d)
    terms = []
    for labels in itertools.product("IXYZ", repeat=n):
        flip, yz, n_y = _parse_pauli_label("".join(labels))
        kp = ks ^ flip
        par = np.bitwise_count(kp & yz) & 1 if hasattr(np, "bitwise_count") \
            else np.array([bin(x & yz).count("1") & 1 for x in kp])
        f = (1j ** n_y) * (1.0 - 2.0 * par)
        w = np.sum(f * H[kp, ks]) / d
        if abs(w) > tol:
            terms.append(("".join(labels), float(np.real(w))))
    return terms


# ---------------------------------------------------------------------------
# symbolic Jordan-Wigner: Pauli terms straight from MO integrals — no dense
# 2^n x 2^n ladder matrices, so molecules scale to 12+ spin orbitals (H6+)
# ---------------------------------------------------------------------------

def _string_mul(s1, s2):
    """Product of symplectic Pauli reps (xmask, zmask, coeff):
    (X^a Z^b)(X^c Z^d) = (-1)^{|b & c|} X^{a^c} Z^{b^d} per site."""
    a, b, c1 = s1
    c, d, c2 = s2
    sign = -1.0 if (bin(b & c).count("1") & 1) else 1.0
    return (a ^ c, b ^ d, c1 * c2 * sign)


def _ladder_strings(p: int, n_so: int, dagger: bool):
    """a_p (or a^dag_p) as two symplectic strings: Zchain X_p (I -/+ Z_p)/2
    (qubit 0 = MSB, matching the dense ladder construction)."""
    bit = 1 << (n_so - 1 - p)
    chain = 0
    for q in range(p):
        chain |= 1 << (n_so - 1 - q)
    s = 0.5 if dagger else -0.5
    return [(bit, chain, 0.5), (bit, chain ^ bit, s)]


def _accumulate(acc: dict, strings, weight):
    for (x, z, c) in strings:
        key = (x, z)
        acc[key] = acc.get(key, 0.0 + 0.0j) + weight * c


def _product(*lists):
    out = [(0, 0, 1.0 + 0.0j)]
    for lst in lists:
        out = [_string_mul(s, t) for s in out for t in lst]
    return out


def jw_pauli_terms(h_mo: np.ndarray, g_mo: np.ndarray, tol: float = 1e-10):
    """(label, weight) Pauli terms of the second-quantized Hamiltonian by
    SYMBOLIC Jordan-Wigner (mask algebra, no 2^n matrices): O(n_so^4)
    string products. Matches the dense-ladder + trace-decomposition path
    exactly (tests/test_molecule.py) and is the only feasible route at
    12+ spin orbitals."""
    n_mo = h_mo.shape[0]
    n_so = 2 * n_mo
    acc: dict = {}
    lad = {(p, dg): _ladder_strings(p, n_so, dg)
           for p in range(n_so) for dg in (False, True)}
    for p in range(n_so):
        for q in range(n_so):
            if p % 2 != q % 2:
                continue
            w = h_mo[p // 2, q // 2]
            if abs(w) > 1e-14:
                _accumulate(acc, _product(lad[(p, True)], lad[(q, False)]),
                            w)
    for p in range(n_so):
        for q in range(n_so):
            if p == q:
                continue
            for r in range(n_so):
                if p % 2 != r % 2:
                    continue
                for s in range(n_so):
                    if q % 2 != s % 2 or s == r:
                        continue
                    v = g_mo[p // 2, r // 2, q // 2, s // 2]
                    if abs(v) < 1e-14:
                        continue
                    _accumulate(
                        acc,
                        _product(lad[(p, True)], lad[(q, True)],
                                 lad[(s, False)], lad[(r, False)]),
                        0.5 * v)

    terms = []
    for (x, z), c in acc.items():
        if abs(c) < tol:
            continue
        label = []
        n_y = 0
        for qb in range(n_so):
            bit = 1 << (n_so - 1 - qb)
            xb, zb = bool(x & bit), bool(z & bit)
            if xb and zb:
                label.append("Y")
                n_y += 1
            elif xb:
                label.append("X")
            elif zb:
                label.append("Z")
            else:
                label.append("I")
        w = c * (-1j) ** n_y   # XZ = -i Y per Y site
        if abs(w.imag) > 1e-9:
            raise ValueError(f"non-Hermitian accumulation at {label}: {w}")
        terms.append(("".join(label), float(w.real)))
    return terms


def sector_fci_from_strings(terms, n_so: int, n_elec: int,
                            device="cuda") -> float:
    """FCI ground energy in the n_elec sector using only the Pauli strings:
    project H onto the C(n_so, n_elec) determinant basis by batched
    matrix-free string application in float64 on ``device`` — no 2^n x
    2^n matrix, so this is the oracle that still works at 12+ spin
    orbitals (at 12, a [924, 4096] batch)."""
    dev = resolve_device(device)
    d = 2**n_so
    idx = np.array([j for j in range(d)
                    if bin(j).count("1") == n_elec])
    m = len(idx)
    basis = torch.zeros((m, d), dtype=torch.float64, device=dev)
    basis[torch.arange(m, device=dev), torch.as_tensor(idx, device=dev)] = 1.0
    ps = PauliStringSet.create(terms, dtype=torch.float64, device=dev)
    with torch.no_grad():
        out = ps.apply(CP(basis, torch.zeros_like(basis)))
    cols = torch.as_tensor(idx, device=dev)
    h_re = out.re[:, cols].cpu().numpy()        # [m(j), m(i)] = <i|H|j>
    h_im = out.im[:, cols].cpu().numpy()
    h_sector = (h_re + 1j * h_im).T
    return float(np.linalg.eigvalsh(h_sector)[0])


def sector_ground_energy(H: np.ndarray, n_elec: int) -> float:
    """Ground energy restricted to the ``n_elec`` particle-number sector.
    The Fock-space Hamiltonian contains every sector, and for clusters the
    GLOBAL minimum is usually a different electron count (electronic energy
    decreases with added electrons) — the physical answer is the sector
    minimum."""
    d = H.shape[0]
    n = int(round(np.log2(d)))
    idx = [j for j in range(d)
           if bin(j).count("1") == n_elec]
    sub = H[np.ix_(idx, idx)]
    return float(np.linalg.eigvalsh(sub)[0])


def number_penalty_terms(n_so: int, n_elec: int, lam: float):
    """lam (N_hat - n_elec)^2 as Pauli strings (I/Z only), closed form.
    N_hat = sum_q (1 - Z_q)/2; with S = N_hat - n_elec and a_q^2 = a_q,

        S^2 = [m/2 + m(m-1)/4 - n m + n^2] I
              + (n - m/2) sum_q Z_q + 1/4 sum_{q<r} 2 Z_q Z_r

    (m = n_so, n = n_elec) — O(m^2) terms built in microseconds (the
    brute-force 4^m decomposition would take hours at m = 12). Added to the
    cost so pulse drives that do not conserve particle number (X/Y) cannot
    escape the physical sector."""
    m, n = n_so, n_elec

    def lbl(sites):
        return "".join("Z" if q in sites else "I" for q in range(m))

    terms = [("I" * m,
              lam * (m / 2.0 + m * (m - 1) / 4.0 - n * m + n * n))]
    wz = lam * (n - m / 2.0)
    if wz != 0.0:
        terms += [(lbl({q}), wz) for q in range(m)]
    terms += [(lbl({q, r}), lam * 0.5)
              for q in range(m) for r in range(q + 1, m)]
    return terms


def build_hydrogen_cluster(coords_angstrom, charge: int = 0,
                           n_basis: int = 6, basis: str = "bspline",
                           T: float = 2.0, omega: float = np.pi,
                           dtype=torch.float32, sampling: bool = False,
                           noisy: bool = False,
                           number_penalty: float = 2.0,
                           compute_exact: bool = True,
                           device="cuda") -> MoleculeProblem:
    """Pulse-level VQE for an arbitrary hydrogen cluster (2 qubits per
    atom, JW in the RHF-MO basis) on ``device``. Initial state: the RHF
    determinant (lowest n_elec spin orbitals occupied). The measured cost
    is ``H_elec + number_penalty (N_hat - n_elec)^2`` (penalty vanishes on
    the physical sector); ``exact_ground_energy`` is the sector-projected
    FCI value the training gap is reported against.

    Beyond 8 spin orbitals (H4) everything goes matrix-free: Pauli terms by
    SYMBOLIC Jordan-Wigner (:func:`jw_pauli_terms` — no 2^n ladder
    matrices), the FCI oracle by sector projection of the strings on
    ``device`` (``compute_exact=False`` skips it: at 20 spin orbitals its
    C(20, 10) x 2^20 batch does not fit a card), and a structure-tagged
    drive set {X_q, Y_q, hop and ZZ pairs} so the fused engines evolve the
    state (2q XX/YY entanglers need dense operators and are only used at
    <= 8 spin orbitals)."""
    dev = resolve_device(device)
    n_atoms = len(coords_angstrom)
    n_so = 2 * n_atoms
    n_elec = n_atoms - charge
    big = n_so > 8
    if big:
        centers = [np.asarray(c, dtype=float) * ANGSTROM_TO_BOHR
                   for c in coords_angstrom]
        if n_elec % 2:
            raise ValueError("closed-shell RHF needs an even electron count")
        S, h_ao, g_ao, e_nuc = cluster_integrals(centers)
        _, C = rhf_scf(S, h_ao, g_ao, n_elec // 2)
        h_mo = C.T @ h_ao @ C
        g_mo = np.einsum("ijkl,ip,jq,kr,ls->pqrs", g_ao, C, C, C, C)
        terms = jw_pauli_terms(h_mo, g_mo)
        exact = sector_fci_from_strings(terms, n_so, n_elec, dev) \
            if compute_exact else float("nan")
    else:
        H, e_nuc, _ = cluster_electronic_hamiltonian(coords_angstrom,
                                                     charge)
        terms = pauli_decompose_fast(H.real)  # real-symmetric (RHF basis)
        exact = sector_ground_energy(H, n_elec)
    if number_penalty:
        terms = terms + number_penalty_terms(n_so, n_elec, number_penalty)
        # merge duplicate labels (penalty shares I/Z strings with H)
        acc = {}
        for lbl, w in terms:
            acc[lbl] = acc.get(lbl, 0.0) + w
        terms = [(lbl, w) for lbl, w in acc.items() if abs(w) > 1e-12]
    meas = Measurement.create_strings(terms, dtype=dtype, device=dev,
                                      sampling=sampling, noisy=noisy)
    d = 2**n_so
    pairs = [(i, i + 1) for i in range(n_so - 1)] + \
            [(i, i + 2) for i in range(n_so - 2)]
    if big:
        # structure-tagged drives (fused-engine eligible): X/Y per
        # qubit + number-conserving HOPPING (XX+YY) pairs + diagonal ZZ
        # pairs. The hop entanglers are decisive: with only {X, Y, ZZ}
        # the 12-qubit H6 VQE recovers ~20% of the correlation energy;
        # hopping moves electron pairs directly between orbitals.
        structure, omegas = [], []
        for q in range(n_so):
            for local in (linalg.X, linalg.Y):
                structure.append(TermStructure(kind="1q", qubit=q,
                                               local=local))
                omegas.append(omega)
        for (i, j) in pairs:
            structure.append(TermStructure(kind="hop", qubit=i, qubit2=j))
            omegas.append(omega)
            structure.append(TermStructure(
                kind="diag", diag=linalg.zz_diagonal(n_so, i, j)))
            omegas.append(omega)
        ham = ControlledHamiltonian.create_structured(
            d, structure, h0_structure=TermStructure(kind="diag",
                                                     diag=np.zeros(d)),
            dtype=dtype)
    else:
        # drive set: X/Y per qubit + XX/YY/ZZ on nearest AND next-nearest
        # pairs. The YY and next-nearest entanglers matter: with only
        # nearest-neighbor XX/ZZ the H3+ VQE plateaus ~12 mHa above the
        # sector ground; this set reaches < 2 mHa.
        Hs, omegas = [], []
        for q in range(n_so):
            for ax in ("X", "Y"):
                Hs.append(linalg.pauli_string("".join(
                    ax if p == q else "I" for p in range(n_so))))
                omegas.append(omega)
        for (i, j) in pairs:
            for kind in ("XX", "YY", "ZZ"):
                Hs.append(linalg.pauli_string("".join(
                    kind[0] if p in (i, j) else "I" for p in range(n_so))))
                omegas.append(omega)
        ham = ControlledHamiltonian.create(np.zeros((d, d)), Hs, dtype=dtype,
                                           device=dev)
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=tuple(omegas))
    hf = sum(1 << (n_so - 1 - p) for p in range(n_elec))
    psi0 = cpx.from_complex(linalg.basis_state(hf, d), dtype=dtype,
                            device=dev)
    return MoleculeProblem(ham=ham, envelope=env, measurement=meas,
                           psi0=psi0, T=float(T),
                           exact_ground_energy=exact, e_nuc=e_nuc,
                           terms=terms)


def rhf_energy(r_angstrom: float) -> float:
    """Closed-shell RHF total energy (sigma_g doubly occupied) — a textbook
    anchor: -1.1167 Ha at R = 0.7414 A."""
    h_mo, g_mo, e_nuc = h2_mo_integrals(r_angstrom * ANGSTROM_TO_BOHR)
    return float(2.0 * h_mo[0, 0] + g_mo[0, 0, 0, 0] + e_nuc)


def fci_energy(r_angstrom: float) -> float:
    """Exact (FCI) total energy in the STO-3G basis."""
    H, e_nuc = h2_electronic_hamiltonian(r_angstrom)
    return float(np.linalg.eigvalsh(H)[0] + e_nuc)
