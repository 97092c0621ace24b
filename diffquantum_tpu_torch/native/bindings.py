"""ctypes bindings for the port's native CPU engine (``diffqc_core.cpp``).

The port of :mod:`diffquantum_tpu.native.bindings`: the same surface
(``available``, ``NativeSystem`` with ``set_system`` / ``trotter`` /
``trotter_simple``, ``complex_test``, ``version``) over the port's own
copy of the C++ source. The library is built at first use with the
host's C++ compiler (``$CXX``, else ``c++``) into
``build/libdiffqc_core_<hash>.so`` (``build/`` beside the package, listed
in ``.gitignore``); the hash covers the source and the flags, as
:mod:`..ops._build` keys the CUDA builds, so an edited source rebuilds
and an unchanged one loads at once. Nothing is written beside the
source.

``available()`` says whether the library built and loaded. Every other
entry point raises when it did not, with the compiler's output: no call
falls back to another engine. The engine is host code (complex128 on
the CPU), the reference's C++ backend.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().with_name("diffqc_core.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None   # why the last build or load failed


def compiler() -> str:
    """The host C++ compiler: ``$CXX`` if set, else ``c++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX or put c++ on "
                           "PATH): the native engine is built from "
                           f"{SOURCE.name} at first use")
    return cxx


def library_path() -> Path:
    """``build/libdiffqc_core_<hash>.so`` for the current source and
    flags."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdiffqc_core_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine (unless this source and these flags were built
    already) and return the library's path. Raises with the compiler's
    output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native engine failed "
                           f"({' '.join(cmd)}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises (with the reason,
    the compiler's output for a failed build) when it cannot be had."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _error = f"the native engine is unavailable: {e}"
        raise RuntimeError(_error) from e
    D = ctypes.POINTER(ctypes.c_double)
    lib.dqc_create.restype = ctypes.c_int
    lib.dqc_create.argtypes = []
    lib.dqc_destroy.restype = None
    lib.dqc_destroy.argtypes = [ctypes.c_int]
    lib.dqc_set_system.restype = ctypes.c_int
    lib.dqc_set_system.argtypes = [
        ctypes.c_int, D, D, ctypes.c_int, D, D, ctypes.c_int, D,
        ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.dqc_trotter.restype = ctypes.c_int
    lib.dqc_trotter.argtypes = [
        ctypes.c_int, D, D, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, D, ctypes.c_int, ctypes.c_int, D, D]
    lib.dqc_trotter_simple.restype = ctypes.c_int
    lib.dqc_trotter_simple.argtypes = [
        ctypes.c_int, D, D, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, D, D, ctypes.c_int, ctypes.c_int, ctypes.c_int, D, D]
    lib.dqc_complex_test.restype = ctypes.c_int
    lib.dqc_complex_test.argtypes = [D, D, ctypes.c_int, D, D]
    lib.dqc_version.restype = ctypes.c_char_p
    lib.dqc_version.argtypes = []
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library built and loaded."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _planes(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


_BASIS_KINDS = {"poly": 0, "legendre": 1, "fourier": 2, "bspline": 3}


class NativeSystem:
    """Handle-based native propagation context; any number of instances
    coexist in one process (the reference keeps one global system,
    `diffqc.cc:21-25`)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.dqc_create()
        self._dim = None

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.dqc_destroy(self._h)

    def set_system(self, H0, Hs: Sequence, channels: Sequence[Sequence[float]],
                   duration: float, func_type: int) -> None:
        """channels: rows (control, omega, w, idx) — the reference's nested
        channel table flattened with an explicit control column
        (`diffqc.cc:103-111` keeps the control implicit in list nesting)."""
        H0 = np.asarray(H0, dtype=np.complex128)
        d = H0.shape[0]
        if H0.shape != (d, d):
            raise ValueError(f"H0 must be square, got {H0.shape}")
        Hs_arr = np.stack([np.asarray(h, dtype=np.complex128) for h in Hs]) \
            if len(Hs) else np.zeros((0, d, d), np.complex128)
        if Hs_arr.shape[1:] != (d, d):
            raise ValueError(f"controls must be {d} x {d}, got "
                             f"{Hs_arr.shape[1:]}")
        ch = np.ascontiguousarray(
            np.asarray(channels, dtype=np.float64).reshape(-1, 4)
            if len(channels) else np.zeros((0, 4)))
        h0_re, h0_im = _planes(H0)
        hs_re, hs_im = _planes(Hs_arr)
        rc = self._lib.dqc_set_system(
            self._h, _dptr(h0_re), _dptr(h0_im), d, _dptr(hs_re),
            _dptr(hs_im), len(Hs_arr), _dptr(ch), ch.shape[0],
            ctypes.c_double(float(duration)), int(func_type))
        if rc != 0:
            raise RuntimeError(f"dqc_set_system failed: {rc}")
        self._dim = d

    def _state(self, psi0) -> np.ndarray:
        if self._dim is None:
            raise RuntimeError("call set_system first")
        psi0 = np.asarray(psi0, dtype=np.complex128).reshape(-1)
        if psi0.size != self._dim:
            raise ValueError(f"psi0 has {psi0.size} amplitudes, the system "
                             f"dimension is {self._dim}")
        return psi0

    def trotter(self, psi0, T0: float, T: float, per_step: int,
                vv: np.ndarray) -> np.ndarray:
        """Channel-model evolution; vv [2, n_idx, n_basis]
        (`diffqc.cc:173-205` semantics)."""
        psi0 = self._state(psi0)
        d = psi0.size
        vv = np.ascontiguousarray(np.asarray(vv, dtype=np.float64))
        if vv.ndim != 3 or vv.shape[0] != 2:
            raise ValueError(f"vv must be [2, n_idx, n_basis], got "
                             f"{vv.shape}")
        _, n_idx, n_basis = vv.shape
        p_re, p_im = _planes(psi0)
        o_re, o_im = np.empty(d), np.empty(d)
        rc = self._lib.dqc_trotter(
            self._h, _dptr(p_re), _dptr(p_im), d, ctypes.c_double(float(T0)),
            ctypes.c_double(float(T)), int(per_step), _dptr(vv), n_idx,
            n_basis, _dptr(o_re), _dptr(o_im))
        if rc != 0:
            raise RuntimeError(f"dqc_trotter failed: {rc}")
        return o_re + 1j * o_im

    def trotter_simple(self, psi0, T0: float, T: float, per_step: int,
                       coeff: np.ndarray, omegas: Sequence[float],
                       basis: str) -> np.ndarray:
        """Simple-envelope evolution (`sim_plain.py:73-99` pulse model)."""
        psi0 = self._state(psi0)
        d = psi0.size
        coeff = np.ascontiguousarray(np.asarray(coeff, dtype=np.float64))
        n_hs, n_basis = coeff.shape
        om = np.ascontiguousarray(np.asarray(omegas, dtype=np.float64))
        if om.shape != (n_hs,):
            raise ValueError(f"{om.size} omegas for {n_hs} coefficient rows")
        p_re, p_im = _planes(psi0)
        o_re, o_im = np.empty(d), np.empty(d)
        rc = self._lib.dqc_trotter_simple(
            self._h, _dptr(p_re), _dptr(p_im), d, ctypes.c_double(float(T0)),
            ctypes.c_double(float(T)), int(per_step), _dptr(coeff), _dptr(om),
            n_hs, n_basis, _BASIS_KINDS[basis.lower()], _dptr(o_re),
            _dptr(o_im))
        if rc != 0:
            raise RuntimeError(f"dqc_trotter_simple failed: {rc}")
        return o_re + 1j * o_im


def complex_test(psi: np.ndarray) -> np.ndarray:
    """Round-trip smoke test (reference binding parity, `diffqc.cc:31-34`)."""
    lib = _load()
    psi = np.asarray(psi, dtype=np.complex128).reshape(-1)
    p_re, p_im = _planes(psi)
    o_re, o_im = np.empty_like(p_re), np.empty_like(p_im)
    lib.dqc_complex_test(_dptr(p_re), _dptr(p_im), psi.size, _dptr(o_re),
                         _dptr(o_im))
    return o_re + 1j * o_im


def version() -> str:
    """The engine's version string, or "unavailable" when it did not
    build."""
    return _load().dqc_version().decode() if available() else "unavailable"
