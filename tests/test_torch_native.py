"""The port's native CPU engine (``diffquantum_tpu_torch/native``) against
the JAX package's (``diffquantum_tpu/native``) on the same inputs, and
against the port's float64 propagator: the ctypes surface, the channel
and simple-envelope evolutions, coexisting instances, and where the
library is built. Both engines build with the host's C++ compiler."""
import os
import pathlib

import numpy as np
import pytest
import torch

from diffquantum_tpu.native import bindings as jb
from diffquantum_tpu.ops import linalg
from diffquantum_tpu_torch.dynamics.hamiltonian import ControlledHamiltonian
from diffquantum_tpu_torch.dynamics.propagator import trotter
from diffquantum_tpu_torch.native import bindings as tb
from diffquantum_tpu_torch.ops import cpx
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope

REPO = pathlib.Path(__file__).resolve().parents[1]


def make_system(seed=0):
    """tests/test_native.py's 2-qubit system: two channels on control 0
    (different carriers), one on control 1."""
    rng = np.random.default_rng(seed)
    H0 = 0.2 * linalg.pauli_string("ZI")
    Hs = [linalg.pauli_string("XI"), linalg.pauli_string("IX")]
    channels = [(0, np.pi, 5.0, 0), (0, 0.5 * np.pi, 9.0, 1),
                (1, np.pi, 4.0, 2)]
    vv = rng.standard_normal((2, 3, 5)) * 0.7
    return H0, Hs, channels, 2.0, vv, linalg.uniform_superposition(2)


def test_complex_roundtrip_and_version():
    psi = np.array([1 + 2j, 3 - 4j, 0.5j])
    np.testing.assert_array_equal(tb.complex_test(psi), psi)
    assert tb.available() and tb.version() == "0.1.0" == jb.version()


@pytest.mark.parametrize("func_type", [0, 1])
@pytest.mark.parametrize("T0,T", [(0.0, 2.0), (0.3, 3.1)])
def test_channel_trotter_matches_jax_engine(func_type, T0, T):
    H0, Hs, channels, duration, vv, psi0 = make_system()
    got, want = tb.NativeSystem(), jb.NativeSystem()
    for s in (got, want):
        s.set_system(H0, Hs, channels, duration, func_type)
    np.testing.assert_allclose(got.trotter(psi0, T0, T, 10, vv),
                               want.trotter(psi0, T0, T, 10, vv),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("basis", ["bspline", "legendre", "poly", "fourier"])
def test_simple_trotter_matches_jax_engine(basis):
    rng = np.random.default_rng(1)
    Hs = [linalg.pauli_string("XI"), linalg.pauli_string("ZZ")]
    coeff = rng.standard_normal((2, 4)) * 0.5
    got, want = tb.NativeSystem(), jb.NativeSystem()
    for s in (got, want):
        s.set_system(np.zeros((4, 4)), Hs, [], 2.0, 1)
    psi0 = linalg.uniform_superposition(2)
    np.testing.assert_allclose(
        got.trotter_simple(psi0, 0.0, 2.0, 10, coeff, (np.pi, 2.0), basis),
        want.trotter_simple(psi0, 0.0, 2.0, 10, coeff, (np.pi, 2.0), basis),
        rtol=0, atol=1e-12)


def test_simple_trotter_vs_port_propagator():
    """trotter_simple against the port's float64 propagator on the CPU
    (tests/test_native.py's check against the JAX propagator)."""
    rng = np.random.default_rng(1)
    H0 = np.zeros((4, 4))
    Hs = [linalg.pauli_string("XI"), linalg.pauli_string("ZZ")]
    omegas, T, n_basis = (np.pi, np.pi), 2.0, 5
    coeff = rng.standard_normal((2, n_basis)) * 0.5
    psi0 = linalg.uniform_superposition(2)
    sys = tb.NativeSystem()
    sys.set_system(H0, Hs, [], T, 1)  # duration normalizes the basis
    got = sys.trotter_simple(psi0, 0.0, T, 10, coeff, omegas, "bspline")
    ham = ControlledHamiltonian.create(H0, Hs, dtype=torch.float64,
                                       device="cpu")
    env = SimpleEnvelope(basis="bspline", n_basis=n_basis, omegas=omegas)
    want = cpx.to_complex(trotter(
        ham, env, torch.tensor(coeff), cpx.from_complex(
            psi0, dtype=torch.float64, device="cpu"), 0.0, T, per_step=10))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_two_instances_coexist():
    H0b = 0.7 * linalg.Z
    sa, sb = tb.NativeSystem(), tb.NativeSystem()
    sa.set_system(np.zeros((2, 2)), [linalg.X], [(0, np.pi, 0.0, 0)], 1.0, 0)
    sb.set_system(H0b, [linalg.Y], [(0, np.pi, 0.0, 0)], 1.0, 0)
    vv = np.zeros((2, 1, 3))
    psi = linalg.basis_state(0, 2)
    out_a = sa.trotter(psi, 0.0, 1.0, 5, vv)
    out_b = sb.trotter(psi, 0.0, 1.0, 5, vv)
    np.testing.assert_allclose(out_a, psi, atol=1e-12)  # H0 = 0 only
    np.testing.assert_allclose(out_b, np.exp(-0.7j) * psi, atol=1e-12)
    with pytest.raises(ValueError, match="amplitudes"):
        sa.trotter(np.ones(4), 0.0, 1.0, 5, vv)


def _files(path: pathlib.Path) -> set:
    return {p.name for p in path.iterdir() if p.is_file()}


def test_builds_into_build_dir_only(tmp_path, monkeypatch):
    """A fresh build lands under the build directory, keyed by the source
    and flags, and writes nothing beside either package's source (the
    JAX package's Makefile target is its own)."""
    jax_native = REPO / "diffquantum_tpu" / "native"
    port_native = REPO / "diffquantum_tpu_torch" / "native"
    port_before = _files(port_native)
    monkeypatch.setattr(tb, "BUILD_DIR", tmp_path / "build")
    lib = tb.build()
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("libdiffqc_core_") and lib.suffix == ".so"
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    assert tb.library_path() == lib and tb.build() == lib  # reused
    assert _files(port_native) == port_before
    assert not any(n.endswith(".so") for n in port_before)
    assert not [n for n in _files(jax_native)
                if n.startswith("libdiffqc_core_")]
    assert pathlib.Path(tb._load()._name).parent == REPO / "build"


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "diffqc_core.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tb, "SOURCE", bad)
    monkeypatch.setattr(tb, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="diffqc_core.cpp") as e:
        tb.build()
    assert "error" in str(e.value)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tb.compiler()
    assert not os.listdir(tmp_path / "build")


def test_unavailable_library_raises(monkeypatch):
    """With a build that fails, available() is False, NativeSystem()
    raises with the reason and version() says so; no other engine runs."""
    monkeypatch.setattr(tb, "_lib", None)
    monkeypatch.setattr(tb, "_error", "the native engine is unavailable: "
                        "compiler said no")
    assert not tb.available()
    with pytest.raises(RuntimeError, match="compiler said no"):
        tb.NativeSystem()
    assert tb.version() == "unavailable"
