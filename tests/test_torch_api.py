"""The port's public names against the JAX package's: for every module
that exists in both packages, each public name of the JAX module is
public in the port's, apart from the names still to port below, each
tied to the ROADMAP.md Queue 1 item (by its title) that ports it.

A module's public names: for a package, the names its ``__init__``
imports from the package or defines; for a module, every callable it
defines (functions and classes, also behind ``jax.jit`` or
``jax.custom_vjp``); names starting with '_' are private. Then the
helpers added to ``ops.cpx`` and ``ops.linalg``, by value."""
import ast
import importlib
import pathlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import diffquantum_tpu_torch

REPO = pathlib.Path(__file__).resolve().parents[1]

# name -> the Queue 1 item that ports it (every public name of the shared
# modules is ported)
STILL_TO_PORT = {}


def _package_names(mod) -> set:
    """The names a package's ``__init__`` binds: its relative imports and
    its own definitions (a package's other attributes depend on which
    submodules were imported before)."""
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


def _public(mod) -> set:
    if hasattr(mod, "__path__"):
        return _package_names(mod)
    return {name for name, val in vars(mod).items()
            if not name.startswith("_") and callable(val)
            and not isinstance(val, types.ModuleType)
            and getattr(val, "__module__", None) == mod.__name__}


def _shared_modules():
    out = []
    for info in pkgutil.walk_packages(diffquantum_tpu_torch.__path__,
                                      "diffquantum_tpu_torch."):
        jname = info.name.replace("diffquantum_tpu_torch", "diffquantum_tpu",
                                  1)
        if (REPO / (jname.replace(".", "/") + ".py")).exists() or \
                (REPO / jname.replace(".", "/") / "__init__.py").exists():
            out.append((jname, info.name))
    return [("diffquantum_tpu", "diffquantum_tpu_torch")] + out


SHARED = _shared_modules()


def test_shared_modules_found():
    names = {j for j, _ in SHARED}
    assert {"diffquantum_tpu", "diffquantum_tpu.ops.cpx",
            "diffquantum_tpu.parallel.sharded_state",
            "diffquantum_tpu.ops.fused_chunked"} <= names
    assert set(STILL_TO_PORT) <= names


@pytest.mark.parametrize("jname,tname", SHARED, ids=[j for j, _ in SHARED])
def test_public_names_cover_jax(jname, tname):
    jmod = importlib.import_module(jname)
    tmod = importlib.import_module(tname)
    allowed = STILL_TO_PORT.get(jname, {})
    missing = _public(jmod) - _public(tmod) - set(allowed)
    assert not missing, f"{tname} lacks {sorted(missing)}"
    # an allowed name is one the port really lacks
    assert not set(allowed) & _public(tmod), \
        f"{sorted(set(allowed) & _public(tmod))} are ported: prune the list"


def test_allowed_names_name_open_roadmap_items():
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index(
        "### Queue 2")]
    for names in STILL_TO_PORT.values():
        for item in set(names.values()):
            assert item in queue1, item


def test_cpx_helpers():
    from diffquantum_tpu_torch.ops import cpx
    a = cpx.CP(torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
               torch.tensor([[0.5, -1.0], [2.0, 0.0]]))
    z = cpx.to_complex(a)
    np.testing.assert_array_equal(cpx.to_complex(cpx.neg(a)), -z)
    np.testing.assert_array_equal(cpx.to_complex(cpx.conj(a)), np.conj(z))
    np.testing.assert_array_equal(cpx.to_complex(cpx.muli(a)), 1j * z)
    np.testing.assert_array_equal(cpx.to_complex(a[1]), z[1])
    np.testing.assert_array_equal(cpx.to_complex(a[:, 0]), z[:, 0])
    re, im = a  # unpacking still yields the planes
    assert re is a.re and im is a.im


def test_linalg_helpers():
    from diffquantum_tpu_torch.ops import linalg
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    np.testing.assert_array_equal(linalg.multi_dot(m, m, m), m @ m @ m)
    np.testing.assert_array_equal(linalg.dagger(m), m.conj().T)
    t = torch.tensor(m)
    assert torch.equal(linalg.dagger(t), t.conj().T)
    assert linalg.is_hermitian(m + m.conj().T)
    assert not linalg.is_hermitian(m)
    np.testing.assert_array_equal(
        linalg.op_on_qubits(linalg.X, [1], 2, op_single=linalg.Z),
        np.kron(linalg.I2, linalg.Z))
    np.testing.assert_array_equal(linalg.op_on_qubits(linalg.X, [0], 2),
                                  np.kron(linalg.X, linalg.I2))
