"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/<name>.cu`` is compiled on its own into
``build/lib<name>_<hash>.so`` (``build/`` beside the package, listed in
``.gitignore``) at first use; the hash covers the source and the flags,
so an edited source rebuilds and an unchanged one loads at once. Sources
export a plain C interface, so no PyTorch header is compiled (seconds per
file instead of minutes). Only sources inside the package are ever built.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (-Xptxas -v register/smem lines)


_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set CUDA_HOME)")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, BuildResult]:
    """Build the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` each, all started together. Raises with nvcc's output if a
    build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC_DIR / f"{name}.cu")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        _LIBS[name] = lib
    return lib
