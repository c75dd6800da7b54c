"""Builds the port's CUDA C++ kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries go to ``_build/`` next to this file, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one
is not.  Nothing is built at import time: the first launch builds what
it needs, and :func:`build` builds several sources in parallel.

A library is compiled under a temporary name and moved into place with
``os.replace``, so a loader never sees a partial file.  The ranks of a
mesh (:func:`repro_torch.launch.mesh.run_on_mesh`) only load: the
parent builds before it spawns them, and each rank calls
:func:`forbid_builds` first, so many ranks never race one nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("gram", "dantzig_fused", "soft_threshold")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# set in a mesh rank: a missing library is an error there, not a build
_LOAD_ONLY = False


def forbid_builds() -> None:
    """Make this process load libraries only: a missing one raises instead of running nvcc."""
    global _LOAD_ONLY
    _LOAD_ONLY = True


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output of the last build of ``name`` (ptxas register and shared-memory use)."""
    return BUILD_DIR / f"{name}.log"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every source in ``names`` that has no current library, all at once.

    Returns the seconds each compile took (0.0 for one already built);
    raises with nvcc's output when any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            if _LOAD_ONLY:
                raise RuntimeError(
                    f"{target.name} is not built, and this process only loads: build it "
                    "before the ranks start (build.build())")
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib
