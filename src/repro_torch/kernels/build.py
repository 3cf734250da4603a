"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``repro_torch/csrc/`` compiles at first use into the
checkout's ``build/`` directory (git-ignored), under a name keyed by the
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already there. The compile writes to a
temporary name and renames it into place, so concurrent first uses never
load a half-written library. Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the checkout's git-ignored build directory (src/repro_torch/kernels ->
#: repo root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: per-source build record: {"seconds": float, "log": str, "path": str};
#: "seconds" is 0.0 when the library was already built
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit (put nvcc on PATH)")
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Raises with nvcc's output if the compile fails."""
    out = library_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr,
                        "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib: Optional[ctypes.CDLL] = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
