"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``repro_torch/csrc/`` compiles at first use into the
checkout's ``build/`` directory (git-ignored), under a name keyed by the
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already there. The compile writes to a
temporary name and renames it into place, so concurrent first uses never
load a half-written library. :func:`build_all` starts one nvcc per source
at once, so several kernels build in the time of the slowest. Nothing
here runs at import time: the CPU tests import every module on a machine
without ``nvcc``.
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
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

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
_BOUND: Dict[Tuple[str, str], Callable] = {}


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


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is built.
    Returns None (already built) or (process, tmp path, out path, t0)."""
    out = library_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": str(out)})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> Path:
    """Wait for a build :func:`_start` began; raise with nvcc's output if
    the compile fails."""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{' '.join(proc.args)}\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(out)}
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Raises with nvcc's output if the compile fails."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def build_all(names) -> None:
    """Compile several sources at once: one nvcc process each, all started
    together, then waited for in turn (every process is waited for, also
    when one fails)."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            _finish(name, st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib: Optional[ctypes.CDLL] = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def bind(name: str, entry: str, argtypes: Sequence, restype=ctypes.c_int) -> Callable:
    """The C function ``entry`` of the library for ``csrc/<name>.cu`` with
    its argument and result types set, resolved once and cached: a wrapper
    calls it on every launch, where looking it up and setting ``argtypes``
    anew cost host time."""
    fn = _BOUND.get((name, entry))
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _BOUND[(name, entry)] = fn
    return fn


#: the current stream's raw handle on a device index, as Triton's launcher
#: reads it: cheaper than building the public ``torch.cuda.current_stream``
#: object on every launch
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def call_on(t, fn: Callable, *args) -> int:
    """``fn(*args, stream)`` with the raw handle of the current stream on
    ``t``'s device; that device is made current only when it is not
    already (a launch goes to the current device's context)."""
    dev = t.device
    stream = (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)
