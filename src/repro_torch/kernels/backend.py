"""Device resolution and the hand-written kernels' build.

Counterpart of ``repro/kernels/backend.py``.  The reference picks the
Pallas execution mode from the backend; here the rule is one line and has
no switch: a wrapper launches its CUDA kernel on a CUDA tensor and runs
the kernel's plain PyTorch version on a CPU tensor.  A CUDA tensor never
reaches the plain version, and a kernel that fails to build or launch
raises.

Kernels are CUDA C++ sources under ``csrc/``, compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  They are built
at first use into ``build/repro_torch_kernels/`` at the repository root,
named by a hash of source, the ``csrc/*.cuh`` headers it includes, and
flags, so an edited source or header is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# csrc/<name>.cu, one library each
SOURCES = ("segscan", "hash_route", "ssd_scan", "ssd_scan_bwd",
           "flash_attention", "flash_attention_bwd", "relaxed")

_LOCAL_INCLUDE = re.compile(rb'#include\s+"([\w.]+\.cuh)"')
_libs: dict = {}   # name -> loaded ctypes.CDLL (one per process)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``None`` means CUDA; asking for
    CUDA where there is none raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by source, the local
    headers it includes (``#include "x.cuh"``) and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for inc in sorted(set(_LOCAL_INCLUDE.findall(src))):
        h.update(inc + (CSRC / inc.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.

    Returns ``{name: {"seconds": float, "ptxas": str, "cached": bool}}``;
    ``ptxas`` is the compiler's per-kernel register and shared-memory
    report.  Raises with the compiler's output when a build fails.
    ``build.compiled`` counts the libraries compiled (not found built).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        tmp = path.parent / f"{path.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)
        build.compiled += 1
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                     "cached": False}
    return out


build.compiled = 0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        build((name,))
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raw_stream(t: torch.Tensor) -> int:
    """:func:`stream_ptr` without building a ``torch.cuda.Stream`` object
    each call: the C call PyTorch's own generated code uses."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
