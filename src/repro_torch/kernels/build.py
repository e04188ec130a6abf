"""Build-at-first-use loader for the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
into a shared library that `ctypes` loads (no PyTorch headers, so a build
takes seconds). The library lands in the checkout's `build/kernels/`
directory (listed in `.gitignore`) under a name that carries a digest of
the source and flags, so an edited kernel is never served from a stale
build. Nothing here runs at import time: the CPU tests import every module
of the package on a host with no `nvcc`.

REPRO_TORCH_PTXAS_VERBOSE=1 adds `-Xptxas -v` and prints its per-kernel
register, shared-memory and spill report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    """`nvcc` from CUDA_HOME / CUDA_PATH, else PATH, else the toolkit
    PyTorch itself resolved. Raises when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA 12 toolkit")


def build(name: str, verbose: bool = False) -> Tuple[Path, float]:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists.

    Returns (library path, seconds spent compiling — 0.0 on a reuse)."""
    src = CSRC / f"{name}.cu"
    verbose = verbose or os.environ.get("REPRO_TORCH_PTXAS_VERBOSE") == "1"
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, 0.0
    tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib)               # atomic publish for concurrent builds
    return lib, seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    if name not in _LOADED:
        lib, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]
