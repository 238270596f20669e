"""nvcc -> shared library -> ctypes: the one build step of the port's CUDA
kernels.

Each kernel's source (`*.cu`, beside its `kernel.py`) is compiled at first
use for sm_90a into a shared library with a plain C entry point, loaded
with ctypes. Libraries land in `build/repro_torch_kernels/` at the
repository root, named by the kernel and a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is compiled
once per checkout. Each library is written under a private name and
renamed into place, so concurrent builds never load a half-written file;
nvcc's `-Xptxas -v` report is kept beside it.

Nothing here runs at import: the CPU tests import the kernel modules on
machines with neither nvcc nor a card. A failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

# <repo>/build/repro_torch_kernels (this file is <repo>/src/repro_torch/...)
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are compiled from source at first use")
    return found


def build(source: Path, name: str,
          flags: tuple = NVCC_FLAGS) -> tuple[Path, str]:
    """Compile `source` into a library if this source/flag pair has none
    yet. Returns (library path, ptxas log). Raises
    `subprocess.CalledProcessError` on a failed compile."""
    key = hashlib.sha1(source.read_bytes()
                       + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}_{key}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, (log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                         capture_output=True, text=True, check=True)
    text = res.stdout + res.stderr
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, text
