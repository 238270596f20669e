"""Build, load and launch the selective scan CUDA kernel.

The source, `selective_scan.cu`, sits beside this module. At first use the
port's one nvcc build step (`kernels/_nvcc.py`) compiles it for sm_90a into
a shared library with a plain C entry point, loaded with ctypes.

Nothing here runs at import: the CPU tests import this module on machines
with neither nvcc nor a card. A failed build or a refused launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).with_name("selective_scan.cu")
N_CHOICES = (4, 8, 16)  # state sizes the .cu file instantiates
THREADS = 128  # channels of one batch row a block owns (the .cu's THREADS)
TL = 16  # time steps a block stages at once (the .cu's TL)

_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])

_lib = None
PTXAS_LOG: str = ""  # nvcc's -Xptxas -v report of this process's build


def build() -> Path:
    """Compile the kernel library if this source/flag pair has none yet;
    returns its path. Raises `subprocess.CalledProcessError` on a failed
    compile."""
    global PTXAS_LOG
    lib, PTXAS_LOG = _nvcc.build(SOURCE, "selective_scan")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.selective_scan_launch.argtypes = _ARGTYPES
        lib.selective_scan_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def out_buffers(u, N: int):
    """The kernel's outputs: empty (y (Bt, L, din), h_final (Bt, din,
    N)), float32 and contiguous."""
    Bt, L, din = u.shape
    return (torch.empty((Bt, L, din), dtype=torch.float32, device=u.device),
            torch.empty((Bt, din, N), dtype=torch.float32, device=u.device))


def selective_scan_cuda(u, dt, A, B, C, D, h0):
    """Launch on CUDA tensors the caller has validated (`ops` does): u, dt
    (Bt, L, din) and B, C (Bt, L, N), one dtype (float32 or bfloat16), any
    strides with a unit last stride; A (din, N), D (din,) and h0 (Bt, din,
    N) or None, float32 and contiguous; N in N_CHOICES; on one card.
    Returns (y (Bt, L, din), h_final (Bt, din, N)), float32 and contiguous.
    Launches on the current stream and does not synchronize."""
    Bt, L, din = u.shape
    N = A.shape[1]
    y, h_final = out_buffers(u, N)
    strides = (ctypes.c_longlong * 8)(
        *[s for t in (u, dt, B, C) for s in t.stride()[:2]])
    lib = library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.selective_scan_launch(
            int(u.dtype == torch.bfloat16), N, u.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), Bt, L,
            din, stream)
    if err != 0:
        raise RuntimeError(
            f"selective scan launch failed: cudaError {err} (Bt={Bt}, L={L}, "
            f"din={din}, N={N}, dtype={u.dtype})")
    return y, h_final
