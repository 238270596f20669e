"""Build, load and launch the causal linear-attention CUDA kernel.

The source, `linear_attention.cu`, sits beside this module. At first use
the port's one nvcc build step (`kernels/_nvcc.py`) compiles it for sm_90a
into a shared library with a plain C entry point, loaded with ctypes.

The kernel (3xTF32 `mma.sync` on the tensor cores, 2xTF32 where v is
bf16) takes every m <= 64 that is a multiple of 4, which includes every
served shape; `ops._check` refuses the rest with a ValueError.

Nothing here runs at import: the CPU tests import this module on machines
with neither nvcc nor a card. A failed build or a refused launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).with_name("linear_attention.cu")
CHUNK = 64  # the .cu file's C
TD = 64  # the .cu file's hd tile: columns of hd a block owns
MAX_M = 64  # the .cu file's MAX_M: 8 k-steps of q, 4 m-tiles of the state

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])

_lib = None
PTXAS_LOG: str = ""  # nvcc's -Xptxas -v report of this process's build


def build() -> Path:
    """Compile the kernel library if this source/flag pair has none yet;
    returns its path. Raises `subprocess.CalledProcessError` on a failed
    compile."""
    global PTXAS_LOG
    lib, PTXAS_LOG = _nvcc.build(SOURCE, "linear_attention")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.linear_attention_launch.argtypes = _ARGTYPES
        lib.linear_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes() -> int:
    """Dynamic shared memory of one block (the .cu file's SM_FLOATS): two
    split copies of the state S (MAX_M x TD, hi and lo: before and after a
    chunk), two buffers each of q and k rows (C x (MAX_M + 4)) and of v
    rows (C x (TD + 4) floats; a bf16 row takes TD + 8 halves of it), P
    (C x (C + 8)), two copies of z, and the decay table (C + 4)."""
    C = CHUNK
    return 4 * (4 * MAX_M * TD + 4 * C * (MAX_M + 4) + 2 * C * (TD + 4)
                + C * (C + 8) + 2 * MAX_M + C + 4)


def out_buffers(v):
    """The kernel's outputs: empty (num (B, H, L, hd), den (B, H, L)) in
    float32, in v's memory layout."""
    num = torch.empty_like(v, dtype=torch.float32)
    return num, torch.empty_like(num[..., 0])


def linear_attention_cuda(qf, kf, v, log_gamma):
    """Launch on CUDA tensors the caller has validated (`ops` does): qf, kf
    (B, H, L, m) float32, v (B, H, L, hd) float32 or bfloat16, log_gamma (H,)
    float32 contiguous, any strides with a unit last stride, on one card.
    Returns (num (B, H, L, hd), den (B, H, L)) in float32, in v's memory
    layout. Launches on the current stream and does not synchronize."""
    B, H, L, m = qf.shape
    hd = v.shape[-1]
    num, den = out_buffers(v)
    strides = (ctypes.c_longlong * 15)(
        *[s for t in (qf, kf, v, num, den) for s in t.stride()[:3]])
    lib = library()
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.linear_attention_launch(
            int(v.dtype == torch.bfloat16), qf.data_ptr(), kf.data_ptr(),
            v.data_ptr(), log_gamma.data_ptr(), num.data_ptr(),
            den.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), B, H, L, m,
            hd, stream)
    if err != 0:
        raise RuntimeError(
            f"linear attention launch failed: cudaError {err} (B={B}, H={H}, "
            f"L={L}, m={m}, hd={hd}, smem={smem_bytes()})")
    return num, den
