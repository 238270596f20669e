"""Build, load and launch the flash attention CUDA kernel.

The source, `flash_attention.cu`, sits beside this module. At first use the
port's one nvcc build step (`kernels/_nvcc.py`) compiles it for sm_90a into
a shared library with a plain C entry point, loaded with ctypes. bf16
inputs go to its wgmma kernel (tensor cores), float32 inputs to its fp32
kernel (CUDA cores).

Nothing here runs at import: the CPU tests import this module on machines
with neither nvcc nor a card. A failed build or a refused launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).with_name("flash_attention.cu")
# the (q/k head dim, v head dim) pairs the .cu file instantiates: equal
# pairs up to 128, MLA's packed nope + rope q/k head beside its v head
# (DeepSeek's (192, 128), their smoke configs' (24, 16)), and Gemma-7B's 256
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
             (256, 256), (24, 16))
BQ = 64  # query rows of a block (the .cu file's BQ)

_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])

_lib = None
PTXAS_LOG: str = ""  # nvcc's -Xptxas -v report of this process's build


def build() -> Path:
    """Compile the kernel library if this source/flag pair has none yet;
    returns its path. Raises `subprocess.CalledProcessError` on a failed
    compile."""
    global PTXAS_LOG
    lib, PTXAS_LOG = _nvcc.build(SOURCE, "flash_attention")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _out_like(q, vd: int) -> torch.Tensor:
    """An empty (B, H, L, vd) tensor whose dims lie in memory in q's order."""
    shape = (*q.shape[:3], vd)
    perm = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    out = torch.empty([shape[i] for i in perm], dtype=q.dtype,
                      device=q.device)
    return out.permute([perm.index(i) for i in range(4)])


def out_buffer(q, vd: int) -> torch.Tensor:
    """The kernel's output: an empty (B, H, Lq, vd) tensor in q's dtype,
    laid out as q is."""
    return torch.empty_like(q) if vd == q.shape[-1] else _out_like(q, vd)


def flash_attention_cuda(q, k, v, causal: bool, window: int = 0):
    """Launch on CUDA tensors the caller has validated (`ops` does): q
    (B, H, Lq, hd), k (B, KV, Lk, hd) and v (B, KV, Lk, vd) with (hd, vd)
    in HEAD_DIMS, one dtype (float32 or bfloat16), any strides with a unit
    last stride (in bf16, 16-byte-aligned rows), on one card; Lq == Lk when
    causal, and `window` > 0 (a local window: key j visible to query i iff
    i - j < window) only when causal. Returns (B, H, Lq, vd) in q's dtype,
    laid out as q is.
    Launches on the current stream and does not synchronize (the bf16 path
    encodes its three TMA tensor maps on the host first)."""
    B, H, L, hd = q.shape
    Lk = k.shape[2]
    G, vd = H // k.shape[1], v.shape[-1]
    out = out_buffer(q, vd)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            int(q.dtype == torch.bfloat16), hd, vd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p),
            B, H, G, L, Lk, 1.0 / math.sqrt(hd), int(bool(causal)),
            int(window), stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention launch failed: cudaError {err} (B={B}, H={H}, "
            f"G={G}, Lq={L}, Lk={Lk}, hd={hd}, vd={vd}, dtype={q.dtype}, "
            f"causal={causal}, window={window})")
    return out
