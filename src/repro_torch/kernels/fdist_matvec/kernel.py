"""Build, load and launch the fused f-distance matvec CUDA kernel.

The source, `fdist_matvec.cu`, sits beside this module. At first use it is
compiled by the port's one nvcc build step (`kernels/_nvcc.py`) for sm_90a
into a shared library with a plain C entry point, loaded with ctypes, in
`build/repro_torch_kernels/` at the repository root, named by a hash of the
source and the flags.

Nothing here runs at import: the CPU tests import this module on machines
with neither nvcc nor a card. A failed build or a refused launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).with_name("fdist_matvec.cu")
MODE_IDS = {"poly": 0, "exp": 1, "expq": 2, "rational": 3}
TB = 64  # source rows per shared-memory stage (the .cu file's TB)
TD_CHOICES = (4, 16, 64)  # d-tile widths the .cu file instantiates
MAX_THREADS = 128  # rows per block at td = 4, 16 (__launch_bounds__)
# td = 64: a register-blocked tile of TILE_ROWS rows x 64 columns per block
# of TILE_THREADS threads, 8 rows x 4 columns a thread (the .cu file's BI)
TILE_ROWS, TILE_THREADS = 64, 128
BLOCKS_PER_SM = 8  # split the source axis until the grid has this many

_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])

_lib = None
PTXAS_LOG: str = ""  # nvcc's -Xptxas -v report of this process's build


def build() -> Path:
    """Compile the kernel library if this source/flag pair has none yet;
    returns its path. Raises `subprocess.CalledProcessError` on a failed
    compile."""
    global PTXAS_LOG
    lib, PTXAS_LOG = _nvcc.build(SOURCE, "fdist_matvec")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fdist_matvec_launch.argtypes = _ARGTYPES
        lib.fdist_matvec_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cdiv(p: int, q: int) -> int:
    return -(-p // q)


def tile_width(d: int) -> int:
    """The d-tile width of the instantiation that serves a field of width
    d: the narrowest that holds d, else the widest (then several tiles)."""
    return next((t for t in TD_CHOICES if t >= d), TD_CHOICES[-1])


def launch_config(B: int, a: int, b: int, d: int, num_sms: int) -> dict:
    """Grid of one launch: `rows` output rows per block (td = 4, 16: one
    thread a row, at most MAX_THREADS; td = 64: the TILE_ROWS x 64 tile
    of TILE_THREADS threads), d in tiles of `td` columns, and the source
    axis cut into `splits` chunks of `j_per_split` (a multiple of TB) when
    the bucket alone would leave SMs idle. Every (row, source) pair lies in
    exactly one (block, split)."""
    td = tile_width(d)
    if td == 64:
        threads, rows = TILE_THREADS, TILE_ROWS
    else:
        threads = rows = min(MAX_THREADS, max(32, _cdiv(a, 32) * 32))
    row_tiles = _cdiv(a, rows)
    d_tiles = _cdiv(d, td)
    base = B * row_tiles * d_tiles
    splits = 1
    target = BLOCKS_PER_SM * num_sms
    if base < target:  # at least two stages of TB sources per split
        splits = max(1, min(_cdiv(target, base), _cdiv(b, 2 * TB)))
    j_per_split = _cdiv(_cdiv(b, splits), TB) * TB
    splits = _cdiv(b, j_per_split)
    return {"threads": threads, "rows": rows, "row_tiles": row_tiles,
            "td": td, "d_tiles": d_tiles, "splits": splits,
            "j_per_split": j_per_split}


_SMS: dict = {}


def _num_sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def fdist_matvec_batched_cuda(x, y, v, coeffs, mode: str) -> torch.Tensor:
    """Launch on CUDA tensors the caller has validated (`ops` does):
    x (B, a) f32, y (B, b) f32, v (B, b, d) f32/bf16, coeffs (k,) f32, all
    contiguous on one card, every dimension > 0. Returns (B, a, d) in v's
    dtype. Launches on the current stream and does not synchronize."""
    B, a = x.shape
    b, d = v.shape[1], v.shape[2]
    cfg = launch_config(B, a, b, d, _num_sms(x.device))
    out = torch.empty((B, a, d), dtype=v.dtype, device=x.device)
    partial = (torch.empty((cfg["splits"], B, a, d), dtype=torch.float32,
                           device=x.device)
               if cfg["splits"] > 1 else None)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fdist_matvec_launch(
            MODE_IDS[mode], int(v.dtype == torch.bfloat16), cfg["td"],
            x.data_ptr(), y.data_ptr(), v.data_ptr(), coeffs.data_ptr(),
            coeffs.shape[0], out.data_ptr(),
            0 if partial is None else partial.data_ptr(),
            B, a, b, d, cfg["threads"], cfg["row_tiles"], cfg["d_tiles"],
            cfg["splits"], cfg["j_per_split"], stream)
    if err != 0:
        raise RuntimeError(
            f"fdist_matvec launch failed: cudaError {err} (mode={mode}, "
            f"B={B}, a={a}, b={b}, d={d}, config={cfg})")
    return out
