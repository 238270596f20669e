"""Build, load and launch the fused topological linear-attention sweep
CUDA kernel.

The source, `topo_sweep.cu`, sits beside this module. At first use the
port's one nvcc build step (`kernels/_nvcc.py`) compiles it for sm_90a into a
shared library with a plain C entry point, loaded with ctypes.

Nothing here runs at import: the CPU tests import this module on machines
with neither nvcc nor a card. A failed build or a refused launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).with_name("topo_sweep.cu")
THREADS = 256  # the .cu file's THREADS
TD_CHOICES = (64, 32, 16)  # hd-tile widths the .cu file instantiates
MAX_CHUNK = 128  # the P micro-tiles cover 128 x 128
UPT = 8  # state rows a thread updates at most (the .cu file's UPT)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on Hopper

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p])

_lib = None
PTXAS_LOG: str = ""  # nvcc's -Xptxas -v report of this process's build


def build() -> Path:
    """Compile the kernel library if this source/flag pair has none yet;
    returns its path. Raises `subprocess.CalledProcessError` on a failed
    compile."""
    global PTXAS_LOG
    lib, PTXAS_LOG = _nvcc.build(SOURCE, "topo_sweep")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.topo_sweep_launch.argtypes = _ARGTYPES
        lib.topo_sweep_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(td: int, C: int, m: int, R: int) -> int:
    """Dynamic shared memory of one block (the .cu file's layout): the
    state tile, the v tile, the state's normalizer, the alpha/beta rows,
    the clamped den, q and k transposed, and P transposed (whose room also
    takes the partial sums of the split state read at td = 16 in rank
    mode)."""
    rm = R * m
    split = 4 * C * td + 4 * C + 3 if td == 16 and R % 4 == 0 else 0
    floats = (rm * td + C * td + rm + 2 * C * R + C + 2 * m * (C + 1)
              + max(C * (C + 1), split))
    return 4 * floats


def choose_td(C: int, m: int, hd: int, R: int) -> int:
    """The widest hd tile that covers no more columns than hd needs, whose
    state rows fit the threads (R*m <= 8 rows a thread) and whose block
    fits in shared memory. Raises ValueError if none does."""
    need = next((t for t in sorted(TD_CHOICES) if t >= hd), TD_CHOICES[0])
    for td in TD_CHOICES:
        if td > need:
            continue
        nrg = THREADS // (td // 8)
        if R * m <= UPT * nrg and smem_bytes(td, C, m, R) <= SMEM_LIMIT:
            return td
    raise ValueError(
        f"the topo sweep kernel has no hd tile for C={C}, m={m}, hd={hd}, "
        f"R={R}: the state (R*m = {R * m} rows) or the block's shared "
        f"memory ({smem_bytes(TD_CHOICES[-1], C, m, R)} bytes at the "
        f"narrowest tile, limit {SMEM_LIMIT}) is too large")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def topo_sweep_cuda(qf, kf, v, dmat, log_gamma, alpha, beta, res_num,
                    res_den, normalize: bool, eps: float):
    """Launch on CUDA tensors the caller has validated (`ops` does): all
    float32, contiguous, on one card; L a multiple of C = dmat.shape[-1].
    Returns out (B, H, L, hd), or (num, den (B, H, L)) when not
    `normalize`. Launches on the current stream and does not synchronize."""
    B, H, L, m = qf.shape
    hd = v.shape[-1]
    C = dmat.shape[-1]
    R = 1 if log_gamma is not None else alpha.shape[-1]
    td = choose_td(C, m, hd, R)
    smem = smem_bytes(td, C, m, R)
    out = torch.empty((B, H, L, hd), dtype=torch.float32, device=qf.device)
    den = (None if normalize else
           torch.empty((B, H, L), dtype=torch.float32, device=qf.device))
    lib = library()
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.topo_sweep_launch(
            td, qf.data_ptr(), kf.data_ptr(), v.data_ptr(), dmat.data_ptr(),
            _ptr(log_gamma), _ptr(alpha), _ptr(beta), _ptr(res_num),
            _ptr(res_den), out.data_ptr(), _ptr(den), B, H, L, m, hd, C, R,
            float(eps), int(bool(normalize)), smem, stream)
    if err != 0:
        raise RuntimeError(
            f"topo sweep launch failed: cudaError {err} (B={B}, H={H}, L={L}, "
            f"m={m}, hd={hd}, C={C}, R={R}, td={td}, smem={smem})")
    return out if normalize else (out, den)
