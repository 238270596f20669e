"""Build, load and launch the fused topological linear-attention sweep
CUDA kernel.

The source, `topo_sweep.cu`, sits beside this module. At first use the
port's one nvcc build step (`kernels/_nvcc.py`) compiles it for sm_90a into a
shared library with a plain C entry point, loaded with ctypes.

The kernel (3xTF32 `mma.sync` on the tensor cores) takes every C <= 128,
m <= 64 and, in rank mode, R <= 16, which includes every served shape;
`tc_config` refuses the rest, and `topo_sweep_cuda` rows that are not
16-byte aligned, with a ValueError.

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
MAX_CHUNK = 128  # the P micro-tiles cover 128 x 128
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on Hopper
TC_MAX_M = 64  # q fragments a warp holds: 8 k-steps of 8
TC_MAX_R = 16  # moments of the TD = 16 write: 4 groups x 4 a warp

_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
             + [ctypes.c_int] * 7
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


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def tc_smem_bytes(td: int, nbuf: int, C: int, m: int, R: int) -> int:
    """Dynamic shared memory of one block (the .cu file's layout, R = 1 in
    decay mode): the state's split copy S (R*M16 x td, hi and lo) and z
    (M16 x R8, hi and lo), then `nbuf` buffers of k rows (C8 x (M16 + 4)),
    v rows (C8 x (td + 4)) and beta rows (C8 x (R + 1)), and two of alpha
    rows; M16 = m rounded up to 16, R8 = R and C8 = C to 8."""
    m16, r8, c8 = _round_up(m, 16), _round_up(R, 8), _round_up(C, 8)
    floats = (2 * R * m16 * td + 2 * m16 * r8
              + nbuf * c8 * ((m16 + 4) + (td + 4) + (R + 1))
              + 2 * c8 * (R + 1))
    return 4 * floats


def tc_config(C: int, m: int, hd: int, R: int, decay: bool):
    """(td, nbuf, shared-memory bytes) of the kernel for this shape (R = 1
    in decay mode). td is 64 in decay mode when hd needs more than 16
    columns, else 16; nbuf is 2 (the next chunk staged a whole chunk ahead)
    where that fits, else 1 (which fits every shape taken). Raises
    ValueError for a C above 128, an m above 64 or, in rank mode, more than
    16 moments."""
    if not 1 <= C <= MAX_CHUNK or not 1 <= m <= TC_MAX_M or hd < 1 or (
            not decay and not 1 <= R <= TC_MAX_R):
        raise ValueError(
            f"the topo sweep kernel takes C <= {MAX_CHUNK}, m <= {TC_MAX_M} "
            f"and, in rank mode, R <= {TC_MAX_R} moments: got C={C}, m={m}, "
            f"hd={hd}, R={R} ({'decay' if decay else 'rank'} mode)")
    td = 64 if decay and hd > 16 else 16
    nbuf = 2 if tc_smem_bytes(td, 2, C, m, R) <= SMEM_LIMIT else 1
    return td, nbuf, tc_smem_bytes(td, nbuf, C, m, R)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def topo_sweep_cuda(qf, kf, v, dmat, log_gamma, alpha, beta, res_num,
                    res_den, normalize: bool, eps: float):
    """Launch on CUDA tensors the caller has validated (`ops` does): all
    float32, contiguous, on one card; L a multiple of C = dmat.shape[-1];
    dmat vanishing above its diagonal (the kernel reads only its lower
    tiles). Returns out (B, H, L, hd), or (num, den (B, H, L)) when not
    `normalize`. Raises ValueError for a shape `tc_config` refuses or for
    q, k, v or res_num data that is not 16-byte aligned (the kernel copies
    their rows 16 bytes at a time). Launches on the current stream and
    does not synchronize."""
    B, H, L, m = qf.shape
    hd = v.shape[-1]
    C = dmat.shape[-1]
    decay = log_gamma is not None
    R = 1 if decay else alpha.shape[-1]
    td, nbuf, smem = tc_config(C, m, hd, R, decay)
    for name, t in (("qf", qf), ("kf", kf), ("v", v), ("res_num", res_num)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the topo sweep kernel reads {name} 16 bytes "
                             "at a time: its data must be 16-byte aligned")
    out = torch.empty((B, H, L, hd), dtype=torch.float32, device=qf.device)
    den = (None if normalize else
           torch.empty((B, H, L), dtype=torch.float32, device=qf.device))
    lib = library()
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.topo_sweep_launch(
            td, nbuf, qf.data_ptr(), kf.data_ptr(), v.data_ptr(),
            dmat.data_ptr(), _ptr(log_gamma), _ptr(alpha), _ptr(beta),
            _ptr(res_num), _ptr(res_den), out.data_ptr(), _ptr(den), B, H, L,
            m, hd, C, R, float(eps), int(bool(normalize)), smem, stream)
    if err != 0:
        raise RuntimeError(
            f"topo sweep launch failed: cudaError {err} (B={B}, H={H}, L={L}, "
            f"m={m}, hd={hd}, C={C}, R={R}, td={td}, nbuf={nbuf}, "
            f"smem={smem})")
    return out if normalize else (out, den)
