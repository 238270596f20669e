"""int8 error-feedback gradient compression: the reference's
`optim/compress.py`. Each tensor is quantized to int8 with a per-tensor
scale (max |g| / 127 + 1e-12), rounded half to even (as `jnp.round`) and
clipped to [-127, 127]; the quantization residual is kept in float32 and
added back into the next step's gradient. On a fleet the pair sits where
the data-parallel all-reduce is; here it changes the grads the optimizer
sees exactly as it would there."""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompressorState(NamedTuple):
    residual: dict  # name -> float32 tensor, like the grads


def compressor_init(params: dict) -> CompressorState:
    return CompressorState(residual={
        k: torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)
        for k, p in params.items()})


def _quantize_dequantize(g):
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: dict, state: CompressorState):
    """Returns (the grads as seen after the all-reduce, in their dtypes;
    the new state)."""
    new_g, new_r = {}, {}
    for k, g in grads.items():
        gf = g.float() + state.residual[k]
        deq = _quantize_dequantize(gf)
        new_g[k] = deq.to(g.dtype)
        new_r[k] = gf - deq
    return new_g, CompressorState(residual=new_r)
