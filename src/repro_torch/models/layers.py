"""Shared neural layers of the port: init helpers on an explicit
`torch.Generator`, RMS norm, rope, the logit softcap and the gated MLP.
Weights keep the reference's `(in, out)` layout (`x @ W`), so reference
weights copy over unchanged. And the next-token loss with its z-loss."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """A leaf of the model: named tensors held as parameters (one of the
    reference's innermost param dicts, e.g. `attn_norm` -> `scale`).
    Allocated on `device` ("meta" to be filled by `load_state_dict(...,
    assign=True)`), in `dtype` unless `dtypes` names another for a leaf
    (the MoE router stays float32 in a bf16 model, as the reference's)."""

    def __init__(self, shapes: dict, dtype=torch.float32, device=None,
                 dtypes: dict | None = None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                tuple(shape), dtype=(dtypes or {}).get(name, dtype),
                device=device)))


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal draw times 1/sqrt(fan_in) (or `scale`), drawn in float32 on
    the generator's device and cast to `dtype`."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * s).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6, plus_one: bool = False):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = (1.0 + scale) if plus_one else scale  # in scale's dtype, as the reference
    return (y * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., L, H, hd), positions: broadcastable to (..., L). Angles and
    the rotation in float32, then cast back to x's dtype (the reference's
    order of operations)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta).to(x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., L, hd/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, hd/2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.float32) -> dict:
    return {"w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_in": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_out": dense_init(gen, (d_ff, d_model), dtype=dtype)}


def gated_mlp(p, x, act: str = "silu"):
    """p: a `Params` with w_gate, w_in (d, ff) and w_out (ff, d)."""
    actf = {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[act]
    h = actf(x @ p.w_gate) * (x @ p.w_in)
    return h @ p.w_out


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32) -> dict:
    x = torch.randn((vocab, d_model), generator=gen, device=gen.device)
    return {"table": (x * 0.02).to(dtype)}


def cross_entropy_loss(logits, labels, vocab_size: int,
                       z_loss: float = 1e-4):
    """Mean next-token CE in float32, with z-loss; labels outside [0,
    vocab_size) are masked. The reference's formula, term by term (not
    `F.cross_entropy`, which has no z-loss and another masking)."""
    logits = logits.float()
    mask = (labels >= 0) & (labels < vocab_size)
    labels_c = labels.clamp(0, vocab_size - 1).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = logz - gold + z_loss * logz.square()
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / mask.sum().clamp_min(1)
