"""Dense oracle for flash attention: the full (L, L) softmax in float32."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, causal: bool = True):
    """q, k: (B, H, L, hd); v: (B, H, L, vd), vd = hd or not (MLA's 128
    beside a 192 q/k head). Returns (B, H, L, vd) in q's dtype."""
    L, hd = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        i = torch.arange(L, device=q.device)
        s = torch.where(i[:, None] >= i[None, :], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
