"""Dense oracle for topological masked linear attention (Alg. 1).

Materializes the full (H, L, L) sequence mask M = [f(dist(i, j))] and runs
the O(L^2) masked quadratic: exact for any g/degree, causal or
bidirectional. Every other impl (the plain sweep, the CUDA kernel) is
tested against it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.masks import _poly_mask_eval


def sequence_topo_mask(g: str, coeffs, L: int, dist_scale: float = 1.0,
                       causal: bool = True):
    """Dense (..., L, L) mask f(i-j) (causal, zero above diagonal) or
    f(|i-j|) (bidirectional). coeffs: (..., t+1)."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32)
    idx = np.arange(L)
    d = idx[:, None] - idx[None, :]
    dist = d if causal else np.abs(d)
    zs = torch.as_tensor(dist, dtype=torch.float32,
                         device=coeffs.device) * dist_scale
    vals = _poly_mask_eval(g, coeffs, zs)
    if causal:
        vals = torch.where(torch.as_tensor(d >= 0, device=coeffs.device),
                           vals, 0.0)
    return vals


def topo_linear_attention_ref(qf, kf, v, coeffs, *, g: str = "exp",
                              dist_scale: float = 1.0, causal: bool = True,
                              eps: float = 1e-6):
    """qf/kf: (B, H, L, m) nonneg features; v: (B, H, L, hd);
    coeffs: (H, t+1) effective (post-constraint) mask coefficients.
    Returns the normalized attention output (B, H, L, hd) in float32."""
    L = qf.shape[-2]
    M = sequence_topo_mask(g, coeffs, L, dist_scale, causal)  # (H, L, L)
    scores = torch.einsum("bhim,bhjm->bhij", qf.float(), kf.float()) * M[None]
    num = torch.einsum("bhij,bhjd->bhid", scores, v.float())
    den = scores.sum(dim=-1)
    den = torch.where(den.abs() < eps, eps, den)
    return num / den[..., None]
