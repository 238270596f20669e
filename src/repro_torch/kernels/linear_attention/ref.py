"""Dense oracle: O(L^2) masked linear attention numerator/denominator."""
from __future__ import annotations

import torch


def linear_attention_ref(qf, kf, v, log_gamma):
    """qf/kf: (B, H, L, m); v: (B, H, L, hd); log_gamma: (H,). Returns
    (num (B, H, L, hd), den (B, H, L)) in float32."""
    L = qf.shape[2]
    i = torch.arange(L, device=qf.device)
    lg = torch.as_tensor(log_gamma, dtype=torch.float32,
                         device=qf.device).reshape(1, -1, 1, 1)
    mask = torch.where(i[:, None] >= i[None, :],
                       torch.exp(lg * (i[:, None] - i[None, :])), 0.0)
    scores = torch.einsum("bhqm,bhkm->bhqk", qf.float(), kf.float()) * mask
    num = torch.einsum("bhqk,bhkd->bhqd", scores, v.float())
    return num, scores.sum(dim=-1)
