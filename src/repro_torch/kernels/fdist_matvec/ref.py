"""Plain PyTorch version of the fused f-distance matvec kernel: the same
math as `fdist_matvec.cu`, with M = [f(x_i + y_j)] materialized. The CPU
path of `ops` and the card's checks against the kernel use it."""
from __future__ import annotations

import torch


def f_eval(s, coeffs, mode: str):
    if mode == "poly":
        acc = torch.zeros_like(s)
        for t in range(coeffs.shape[0] - 1, -1, -1):
            acc = acc * s + coeffs[t]
        return acc
    if mode == "exp":
        return coeffs[1] * torch.exp(coeffs[0] * s)
    if mode == "expq":
        return torch.exp(coeffs[0] * s * s + coeffs[1] * s + coeffs[2])
    if mode == "rational":
        return 1.0 / (1.0 + coeffs[0] * s * s)
    raise ValueError(mode)


def fdist_matvec_ref(x, y, v, coeffs, mode: str = "poly"):
    """x (a,), y (b,), v (b, d), coeffs (k,) -> (a, d) in v's dtype."""
    s = x.float()[:, None] + y.float()[None, :]
    m = f_eval(s, coeffs.float(), mode)
    return (m @ v.float()).to(v.dtype)


def fdist_matvec_batched_ref(x, y, v, coeffs, mode: str = "poly"):
    """x (B, a), y (B, b), v (B, b, d), coeffs (k,) -> (B, a, d) in v's
    dtype."""
    s = x.float()[:, :, None] + y.float()[:, None, :]
    m = f_eval(s, coeffs.float(), mode)
    return torch.bmm(m, v.float()).to(v.dtype)
