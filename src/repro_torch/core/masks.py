"""Topological RPE masks on the token path metric: the pieces of the
sequence mask f(i - j), f = g(sum_t a_t x^t), that the fused topological
linear-attention sweep and the O(1)-state decode need.

`coeffs` carries leading head dims (H, t+1) everywhere and every result is
differentiable in it. The tree/forest fastmults, Alg. 1 with a generic
FastMult and the Toeplitz paths stay in ROADMAP A5.
"""
from __future__ import annotations

import numpy as np
import torch

GS = {
    "exp": torch.exp,
    "recip": lambda z: 1.0 / (1.0 + z * z),  # stabilized z -> z^{-1} family
    "identity": lambda z: z,
}


def _coeffs(coeffs, device=None) -> torch.Tensor:
    return torch.as_tensor(coeffs, dtype=torch.float32, device=device)


def sequence_mask_values(g: str, coeffs, L: int, dist_scale: float = 1.0):
    """F[..., k] = f(k) for k = 0..L-1 (token path metric)."""
    c = _coeffs(coeffs)
    ks = torch.arange(L, dtype=torch.float32, device=c.device) * dist_scale
    z = torch.zeros(c.shape[:-1] + (L,), dtype=torch.float32, device=c.device)
    for t in range(c.shape[-1] - 1, -1, -1):
        z = z * ks + c[..., t:t + 1]
    return GS[g](z)


def chebyshev_nodes(L: int, rank: int) -> np.ndarray:
    """Chebyshev nodes on [0, L] (numpy, static)."""
    kk = np.arange(rank)
    t = np.cos((2 * kk + 1) * np.pi / (2 * rank))
    return ((L / 2.0) + (L / 2.0) * t).astype(np.float32)  # (rank,)


def _poly_mask_eval(g: str, coeffs, zs: torch.Tensor):
    """f = g(poly(coeffs)) evaluated on a 2-trailing-dim grid `zs` (already
    dist-scaled); coeffs (..., t+1) broadcasts its leading (head) dims."""
    c = _coeffs(coeffs, zs.device)
    acc = torch.zeros(c.shape[:-1] + zs.shape, dtype=torch.float32,
                      device=zs.device)
    for t in range(c.shape[-1] - 1, -1, -1):
        acc = acc * zs + c[..., t][..., None, None]
    return GS[g](acc)


def chebyshev_separable_expansion(g: str, coeffs, L: int,
                                  dist_scale: float = 1.0, rank: int = 16):
    """Node grid + node-pair mask values of the rank-R Chebyshev expansion
    of (i, j) -> f(i - j) on [0, L)^2, shared by the tables below
    and the O(1)-state decode (attention.topo_decomposition). Returns
    (nodes (rank,) np, Bmat (..., rank, rank))."""
    c = _coeffs(coeffs)
    nodes = chebyshev_nodes(L, rank)
    zs = torch.from_numpy(nodes[:, None] - nodes[None, :]).to(c.device)
    return nodes, _poly_mask_eval(g, c, zs * dist_scale)


def chebyshev_separable_tables(g: str, coeffs, L: int, dist_scale: float = 1.0,
                               rank: int = 16):
    """Rank-R separable expansion of the sequence mask, tabulated per
    position: f(i - j) ~= sum_r alpha[..., i, r] * beta[..., j, r] for
    i, j in [0, L), by 2-D Chebyshev interpolation of (i, j) -> f(i - j).

    Returns (alpha (..., L, rank), beta (..., L, rank))."""
    from repro_torch.core.plan_api import _lagrange_batched

    c = _coeffs(coeffs)
    nodes, Bmat = chebyshev_separable_expansion(g, c, L, dist_scale, rank)
    pos = torch.arange(L, dtype=torch.float32, device=c.device)
    Lg = _lagrange_batched(pos[None, :],
                           torch.from_numpy(nodes[None, :]).to(c.device))[0]
    alpha = torch.einsum("lq,...qr->...lr", Lg, Bmat)
    beta = Lg.expand(Bmat.shape[:-2] + Lg.shape)
    return alpha, beta


def sequence_mask_matrix(g: str, coeffs, C: int, dist_scale: float = 1.0,
                         strict: bool = False):
    """Lower-triangular (..., C, C) tile of the causal sequence mask:
    f(i - j) where i > j (>= unless `strict`), zero above the diagonal.
    The exact within-chunk mask the fused sweep applies."""
    c = _coeffs(coeffs)
    d = np.arange(C)[:, None] - np.arange(C)[None, :]
    zs = torch.as_tensor(d, dtype=torch.float32, device=c.device) * dist_scale
    vals = _poly_mask_eval(g, c, zs)
    keep = torch.as_tensor(d > 0 if strict else d >= 0, device=c.device)
    return torch.where(keep, vals, 0.0)
