"""Topological RPE masks for linear attention (paper Sec 4.4 + Alg. 1,
App. C).

The mask is M = [f(dist(i,j))] with f = g(sum_t a_t x^t) and (a_t)
learnable: 3 extra scalars per layer (synced) or per head (asynced).
FastMult_M:
  - sequences (LM archs): Toeplitz FFT, exact for any f (core.toeplitz),
    and the pieces of the sequence mask the fused sweep and the O(1)-state
    decode need (Chebyshev tables, within-chunk tiles);
  - grids/trees (ViT): the plan executor (`plan_api.fastmult`), exact;
  - many trees at once: `make_forest_fastmult` over a packed Forest.

Decode: for separable f (g = exp and t <= 1, or g = identity) the cross
term f(i - j) = sum_r alpha_r(i) beta_r(j) splits, so masked linear
attention has an O(1)-per-token state (the cordial decode states below).

`coeffs` carries leading head dims (H, t+1) where it may, and every
result is differentiable in it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import plan_api
from repro_torch.core.plan_api import PlanParams, PlanSpec
from repro_torch.core.toeplitz import (causal_toeplitz_matvec,
                                       symmetric_toeplitz_matvec)
from repro_torch.device import resolve_device

GS = {
    "exp": torch.exp,
    "recip": lambda z: 1.0 / (1.0 + z * z),  # stabilized z -> z^{-1} family
    "identity": lambda z: z,
}


def _coeffs(coeffs, device=None) -> torch.Tensor:
    return torch.as_tensor(coeffs, dtype=torch.float32, device=device)


def mask_f(g: str, coeffs, dist_scale: float = 1.0) -> Callable:
    """f(x) = g(sum_t coeffs[..., t] * (x * dist_scale)^t). coeffs may carry
    leading batch (head) dims; the result broadcasts accordingly."""

    def f(x):
        z = 0.0
        xs = x * dist_scale
        c = _coeffs(coeffs, x.device)
        for t in range(c.shape[-1] - 1, -1, -1):
            z = z * xs + (c[..., t, None] if c.ndim > 1 else c[..., t])
        return GS[g](z)

    return f


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
    c = _coeffs(coeffs)
    nodes, Bmat = chebyshev_separable_expansion(g, c, L, dist_scale, rank)
    pos = torch.arange(L, dtype=torch.float32, device=c.device)
    Lg = plan_api._lagrange_batched(pos[None, :],
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


# ----------------------------------------------------------------------------
# Algorithm 1 (App. C): general efficient low-rank masked attention
# ----------------------------------------------------------------------------


def masked_linear_attention(q_feat, k_feat, v, fastmult: Callable,
                            eps: float = 1e-6):
    """Alg. 1. q_feat/k_feat: (..., L, m) nonneg features, v: (..., L, d);
    fastmult(X) applies M to the L axis of X (..., L, c). Returns
    (..., L, d)."""
    m, d = q_feat.shape[-1], v.shape[-1]
    v1 = (k_feat[..., :, :, None] * v[..., :, None, :]).reshape(
        v.shape[:-1] + (m * d,))  # rows vec(phi(k_i) v_i^T)
    d1 = fastmult(v1)  # (..., L, m*d)
    d2 = fastmult(k_feat)  # (..., L, m)
    num = torch.einsum("...lm,...lmd->...ld", q_feat,
                       d1.reshape(d1.shape[:-1] + (m, d)))
    den = torch.einsum("...lm,...lm->...l", q_feat, d2)
    den = torch.where(den.abs() < eps, eps, den)
    return num / den[..., None]


def masked_attention_bruteforce(q_feat, k_feat, v, mask, eps: float = 1e-6):
    """Oracle: A = M ⊙ (phi(Q) phi(K)^T); O(L^2 d)."""
    A = torch.einsum("...lm,...km->...lk", q_feat, k_feat) * mask
    den = A.sum(dim=-1)
    den = torch.where(den.abs() < eps, eps, den)
    return torch.einsum("...lk,...kd->...ld", A, v) / den[..., None]


# ----------------------------------------------------------------------------
# sequence (Toeplitz) fastmult factory
# ----------------------------------------------------------------------------


def make_sequence_fastmult(g: str, coeffs, L: int, causal: bool,
                           dist_scale: float = 1.0) -> Callable:
    F = sequence_mask_values(g, coeffs, L, dist_scale)  # (..., L)

    def fastmult(X):
        if causal:
            return causal_toeplitz_matvec(F, X)
        return symmetric_toeplitz_matvec(F, X)

    return fastmult


# ----------------------------------------------------------------------------
# tree / grid (plan) fastmult factories
# ----------------------------------------------------------------------------

# columns of the folded field per plan execution. On the 14 x 14 grid plan
# the executor's temporaries (the Hankel spectra and inverse FFTs above
# all) take ~20-25 KB a column: unchunked, TopoViT-B/16 at 64 images (3.1 M
# columns) ran out of an H100's 80 GB; at 2^20 columns it peaks at 30.7
# GiB. The multiply is column-wise, so chunking does not change the result
FIELD_COL_CHUNK = 1 << 20


def _plan_pair(plan):
    if (isinstance(plan, (tuple, list)) and len(plan) == 2
            and isinstance(plan[0], PlanSpec)
            and isinstance(plan[1], PlanParams)):
        return plan
    raise TypeError(
        f"make_tree_fastmult takes a (PlanSpec, PlanParams) pair from "
        f"ftfi.build / ftfi.load_plan, got {type(plan).__name__}: the "
        "Integrator facade is not ported yet (ROADMAP A9b)")


def make_tree_fastmult(plan, g: str, coeffs, dist_scale: float = 1.0, *,
                       backend: str = "torch", device=None) -> Callable:
    """FastMult_M for M = [f(dist_T(i,j))] through the plan executor.

    `plan` is a `(spec, params)` pair from `ftfi.build` / `ftfi.load_plan`;
    `backend` is "torch" or "cuda" (`plan_api.fastmult`); the field and the
    result live on `device` (None: the CUDA card). The closure takes fields
    with any leading batch/head axes, (..., L, c): the multiply is linear,
    so they fold into the trailing column axis of one plan execution.

    The folded field runs through the executor `FIELD_COL_CHUNK` columns
    at a time, which bounds its temporaries on the card.

    The closure is built on every call (no memo: building it touches no
    device data) and captures the coeffs, so their gradients flow through
    the leaf blocks, the Hankel mask values and the diagonal correction."""
    spec, params = _plan_pair(plan)
    dev = resolve_device(device)
    base = plan_api.fastmult(spec, mask_f(g, _coeffs(coeffs, dev), dist_scale),
                             backend=backend, device=dev)

    def fastmult(X):  # X: (..., L, c)
        shape = X.shape
        L = shape[-2]
        Xf = X.reshape(-1, L, shape[-1]).movedim(0, -1)  # (L, c, B*)
        Xf = Xf.reshape(L, -1).float()
        out = [base(params, Xf[:, c0:c0 + FIELD_COL_CHUNK])
               for c0 in range(0, Xf.shape[1], FIELD_COL_CHUNK)]
        out = (out[0] if len(out) == 1 else torch.cat(out, dim=1)).reshape(
            L, shape[-1], -1)
        return out.movedim(-1, 0).reshape(shape)

    return fastmult


def make_forest_fastmult(plan, forest, g: str, coeffs,
                         dist_scale: float = 1.0, tree_weights=None, *,
                         backend: str = "torch", device=None) -> Callable:
    """Per-graph FastMult over a packed `Forest` field (..., sum_t n_t, c).

    `plan` is `ftfi.build(forest)`: its plan is block-diagonal across
    trees, so one execution applies each graph's own mask M_t =
    [f(dist_{T_t}(i,j))] to its own rows. `tree_weights` (K,) optionally
    scales each tree's output block (the multiply is linear, so that equals
    scaling its mask)."""
    base = make_tree_fastmult(plan, g, coeffs, dist_scale, backend=backend,
                              device=device)
    if tree_weights is None:
        return base
    w = torch.from_numpy(forest.broadcast(
        np.asarray(tree_weights, np.float32))).to(
            resolve_device(device))[:, None]  # (N, 1)

    def fastmult(X):  # X: (..., N, c)
        return base(X) * w

    return fastmult


# ----------------------------------------------------------------------------
# cordial decode states: O(1)-per-token masked linear attention (causal)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CordialDecomposition:
    """f(i - j) = sum_r alpha_r(i) beta_r(j): per-term callables evaluated
    on positions (float32 tensors)."""

    num_terms: int
    alpha: Callable  # (pos (...,),) -> (..., R)
    beta: Callable


def _on(a: np.ndarray, pos: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(pos.device)


def _pos(pos) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.float32)


def cordial_decomposition(g: str, coeffs, dist_scale: float = 1.0
                          ) -> CordialDecomposition:
    coeffs = np.asarray(coeffs, dtype=np.float32)
    T = coeffs.shape[-1] - 1
    if g == "exp" and T <= 1:
        # exp(a0 + a1 (i-j)s) = [e^{a0} e^{a1 s i}] * [e^{-a1 s j}]
        ea0 = np.exp(coeffs[..., 0])
        a1 = coeffs[..., 1] if T == 1 else np.zeros_like(coeffs[..., 0])

        def alpha(pos):
            pos = _pos(pos)
            return (_on(ea0, pos) * torch.exp(
                _on(a1, pos) * dist_scale * pos))[..., None]

        def beta(pos):
            pos = _pos(pos)
            return torch.exp(-_on(a1, pos) * dist_scale * pos)[..., None]

        return CordialDecomposition(1, alpha, beta)
    if g == "identity":
        # poly(i-j) = sum_t a_t sum_l C(t,l) i^l (-j)^{t-l}, consolidated by
        # l: alpha_l(i) = i^l, beta_l(j) = sum_{t>=l} a_t C(t,l) (-j)^{t-l}
        R = T + 1

        def alpha(pos):
            ps = _pos(pos) * dist_scale
            return torch.stack([ps ** l for l in range(R)], dim=-1)

        def beta(pos):
            ps = _pos(pos) * dist_scale
            outs = []
            for l in range(R):
                acc = 0.0
                for t in range(l, T + 1):
                    acc = acc + (_on(coeffs[..., t], ps) * math.comb(t, l)
                                 * (-ps) ** (t - l))
                outs.append(acc)
            return torch.stack(outs, dim=-1)

        return CordialDecomposition(R, alpha, beta)
    raise ValueError(
        f"g={g!r}, degree={T}: not exactly separable; use the Toeplitz path "
        "(chunked prefill) or g in {'exp' (deg<=1), 'identity'}")


def decode_state_init(decomp: CordialDecomposition, m: int, d: int,
                      batch_shape=(), dtype=torch.float32, device=None):
    """S: (..., R, m, d) cross-moment states; z: (..., R, m) normalizers."""
    R = decomp.num_terms
    return (torch.zeros(tuple(batch_shape) + (R, m, d), dtype=dtype,
                        device=device),
            torch.zeros(tuple(batch_shape) + (R, m), dtype=dtype,
                        device=device))


def decode_state_update(decomp, state, pos, k_feat, v):
    """Absorb the token at integer position `pos`: k_feat (..., m),
    v (..., d)."""
    S, z = state
    b = decomp.beta(torch.as_tensor(pos, dtype=torch.float32,
                                    device=S.device))
    b = torch.broadcast_to(b, S.shape[:-2])  # (..., R)
    S = S + b[..., None, None] * (k_feat[..., None, :, None]
                                  * v[..., None, None, :])
    z = z + b[..., None] * k_feat[..., None, :]
    return (S, z)


def decode_state_read(decomp, state, pos, q_feat, eps: float = 1e-6):
    """Masked linear attention output for the query at position `pos`."""
    S, z = state
    a = decomp.alpha(torch.as_tensor(pos, dtype=torch.float32,
                                     device=S.device))
    a = torch.broadcast_to(a, S.shape[:-2])  # (..., R)
    num = torch.einsum("...m,...rmd,...r->...d", q_feat, S, a)
    den = torch.einsum("...m,...rm,...r->...", q_feat, z, a)
    den = torch.where(den.abs() < eps, eps, den)
    return num / den[..., None]
