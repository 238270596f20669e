"""Topological Performer attention (paper Sec 4.4 / Alg. 1): masked linear
attention under the sequence mask f(|i-j|), f = g(sum_t a_t x^t).

  - train/prefill: exact; `cfg.topo_attn_impl` picks the dense oracle
    ("ref"), the plain chunked sweep ("torch", the reference's XLA twin) or
    the fused CUDA sweep kernel ("cuda", the reference's "pallas");
  - decode: O(1)-state cordial recurrences; a non-separable f uses the
    Chebyshev rank-R separable expansion shared with the sweep.

Full/local/MLA/performer attention, rope and the Toeplitz-FFT path come
with ROADMAP A10 (and A5); the forest tree-mask prefill with A11.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import Params, dense_init

IMPLS = ("ref", "torch", "cuda")


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------


def attn_shapes(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
         "wo": (H * hd, d)}
    if cfg.qkv_bias:
        s.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return s


def attn_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    p = {name: dense_init(gen, shape, dtype=dtype)
         for name, shape in attn_shapes(cfg).items() if name[0] == "w"}
    if cfg.qkv_bias:
        p.update({name: torch.zeros(shape, dtype=dtype, device=gen.device)
                  for name, shape in attn_shapes(cfg).items()
                  if name[0] == "b"})
    return p


def topo_shapes(cfg) -> dict:
    lead = () if cfg.topo_synced else (cfg.num_heads,)
    return {"coeffs": lead + (cfg.topo_degree + 1,), "logit_scale": lead}


def topo_init(cfg, dtype=torch.float32, device=None) -> dict:
    """3 learnable scalars (synced) or 3/head (asynced): [a_0..a_t] +
    scale."""
    t = cfg.topo_degree
    shapes = topo_shapes(cfg)
    coeffs = np.zeros(shapes["coeffs"], dtype=np.float32)
    if t >= 1:
        coeffs[..., 1] = -1.0  # init: decaying mask
    return {"coeffs": torch.as_tensor(coeffs, device=device).to(dtype),
            "logit_scale": torch.zeros(shapes["logit_scale"], dtype=dtype,
                                       device=device)}


class TopoAttention(Params):
    """The projections of one topo block: wq, wk, wv, wo (+ bq, bk, bv),
    in the reference's (in, out) layout."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(attn_shapes(cfg), dtype, device)


# ----------------------------------------------------------------------------
# projections and features
# ----------------------------------------------------------------------------


def _positions_vec(pos, B: int, device=None) -> torch.Tensor:
    """Decode positions as a (B,) int32 vector: a scalar broadcasts to the
    whole batch (lockstep decode); a (B,) vector passes through (per-slot
    positions, so requests of different prompt lengths decode together)."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if p.ndim == 0:
        p = p.expand(B)
    return p


def _project_qkv(cfg, p, x, positions, rope: bool = True):
    if rope:
        raise NotImplementedError("rope is not ported yet (ROADMAP A10); the "
                                  "topo path projects with rope=False")
    B, L, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(B, L, H, hd), k.reshape(B, L, KV, hd),
            v.reshape(B, L, KV, hd))


def _expand_kv(cfg, k, v):
    G = cfg.num_heads // cfg.num_kv_heads
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    return k, v


def phi_features(x, kind: str):
    """Elementwise nonneg feature map applied to hd^-1/4-scaled q/k."""
    hd = x.shape[-1]
    x = x.float() * (hd ** -0.25)
    if kind == "relu":
        return torch.relu(x) + 1e-6
    if kind == "sq":
        return x.square()
    if kind == "quart":
        return x.square().square()
    if kind == "exp":
        return torch.exp(x.clamp(-20.0, 8.0))
    raise ValueError(kind)


def linear_attention_output(num, den, eps: float = 1e-6):
    den = torch.where(den.abs() < eps, eps, den)
    return (num / den[..., None]).to(num.dtype)


# ----------------------------------------------------------------------------
# topological masks on the token path metric
# ----------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def topo_mask_coeffs(cfg, p_topo):
    """Effective coefficients (H, t+1), stability-shaped: the degree-1
    coefficient is forced <= 0 (decay) via -softplus."""
    c = p_topo.coeffs.float()
    if c.ndim == 1:
        c = c[None].expand(cfg.num_heads, c.shape[0])
    out = [c[:, 0]]
    if c.shape[1] > 1:
        out.append(-_softplus(c[:, 1]))
    for t in range(2, c.shape[1]):
        out.append(-_softplus(c[:, t]) if cfg.topo_g == "exp" else c[:, t])
    return torch.stack(out, dim=1)  # (H, t+1)


def topo_logit_scale(cfg, p_topo):
    """Per-head feature temperature e^{logit_scale}, applied to q before
    phi (a post-phi scale would cancel in the normalization)."""
    ls = p_topo.logit_scale.float()
    return torch.exp(ls).expand(cfg.num_heads)


def topo_attention_train(cfg, p, p_topo, x, positions, causal: bool = True):
    """Masked linear attention (Alg. 1) with the sequence topological mask,
    over the whole of x (B, L, d). Impl (cfg.topo_attn_impl): "ref" the
    dense (L, L) oracle, "torch" the plain chunked sweep, "cuda" the fused
    kernel (on CPU tensors its wrapper runs the plain sweep)."""
    B, L, _ = x.shape
    impl = cfg.topo_attn_impl
    if impl == "fft":
        raise NotImplementedError(
            "topo_attn_impl='fft' (the Toeplitz-FFT path, core/toeplitz.py) is "
            "not ported yet (ROADMAP A5/A10); use 'torch' or 'cuda'")
    if impl not in IMPLS:
        raise ValueError(f"cfg.topo_attn_impl={impl!r}: expected one of "
                         f"{IMPLS}")
    q, k, v = _project_qkv(cfg, p, x, positions, rope=False)
    k, v = _expand_kv(cfg, k, v)
    scale = topo_logit_scale(cfg, p_topo)  # (H,)
    qf = phi_features(q * scale[None, None, :, None], cfg.performer_phi)
    kf = phi_features(k, cfg.performer_phi)
    coeffs = topo_mask_coeffs(cfg, p_topo)  # (H, t+1)
    args = (qf.permute(0, 2, 1, 3), kf.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3).float(), coeffs)
    kw = dict(g=cfg.topo_g, dist_scale=cfg.topo_dist_scale, causal=causal)
    if impl == "ref":
        from repro_torch.kernels.topo_linear_attention.ref import (
            topo_linear_attention_ref)
        out = topo_linear_attention_ref(*args, **kw)
    else:
        from repro_torch.kernels.topo_linear_attention.ops import (
            topo_linear_attention)
        out = topo_linear_attention(*args, use_kernel=impl == "cuda", **kw)
    H, hd = cfg.num_heads, cfg.head_dim
    out = out.permute(0, 2, 1, 3).to(x.dtype).reshape(B, L, H * hd)
    return out @ p.wo


# --- decode: cordial / Chebyshev-separable O(1) states -----------------------


def topo_decomposition(cfg, coeffs, L: int, rank: int = 24):
    """f(i-j) = sum_r alpha_r(i) beta_r(j) for i, j in [0, L).

    Exact rank-1 for g=exp, t<=1; otherwise the Chebyshev rank-`rank`
    expansion shared with the sweep (core.masks.chebyshev_separable_
    expansion), Lagrange-evaluated only at the queried positions.
    Returns (alpha, beta, R): alpha/beta map positions (N,) float32 to
    (N, H, R)."""
    from repro_torch.core.masks import chebyshev_separable_expansion
    from repro_torch.core.plan_api import _lagrange_batched

    s = cfg.topo_dist_scale
    H = coeffs.shape[0]
    if cfg.topo_g == "exp" and cfg.topo_degree <= 1:
        a1 = (coeffs[:, 1] if coeffs.shape[1] > 1
              else torch.zeros(H, dtype=torch.float32, device=coeffs.device))

        def alpha(pos):
            return torch.exp(a1[None, :] * s * pos[:, None])[..., None]

        def beta(pos):
            return torch.exp(-a1[None, :] * s * pos[:, None])[..., None]

        return alpha, beta, 1
    nodes, Bmat = chebyshev_separable_expansion(cfg.topo_g, coeffs, L, s, rank)
    nodes_t = torch.from_numpy(nodes).to(coeffs.device)[None, :]

    def lagr(pos):  # (N,) -> (N, rank)
        return _lagrange_batched(pos[None, :], nodes_t)[0]

    def alpha(pos):
        return torch.einsum("nr,hrq->nhq", lagr(pos), Bmat)

    def beta(pos):
        lg = lagr(pos)
        return lg[:, None, :].expand(lg.shape[0], H, rank)

    return alpha, beta, rank


def topo_decode_init(cfg, B: int, L: int, dtype=torch.float32,
                     rank: int = 24, device=None) -> dict:
    H, hd = cfg.num_heads, cfg.head_dim
    m = hd  # deterministic elementwise phi keeps feature dim = head_dim
    R = 1 if (cfg.topo_g == "exp" and cfg.topo_degree <= 1) else rank
    return {"S": torch.zeros((B, H, R, m, hd), dtype=dtype, device=device),
            "z": torch.zeros((B, H, R, m), dtype=dtype, device=device)}


def topo_attention_decode(cfg, p, p_topo, x, pos, cache, L: int,
                          rank: int = 24):
    """O(1)-state masked linear attention decode step. x: (B, 1, d);
    pos: () or (B,): alpha/beta are evaluated per slot position, so slots
    at different sequence depths share one batched step."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, pos_v[:, None], rope=False)
    k, v = _expand_kv(cfg, k, v)
    scale = topo_logit_scale(cfg, p_topo)  # (H,)
    qf = phi_features(q[:, 0] * scale[None, :, None], cfg.performer_phi)
    kf = phi_features(k[:, 0], cfg.performer_phi)
    coeffs = topo_mask_coeffs(cfg, p_topo)
    alpha, beta, R = topo_decomposition(cfg, coeffs, L, rank)
    pos_f = pos_v.float()
    b = beta(pos_f)  # (B, H, R)
    S = cache["S"] + b[:, :, :, None, None] * (
        kf[:, :, None, :, None] * v[:, 0].float()[:, :, None, None, :])
    z = cache["z"] + b[:, :, :, None] * kf[:, :, None, :]
    a = alpha(pos_f)  # (B, H, R)
    num = torch.einsum("bhm,bhrmv,bhr->bhv", qf, S, a)
    den = torch.einsum("bhm,bhrm,bhr->bh", qf, z, a)
    out = linear_attention_output(num, den).to(x.dtype).reshape(
        B, 1, H * hd) @ p.wo
    return out, {"S": S, "z": z}


def topo_attention_prefill(cfg, p, p_topo, x, positions, lengths, cache,
                           L: int, rank: int = 24, tree_mask=None):
    """Fused topo prefill: the exact train-path attention over the prompt
    plus the closed-form cordial decode state of the prompt tokens,

        S = sum_{j < len_b} beta(j) kf_j (x) v_j,
        z = sum_{j < len_b} beta(j) kf_j,

    set (not accumulated) into the cache so a reused slot never inherits a
    previous request's state. Rows with lengths[b] == 0 keep their state.
    """
    if tree_mask is not None:
        raise NotImplementedError("forest tree-mask prefill is not ported yet "
                                  "(ROADMAP A11)")
    B, Lp, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = topo_attention_train(cfg, p, p_topo, x, positions, causal=True)
    # only k and v feed the state: skip the q projection
    k, v = x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    k, v = _expand_kv(cfg, k.reshape(B, Lp, KV, hd), v.reshape(B, Lp, KV, hd))
    kf = phi_features(k, cfg.performer_phi)  # (B, Lp, H, m)
    coeffs = topo_mask_coeffs(cfg, p_topo)
    _, beta, R = topo_decomposition(cfg, coeffs, L, rank)
    bet = beta(torch.arange(Lp, dtype=torch.float32, device=x.device))
    vmask = (torch.arange(Lp, device=x.device)[None, :]
             < lengths[:, None]).float()  # (B, Lp)
    kv = (kf * vmask[:, :, None, None]).permute(0, 2, 3, 1).contiguous()
    vt = v.float().permute(0, 2, 1, 3).contiguous()  # (B, H, Lp, hd)
    bt = bet.permute(1, 2, 0)  # (H, R, Lp)
    # one r at a time: the (B, H, R, m, Lp) product would not fit at
    # served widths
    S = torch.stack([(kv * bt[None, :, r, None, :]) @ vt for r in range(R)],
                    dim=2)  # (B, H, R, m, hd)
    z = torch.einsum("bhml,hrl->bhrm", kv, bt)
    valid = lengths > 0
    return out, {
        "S": torch.where(valid[:, None, None, None, None],
                         S.to(cache["S"].dtype), cache["S"]),
        "z": torch.where(valid[:, None, None, None],
                         z.to(cache["z"].dtype), cache["z"]),
    }
