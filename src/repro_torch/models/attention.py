"""Attention variants of the port: full softmax (GQA), Performer (FAVOR+
with a deterministic phi) and the paper's Topological Performer (Sec 4.4 /
Alg. 1), each with train/prefill and O(1)-per-token decode.

  - full: rope, then causal softmax attention; `cfg.attn_impl` picks the
    dense `_sdpa` ("naive"), the plain online-softmax twin ("chunked") or
    the flash attention CUDA kernel ("cuda"); decode attends over the KV
    cache with `_sdpa`;
  - performer: causal linear attention over phi features; "cuda" runs the
    linear attention CUDA kernel, "naive" and "chunked" its plain twin;
    decode carries the (S, z) state;
  - topo: masked linear attention under the sequence mask f(|i-j|);
    `cfg.topo_attn_impl` picks the dense oracle ("ref"), the plain chunked
    sweep ("torch"), the fused sweep kernel ("cuda", the reference's
    "pallas") or "fft": the separable decay path at g = exp, degree <= 1
    (through `causal_linear_attention` and so `cfg.attn_impl`), else Alg.
    1 with the Toeplitz-FFT FastMult (core/toeplitz.py, float64 FFTs);
    decode uses O(1)-state cordial recurrences (a non-separable f through
    the Chebyshev rank-R separable expansion shared with the sweep).

Local and MLA attention come with ROADMAP A10, the forest tree-mask
prefill with A11.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linear_attention import ops as linear_ops
from repro_torch.models.layers import Params, apply_rope, dense_init, softcap

IMPLS = ("ref", "torch", "cuda", "fft")  # cfg.topo_attn_impl
ATTN_IMPLS = ("naive", "chunked", "cuda")  # cfg.attn_impl


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


class Attention(Params):
    """The projections of one attention block: wq, wk, wv, wo (+ bq, bk,
    bv), in the reference's (in, out) layout."""

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
    B, L, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, L, H, hd)
    k = k.reshape(B, L, KV, hd)
    v = v.reshape(B, L, KV, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def _attn_impl(cfg) -> str:
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"cfg.attn_impl={cfg.attn_impl!r}: expected one of "
                         f"{ATTN_IMPLS}")
    return cfg.attn_impl


# ----------------------------------------------------------------------------
# full softmax attention (GQA)
# ----------------------------------------------------------------------------


def _sdpa(cfg, q, k, v, mask):
    """Dense softmax attention. q: (B, Lq, H, hd); k, v: (B, Lk, KV, hd);
    mask: (1|B, 1, Lq, Lk) bool. The weights are cast to v's dtype before
    P v, as the reference does."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Lq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(mask[:, :, None], logits, flash_ops.NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Lq, H, hd)


def _attend(cfg, q, k, v, causal: bool, window: int):
    """Self-attention over a whole sequence whose positions are aranges (as
    at every call site): q (B, L, H, hd), k/v (B, L, KV, hd) -> (B, L, H,
    hd), executed as `cfg.attn_impl` says."""
    impl = _attn_impl(cfg)
    if impl == "chunked":
        return flash_ops.sdpa_chunked(q, k, v, causal, window,
                                      cfg.attn_logit_softcap)
    if impl == "cuda":
        if window or cfg.attn_logit_softcap:
            raise NotImplementedError(
                "the flash attention kernel has no local window and no logit "
                "softcap (nor has the reference's kernel): local attention "
                "comes with ROADMAP A10; use attn_impl 'chunked'")
        out = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal)
        return out.transpose(1, 2)
    L = q.shape[1]
    idx = torch.arange(L, device=q.device)
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (idx[:, None] >= idx[None, :])
    if window and window > 0:
        mask = mask & (idx[:, None] - idx[None, :] < window)
    return _sdpa(cfg, q, k, v, mask[None, None])


def full_attention_train(cfg, p, x, positions, causal: bool = True,
                         window: int = 0, rope: bool = True):
    """Self-attention over the whole of x (B, L, d). (The reference's
    cross-attention branch, `kv_x`, comes with encdec, ROADMAP A10.)"""
    B, L, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, rope=rope)
    out = _attend(cfg, q, k, v, causal, window)
    return out.reshape(B, L, -1) @ p.wo


def full_attention_decode(cfg, p, x, pos, cache, window: int = 0,
                          rope: bool = True):
    """One-token decode. cache: {"k", "v"} (B, S, KV, hd); pos: () or (B,)
    (per-slot positions: each row writes and masks its own cache row)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos_v[:, None], rope=rope)
    S = cache["k"].shape[1]
    rows, at = torch.arange(B, device=x.device), pos_v.long()
    k, v = cache["k"].clone(), cache["v"].clone()
    k[rows, at] = k_new[:, 0].to(k.dtype)
    v[rows, at] = v_new[:, 0].to(v.dtype)
    idx = torch.arange(S, device=x.device)
    mask = idx[None, None, :] <= pos_v[:, None, None]  # (B, 1, S)
    if window and window > 0:
        mask = mask & (idx[None, None, :] > pos_v[:, None, None] - window)
    out = _sdpa(cfg, q, k, v, mask[:, None])
    return out.reshape(B, 1, H * hd) @ p.wo, {"k": k, "v": v}


def full_attention_prefill(cfg, p, x, positions, lengths, cache,
                           window: int = 0, rope: bool = True):
    """Whole-prompt prefill that writes K/V rows [0, Lp) into the decode
    cache. x: (B, Lp, d); rows with lengths[b] == 0 keep their cache (they
    belong to other live slots). Rows at or past lengths[b] may hold junk
    keys: decode at position q rewrites row q before its causal mask can
    see it. Returns (out (B, Lp, d), new_cache)."""
    B, Lp, _ = x.shape
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, rope=rope)
    out = _attend(cfg, q, k_new, v_new, True, window)
    out = out.reshape(B, Lp, -1) @ p.wo
    valid = (lengths > 0)[:, None, None, None]
    new = {}
    for name, t in (("k", k_new), ("v", v_new)):
        c = cache[name].clone()
        c[:, :Lp] = torch.where(valid, t.to(c.dtype), c[:, :Lp])
        new[name] = c
    return out, new


# ----------------------------------------------------------------------------
# causal linear attention and the Performer
# ----------------------------------------------------------------------------


def causal_linear_attention(qf, kf, v, log_gamma=None,
                            use_kernel: bool = False):
    """Unmasked (or gamma-decayed) causal linear attention. qf/kf: (B, L, H,
    m) nonneg; v: (B, L, H, hd); log_gamma: None, a scalar or (H,) log decay
    (the mask gamma^(i-j), the separable g = exp, degree-1 topological
    mask). Returns (num (B, L, H, hd), den (B, L, H)) in float32.

    use_kernel: the linear attention kernel through its wrapper (on CPU
    tensors the wrapper's plain version); else the plain twin of the
    reference's chunked scan."""
    if not use_kernel:
        return linear_ops.causal_linear_attention(qf, kf, v, log_gamma)
    H = qf.shape[2]
    lg = torch.broadcast_to(torch.as_tensor(
        0.0 if log_gamma is None else log_gamma, dtype=torch.float32,
        device=qf.device), (H,)).contiguous()
    num, den = linear_ops.linear_attention(
        qf.transpose(1, 2), kf.transpose(1, 2), v.transpose(1, 2), lg)
    return num.transpose(1, 2), den.transpose(1, 2)


def performer_decode_init(cfg, B: int, dtype=torch.float32, device=None):
    H, hd = cfg.num_heads, cfg.head_dim
    return {"S": torch.zeros((B, H, hd, hd), dtype=dtype, device=device),
            "z": torch.zeros((B, H, hd), dtype=dtype, device=device)}


def _performer_fields(cfg, p, x, positions):
    """phi(q), phi(k) (B, L, H, m) float32 and v (B, L, H, hd), GQA
    expanded, no rope."""
    q, k, v = _project_qkv(cfg, p, x, positions, rope=False)
    k, v = _expand_kv(cfg, k, v)
    return (phi_features(q, cfg.performer_phi),
            phi_features(k, cfg.performer_phi), v)


def _performer_attend(cfg, p, x, qf, kf, v, causal: bool):
    B, L, _ = x.shape
    if causal:
        num, den = causal_linear_attention(
            qf, kf, v, use_kernel=_attn_impl(cfg) == "cuda")
    else:
        kv = torch.einsum("blhm,blhv->bhmv", kf, v.float())
        num = torch.einsum("blhm,bhmv->blhv", qf, kv)
        den = torch.einsum("blhm,bhm->blh", qf, kf.sum(dim=1))
    out = linear_attention_output(num, den)
    return out.to(x.dtype).reshape(B, L, -1) @ p.wo


def performer_attention_train(cfg, p, x, positions, causal: bool = True):
    qf, kf, v = _performer_fields(cfg, p, x, positions)
    return _performer_attend(cfg, p, x, qf, kf, v, causal)


def performer_attention_decode(cfg, p, x, pos, cache):
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    qf, kf, v = _performer_fields(cfg, p, x, pos_v[:, None])
    qf, kf = qf[:, 0], kf[:, 0]
    S = cache["S"] + kf[..., None] * v[:, 0].float()[..., None, :]
    z = cache["z"] + kf
    num = torch.einsum("bhm,bhmv->bhv", qf, S)
    den = torch.einsum("bhm,bhm->bh", qf, z)
    out = linear_attention_output(num, den).to(x.dtype).reshape(
        B, 1, H * hd) @ p.wo
    return out, {"S": S, "z": z}


def performer_attention_prefill(cfg, p, x, positions, lengths, cache):
    """Fused performer prefill: the train-path attention over the prompt
    plus the closed-form linear-attention state of the prompt tokens,

        S = sum_{j < len_b} kf_j (x) v_j,   z = sum_{j < len_b} kf_j,

    set (not accumulated) into the cache so a reused slot never inherits a
    previous request's state; rows with lengths[b] == 0 keep theirs."""
    Lp = x.shape[1]
    qf, kf, v = _performer_fields(cfg, p, x, positions)
    out = _performer_attend(cfg, p, x, qf, kf, v, causal=True)
    vmask = (torch.arange(Lp, device=x.device)[None, :]
             < lengths[:, None]).float()  # (B, Lp)
    kv = (kf * vmask[:, :, None, None]).permute(0, 2, 3, 1)  # (B, H, m, Lp)
    S = kv @ v.float().permute(0, 2, 1, 3)  # (B, H, m, hd)
    z = kv.sum(dim=-1)
    valid = lengths > 0
    return out, {
        "S": torch.where(valid[:, None, None, None],
                         S.to(cache["S"].dtype), cache["S"]),
        "z": torch.where(valid[:, None, None],
                         z.to(cache["z"].dtype), cache["z"]),
    }


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


def _topo_separable_attention(cfg, qf, kf, v, coeffs, causal: bool):
    """The reference's "fft" impl at g = exp, degree <= 1: the mask is
    e^{a0} gamma^(i-j) (gamma^|i-j| bidirectional), a decayed causal linear
    attention. The e^{a0} factor cancels in the normalization except where
    the eps clamp of the denominator binds, so it is folded into kf, as
    the other impls do. Bidirectional: forward + reversed - the diagonal
    (counted twice). (B, L, H, .) in, (B, L, H, hd) float32 out."""
    kf = kf * torch.exp(coeffs[:, 0])[None, None, :, None]
    lg = (coeffs[:, 1] * cfg.topo_dist_scale if coeffs.shape[1] > 1
          else torch.zeros(cfg.num_heads, device=qf.device))
    use_kernel = _attn_impl(cfg) == "cuda"
    num, den = causal_linear_attention(qf, kf, v, lg, use_kernel)
    if not causal:
        nb, db = causal_linear_attention(qf.flip(1), kf.flip(1), v.flip(1),
                                         lg, use_kernel)
        diag = torch.einsum("blhm,blhm->blh", qf, kf)
        num = num + nb.flip(1) - diag[..., None] * v.float()
        den = den + db.flip(1) - diag
    return linear_attention_output(num, den)


# feature columns of Alg. 1's k (x) v field per Toeplitz product in
# `_topo_fft_attention`
FFT_COL_CHUNK = 8


def _topo_fft_attention(cfg, qf, kf, v, coeffs, causal: bool):
    """Alg. 1 with the Toeplitz-FFT FastMult, chunked over feature columns:
    exact for any g and degree, memory O(B L H FFT_COL_CHUNK hd) instead of
    O(B L H m hd). The accumulators are float32 and the FFTs float64
    (core/toeplitz.py says why). (B, L, H, .) in, (B, L, H, hd) out."""
    from repro_torch.core.masks import sequence_mask_values
    from repro_torch.core.toeplitz import (causal_toeplitz_matvec,
                                           symmetric_toeplitz_matvec)

    B, L, H, m = qf.shape
    hd = v.shape[-1]
    F = sequence_mask_values(cfg.topo_g, coeffs, L,
                             cfg.topo_dist_scale)[None]  # (1, H, L)
    fastmult = causal_toeplitz_matvec if causal else symmetric_toeplitz_matvec
    qf32, kf32, v32 = qf.float(), kf.float(), v.float()
    d2 = fastmult(F, kf32.transpose(1, 2)).transpose(1, 2)
    den = torch.einsum("blhm,blhm->blh", qf32, d2)
    num = torch.zeros((B, L, H, hd), dtype=torch.float32, device=qf.device)
    for c0 in range(0, m, FFT_COL_CHUNK):
        c1 = min(c0 + FFT_COL_CHUNK, m)
        v1 = kf32[..., c0:c1, None] * v32[..., None, :]  # (B, L, H, c, hd)
        v1 = v1.reshape(B, L, H, -1).transpose(1, 2)  # (B, H, L, c*hd)
        d1 = fastmult(F, v1).transpose(1, 2).reshape(B, L, H, c1 - c0, hd)
        num = num + torch.einsum("blhc,blhcv->blhv", qf32[..., c0:c1], d1)
    return linear_attention_output(num, den)


def resolve_topo_backend(cfg, backend: str | None = None) -> str:
    """Plan backend of the tree- and grid-mask fastmults (the ViT path):
    the explicit `backend`, else cfg.topo_backend, else "cuda" where
    cfg.topo_attn_impl is "cuda" and "torch" otherwise, used as given: a
    rung blocked by `ladder.block_backend` is not skipped here, since the
    degradation ladder never moves a card path off its kernel."""
    return (backend or cfg.topo_backend
            or ("cuda" if cfg.topo_attn_impl == "cuda" else "torch"))


def topo_attention_train(cfg, p, p_topo, x, positions, causal: bool = True):
    """Masked linear attention (Alg. 1) with the sequence topological mask,
    over the whole of x (B, L, d). Impl (cfg.topo_attn_impl): "ref" the
    dense (L, L) oracle, "torch" the plain chunked sweep, "cuda" the fused
    kernel (on CPU tensors its wrapper runs the plain sweep), "fft" the
    separable decay path at g = exp, degree <= 1, else Alg. 1 with the
    Toeplitz-FFT FastMult."""
    B, L, _ = x.shape
    impl = cfg.topo_attn_impl
    if impl not in IMPLS:
        raise ValueError(f"cfg.topo_attn_impl={impl!r}: expected one of "
                         f"{IMPLS}")
    separable = cfg.topo_g == "exp" and cfg.topo_degree <= 1
    q, k, v = _project_qkv(cfg, p, x, positions, rope=False)
    k, v = _expand_kv(cfg, k, v)
    scale = topo_logit_scale(cfg, p_topo)  # (H,)
    qf = phi_features(q * scale[None, None, :, None], cfg.performer_phi)
    kf = phi_features(k, cfg.performer_phi)
    coeffs = topo_mask_coeffs(cfg, p_topo)  # (H, t+1)
    if impl == "fft" and separable:
        out = _topo_separable_attention(cfg, qf, kf, v, coeffs, causal)
    elif impl == "fft":
        out = _topo_fft_attention(cfg, qf, kf, v, coeffs, causal)
    else:
        args = (qf.permute(0, 2, 1, 3), kf.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3).float(), coeffs)
        kw = dict(g=cfg.topo_g, dist_scale=cfg.topo_dist_scale,
                  causal=causal)
        if impl == "ref":
            from repro_torch.kernels.topo_linear_attention.ref import (
                topo_linear_attention_ref)
            out = topo_linear_attention_ref(*args, **kw)
        else:
            from repro_torch.kernels.topo_linear_attention.ops import (
                topo_linear_attention)
            out = topo_linear_attention(*args, use_kernel=impl == "cuda",
                                        **kw)
        out = out.permute(0, 2, 1, 3)
    H, hd = cfg.num_heads, cfg.head_dim
    return out.to(x.dtype).reshape(B, L, H * hd) @ p.wo


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
