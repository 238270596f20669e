"""Attention variants of the port: full softmax (GQA), MLA (DeepSeek's
multi-head latent attention), Performer (FAVOR+ with a deterministic phi)
and the paper's Topological Performer (Sec 4.4 / Alg. 1), each with
train/prefill and O(1)-per-token decode.

  - full: rope, then causal softmax attention, optionally under a local
    window (RecurrentGemma's local attention) or non-causal (an encoder),
    or cross-attention from a decoder's queries to an encoder's memory
    (`kv_x`); `cfg.attn_impl` picks the dense `_sdpa` ("naive"), the plain
    online-softmax twin ("chunked") or the flash attention CUDA kernel
    ("cuda"); decode attends over the KV cache with `_sdpa`, local
    attention over a ring of the window's last W keys;
  - MLA: "naive" the reference's two-einsum logits; "chunked" and "cuda"
    pack nope || rope into one 192-wide q/k head (k_rope broadcast over the
    heads) beside the 128-wide v and run the plain online-softmax twin or
    the flash attention kernel at (hd, vd) = (192, 128); decode is the
    absorbed form in float32 over the latent cache {"ckv", "krope"};
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

The topo prefill also takes a per-request tree mask served from one
packed forest plan (`tree_mask`, serve/forest_masks.py): the prompt then
attends bidirectionally under each request's tree metric through Alg. 1
with `masks.make_tree_fastmult` (the plan executor's Chebyshev engine, no
kernel), and generated tokens continue through the causal recurrence.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linear_attention import ops as linear_ops
from repro_torch.launch import sharding
from repro_torch.launch.sharding import (match_heads, shard, shard_q_heads,
                                         split_heads)
from repro_torch.models.layers import (Params, apply_rope, dense_init,
                                       rms_norm, softcap)

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


def mla_shapes(cfg) -> dict:
    """MLA's projections: the kv down-projection to the latent c_kv with
    its norm, its up-projection to per-head k_nope and v, the shared rope
    key, the output; and q through a LoRA (w_dq, q_norm, w_uq) or one wq."""
    d, H = cfg.d_model, cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    s = {"w_dkv": (d, r_kv), "kv_norm": (r_kv,),
         "w_ukv": (r_kv, H * (nope + vdim)), "w_kr": (d, rope),
         "wo": (H * vdim, d)}
    if r_q > 0:
        s.update(w_dq=(d, r_q), q_norm=(r_q,), w_uq=(r_q, H * (nope + rope)))
    else:
        s["wq"] = (d, H * (nope + rope))
    return s


def mla_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    return {name: (torch.zeros(shape, dtype=dtype, device=gen.device)
                   if name.endswith("norm") else
                   dense_init(gen, shape, dtype=dtype))
            for name, shape in mla_shapes(cfg).items()}


class MLA(Params):
    """The projections of one MLA block (`mla_shapes`)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(mla_shapes(cfg), dtype, device)


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
    q = split_heads(q, (B, L, H, hd))
    k = split_heads(k, (B, L, KV, hd))
    v = split_heads(v, (B, L, KV, hd))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_q_heads(q)
    k = shard(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard(v, ("batch", "seq", "kv_heads", "head_dim"))
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


def _sdpa_seq(cfg, q, k, v, mask, seq):
    """`_sdpa` over a cache whose sequence is sharded (`seq`, a
    `sharding.SeqShard`; None: `_sdpa` itself): each rank's partial max,
    sum and output over its block of the keys, met over `seq.group` (the
    flash-decoding combine). mask covers the rank's keys."""
    if seq is None:
        return _sdpa(cfg, q, k, v, mask)
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Lq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(mask[:, :, None], logits, flash_ops.NEG_INF)
    top = sharding.max_over(logits.amax(dim=-1, keepdim=True), seq.group)
    w = torch.exp(logits - top)
    den = sharding.sum_over(w.sum(dim=-1, keepdim=True), seq.group)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    out = sharding.sum_over(out.float(), seq.group) / den.permute(
        0, 3, 1, 2, 4)
    return out.to(v.dtype).reshape(B, Lq, H, hd)


def _write_row(c, at, new, seq):
    """A clone of the cache slab c (B, S, ...) with row `at` (B,) of each
    batch row set to new (B, ...). On a sequence-sharded slab (`seq`) only
    the rank whose block holds a row's position writes it, at its offset
    in the block (the clamped row is rewritten with itself elsewhere)."""
    c = c.clone()
    rows = torch.arange(c.shape[0], device=c.device)
    if seq is None:
        c[rows, at] = new.to(c.dtype)
        return c
    at = at - seq.offset
    mine = (at >= 0) & (at < c.shape[1])
    at = at.clamp(0, c.shape[1] - 1)
    keep = mine.reshape((-1,) + (1,) * (new.ndim - 1))
    c[rows, at] = torch.where(keep, new.to(c.dtype), c[rows, at])
    return c


# roles of the dims of the decode caches and of their step's tensors
# (`sharding.cache_face`)
_KV = {"batch": 0, "seq": 1, "heads": 2}  # (B, S, KV, hd)
_BH = {"batch": 0, "heads": 2}  # (B, 1, H, hd)
_B = {"batch": 0}
_STATE = {"batch": 0, "heads": 1}  # (B, H, ...)


def _attend(cfg, q, k, v, causal: bool, window: int):
    """Attention over whole sequences whose positions are aranges (as at
    every call site): q (B, Lq, H, hd), k/v (B, Lk, KV, hd) -> (B, Lq, H,
    hd); Lk = Lq for self-attention (causal, with a local window or not,
    or bidirectional), any Lk for cross-attention (not causal). Executed
    as `cfg.attn_impl` says. Under a mesh q's heads are gathered where k's
    do not shard alike (`sharding.match_heads`)."""
    impl = _attn_impl(cfg)
    q = match_heads(q, k)
    if impl == "chunked":
        return flash_ops.sdpa_chunked(q, k, v, causal, window,
                                      cfg.attn_logit_softcap)
    if impl == "cuda":
        if cfg.attn_logit_softcap:
            raise NotImplementedError(
                "the flash attention kernel has no logit softcap (nor has "
                "the reference's kernel, and no config sets one); use "
                "attn_impl 'chunked'")
        # under a mesh each rank runs the kernel on its (batch, heads) slab
        out = sharding.slab_face(
            functools.partial(flash_ops.flash_attention, causal=causal,
                              window=window),
            (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            ((0, 1),) * 3, (0, 1))
        return out.transpose(1, 2)
    iq = torch.arange(q.shape[1], device=q.device)
    ik = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((len(iq), len(ik)), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (iq[:, None] >= ik[None, :])
    if window and window > 0:
        mask = mask & (iq[:, None] - ik[None, :] < window)
    return _sdpa(cfg, q, k, v, mask[None, None])


def full_attention_train(cfg, p, x, positions, causal: bool = True,
                         window: int = 0, rope: bool = True, kv_x=None,
                         kv_positions=None):
    """Attention over the whole of x (B, L, d): self-attention, or with
    `kv_x` (B, Lk, d) cross-attention whose keys and values are projected
    from kv_x (no bias, no rope, as the reference's cross branch; q is
    roped only where `rope` says). `kv_positions` is the reference's
    argument, aranges at every call site: the paths take the keys'
    positions as 0..Lk-1."""
    B, L, _ = x.shape
    if kv_x is None:
        q, k, v = _project_qkv(cfg, p, x, positions, rope=rope)
    else:
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = x @ p.wq
        if cfg.qkv_bias:
            q = q + p.bq
        q = split_heads(q, (B, L, H, hd))
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        Lk = kv_x.shape[1]
        k = split_heads(kv_x @ p.wk, (B, Lk, KV, hd))
        v = split_heads(kv_x @ p.wv, (B, Lk, KV, hd))
    out = _attend(cfg, q, k, v, causal, window)
    return out.reshape(B, L, -1) @ p.wo


def _full_decode_slab(cfg, window, seq, c, q, k_new, v_new, pos_v):
    """`full_attention_decode` on one rank's slab of the cache (all of it
    on one device): write the new row, attend over the slab."""
    S = c["k"].shape[1]
    at = pos_v.long()
    k = _write_row(c["k"], at, k_new[:, 0], seq)
    v = _write_row(c["v"], at, v_new[:, 0], seq)
    idx = torch.arange(S, device=q.device)
    if seq is not None:
        idx = idx + seq.offset
    mask = idx[None, None, :] <= pos_v[:, None, None]  # (B, 1, S)
    if window and window > 0:
        mask = mask & (idx[None, None, :] > pos_v[:, None, None] - window)
    return (_sdpa_seq(cfg, q, k, v, mask[:, None], seq),), {"k": k, "v": v}


def full_attention_decode(cfg, p, x, pos, cache, window: int = 0,
                          rope: bool = True):
    """One-token decode. cache: {"k", "v"} (B, S, KV, hd); pos: () or (B,)
    (per-slot positions: each row writes and masks its own cache row).
    A DTensor cache is read and written where it lies
    (`sharding.cache_face`): its batch over data, its KV heads over model
    where they divide, or (a batch-1 long context) its sequence over data,
    each rank then writing only the position its block holds and the
    softmax met over the blocks."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos_v[:, None], rope=rope)
    (out,), new = sharding.cache_face(
        functools.partial(_full_decode_slab, cfg, window), cache,
        {"k": _KV, "v": _KV}, (q, k_new, v_new, pos_v), (_BH, _BH, _BH, _B),
        (_BH,))
    return out.reshape(B, 1, H * hd) @ p.wo, new


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


def local_attention_decode_init(cfg, B: int, dtype=torch.float32,
                                device=None):
    """The ring of a local-attention layer: the last W keys and values
    {"k", "v": (B, W, KV, hd)} and their positions {"kpos": (B, W)} int32,
    -1 where a slot is empty; position p lives in slot p % W."""
    W, KV, hd = cfg.local_window, cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((B, W, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((B, W, KV, hd), dtype=dtype, device=device),
            "kpos": torch.full((B, W), -1, dtype=torch.int32,
                               device=device)}


def _local_decode_slab(cfg, seq, c, q, k_new, v_new, pos_v):
    W = c["k"].shape[1]
    slot = (pos_v % W).long()
    k = _write_row(c["k"], slot, k_new[:, 0], None)
    v = _write_row(c["v"], slot, v_new[:, 0], None)
    kpos = _write_row(c["kpos"], slot, pos_v, None)
    mask = (kpos >= 0) & (kpos <= pos_v[:, None])  # the ring is the window
    return ((_sdpa(cfg, q, k, v, mask[:, None, None, :]),),
            {"k": k, "v": v, "kpos": kpos})


def local_attention_decode(cfg, p, x, pos, cache):
    """Sliding-window decode over the ring (keys roped at their true
    position when written). pos: () or (B,). A DTensor ring is read and
    written on each rank's slab (`sharding.cache_face`)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos_v[:, None])
    ring = {"batch": 0, "heads": 2}
    (out,), new = sharding.cache_face(
        functools.partial(_local_decode_slab, cfg), cache,
        {"k": ring, "v": ring, "kpos": _B}, (q, k_new, v_new, pos_v),
        (_BH, _BH, _BH, _B), (_BH,))
    return out.reshape(B, 1, H * hd) @ p.wo, new


def local_attention_prefill(cfg, p, x, positions, lengths, cache):
    """Whole-prompt local attention (`_attend` under the window, so B5 on
    "cuda"; the reference runs its dense `_sdpa` here, the same function)
    that builds each valid row's ring from its last min(W, lengths[b])
    tokens only, kpos -1 elsewhere: junk keys past a row's length would be
    visible to later decode steps. Rows with lengths[b] == 0 keep their
    ring."""
    B, Lp, _ = x.shape
    W = cfg.local_window
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    out = _attend(cfg, q, k_new, v_new, True, W)
    out = out.reshape(B, Lp, -1) @ p.wo
    dev = x.device
    widx = lengths[:, None] - W + torch.arange(W, device=dev)[None, :]
    valid_w = (widx >= 0) & (lengths[:, None] > 0)  # (B, W) positions
    gidx = widx.clamp(0, max(Lp - 1, 0)).long()
    rows = torch.arange(B, device=dev)[:, None]
    slot = (widx % W).long()  # W consecutive positions: W distinct slots
    new = {}
    for name, t in (("k", k_new), ("v", v_new)):
        ring = torch.zeros_like(cache[name])
        ring[rows, slot] = torch.where(valid_w[..., None, None], t[rows, gidx],
                                       0.0).to(ring.dtype)
        new[name] = ring
    ring_p = torch.full_like(cache["kpos"], -1)
    ring_p[rows, slot] = torch.where(valid_w, widx, -1).to(torch.int32)
    new["kpos"] = ring_p
    valid = lengths > 0
    return out, {n: torch.where(valid.reshape((B,) + (1,) * (t.ndim - 1)),
                                t, cache[n]) for n, t in new.items()}


# ----------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2/V3)
# ----------------------------------------------------------------------------


def _mla_q(cfg, p, x, positions):
    """q_nope (B, L, H, nope) and the roped q_rope (B, L, H, rope)."""
    B, L, _ = x.shape
    H, nope = cfg.num_heads, cfg.qk_nope_dim
    with record_function("mla.proj"):
        if cfg.q_lora_rank > 0:
            q = rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps,
                         plus_one=True) @ p.w_uq
        else:
            q = x @ p.wq
        q = split_heads(q, (B, L, H, nope + cfg.qk_rope_dim))
        return q[..., :nope], apply_rope(q[..., nope:], positions,
                                         cfg.rope_theta)


def _mla_latent(cfg, p, x, positions):
    """What the decode cache keeps: c_kv (B, L, kv_lora_rank), normed, and
    the roped shared key k_rope (B, L, 1, rope)."""
    B, L, _ = x.shape
    with record_function("mla.proj"):
        ckv = rms_norm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps, plus_one=True)
        k_rope = apply_rope((x @ p.w_kr).reshape(B, L, 1, cfg.qk_rope_dim),
                            positions, cfg.rope_theta)
        return ckv, k_rope


def _mla_attend(cfg, p, q_nope, q_rope, ckv, k_rope, causal: bool):
    """Attention over the whole sequence from the latent: k_nope and v
    come up from c_kv; the output projected by wo, (B, L, d)."""
    B, L, H, nope = q_nope.shape
    rope, vdim = cfg.qk_rope_dim, cfg.v_head_dim
    with record_function("mla.proj"):
        kv = split_heads(ckv @ p.w_ukv, (B, L, H, nope + vdim))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_nope = shard(k_nope, ("batch", "seq", "heads", None))
    if _attn_impl(cfg) != "naive":
        # nope || rope packed into one head: the same logits, and no (L, L)
        # scores held (the reference's "§Perf B3")
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        k_cat = torch.cat([k_nope, k_rope.expand(B, L, H, rope)], dim=-1)
        out = _attend(cfg, q_cat, k_cat, v, causal, 0)
        return out.reshape(B, L, H * vdim) @ p.wo
    logits = (torch.einsum("blhn,bshn->bhls", q_nope.float(), k_nope.float())
              + torch.einsum("blhr,bsxr->bhls", q_rope.float(),
                             k_rope.float())) / math.sqrt(nope + rope)
    if causal:
        qi = torch.arange(L, device=q_nope.device)
        logits = torch.where(qi[:, None] >= qi[None, :], logits,
                             flash_ops.NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhls,bshv->blhv", w.to(v.dtype), v)
    return out.reshape(B, L, H * vdim) @ p.wo


def mla_attention_train(cfg, p, x, positions, causal: bool = True):
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv, k_rope, causal)


def mla_decode_init(cfg, B: int, S: int, dtype=torch.float32, device=None):
    return {"ckv": torch.zeros((B, S, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((B, S, cfg.qk_rope_dim), dtype=dtype,
                                 device=device)}


def _mla_decode_slab(cfg, seq, c, q_nope, q_rope, ckv_new, krope_new, pos_v,
                     w_ukv):
    """`mla_attention_decode` on one rank's slab: its batch rows, its
    query heads (w_ukv's columns alike) and, sequence-sharded, its block
    of the latent cache, the softmax met over the blocks."""
    nope, vdim = cfg.qk_nope_dim, cfg.v_head_dim
    H = q_nope.shape[2]
    at = pos_v.long()
    ckv = _write_row(c["ckv"], at, ckv_new[:, 0], seq)
    krope = _write_row(c["krope"], at, krope_new[:, 0, 0], seq)
    with record_function("mla.absorbed"):
        w_ukv = w_ukv.reshape(w_ukv.shape[0], H, nope + vdim).float()
        w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
        q_lat = torch.einsum("blhn,rhn->blhr", q_nope.float(), w_uk)
        ckv_f = ckv.float()
        logits = (torch.einsum("blhr,bsr->bhls", q_lat, ckv_f)
                  + torch.einsum("blhr,bsr->bhls", q_rope.float(),
                                 krope.float())
                  ) / math.sqrt(nope + cfg.qk_rope_dim)
        idx = torch.arange(ckv.shape[1], device=q_nope.device)
        if seq is not None:
            idx = idx + seq.offset
        mask = idx[None, None, None, :] <= pos_v[:, None, None, None]
        logits = torch.where(mask, logits, flash_ops.NEG_INF)
        if seq is None:
            w = torch.softmax(logits, dim=-1)
            out_lat = torch.einsum("bhls,bsr->blhr", w, ckv_f)
        else:
            top = sharding.max_over(logits.amax(dim=-1, keepdim=True),
                                    seq.group)
            w = torch.exp(logits - top)
            den = sharding.sum_over(w.sum(dim=-1, keepdim=True), seq.group)
            out_lat = sharding.sum_over(torch.einsum(
                "bhls,bsr->blhr", w, ckv_f), seq.group) / den.permute(
                0, 2, 1, 3)
        out = torch.einsum("blhr,rhv->blhv", out_lat, w_uv)
    return (out,), {"ckv": ckv, "krope": krope}


def mla_attention_decode(cfg, p, x, pos, cache):
    """Absorbed decode: the cache holds only (c_kv, k_rope). q_nope is taken
    through W_uk into the latent space, so scores and values are computed
    there, in float32: O(S (kv_lora_rank + rope) H) a step. A DTensor
    latent cache is read and written where it lies
    (`sharding.cache_face`): its batch over data, or its sequence; the
    query heads stay over model, where the cache (no heads dim) is
    replicated."""
    B = x.shape[0]
    H, vdim = cfg.num_heads, cfg.v_head_dim
    pos_v = _positions_vec(pos, B, x.device)
    positions = pos_v[:, None]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)  # (B, 1, H, *)
    ckv_new, krope_new = _mla_latent(cfg, p, x, positions)
    lat = {"batch": 0, "seq": 1}
    (out,), new = sharding.cache_face(
        functools.partial(_mla_decode_slab, cfg), cache,
        {"ckv": lat, "krope": lat},
        (q_nope, q_rope, ckv_new, krope_new, pos_v, p.w_ukv),
        (_BH, _BH, _B, _B, _B, {"heads": 1}), (_BH,))
    out = out.to(x.dtype).reshape(B, 1, H * vdim) @ p.wo
    return out, new


def mla_attention_prefill(cfg, p, x, positions, lengths, cache):
    """Whole-prompt MLA (the train path's attention) that writes the latent
    rows (c_kv, k_rope) [0, Lp) into the decode cache; rows with lengths[b]
    == 0 keep theirs, junk rows past lengths[b] are rewritten before they
    are read (as in `full_attention_prefill`)."""
    Lp = x.shape[1]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv_new, k_rope = _mla_latent(cfg, p, x, positions)
    out = _mla_attend(cfg, p, q_nope, q_rope, ckv_new, k_rope, True)
    valid = (lengths > 0)[:, None, None]
    new = {}
    for name, t in (("ckv", ckv_new), ("krope", k_rope[:, :, 0])):
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
    num, den = sharding.slab_face(
        linear_ops.linear_attention,
        (qf.transpose(1, 2), kf.transpose(1, 2), v.transpose(1, 2), lg),
        ((0, 1),) * 3 + ((None, 0),), ((0, 1), (0, 1)))
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


def _performer_decode_slab(seq, c, qf, kf, v):
    S = c["S"] + kf[..., None] * v.float()[..., None, :]
    z = c["z"] + kf
    num = torch.einsum("bhm,bhmv->bhv", qf, S)
    den = torch.einsum("bhm,bhm->bh", qf, z)
    return (linear_attention_output(num, den),), {"S": S, "z": z}


def performer_attention_decode(cfg, p, x, pos, cache):
    """The O(1) linear-attention state step; a DTensor state on each
    rank's (batch, heads) slab (`sharding.cache_face`)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    pos_v = _positions_vec(pos, B, x.device)
    qf, kf, v = _performer_fields(cfg, p, x, pos_v[:, None])
    (out,), new = sharding.cache_face(
        _performer_decode_slab, cache, {"S": _STATE, "z": _STATE},
        (qf[:, 0], kf[:, 0], v[:, 0]), (_STATE,) * 3, (_STATE,))
    return out.to(x.dtype).reshape(B, 1, H * hd) @ p.wo, new


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
    # the masked sweep is independent per (batch, head): the phi fields
    # stay batch over data and heads over model, never gathered
    qf = shard(qf, ("field_batch", None, "heads", None))
    kf = shard(kf, ("field_batch", None, "heads", None))
    v = shard(v, ("field_batch", None, "heads", None))
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
            out = sharding.slab_face(
                functools.partial(topo_linear_attention,
                                  use_kernel=impl == "cuda", **kw), args,
                ((0, 1),) * 3 + (((None, 0) if coeffs.ndim == 2
                                  else (None, None)),), (0, 1))
        out = out.permute(0, 2, 1, 3)
    out = shard(out, ("field_batch", None, "heads", None))
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
    at different sequence depths share one batched step. The state
    (B, H, R, m, hd) has no sequence dim: a DTensor state steps on each
    rank's (batch, heads) slab (`sharding.cache_face`)."""
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
    (out,), new = sharding.cache_face(
        _topo_decode_slab, cache, {"S": _STATE, "z": _STATE},
        (qf, kf, v[:, 0], beta(pos_f), alpha(pos_f)), (_STATE,) * 5,
        (_STATE,))
    return out.to(x.dtype).reshape(B, 1, H * hd) @ p.wo, new


def _topo_decode_slab(seq, c, qf, kf, v, b, a):
    """The cordial state step on one rank's (batch, heads) slab; b, a:
    beta and alpha at the slots' positions (B, H, R)."""
    S = c["S"] + b[:, :, :, None, None] * (
        kf[:, :, None, :, None] * v.float()[:, :, None, None, :])
    z = c["z"] + b[:, :, :, None] * kf[:, :, None, :]
    num = torch.einsum("bhm,bhrmv,bhr->bhv", qf, S, a)
    den = torch.einsum("bhm,bhrm,bhr->bh", qf, z, a)
    return (linear_attention_output(num, den),), {"S": S, "z": z}


def topo_attention_prefill(cfg, p, p_topo, x, positions, lengths, cache,
                           L: int, rank: int = 24, tree_mask=None):
    """Fused topo prefill: the exact train-path attention over the prompt
    plus the closed-form cordial decode state of the prompt tokens,

        S = sum_{j < len_b} beta(j) kf_j (x) v_j,
        z = sum_{j < len_b} beta(j) kf_j,

    set (not accumulated) into the cache so a reused slot never inherits a
    previous request's state. Rows with lengths[b] == 0 keep their state.

    `tree_mask` (optional) replaces the sequence mask over the prompt by a
    per-request tree mask served from a packed forest plan (see
    serve.forest_masks): {"make_fastmult": coeffs -> FastMult over the
    packed row space, "pack": (N,) packed row -> flat token b * Lp + l (-1:
    a foreign block or a ghost), "unpack": (B * Lp,) token -> packed row
    (-1: in no tree)}. The prompt attends bidirectionally under its tree
    metric (prefix-LM style: the prompt is completed context); the decode
    state is the sequence one above, so generated tokens continue through
    the causal cordial recurrence.
    """
    B, Lp, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tree_mask is None:
        out = topo_attention_train(cfg, p, p_topo, x, positions, causal=True)
    else:
        out = _topo_tree_masked_attention(cfg, p, p_topo, x, positions,
                                          tree_mask)
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


def _topo_tree_masked_attention(cfg, p, p_topo, x, positions, tree_mask):
    """Masked linear attention (Alg. 1) under per-request TREE masks: the
    tokens are packed into their forest rows, ONE block-diagonal plan
    execution applies every request's own M_t = [f(dist_{T_t}(i, j))], and
    the outputs scatter back to (B, Lp). Synced heads fold into one
    fastmult, unsynced heads take one each. Tokens outside every tree block
    get zero attention output (their rows are padding by construction).
    The maps hold -1 for "foreign": gathers take index max(i, 0) and are
    then zeroed, never index -1 (which would read the last row)."""
    from repro_torch.core.masks import masked_linear_attention

    B, Lp, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, positions, rope=False)
    k, v = _expand_kv(cfg, k, v)
    scale = topo_logit_scale(cfg, p_topo)
    qf = phi_features(q * scale[None, None, :, None], cfg.performer_phi)
    kf = phi_features(k, cfg.performer_phi)
    m = qf.shape[-1]
    pack = torch.as_tensor(tree_mask["pack"], device=x.device).long()
    unpack = torch.as_tensor(tree_mask["unpack"], device=x.device).long()
    take = pack.clamp(min=0)
    in_tree = (pack >= 0).float()[:, None, None]

    def packed(t, width):  # (B, Lp, H, width) -> (H, N, width), float32
        return (t.reshape(B * Lp, H, width)[take].float()
                * in_tree).movedim(1, 0)

    qp, kp, vp = packed(qf, m), packed(kf, m), packed(v, hd)
    coeffs = topo_mask_coeffs(cfg, p_topo)  # (H, t+1)

    def mk(c):  # the fastmult, its device time under one profiler range
        fm = tree_mask["make_fastmult"](c)

        def scoped(X):
            with record_function("topo.tree_fastmult"):
                return fm(X)
        return scoped

    if cfg.topo_synced:
        out_p = masked_linear_attention(qp, kp, vp, mk(coeffs[0]))
    else:
        out_p = torch.stack([
            masked_linear_attention(qp[h], kp[h], vp[h], mk(coeffs[h]))
            for h in range(H)])
    out_tok = out_p.movedim(0, 1)[unpack.clamp(min=0)]  # (B*Lp, H, hd)
    out_tok = out_tok * (unpack >= 0).to(out_tok.dtype)[:, None, None]
    return out_tok.to(x.dtype).reshape(B, Lp, H * hd) @ p.wo
