"""Shared neural layers of the port: init helpers on an explicit
`torch.Generator`, RMS norm, rope, the logit softcap and the gated MLP.
Weights keep the reference's `(in, out)` layout (`x @ W`), so reference
weights copy over unchanged. And the next-token loss with its z-loss."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import sharding
from repro_torch.launch.sharding import shard


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
    h = shard(h, ("batch", "seq", "ff"))
    return h @ p.w_out


def embed_lookup(table, tokens):
    """table[tokens]. On a DTensor table (vocab-sharded by the rules) it
    runs on each rank's slab (`_sharded_embed_lookup`)."""
    if sharding.is_dtensor(table):
        return _sharded_embed_lookup(table, tokens)
    return table[tokens]


def _sharded_embed_lookup(table, tokens):
    """table (V, d) DTensor, rows sharded over the mesh dims that shard
    the vocab, and tokens (B, L), batch-sharded or replicated: each rank
    looks its tokens up in its rows, zeros elsewhere, so the output is
    partial over the vocab's ranks (summed by the next `shard`) and
    batch-sharded as the tokens are. DTensor's own indexing backward
    (index_put) failed to propagate this sharding with torch 2.11."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not sharding.is_dtensor(tokens):
        from torch.distributed.tensor import DTensor

        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab_dims = [j for j, p in enumerate(table.placements) if p == Shard(0)]
    tok_pl = [Replicate() if j in vocab_dims or not p.is_shard() else p
              for j, p in enumerate(tokens.placements)]
    out_pl = [Partial() if j in vocab_dims else p
              for j, p in enumerate(tok_pl)]
    tab_gpl = [p if j in vocab_dims else
               Partial() if tok_pl[j].is_shard() else Replicate()
               for j, p in enumerate(table.placements)]

    def local(tab, tok):
        vloc = tab.shape[0]
        off = 0
        for j in vocab_dims:  # the vocab shards nest in mesh-dim order
            off = off * mesh.size(j) + mesh.get_local_rank(j)
        rows = tok.long() - off * vloc
        hit = (rows >= 0) & (rows < vloc)
        return tab[rows.clamp(0, vloc - 1)] * hit[..., None].to(tab.dtype)

    return sharding.local_face(local, (table, tokens),
                               (list(table.placements), tok_pl), out_pl,
                               (tab_gpl, None))


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32) -> dict:
    x = torch.randn((vocab, d_model), generator=gen, device=gen.device)
    return {"table": (x * 0.02).to(dtype)}


def cross_entropy_loss(logits, labels, vocab_size: int,
                       z_loss: float = 1e-4):
    """Mean next-token CE in float32, with z-loss; labels outside [0,
    vocab_size) are masked. The reference's formula, term by term (not
    `F.cross_entropy`, which has no z-loss and another masking). On
    DTensor logits it runs on each rank's slab (`_sharded_cross_entropy`).
    """
    if sharding.is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels, vocab_size, z_loss)
    logits = logits.float()
    mask = (labels >= 0) & (labels < vocab_size)
    labels_c = labels.clamp(0, vocab_size - 1).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = logz - gold + z_loss * logz.square()
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / mask.sum().clamp_min(1)


def _sharded_cross_entropy(logits, labels, vocab_size: int, z_loss: float):
    """`cross_entropy_loss` of DTensor logits (B, L, V), each mesh dim
    sharding the batch, the length or the vocab, or replicating them. No
    collective moves the logits: per token, the max over the vocab is one
    all_reduce (max) and the sum of exponentials and the gold logit one
    all_reduce (sum) each over the vocab's ranks; the loss's numerator
    comes back partial over the batch's ranks (its count summed there)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    vdim = logits.ndim - 1
    vocab_dims = [j for j, p in enumerate(pl) if p == Shard(vdim)]
    row_dims = [j for j, p in enumerate(pl)
                if p.is_shard() and p != Shard(vdim)]
    lab_pl = [Replicate() if j in vocab_dims else p for j, p in enumerate(pl)]
    if not sharding.is_dtensor(labels):
        from torch.distributed.tensor import distribute_tensor

        labels = distribute_tensor(labels, mesh, [Replicate()] * mesh.ndim)

    def local_ce(lg, lab):
        lg = lg.float()
        vloc = lg.shape[-1]
        off = 0
        for j in vocab_dims:  # the vocab shards nest in mesh-dim order
            off = off * mesh.size(j) + mesh.get_local_rank(j)
        off *= vloc
        mask = (lab >= 0) & (lab < vocab_size)
        lab_c = lab.clamp(0, vocab_size - 1).long()
        mx = lg.detach().amax(dim=-1)
        for j in vocab_dims:
            mx = sharding.max_over(mx, mesh.get_group(j))
        sumexp = torch.exp(lg - mx[..., None]).sum(dim=-1)
        here = (lab_c >= off) & (lab_c < off + vloc)
        gold = torch.gather(lg, -1, (lab_c - off).clamp(0, vloc - 1)[
            ..., None])[..., 0] * here
        for j in vocab_dims:
            sumexp = sharding.sum_over(sumexp, mesh.get_group(j))
            gold = sharding.sum_over(gold, mesh.get_group(j))
        logz = mx + torch.log(sumexp)
        nll = logz - gold + z_loss * logz.square()
        nll = torch.where(mask, nll, 0.0)
        count = mask.sum().to(torch.float32)
        for j in row_dims:
            count = sharding.sum_over(count, mesh.get_group(j))
        return nll.sum() / count.clamp_min(1)

    out_pl = [Partial() if j in row_dims else Replicate()
              for j in range(mesh.ndim)]
    return sharding.local_face(local_ce, (logits, labels), (pl, lab_pl),
                               out_pl)


def causal_conv_step(conv, xin, w, b):
    """One decode step of a causal depthwise conv: conv (B, K-1, C) the
    last inputs, xin (B, 1, C) the new one, w (C, K), b (C,). Returns
    (out (B, C), the new conv buffer). A DTensor buffer steps on each
    rank's (batch, channels) slab (`sharding.cache_face`)."""
    def slab(seq, c, xin, w, b):
        buf = torch.cat([c["conv"], xin.to(c["conv"].dtype)], dim=1)
        xc = torch.einsum("bkc,ck->bc", buf[:, -w.shape[1]:], w) + b
        return (xc,), {"conv": buf[:, 1:]}

    (xc,), new = sharding.cache_face(
        slab, {"conv": conv}, {"conv": {"batch": 0, "heads": 2}},
        (xin, w, b), ({"batch": 0, "heads": 2}, {"heads": 0}, {"heads": 0}),
        ({"batch": 0, "heads": 1},))
    return xc, new["conv"]
