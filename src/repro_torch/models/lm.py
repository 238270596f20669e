"""Decoder-only LM of the port: the dense family with
`attention_variant` "full" (rope + softmax attention, the published
architecture), "performer" (causal linear attention) or "topo" (the
paper's Topological Transformer LM), and the ssm family (Mamba-1).

dense: [norm -> attention, norm -> gated MLP] x num_layers; ssm:
[norm -> mamba] x num_layers, no MLP. Layers run in a plain Python loop
(the reference's lax.scan is not copied). Parameter names follow the
reference's pytree paths (`blocks0/attn/wq[l]` -> `blocks.{l}.attn.wq`,
`blocks0/ssm/in_proj[l]` -> `blocks.{l}.ssm.in_proj`), so `convert.py` is
a renaming. The decode cache keeps the reference's layout, stacked over
layers under "blocks0": full {"k", "v": (num_layers, B, S, KV, hd)} in the
model's dtype; performer {"S": (num_layers, B, H, hd, hd), "z":
(num_layers, B, H, hd)}; topo {"S": (num_layers, B, H, R, m, hd), "z":
(num_layers, B, H, R, m)}, both in float32; ssm {"conv": (num_layers, B,
K-1, d_inner)} in the model's dtype and {"h": (num_layers, B, d_inner,
N)} in float32. MoE, MLA, hybrid, encdec and local attention come with
ROADMAP A10.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (Params, cross_entropy_loss,
                                       dense_init, dtype_of, embed_init,
                                       gated_mlp, gated_mlp_init, rms_norm)


VARIANTS = ("full", "performer", "topo")
FAMILIES = ("dense", "ssm")


def check_supported(cfg) -> None:
    if (cfg.is_encdec or cfg.family not in FAMILIES or cfg.mla or cfg.moe):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with MLA' if cfg.mla else ''}{' with MoE' if cfg.moe else ''}"
            " is not ported yet (ROADMAP A10); the port serves the dense "
            "and ssm families")
    if cfg.family == "dense" and cfg.attention_variant not in VARIANTS:
        raise NotImplementedError(
            f"attention_variant={cfg.attention_variant!r} is not ported yet "
            f"(ROADMAP A10); the port serves {VARIANTS}")


# ----------------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------------


class DecoderBlock(nn.Module):
    """One dense block: attn_norm, attn, topo (the mask scalars, topo
    variant only), mlp_norm, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = Params({"scale": (d,)}, dtype, device)
        self.attn = A.Attention(cfg, dtype, device)
        if cfg.attention_variant == "topo":
            self.topo = Params(A.topo_shapes(cfg), dtype, device)
        self.mlp_norm = Params({"scale": (d,)}, dtype, device)
        self.mlp = Params({"w_gate": (d, cfg.d_ff), "w_in": (d, cfg.d_ff),
                           "w_out": (cfg.d_ff, d)}, dtype, device)


class MambaBlock(nn.Module):
    """One ssm block: norm, ssm (the Mamba mixer's parameters)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = Params({"scale": (cfg.d_model,)}, dtype, device)
        self.ssm = SSM.SSM(cfg, dtype, device)


BLOCKS = {"attn_mlp": DecoderBlock, "mamba": MambaBlock}


class DecoderLM(nn.Module):
    """embed, blocks (a ModuleList of DecoderBlock or MambaBlock),
    final_norm, and lm_head unless the embeddings are tied. Parameters live
    in the config's dtype. `forward(tokens)` is the cacheless prefill
    (last-position logits)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        (kind, count, _), = stack_desc(cfg).segments
        dtype = dtype_of(cfg)
        V, d = cfg.padded_vocab(), cfg.d_model
        self.cfg = cfg
        self.embed = Params({"table": (V, d)}, dtype, device)
        self.blocks = nn.ModuleList([BLOCKS[kind](cfg, dtype, device)
                                     for _ in range(count)])
        self.final_norm = Params({"scale": (d,)}, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Params({"kernel": (d, V)}, dtype, device)

    def forward(self, tokens):
        return forward_prefill(self.cfg, self, {"tokens": tokens})


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg, kind: str, dtype) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"norm": {"scale": torch.zeros((d,), dtype=dtype,
                                              device=gen.device)},
                "ssm": SSM.ssm_init(gen, cfg, dtype)}
    p = {"attn_norm": {"scale": torch.zeros((d,), dtype=dtype,
                                            device=gen.device)},
         "attn": A.attn_init(gen, cfg, dtype)}
    if cfg.attention_variant == "topo":
        p["topo"] = A.topo_init(cfg, dtype, gen.device)
    p["mlp_norm"] = {"scale": torch.zeros((d,), dtype=dtype,
                                          device=gen.device)}
    p["mlp"] = gated_mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def _attn_train(cfg, p, x, positions):
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.attention_variant == "topo":
        return A.topo_attention_train(cfg, p.attn, p.topo, h, positions)
    if cfg.attention_variant == "performer":
        return A.performer_attention_train(cfg, p.attn, h, positions)
    return A.full_attention_train(cfg, p.attn, h, positions)


def _mlp(cfg, p, x):
    h = rms_norm(x, p.mlp_norm.scale, cfg.norm_eps, plus_one=True)
    return x + gated_mlp(p.mlp, h, cfg.mlp_act)


def _mamba_in(cfg, p, x):
    return rms_norm(x, p.norm.scale, cfg.norm_eps, plus_one=True)


def _block_train(cfg, kind, p, x, positions):
    if kind == "mamba":
        return x + SSM.mamba_block_train(cfg, p.ssm, _mamba_in(cfg, p, x))
    return _mlp(cfg, p, x + _attn_train(cfg, p, x, positions))


def _block_decode(cfg, kind, p, x, pos, cache, S):
    """x: (B, 1, d). Returns (x, new_cache)."""
    if kind == "mamba":
        y, cache = SSM.mamba_block_decode(cfg, p.ssm, _mamba_in(cfg, p, x),
                                          cache)
        return x + y, cache
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.attention_variant == "topo":
        y, cache = A.topo_attention_decode(cfg, p.attn, p.topo, h, pos,
                                           cache, L=S)
    elif cfg.attention_variant == "performer":
        y, cache = A.performer_attention_decode(cfg, p.attn, h, pos, cache)
    else:
        y, cache = A.full_attention_decode(cfg, p.attn, h, pos, cache)
    return _mlp(cfg, p, x + y), cache


def _block_prefill(cfg, kind, p, x, positions, lengths, cache, S,
                   tree_mask=None):
    """Whole-prompt forward (the math of `_block_train`) that also writes
    the decode cache for positions [0, lengths[b]). x: (B, Lp, d) right-
    padded; rows with lengths[b] == 0 leave their cache untouched."""
    if kind == "mamba":
        y, cache = SSM.mamba_block_prefill(cfg, p.ssm, _mamba_in(cfg, p, x),
                                           lengths, cache)
        return x + y, cache
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.attention_variant == "topo":
        y, cache = A.topo_attention_prefill(cfg, p.attn, p.topo, h,
                                            positions, lengths, cache, L=S,
                                            tree_mask=tree_mask)
    elif cfg.attention_variant == "performer":
        y, cache = A.performer_attention_prefill(cfg, p.attn, h, positions,
                                                 lengths, cache)
    else:
        y, cache = A.full_attention_prefill(cfg, p.attn, h, positions,
                                            lengths, cache)
    return _mlp(cfg, p, x + y), cache


def _block_cache_init(cfg, kind, B, S, device=None):
    if kind == "mamba":
        return SSM.mamba_decode_init(cfg, B, dtype_of(cfg), device)
    if cfg.attention_variant == "topo":
        return A.topo_decode_init(cfg, B, S, device=device)
    if cfg.attention_variant == "performer":
        return A.performer_decode_init(cfg, B, device=device)
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
            for name in ("k", "v")}


@dataclasses.dataclass(frozen=True)
class StackDesc:
    """(kind, count, scanned) segments, executed in order."""
    segments: tuple


def stack_desc(cfg) -> StackDesc:
    check_supported(cfg)
    kind = "mamba" if cfg.family == "ssm" else "attn_mlp"
    return StackDesc(((kind, cfg.num_layers, cfg.scan_layers),))


def _kind(cfg) -> str:
    (kind, _, _), = stack_desc(cfg).segments
    return kind


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------


def init_state_dict(cfg, gen: torch.Generator) -> dict:
    """Random weights (the reference's init recipe, drawn from `gen` on its
    device) as a state dict of `DecoderLM`."""
    dtype = dtype_of(cfg)
    kind = _kind(cfg)
    sd = {"embed.table": embed_init(gen, cfg.padded_vocab(), cfg.d_model,
                                    dtype)["table"]}
    for layer in range(cfg.num_layers):
        for part, leaves in _block_init(gen, cfg, kind, dtype).items():
            for name, t in leaves.items():
                sd[f"blocks.{layer}.{part}.{name}"] = t
    sd["final_norm.scale"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=gen.device)
    if not cfg.tie_embeddings:
        sd["lm_head.kernel"] = dense_init(
            gen, (cfg.d_model, cfg.padded_vocab()), dtype=dtype)
    return sd


def from_state_dict(cfg, sd: dict) -> DecoderLM:
    """A DecoderLM holding exactly the tensors of `sd` (strict: every name
    of the model, nothing else)."""
    model = DecoderLM(cfg, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def init_params(cfg, gen: torch.Generator) -> DecoderLM:
    return from_state_dict(cfg, init_state_dict(cfg, gen))


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------


def embed_tokens(cfg, model, tokens):
    x = model.embed.table[tokens]
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg, model, x):
    if cfg.tie_embeddings:
        return x @ model.embed.table.T
    return x @ model.lm_head.kernel


def _final(cfg, model, x):
    return rms_norm(x, model.final_norm.scale, cfg.norm_eps, plus_one=True)


def _remat(cfg) -> bool:
    """Whether `forward_train` recomputes each block in the backward (the
    counterpart of the reference's `_maybe_remat`). Both of its policies,
    "dots" and "nothing", become a whole-block recompute here: it changes
    memory, not numbers."""
    return bool(cfg.remat) and getattr(cfg, "remat_policy", "dots") != "none"


def forward_train(cfg, model, batch):
    """batch: {'tokens': (B, L)}. Returns (loss, {"aux": aux}): the mean
    next-token CE over `padded_vocab()` with its z-loss, plus the blocks'
    auxiliary loss (0 for the dense and ssm families: no MoE router yet)."""
    if cfg.mtp_depth > 0:
        raise NotImplementedError(
            "multi-token prediction (mtp_depth > 0) belongs to the DeepSeek "
            "configs, which are not ported yet (ROADMAP A10)")
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device)[None].expand(B, L)
    kind = _kind(cfg)
    remat = _remat(cfg) and torch.is_grad_enabled()
    for blk in model.blocks:
        if remat:
            x = checkpoint(_block_train, cfg, kind, blk, x, positions,
                           use_reentrant=False)
        else:
            x = _block_train(cfg, kind, blk, x, positions)
    logits = unembed(cfg, model, _final(cfg, model, x))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:],
                              cfg.padded_vocab())
    return loss + aux, {"aux": aux}


def forward_prefill(cfg, model, batch):
    """Prefill: logits for the last position (B, 1, V), no cache."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device)[None].expand(B, L)
    kind = _kind(cfg)
    for blk in model.blocks:
        x = _block_train(cfg, kind, blk, x, positions)
    return unembed(cfg, model, _final(cfg, model, x)[:, -1:, :])


def init_decode_cache(cfg, B: int, S: int, device=None) -> dict:
    one = _block_cache_init(cfg, _kind(cfg), B, S, device)
    n = cfg.num_layers
    return {"blocks0": {k: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                                       device=t.device)
                        for k, t in one.items()}}


def _layer(cache, layer: int) -> dict:
    return {k: t[layer] for k, t in cache["blocks0"].items()}


def _stack(caches: list) -> dict:
    return {"blocks0": {k: torch.stack([c[k] for c in caches])
                        for k in caches[0]}}


def forward_decode(cfg, model, cache, token, pos, S):
    """token: (B, 1) int; pos: () or (B,) int. Returns (logits (B, 1, V),
    new_cache)."""
    x = embed_tokens(cfg, model, token)
    kind = _kind(cfg)
    new = []
    for layer, blk in enumerate(model.blocks):
        x, c = _block_decode(cfg, kind, blk, x, pos, _layer(cache, layer), S)
        new.append(c)
    return unembed(cfg, model, _final(cfg, model, x)), _stack(new)


def forward_prefill_into_cache(cfg, model, cache, tokens, lengths, S,
                               tree_mask=None):
    """Fused prefill: the whole (right-padded) prompt batch in one forward
    pass that also writes each row's state into the decode cache.

    tokens: (B, Lp) int, right-padded; lengths: (B,) int; rows with
    lengths[b] == 0 keep their cache. Returns (logits (B, V) of each row's
    last real token, new_cache)."""
    B, Lp = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    positions = torch.arange(Lp, dtype=torch.int32,
                             device=x.device)[None].expand(B, Lp)
    kind = _kind(cfg)
    new = []
    for layer, blk in enumerate(model.blocks):
        x, c = _block_prefill(cfg, kind, blk, x, positions, lengths,
                              _layer(cache, layer), S, tree_mask=tree_mask)
        new.append(c)
    x = _final(cfg, model, x)
    last = (lengths - 1).clamp(0, Lp - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return unembed(cfg, model, x_last)[:, 0], _stack(new)
