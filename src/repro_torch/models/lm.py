"""Decoder-only LM of the port: the dense family with
`attention_variant` "full" (rope + softmax attention, the published
architecture), "performer" (causal linear attention) or "topo" (the
paper's Topological Transformer LM), the moe family (DeepSeek: MLA or GQA
attention, first_dense_layers dense blocks, then MoE blocks, and the
multi-token-prediction head of DeepSeek-V3) and the ssm family (Mamba-1).

dense: [norm -> attention, norm -> gated MLP] x num_layers; moe: the same
for the first first_dense_layers layers, then [norm -> attention, norm ->
MoE FFN]; ssm: [norm -> mamba] x num_layers, no MLP. Layers run in a plain
Python loop (the reference's lax.scan is not copied). `model.blocks` holds
every layer in order; the reference stacks each segment of `stack_desc`
under its own key, `blocks{si}`, and parameter names follow its pytree
paths with the layer unstacked (`blocks0/attn/wq[l]` ->
`blocks.{l}.attn.wq`, `blocks1/moe/router[j]` -> `blocks.{f + j}.moe.
router` with f the first segment's count), so `convert.py` is a renaming.
The decode cache keeps the reference's layout, each segment stacked over
its layers under "blocks{si}": full {"k", "v": (n, B, S, KV, hd)} and MLA
{"ckv": (n, B, S, kv_lora_rank), "krope": (n, B, S, qk_rope_dim)} in the
model's dtype; performer {"S": (n, B, H, hd, hd), "z": (n, B, H, hd)};
topo {"S": (n, B, H, R, m, hd), "z": (n, B, H, R, m)}, both in float32;
ssm {"conv": (n, B, K-1, d_inner)} in the model's dtype and {"h": (n, B,
d_inner, N)} in float32. Hybrid, encdec, vlm and local attention come with
ROADMAP A10b.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (Params, cross_entropy_loss,
                                       dense_init, dtype_of, embed_init,
                                       gated_mlp, gated_mlp_init, rms_norm)


VARIANTS = ("full", "performer", "topo")
FAMILIES = ("dense", "moe", "ssm")
MTP_WEIGHT = 0.3  # the reference's weight of the multi-token-prediction loss


def check_supported(cfg) -> None:
    if cfg.is_encdec or cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' (encoder-decoder)' if cfg.is_encdec else ''} is not ported "
            "yet (ROADMAP A10b); the port serves the dense, moe and ssm "
            "families")
    if cfg.family != "ssm" and cfg.attention_variant not in VARIANTS:
        raise NotImplementedError(
            f"attention_variant={cfg.attention_variant!r} is not ported yet "
            f"(ROADMAP A10b: local attention); the port serves {VARIANTS}")


# ----------------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------------


class DecoderBlock(nn.Module):
    """One dense block: attn_norm, attn (MLA where cfg.mla, else GQA), topo
    (the mask scalars, topo variant only), mlp_norm, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = Params({"scale": (d,)}, dtype, device)
        self.attn = (A.MLA if cfg.mla else A.Attention)(cfg, dtype, device)
        if cfg.attention_variant == "topo":
            self.topo = Params(A.topo_shapes(cfg), dtype, device)
        self.mlp_norm = Params({"scale": (d,)}, dtype, device)
        self._ffn(cfg, dtype, device)

    def _ffn(self, cfg, dtype, device):
        d = cfg.d_model
        self.mlp = Params({"w_gate": (d, cfg.d_ff), "w_in": (d, cfg.d_ff),
                           "w_out": (cfg.d_ff, d)}, dtype, device)


class MoEBlock(DecoderBlock):
    """One MoE block: attn_norm, attn, topo (topo variant only), mlp_norm,
    moe (router, experts, shared experts) in place of the MLP."""

    def _ffn(self, cfg, dtype, device):
        self.moe = MOE.MoE(cfg, dtype, device)


class MambaBlock(nn.Module):
    """One ssm block: norm, ssm (the Mamba mixer's parameters)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = Params({"scale": (cfg.d_model,)}, dtype, device)
        self.ssm = SSM.SSM(cfg, dtype, device)


BLOCKS = {"attn_mlp": DecoderBlock, "moe": MoEBlock, "mamba": MambaBlock}


class DecoderLM(nn.Module):
    """embed, blocks (a ModuleList of the layers' blocks, in order),
    final_norm, lm_head unless the embeddings are tied, and the MTP head
    (mtp_proj, mtp_block, mtp_norm) where cfg.mtp_depth > 0. Parameters
    live in the config's dtype (the MoE router in float32).
    `forward(tokens)` is the cacheless prefill (last-position logits)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype = dtype_of(cfg)
        V, d = cfg.padded_vocab(), cfg.d_model
        self.cfg = cfg
        self.embed = Params({"table": (V, d)}, dtype, device)
        self.blocks = nn.ModuleList([BLOCKS[kind](cfg, dtype, device)
                                     for kind in layer_kinds(cfg)])
        self.final_norm = Params({"scale": (d,)}, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Params({"kernel": (d, V)}, dtype, device)
        if cfg.mtp_depth > 0:
            self.mtp_proj = Params({"kernel": (2 * d, d)}, dtype, device)
            self.mtp_block = DecoderBlock(cfg, dtype, device)
            self.mtp_norm = Params({"scale": (d,)}, dtype, device)

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
         "attn": (A.mla_init if cfg.mla else A.attn_init)(gen, cfg, dtype)}
    if cfg.attention_variant == "topo":
        p["topo"] = A.topo_init(cfg, dtype, gen.device)
    p["mlp_norm"] = {"scale": torch.zeros((d,), dtype=dtype,
                                          device=gen.device)}
    if kind == "moe":
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = gated_mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def _attn_train(cfg, p, x, positions):
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.mla:
        return A.mla_attention_train(cfg, p.attn, h, positions)
    if cfg.attention_variant == "topo":
        return A.topo_attention_train(cfg, p.attn, p.topo, h, positions)
    if cfg.attention_variant == "performer":
        return A.performer_attention_train(cfg, p.attn, h, positions)
    return A.full_attention_train(cfg, p.attn, h, positions)


def _ffn(cfg, kind, p, x):
    """x + the block's FFN of its norm: the gated MLP, or the MoE (with its
    aux). Returns (x, aux or None)."""
    h = rms_norm(x, p.mlp_norm.scale, cfg.norm_eps, plus_one=True)
    if kind == "moe":
        y, aux = MOE.moe_block(cfg, p.moe, h)
        return x + y, aux
    return x + gated_mlp(p.mlp, h, cfg.mlp_act), None


def _mamba_in(cfg, p, x):
    return rms_norm(x, p.norm.scale, cfg.norm_eps, plus_one=True)


def _block_train(cfg, kind, p, x, positions):
    """Returns (x, aux): aux is the MoE router's loss, None for the other
    kinds."""
    if kind == "mamba":
        return (x + SSM.mamba_block_train(cfg, p.ssm, _mamba_in(cfg, p, x)),
                None)
    return _ffn(cfg, kind, p, x + _attn_train(cfg, p, x, positions))


def _block_decode(cfg, kind, p, x, pos, cache, S):
    """x: (B, 1, d). Returns (x, new_cache)."""
    if kind == "mamba":
        y, cache = SSM.mamba_block_decode(cfg, p.ssm, _mamba_in(cfg, p, x),
                                          cache)
        return x + y, cache
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.mla:
        y, cache = A.mla_attention_decode(cfg, p.attn, h, pos, cache)
    elif cfg.attention_variant == "topo":
        y, cache = A.topo_attention_decode(cfg, p.attn, p.topo, h, pos,
                                           cache, L=S)
    elif cfg.attention_variant == "performer":
        y, cache = A.performer_attention_decode(cfg, p.attn, h, pos, cache)
    else:
        y, cache = A.full_attention_decode(cfg, p.attn, h, pos, cache)
    return _ffn(cfg, kind, p, x + y)[0], cache


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
    if cfg.mla:
        y, cache = A.mla_attention_prefill(cfg, p.attn, h, positions, lengths,
                                           cache)
    elif cfg.attention_variant == "topo":
        y, cache = A.topo_attention_prefill(cfg, p.attn, p.topo, h,
                                            positions, lengths, cache, L=S,
                                            tree_mask=tree_mask)
    elif cfg.attention_variant == "performer":
        y, cache = A.performer_attention_prefill(cfg, p.attn, h, positions,
                                                 lengths, cache)
    else:
        y, cache = A.full_attention_prefill(cfg, p.attn, h, positions,
                                            lengths, cache)
    return _ffn(cfg, kind, p, x + y)[0], cache


def _block_cache_init(cfg, kind, B, S, device=None):
    if kind == "mamba":
        return SSM.mamba_decode_init(cfg, B, dtype_of(cfg), device)
    if cfg.mla:
        return A.mla_decode_init(cfg, B, S, dtype_of(cfg), device)
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
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(("attn_mlp", cfg.first_dense_layers, False))
        segs.append(("moe", cfg.num_layers - cfg.first_dense_layers,
                     cfg.scan_layers))
        return StackDesc(tuple(segs))
    kind = "mamba" if cfg.family == "ssm" else "attn_mlp"
    return StackDesc(((kind, cfg.num_layers, cfg.scan_layers),))


def segments(cfg) -> list:
    """(key, kind, first layer, count) of each segment that has layers:
    the reference's "blocks{si}" keys of its params and decode cache, and
    where the segment's layers sit in `model.blocks`."""
    out, first = [], 0
    for si, (kind, count, _) in enumerate(stack_desc(cfg).segments):
        if count:
            out.append((f"blocks{si}", kind, first, count))
            first += count
    return out


def layer_kinds(cfg) -> list:
    return [kind for _, kind, _, count in segments(cfg)
            for _ in range(count)]


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------


def init_state_dict(cfg, gen: torch.Generator) -> dict:
    """Random weights (the reference's init recipe, drawn from `gen` on its
    device) as a state dict of `DecoderLM`."""
    dtype = dtype_of(cfg)
    d = cfg.d_model
    sd = {"embed.table": embed_init(gen, cfg.padded_vocab(), d,
                                    dtype)["table"]}
    for layer, kind in enumerate(layer_kinds(cfg)):
        for part, leaves in _block_init(gen, cfg, kind, dtype).items():
            for name, t in leaves.items():
                sd[f"blocks.{layer}.{part}.{name}"] = t
    sd["final_norm.scale"] = torch.zeros((d,), dtype=dtype,
                                         device=gen.device)
    if not cfg.tie_embeddings:
        sd["lm_head.kernel"] = dense_init(
            gen, (d, cfg.padded_vocab()), dtype=dtype)
    if cfg.mtp_depth > 0:
        sd["mtp_proj.kernel"] = dense_init(gen, (2 * d, d), dtype=dtype)
        for part, leaves in _block_init(gen, cfg, "attn_mlp", dtype).items():
            for name, t in leaves.items():
                sd[f"mtp_block.{part}.{name}"] = t
        sd["mtp_norm.scale"] = torch.zeros((d,), dtype=dtype,
                                           device=gen.device)
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


def _run_stack(cfg, model, x, positions, remat: bool = False):
    """The layers over the whole sequence (train and cacheless prefill).
    Returns (x, the summed aux of the MoE blocks, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, blk in zip(layer_kinds(cfg), model.blocks):
        if remat:
            x, a = checkpoint(_block_train, cfg, kind, blk, x, positions,
                              use_reentrant=False)
        else:
            x, a = _block_train(cfg, kind, blk, x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def _positions(tokens, dev):
    B, L = tokens.shape
    return torch.arange(L, dtype=torch.int32, device=dev)[None].expand(B, L)


def forward_train(cfg, model, batch):
    """batch: {'tokens': (B, L)}. Returns (loss, {"aux": aux}): the mean
    next-token CE over `padded_vocab()` with its z-loss, plus MTP_WEIGHT
    times the multi-token-prediction loss where cfg.mtp_depth > 0, plus the
    MoE blocks' summed auxiliary loss (0 without MoE blocks)."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, model, tokens)
    positions = _positions(tokens, x.device)
    x, aux = _run_stack(cfg, model, x, positions,
                        _remat(cfg) and torch.is_grad_enabled())
    h = _final(cfg, model, x)
    loss = cross_entropy_loss(unembed(cfg, model, h)[:, :-1], tokens[:, 1:],
                              cfg.padded_vocab())
    if cfg.mtp_depth > 0:
        loss = loss + MTP_WEIGHT * _mtp_loss(cfg, model, h, tokens,
                                             positions)
    return loss + aux, {"aux": aux}


def _mtp_loss(cfg, model, h, tokens, positions):
    """DeepSeek-V3's one-step multi-token prediction: the final hidden h_t
    joined with emb(t + 1) predicts token t + 2 through one more block."""
    emb_next = embed_tokens(cfg, model, tokens)
    hcat = torch.cat([h[:, :-1], emb_next[:, 1:]], dim=-1)
    hp, _ = _block_train(cfg, "attn_mlp", model.mtp_block,
                         hcat @ model.mtp_proj.kernel, positions[:, :-1])
    hp = rms_norm(hp, model.mtp_norm.scale, cfg.norm_eps, plus_one=True)
    return cross_entropy_loss(unembed(cfg, model, hp)[:, :-1], tokens[:, 2:],
                              cfg.padded_vocab())


def forward_prefill(cfg, model, batch):
    """Prefill: logits for the last position (B, 1, V), no cache."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, model, tokens)
    x, _ = _run_stack(cfg, model, x, _positions(tokens, x.device))
    return unembed(cfg, model, _final(cfg, model, x)[:, -1:, :])


def init_decode_cache(cfg, B: int, S: int, device=None) -> dict:
    cache = {}
    for key, kind, _, count in segments(cfg):
        one = _block_cache_init(cfg, kind, B, S, device)
        cache[key] = {k: torch.zeros((count,) + tuple(t.shape),
                                     dtype=t.dtype, device=t.device)
                      for k, t in one.items()}
    return cache


def _over_layers(cfg, model, cache, step):
    """Runs step(kind, block, layer cache) -> new layer cache over every
    layer in order; returns the new cache, each segment stacked under its
    key."""
    new = {}
    for key, kind, first, count in segments(cfg):
        cs = [step(kind, model.blocks[first + j],
                   {k: t[j] for k, t in cache[key].items()})
              for j in range(count)]
        new[key] = {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
    return new


def forward_decode(cfg, model, cache, token, pos, S):
    """token: (B, 1) int; pos: () or (B,) int. Returns (logits (B, 1, V),
    new_cache)."""
    x = embed_tokens(cfg, model, token)

    def step(kind, blk, c):
        nonlocal x
        x, c = _block_decode(cfg, kind, blk, x, pos, c, S)
        return c

    new = _over_layers(cfg, model, cache, step)
    return unembed(cfg, model, _final(cfg, model, x)), new


def forward_prefill_into_cache(cfg, model, cache, tokens, lengths, S,
                               tree_mask=None):
    """Fused prefill: the whole (right-padded) prompt batch in one forward
    pass that also writes each row's state into the decode cache.

    tokens: (B, Lp) int, right-padded; lengths: (B,) int; rows with
    lengths[b] == 0 keep their cache. Returns (logits (B, V) of each row's
    last real token, new_cache)."""
    B, Lp = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    positions = _positions(tokens, x.device)

    def step(kind, blk, c):
        nonlocal x
        x, c = _block_prefill(cfg, kind, blk, x, positions, lengths, c, S,
                              tree_mask=tree_mask)
        return c

    new = _over_layers(cfg, model, cache, step)
    x = _final(cfg, model, x)
    last = (lengths - 1).clamp(0, Lp - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return unembed(cfg, model, x_last)[:, 0], new
