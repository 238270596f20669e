"""Decoder-only LM of the port: the dense family with
`attention_variant` "full" (rope + softmax attention, the published
architecture), "performer" (causal linear attention) or "topo" (the
paper's Topological Transformer LM), the moe family (DeepSeek: MLA or GQA
attention, first_dense_layers dense blocks, then MoE blocks, and the
multi-token-prediction head of DeepSeek-V3), the ssm family (Mamba-1), the
hybrid family (RecurrentGemma: RG-LRU blocks and local attention) and the
vlm family (LLaVA-NeXT: a dense backbone over projected patch embeddings
ahead of the text). The encoder-decoder family is `encdec.py`.

dense and vlm: [norm -> attention, norm -> gated MLP] x num_layers; moe:
the same for the first first_dense_layers layers, then [norm -> attention,
norm -> MoE FFN]; ssm: [norm -> mamba] x num_layers, no MLP; hybrid:
num_superblocks x cfg.superblock, then cfg.tail_blocks, each "rec" a
[norm -> RG-LRU, norm -> gated MLP] block and each "attn" a [norm ->
causal attention under cfg.local_window, norm -> gated MLP] block. Layers
run in a plain Python loop (the reference's lax.scan is not copied).
`model.blocks` holds every layer in order; the reference stacks each
segment of `stack_desc` under its own key, `blocks{si}`, and parameter
names follow its pytree paths with the layer unstacked (`blocks0/attn/
wq[l]` -> `blocks.{l}.attn.wq`, `blocks1/moe/router[j]` -> `blocks.{f +
j}.moe.router` with f the first segment's count; hybrid `blocks0/b{bi}_
{kind}/...[j]` -> `blocks.{len(superblock) j + bi}...` and `tail{bi}/...`
-> the tail's layers after the superblocks), so `convert.py` is a
renaming. The decode cache keeps the reference's layout (`slots`), each
segment stacked over its layers under "blocks{si}" (hybrid: under
"blocks0"/"b{bi}_{kind}", and one unstacked "tail{bi}" each): full {"k",
"v": (n, B, S, KV, hd)} and MLA {"ckv": (n, B, S, kv_lora_rank), "krope":
(n, B, S, qk_rope_dim)} in the model's dtype; performer {"S": (n, B, H,
hd, hd), "z": (n, B, H, hd)}; topo {"S": (n, B, H, R, m, hd), "z": (n, B,
H, R, m)}, both in float32; ssm {"conv": (n, B, K-1, d_inner)} in the
model's dtype and {"h": (n, B, d_inner, N)} in float32; local attention
the ring {"k", "v": (n, B, W, KV, hd), "kpos": (n, B, W) int32}; RG-LRU
{"conv": (n, B, 3, lru_width)} in the model's dtype and {"h": (n, B,
lru_width)} in float32. The vlm's cache holds the text only, as the
reference's: `forward_prefill_into_cache` and decode take tokens.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import sharding
from repro_torch.launch.sharding import shard
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (Params, cross_entropy_loss,
                                       dense_init, dtype_of, embed_init,
                                       embed_lookup, gated_mlp,
                                       gated_mlp_init, rms_norm)


VARIANTS = ("full", "performer", "topo")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")  # and encdec (encdec.py)
MTP_WEIGHT = 0.3  # the reference's weight of the multi-token-prediction loss
PATCH_DIM = 1024  # the vlm's stub vision tower: patch embedding width


def check_supported(cfg) -> None:
    """Raises ValueError on a config the reference has no meaning for: a
    family or attention variant it does not define."""
    if not cfg.is_encdec and cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r}: expected one of "
                         f"{FAMILIES + ('encdec',)}")
    if cfg.family != "ssm" and cfg.attention_variant not in VARIANTS:
        raise ValueError(f"attention_variant={cfg.attention_variant!r}: "
                         f"expected one of {VARIANTS}")


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


class RecBlock(nn.Module):
    """One hybrid recurrent block: norm, lru (the RG-LRU's parameters),
    mlp_norm, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm = Params({"scale": (d,)}, dtype, device)
        self.lru = RG.LRU(cfg, dtype, device)
        self.mlp_norm = Params({"scale": (d,)}, dtype, device)
        self.mlp = Params({"w_gate": (d, cfg.d_ff), "w_in": (d, cfg.d_ff),
                           "w_out": (cfg.d_ff, d)}, dtype, device)


# a hybrid attention block ("attn_local_mlp") has a dense block's params
BLOCKS = {"attn_mlp": DecoderBlock, "attn_local_mlp": DecoderBlock,
          "moe": MoEBlock, "mamba": MambaBlock, "rec_mlp": RecBlock}


class DecoderLM(nn.Module):
    """embed, blocks (a ModuleList of the layers' blocks, in order),
    final_norm, lm_head unless the embeddings are tied, and the MTP head
    (mtp_proj, mtp_block, mtp_norm) where cfg.mtp_depth > 0, and the vlm's
    mm_projector (w1 (1024, d), w2 (d, d)). Parameters live in the
    config's dtype (the MoE router in float32).
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
        if cfg.family == "vlm":
            self.mm_projector = Params({"w1": (PATCH_DIM, d), "w2": (d, d)},
                                       dtype, device)

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
    if kind == "rec_mlp":
        zeros = lambda: torch.zeros((d,), dtype=dtype,  # noqa: E731
                                    device=gen.device)
        return {"norm": {"scale": zeros()},
                "lru": RG.lru_init(gen, cfg, dtype),
                "mlp_norm": {"scale": zeros()},
                "mlp": gated_mlp_init(gen, d, cfg.d_ff, dtype)}
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


def _attn_train(cfg, p, x, positions, window: int = 0):
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.mla:
        return A.mla_attention_train(cfg, p.attn, h, positions)
    if cfg.attention_variant == "topo":
        return A.topo_attention_train(cfg, p.attn, p.topo, h, positions)
    if cfg.attention_variant == "performer":
        return A.performer_attention_train(cfg, p.attn, h, positions)
    return A.full_attention_train(cfg, p.attn, h, positions, window=window)


def _ffn(cfg, kind, p, x):
    """x + the block's FFN of its norm: the gated MLP, or the MoE (with its
    aux). Returns (x, aux or None)."""
    h = rms_norm(x, p.mlp_norm.scale, cfg.norm_eps, plus_one=True)
    if kind == "moe":
        y, aux = MOE.moe_block(cfg, p.moe, h)
        return x + y, aux
    return x + gated_mlp(p.mlp, h, cfg.mlp_act), None


def _mamba_in(cfg, p, x):
    """The norm ahead of a Mamba or RG-LRU mixer."""
    return rms_norm(x, p.norm.scale, cfg.norm_eps, plus_one=True)


def _window(cfg, kind) -> int:
    return cfg.local_window if kind == "attn_local_mlp" else 0


def _block_train(cfg, kind, p, x, positions):
    """Returns (x, aux): aux is the MoE router's loss, None for the other
    kinds. Under a mesh the block's output is the residual stream, batch
    over the data axes and replicated over the model axis (or its length
    over the model axis where cfg.seq_sharded_residuals)."""
    x, aux = _block_body(cfg, kind, p, x, positions)
    seq = ("seq_sp" if getattr(cfg, "seq_sharded_residuals", False)
           else "seq")
    return shard(x, ("batch", seq, "embed")), aux


def _block_body(cfg, kind, p, x, positions):
    if kind == "mamba":
        return (x + SSM.mamba_block_train(cfg, p.ssm, _mamba_in(cfg, p, x)),
                None)
    if kind == "rec_mlp":
        return _ffn(cfg, kind, p, x + RG.lru_block_train(
            cfg, p.lru, _mamba_in(cfg, p, x)))
    return _ffn(cfg, kind, p, x + _attn_train(cfg, p, x, positions,
                                              _window(cfg, kind)))


def _block_decode(cfg, kind, p, x, pos, cache, S):
    """x: (B, 1, d). Returns (x, new_cache)."""
    if kind == "mamba":
        y, cache = SSM.mamba_block_decode(cfg, p.ssm, _mamba_in(cfg, p, x),
                                          cache)
        return x + y, cache
    if kind == "rec_mlp":
        y, cache = RG.lru_block_decode(cfg, p.lru, _mamba_in(cfg, p, x),
                                       cache)
        return _ffn(cfg, kind, p, x + y)[0], cache
    h = rms_norm(x, p.attn_norm.scale, cfg.norm_eps, plus_one=True)
    if cfg.mla:
        y, cache = A.mla_attention_decode(cfg, p.attn, h, pos, cache)
    elif cfg.attention_variant == "topo":
        y, cache = A.topo_attention_decode(cfg, p.attn, p.topo, h, pos,
                                           cache, L=S)
    elif cfg.attention_variant == "performer":
        y, cache = A.performer_attention_decode(cfg, p.attn, h, pos, cache)
    elif kind == "attn_local_mlp":
        y, cache = A.local_attention_decode(cfg, p.attn, h, pos, cache)
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
    if kind == "rec_mlp":
        y, cache = RG.lru_block_prefill(cfg, p.lru, _mamba_in(cfg, p, x),
                                        lengths, cache)
        return _ffn(cfg, kind, p, x + y)[0], cache
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
    elif kind == "attn_local_mlp":
        y, cache = A.local_attention_prefill(cfg, p.attn, h, positions,
                                             lengths, cache)
    else:
        y, cache = A.full_attention_prefill(cfg, p.attn, h, positions,
                                            lengths, cache)
    return _ffn(cfg, kind, p, x + y)[0], cache


def _block_cache_init(cfg, kind, B, S, device=None):
    if kind == "mamba":
        return SSM.mamba_decode_init(cfg, B, dtype_of(cfg), device)
    if kind == "rec_mlp":
        return RG.lru_decode_init(cfg, B, dtype_of(cfg), device)
    if cfg.mla:
        return A.mla_decode_init(cfg, B, S, dtype_of(cfg), device)
    if cfg.attention_variant == "topo":
        return A.topo_decode_init(cfg, B, S, device=device)
    if cfg.attention_variant == "performer":
        return A.performer_decode_init(cfg, B, device=device)
    if kind == "attn_local_mlp":
        return A.local_attention_decode_init(cfg, B, dtype_of(cfg), device)
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
            for name in ("k", "v")}


@dataclasses.dataclass(frozen=True)
class StackDesc:
    """(kind, count, scanned) segments, executed in order."""
    segments: tuple


def stack_desc(cfg) -> StackDesc:
    check_supported(cfg)
    if cfg.family == "hybrid":
        return StackDesc((("hybrid_superblocks", cfg.num_superblocks,
                           cfg.scan_layers),
                          ("hybrid_tail", len(cfg.tail_blocks), False)))
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(("attn_mlp", cfg.first_dense_layers, False))
        segs.append(("moe", cfg.num_layers - cfg.first_dense_layers,
                     cfg.scan_layers))
        return StackDesc(tuple(segs))
    kind = "mamba" if cfg.family == "ssm" else "attn_mlp"
    return StackDesc(((kind, cfg.num_layers, cfg.scan_layers),))


def _hybrid_kind(kind: str) -> str:
    return "rec_mlp" if kind == "rec" else "attn_local_mlp"


def segments(cfg) -> list:
    """(key, kind, first layer, count) of each segment that has layers:
    the reference's "blocks{si}" keys of its params and decode cache, and
    where the segment's layers sit in `model.blocks`. Not for the hybrid
    family, whose segments interleave kinds: see `slots`."""
    out, first = [], 0
    for si, (kind, count, _) in enumerate(stack_desc(cfg).segments):
        if count:
            out.append((f"blocks{si}", kind, first, count))
            first += count
    return out


def slots(cfg) -> list:
    """(path, kind, layers, stacked) of each place of the reference's param
    and cache trees that holds blocks: `path` the keys down to it, `layers`
    the numbers in `model.blocks` of its blocks, stacked along a leading
    axis where `stacked`. Hybrid: superblock position bi under ("blocks0",
    "b{bi}_{kind}"), layers bi, bi + n, ... (n = len(cfg.superblock)),
    then each tail block under ("tail{bi}",), unstacked."""
    if cfg.family != "hybrid":
        return [((key,), kind, tuple(range(first, first + count)), True)
                for key, kind, first, count in segments(cfg)]
    n, nsb = len(cfg.superblock), cfg.num_superblocks
    out = []
    if nsb:
        out += [(("blocks0", f"b{bi}_{k}"), _hybrid_kind(k),
                 tuple(range(bi, n * nsb, n)), True)
                for bi, k in enumerate(cfg.superblock)]
    out += [((f"tail{bi}",), _hybrid_kind(k), (n * nsb + bi,), False)
            for bi, k in enumerate(cfg.tail_blocks)]
    return out


def layer_kinds(cfg) -> list:
    kinds = {layer: kind for _, kind, layers, _ in slots(cfg)
             for layer in layers}
    return [kinds[layer] for layer in range(len(kinds))]


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
    if cfg.family == "vlm":
        sd["mm_projector.w1"] = dense_init(gen, (PATCH_DIM, d), dtype=dtype)
        sd["mm_projector.w2"] = dense_init(gen, (d, d), dtype=dtype)
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
    x = embed_lookup(model.embed.table, tokens)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg, model, x):
    if cfg.tie_embeddings:
        logits = x @ model.embed.table.T
    else:
        logits = x @ model.lm_head.kernel
    return shard(logits, ("batch", "seq", "vocab"))


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
                              use_reentrant=False, **sharding.remat_kwargs())
        else:
            x, a = _block_train(cfg, kind, blk, x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def _positions(x):
    """Aranges (B, L) int32 over the sequence of x (B, L, d)."""
    B, L = x.shape[:2]
    return torch.arange(L, dtype=torch.int32, device=x.device)[None].expand(
        B, L)


def _inputs(cfg, model, batch):
    """The embedded sequence: the tokens' embeddings, and for the vlm the
    projected patches gelu(patches @ w1) @ w2 ahead of them. Returns (x,
    the number of prefix positions P)."""
    te = embed_tokens(cfg, model, batch["tokens"])
    if cfg.family != "vlm":
        return te, 0
    patches = batch.get("patch_embeds")
    if patches is None:
        raise ValueError("the vlm family takes batch['patch_embeds'] (B, P, "
                         f"{PATCH_DIM}) ahead of the tokens")
    mm = model.mm_projector
    pe = F.gelu(patches.to(te.dtype) @ mm.w1, approximate="tanh") @ mm.w2
    return torch.cat([pe, te], dim=1), patches.shape[1]


def forward_train(cfg, model, batch):
    """batch: {'tokens': (B, L)} (+ 'patch_embeds' (B, P, 1024) for the
    vlm). Returns (loss, {"aux": aux}): the mean next-token CE over the
    text and `padded_vocab()` with its z-loss, plus MTP_WEIGHT times the
    multi-token-prediction loss where cfg.mtp_depth > 0, plus the MoE
    blocks' summed auxiliary loss (0 without MoE blocks)."""
    tokens = batch["tokens"]
    x, P = _inputs(cfg, model, batch)
    x = shard(x, ("batch", "seq", "embed"))
    positions = _positions(x)
    x, aux = _run_stack(cfg, model, x, positions,
                        _remat(cfg) and torch.is_grad_enabled())
    h = _final(cfg, model, x)[:, P:]  # the text region
    loss = cross_entropy_loss(unembed(cfg, model, h)[:, :-1], tokens[:, 1:],
                              cfg.padded_vocab())
    if cfg.mtp_depth > 0:
        loss = loss + MTP_WEIGHT * _mtp_loss(cfg, model, h, tokens,
                                             positions[:, P:])
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
    """Prefill: logits for the last position (B, 1, V), no cache (the vlm
    with its patches ahead of the tokens)."""
    x, _ = _inputs(cfg, model, batch)
    x, _ = _run_stack(cfg, model, x, _positions(x))
    return unembed(cfg, model, _final(cfg, model, x)[:, -1:, :])


def _node(tree: dict, path: tuple) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def init_decode_cache(cfg, B: int, S: int, device=None) -> dict:
    cache = {}
    for path, kind, layers, stacked in slots(cfg):
        one = _block_cache_init(cfg, kind, B, S, device)
        _put(cache, path, {k: t.expand((len(layers),) + tuple(t.shape))
                           .clone() if stacked else t
                           for k, t in one.items()})
    return cache


def _over_layers(cfg, model, cache, step):
    """Runs step(kind, block, layer cache) -> new layer cache over every
    layer in order; returns the new cache in the reference's layout. Each
    layer's new cache is copied into its slot of the new stack as soon as
    it is made, so the call holds the old cache, the new one and one
    layer's temporaries (not every layer's new cache besides)."""
    where = {layer: (path, kind, j, stacked, len(layers))
             for path, kind, layers, stacked in slots(cfg)
             for j, layer in enumerate(layers)}
    new: dict = {}
    for layer in range(len(where)):
        path, kind, j, stacked, count = where[layer]
        c = _node(cache, path)
        out = step(kind, model.blocks[layer],
                   {k: sharding.unstack(t, j) for k, t in c.items()}
                   if stacked else c)
        if not stacked:
            _put(new, path, out)
            continue
        if j == 0:  # a DTensor stack takes the old slab's placements
            _put(new, path, {k: sharding.empty_stack(t, count)
                             for k, t in out.items()})
        for k, t in out.items():
            sharding.local(_node(new, path)[k])[j].copy_(sharding.local(t))
        del out
    return new


def forward_decode(cfg, model, cache, token, pos, S):
    """token: (B, 1) int; pos: () or (B,) int. Returns (logits (B, 1, V),
    new_cache). On a sharded model the cache is a tree of DTensors
    (`launch.specs.cache_shardings`); each layer reads and writes its
    slabs where they lie, and the new cache keeps their placements."""
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
    lengths[b] == 0 keep their cache. `tree_mask` (the topo variant's
    forest mask, `attention.topo_attention_prefill`) reaches every topo
    layer. Returns (logits (B, V) of each row's last real token,
    new_cache)."""
    B, Lp = tokens.shape
    x = shard(embed_tokens(cfg, model, tokens), ("batch", "seq", "embed"))
    positions = _positions(x)

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
