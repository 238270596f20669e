"""Encoder-decoder transformer of the port (the SeamlessM4T backbone, its
audio frontend a stub), the counterpart of the reference's
`models/encdec.py`.

Encoder: frontend_proj (1024 -> d) of the (B, S, 1024) frame embeddings,
then [norm -> bidirectional self-attention, norm -> gated MLP] x
encoder_layers and enc_final_norm. Decoder: [norm -> causal
self-attention, norm -> cross-attention over the encoder's memory, norm ->
gated MLP] x decoder_layers, final_norm, lm_head. The self-attention takes
the config's variant (full, performer, topo); cross-attention is softmax
(the two modalities share no tree metric). On attn_impl "cuda" the full
variant's three attentions each launch the flash attention kernel (B5):
non-causal over the frames, causal over the text, and non-causal from the
text's queries to the memory's keys ("cross": Lq != Lk).

Parameters follow the reference's pytree paths with the layer unstacked
(`blocks_enc/attn/wq[l]` -> `blocks_enc.{l}.attn.wq`). The decode cache is
the reference's: {"self": each decoder layer's self-attention cache,
stacked, "cross_k", "cross_v": (n, B, max_source_len, KV, hd)}. As in the
reference, decode attends to that cross memory and nothing writes it:
`init_decode_cache` zeroes it, so decode's cross-attention adds 0 (ROADMAP
lists this among the reference behaviours the port follows), and the
encoder has no padding mask: sources in one batch share one length.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import sharding
from repro_torch.launch.sharding import shard, split_heads
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.models.layers import (Params, cross_entropy_loss,
                                       dense_init, dtype_of, embed_init,
                                       embed_lookup, gated_mlp, rms_norm)

FRONTEND_DIM = 1024  # the stub audio frontend's frame embedding width


class DecBlock(lm.DecoderBlock):
    """One decoder block: an encoder block's attn_norm, attn, topo (topo
    variant only), mlp_norm, mlp, and cross_norm, cross_attn."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.cross_norm = Params({"scale": (cfg.d_model,)}, dtype, device)
        self.cross_attn = A.Attention(cfg, dtype, device)


class EncDecLM(nn.Module):
    """frontend_proj, embed, blocks_enc, blocks_dec, enc_final_norm,
    final_norm, lm_head, in the config's dtype."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype = dtype_of(cfg)
        V, d = cfg.padded_vocab(), cfg.d_model
        self.cfg = cfg
        self.frontend_proj = Params({"kernel": (FRONTEND_DIM, d)}, dtype,
                                    device)
        self.embed = Params({"table": (V, d)}, dtype, device)
        self.blocks_enc = nn.ModuleList([lm.DecoderBlock(cfg, dtype, device)
                                         for _ in range(cfg.encoder_layers)])
        self.blocks_dec = nn.ModuleList([DecBlock(cfg, dtype, device)
                                         for _ in range(cfg.decoder_layers)])
        self.enc_final_norm = Params({"scale": (d,)}, dtype, device)
        self.final_norm = Params({"scale": (d,)}, dtype, device)
        self.lm_head = Params({"kernel": (d, V)}, dtype, device)


def init_state_dict(cfg, gen: torch.Generator) -> dict:
    """Random weights by the reference's recipe, drawn from `gen` on its
    device, as a state dict of `EncDecLM`."""
    dtype = dtype_of(cfg)
    d, V = cfg.d_model, cfg.padded_vocab()
    zeros = lambda: torch.zeros((d,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    sd = {"frontend_proj.kernel": dense_init(gen, (FRONTEND_DIM, d),
                                             dtype=dtype),
          "embed.table": embed_init(gen, V, d, dtype)["table"]}
    for stack, n in (("blocks_enc", cfg.encoder_layers),
                     ("blocks_dec", cfg.decoder_layers)):
        for layer in range(n):
            parts = lm._block_init(gen, cfg, "attn_mlp", dtype)
            if stack == "blocks_dec":
                parts["cross_norm"] = {"scale": zeros()}
                parts["cross_attn"] = A.attn_init(gen, cfg, dtype)
            for part, leaves in parts.items():
                for name, t in leaves.items():
                    sd[f"{stack}.{layer}.{part}.{name}"] = t
    sd["enc_final_norm.scale"] = zeros()
    sd["final_norm.scale"] = zeros()
    sd["lm_head.kernel"] = dense_init(gen, (d, V), dtype=dtype)
    return sd


def from_state_dict(cfg, sd: dict) -> EncDecLM:
    model = EncDecLM(cfg, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def init_params(cfg, gen: torch.Generator) -> EncDecLM:
    return from_state_dict(cfg, init_state_dict(cfg, gen))


def _norm(cfg, x, p):
    return rms_norm(x, p.scale, cfg.norm_eps, plus_one=True)


def _self_attn(cfg, p, x, positions, causal: bool):
    h = _norm(cfg, x, p.attn_norm)
    if cfg.attention_variant == "topo":
        return A.topo_attention_train(cfg, p.attn, p.topo, h, positions,
                                      causal=causal)
    if cfg.attention_variant == "performer":
        return A.performer_attention_train(cfg, p.attn, h, positions,
                                           causal=causal)
    return A.full_attention_train(cfg, p.attn, h, positions, causal=causal)


def _mlp(cfg, p, x):
    return x + gated_mlp(p.mlp, _norm(cfg, x, p.mlp_norm), cfg.mlp_act)


def _layers(cfg, blocks, body, x):
    remat = lm._remat(cfg) and torch.is_grad_enabled()
    for blk in blocks:
        x = (checkpoint(body, blk, x, use_reentrant=False,
                        **sharding.remat_kwargs()) if remat
             else body(blk, x))
        x = shard(x, ("batch", "seq", "embed"))
    return x


def encode(cfg, model, src_embeds):
    """src_embeds: (B, S, 1024) stub frontend output -> memory (B, S, d)."""
    x = src_embeds.to(dtype_of(cfg)) @ model.frontend_proj.kernel
    x = shard(x, ("batch", "seq", "embed"))
    positions = lm._positions(x)

    def body(p, x):
        return _mlp(cfg, p, x + _self_attn(cfg, p, x, positions, False))

    return _norm(cfg, _layers(cfg, model.blocks_enc, body, x),
                 model.enc_final_norm)


def _decode_stack(cfg, model, x, memory):
    positions, mem_positions = lm._positions(x), lm._positions(memory)

    def body(p, x):
        x = x + _self_attn(cfg, p, x, positions, True)
        x = x + A.full_attention_train(
            cfg, p.cross_attn, _norm(cfg, x, p.cross_norm), positions,
            causal=False, rope=False, kv_x=memory,
            kv_positions=mem_positions)
        return _mlp(cfg, p, x)

    return _layers(cfg, model.blocks_dec, body, x)


def _decoder_out(cfg, model, batch):
    memory = encode(cfg, model, batch["src_embeds"])
    x = embed_lookup(model.embed.table, batch["tokens"])
    return _norm(cfg, _decode_stack(cfg, model, x, memory), model.final_norm)


def forward_train(cfg, model, batch):
    """batch: {'src_embeds': (B, S, 1024), 'tokens': (B, L)}. Returns
    (loss, {}): the next-token CE with its z-loss."""
    tokens = batch["tokens"]
    logits = _decoder_out(cfg, model, batch) @ model.lm_head.kernel
    logits = shard(logits, ("batch", "seq", "vocab"))
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:],
                              cfg.padded_vocab()), {}


def forward_prefill(cfg, model, batch):
    """Logits of the last position (B, 1, V), no cache."""
    return _decoder_out(cfg, model, batch)[:, -1:, :] @ model.lm_head.kernel


def init_decode_cache(cfg, B: int, S: int, device=None) -> dict:
    """Each decoder layer's self-attention cache, stacked, and the cross
    memory {"cross_k", "cross_v": (n, B, max_source_len, KV, hd)}, zeros."""
    dtype = dtype_of(cfg)
    KV, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.decoder_layers
    one = lm._block_cache_init(cfg, "attn_mlp", B, S, device)
    cross = (n, B, cfg.max_source_len, KV, hd)
    return {"self": {k: t.expand((n,) + tuple(t.shape)).clone()
                     for k, t in one.items()},
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


def forward_decode(cfg, model, cache, token, pos, S):
    """token: (B, 1); pos: () or (B,). Returns (logits (B, 1, V),
    new_cache): self-attention through each layer's cache, cross-attention
    (q without bias or rope, as the reference's) over the cache's cross
    memory. A DTensor cache is read and written on each rank's slabs
    (`sharding.cache_face`), keeping its placements."""
    x = embed_lookup(model.embed.table, token)
    B, H, hd = token.shape[0], cfg.num_heads, cfg.head_dim
    Sm = cache["cross_k"].shape[2]
    mem_mask = torch.ones((1, 1, 1, Sm), dtype=torch.bool, device=x.device)
    new_self = []
    for layer, p in enumerate(model.blocks_dec):
        c = {k: sharding.unstack(t, layer) for k, t in cache["self"].items()}
        h = _norm(cfg, x, p.attn_norm)
        if cfg.attention_variant == "topo":
            y, c = A.topo_attention_decode(cfg, p.attn, p.topo, h, pos, c,
                                           L=S)
        elif cfg.attention_variant == "performer":
            y, c = A.performer_attention_decode(cfg, p.attn, h, pos, c)
        else:
            y, c = A.full_attention_decode(cfg, p.attn, h, pos, c)
        new_self.append(c)
        x = x + y
        h = _norm(cfg, x, p.cross_norm)
        q = split_heads(h @ p.cross_attn.wq, (B, 1, H, hd))
        mem = {"k": sharding.unstack(cache["cross_k"], layer),
               "v": sharding.unstack(cache["cross_v"], layer)}
        (y,), _ = sharding.cache_face(
            lambda seq, c, q: ((A._sdpa_seq(cfg, q, c["k"], c["v"],
                                            mem_mask, seq),), c),
            mem, {"k": A._KV, "v": A._KV}, (q,), (A._BH,), (A._BH,))
        x = _mlp(cfg, p, x + y.reshape(B, 1, -1) @ p.cross_attn.wo)
    logits = _norm(cfg, x, model.final_norm) @ model.lm_head.kernel
    new = dict(cache)
    new["self"] = {k: sharding.stack([c[k] for c in new_self])
                   for k in new_self[0]}
    return logits, new
