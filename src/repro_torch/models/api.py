"""Public model API of the port: init / loss / prefill / decode entry
points.

Each takes the model (`lm.DecoderLM`, or `encdec.EncDecLM` where
cfg.is_encdec) in place of the reference's param pytree, and
`device=None`, which means the CUDA card (raising without one); the tests
pass `device="cpu"`. Inputs may be numpy arrays or tensors and are moved
to the device: tokens, and the stub frontends' embeddings (the vlm's
batch["patch_embeds"] (B, P, 1024), the encdec's batch["src_embeds"] (B,
S, 1024), cast to the model's dtype inside); the model must already live
there. `loss_fn` runs with grad enabled; serving runs under
`torch.no_grad()`.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import encdec, lm

EMBEDS = ("patch_embeds", "src_embeds")  # the frontends' float inputs


def _on(model, device):
    dev = resolve_device(device)
    here = next(model.parameters()).device
    if here.type != dev.type or (dev.index is not None
                                 and here.index != dev.index):
        raise ValueError(f"the model lives on {here}, the call asks for {dev}")
    return dev


def _ints(x, dev):
    return torch.as_tensor(x, device=dev).long()


def _batch(cfg, batch, dev, model=None) -> dict:
    """The batch on `dev`: tokens as int64, the frontends' embeddings as
    they come (float). For a sharded model (DTensor parameters) each entry
    becomes a DTensor with its batch dim over the batch axes."""
    out = {"tokens": _ints(batch["tokens"], dev)}
    for name in EMBEDS:
        if batch.get(name) is not None:
            out[name] = torch.as_tensor(batch[name], device=dev)
    mesh = sharding.model_mesh(model) if model is not None else None
    if mesh is not None:
        out = {k: sharding.distribute_batch(t, mesh) for k, t in out.items()}
    if cfg.is_encdec and "src_embeds" not in out:
        raise ValueError("the encoder-decoder family takes "
                         "batch['src_embeds'] (B, S, 1024) beside the tokens")
    return out


def sharded_scope(model):
    """`sharding.dtensor_scope` for a sharded model, else nothing."""
    return (sharding.dtensor_scope() if sharding.sharded(model)
            else contextlib.nullcontext())


def _family(cfg):
    """The module that runs the config's family: encdec or lm."""
    lm.check_supported(cfg)
    return encdec if cfg.is_encdec else lm


def init_params(cfg, seed=0, device=None):
    """Random weights from `seed` (an int, or a torch.Generator on the
    device) by the reference's init recipe."""
    fam = _family(cfg)
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    return fam.init_params(cfg, gen)


def loss_fn(cfg, model, batch, device=None):
    """(loss, metrics) of `batch` {'tokens': (B, L)} (+ the family's
    embeddings), with grad enabled: call `loss.backward()` for the
    parameters' grads (on a sharded model inside
    `launch.sharding.dtensor_scope()`, as `launch.steps` does). metrics:
    {"aux": the MoE loss} for the decoder-only families, {} for encdec
    (the reference's)."""
    fam = _family(cfg)
    dev = _on(model, device)
    with torch.enable_grad(), sharded_scope(model):
        return fam.forward_train(cfg, model, _batch(cfg, batch, dev, model))


@torch.no_grad()
def prefill_fn(cfg, model, batch, device=None):
    """Last-position logits (B, 1, V), no cache."""
    fam = _family(cfg)
    dev = _on(model, device)
    with sharded_scope(model):
        return fam.forward_prefill(cfg, model, _batch(cfg, batch, dev, model))


@torch.no_grad()
def prefill_into_cache(cfg, model, cache, tokens, lengths, S,
                       tree_mask=None, device=None):
    """Fused prefill: whole (right-padded) prompts through one forward pass
    that also writes the decode cache. Returns (last-real-token logits
    (B, V), new_cache). Rows with lengths[b] == 0 keep their cache. The
    vlm's takes the text only; the encoder-decoder family has none (it
    serves by decode replay), as in the reference."""
    if _family(cfg) is encdec:
        raise NotImplementedError(
            "fused prefill-into-cache is decoder-only; encdec serves via "
            "decode replay")
    dev = _on(model, device)
    return lm.forward_prefill_into_cache(cfg, model, cache, _ints(tokens, dev),
                                         _ints(lengths, dev), S,
                                         tree_mask=tree_mask)


def init_cache(cfg, B, S, device=None) -> dict:
    return _family(cfg).init_decode_cache(cfg, B, S, resolve_device(device))


@torch.no_grad()
def decode_fn(cfg, model, cache, token, pos, S, device=None):
    """One decode step: (logits (B, 1, V), new_cache). pos: () or (B,).
    A sharded model (`sharding.distribute_params`) decodes a DTensor
    cache (`launch.specs.cache_shardings`) in `sharding.dtensor_scope`:
    each layer reads and writes its cache's slabs where they lie, the new
    cache keeps their placements, and a plain token is put on the batch
    axes."""
    fam = _family(cfg)
    dev = _on(model, device)
    token, pos = _ints(token, dev), _ints(pos, dev)
    mesh = sharding.model_mesh(model)
    if mesh is None:
        return fam.forward_decode(cfg, model, cache, token, pos, S)
    if not all(map(sharding.is_dtensor,
                   torch.utils._pytree.tree_leaves(cache))):
        raise ValueError("a sharded model decodes a DTensor cache: place "
                         "it by launch.specs.decode_shardings")
    with sharding.dtensor_scope():
        return fam.forward_decode(cfg, model, cache,
                                  sharding.distribute_batch(token, mesh),
                                  pos, S)


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
