"""Public model API of the port: init / loss / prefill / decode entry
points.

Each takes the model (`lm.DecoderLM`) in place of the reference's param
pytree, and `device=None`, which means the CUDA card (raising without
one); the tests pass `device="cpu"`. Token inputs may be numpy arrays or
tensors and are moved to the device; the model must already live there.
`loss_fn` runs with grad enabled; serving runs under `torch.no_grad()`.
Encoder-decoder families come with ROADMAP A10b.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm


def _on(model, device):
    dev = resolve_device(device)
    here = next(model.parameters()).device
    if here.type != dev.type or (dev.index is not None
                                 and here.index != dev.index):
        raise ValueError(f"the model lives on {here}, the call asks for {dev}")
    return dev


def _ints(x, dev):
    return torch.as_tensor(x, device=dev).long()


def init_params(cfg, seed=0, device=None) -> lm.DecoderLM:
    """Random weights from `seed` (an int, or a torch.Generator on the
    device) by the reference's init recipe."""
    lm.check_supported(cfg)
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    return lm.init_params(cfg, gen)


def loss_fn(cfg, model, batch, device=None):
    """(loss, {"aux": aux}) of `batch` {'tokens': (B, L)}, with grad
    enabled: call `loss.backward()` for the parameters' grads."""
    lm.check_supported(cfg)
    dev = _on(model, device)
    with torch.enable_grad():
        return lm.forward_train(cfg, model, {"tokens": _ints(batch["tokens"],
                                                             dev)})


@torch.no_grad()
def prefill_fn(cfg, model, batch, device=None):
    """Last-position logits (B, 1, V), no cache."""
    lm.check_supported(cfg)
    dev = _on(model, device)
    return lm.forward_prefill(cfg, model, {"tokens": _ints(batch["tokens"],
                                                           dev)})


@torch.no_grad()
def prefill_into_cache(cfg, model, cache, tokens, lengths, S,
                       tree_mask=None, device=None):
    """Fused prefill: whole (right-padded) prompts through one forward pass
    that also writes the decode cache. Returns (last-real-token logits
    (B, V), new_cache). Rows with lengths[b] == 0 keep their cache."""
    lm.check_supported(cfg)
    dev = _on(model, device)
    return lm.forward_prefill_into_cache(cfg, model, cache, _ints(tokens, dev),
                                         _ints(lengths, dev), S,
                                         tree_mask=tree_mask)


def init_cache(cfg, B, S, device=None) -> dict:
    lm.check_supported(cfg)
    return lm.init_decode_cache(cfg, B, S, resolve_device(device))


@torch.no_grad()
def decode_fn(cfg, model, cache, token, pos, S, device=None):
    """One decode step: (logits (B, 1, V), new_cache). pos: () or (B,)."""
    lm.check_supported(cfg)
    dev = _on(model, device)
    return lm.forward_decode(cfg, model, cache, _ints(token, dev),
                             _ints(pos, dev), S)


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
