"""Weights carried across from the reference: its param pytree (nested
dicts of numpy arrays, layer-stacked leaves with a leading axis over each
segment's layers) to a `DecoderLM`, an `EncDecLM` or a `TopoViT` and back.

The port's parameter names are the reference's pytree paths with the layer
axis unstacked and the segments' layers numbered in order
(`blocks0/attn/wq[l]` -> `blocks.{l}.attn.wq`; in the moe family
`blocks1/moe/router[j]` -> `blocks.{first_dense_layers + j}.moe.router`;
in the hybrid family `blocks0/b{bi}_{kind}/...[j]` -> `blocks.{n j +
bi}...` with n = len(superblock), and the unstacked `tail{bi}/...` ->
`blocks.{n num_superblocks + bi}...`; in the encdec family
`blocks_enc/...[l]` -> `blocks_enc.{l}...` and `blocks_dec` likewise),
the other leaves by their paths (`mtp_block/attn/wo` ->
`mtp_block.attn.wo`, `mm_projector/w1`, `frontend_proj/kernel`), and its
weights keep the reference's (in, out) layout, so converting is a
renaming and a copy: bitwise in both directions. bfloat16 arrays travel as
their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm, vit

# {the reference's key of a stack of layers: the port's number of its first
# layer in `blocks`}: the dense and ssm LMs' one stack and the ViT's. A
# rule may also be (the port's ModuleList, its layers, stacked): the
# hybrid and encdec families' (`_stacks`)
STACKED = {"blocks0": 0}
VIT_STACKED = {"blocks": 0}


def _to_torch(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bfloat16 numpy type

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _stacks(cfg) -> dict:
    """{the dotted path of a place in the reference's tree that holds
    blocks: its rule}: the first layer (an int) where the place is one
    stacked segment of `blocks`, else (the port's ModuleList, its layers,
    stacked)."""
    if cfg.is_encdec:
        return {name: (name, tuple(range(n)), True)
                for name, n in (("blocks_enc", cfg.encoder_layers),
                                ("blocks_dec", cfg.decoder_layers))}
    if cfg.family == "hybrid":
        return {".".join(path): ("blocks", layers, stacked)
                for path, _, layers, stacked in lm.slots(cfg)}
    return {key: first for key, _, first, _ in lm.segments(cfg)}


def _rule(stacks: dict, name: str):
    """(the place, its rule) whose path prefixes the dotted `name`, the
    longest one; None where no place does."""
    hits = [k for k in stacks if name.startswith(k + ".")]
    return max(hits, key=len) if hits else None


def _state_dict(tree: dict, dev, stacks: dict) -> dict:
    sd = {}
    for name, leaf in _flatten(tree):
        place = _rule(stacks, name)
        if place is None:
            sd[name] = _to_torch(leaf, dev)
            continue
        rest, rule = name[len(place) + 1:], stacks[place]
        if isinstance(rule, int):
            rule = ("blocks", range(rule, rule + np.shape(leaf)[0]), True)
        port, layers, stacked = rule
        if not stacked:
            sd[f"{port}.{layers[0]}.{rest}"] = _to_torch(leaf, dev)
            continue
        for j, layer in enumerate(layers):
            sd[f"{port}.{layer}.{rest}"] = _to_torch(leaf[j], dev)
    return sd


def _owner(stacks: dict, port: str, layer: int):
    """(place, index along its stack, stacked) of the port's block `port`
    [layer]; None for a leaf outside every place."""
    for place, rule in stacks.items():
        if not isinstance(rule, int) and rule[0] == port and layer in rule[1]:
            return place, rule[1].index(layer), rule[2]
    firsts = sorted((r, k) for k, r in stacks.items() if isinstance(r, int))
    if port == "blocks" and firsts:
        first, place = [fk for fk in firsts if fk[0] <= layer][-1]
        return place, layer - first, True
    return None


def _tree(model, stacks: dict) -> dict:
    """The counterpart of `_state_dict`: each block's leaf back at its
    place, stacked in order where the place is stacked."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        owner = (_owner(stacks, parts[0], int(parts[1]))
                 if len(parts) > 2 and parts[1].isdigit() else None)
        if owner is None:
            path = parts
        else:
            place, j, is_stacked = owner
            path = place.split(".") + parts[2:]
            if is_stacked:
                stacked.setdefault(tuple(path), []).append((j, _to_numpy(t)))
                continue
        lm._put(tree, tuple(path), _to_numpy(t))
    for path, layers in stacked.items():
        lm._put(tree, path, np.stack([a for _, a in sorted(
            layers, key=lambda x: x[0])]))
    return tree


def from_reference(cfg, tree: dict, device=None):
    """The reference's `api.init_params(cfg, key)` tree (as numpy) -> a
    DecoderLM (an EncDecLM where cfg.is_encdec) on `device`, loaded with
    load_state_dict(strict=True)."""
    fam = encdec if cfg.is_encdec else lm
    return fam.from_state_dict(cfg, _state_dict(
        tree, resolve_device(device), _stacks(cfg)))


def to_reference(model) -> dict:
    """The counterpart of `from_reference`: the numpy param tree in the
    reference's layout (each stacked place's leaves along a leading
    axis)."""
    return _tree(model, _stacks(model.cfg))


def vit_from_reference(cfg, tree: dict, device=None) -> vit.TopoViT:
    """The reference's `vit.init_params(cfg, key, ...)` tree (as numpy,
    blocks stacked under "blocks") -> a TopoViT on `device` (strict)."""
    return vit.from_state_dict(cfg, _state_dict(
        tree, resolve_device(device), VIT_STACKED))


def vit_to_reference(model: vit.TopoViT) -> dict:
    """The counterpart of `vit_from_reference`."""
    return _tree(model, VIT_STACKED)
