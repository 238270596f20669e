"""Weights carried across from the reference: its param pytree (nested
dicts of numpy arrays, layer-stacked leaves with a leading axis over each
segment's layers) to a `DecoderLM` or a `TopoViT` and back.

The port's parameter names are the reference's pytree paths with the layer
axis unstacked and the segments' layers numbered in order
(`blocks0/attn/wq[l]` -> `blocks.{l}.attn.wq`; in the moe family
`blocks1/moe/router[j]` -> `blocks.{first_dense_layers + j}.moe.router`),
the MTP head's leaves by their paths (`mtp_block/attn/wo` ->
`mtp_block.attn.wo`), and its weights keep the reference's (in, out)
layout, so converting is a renaming and a copy: bitwise in both
directions. bfloat16 arrays travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm, vit

# {the reference's key of a stack of layers: the port's number of its first
# layer}: the dense and ssm LMs' one stack and the ViT's
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
    """{the reference's key of a stacked segment: its first layer}."""
    return {key: first for key, _, first, _ in lm.segments(cfg)}


def _state_dict(tree: dict, dev, stacks: dict) -> dict:
    sd = {}
    for name, leaf in _flatten(tree):
        key, _, rest = name.partition(".")
        if key in stacks:
            for j in range(np.shape(leaf)[0]):
                sd[f"blocks.{stacks[key] + j}.{rest}"] = _to_torch(leaf[j],
                                                                  dev)
        else:
            sd[name] = _to_torch(leaf, dev)
    return sd


def _tree(model, stacks: dict) -> dict:
    """The counterpart of `_state_dict`: each "blocks.{layer}" leaf stacked
    into the segment that holds the layer."""
    firsts = sorted(stacks.items(), key=lambda kv: kv[1])
    tree: dict = {}
    blocks: dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layer = int(parts[1])
            key, first = [kv for kv in firsts if kv[1] <= layer][-1]
            blocks.setdefault((key,) + tuple(parts[2:]), []).append(
                (layer - first, _to_numpy(t)))
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_numpy(t)
    for path, layers in blocks.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([a for _, a in sorted(layers,
                                                        key=lambda x: x[0])])
    return tree


def from_reference(cfg, tree: dict, device=None) -> lm.DecoderLM:
    """The reference's `lm.init_params(cfg, key)` tree (as numpy) -> a
    DecoderLM on `device`, loaded with load_state_dict(strict=True)."""
    return lm.from_state_dict(cfg, _state_dict(tree, resolve_device(device),
                                               _stacks(cfg)))


def to_reference(model: lm.DecoderLM) -> dict:
    """The counterpart of `from_reference`: the numpy param tree, with each
    segment's block leaves stacked along a leading axis under its
    "blocks{si}" key."""
    return _tree(model, _stacks(model.cfg))


def vit_from_reference(cfg, tree: dict, device=None) -> vit.TopoViT:
    """The reference's `vit.init_params(cfg, key, ...)` tree (as numpy,
    blocks stacked under "blocks") -> a TopoViT on `device` (strict)."""
    return vit.from_state_dict(cfg, _state_dict(
        tree, resolve_device(device), VIT_STACKED))


def vit_to_reference(model: vit.TopoViT) -> dict:
    """The counterpart of `vit_from_reference`."""
    return _tree(model, VIT_STACKED)
