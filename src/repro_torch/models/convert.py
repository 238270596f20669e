"""Weights carried across from the reference: its param pytree (nested
dicts of numpy arrays, layer-stacked leaves with a leading num_layers
axis) to a `DecoderLM` or a `TopoViT` and back.

The port's parameter names are the reference's pytree paths with the layer
axis unstacked (`blocks0/attn/wq[l]` -> `blocks.{l}.attn.wq`) and its
weights keep the reference's (in, out) layout, so converting is a renaming
and a copy: bitwise in both directions. bfloat16 arrays travel as their
16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm, vit

STACKED = "blocks0"  # the LM's stacked blocks
VIT_STACKED = "blocks"


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


def _state_dict(tree: dict, dev, stacked: str) -> dict:
    sd = {}
    for name, leaf in _flatten(tree):
        if name.startswith(stacked + "."):
            rest = name[len(stacked) + 1:]
            for layer in range(np.shape(leaf)[0]):
                sd[f"blocks.{layer}.{rest}"] = _to_torch(leaf[layer], dev)
        else:
            sd[name] = _to_torch(leaf, dev)
    return sd


def _tree(model, stacked: str) -> dict:
    tree: dict = {}
    blocks: dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault(tuple(parts[2:]), []).append(
                (int(parts[1]), _to_numpy(t)))
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_numpy(t)
    for path, layers in blocks.items():
        node = tree.setdefault(stacked, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([a for _, a in sorted(layers,
                                                        key=lambda x: x[0])])
    return tree


def from_reference(cfg, tree: dict, device=None) -> lm.DecoderLM:
    """The reference's `lm.init_params(cfg, key)` tree (as numpy) -> a
    DecoderLM on `device`, loaded with load_state_dict(strict=True)."""
    return lm.from_state_dict(cfg, _state_dict(tree, resolve_device(device),
                                               STACKED))


def to_reference(model: lm.DecoderLM) -> dict:
    """The counterpart of `from_reference`: the numpy param tree, with the
    block leaves stacked along a leading num_layers axis."""
    return _tree(model, STACKED)


def vit_from_reference(cfg, tree: dict, device=None) -> vit.TopoViT:
    """The reference's `vit.init_params(cfg, key, ...)` tree (as numpy,
    blocks stacked under "blocks") -> a TopoViT on `device` (strict)."""
    return vit.from_state_dict(cfg, _state_dict(
        tree, resolve_device(device), VIT_STACKED))


def vit_to_reference(model: vit.TopoViT) -> dict:
    """The counterpart of `vit_from_reference`."""
    return _tree(model, VIT_STACKED)
