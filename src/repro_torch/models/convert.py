"""Weights carried across from the reference: its param pytree (nested
dicts of numpy arrays, layer-stacked leaves with a leading num_layers
axis) to a `DecoderLM` and back.

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
from repro_torch.models import lm

STACKED = "blocks0"


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


def from_reference(cfg, tree: dict, device=None) -> lm.DecoderLM:
    """The reference's `lm.init_params(cfg, key)` tree (as numpy) -> a
    DecoderLM on `device`, loaded with load_state_dict(strict=True)."""
    dev = resolve_device(device)
    sd = {}
    for name, leaf in _flatten(tree):
        if name.startswith(STACKED + "."):
            rest = name[len(STACKED) + 1:]
            for layer in range(np.shape(leaf)[0]):
                sd[f"blocks.{layer}.{rest}"] = _to_torch(leaf[layer], dev)
        else:
            sd[name] = _to_torch(leaf, dev)
    return lm.from_state_dict(cfg, sd)


def to_reference(model: lm.DecoderLM) -> dict:
    """The counterpart of `from_reference`: the numpy param tree, with the
    block leaves stacked along a leading num_layers axis."""
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
        node = tree.setdefault(STACKED, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([a for _, a in sorted(layers,
                                                        key=lambda x: x[0])])
    return tree
