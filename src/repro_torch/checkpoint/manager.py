"""Fault-tolerant checkpointing: atomic (tmp + rename), keep-k, auto-resume.
The reference's `checkpoint/manager.py` layout, for tensors:

    <dir>/step_0000000020/params.npz   the model, keyed by state_dict names
                         /opt.npz      the optimizer state, "step", "mu.<name>"
                                       and "nu.<name>" (a NamedTuple's fields
                                       as the reference flattens them)
                         /meta.json    step, time, extra, and "dtypes"

numpy has no bfloat16 (and the card's machine has no `ml_dtypes`), so a
bfloat16 tensor is stored as its 16-bit pattern (int16) and `meta.json`
records its dtype under "dtypes": a restore is bitwise. Every other dtype
is stored as itself. A restore copies into the tensors of `like_*` (their
device and dtype), so it takes a live model and optimizer state.
Resharding on restore (the reference's elastic path) comes with ROADMAP
A12b, the parameter sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{dotted name: tensor} of nested dicts / NamedTuples / lists, keys
    as the reference's `_flatten` makes them."""
    if isinstance(tree, dict):
        it = sorted(tree.items())
    elif hasattr(tree, "_fields"):  # NamedTuple
        it = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        it = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("."): tree}
    out = {}
    for k, v in it:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _to_torch(a: np.ndarray, dtype: str | None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def _state(params) -> dict:
    return params.state_dict() if isinstance(params, torch.nn.Module) \
        else params


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, params, opt_state=None,
             extra: dict | None = None) -> str:
        """params: a module (its state_dict) or {name: tensor}; opt_state:
        any tree of tensors (e.g. `optim.adamw.AdamWState`)."""
        tmp = self._step_dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        blobs = {"params": _state(params)}
        if opt_state is not None:
            blobs["opt"] = opt_state
        dtypes = {}
        for name, tree in blobs.items():
            flat = _flatten(tree)
            dtypes[name] = {k: str(v.dtype).removeprefix("torch.")
                            for k, v in flat.items()}
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **{k: _to_numpy(v) for k, v in flat.items()})
        meta = {"step": step, "time": time.time(), "extra": extra or {},
                "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_params, like_opt=None, step: int | None = None):
        """Restore the latest (or the given) step into the tensors of
        `like_params` (a module or {name: tensor}) and `like_opt`, in place,
        each in its own device and dtype; a tensor of another dtype than
        the saved one is cast, as the reference's restore casts. Returns
        None without a checkpoint, else {"step", "params", "opt" (when
        saved and asked for), "meta"}: the trees now holding the values."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)

        def load(name, like):
            dtypes = meta.get("dtypes", {}).get(name, {})
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                for k, ref in _flatten(like).items():
                    got = _to_torch(z[k], dtypes.get(k))
                    if tuple(got.shape) != tuple(ref.shape):
                        raise ValueError(f"{name}.npz[{k}] is "
                                         f"{tuple(got.shape)}, the live "
                                         f"tensor {tuple(ref.shape)}")
                    with torch.no_grad():
                        ref.copy_(got.to(ref.dtype))
            return like

        out = {"step": step, "params": load("params", _state(like_params))}
        if like_opt is not None and os.path.exists(os.path.join(d,
                                                                "opt.npz")):
            out["opt"] = load("opt", like_opt)
        out["meta"] = meta
        return out
