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

Sharded state (DTensors, `launch.sharding.distribute_params`) is saved in
the logical, unsharded layout: every rank gathers each DTensor whole
(`full_tensor()`, a collective) and rank 0 writes the files, the same npz
keys and `meta.json` as a single device's. A restore into DTensors on any
mesh (the reference's elastic re-mesh) keeps each rank's slab of the saved
array, by the like tensor's placements, with no collective: bitwise, as
the reference's `device_put` with new shardings is.
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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _writer() -> bool:
    """Whether this process writes the files: rank 0 of the group, or the
    only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if _is_dtensor(t):
        t = t.full_tensor()
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
        any tree of tensors (e.g. `optim.adamw.AdamWState`). DTensors are
        saved whole: every rank of their group must call this (each
        gathers), rank 0 writes, and the others wait for it."""
        blobs = {"params": _state(params)}
        if opt_state is not None:
            blobs["opt"] = opt_state
        flats = {name: _flatten(tree) for name, tree in blobs.items()}
        final = self._step_dir(step)
        if not _writer():  # each gather takes every rank
            for flat in flats.values():
                for v in flat.values():
                    if _is_dtensor(v):
                        v.full_tensor()
            _barrier(flats)
            return final
        arrays = {name: {k: _to_numpy(v) for k, v in flat.items()}
                  for name, flat in flats.items()}
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        dtypes = {}
        for name, flat in flats.items():
            dtypes[name] = {k: str(v.dtype).removeprefix("torch.")
                            for k, v in flat.items()}
            np.savez(os.path.join(tmp, f"{name}.npz"), **arrays[name])
        meta = {"step": step, "time": time.time(), "extra": extra or {},
                "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        _barrier(flats)
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
        the saved one is cast, as the reference's restore casts. A DTensor
        like takes its slab of the saved array, on whatever mesh it lives
        (no collective). Returns
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
                        _put(ref, got.to(ref.dtype))
            return like

        out = {"step": step, "params": load("params", _state(like_params))}
        if like_opt is not None and os.path.exists(os.path.join(d,
                                                                "opt.npz")):
            out["opt"] = load("opt", like_opt)
        out["meta"] = meta
        return out


def _put(ref, got: torch.Tensor) -> None:
    """Copy the whole array `got` into `ref`, or into this rank's slab of a
    DTensor `ref`."""
    if not _is_dtensor(ref):
        ref.copy_(got)
        return
    from repro_torch.launch.sharding import slab

    ref.to_local().copy_(slab(got, ref.device_mesh, ref.placements))


def _barrier(flats: dict) -> None:
    """Wait for the writer where the state is sharded (its ranks saved
    together)."""
    mesh = next((t.device_mesh for flat in flats.values()
                 for t in flat.values() if _is_dtensor(t)), None)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
