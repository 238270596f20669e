"""Logical-axis sharding rules over a `torch.distributed` device mesh: the
plan half of the reference's `launch/sharding.py`.

`DEFAULT_RULES` maps logical axis names to mesh axis names (the
reference's table, whole). `use_sharding(mesh)` makes a mesh and its rules
current for the block (a contextvar, so threads and tasks each see their
own), dropping the axes the mesh lacks ("pod" on a single-pod mesh).
`plan_axis` names the mesh axis that carries the FTFI plan's leaf blocks
(`core.plan_shard`), `batch_axes` the axes of the logical batch.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` (see
`launch.mesh`); the helpers below read its extent, process group and
coordinate along one named axis. With no rules active (one process) every
query answers as the reference's does with no mesh.

The parameter half (logical_to_spec, shard, param_spec_for_path,
tree_param_specs, shard_q_heads, named_sharding) is ROADMAP A12b.
"""
from __future__ import annotations

import contextlib
import contextvars

# logical axis name -> mesh axis (or tuple of mesh axes, or None)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",  # long-context decode: sequence over data axis
    "embed": None,  # activation d_model stays unsharded (megatron style)
    "seq_sp": "model",  # sequence-parallel residual stream (opt-in per cfg)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_capacity": None,
    "inner": "model",  # ssm / lru inner channels
    "state": None,
    "kv_lora": None,
    "frames": None,
    # FTFI plan axes (core.plan_shard): the plan's vertex index space is
    # cut into per-device leaf blocks over `data`; cross-bucket source /
    # target group spaces follow their jobs onto the same axis; whole trees
    # of a packed Forest land per shard ("tree"); batched field columns ride
    # the batch axes
    "plan_leaves": "data",
    "cross_src": "data",
    "cross_tgt": "data",
    "tree": "data",
    "field_batch": ("pod", "data"),
}

_rules_var: contextvars.ContextVar = contextvars.ContextVar("rules",
                                                            default=None)
_mesh_var: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                           default=None)


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names, in order."""
    return tuple(mesh.mesh_dim_names or ())


def mesh_size(mesh) -> int:
    """Ranks in the whole mesh."""
    return int(mesh.size())


def axis_size(mesh, axis: str) -> int:
    """Extent of the mesh along `axis` (1 for an axis it lacks)."""
    axes = mesh_axes(mesh)
    return int(mesh.size(axes.index(axis))) if axis in axes else 1


def axis_group(mesh, axis: str):
    """The process group of this rank's line of the mesh along `axis`."""
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(axis))


@contextlib.contextmanager
def use_sharding(mesh, rules: dict | None = None,
                 overrides: dict | None = None):
    r = dict(DEFAULT_RULES if rules is None else rules)
    if overrides:
        r.update(overrides)
    # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
    axis_names = set(mesh_axes(mesh))

    def _filter(ax):
        if ax is None:
            return None
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a in axis_names)
            return ax if ax else None
        return ax if ax in axis_names else None

    r = {k: _filter(v) for k, v in r.items()}
    t1 = _rules_var.set(r)
    t2 = _mesh_var.set(mesh)
    try:
        yield
    finally:
        _rules_var.reset(t1)
        _mesh_var.reset(t2)


def batch_axes():
    """Mesh axes bound to the logical 'batch' axis (tuple), or None."""
    rules = _rules_var.get()
    if rules is None:
        return None
    ax = rules.get("batch")
    if ax is None:
        return None
    return ax if isinstance(ax, tuple) else (ax,)


def current_mesh():
    return _mesh_var.get()


def plan_axis(mesh=None) -> str | None:
    """Mesh axis carrying the FTFI `plan_leaves` logical axis (leaf-block
    sharding of the plan executor). Falls back to "data" (or the mesh's
    first axis) when the active rules don't bind it."""
    rules = _rules_var.get()
    ax = (rules or DEFAULT_RULES).get("plan_leaves", "data")
    if isinstance(ax, tuple):
        ax = ax[0] if ax else None
    mesh = mesh if mesh is not None else _mesh_var.get()
    if mesh is not None and ax not in mesh_axes(mesh):
        names = mesh_axes(mesh)
        ax = "data" if "data" in names else names[0]
    return ax
