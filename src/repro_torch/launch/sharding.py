"""Logical-axis sharding rules over a `torch.distributed` device mesh: the
reference's `launch/sharding.py`, its plan half and its parameter half.

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

The parameter half turns logical names into DTensor placements:
`logical_to_spec` gives each tensor dim its mesh axis or axes (each mesh
axis taken once a spec), `placements` turns a spec into one `Shard(i)` or
`Replicate()` per mesh dim, and `shard(x, logical)` redistributes a
DTensor activation to its spec (a no-op on a plain tensor or with no
rules), dropping every axis that does not divide its dim. `PARAM_RULES`
give each parameter of the port (`models/convert.py`'s names: the layer
axis unstacked, `blocks.{l}.attn.wq`) the spec the reference gives its
counterpart; `tree_param_specs` falls back to replication where an axis
does not divide, and `distribute_params(model, mesh)` turns every
parameter into a DTensor parameter by them. `shard_q_heads` shards a query
over heads, or over its length where the heads do not divide the model
axis. `local_face` runs a function on each rank's slab of DTensor inputs
(the vocab-sharded cross-entropy, the MoE's expert-parallel dispatch) and
wraps its outputs back; `slab_face` is its (batch, heads) form, which the
models put around each kernel call (B2, B4, B5, B6, the convs, the ViT's
Alg. 1), so the kernel wrappers see plain tensors only.
"""
from __future__ import annotations

import contextlib
import contextvars
import re

import torch

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


# ----------------------------------------------------------------------------
# the parameter half: specs, placements, DTensors
# ----------------------------------------------------------------------------


def _key(ax) -> tuple:
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def logical_to_spec(logical: tuple) -> tuple:
    """The spec of a tensor whose dims have the logical names `logical`:
    per dim its mesh axis (a name, a tuple of names, or None). A mesh axis
    is taken at most once a spec: a later dim that asks for a used axis
    stays unsharded. () with no rules active."""
    rules = _rules_var.get()
    if rules is None:
        return ()
    axes, used = [], set()
    for name in logical:
        ax = rules.get(name) if name is not None else None
        if ax is not None:
            if any(a in used for a in _key(ax)):
                ax = None
            else:
                used.update(_key(ax))
        axes.append(ax)
    return tuple(axes)


def _divisible(spec: tuple, shape, mesh) -> tuple:
    """`spec` with each axis dropped whose extent does not divide its dim
    (and any entry past the tensor's dims)."""
    fixed = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fixed.append(None)
            continue
        total = 1
        for a in _key(ax):
            total *= axis_size(mesh, a)
        fixed.append(ax if shape[i] % total == 0 else None)
    return tuple(fixed[:len(shape)])


def placements(spec: tuple, mesh) -> list:
    """One DTensor placement per mesh dim: `Shard(i)` where the spec puts
    that mesh axis on tensor dim i, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, ax in enumerate(spec):
        if ax is not None:
            for a in _key(ax):
                where[a] = i
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_axes(mesh)]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, logical: tuple):
    """Redistribute the DTensor x to the spec of `logical` (the
    reference's with_sharding_constraint): axes whose mesh extent does not
    divide the dim are dropped. A no-op on a plain tensor or with no rules
    active."""
    rules, mesh = _rules_var.get(), _mesh_var.get()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    want = placements(_divisible(logical_to_spec(logical), x.shape, mesh),
                      mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# Order matters: first match wins. Patterns run against the port's
# '.'-joined parameter names, whose layer index is unstacked
# (`blocks.3.attn.wq`): the reference's rules, '/' -> '.', with no leading
# stack dim to prepend.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed\.table", ("vocab", "embed")),
    (r"lm_head\.kernel", ("embed", "vocab")),
    (r"(attn|cross_attn)\.(wq|wkv|wk|wv)\b.*", ("embed", "heads")),
    (r"(attn|cross_attn)\.wo", ("heads", "embed")),
    (r"attn\.w_dq", ("embed", None)),
    (r"attn\.w_uq", (None, "heads")),
    (r"attn\.w_dkv", ("embed", None)),
    (r"attn\.w_ukv", (None, "heads")),
    (r"attn\.w_kr", ("embed", None)),
    (r"mlp\.w_(in|gate)", ("embed", "ff")),
    (r"mlp\.w_out", ("ff", "embed")),
    (r"moe\.router", ("embed", "experts")),
    (r"moe\.experts_w_(in|gate)", ("experts", "embed", None)),
    (r"moe\.experts_w_out", ("experts", None, "embed")),
    (r"moe\.shared_w_(in|gate)", ("embed", "ff")),
    (r"moe\.shared_w_out", ("ff", "embed")),
    (r"ssm\.in_proj", ("embed", "inner")),
    (r"ssm\.conv_w", ("inner", None)),
    (r"ssm\.x_proj", ("inner", None)),
    (r"ssm\.dt_proj", (None, "inner")),
    (r"ssm\.(A_log|D|conv_b|dt_bias)", ("inner",)),
    (r"ssm\.out_proj", ("inner", "embed")),
    (r"lru\.in_proj", ("embed", "inner")),
    (r"lru\.conv_w", ("inner", None)),
    (r"lru\.(a_param|gate_w|gate_b|input_w|input_b)", ("inner",)),
    (r"lru\.gates", ("inner", None)),
    (r"lru\.out_proj", ("inner", "embed")),
    (r"topo\..*", (None,)),  # 3 scalars a layer: replicated
    (r".*(norm|scale|bias)\b.*", (None,)),
    (r".*", (None,)),
]


def param_spec_for_path(path: str, ndim: int) -> tuple:
    """The spec of the parameter named `path` (first rule that matches),
    padded or cut to `ndim` dims. () with no rules active."""
    if _rules_var.get() is None:
        return ()
    names = next((list(logical) for pat, logical in PARAM_RULES
                  if re.search(pat, path)), [])
    names = (names + [None] * ndim)[:ndim]
    return tuple(logical_to_spec((n,))[0] if n else None for n in names)


def tree_param_specs(params) -> dict:
    """{name: spec} of every parameter of `params` (a module, or a
    {name: shape} dict), each axis that does not divide its dim dropped
    (replication). Needs active rules."""
    mesh = _mesh_var.get()
    shapes = (params if isinstance(params, dict) else
              {n: p.shape for n, p in params.named_parameters()})
    return {name: _divisible(param_spec_for_path(name, len(shape)),
                             tuple(shape), mesh)
            for name, shape in shapes.items()}


def named_sharding(spec: tuple) -> list:
    """The placements of `spec` on the current mesh."""
    return placements(spec, _mesh_var.get())


def shard_q_heads(x):
    """Attention-query sharding with a context-parallel fallback: heads
    over the model axis where they divide it; otherwise (llava 56, qwen2
    12, recurrentgemma 10) the QUERY length, whose rows are independent;
    otherwise the batch only. x: (B, L, H, hd). A no-op on a plain tensor
    or with no rules active."""
    rules, mesh = _rules_var.get(), _mesh_var.get()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    model_ax = rules.get("heads")
    if model_ax is None:
        return shard(x, ("batch", None, None, None))
    msize = 1
    for a in _key(model_ax):
        msize *= axis_size(mesh, a)
    L, H = x.shape[1], x.shape[2]
    if H % msize == 0:
        logical = ("batch", None, "heads", None)
    elif L % msize == 0 and L > 1:
        logical = ("batch", "heads", None, None)
    else:
        logical = ("batch", None, None, None)
    return shard(x, logical)


def split_heads(x, shape: tuple):
    """x (..., H * hd) reshaped to `shape` (..., H, hd). On a DTensor whose
    last dim is sharded by a mesh dim that does not divide H, that mesh dim
    is gathered first (the heads then run replicated there)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = Shard(x.ndim - 1)
        pls = [Replicate() if p == last and shape[-2] % x.device_mesh.size(j)
               else p for j, p in enumerate(x.placements)]
        if pls != list(x.placements):
            x = x.redistribute(x.device_mesh, pls)
    return x.reshape(shape)


def match_heads(q, k, dim: int = 2):
    """q with its heads (dim `dim`) gathered on every mesh dim that shards
    them where k's are not sharded alike (GQA's groups need both sharded
    or neither); a plain q as it is."""
    if not (is_dtensor(q) and is_dtensor(k)):
        return q
    from torch.distributed.tensor import Replicate, Shard

    pls = [Replicate() if p == Shard(dim) and k.placements[j] != p else p
           for j, p in enumerate(q.placements)]
    if pls != list(q.placements):
        q = q.redistribute(q.device_mesh, pls)
    return q


def distribute_params(model, mesh=None):
    """Turn every parameter of `model` into a DTensor parameter on `mesh`
    (default: the active mesh) placed by `tree_param_specs` under the
    active rules (the default ones on another mesh), in place, as
    `torch.distributed.tensor.distribute_module` would: each rank keeps
    its slab. Every rank must hold the same weights (build them from one
    seed). Returns the model."""
    from torch import nn

    mesh = mesh if mesh is not None else _mesh_var.get()
    ctx = (use_sharding(mesh) if mesh is not _mesh_var.get()
           or _rules_var.get() is None else contextlib.nullcontext())
    with ctx:
        specs = tree_param_specs(model)
    for name, spec in specs.items():
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        if is_dtensor(p):
            continue
        owner.register_parameter(leaf, nn.Parameter(
            from_replica(p.detach(), mesh, placements(spec, mesh)),
            requires_grad=p.requires_grad))
    return model


def from_replica(x, mesh, pls):
    """The DTensor with placements `pls` of x, which every rank holds whole
    and alike: each rank keeps a copy of its slab (no collective, unlike
    `distribute_tensor`, which scatters rank 0's copy)."""
    from torch.distributed.tensor import DTensor

    # a copy: a view would keep the whole tensor alive
    return DTensor.from_local(slab(x, mesh, pls).clone(), mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def slab(x, mesh, pls):
    """This rank's slab of the whole tensor x under placements `pls` (a
    plain tensor, contiguous)."""
    for j, pl in enumerate(pls):
        if pl.is_shard():
            x = x.chunk(mesh.size(j), dim=pl.dim)[mesh.get_local_rank(j)]
    return x.contiguous()


def distribute_batch(x, mesh):
    """x (B, ...), alike on every rank, as a DTensor whose batch dim is
    sharded over the batch axes (where they divide B), replicated
    otherwise. A DTensor passes as it is."""
    if is_dtensor(x):
        return x
    ctx = (contextlib.nullcontext() if _rules_var.get() is not None
           else use_sharding(mesh))
    with ctx:
        spec = _divisible(logical_to_spec(("batch",)), tuple(x.shape), mesh)
    return from_replica(x, mesh, placements(spec, mesh))


def model_mesh(model):
    """The mesh of a sharded model's parameters (None for a plain one)."""
    return next((p.device_mesh for p in model.parameters()
                 if is_dtensor(p)), None)


def _owner(model, name: str):
    *path, leaf = name.split(".")
    mod = model
    for part in path:
        mod = getattr(mod, part)
    return mod, leaf


def full(x):
    """The whole tensor of a DTensor (a collective where it is sharded or
    partial); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x):
    """This rank's slab of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def local_face(fn, args: tuple, in_placements: tuple, out_placements,
               in_grad_placements: tuple | None = None):
    """Run fn on each rank's slab of DTensor `args` and wrap its outputs as
    DTensors with `out_placements` (a placement list, or a tuple of them
    for several outputs; None for an output that is not a tensor). Each
    DTensor arg is first redistributed to its `in_placements` (None: as it
    is); its gradient is taken as `in_grad_placements` (default: the same
    placements; give `Partial()` on the axes where other args are sharded
    and this one is not, since the rank's grad is then a partial sum).
    Non-DTensor args pass through. Differentiable: fn runs under autograd
    on the slabs."""
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    locs = []
    for i, a in enumerate(args):
        if not is_dtensor(a):
            locs.append(a)
            continue
        want = in_placements[i]
        if want is not None and list(a.placements) != list(want):
            a = a.redistribute(mesh, want)
        gp = in_grad_placements[i] if in_grad_placements else None
        locs.append(a.to_local(grad_placements=gp))
    out = fn(*locs)
    multi = isinstance(out, tuple)
    outs = out if multi else (out,)
    pls = out_placements if multi else (out_placements,)
    wrapped = tuple(
        o if pl is None or not torch.is_tensor(o)
        else DTensor.from_local(o, mesh, pl, run_check=False)
        for o, pl in zip(outs, pls))
    return wrapped if multi else wrapped[0]


class _SumOverGroup(torch.autograd.Function):
    """all_reduce (sum) in the forward, identity in the backward: the
    reduction of partial sums whose result every rank then uses alike
    (Megatron's "g"), so each rank's cotangent is already the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x, group):
    """The sum of x over the ranks of `group`, differentiable as
    `_SumOverGroup` says."""
    return _SumOverGroup.apply(x, group)


def max_over(x, group):
    """The elementwise max of x over the ranks of `group` (no gradient)."""
    out = x.detach().contiguous().clone()
    torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    return out


# ----------------------------------------------------------------------------
# the cache side: a decode step on each rank's slab of its cache
# ----------------------------------------------------------------------------


class SeqShard:
    """What a rank of a sequence-sharded cache needs: `offset`, the first
    position of its block (`torch.chunk`'s split), and `group`, the ranks
    that hold the other blocks (its partial softmax statistics meet there:
    `max_over`, `sum_over`)."""

    def __init__(self, offset: int, group):
        self.offset, self.group = int(offset), group


def _placed(roles: list, dims: dict | None) -> list:
    """One placement per mesh dim for a tensor whose dims have the `roles`
    names in `dims` ({"batch": 0, "heads": 2, ...}): Shard where the mesh
    dim's role is one of its dims, else Replicate (a sequence-sharded mesh
    dim replicates everything but the cache)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = dims or {}
    return [Shard(dims[r]) if r in dims and r != "seq" else Replicate()
            for r in roles]


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of `shape` (computed, so that no
    tensor is made: a count open around the caller would read one)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def _wrap(x, mesh, pls, shape=None, stride=None):
    from torch.distributed.tensor import DTensor

    if shape is None:
        shape = list(x.shape)
        for j, p in enumerate(pls):
            if p.is_shard():
                shape[p.dim] *= mesh.size(j)
        shape = torch.Size(shape)
        stride = contiguous_strides(shape)
    return DTensor.from_local(x, mesh, pls, run_check=False, shape=shape,
                              stride=stride)


def cache_face(fn, cache: dict, cache_roles: dict, args: tuple,
               arg_roles: tuple, out_roles: tuple):
    """A decode step's DTensor face, led by its cache: fn(seq, cache, *args)
    -> (outs, new_cache) runs on each rank's slab of the cache as it is
    placed, and everything else is brought to the cache. No collective
    moves the cache.

    `cache` maps names to tensors (one layer's), `cache_roles` each name
    to its dims' roles ({"batch": 0, "seq": 1, "heads": 2}); `arg_roles`
    gives each of `args` likewise (None: passed as it is), `out_roles`
    each of fn's outputs. Each mesh dim takes its role from the cache
    leaves sharded over it ("batch", "seq" or "heads"; a leaf sharded on a
    dim without a role raises). Where no leaf is sharded and no leaf has
    a heads dim (a latent cache), the heads of args[0] keep their
    sharding where every arg's heads divide (the "heads" role). Each arg
    is then redistributed to its slab: sharded on its dim of that role,
    replicated elsewhere (a token-sized collective at most; plain tensors
    are taken as replicated), and so are the outputs. On a "seq" mesh dim
    everything but the cache is replicated and fn gets `SeqShard` (else
    None): it writes only the positions its block holds and meets its
    partial softmax statistics over `seq.group`. The new cache keeps the
    old one's placements and shapes. With a plain cache this is
    fn(None, cache, *args)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = next(iter(cache.values()))
    if not is_dtensor(lead):
        return fn(None, cache, *args)
    mesh = lead.device_mesh
    roles, seq = [], None
    any_heads = any("heads" in cache_roles[n] for n in cache)
    for j in range(mesh.ndim):
        got = set()
        for n, t in cache.items():
            pl = t.placements[j]
            if pl.is_shard():
                role = next((r for r, d in cache_roles[n].items()
                             if d == pl.dim), None)
                if role is None:
                    raise ValueError(
                        f"cache leaf {n!r} is sharded on its dim {pl.dim} "
                        f"over mesh dim {j}: its decode step cannot take "
                        "that dim apart")
                got.add((role, n))
            elif not pl.is_replicate():
                raise ValueError(f"cache leaf {n!r} is {pl} over mesh dim "
                                 f"{j}")
        kinds = {r for r, _ in got}
        if len(kinds) > 1:
            raise ValueError(f"the cache leaves are sharded by {kinds} over "
                             f"mesh dim {j}")
        role = kinds.pop() if kinds else None
        if role is None and not any_heads and arg_roles[0] and \
                "heads" in arg_roles[0]:
            h = arg_roles[0]["heads"]
            if (is_dtensor(args[0]) and args[0].placements[j] == Shard(h)
                    and all(a.shape[rl["heads"]] % mesh.size(j) == 0
                            for a, rl in zip(args, arg_roles)
                            if rl and "heads" in rl)):
                role = "heads"
        if role == "seq":
            n = next(n for r, n in got if r == "seq")
            S = cache[n].shape[cache_roles[n]["seq"]]
            seq = SeqShard(mesh.get_local_rank(j) * -(-S // mesh.size(j)),
                           mesh.get_group(j))
        roles.append(role)
    locs = []
    for a, rl in zip(args, arg_roles):
        if rl is None or not torch.is_tensor(a):
            locs.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = _placed(roles, rl)
        if list(a.placements) != want:
            a = a.redistribute(mesh, want)
        locs.append(a.to_local())
    outs, new = fn(seq, {n: t.to_local() for n, t in cache.items()}, *locs)
    outs = tuple(_wrap(o.contiguous(), mesh, _placed(roles, rl))
                 for o, rl in zip(outs, out_roles))
    new = {n: _wrap(t, mesh, list(cache[n].placements), cache[n].shape,
                    cache[n].stride()) for n, t in new.items()}
    return outs, new


def _shifted(pls, by: int) -> list:
    from torch.distributed.tensor import Shard

    return [Shard(p.dim + by) if p.is_shard() else p for p in pls]


def unstack(x, j: int):
    """x[j] of a stack whose dim 0 (the layers) no mesh dim shards; a
    DTensor's from its slab, with no collective."""
    if not is_dtensor(x):
        return x[j]
    if any(p.is_shard() and p.dim == 0 for p in x.placements):
        raise ValueError("the stack is sharded over its layer dim")
    return _wrap(x.to_local()[j], x.device_mesh, _shifted(x.placements, -1),
                 x.shape[1:], x.stride()[1:])


def empty_stack(like, count: int):
    """An uninitialized stack of `count` tensors like `like` (a DTensor's
    slabs stacked, placed as `like` one dim down)."""
    loc = local(like)
    out = torch.empty((count,) + tuple(loc.shape), dtype=loc.dtype,
                      device=loc.device)
    if not is_dtensor(like):
        return out
    shape = torch.Size((count,) + tuple(like.shape))
    return _wrap(out, like.device_mesh, _shifted(like.placements, 1), shape,
                 contiguous_strides(shape))


def stack(tensors: list):
    """torch.stack of same-placed tensors along a new dim 0; DTensors by
    their slabs, with no collective."""
    if not is_dtensor(tensors[0]):
        return torch.stack(tensors)
    out = empty_stack(tensors[0], len(tensors))
    for j, t in enumerate(tensors):
        local(out)[j].copy_(local(t))
    return out


def argmax_last(x):
    """argmax over the last dim of x (.., V); on a DTensor whose last dim
    is sharded (the vocab over the model axis) each rank takes its slab's
    max and first index, and two all_reduces of (..) over those mesh dims
    pick the first index of the global max (torch.argmax's choice), with
    no gather of x. The result is placed as x's leading dims."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    from torch.distributed.tensor import Replicate

    last = x.ndim - 1
    mesh = x.device_mesh
    pls = [Replicate() if p.is_partial() else p for p in x.placements]
    if pls != list(x.placements):
        x = x.redistribute(mesh, pls)
    vdims = [j for j, p in enumerate(pls) if p.is_shard() and p.dim == last]
    loc = x.to_local()
    best, idx = loc.max(dim=-1)
    if vdims:
        (j,) = vdims  # one mesh dim shards the vocab
        V = x.shape[-1]
        idx = idx + mesh.get_local_rank(j) * -(-V // mesh.size(j))
        group = mesh.get_group(j)
        top = max_over(best, group)
        idx = torch.where(best == top, idx, torch.full_like(idx, V))
        out = idx.contiguous().clone()
        torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.MIN,
                                     group=group)
        idx = out
    out_pls = [Replicate() if j in vdims else p for j, p in enumerate(pls)]
    return _wrap(idx, mesh, out_pls)


def matmul(x, w):
    """x (..., K) @ w (K, N), w a 2-D DTensor (a weight): each rank's slab
    product with the placements fixed per mesh dim, Megatron's column and
    row parallel layers: w sharded by columns takes x replicated there and
    gives y sharded by its last dim; w sharded by rows takes x sharded by
    its last dim and gives y partial; a replicated w keeps x's batch
    sharding (its grad partial there). DTensor's own propagation is not
    used for these products: its choice of strategy depends on the shapes,
    and at served widths it gathered whole weights in the backward and
    left their grads partial at full size."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    last = x.ndim - 1
    x_pl, x_gpl, w_gpl, y_pl = [], [], [], []
    for pw, px in zip(w.placements, x.placements):
        if px.is_partial():
            px = Replicate()
        if pw == Shard(1):  # column parallel
            x_pl.append(Replicate())
            x_gpl.append(Partial())
            w_gpl.append(pw)
            y_pl.append(Shard(last))
        elif pw == Shard(0):  # row parallel
            x_pl.append(Shard(last))
            x_gpl.append(Shard(last))
            w_gpl.append(pw)
            y_pl.append(Partial())
        elif px.is_shard() and px.dim != last:  # data parallel
            x_pl.append(px)
            x_gpl.append(px)
            w_gpl.append(Partial())
            y_pl.append(px)
        else:
            x_pl.append(Replicate())
            x_gpl.append(Replicate())
            w_gpl.append(Replicate())
            y_pl.append(Replicate())
    return local_face(torch.matmul, (x, w), (x_pl, list(w.placements)),
                      y_pl, (x_gpl, w_gpl))


# `a @ b` reaches a mode as TensorBase.matmul
_MATMULS = (torch.matmul, torch.Tensor.__matmul__, torch._C.TensorBase.matmul)


class _SlabProducts(torch.overrides.TorchFunctionMode):
    """Routes every `a @ w` whose right operand is a 2-D DTensor (a weight,
    or a tied embedding's transpose) through `matmul`."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in _MATMULS and len(args) == 2
                and not kwargs and is_dtensor(args[1])
                and args[1].ndim == 2 and args[0].ndim >= 2):
            return matmul(*args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def dtensor_scope():
    """The context a sharded forward and its backward run in: plain tensors
    that meet a DTensor (aranges, rope angles, masks made from global
    shapes, alike on every rank) are taken as replicated, and products by
    weights run as `matmul` says. Re-entrant."""
    from torch.distributed.tensor.experimental import implicit_replication

    global _SCOPES
    # implicit_replication sets one global flag and clears it on exit: an
    # inner scope leaves it to the outermost
    outer = implicit_replication() if not _SCOPES else contextlib.nullcontext()
    _SCOPES += 1
    try:
        with outer, _SlabProducts():
            yield
    finally:
        _SCOPES -= 1


_SCOPES = 0  # dtensor_scope blocks open


def remat_contexts():
    """`torch.utils.checkpoint`'s context_fn: the block's recompute in the
    backward runs in `dtensor_scope` where its forward did (the mode does
    not reach the recompute by itself)."""
    return (contextlib.nullcontext(),
            dtensor_scope() if _SCOPES else contextlib.nullcontext())


def remat_kwargs() -> dict:
    """The context_fn argument of a block's `checkpoint`: `remat_contexts`
    inside a `dtensor_scope`, else none (checkpoint's own no-op, which a
    graph trace such as `make_fx` requires)."""
    return {"context_fn": remat_contexts} if _SCOPES else {}


def sharded(model) -> bool:
    """Whether `model`'s parameters are DTensors (`distribute_params`)."""
    return any(is_dtensor(p) for p in model.parameters())


def slab_face(fn, args: tuple, roles: tuple, out_roles):
    """A kernel's DTensor face: run fn on each rank's (batch, heads) slab
    of `args` with no collective of its own. roles[i] = (the batch dim,
    the heads dim) of args[i], either None (a dim the arg lacks);
    out_roles likewise for fn's output (a tuple of them for several
    outputs). Each mesh dim takes its placement from args[0]: where it
    shards args[0]'s batch dim, every arg with a batch dim is sharded
    there alike; its heads (or channels) dim likewise, where every arg's
    heads dim divides; anything else runs replicated on that mesh dim (as
    `shard` drops an axis that does not divide). An arg without the
    sharded role is replicated there, and its grad is the sum of the
    ranks' (Partial). Non-DTensor args pass through; where args[0] is
    not a DTensor this is fn(*args)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    mesh = lead.device_mesh
    multi = isinstance(out_roles[0], tuple)
    outs = out_roles if multi else (out_roles,)
    in_pl = [[] for _ in args]
    in_gpl = [[] for _ in args]
    out_pl = [[] for _ in outs]
    for j, p in enumerate(lead.placements):
        role = None
        if p.is_shard():
            role = next((r for r in (0, 1) if roles[0][r] == p.dim), None)
        if role == 1 and any(
                rl[1] is not None and a.shape[rl[1]] % mesh.size(j)
                for a, rl in zip(args, roles) if torch.is_tensor(a)):
            role = None
        for i, rl in enumerate(roles):
            dim = rl[role] if role is not None else None
            in_pl[i].append(Shard(dim) if dim is not None else Replicate())
            in_gpl[i].append(Shard(dim) if dim is not None else
                             Partial() if role is not None else Replicate())
        for o, rl in enumerate(outs):
            dim = rl[role] if role is not None else None
            out_pl[o].append(Shard(dim) if dim is not None else Replicate())
    return local_face(fn, args, tuple(in_pl), tuple(out_pl) if multi
                      else out_pl[0], tuple(in_gpl))


def _collective_kinds() -> dict:
    """{op packet: (kind, the index of the arg each rank sends)} of the
    torch.distributed collectives: the functional ones DTensor issues and
    the c10d ones `torch.distributed`'s calls issue."""
    f, c = torch.ops._c10d_functional, torch.ops.c10d
    return {f.all_gather_into_tensor: ("all_gather", 0),
            f.reduce_scatter_tensor: ("reduce_scatter", 0),
            f.all_reduce: ("all_reduce", 0),
            f.all_to_all_single: ("all_to_all", 0),
            f.broadcast: ("broadcast", 0),
            c._allgather_base_: ("all_gather", 1),
            c._reduce_scatter_base_: ("reduce_scatter", 1),
            c.allreduce_: ("all_reduce", 0),
            c.alltoall_base_: ("all_to_all", 1),
            c.allgather_: ("all_gather", 1),
            c.broadcast_: ("broadcast", 0)}


class CollectiveCensus(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the collectives this rank issues inside the block, by kind,
    with the bytes of the tensor it sends to each (`counts`, `bytes`,
    `largest`): DTensor's redistributions (the mode lets DTensor desugar
    first) and direct `torch.distributed` calls, forward and backward.
    `keep=True`
    also holds every tensor sent (`sent`) and its collective's kind
    (`sent_kinds`, alike in order), so that a caller can ask whether one
    of them was a given tensor's storage, or a given kind and shape."""

    def __init__(self, keep: bool = False):
        super().__init__()
        self.counts, self.bytes, self.largest = {}, {}, {}
        self.sent: list | None = [] if keep else None
        self.sent_kinds: list | None = [] if keep else None
        self._kinds = _collective_kinds()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        hit = self._kinds.get(func._overloadpacket)
        if hit is not None:
            kind, i = hit
            sent = args[i] if i < len(args) else None
            ts = sent if isinstance(sent, (list, tuple)) else [sent]
            n = sum(t.numel() * t.element_size() for t in ts
                    if torch.is_tensor(t))
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + n
            self.largest[kind] = max(self.largest.get(kind, 0), n)
            if self.sent is not None:
                mine = [t for t in ts if torch.is_tensor(t)]
                self.sent.extend(mine)
                self.sent_kinds.extend([kind] * len(mine))
        return func(*args, **kwargs)
