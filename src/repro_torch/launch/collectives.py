"""The collectives of the sharded FTFI executor, with their VJPs.

Each helper runs one `torch.distributed` collective over a process group
and is differentiable:

  all_to_all(x, group)       (D * E, d) rows out, rows in; VJP: the
                             reverse all_to_all (its own transpose)
  reduce_scatter(x, group)   (D * b, d) partial sums -> this rank's summed
                             block (b, d); VJP: all_gather
  all_gather(x, group)       (b, d) blocks -> the (D * b, d) whole, one copy
                             on every rank; VJP: this rank's block of the
                             cotangent (the reverse of the gather: every
                             rank holds the same replicated value, so the
                             cotangent is one logical value, not D)
  scatter_block(x, group)    this rank's block of a replicated (D * b, d)
                             input; VJP: all_gather of the block cotangents,
                             so every rank gets the whole gradient
  replicated(ts, group)      identity on replicated tensors that each rank
                             reads only in part; VJP: one all_reduce (sum)
                             of the flattened cotangents

A field sharded by rows is a DTensor with `Shard(0)` on the plan axis and
`Replicate()` on every other mesh axis (`row_placements`): rank k holds
rows [k * block, (k + 1) * block) of n, block = ceil(n / D), which is
`torch.chunk`'s split and so DTensor's own (`row_bounds`). `rows_dtensor`
wraps a rank's (rows, ...) block as such a field with no collective;
`local_rows` reads a rank's block of one (its local tensor, where it is
placed so).

`COUNTS` counts forward calls by collective (backward calls apart, under
"backward_<name>"); a caller zeroes it around the work it reads.

Every collective takes its tensors where they lie. NCCL takes CUDA
tensors, and gloo takes CPU tensors; gloo also took all four collectives
here (all_to_all_single, reduce_scatter_tensor, all_gather_into_tensor and
all_reduce) on CUDA tensors with torch 2.11 on an H100, so a group of gloo
processes sharing one card keeps its buffers on the card. A backend that
refuses a tensor raises, and the caller's work fails with it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS: dict = {}

# the current names first: the older ones are deprecated aliases
_RS_NAMES = ("reduce_scatter_single", "reduce_scatter_tensor")
_AG_NAMES = ("all_gather_single", "all_gather_into_tensor")


def reset_counts() -> None:
    COUNTS.clear()


def _count(name: str) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + 1


def _fn(names):
    if isinstance(names, str):
        return getattr(dist, names)
    return next(getattr(dist, n) for n in names if hasattr(dist, n))


def _raw(name: str, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    if name == "all_to_all":
        _fn("all_to_all_single")(out, inp, group=group)
    elif name == "reduce_scatter":
        _fn(_RS_NAMES)(out, inp, group=group)
    elif name == "all_gather":
        _fn(_AG_NAMES)(out, inp, group=group)
    elif name == "all_reduce":
        out.copy_(inp)
        _fn("all_reduce")(out, group=group)
    else:  # pragma: no cover - internal names only
        raise ValueError(name)


def _run(name: str, out_shape, x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _raw(name, out, x, group)
    return out


def _block(x: torch.Tensor, group) -> int:
    """Rows of one rank's block of x."""
    ws = dist.get_world_size(group)
    if x.shape[0] % ws:
        raise ValueError(f"{x.shape[0]} rows do not split into {ws} blocks")
    return x.shape[0] // ws


def _a2a(x, group):
    return _run("all_to_all", x.shape, x, group)


def _rs(x, group):
    b = _block(x, group)
    return _run("reduce_scatter", (b,) + tuple(x.shape[1:]), x, group)


def _ag(x, group):
    ws = dist.get_world_size(group)
    return _run("all_gather", (ws * x.shape[0],) + tuple(x.shape[1:]), x,
                group)


def _own(x, group):
    b = _block(x, group)
    r = dist.get_rank(group)
    return x[r * b:(r + 1) * b]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_to_all")
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("backward_all_to_all")
        return _a2a(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("reduce_scatter")
        return _rs(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("backward_all_gather")
        return _ag(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_gather")
        return _ag(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group).contiguous(), None


class _ScatterBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own(x, group).clone()

    @staticmethod
    def backward(ctx, g):
        _count("backward_all_gather")
        return _ag(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        # every rank reduces every tensor (unused ones as zeros), so the
        # flattened buffers agree in length across the group
        _count("backward_all_reduce")
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = _run("all_reduce", flat.shape, flat, ctx.group)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None,) + tuple(out)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rows [j*E, (j+1)*E) go to rank j; rows from rank j land there."""
    return _AllToAll.apply(x, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ranks of x, this rank's block of rows."""
    return _ReduceScatter.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block, concatenated in rank order, on every rank."""
    return _AllGather.apply(x, group)


def scatter_block(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows of a replicated x."""
    return _ScatterBlock.apply(x, group)


def row_bounds(n: int, D: int, k: int) -> tuple:
    """[lo, hi): rank k's rows of n split into D blocks of ceil(n / D)
    (the last ones short or empty), as `torch.chunk` and DTensor's
    `Shard` split them."""
    block = max(-(-n // D), 1)
    lo = min(k * block, n)
    return lo, min(lo + block, n)


def row_placements(mesh, axis: str, dim: int = 0) -> list:
    """`Shard(dim)` on the mesh dim named `axis`, `Replicate()` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dim) if name == axis else Replicate()
            for name in (mesh.mesh_dim_names or ())]


def rows_dtensor(local: torch.Tensor, mesh, axis: str, n: int,
                 dim: int = 0):
    """This rank's row block `local` (its rows along `dim`) of a field of
    n rows as a DTensor sharded by rows over `axis` (no collective; every
    rank passes its own block). Differentiable: the grad of `local` is the
    rank's block of the field's grad."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import contiguous_strides

    shape = list(local.shape)
    shape[dim] = n
    return DTensor.from_local(local, mesh, row_placements(mesh, axis, dim),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def local_rows(X, axis: str, dim: int = 0) -> torch.Tensor:
    """The local row block (along `dim`) of the DTensor field X over the
    mesh dim named `axis`, X first redistributed to `row_placements` where
    it is placed otherwise (a replicated X gives its block with no
    collective). Differentiable: the block's grad is the field's, sharded
    by rows."""
    want = row_placements(X.device_mesh, axis, dim)
    if list(X.placements) != want:
        X = X.redistribute(X.device_mesh, want)
    return X.to_local()


def replicated(tensors, group) -> tuple:
    """The replicated `tensors` as they are; their grads summed over the
    group's ranks in the backward."""
    tensors = tuple(tensors)
    if not any(t.requires_grad for t in tensors):
        return tensors
    return _Replicated.apply(group, *tensors)


# ----------------------------------------------------------------------------
# DTensor's collectives on gloo and CUDA tensors
# ----------------------------------------------------------------------------


class C10dRoute(torch.utils._python_dispatch.TorchDispatchMode):
    """Runs the collectives that DTensor's redistributions issue
    (`_c10d_functional`'s all_reduce, all_gather_into_tensor and
    reduce_scatter_tensor, and DTensor's shard_dim_alltoall) on a gloo
    group through `torch.distributed`'s own synchronous calls, for tensors
    on `devices`; their `wait_tensor` is then the identity. With torch 2.11
    on an H100, gloo's functional all_gather_into_tensor on CUDA tensors
    crashed the process (segmentation fault in wait_tensor) where
    `torch.distributed`'s all_gather_into_tensor on the same tensors
    works, so gloo ranks that share a card run DTensor under this mode
    (`route_dtensor_collectives`). Anything else passes through."""

    def __init__(self, devices=("cuda",)):
        super().__init__()
        self.devices = tuple(devices)
        self.calls = 0  # collectives it ran
        f = torch.ops._c10d_functional
        self._ops = {f.all_reduce: self._all_reduce,
                     f.all_gather_into_tensor: self._all_gather,
                     f.reduce_scatter_tensor: self._reduce_scatter}
        dt = getattr(torch.ops, "_dtensor", None)
        if dt is not None and hasattr(dt, "shard_dim_alltoall"):
            self._ops[dt.shard_dim_alltoall] = self._shard_dim_alltoall
        self._wait = f.wait_tensor

    @staticmethod
    def _group(name):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(name)

    def _mine(self, x, name) -> bool:
        return (x.device.type in self.devices
                and dist.get_backend(self._group(name)) == "gloo")

    @staticmethod
    def _op(name: str):
        return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
                "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                "product": dist.ReduceOp.PRODUCT}[name.lower()]

    def _all_reduce(self, x, op, name):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=self._op(op), group=self._group(name))
        if op.lower() == "avg":
            out /= dist.get_world_size(self._group(name))
        return out

    def _all_gather(self, x, size, name):
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _fn(_AG_NAMES)(out, x, group=self._group(name))
        return out

    def _reduce_scatter(self, x, op, size, name):
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        _fn(_RS_NAMES)(out, x, op=self._op(op), group=self._group(name))
        if op.lower() == "avg":
            out /= size
        return out

    def _shard_dim_alltoall(self, x, gather_dim, shard_dim, name):
        """Every rank's block gathered along gather_dim, then this rank's
        block along shard_dim (DTensor's own fallback on gloo)."""
        group = self._group(name)
        size = dist.get_world_size(group)
        parts = self._all_gather(x, size, name).chunk(size, dim=0)
        whole = torch.cat(parts, dim=gather_dim)
        return whole.chunk(size, dim=shard_dim)[
            dist.get_rank(group)].contiguous()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        run = self._ops.get(packet)
        if run is not None and self._mine(args[0], args[-1]):
            out = run(*args, **kwargs)
            self.calls += 1
            out._c10d_route_done = True  # complete: its wait is a no-op
            return out
        if packet is self._wait and getattr(args[0], "_c10d_route_done",
                                            False):
            return args[0]
        return func(*args, **kwargs)


_ROUTE: C10dRoute | None = None


def route_dtensor_collectives() -> None:
    """Enter `C10dRoute` for CUDA tensors in this process, once, for the
    rest of its life (a gloo rank that holds DTensors on a card)."""
    global _ROUTE
    if _ROUTE is None:
        _ROUTE = C10dRoute()
        _ROUTE.__enter__()
