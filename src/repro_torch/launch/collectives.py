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


def replicated(tensors, group) -> tuple:
    """The replicated `tensors` as they are; their grads summed over the
    group's ranks in the backward."""
    tensors = tuple(tensors)
    if not any(t.requires_grad for t in tensors):
        return tensors
    return _Replicated.apply(group, *tensors)
