"""AdamW + cosine schedule + global-norm clipping over a model's named
parameters: the reference's `optim/adamw.py`, formula for formula and in
its order of operations.

  * the clip scale is min(1, max_norm / (gnorm + 1e-9)), the norm summed
    in float32; the clipped grads are float32 (the scale is a float32
    scalar), as in the reference;
  * step + 1 feeds the schedule, and the bias corrections are float32;
  * p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), cast back to p's
    dtype;
  * mu and nu start as zeros in p's dtype, as `zeros_like(p)` does; their
    update mixes in the float32 grads, so from the first step on they are
    float32 for a bfloat16 parameter, again as in the reference.

Not `torch.optim.AdamW` with `clip_grad_norm_`: their epsilon and their
order of operations compute another function. The update writes the new
values into the parameters and the state in place (no second copy of a
1B-parameter model or of its state), under `torch.no_grad()`.

DTensor parameters (`launch.sharding.distribute_params`): each grad is
first placed as its parameter is (a partial grad reduced: over the data
axes for a replicated weight, the model axis for a norm), the global norm
is each rank's sum of squares of the slabs it owns (one copy of each
replicated slab counted) reduced once over the whole mesh, `lr`, the bias
corrections and the clip scale stay plain replicated scalars, and the
update runs on each rank's slabs, in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict  # name -> tensor, like the params
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: dict) -> AdamWState:
    """params: {name: tensor} (e.g. dict(model.named_parameters()))."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()})


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at `step` (an int or a tensor), float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def place_grads(grads: dict, params: dict) -> dict:
    """Each DTensor grad redistributed to its parameter's placements (the
    reduction of a partial grad); plain grads as they are."""
    out = {}
    for k, g in grads.items():
        p = params[k]
        if _is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[k] = g
    return out


def _owned_sumsq(g) -> torch.Tensor:
    """This rank's share of sum(g^2) in float32: its slab, counted on one
    rank of each replicated mesh dim only, so the shares sum to the
    whole."""
    sq = torch.sum(torch.square(_local(g).float()))
    if _is_dtensor(g):
        mesh = g.device_mesh
        for j, pl in enumerate(g.placements):
            if pl.is_partial():
                raise ValueError("place the grads first (place_grads)")
            if pl.is_replicate() and mesh.get_local_rank(j) != 0:
                return torch.zeros_like(sq)
    return sq


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every grad, in float32. Over DTensor
    grads (placed as their parameters) every rank sums the squares it owns
    and one all_reduce over the mesh's ranks adds them: a plain scalar,
    alike on every rank."""
    total = None
    mesh = None
    for g in grads.values():
        sq = _owned_sumsq(g)
        mesh = g.device_mesh if _is_dtensor(g) else mesh
        total = sq if total is None else total + sq
    if mesh is not None:
        import torch.distributed as dist

        if mesh.size() == dist.get_world_size():
            dist.all_reduce(total)
        else:
            for j in range(mesh.ndim):
                dist.all_reduce(total, group=mesh.get_group(j))
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(the grads scaled by min(1, max_norm / (gnorm + 1e-9)), as float32;
    gnorm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict,
                 cfg: AdamWConfig):
    """One step over {name: grad} and {name: parameter}. The parameters and
    the state's mu and nu dicts are updated in place; returns (the new
    state, metrics {"grad_norm", "lr"}). The clip is applied tensor by
    tensor: the same values as clipping every grad first, without a
    float32 copy of all of them at once. DTensor grads are placed as their
    parameters first (`place_grads`)."""
    grads = place_grads(grads, params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    bc1 = 1.0 - torch.pow(cfg.b1, step.float())
    bc2 = 1.0 - torch.pow(cfg.b2, step.float())
    mu, nu = state.mu, state.nu
    for k, p in params.items():
        g = _local(grads[k]).float() * scale
        mu[k] = _ema(mu[k], cfg.b1, g)
        nu[k] = _ema(nu[k], cfg.b2, torch.square(g))
        del g
        m, v, w = _local(mu[k]), _local(nu[k]), _local(p)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * w
        w.copy_((w - lr * upd).to(w.dtype))
    return AdamWState(step, mu, nu), {"grad_norm": gnorm, "lr": lr}


def _ema(old, b: float, new):
    """b old + (1 - b) new: in place where old already has new's dtype
    (the same roundings as out of place). `new` is a plain tensor (a
    DTensor `old`'s slab); a DTensor `old` stays one."""
    loc = _local(old)
    if loc.dtype == new.dtype:
        loc.mul_(b).add_((1 - b) * new)
        return old
    out = b * loc + (1 - b) * new
    if not _is_dtensor(old):
        return out
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, old.device_mesh, old.placements,
                              run_check=False)
