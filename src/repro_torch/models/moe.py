"""Mixture-of-Experts FFN of the port (DeepSeek-style), the reference's
`models/moe.py` on one device.

Dispatch is sort-based (no (T, E, C) one-hots): the (token, k) assignments
are flattened, sorted by expert (stably: earlier tokens keep priority), each
one's position in its expert counted from the sorted segment starts, and
scattered into an (E, C, d) buffer; assignments at positions >= C are
dropped (they add zeros to slot C - 1). The experts' gated FFNs run as
batched products over that buffer, the outputs are gathered back and summed
per token with their renormalised gates. T counts every position of the
batch, padding included, so padded rows compete for capacity as they do in
the reference. Top-k is a stable descending sort, so equal probabilities
order by expert index, as `jax.lax.top_k` orders them. A Switch-style aux
load-balance loss on each token's top-1 expert comes with the output.

Set `TRACE` to a list to record each dispatch's routing (expert ids,
positions, the kept mask and C), e.g. to compare two runs' routing; it is
None, and records nothing, by default. Each stage runs in a
`torch.profiler.record_function` range (`moe.router`, `moe.dispatch`,
`moe.experts`, `moe.combine`, `moe.shared`), so a profile attributes its
device time by stage.

On a sharded model (DTensor parameters, `launch.sharding`) the block runs
expert-parallel (`_moe_sharded`): the experts over the model axis, each
rank routing its tokens with the whole router and running its own experts
only, the outputs partial over the experts' ranks; the `moe_groups`
groups over the data axes, each rank dispatching its own groups (the
reference's `spmd_axis_name`), or every group on every rank where the
groups do not divide over them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.launch import sharding
from repro_torch.models.layers import Params, dense_init

TRACE: list | None = None


def moe_shapes(cfg) -> dict:
    d, E, ffe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s = {"router": (d, E), "experts_w_gate": (E, d, ffe),
         "experts_w_in": (E, d, ffe), "experts_w_out": (E, ffe, d)}
    if cfg.num_shared_experts > 0:
        ffs = ffe * cfg.num_shared_experts
        s.update(shared_w_gate=(d, ffs), shared_w_in=(d, ffs),
                 shared_w_out=(ffs, d))
    return s


ROUTER_DTYPES = {"router": torch.float32}  # the router stays float32


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    return {name: dense_init(gen, shape, scale=0.02 if name == "router"
                             else None,
                             dtype=ROUTER_DTYPES.get(name, dtype))
            for name, shape in moe_shapes(cfg).items()}


class MoE(Params):
    """The router, the stacked experts (E, d, f) / (E, f, d) and the shared
    experts (f = moe_d_ff x num_shared_experts)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(moe_shapes(cfg), dtype, device, ROUTER_DTYPES)


def capacity(cfg, T: int) -> int:
    """Slots per expert for T tokens: the reference's formula."""
    C = int(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts)
    return max(8, min(C, T))


def _dispatch_combine(cfg, p, xt, experts=None, e0: int = 0, router=None):
    """Dispatch -> expert FFN -> combine for one group. xt: (T, d) ->
    ((T, d), aux). `router` is the whole router (default p's); `experts`
    (w_gate, w_in, w_out) are the slabs of the experts e0, e0 + 1, ...
    (default: all of p's, e0 = 0): the output then sums those experts'
    contributions only."""
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    dev = xt.device
    w_gate, w_in, w_out = experts or (p.experts_w_gate, p.experts_w_in,
                                      p.experts_w_out)
    e1 = e0 + w_gate.shape[0]

    with record_function("moe.router"):
        probs = torch.softmax(xt.float() @ (p.router if router is None
                                            else router), dim=-1)  # (T, E)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = vals[:, :K], ids[:, :K]
        gate_vals = gate_vals / gate_vals.sum(dim=-1,
                                              keepdim=True).clamp_min(1e-9)
        # aux load-balance loss (Switch-style)
        me = probs.mean(dim=0)
        ce = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)
        aux = (me * ce).sum() * E * cfg.router_aux_loss

    C = capacity(cfg, T)
    with record_function("moe.dispatch"):
        flat_expert = expert_ids.reshape(-1)  # (T * K,)
        flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
        # position within expert by a stable sort: earlier tokens keep
        # priority
        sorted_e, order = torch.sort(flat_expert, stable=True)
        seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
        pos_sorted = torch.arange(T * K, device=dev) - seg_start[sorted_e]
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        keep = pos < C
        slot = flat_expert * C + torch.where(keep, pos, C - 1)
        # each kept assignment owns its slot; dropped ones add zeros to C - 1
        buf = xt.new_zeros((E * C, d)).index_add_(
            0, slot, torch.where(keep[:, None], xt[flat_tok], 0.0).to(
                xt.dtype)).view(E, C, d)
    if TRACE is not None:
        TRACE.append({"expert_ids": expert_ids, "pos": pos.view(T, K),
                      "keep": keep.view(T, K), "C": C})

    with record_function("moe.experts"):
        buf = buf[e0:e1]
        h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_in)
        out_buf = torch.bmm(h, w_out).view((e1 - e0) * C, d)

    with record_function("moe.combine"):
        if (e0, e1) != (0, E):
            mine = (flat_expert >= e0) & (flat_expert < e1)
            keep = keep & mine
            slot = torch.where(mine, slot - e0 * C, 0)
        weighted = out_buf[slot] * (gate_vals.reshape(-1) * keep).to(
            xt.dtype)[:, None]
        # flat_tok is arange(T) repeated K times: token t's K rows are
        # adjacent
        return weighted.view(T, K, d).sum(dim=1), aux


def moe_block(cfg, p, x):
    """x: (B, L, d) -> ((B, L, d), aux scalar). moe_groups > 1 splits the
    tokens into that many groups, each dispatched with its own capacity
    (the reference's per-group C), the aux their mean; a T not divisible by
    the groups falls back to one."""
    B, L, d = x.shape
    T = B * L
    G = max(1, getattr(cfg, "moe_groups", 1))
    if T % G:
        G = 1
    if sharding.is_dtensor(x):
        return _moe_sharded(cfg, p, x, G)
    xt = x.reshape(T, d)
    if G == 1:
        yt, aux = _dispatch_combine(cfg, p, xt)
    else:
        outs = [_dispatch_combine(cfg, p, g) for g in xt.view(G, T // G, d)]
        yt = torch.cat([y for y, _ in outs])
        aux = torch.stack([a for _, a in outs]).mean()
    if cfg.num_shared_experts > 0:
        with record_function("moe.shared"):
            hs = F.silu(xt @ p.shared_w_gate) * (xt @ p.shared_w_in)
            yt = yt + hs @ p.shared_w_out
    return yt.reshape(B, L, d), aux


def _moe_sharded(cfg, p, x, G: int):
    """`moe_block` on a DTensor x (B, L, d), expert-parallel (the module's
    docstring). The routing of every group is the single-device one: each
    rank holds whole groups and the whole router (gathered over the
    experts' axis), so its `TRACE` records are those of its groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    B, L, d = x.shape
    wg = p.experts_w_gate
    data = [j for j, pl in enumerate(x.placements) if pl == Shard(0)]
    D = 1
    for j in data:
        D *= mesh.size(j)
    local_groups = G % D == 0
    ep = [j for j, pl in enumerate(wg.placements) if pl == Shard(0)]
    M = 1
    for j in ep:
        M *= mesh.size(j)
    # per mesh dim: the tokens' rows (sharded where the groups are local),
    # the grads of x, the router and the experts, the output and the aux.
    # An expert rank adds its experts' share of y and of every input's
    # grad (Partial); the aux, alike on the expert ranks, is split among
    # them (and among the data ranks, which average their groups')
    x_pl, x_gpl, r_gpl, e_gpl, y_pl, aux_pl = [], [], [], [], [], []
    for j in range(mesh.ndim):
        rows = j in data and local_groups
        x_pl.append(Shard(0) if rows else Replicate())
        x_gpl.append(Partial() if j in ep else x_pl[-1])
        r_gpl.append(Partial() if j in ep or rows else Replicate())
        e_gpl.append(Shard(0) if j in ep else
                     Partial() if rows else Replicate())
        y_pl.append(Partial() if j in ep else x_pl[-1])
        aux_pl.append(r_gpl[-1])
    share = (D if local_groups else 1) * M

    def local(xl, router, w_gate, w_in, w_out):
        b = xl.shape[0]
        xt = xl.reshape(b * L, d)
        # this rank's experts: its block of the experts' axes, in order
        e0 = 0
        for j in ep:
            e0 = e0 * mesh.size(j) + mesh.get_local_rank(j)
        e0 *= w_gate.shape[0]
        n = G // D if local_groups else G
        outs = [_dispatch_combine(cfg, p, g, (w_gate, w_in, w_out), e0,
                                  router) for g in xt.view(n, -1, d)]
        yt = torch.cat([y for y, _ in outs])
        aux = torch.stack([a for _, a in outs]).mean()
        return yt.view(b, L, d), aux / share

    y, aux = sharding.local_face(
        local, (x, p.router, wg, p.experts_w_in, p.experts_w_out),
        (x_pl, [Replicate()] * mesh.ndim, None, None, None), (y_pl, aux_pl),
        (x_gpl, r_gpl, e_gpl, e_gpl, e_gpl))
    if cfg.num_shared_experts > 0:
        with record_function("moe.shared"):
            hs = F.silu(x @ p.shared_w_gate) * (x @ p.shared_w_in)
            y = y + hs @ p.shared_w_out
    return y, aux

