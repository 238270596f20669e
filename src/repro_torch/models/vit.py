"""Topological Vision Transformer (paper Sec 4.4, TopViT with trees).

Performer attention with the RPE mask M = [f(dist_MST(i,j))] over the MST
of the 2D patch grid, applied through Algorithm 1 with the plan executor's
FastMult (exact). 3 learnable mask scalars per layer (synced).

The mask function is a bare callable (`masks.mask_f`), family None for
the plan's engine selection, and the grid MST has unit spacing, so every
cross bucket takes the exact Hankel-FFT engine on either backend: this
path launches none of the port's CUDA kernels.

`TopoViT` holds the reference's param tree with the layer axis unstacked
(`blocks/attn/wq[l]` -> `blocks.{l}.attn.wq`), in the reference's (in,
out) layout, so `convert.vit_from_reference` is a renaming. Blocks run in
a Python loop. The grid plan runs through an `Integrator`
(`build_grid_integrator`) on `attention.resolve_topo_backend`'s backend.
On "cuda" its first build runs a health probe (`ladder.probe_backend`)
with a mask of the ViT's own family, so the probe exercises the engine the
grid will serve. A failed probe raises `DeviceRungError` on the card,
which never leaves the backend it was given; on a CPU device it blocks the
rung and the grid is served by "torch", as the reference's ladder demotes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import ladder, plan_api
from repro_torch.core.engines import Integrator
from repro_torch.core.lru import BoundedLRU
from repro_torch.core.masks import (make_tree_fastmult, mask_f,
                                    masked_attention_bruteforce,
                                    masked_linear_attention)
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import grid_graph
from repro_torch.graphs.mst import minimum_spanning_tree
from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.models import attention as A
from repro_torch.models.layers import (Params, dense_init, dtype_of,
                                       gated_mlp, gated_mlp_init, rms_norm)

VARIANTS = ("topo", "performer")
LEAF_SIZE = 16

_GRID_PLAN_CACHE = BoundedLRU(8)
_GRID_INTEGRATOR_CACHE = BoundedLRU(8)
_GRID_DIST_CACHE = BoundedLRU(4)


def _grid_side(n: int) -> int:
    side = int(round(np.sqrt(n)))
    if side * side != n:
        raise ValueError(f"{n} patches: not a square patch grid")
    return side


def install_grid_plan(spec, params, device=None) -> int:
    """Adopt a prebuilt or loaded plan (e.g. an `ftfi.load_plan` artifact,
    this package's or the reference's) as the grid plan for its side
    length: later `build_grid_plan` / `build_grid_integrator` calls for
    that (side, device) serve it with no IT build, whatever the backend.
    The pair enters through `Integrator.from_plan`, so it passes the plan
    guard first. Returns the grid side."""
    side = _grid_side(spec.n)
    dev = resolve_device(device)
    integ = Integrator.from_plan(spec, params, backend="torch", device=dev)
    _GRID_PLAN_CACHE.put((side, str(dev)), (integ.spec, integ.params))
    return side


def build_grid_plan(cfg, device=None):
    """The (spec, params) pair of the patch-grid MST plan, leaf size 16,
    params on `device` (None: the CUDA card). The MST of a unit-weight grid
    is grid-aligned (grid_h == 1), so general mask functions take the exact
    Hankel-FFT cross engine. The pair does not depend on the backend that
    runs it: memoized per (grid side, device)."""
    side = _grid_side(cfg.num_prefix_embeddings)
    dev = resolve_device(device)
    key = (side, str(dev))
    plan = _GRID_PLAN_CACHE.get(key)
    if plan is None:
        plan = plan_api.build(minimum_spanning_tree(grid_graph(side, side)),
                              leaf_size=LEAF_SIZE, device=dev)
        _GRID_PLAN_CACHE.put(key, plan)
    return plan


def build_grid_integrator(cfg, backend: str | None = None, device=None):
    """`Integrator` over the grid plan of `build_grid_plan` on `backend`
    (`attention.resolve_topo_backend`: the explicit argument, else
    cfg.topo_backend, else the impl's), memoized per (grid side, backend,
    device). On "cuda" a new Integrator is probed once with a mask of the
    ViT's family before it serves: on the card a failed probe raises
    `ladder.DeviceRungError`; on a CPU device the rung is blocked
    (`ladder.block_backend`) and the grid is served by "torch" from then
    on, as the reference demotes (its host rung, the plain executor on
    the CPU, is "torch" there)."""
    side = _grid_side(cfg.num_prefix_embeddings)
    dev = resolve_device(device)
    backend = A.resolve_topo_backend(cfg, backend)
    if dev.type == "cpu":
        backend = ladder.effective_backend(backend)
        backend = "torch" if backend == "host" else backend
    elif backend in ladder.stats()["blocked"]:
        raise ladder.DeviceRungError(
            f"grid {side}x{side}: backend {backend!r} is blocked "
            f"({ladder.stats()['blocked'][backend]}); on the card the ladder "
            "does not demote")
    spec, params = build_grid_plan(cfg, dev)
    key = (side, backend, str(dev))
    integ = _GRID_INTEGRATOR_CACHE.get(key)
    if integ is not None and integ.spec is spec:
        return integ
    integ = Integrator.from_plan(spec, params, backend=backend, device=dev)
    if backend == "cuda":
        reason = ladder.probe_backend(
            integ.spec, integ.params, backend, device=dev,
            fn=mask_f(cfg.topo_g, [0.0, -1.0], cfg.topo_dist_scale))
        if reason is not None:
            if dev.type != "cpu":
                raise ladder.DeviceRungError(
                    f"grid {side}x{side} probe of backend {backend!r} "
                    f"failed on the card ({reason}); the ladder demotes "
                    "only on CPU tensors")
            ladder.block_backend(backend, f"grid {side}x{side} probe: "
                                 f"{reason}")
            return build_grid_integrator(cfg, "torch", dev)
    _GRID_INTEGRATOR_CACHE.put(key, integ)
    return integ


def _grid_tree_distances(side: int) -> np.ndarray:
    """Dense (L, L) MST path-distance matrix for the "ref" impl."""
    D = _GRID_DIST_CACHE.get(side)
    if D is None:
        from repro_torch.graphs.traverse import tree_all_pairs

        D = np.asarray(tree_all_pairs(
            minimum_spanning_tree(grid_graph(side, side))), np.float32)
        _GRID_DIST_CACHE.put(side, D)
    return D


# ----------------------------------------------------------------------------
# modules and params
# ----------------------------------------------------------------------------


class ViTBlock(nn.Module):
    """attn_norm, attn, topo (the mask scalars, in both variants, as in
    the reference), mlp_norm, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = Params({"scale": (d,)}, dtype, device)
        self.attn = A.Attention(cfg, dtype, device)
        self.topo = Params(A.topo_shapes(cfg), dtype, device)
        self.mlp_norm = Params({"scale": (d,)}, dtype, device)
        self.mlp = Params({"w_gate": (d, cfg.d_ff), "w_in": (d, cfg.d_ff),
                           "w_out": (cfg.d_ff, d)}, dtype, device)


class TopoViT(nn.Module):
    """patch_proj, pos_embed, blocks (a ModuleList of ViTBlock),
    final_norm, head; parameters in the config's dtype.
    `forward(patches)` is `vit.forward` on the model's device."""

    def __init__(self, cfg, num_classes: int = 1000, patch_dim: int = 768,
                 device=None):
        super().__init__()
        dtype = dtype_of(cfg)
        d, L = cfg.d_model, cfg.num_prefix_embeddings
        self.cfg = cfg
        self.patch_proj = Params({"kernel": (patch_dim, d), "bias": (d,)},
                                 dtype, device)
        self.pos_embed = nn.Parameter(torch.empty((L, d), dtype=dtype,
                                                  device=device))
        self.blocks = nn.ModuleList([ViTBlock(cfg, dtype, device)
                                     for _ in range(cfg.num_layers)])
        self.final_norm = Params({"scale": (d,)}, dtype, device)
        self.head = Params({"kernel": (d, num_classes),
                            "bias": (num_classes,)}, dtype, device)

    def forward(self, patches):
        return forward(self.cfg, self, patches,
                       device=self.pos_embed.device)


def init_state_dict(cfg, gen: torch.Generator, num_classes: int = 1000,
                    patch_dim: int = 768) -> dict:
    """Random weights by the reference's recipe, drawn from `gen` on its
    device, as a state dict of `TopoViT`."""
    dtype, dev, d = dtype_of(cfg), gen.device, cfg.d_model
    sd = {"patch_proj.kernel": dense_init(gen, (patch_dim, d), dtype=dtype),
          "patch_proj.bias": torch.zeros((d,), dtype=dtype, device=dev),
          "pos_embed": (torch.randn((cfg.num_prefix_embeddings, d),
                                    generator=gen, device=dev)
                        * 0.02).to(dtype)}
    for layer in range(cfg.num_layers):
        block = {"attn_norm": {"scale": torch.zeros((d,), dtype=dtype,
                                                    device=dev)},
                 "attn": A.attn_init(gen, cfg, dtype),
                 "topo": A.topo_init(cfg, dtype, dev),
                 "mlp_norm": {"scale": torch.zeros((d,), dtype=dtype,
                                                   device=dev)},
                 "mlp": gated_mlp_init(gen, d, cfg.d_ff, dtype)}
        for part, leaves in block.items():
            for name, t in leaves.items():
                sd[f"blocks.{layer}.{part}.{name}"] = t
    sd["final_norm.scale"] = torch.zeros((d,), dtype=dtype, device=dev)
    sd["head.kernel"] = dense_init(gen, (d, num_classes), dtype=dtype)
    sd["head.bias"] = torch.zeros((num_classes,), dtype=dtype, device=dev)
    return sd


def from_state_dict(cfg, sd: dict) -> TopoViT:
    """A TopoViT holding exactly the tensors of `sd` (strict)."""
    num_classes = sd["head.kernel"].shape[1]
    patch_dim = sd["patch_proj.kernel"].shape[0]
    model = TopoViT(cfg, num_classes, patch_dim, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def init_params(cfg, seed=0, num_classes: int = 1000, patch_dim: int = 768,
                device=None) -> TopoViT:
    """Random weights from `seed` (an int, or a torch.Generator on the
    device) on `device` (None: the CUDA card)."""
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
    return from_state_dict(cfg, init_state_dict(cfg, gen, num_classes,
                                                patch_dim))


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------


def topo_vit_attention(cfg, p, x, plan, backend: str, rows=None):
    """Grid-MST masked linear attention of one block `p` over x (B, L, d).
    cfg.topo_attn_impl "ref" materializes the dense tree mask (the oracle);
    every other impl runs Algorithm 1 with the plan FastMult on `backend`.
    `rows` (`_Rows`): x is this rank's row block of the tokens, and the
    mask fastmults run the multi-rank executor on row blocks."""
    B, L, _ = x.shape
    q, k, v = A._project_qkv(cfg, p.attn, x, None, rope=False)
    scale = A.topo_logit_scale(cfg, p.topo)  # (H,)
    qf = A.phi_features(q * scale[None, None, :, None], cfg.performer_phi)
    kf = A.phi_features(k, cfg.performer_phi)
    coeffs = A.topo_mask_coeffs(cfg, p.topo)[0]  # synced: same across heads
    # (B, L, H, m) -> heads folded into batch for Alg. 1
    qf_, kf_ = qf.transpose(1, 2), kf.transpose(1, 2)
    v_ = v.transpose(1, 2).float()
    if cfg.topo_attn_impl == "ref":
        D = torch.from_numpy(_grid_tree_distances(_grid_side(L))).to(x.device)
        out = masked_attention_bruteforce(
            qf_, kf_, v_, mask_f(cfg.topo_g, coeffs, cfg.topo_dist_scale)(D))
    elif sharding.is_dtensor(qf_):
        out = _masked_attention_sharded(cfg, plan, backend, qf_, kf_, v_,
                                        coeffs)
    else:
        fastmult = make_tree_fastmult(
            plan, cfg.topo_g, coeffs, cfg.topo_dist_scale, backend=backend,
            device=x.device, mesh=None if rows is None else rows.mesh)
        out = masked_linear_attention(qf_, kf_, v_, fastmult)
    out = out.transpose(1, 2).reshape(B, L, -1).to(x.dtype)
    return out @ p.attn.wo


class _Rows:
    """The tokens sharded by rows over the plan axis of `mesh`: rank k
    holds rows [lo, hi) of L (`collectives.row_bounds`, the plan
    executor's blocks). Every op of a block but the mask fastmults is
    row-wise, so the tokens stay sharded by rows from the patch projection
    to the pooling, and each integrate takes and returns row blocks."""

    def __init__(self, mesh, L: int):
        from repro_torch.launch import collectives

        self.mesh, self.L = mesh, L
        self.axis = sharding.plan_axis(mesh)
        self.group = sharding.axis_group(mesh, self.axis)
        self.lo, self.hi = collectives.row_bounds(
            L, sharding.axis_size(mesh, self.axis),
            sharding.axis_rank(mesh, self.axis))


def _row_mesh(mesh):
    """`mesh` where its plan axis has more than one rank (the mask
    fastmults then run the multi-rank executor over it), else None."""
    if mesh is None or sharding.axis_size(mesh, sharding.plan_axis(mesh)) < 2:
        return None
    return mesh


def _heads_to_rows(x, group, M: int, rows: int):
    """(b, h, L, c), this rank's h heads of every row -> (b, M h, rows, c),
    every head of this rank's rows [lo, lo + rows) (`collectives.
    row_bounds`), by one all_to_all over `group`, whose M ranks hold the
    heads in rank order. L is padded to M blocks of ceil(L / M) rows."""
    from repro_torch.launch import collectives

    b, h, L, c = x.shape
    block = -(-L // M)
    x = F.pad(x, (0, 0, 0, M * block - L)).permute(2, 0, 1, 3)
    y = collectives.all_to_all(x, group).reshape(M, block, b, h, c)
    return y.permute(2, 0, 3, 1, 4).reshape(b, M * h, block, c)[:, :, :rows]


def _rows_to_heads(y, group, M: int, L: int):
    """The inverse of `_heads_to_rows`: (b, H, rows, c), every head of this
    rank's rows -> (b, H / M, L, c), this rank's heads of every row, by
    one all_to_all over `group`."""
    from repro_torch.launch import collectives

    b, H, rows, c = y.shape
    block = -(-L // M)
    y = F.pad(y, (0, 0, 0, block - rows)).reshape(b, M, H // M, block, c)
    y = y.permute(1, 3, 0, 2, 4).reshape(M * block, b, H // M, c)
    return collectives.all_to_all(y, group)[:L].permute(1, 2, 0, 3)


def _masked_attention_sharded(cfg, plan, backend, qf, kf, v, coeffs):
    """Alg. 1 on DTensor fields (B, H, L, .) of a sharded model, on each
    rank's slab: the batch over the data axes, the heads over the model
    axis (`sharding.slab_face`). With cfg.topo_shard_plan the mask
    fastmults run the multi-rank executor over the model axis on row
    blocks: one all_to_all trades each rank's heads of every row for every
    head of its rows (qf, kf and v in one exchange), Alg. 1 runs on those
    rows, and one all_to_all brings the output back to the rank's heads,
    where the output projection's weights are sharded. No collective of
    the field's whole size: a rank receives (M - 1) / M^2 of each field.
    The mask coefficients' grads are summed over the model axis inside
    the fastmult (`make_tree_fastmult`), over the data axes here."""
    mesh = qf.device_mesh
    rest = [a for a in sharding.mesh_axes(mesh)
            if a not in (sharding.batch_axes() or ())]
    plan_mesh = (_row_mesh(mesh[rest[0]]) if cfg.topo_shard_plan and rest
                 else None)
    if plan_mesh is None:
        def local(q, k, vv, c):
            fm = make_tree_fastmult(plan, cfg.topo_g, c, cfg.topo_dist_scale,
                                    backend=backend, device=q.device)
            return masked_linear_attention(q, k, vv, fm)

        return sharding.slab_face(local, (qf, kf, v, coeffs),
                                  ((0, 1),) * 3 + ((None, None),), (0, 1))
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch import collectives

    axis = rest[0]
    M = sharding.axis_size(mesh, axis)
    H, L = qf.shape[1], qf.shape[2]
    if H % M:
        raise ValueError(f"topo_shard_plan: {H} heads do not split over the "
                         f"{M} ranks of mesh axis {axis!r}")
    group = sharding.axis_group(mesh, axis)
    lo, hi = collectives.row_bounds(L, M, sharding.axis_rank(mesh, axis))
    field = [Shard(1) if name == axis else p if p.is_shard(0) else Replicate()
             for name, p in zip(sharding.mesh_axes(mesh), qf.placements)]
    coeff_grad = [Partial() if p.is_shard(0) else Replicate() for p in field]

    def local(q, k, vv, c):
        fm = make_tree_fastmult(plan, cfg.topo_g, c, cfg.topo_dist_scale,
                                backend=backend, device=q.device,
                                mesh=plan_mesh)
        m = q.shape[-1]
        q, k, vv = _heads_to_rows(torch.cat((q, k, vv), dim=-1), group, M,
                                  hi - lo).split((m, m, vv.shape[-1]), -1)
        return _rows_to_heads(masked_linear_attention(q, k, vv, fm), group,
                              M, L)

    return sharding.local_face(
        local, (qf, kf, v, coeffs), (field,) * 3 + ([Replicate()] * len(
            field),), field, (field,) * 3 + (coeff_grad,))


def forward(cfg, model, patches, plan=None, *, backend: str | None = None,
            device=None):
    """patches (B, L, patch_dim), numpy or tensor -> logits
    (B, num_classes), on `device` (None: the CUDA card), where the model
    must already live. `plan` is the grid plan, a (spec, params) pair or an
    Integrator (default `build_grid_integrator`, probed on "cuda"), run on
    `attention.resolve_topo_backend`'s backend; the "ref" impl and
    the "performer" variant need none. Differentiable: serving wraps it in
    `torch.no_grad()`. `cfg.topo_shard_plan` runs each mask fastmult on the
    multi-rank plan executor over the active `launch.sharding` mesh (leaf
    blocks over its plan axis); the model and the patches are replicated,
    the tokens run sharded by rows over the plan axis (`_forward_rows`),
    and every rank returns the same logits. With no mesh, or one rank on
    its plan axis, it runs the single-device executor.

    A sharded model (`sharding.distribute_params`) takes the patches'
    batch over the data axes and returns DTensor logits, batch-sharded;
    its backward runs in `sharding.dtensor_scope()`. With
    cfg.topo_shard_plan the plan's leaf blocks then go over the model
    axis (`_masked_attention_sharded`)."""
    if cfg.attention_variant not in VARIANTS:
        raise ValueError(f"attention_variant={cfg.attention_variant!r}: the "
                         f"ViT runs {VARIANTS}")
    if cfg.topo_attn_impl not in A.IMPLS:
        raise ValueError(f"cfg.topo_attn_impl={cfg.topo_attn_impl!r}: "
                         f"expected one of {A.IMPLS}")
    dev = api._on(model, device)
    topo = cfg.attention_variant == "topo"
    backend = A.resolve_topo_backend(cfg, backend)
    if topo and cfg.topo_attn_impl != "ref" and plan is None:
        plan = build_grid_integrator(cfg, backend, dev)
        backend = plan.backend
    x = torch.as_tensor(patches, device=dev).to(dtype_of(cfg))
    mesh = sharding.model_mesh(model)
    if mesh is not None:
        with api.sharded_scope(model):
            return _forward(cfg, model, sharding.distribute_batch(x, mesh),
                            plan, backend, topo)
    row_mesh = (_row_mesh(sharding.current_mesh())
                if topo and cfg.topo_shard_plan
                and cfg.topo_attn_impl != "ref" else None)
    if row_mesh is not None:
        return _forward_rows(cfg, model, x, plan, backend,
                             _Rows(row_mesh, x.shape[1]))
    return _forward(cfg, model, x, plan, backend, topo)


def _forward(cfg, model, x, plan, backend, topo, rows=None):
    """The blocks, the final norm and the pooled head. With `rows` x holds
    this rank's rows of the tokens; the pooling sums the rows over the
    plan axis (one all_reduce of (B, d))."""
    x = x @ model.patch_proj.kernel
    pos = model.pos_embed if rows is None else model.pos_embed[
        rows.lo:rows.hi]
    x = x + model.patch_proj.bias + pos[None]
    for blk in model.blocks:
        h = rms_norm(x, blk.attn_norm.scale, cfg.norm_eps, plus_one=True)
        if topo:
            x = x + topo_vit_attention(cfg, blk, h, plan, backend, rows)
        else:
            x = x + A.performer_attention_train(cfg, blk.attn, h, None,
                                                causal=False)
        h = rms_norm(x, blk.mlp_norm.scale, cfg.norm_eps, plus_one=True)
        x = x + gated_mlp(blk.mlp, h, cfg.mlp_act)
    x = rms_norm(x, model.final_norm.scale, cfg.norm_eps, plus_one=True)
    if rows is None:
        pooled = x.mean(dim=1)
    else:
        pooled = sharding.sum_over(x.sum(dim=1), rows.group) / rows.L
    return pooled @ model.head.kernel + model.head.bias


def _forward_rows(cfg, model, x, plan, backend, rows):
    """`_forward` of a replicated model with the tokens sharded by rows
    over the plan axis (cfg.topo_shard_plan under a mesh): each rank
    takes its rows of the patches and every rank returns the same logits.
    A rank reads the weights before the pooling on its own rows only, so
    they pass through `collectives.replicated` (their grads summed over the
    plan axis in the backward); the mask coefficients are summed inside
    the fastmult (`make_tree_fastmult`) and the head's grads are whole on
    every rank."""
    from torch.nn.utils.stateless import _reparametrize_module

    from repro_torch.launch import collectives

    names = [n for n, _ in model.named_parameters()
             if not n.startswith("head.") and not n.endswith("topo.coeffs")]
    params = dict(model.named_parameters())
    summed = collectives.replicated([params[n] for n in names], rows.group)
    with _reparametrize_module(model, dict(zip(names, summed))):
        return _forward(cfg, model, x[:, rows.lo:rows.hi], plan, backend,
                        True, rows)
