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
a Python loop. The plan backend comes from
`attention.resolve_topo_backend`, as given. The reference's build-time
health probe (vit.py:66-77) is ROADMAP A9b: nothing here probes or
falls back.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import plan_api
from repro_torch.core.lru import BoundedLRU
from repro_torch.core.masks import (make_tree_fastmult, mask_f,
                                    masked_attention_bruteforce,
                                    masked_linear_attention)
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import grid_graph
from repro_torch.graphs.mst import minimum_spanning_tree
from repro_torch.models import api
from repro_torch.models import attention as A
from repro_torch.models.layers import (Params, dense_init, dtype_of,
                                       gated_mlp, gated_mlp_init, rms_norm)

VARIANTS = ("topo", "performer")
LEAF_SIZE = 16

_GRID_PLAN_CACHE = BoundedLRU(8)
_GRID_DIST_CACHE = BoundedLRU(4)


def _grid_side(n: int) -> int:
    side = int(round(np.sqrt(n)))
    if side * side != n:
        raise ValueError(f"{n} patches: not a square patch grid")
    return side


def install_grid_plan(spec, params, device=None) -> int:
    """Adopt a prebuilt or loaded plan (e.g. an `ftfi.load_plan` artifact,
    this package's or the reference's) as the grid plan for its side
    length: later `build_grid_plan` calls for that (side, device) return
    it with no IT build, whatever the backend. Returns the grid side."""
    side = _grid_side(spec.n)
    dev = resolve_device(device)
    _GRID_PLAN_CACHE.put((side, str(dev)),
                         (spec, plan_api._params_on(params, dev)))
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


def topo_vit_attention(cfg, p, x, plan, backend: str):
    """Grid-MST masked linear attention of one block `p` over x (B, L, d).
    cfg.topo_attn_impl "ref" materializes the dense tree mask (the oracle);
    every other impl runs Algorithm 1 with the plan FastMult on `backend`."""
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
    else:
        fastmult = make_tree_fastmult(
            plan, cfg.topo_g, coeffs, cfg.topo_dist_scale, backend=backend,
            device=x.device)
        out = masked_linear_attention(qf_, kf_, v_, fastmult)
    out = out.transpose(1, 2).reshape(B, L, -1).to(x.dtype)
    return out @ p.attn.wo


def forward(cfg, model, patches, plan=None, *, backend: str | None = None,
            device=None):
    """patches (B, L, patch_dim), numpy or tensor -> logits
    (B, num_classes), on `device` (None: the CUDA card), where the model
    must already live. `plan` is the grid plan (default `build_grid_plan`),
    run on `attention.resolve_topo_backend`'s backend; the "ref" impl and
    the "performer" variant need none. Differentiable: serving wraps it in
    `torch.no_grad()`. `cfg.topo_shard_plan` under a process group of more
    than one rank raises: the sharded plan executor is ROADMAP A12."""
    if cfg.attention_variant not in VARIANTS:
        raise ValueError(f"attention_variant={cfg.attention_variant!r}: the "
                         f"ViT runs {VARIANTS}")
    if cfg.topo_attn_impl not in A.IMPLS:
        raise ValueError(f"cfg.topo_attn_impl={cfg.topo_attn_impl!r}: "
                         f"expected one of {A.IMPLS}")
    dist = torch.distributed
    if (cfg.topo_shard_plan and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            f"cfg.topo_shard_plan over a process group of "
            f"{dist.get_world_size()} ranks: the sharded plan executor is "
            "not ported yet (ROADMAP A12)")
    dev = api._on(model, device)
    topo = cfg.attention_variant == "topo"
    backend = A.resolve_topo_backend(cfg, backend)
    if topo and cfg.topo_attn_impl != "ref" and plan is None:
        plan = build_grid_plan(cfg, dev)
    x = torch.as_tensor(patches, device=dev).to(dtype_of(cfg))
    x = x @ model.patch_proj.kernel
    x = x + model.patch_proj.bias + model.pos_embed[None]
    for blk in model.blocks:
        h = rms_norm(x, blk.attn_norm.scale, cfg.norm_eps, plus_one=True)
        if topo:
            x = x + topo_vit_attention(cfg, blk, h, plan, backend)
        else:
            x = x + A.performer_attention_train(cfg, blk.attn, h, None,
                                                causal=False)
        h = rms_norm(x, blk.mlp_norm.scale, cfg.norm_eps, plus_one=True)
        x = x + gated_mlp(blk.mlp, h, cfg.mlp_act)
    x = rms_norm(x, model.final_norm.scale, cfg.norm_eps, plus_one=True)
    return x.mean(dim=1) @ model.head.kernel + model.head.bias
