"""Input stand-ins for every (arch x shape) cell: the reference's
`launch/specs.py`.

The reference's `jax.ShapeDtypeStruct`s become meta tensors (a shape and
a dtype, no memory), its param pytree's `eval_shape` the model on the meta
device, and its `NamedSharding`s DTensor placements (one per mesh dim, by
`launch.sharding`'s rules).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding
from repro_torch.launch.sharding import logical_to_spec
from repro_torch.models.encdec import FRONTEND_DIM
from repro_torch.models.lm import PATCH_DIM


def batch_specs(cfg, shape_name: str) -> dict:
    """Meta-tensor inputs of the step function of this cell (global
    shapes)."""
    sh = SHAPES[shape_name]
    B, L = sh["global_batch"], sh["seq_len"]
    meta = dict(device="meta")
    i32 = torch.int32
    if sh["kind"] in ("train", "prefill"):
        batch = {"tokens": torch.empty((B, L), dtype=i32, **meta)}
        if cfg.family == "vlm":
            P_ = cfg.num_prefix_embeddings
            batch["tokens"] = torch.empty((B, L - P_), dtype=i32, **meta)
            batch["patch_embeds"] = torch.empty((B, P_, PATCH_DIM),
                                                dtype=torch.bfloat16, **meta)
        if cfg.is_encdec:
            batch["src_embeds"] = torch.empty(
                (B, cfg.max_source_len, FRONTEND_DIM), dtype=torch.bfloat16,
                **meta)
        return batch
    # decode: one token + KV/state cache of length L
    from repro_torch.models import api

    return {"token": torch.empty((B, 1), dtype=i32, **meta),
            "cache": api.init_cache(cfg, B, L, device="meta"),
            "pos": torch.empty((), dtype=i32, **meta)}


def params_shapes(cfg):
    """The config's model on the meta device: every parameter's shape and
    dtype, no memory."""
    if cfg.is_encdec:
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, device="meta")
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, device="meta")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def batch_shardings(cfg, shape_name: str, mesh) -> dict:
    """DTensor placements for the batch (batch dim over (pod, data)); in a
    decode cell the cache's too: its batch dim over the batch axes where
    they divide it, else (a batch-1 long context) its sequence over
    `seq_shard`, and a heads-like dim over `model` where it divides. Call
    under `sharding.use_sharding(mesh)`."""
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    dp = logical_to_spec(("batch",))[0]
    seq = logical_to_spec(("seq_shard",))[0]

    def ns(spec):
        return sharding.placements(spec, mesh)

    if kind in ("train", "prefill"):
        out = {"tokens": ns((dp, None))}
        if cfg.family == "vlm":
            out["patch_embeds"] = ns((dp, None, None))
        if cfg.is_encdec:
            out["src_embeds"] = ns((dp, None, None))
        return out
    B = sh["global_batch"]
    ndev_dp = 1
    if dp is not None:
        for n in (dp if isinstance(dp, tuple) else (dp,)):
            ndev_dp *= sharding.axis_size(mesh, n)
    batch_shardable = B % max(ndev_dp, 1) == 0 and B >= ndev_dp
    model_sz = sharding.axis_size(mesh, "model")

    def cache_spec(leaf):
        # leaf leading dims: [layers?, batch, length/positions, ...]
        nd = leaf.ndim
        spec = [None] * nd
        shp = leaf.shape
        # find the batch dim: first dim equal to B
        for i, s in enumerate(shp):
            if s == B:
                if batch_shardable:
                    spec[i] = dp
                elif i + 1 < nd and shp[i + 1] == sh["seq_len"]:
                    spec[i + 1] = seq  # batch=1 long-context: shard sequence
                break
        # shard a heads-like dim over model where divisible
        for i in range(nd - 1, 0, -1):
            if spec[i] is None and shp[i] in (cfg.num_heads, cfg.num_kv_heads,
                                              cfg.d_inner, cfg.lru_width):
                if shp[i] % model_sz == 0:
                    spec[i] = "model"
                    break
        return ns(tuple(spec))

    cache = _tree_map(cache_spec, batch_specs(cfg, shape_name)["cache"])
    return {
        "token": ns((dp, None)) if batch_shardable else ns((None, None)),
        "cache": cache,
        "pos": ns(()),
    }
