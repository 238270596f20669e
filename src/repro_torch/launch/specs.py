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
    decode cell the token's, pos's (replicated) and the cache's too
    (`cache_shardings`). Call under `sharding.use_sharding(mesh)`."""
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    dp = logical_to_spec(("batch",))[0]

    def ns(spec):
        return sharding.placements(spec, mesh)

    if kind in ("train", "prefill"):
        out = {"tokens": ns((dp, None))}
        if cfg.family == "vlm":
            out["patch_embeds"] = ns((dp, None, None))
        if cfg.is_encdec:
            out["src_embeds"] = ns((dp, None, None))
        return out
    return decode_shardings(cfg, batch_specs(cfg, shape_name)["cache"],
                            sh["global_batch"], sh["seq_len"], mesh)


def decode_shardings(cfg, cache: dict, B: int, S: int, mesh) -> dict:
    """{"token", "cache", "pos"}: the placements of one decode step's
    inputs at batch B over a cache of S positions (the tree of
    `api.init_cache`): the token's batch over the batch axes where they
    divide B, else replicated; the cache by `cache_shardings`; pos
    replicated. Call under `sharding.use_sharding(mesh)`."""
    dp = logical_to_spec(("batch",))[0]
    token = (dp, None) if _batch_shardable(B, mesh) else (None, None)
    return {"token": sharding.placements(token, mesh),
            "cache": cache_shardings(cfg, cache, B, S, mesh),
            "pos": sharding.placements((), mesh)}


def _batch_shardable(B: int, mesh) -> bool:
    dp = logical_to_spec(("batch",))[0]
    ndev_dp = 1
    if dp is not None:
        for n in (dp if isinstance(dp, tuple) else (dp,)):
            ndev_dp *= sharding.axis_size(mesh, n)
    return B % max(ndev_dp, 1) == 0 and B >= ndev_dp


def cache_shardings(cfg, cache: dict, B: int, S: int, mesh) -> dict:
    """DTensor placements of a decode cache of batch B and length S (the
    tree of `api.init_cache`, real or meta tensors), by the reference's
    rule: each leaf's batch dim over the batch axes where they divide B,
    else (a batch-1 long context) its sequence over `seq_shard`, and a
    heads-like dim over `model` where it divides. Call under
    `sharding.use_sharding(mesh)`."""
    dp = logical_to_spec(("batch",))[0]
    seq = logical_to_spec(("seq_shard",))[0]
    batch_shardable = _batch_shardable(B, mesh)
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
                elif i + 1 < nd and shp[i + 1] == S:
                    spec[i + 1] = seq  # batch=1 long-context: shard sequence
                break
        # shard a heads-like dim over model where divisible
        for i in range(nd - 1, 0, -1):
            if spec[i] is None and shp[i] in (cfg.num_heads, cfg.num_kv_heads,
                                              cfg.d_inner, cfg.lru_width):
                if shp[i] % model_sz == 0:
                    spec[i] = "model"
                    break
        return sharding.placements(tuple(spec), mesh)

    return _tree_map(cache_spec, cache)


def distribute_cache(cache: dict, pls: dict, mesh) -> dict:
    """The cache tree as DTensors placed by `pls` (`cache_shardings`);
    every rank holds the whole cache alike and keeps its slabs (no
    collective)."""
    if isinstance(cache, dict):
        return {k: distribute_cache(v, pls[k], mesh)
                for k, v in cache.items()}
    return sharding.from_replica(cache, mesh, pls)
