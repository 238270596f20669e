"""Per-rank work of tests/test_torch_serve_shard.py: every sharded decode
case on a (2, 2) mesh over ("data", "model") of 4 gloo CPU ranks, run once
per rank by `launch.mesh.run_local` (a module-level function, so the
spawned ranks import it by name; this module imports neither jax nor the
reference). Each rank builds the model from the state dict the test sends
(numpy), fills a cache with the port's single-device prefill (the encdec
family, which has none, by decode replay), runs the single-device steps,
then the same steps on the sharded model with the cache, token and pos
placed by `launch.specs.batch_shardings`, and returns both, with each
step's collective census, as numpy."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import base as TB
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding, specs, steps
from repro_torch.models import api, encdec, lm

CPU = "cpu"


def _np(t):
    return sharding.full(t).detach().cpu().numpy().copy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _model(cfg, sd):
    fam = encdec if cfg.is_encdec else lm
    return fam.from_state_dict(cfg, {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()})


def _prefilled(cfg, model, c):
    """(the cache after the prompt, the first decoded token, its position)
    on one device."""
    B, S = c["B"], c["S"]
    cache = api.init_cache(cfg, B, S, device=CPU)
    prompt = torch.as_tensor(c["prompt"])
    if cfg.is_encdec:  # no fused prefill: replay the prompt
        for pos in range(prompt.shape[1]):
            logits, cache = api.decode_fn(cfg, model, cache,
                                          prompt[:, pos:pos + 1], pos, S,
                                          device=CPU)
        first = torch.argmax(logits[:, -1], dim=-1)
    else:
        lengths = torch.full((B,), prompt.shape[1], dtype=torch.int64)
        logits, cache = api.prefill_into_cache(cfg, model, cache, prompt,
                                               lengths, S, device=CPU)
        first = torch.argmax(logits, dim=-1)
    return cache, first.to(torch.int32)[:, None], prompt.shape[1]


def _stepped(step, *args):
    """One `step` call and the logits its `api.decode_fn` returned: the
    checked logits, token and cache come from one computation."""
    seen, real = [], api.decode_fn

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out[0])
        return out

    api.decode_fn = spy
    try:
        token, cache = step(*args)
    finally:
        api.decode_fn = real
    return token, cache, seen[0]


def _case(c: dict, mesh) -> dict:
    cfg = get_smoke_config(c["arch"], dtype="float32", **c["over"])
    B, S = c["B"], c["S"]
    shape = f"serve_shard_{B}x{S}"
    TB.SHAPES[shape] = dict(seq_len=S, global_batch=B, kind="decode")
    single = _model(cfg, c["sd"])
    cache, token, pos0 = _prefilled(cfg, single, c)
    step = steps.make_serve_step(cfg, S, device=CPU)
    want = []
    c1, t1 = cache, token
    for i in range(c["steps"]):
        t1, c1, logits = _stepped(step, single, c1, t1, pos0 + i)
        want.append({"token": _np(t1), "logits": _np(logits),
                     "cache": {n: _np(t) for n, t in _leaves(c1)}})

    model = _model(cfg, c["sd"])
    out = {"steps": [], "single": want, "first": _np(token)}
    with sharding.use_sharding(mesh):
        sharding.distribute_params(model, mesh)
        pls = specs.batch_shardings(cfg, shape, mesh)
        c2 = specs.distribute_cache(cache, pls["cache"], mesh)
        t2 = sharding.from_replica(token, mesh, pls["token"])
        slabs = {n: (tuple(sharding.local(t).shape),
                     sharding.local(t).numel()
                     * sharding.local(t).element_size())
                 for n, t in _leaves(c2)}
        for i in range(c["steps"]):
            pos = sharding.from_replica(torch.tensor(pos0 + i), mesh,
                                        pls["pos"])
            census = sharding.CollectiveCensus(keep=True)
            old = {sharding.local(t).untyped_storage().data_ptr()
                   for _, t in _leaves(c2)}
            with census:
                t2, c2, logits = _stepped(step, model, c2, t2, pos)
            new = {sharding.local(t).untyped_storage().data_ptr()
                   for _, t in _leaves(c2)}
            sent = {t.untyped_storage().data_ptr() for t in census.sent}
            out["steps"].append({
                "token": _np(t2), "logits": _np(logits),
                "cache": {n: _np(t) for n, t in _leaves(c2)},
                "token_placements": [repr(p) for p in t2.placements],
                "cache_placements": {n: [repr(p) for p in t.placements]
                                     for n, t in _leaves(c2)},
                "counts": dict(census.counts),
                "largest": dict(census.largest),
                "sent_cache": len(sent & (old | new))})
    out["placed"] = {n: [repr(p) for p in t] for n, t in
                     _leaves(pls["cache"])}
    out["token_placed"] = [repr(p) for p in pls["token"]]
    out["slabs"] = slabs
    TB.SHAPES.pop(shape)
    return out


def rank_main(cases: dict) -> dict:
    """Every case on this rank, on the (2, 2) mesh."""
    torch.manual_seed(0)
    mesh = M.make_local_mesh(2, 2, CPU)
    out = {"rank": dist.get_rank()}
    for name, c in cases.items():
        out[name] = _case(c, mesh)
    return out
