"""Per-rank work of tests/test_torch_param_shard.py: every case the 4-rank
gloo group computes on its (2, 2) mesh over ("data", "model"), run once
per rank by `launch.mesh.run_local` (a module-level function, so the
spawned ranks import it by name; this module imports neither jax nor the
reference). Each rank builds every model from the same state dict (numpy,
from the test), runs it on one device and sharded
(`launch.sharding.distribute_params`), and returns both results whole, as
numpy."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import collectives
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding, steps
from repro_torch.models import api, encdec, lm, moe, vit
from repro_torch.optim.adamw import AdamWConfig, adamw_init

CPU = "cpu"
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)


def _np(t):
    return sharding.full(t).detach().cpu().numpy().copy()


def model_of(cfg, sd: dict):
    """The port's model of `cfg` holding the state dict `sd` (numpy)."""
    fam = encdec if cfg.is_encdec else lm
    return fam.from_state_dict(cfg, {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()})


def _params(model) -> dict:
    return {n: _np(p) for n, p in model.named_parameters()}


def _batch(c: dict) -> dict:
    return {k: c[k] for k in ("tokens", "src_embeds", "patch_embeds")
            if k in c}


def _step(cfg, model, batch, n: int = 1):
    """n train steps from a fresh AdamW state: (losses, the params whole,
    the state)."""
    opt = adamw_init(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, OPT, device=CPU)
    losses = []
    for _ in range(n):
        _, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses, opt


def _loss(cfg, model, batch) -> float:
    with api.sharded_scope(model):
        return float(sharding.full(api.loss_fn(cfg, model, batch,
                                               device=CPU)[0]))


def _routing(cfg, model, batch) -> list:
    """The loss's MoE routing records (`moe.TRACE`) as numpy."""
    moe.TRACE = []
    try:
        _loss(cfg, model, batch)
        return [{k: (v.numpy() if torch.is_tensor(v) else v)
                 for k, v in rec.items()} for rec in moe.TRACE]
    finally:
        moe.TRACE = None


def _train_case(c: dict, mesh) -> dict:
    cfg = get_smoke_config(c["arch"], **c["over"])
    single = model_of(cfg, c["sd"])
    l1, _ = _step(cfg, single, _batch(c))
    model = model_of(cfg, c["sd"])
    with sharding.use_sharding(mesh):
        sharding.distribute_params(model, mesh)
        l2, opt = _step(cfg, model, _batch(c))
    return {"single_loss": l1[0], "loss": l2[0],
            "single_params": _params(single), "params": _params(model),
            "_model": model, "_opt": opt, "_cfg": cfg}


def _routed_case(c: dict, mesh) -> dict:
    """The dense step sharded again with DTensor's collectives run through
    `collectives.C10dRoute` (the route of gloo ranks on a card, here taken
    on CPU tensors)."""
    route = collectives.C10dRoute(devices=(CPU,))
    with route:
        res = _train_case(c, mesh)
    return {"loss": res["loss"], "params": res["params"],
            "calls": route.calls}


def _loss_case(c: dict, mesh) -> dict:
    cfg = get_smoke_config(c["arch"], **c["over"])
    single = model_of(cfg, c["sd"])
    model = model_of(cfg, c["sd"])
    out = {"single_loss": _loss(cfg, single, _batch(c))}
    with sharding.use_sharding(mesh):
        sharding.distribute_params(model, mesh)
        out["loss"] = _loss(cfg, model, _batch(c))
        if cfg.family == "moe":
            out["routing"] = _routing(cfg, model, _batch(c))
    if cfg.family == "moe":
        out["single_routing"] = _routing(cfg, single, _batch(c))
    return out


def _sent(census) -> list:
    """(kind, shape, bytes) of each tensor a census saw sent, in order."""
    return [(kind, tuple(t.shape), t.numel() * t.element_size())
            for kind, t in zip(census.sent_kinds, census.sent)]


def _vit_case(c: dict, mesh) -> dict:
    cfg = get_smoke_config("topovit_b16", dtype="float32",
                           topo_attn_impl="torch")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in c["sd"].items()}
    single = vit.from_state_dict(cfg, dict(sd))
    plan = vit.build_grid_integrator(cfg, "torch", torch.device(CPU))
    ref = vit.forward(cfg, single, c["patches"], plan, device=CPU)
    (ref * torch.as_tensor(c["W"])).sum().backward()
    model = vit.from_state_dict(cfg, dict(sd))
    cfg_s = cfg.replace(topo_shard_plan=True)
    with sharding.use_sharding(mesh):
        sharding.distribute_params(model, mesh)
        with sharding.dtensor_scope():
            census = sharding.CollectiveCensus(keep=True)
            with census:
                logits = vit.forward(cfg_s, model, c["patches"], plan,
                                     device=CPU)
            back = sharding.CollectiveCensus(keep=True)
            with back:
                (logits * torch.as_tensor(c["W"])).sum().backward()
    return {"single_logits": ref.detach().numpy(), "logits": _np(logits),
            "forward_sent": _sent(census), "backward_sent": _sent(back),
            "single_coeff_grads": np.stack([b.topo.coeffs.grad.numpy()
                                            for b in single.blocks]),
            "placements": str(logits.placements),
            "coeff_grads": np.stack([_np(b.topo.coeffs.grad)
                                     for b in model.blocks])}


def _ckpt_case(dense: dict, c: dict, path: str) -> dict:
    """Save the sharded dense state after its step from the (2, 2) mesh,
    restore it on a (1, 4) mesh (each rank's slabs against the saved
    arrays, bitwise), then one more step on each mesh."""
    cfg, model, opt = dense["_cfg"], dense["_model"], dense["_opt"]
    mgr = CheckpointManager(path, keep=2)
    saved = mgr.save(1, model, opt)
    mesh14 = M.make_local_mesh(1, dist.get_world_size(), CPU)
    other = model_of(cfg, c["sd"])
    with sharding.use_sharding(mesh14):
        sharding.distribute_params(other, mesh14)
        opt14 = adamw_init(dict(other.named_parameters()))
        mgr.restore(other, opt14)
        with np.load(saved + "/params.npz") as z:
            bitwise = all(
                torch.equal(p.to_local(), sharding.slab(
                    torch.from_numpy(z[n]), mesh14, p.placements))
                for n, p in other.named_parameters())
        with np.load(saved + "/opt.npz") as z:
            bitwise = bitwise and all(
                torch.equal(t.to_local(), sharding.slab(
                    torch.from_numpy(z[f"{part}.{n}"]), mesh14,
                    t.placements))
                for part in ("mu", "nu")
                for n, t in getattr(opt14, part).items())
        step = steps.make_train_step(cfg, OPT, device=CPU)
        _, _, m14 = step(other, opt14, _batch(c))
    step = steps.make_train_step(cfg, OPT, device=CPU)
    with sharding.use_sharding(model.embed.table.device_mesh):
        _, _, m22 = step(model, opt, _batch(c))
    return {"restore14_bitwise": bool(bitwise),
            "loss22": float(m22["loss"]), "loss14": float(m14["loss"]),
            "params22": _params(model), "params14": _params(other),
            "placements14": {n: str(p.placements)
                             for n, p in other.named_parameters()}}


def rank_main(case: dict) -> dict:
    """Every sharded case of the test on this rank."""
    torch.manual_seed(0)
    mesh = M.make_local_mesh(2, 2, CPU)
    out = {"rank": dist.get_rank()}
    dense = _train_case(case["dense"], mesh)
    out["routed"] = _routed_case(case["dense"], mesh)
    out["topo"] = {k: v for k, v in _train_case(case["topo"], mesh).items()
                   if not k.startswith("_")}
    for name in ("moe", "moe_groups", "ssm", "hybrid", "encdec"):
        out[name] = _loss_case(case[name], mesh)
    out["vit"] = _vit_case(case["vit"], mesh)
    out["ckpt"] = _ckpt_case(dense, case["dense"], case["ckpt_dir"])
    out["dense"] = {k: v for k, v in dense.items() if not k.startswith("_")}
    return out
