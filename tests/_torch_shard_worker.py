"""Per-rank work of tests/test_torch_plan_shard.py: every case the 4-rank
gloo group computes, run once per rank by `launch.mesh.run_local` (a
module-level function, so the spawned ranks import it by name; this module
imports neither jax nor the reference). Inputs arrive as numpy from the
test; results go back as numpy, with each forward's collective counts."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ftfi as T
from repro_torch.core import cordial as TC
from repro_torch.graphs import graph as TG
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding

CPU = "cpu"
_COLLECTIVES = ("all_to_all_single", "reduce_scatter_tensor",
                "reduce_scatter_single", "all_gather_into_tensor",
                "all_gather_single", "all_reduce")


class _Census:
    """Counts the torch.distributed collectives issued inside the block
    (the module's functions wrapped in place, restored on exit)."""

    def __enter__(self):
        self.counts = {}
        self._saved = {}
        for name in _COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **kw)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def summary(self) -> dict:
        c = self.counts
        return {"all_to_all": c.get("all_to_all_single", 0),
                "reduce_scatter": c.get("reduce_scatter_tensor", 0)
                + c.get("reduce_scatter_single", 0),
                "all_gather": c.get("all_gather_into_tensor", 0)
                + c.get("all_gather_single", 0),
                "all_reduce": c.get("all_reduce", 0)}


def _np(t):
    """numpy of a tensor; a DTensor (the sharded executor's rows) whole."""
    if sharding.is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _fn(name):
    return (TC.Exponential(-0.4) if name == "exp"
            else (lambda s: 1.0 / (1.0 + s * s)))


def _grads(spec, params, fn, X, mesh):
    """The grads of sum(Y^2) in X and every distance tensor."""
    X = torch.as_tensor(X).clone().requires_grad_(True)
    p = T.PlanParams(
        cross_tgt_d=tuple(t.clone().requires_grad_(True)
                          for t in params.cross_tgt_d),
        cross_src_d=tuple(t.clone().requires_grad_(True)
                          for t in params.cross_src_d),
        leaf_dists=tuple(t.clone().requires_grad_(True)
                         for t in params.leaf_dists))
    Y = T.apply_sharded(spec, p, fn, X, mesh=mesh, device=CPU)
    (Y.full_tensor() ** 2).sum().backward()
    return {"X": _np(X.grad),
            "cross_tgt_d": [_np(t.grad) for t in p.cross_tgt_d],
            "cross_src_d": [_np(t.grad) for t in p.cross_src_d],
            "leaf_dists": [_np(t.grad) for t in p.leaf_dists]}


def _face_grads(face, args, W):
    """The grads of sum(face(*args) * W) in every input of a kernel face."""
    args = [torch.as_tensor(a).clone().requires_grad_(True) for a in args]
    out = face(*args)
    grads = torch.autograd.grad((out * torch.as_tensor(W)).sum(), args)
    return [_np(g) for g in grads]


def _rows_case(spec, params, X, mesh) -> dict:
    """The field sharded by rows: a `Shard(0)` DTensor X and the plain X
    give the same rows; the result's placements and local block; the
    grads of sum(Y^2) in the row-sharded X (each rank its rows)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fn = _fn("exp")
    Xt = torch.as_tensor(X)
    Xs = DTensor.from_local(Xt, mesh, [Replicate()], run_check=False
                            ).redistribute(mesh, [Shard(0)])
    with _Census() as c, torch.no_grad():
        Y = T.apply_sharded(spec, params, fn, Xs, mesh=mesh, device=CPU)
    plain = T.apply_sharded(spec, params, fn, Xt, mesh=mesh, device=CPU)
    Xg = Xs.detach().requires_grad_(True)
    Yg = T.apply_sharded(spec, params, fn, Xg, mesh=mesh, device=CPU)
    (Yg.to_local() ** 2).sum().backward()
    return {"placements": [repr(p) for p in Y.placements],
            "local": _np(Y.to_local()), "plain_local": _np(plain.to_local()),
            "whole": _np(Y), "census": c.summary(),
            "grad_placements": [repr(p) for p in Xg.grad.placements],
            "grad_local": _np(Xg.grad.to_local()), "grad_X": _np(Xg.grad)}


def rank_main(case: dict) -> dict:
    """Every sharded case of the test on this rank."""
    torch.manual_seed(0)
    mesh = M.make_plan_mesh(CPU)  # ("data",): D = world size
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}

    tree = TG.random_tree(257, seed=3)
    spec, params = T.build(tree, reweightable=True, device=CPU)
    X = case["X"]
    for name in ("exp", "cheb"):
        with _Census() as c:
            with torch.no_grad():
                Y = T.apply_sharded(spec, params, _fn(name), X, mesh=mesh,
                                    device=CPU)
        out[f"census_{name}"] = c.summary()
        out[f"tree_{name}"] = _np(Y)
    out["grads"] = _grads(spec, params, _fn("exp"), X, mesh)
    out["rows"] = _rows_case(spec, params, X, mesh)
    with sharding.use_sharding(mesh), torch.no_grad():
        pr = T.reweight(spec, torch.as_tensor(case["edge_w"]))
        out["reweighted"] = _np(T.apply_sharded(spec, pr, _fn("exp"), X))
        s2, p2 = T.update_plan(spec, params, [("insert_leaf", 5, 0.8)],
                               device=CPU)
        s2, p2 = T.update_plan(s2, p2, [("reweight", case["edge_w2"])],
                               device=CPU)
        out["updated"] = _np(T.apply(s2, p2, _fn("exp"), case["X2"],
                                     mesh=mesh, device=CPU))
        forest = TG.Forest([TG.random_tree(40 + 7 * i, seed=i)
                            for i in range(5)])
        fs, fp = T.build(forest, device=CPU)
        fp = dataclasses.replace(fp, tree_w=torch.as_tensor(case["tree_w"]))
        for name in ("exp", "cheb"):
            out[f"forest_{name}"] = _np(T.apply_sharded(
                fs, fp, _fn(name), case["Xf"], device=CPU))

    # one rank on the plan axis: the single-device result, bit for bit
    mesh1 = M.make_local_mesh(1, dist.get_world_size(), CPU)
    with torch.no_grad():
        got = T.apply_sharded(spec, params, _fn("exp"), X, mesh=mesh1,
                              device=CPU)
        want = T.apply(spec, params, _fn("exp"), X, device=CPU)
    out["world1_equal"] = bool(torch.equal(got.full_tensor(), want))

    # the kernel faces, on the ("data",) mesh of 4 and a (2, 2) mesh
    from repro_torch.kernels.fdist_matvec import ops as fdist_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    mesh2 = M.make_local_mesh(2, 2, CPU)
    x, y, v, coef = (torch.as_tensor(case[k]) for k in ("fx", "fy", "fv",
                                                         "fcoef"))
    out["fdist"] = {tag: _np(fdist_ops.fdist_matvec_batched_sharded(
        x, y, v, coef, mesh=m, mode="exp"))
        for tag, m in (("d4", mesh), ("d2m2", mesh2))}
    qf, kf, vv, co = (torch.as_tensor(case[k]) for k in ("qf", "kf", "vv",
                                                         "co"))
    out["topo"] = {}
    for tag, causal in (("causal", True), ("bidir", False)):
        out["topo"][tag] = _np(topo_ops.topo_linear_attention_sharded(
            qf, kf, vv, co, mesh=mesh2, g="exp", causal=causal))
    out["topo"]["h3"] = _np(topo_ops.topo_linear_attention_sharded(
        qf[:, :3], kf[:, :3], vv[:, :3], co[:3], mesh=mesh2, g="exp"))
    # each face's grads in every input: every rank holds the whole of each
    out["face_grads"] = {
        f"fdist_{tag}": _face_grads(
            lambda *a, m=m: fdist_ops.fdist_matvec_batched_sharded(
                *a, mesh=m, mode="exp"), (x, y, v, coef), case["fW"])
        for tag, m in (("d4", mesh), ("d2m2", mesh2))}
    out["face_grads"]["topo_causal"] = _face_grads(
        lambda *a: topo_ops.topo_linear_attention_sharded(
            *a, mesh=mesh2, g="exp", causal=True), (qf, kf, vv, co),
        case["tW"])
    out["face_grads"]["topo_h3"] = _face_grads(
        lambda *a: topo_ops.topo_linear_attention_sharded(
            *a, mesh=mesh2, g="exp", causal=False), (qf[:, :3], kf[:, :3],
                                                     vv[:, :3],
                                       co[:3]), case["tW"][:, :3])

    # TopoViT (smoke) with topo_shard_plan: weights from the test
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import vit as TV

    cfg = get_smoke_config("topovit_b16", dtype="float32",
                           topo_attn_impl="torch", topo_shard_plan=True)
    model = TV.from_state_dict(cfg, {k: torch.as_tensor(a)
                                     for k, a in case["vit_sd"].items()})
    with sharding.use_sharding(mesh), torch.no_grad(), _Census() as c:
        out["vit"] = _np(TV.forward(cfg, model, case["patches"], device=CPU))
    out["census_vit"] = c.summary()
    # the mask scalars' grads: every rank reads its own share of each
    # layer's coefficients, so their grads are summed over the ranks
    scalars = [t for blk in model.blocks
               for t in (blk.topo.coeffs, blk.topo.logit_scale)]
    with sharding.use_sharding(mesh):
        loss = (TV.forward(cfg, model, case["patches"], device=CPU)
                * torch.as_tensor(case["vit_W"])).sum()
        grads = torch.autograd.grad(loss, scalars)
    out["vit_grads"] = [_np(torch.cat([grads[2 * i].reshape(-1),
                                       grads[2 * i + 1].reshape(-1)]))
                        for i in range(len(model.blocks))]
    return out
