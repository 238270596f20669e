"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, counted
per device, with no card and no memory: the reference's
`launch/dryrun.py`.

The reference AOT-lowers and compiles each cell on 512 fake CPU devices
(its `XLA_FLAGS` header forces them) and reads XLA's memory_analysis(),
cost_analysis() and the collectives of the compiled HLO. The port has no
compiler to ask, so in one process it:

  * starts a `"fake"` process group of the mesh's world size
    (`fake_group`: `torch.testing`'s `FakeStore`, this process rank 0; no
    `XLA_FLAGS` counterpart is needed);
  * builds the production mesh (`launch.mesh.make_production_mesh`, CPU);
  * makes every parameter a DTensor from a fake local shard of the shape
    `launch.sharding`'s rules give rank 0 (`DTensor.from_local`, no
    check), the batch (and a decode cell's cache) likewise by
    `launch.specs.batch_shardings`;
  * runs one step under `FakeTensorMode` inside a `roofline.count.CostCount`:
    the train step with its backward and AdamW, the prefill, or (a decode
    cell: decode_32k, long_500k) one `launch.steps.make_serve_step` call
    on the cache, token and pos that `launch.specs.batch_shardings` places
    (the batch over data, KV heads or channels over model where they
    divide, a batch-1 long context's sequence over data).

The count's record holds the reference's keys (flops, bytes accessed,
collective bytes, argument / output / temp bytes, the peak), per device.
The step runs the card's route: `cell_config` sets the kernel impls
(attn_impl and topo_attn_impl "cuda"); on fake tensors each kernel wrapper
takes its plain version for shapes and the count records the kernel's
formula (`roofline/kernels.py`), the work it reads on the card too. Eager
torch runs every layer, so nothing is counted once for many layers: the
count is at full depth (`cost_mode` "full-depth"). `extrapolated_cost`
(two reduced depths, extrapolated per layer) serves `launch.perf` and
`analyze_cell(extrapolate=True)`.
Results append to results/dryrun.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--variant full|topo|auto] [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import ARCHS, SHAPES, get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.specs import batch_shardings, batch_specs, params_shapes
from repro_torch.roofline.analysis import roofline_terms

DRY_ARCHS = [a for a in ARCHS if a != "topovit_b16"]

# archs that are natively sub-quadratic (run long_500k as-is); all others run
# long_500k under the paper's topo variant (DESIGN §5 long_500k policy)
NATIVE_SUBQUADRATIC = {"falcon_mamba_7b", "recurrentgemma_2b"}

MESHES = {"16x16": (False, 256), "2x16x16": (True, 512)}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A `"fake"` process group of `world_size` ranks in this one process
    (rank 0): collectives return at once and move nothing. Refuses when a
    group is already initialized; destroys its group on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "dry run needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_config(arch: str, shape: str, variant: str = "auto"):
    """The cell's config and a note, by the reference's variant policy,
    on the card's route: attn_impl and topo_attn_impl "cuda"."""
    cfg = get_config(arch)
    note = ""
    if variant == "auto":
        if shape == "long_500k" and arch not in NATIVE_SUBQUADRATIC:
            cfg = cfg.replace(attention_variant="topo",
                              topo_dist_scale=1.0 / SHAPES[shape]["seq_len"])
            note = "topo-variant (paper technique enables 500k decode)"
    elif variant != "full":
        cfg = cfg.replace(attention_variant=variant,
                          topo_dist_scale=1.0 / SHAPES[shape]["seq_len"])
        note = f"{variant}-variant"
    return cfg.replace(attn_impl="cuda", topo_attn_impl="cuda"), note


def lower_cell(arch: str, shape: str, mesh, variant: str = "auto"):
    """Returns (count, cfg, note): the cell's step counted by
    `lower_cell_cfg`."""
    cfg, note = cell_config(arch, shape, variant)
    return lower_cell_cfg(cfg, shape, mesh), cfg, note


def depth_variants(cfg):
    """Two reduced-depth configs for per-layer cost extrapolation.
    Returns (cfg_small, cfg_large, n_small, n_large, n_full)."""
    if cfg.family == "hybrid":
        return (cfg.replace(num_superblocks=1, scan_layers=False),
                cfg.replace(num_superblocks=2, scan_layers=False),
                1, 2, cfg.num_superblocks)
    if cfg.is_encdec:
        return (cfg.replace(encoder_layers=2, decoder_layers=2,
                            scan_layers=False),
                cfg.replace(encoder_layers=4, decoder_layers=4,
                            scan_layers=False),
                2, 4, cfg.encoder_layers)
    if cfg.family == "moe":
        fd = cfg.first_dense_layers
        return (cfg.replace(num_layers=fd + 1, scan_layers=False),
                cfg.replace(num_layers=fd + 3, scan_layers=False),
                fd + 1, fd + 3, cfg.num_layers)
    return (cfg.replace(num_layers=2, scan_layers=False),
            cfg.replace(num_layers=4, scan_layers=False),
            2, 4, cfg.num_layers)


def _cost_of(cfg, shape, mesh):
    rec = lower_cell_cfg(cfg, shape, mesh).record()
    return {k: rec[k] for k in ("flops", "bytes_accessed",
                                "collective_bytes")}


def extrapolated_cost(cfg, shape, mesh) -> dict:
    c_small, c_large, n_s, n_l, n_f = depth_variants(cfg)
    small = _cost_of(c_small, shape, mesh)
    large = _cost_of(c_large, shape, mesh)
    out = {}
    for k in small:
        # cost is monotone in depth, so clamp a negative per-layer delta
        per = max((large[k] - small[k]) / (n_l - n_s), 0.0)
        out[k] = max(small[k] + (n_f - n_s) * per, large[k])
    return out


def _local_shape(shape, pls, mesh) -> tuple:
    """A rank's shard of a tensor of global `shape` under placements (the
    rules shard only dims their mesh axes divide)."""
    out = list(shape)
    for j, pl in enumerate(pls):
        if pl.is_shard():
            out[pl.dim] //= mesh.size(j)
    return tuple(out)


def _fake_dtensor(like, pls, mesh):
    """A DTensor of `like`'s global shape and dtype whose local shard is a
    fake CPU tensor (allocates nothing). Call under FakeTensorMode."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(like.shape, pls, mesh), dtype=like.dtype,
                        device="cpu")
    return DTensor.from_local(local, mesh, pls, run_check=False)


def fake_sharded_model(cfg, mesh):
    """The config's model with every parameter a DTensor over `mesh` placed
    by the rules (`tree_param_specs`), its local shards fake. Call under
    FakeTensorMode and `use_sharding(mesh)`."""
    from torch import nn

    model = params_shapes(cfg)
    for name, spec in SH.tree_param_specs(model).items():
        owner, leaf = SH._owner(model, name)
        p = getattr(owner, leaf)
        owner.register_parameter(leaf, nn.Parameter(
            _fake_dtensor(p, SH.placements(spec, mesh), mesh),
            requires_grad=p.requires_grad))
    return model


def _fake_tree(specs, pls, mesh):
    if isinstance(specs, dict):
        return {k: _fake_tree(v, pls[k], mesh) for k, v in specs.items()}
    return _fake_dtensor(specs, pls, mesh)


def lower_cell_cfg(cfg, shape: str, mesh):
    """One step of the cell on `mesh` (a fake group of its world size must
    be initialized) under FakeTensorMode, counted: returns the
    `roofline.count.CostCount`, whose `record()` holds what the
    reference's compiled.cost_analysis() and memory_analysis() hold, per
    device: the train step, the prefill, or one decode step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.count import CostCount

    kind, cpu = SHAPES[shape]["kind"], "cpu"
    with SH.use_sharding(mesh), FakeTensorMode(allow_non_fake_inputs=True):
        model = fake_sharded_model(cfg, mesh)
        specs, pls = batch_specs(cfg, shape), batch_shardings(cfg, shape, mesh)
        batch = _fake_tree(specs, pls, mesh)
        if kind == "train":
            opt = adamw_init(dict(model.named_parameters()))
            with CostCount() as count:
                count.track_arguments(list(model.parameters()), opt, batch)
                out = make_train_step(cfg, AdamWConfig(), cpu)(
                    model, opt, batch)
                count.track_outputs(out[1:])
        elif kind == "prefill":
            with CostCount() as count:
                count.track_arguments(list(model.parameters()), batch)
                count.track_outputs(make_prefill_step(cfg, cpu)(
                    model, batch))
        else:  # decode: one token a row over the cell's cache
            step = make_serve_step(cfg, SHAPES[shape]["seq_len"], cpu)
            with CostCount() as count:
                count.track_arguments(list(model.parameters()), batch)
                count.track_outputs(step(model, batch["cache"],
                                         batch["token"], batch["pos"]))
    return count


def analyze_cell(arch: str, shape: str, mesh, mesh_name: str,
                 variant: str = "auto", extrapolate: bool = False) -> dict:
    """The cell's record: the count and its roofline terms. Eager torch
    counts every layer, so by default the count is the full-depth step's
    (`cost_mode` "full-depth"). `extrapolate=True` replaces its flops,
    bytes and collective bytes by `extrapolated_cost`'s, from two reduced
    depths (`cost_mode` "depth-extrapolated", the reference's default,
    whose scanned body counts one layer)."""
    t0 = time.time()
    count, cfg, note = lower_cell(arch, shape, mesh, variant)
    t_count = time.time() - t0
    n_chips = int(math.prod(mesh.shape))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "note": note,
           "variant": cfg.attention_variant,
           "compile_s": round(t_count, 1)}
    rec.update(count.record())
    rec["n_chips"] = n_chips
    rec["cost_mode"] = "full-depth"
    if extrapolate:
        rec.update(extrapolated_cost(cfg, shape, mesh))
        rec["cost_mode"] = "depth-extrapolated"
    rec.update(roofline_terms(rec, cfg, SHAPES[shape], n_chips))
    return rec


def production_mesh(multi: bool):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=multi, device_type="cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="auto")
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else DRY_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant_req", "auto"))
            for r in results}

    for mesh_name in meshes:
        multi, world = MESHES[mesh_name]
        with fake_group(world):
            mesh = production_mesh(multi)
            for arch in archs:
                for shape in shapes:
                    key = (arch, shape, mesh_name, args.variant)
                    if key in done:
                        continue
                    print(f"=== {arch} x {shape} x {mesh_name} ===",
                          flush=True)
                    try:
                        rec = analyze_cell(arch, shape, mesh, mesh_name,
                                           args.variant)
                        rec["variant_req"] = args.variant
                        rec["status"] = "ok"
                        print(f"  ok: {rec['compile_s']}s count, "
                              f"{rec['peak_bytes_per_device']/2**30:.2f} "
                              f"GiB/dev, flops={rec['flops']:.3e} "
                              f"coll={rec['collective_bytes']:.3e}",
                              flush=True)
                    except Exception as e:  # a cell that fails is recorded
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name,
                               "variant_req": args.variant,
                               "status": f"error: {type(e).__name__}: {e}"}
                    results.append(rec)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} cells ok -> {args.out}")


if __name__ == "__main__":
    main()
