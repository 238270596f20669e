"""§Perf hillclimbing driver: re-analyze a cell under config overrides and
append (hypothesis, before/after roofline terms) to results/perf.json: the
reference's `launch/perf.py` over the port's dry run (`launch.dryrun`: one
step on a fake process group under FakeTensorMode, counted per device).

  PYTHONPATH=src python -m repro_torch.launch.perf \
      --cell granite_34b:train_4k --tag chunked_attn --set attn_impl=chunked
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import (MESHES, cell_config,
                                       extrapolated_cost, fake_group,
                                       lower_cell_cfg, production_mesh)
from repro_torch.roofline.analysis import roofline_terms


def parse_val(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return v == "true"
    return v


def analyze_with_overrides(arch, shape, overrides, mesh):
    cfg, note = cell_config(arch, shape, "auto")
    if overrides:
        cfg = cfg.replace(**overrides)
    # full-depth count for memory analysis
    rec_full = lower_cell_cfg(cfg, shape, mesh).record()
    rec = {
        "arch": arch, "shape": shape, "overrides": overrides,
        "peak_bytes_per_device": rec_full["peak_bytes_per_device"],
    }
    rec.update(extrapolated_cost(cfg, shape, mesh))
    n_chips = int(math.prod(mesh.shape))
    rec["n_chips"] = n_chips
    rec.update(roofline_terms(rec, cfg, SHAPES[shape], n_chips))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", default="results/perf.json")
    args = ap.parse_args()
    arch, shape = args.cell.split(":")
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)
    with fake_group(MESHES["16x16"][1]):
        rec = analyze_with_overrides(arch, shape, overrides,
                                     production_mesh(False))
    rec["tag"] = args.tag
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: rec[k] for k in
                      ("tag", "compute_s", "memory_s", "collective_s",
                       "dominant", "useful_flops_ratio",
                       "peak_bytes_per_device")}, indent=1))


if __name__ == "__main__":
    main()
