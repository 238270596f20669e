"""Quickstart: exact fast tree-field integration in five minutes.

    python -m repro_torch.examples.quickstart [--device cpu] [--n 6000]

The reference's examples/quickstart.py on the port. Its backends map as
the facade maps them: "plan" is "torch" (the plan executor's plain
engines), "pallas" is "cuda" (the fdist_matvec kernel, one launch per
cross bucket of the plan on the card; its plain version on the CPU).
Step 6 is the functional API as it stands without `jit`: `ftfi.build`,
`ftfi.fastmult`, and the edge-weight gradient through `ftfi.reweight` and
`torch.autograd.grad`."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import ftfi
from repro_torch.core import (BTFI, Exponential, Integrator, Polynomial,
                              Rational)
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import synthetic_graph
from repro_torch.graphs.mst import minimum_spanning_tree


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel_err(got, ref) -> float:
    got, ref = (torch.as_tensor(t).detach().double().cpu()
                for t in (got, ref))
    return float((got - ref).abs().max() / ref.abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=6000,
                    help="vertices of the graph of steps 1-4; steps 5-6 "
                         "take a graph of n / 4")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result: dict = {"n": args.n, "sub_n": args.n // 4}

    # 1. A graph: path + random extra edges (paper Sec 4.1). FTFI integrates
    #    on trees, so we approximate the graph metric with its MST metric.
    n = args.n
    tree = minimum_spanning_tree(synthetic_graph(n, n // 2, seed=0))

    # 2. A tensor field on the vertices.
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 8))

    # 3. Preprocess once (IntegratorTree, O(N log N)), integrate many times.
    #    One API, swappable structured-multiply backends:
    #      host   recursive numpy engines (exact; ExpMP fast path for exp)
    #      torch  plan executor on the card (exact LDR + Chebyshev)
    #      cuda   plan executor on the fdist_matvec CUDA kernel
    t0 = time.perf_counter()
    integ = Integrator(tree, backend="host", leaf_size=256)
    t_pre = time.perf_counter() - t0
    result["host_ms"] = {}
    for fn, name in [(Exponential(-0.5), "exp(-0.5 x)"),
                     (Polynomial((1.0, -0.3, 0.02)), "1 - 0.3x + 0.02x^2"),
                     (Rational((1.0,), (1.0, 0.0, 2.0)), "1/(1+2x^2)")]:
        t0 = time.perf_counter()
        integ.integrate(fn, X)
        t_fast = time.perf_counter() - t0
        engine = integ.describe(fn)["cross_engine"]
        result["host_ms"][name] = t_fast * 1e3
        print(f"f = {name:20s} integrated {n} vertices x 8 channels "
              f"in {t_fast*1e3:7.1f} ms  [{engine}]")

    # 4. Exactness: identical to brute force (materialized N x N kernel,
    #    float64 on the device: the reference's float32 distances meet its
    #    float64 field in a float64 product).
    t0 = time.perf_counter()
    btfi = BTFI(tree, dtype=torch.float64, device=dev)
    t_pre_b = time.perf_counter() - t0
    fn = Exponential(-0.5)
    t0 = time.perf_counter()
    ref = btfi.integrate(fn, X)
    _sync(dev)
    result["brute_ms"] = (time.perf_counter() - t0) * 1e3
    del btfi
    err = _rel_err(integ.integrate(fn, X), ref)
    result.update(host_rel_err=err, preprocess_s=t_pre,
                  btfi_preprocess_s=t_pre_b)
    print(f"\nexact vs brute force: rel err = {err:.2e}")
    print(f"preprocessing: Integrator {t_pre:.2f}s vs BTFI {t_pre_b:.2f}s "
          f"({t_pre_b/max(t_pre, 1e-9):.1f}x)")

    # 5. The plan backends agree too (built once, reused per field).
    sub_n = args.n // 4
    sub = minimum_spanning_tree(synthetic_graph(sub_n, sub_n // 2, seed=1))
    Xs = rng.normal(size=(sub_n, 8))
    ref = BTFI(sub, dtype=torch.float64, device=dev).integrate(fn, Xs)
    result["backends"] = {}
    for backend in ("torch", "cuda"):
        ii = Integrator(sub, backend=backend, leaf_size=64, device=dev)
        t0 = time.perf_counter()
        got = ii.integrate(fn, Xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        err = _rel_err(got, ref)
        engine = ii.describe(fn)["cross_engine"]
        result["backends"][backend] = {
            "rel_err": err, "ms": dt * 1e3, "engine": engine,
            "cross_buckets": len(ii.spec.cross_tgt_d0)}
        print(f"backend={backend:6s} rel err vs BTFI = {err:.2e}  "
              f"({dt*1e3:.1f} ms, engine={engine})")

    # 6. Functional plan API: a static PlanSpec and differentiable
    #    PlanParams. The pure (params, X) -> Y closure takes batched fields,
    #    checkpoints and serves the plan, and (with reweightable=True)
    #    trains the tree metric itself.
    spec, params = ftfi.build(sub, leaf_size=64, device=dev)
    fm = ftfi.fastmult(spec, fn, device=dev)
    err = _rel_err(fm(params, Xs), ref)
    result["fastmult_rel_err"] = err
    print(f"\nftfi.fastmult         rel err vs BTFI = {err:.2e}  [{spec!r}]")

    # learnable tree metric: gradients flow into edge weights via
    # ftfi.reweight
    small = minimum_spanning_tree(synthetic_graph(200, 100, seed=3))
    rspec, _ = ftfi.build(small, leaf_size=32, reweightable=True, device=dev)
    w = torch.tensor(small.weights, dtype=torch.float32, device=dev,
                     requires_grad=True)
    Xp = torch.as_tensor(rng.normal(size=(200, 4)), dtype=torch.float32,
                         device=dev)
    loss = (ftfi.apply(rspec, ftfi.reweight(rspec, w), fn, Xp,
                       device=dev) ** 2).sum()
    (g,) = torch.autograd.grad(loss, w)
    g1 = float(g.abs().sum())
    result.update(edge_grad_shape=tuple(g.shape), edge_grad_l1=g1,
                  edge_grad_finite=bool(torch.isfinite(g).all()))
    print(f"d(loss)/d(edge weights): shape={tuple(g.shape)}, "
          f"|g|_1={g1:.3g}  (tree metric is trainable)")
    return result


if __name__ == "__main__":
    main()
