#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port of FTFI runs on a CUDA card.

Run from the root of a checkout, on a machine with one CUDA card (Hopper,
sm_90a) and nvcc:

    python3 chip_smoke.py [--out results.json]

It builds the port's five CUDA kernels (fdist_matvec, the topological
linear-attention sweep, flash attention, causal linear attention and the
selective scan) from the repository's sources, in parallel, checks that
the flash attention library's bf16 kernel and the topo sweep and linear
attention libraries run on the tensor cores (HGMMA and HMMA instructions
in their SASS, `cuobjdump -sass`), and drives four paths.

FTFI: it holds the fdist_matvec kernel against its plain PyTorch version
on the card, drives `ftfi.build` (graph -> MST -> IT plan on the host) and
`ftfi.apply` on the card at the sizes of benchmarks/bench_ftfi_runtime.py
against the dense BTFI oracle, then times the kernel, its plain version
and one `torch.bmm` of the materialized M V at the plan's bucket shapes
(the single-job launch beside one `torch.mm`), and traces one `apply`
with torch.profiler. The kernel is listed twice, by d-tile: d = 4 (one
thread a row) and d = 64 (the register-blocked tile).

Topo-LM: it holds the sweep kernel against its plain version (decay and
rank mode, causal and the bidirectional pair) at the served layer's shape
and against the dense oracle at small shapes; serves 4 requests (prefill
into the cache, then 32 greedy decode steps at per-slot positions) of the
full-width Llama-3.2-1B with the paper's topological attention at mask
degree 1 (decay mode) and 2 (rank mode), with `topo_attn_impl="cuda"`
held against `"torch"` in float32; then times prefill, decode and the
kernel in bf16 (beside two bounds: fp32 outside the tensor cores, and the
3xTF32 products on them) and traces one prefill.

Dense LM: it holds the flash attention kernel (causal and not, f32 and
bf16, the served shape and a ragged L, and bf16 with peaked logits, q x 4)
and the linear attention kernel (lg = 0 and per head, on num and den)
against their plain versions on the card; serves the 4 requests of the
full-width Llama-3.2-1B as published (rope, softmax attention,
`attention_variant="full"`) and as a Performer (`"performer"`), with
`attn_impl="cuda"` held against `"chunked"` in float32; then times
prefill, decode and both kernels in bf16 (flash attention beside one
`scaled_dot_product_attention` call; linear attention beside three
bounds: bytes, 3xTF32 products on the tensor cores, fp32 FMAs outside
them) and traces one prefill and one decode step.

SSM LM: it holds the selective scan kernel against its plain chunked
version (the served shape with f32 and bf16 inputs, on y and h_final; a
ragged L = 1000, din = 200 at N = 4 and 16 with an h0) and against the
sequential oracle at small shapes; serves the 4 requests of the
full-width Falcon-Mamba-7B (64 Mamba-1 blocks, d_model 4096, d_inner
8192, N = 16), with `attn_impl="cuda"` held against `"chunked"` in
float32 (64 launches per prefill, none in decode); then, in bf16, serves
them again, times prefill, decode and the kernel (its bound with a third
term, the exps on the special function units at the card's SM clock)
and traces one prefill and one decode step.

Topo fft and TopoViT: it holds `topo_attention_train` with impl "fft"
(Alg. 1 with the Toeplitz-FFT FastMult, float64 FFTs) against the dense
oracle at the served topo-LM's width (degree 2 and 3, causal and
bidirectional, L = 1024) and times it beside the sweep kernel at L = 4096;
holds the full TopoViT-B/16 (12 layers, the grid-MST mask through the plan
executor's Hankel engine, which launches no kernel of the port) in float32
on impl "cuda" against "ref" on the card and against "torch" on the CPU at
2 images, and against "ref" at 64 (the field in several column chunks);
then serves a batch of 64 images in bf16, and the Performer variant at the
same shape: forward ms, images/s, peak memory, a profile of one forward and
the fastmult's share of its device time, the dense mask's forward for
scale, and the ops of one Hankel-engine call (the FFT's layout).

Training: every kernel wrapper is a torch.autograd.Function (forward the
kernel, backward its plain version's VJP; B1's v-grad the kernel with x
and y swapped). 3f holds each Function's grads against the plain path's
under the same upstream gradient (card-test shapes and the training
paths' shapes) and counts one launch per forward, none in the backward
but B1's, none on the plain path, and times each backward; 4f holds
`api.loss_fn` + backward in float32 through the kernels against the plain
impls from the same weights and batch (the topo Llama-3.2-1B at full
depth, degree 1 and 2; full, Performer and Falcon-Mamba-7B at full width
and 2 layers); 5f trains the paper's topological Llama-3.2-1B (degree 2,
bf16, batch 4 x 2048) for 6 steps through `train.loop.run_training`:
losses, step time, tokens/s, peak memory, the checkpoint's save time and
a bit-exact restore, and a profiled step.

Learnable metrics and plan maintenance (configuration (j): cell (a)'s
graph, its MST built reweightable): 4g holds `apply` on `ftfi.reweight`
of the build weights against the birth params, and the relative error of
the tree kernel's action against exp(lam D_G) X and its gradient in the
edge weights, "cuda" against "torch"; trains the edge weights 50 AdamW
steps on "cuda" (bench_learnable_f's flow; B1 counted per forward) and
fits the rational f of Sec 4.3 beside it. 4h edits the plan 64 times
through `update_plan` against a fresh build, round-trips it through the
disk plan cache (miss, bit-exact hit, corrupted entry rebuilt), runs the
plan guard, and injects a kernel failure and a NaN output into the
degradation ladder: on the card each raises (the ladder never moves card
tensors off the kernel), on a CPU copy of the plan each demotes once to
"torch" (the run fails on any other demotion). 5g times the step and its parts, `graph_all_pairs`,
`update_plan` against a rebuild, a cache hit against a build, and `apply`
"cuda" against "torch" for the `backend="auto"` threshold.

Any failed check raises and the script exits non-zero. It imports neither
jax nor the reference package `repro`.

Phases print one line each. The line before the last is the card's name
and power limit as nvidia-smi reports them; the line before that lists the
kernels with their launch counts on the main path and what each backward
runs; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and fp32 flop/s
# outside the tensor cores; the bound of a call is the larger of its bytes
# and its operations over these
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, in the tensor cores
TF32_FLOPS_PER_S = 495e12  # dense, in the tensor cores; 3xTF32 takes three
# exp2 results a clock on one SM's special function units (4 quadrants of
# 4, sm_90: CUDA C++ Programming Guide, arithmetic instruction throughput)
SFU_PER_CLOCK_PER_SM = 16

MODES = [("poly", (0.5, -0.2, 0.1)), ("exp", (-0.7, 1.3)),
         ("expq", (-0.05, -0.2, 0.1)), ("rational", (0.8,))]
# the (a, b, d) of tests/test_kernels.py::test_fdist_matvec
TEST_SHAPES = [(300, 200, 8), (128, 128, 4), (97, 33, 3), (64, 257, 16)]
FP32_TOL, BF16_TOL = 3e-6, 3e-2  # tests/test_kernels.py bounds
EXACT_TOL = 1e-5  # tests/test_forest.py / tests/test_plan_api.py bound

# the main path at the sizes users run (bench_ftfi_runtime.py: synthetic
# graphs of n vertices and n/2 extra edges, icosphere meshes; the forest of
# bench_graph_classification.make_dataset)
FULL = {"n": 10000, "extra": 5000, "leaf": 64, "widths": (4, 64),
        "ico": 5, "per_class": 30, "size_range": (24, 60), "forest_leaf": 16,
        "reps": 20}


def _f_ops(mode: str, k: int) -> int:
    """fp32 operations of one f(x + y): the add, then the family's ops
    (an exp or a division counted as one)."""
    return 1 + {"poly": 2 * k, "exp": 3, "expq": 6, "rational": 4}[mode]


def work(B, a, b, d, mode, k, v_bytes=4, out_bytes=4):
    """(bytes, operations) of one batched call: each input read once, the
    output written once; a*b evaluations of f plus a*b*d multiply-adds per
    job."""
    nbytes = 4 * (B * a + B * b + k) + v_bytes * B * b * d + out_bytes * B * a * d
    return nbytes, B * a * b * (2 * d + _f_ops(mode, k))


def bound(nbytes, ops, flops_per_s=FP32_FLOPS_PER_S):
    """(least time on an H100 in ms, what bounds it) for this much work,
    its operations at `flops_per_s` (fp32 outside the tensor cores unless
    given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int) -> float:
    """Device time per call of fn(), from CUDA events. The calls are queued
    behind a spin kernel, so the card runs them back to back and the time
    holds none of the host's launch gaps (small buckets take less time on
    the card than the host takes to launch them). Inputs stay in L2 from
    one call to the next."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # host time to enqueue one call sizes the spin
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(min(int(4e9 * reps * host_s), 2_000_000_000)
                      + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """End-to-end time per call of fn(), host clock, ending in a
    synchronize: what a caller of the entry point waits."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    props = torch.cuda.get_device_properties(0)
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "sms": props.multi_processor_count,
            "sm_clock_max_mhz": float(clock),
            "count": torch.cuda.device_count()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    print(f"[device] {info['name']} | nvidia-smi: {smi} | torch "
          f"{info['torch']} cuda {info['cuda']} | {info['sms']} SMs, max SM "
          f"clock {info['sm_clock_max_mhz']:.0f} MHz | "
          f"matmul.allow_tf32={info['allow_tf32']}", flush=True)
    return info


def phase_build():
    """Build every kernel of the port from the checkout, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.fdist_matvec import kernel as fdist_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.linear_attention import kernel as linear_kernel
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.topo_linear_attention import kernel as topo_kernel

    def one(mod):
        t0 = time.perf_counter()
        lib = mod.build()
        mod.library()
        return lib, time.perf_counter() - t0

    mods = {"fdist_matvec": fdist_kernel, "topo_sweep": topo_kernel,
            "flash_attention": flash_kernel,
            "linear_attention": linear_kernel,
            "selective_scan": scan_kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {name: ex.submit(one, mod) for name, mod in mods.items()}
        done = {name: f.result() for name, f in futs.items()}
    wall = time.perf_counter() - t0
    out = {}
    for name, mod in mods.items():
        lib, secs = done[name]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           mod.PTXAS_LOG)]
        spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores",
                                             mod.PTXAS_LOG)]
        out[name] = {"seconds": secs, "library": str(lib.relative_to(ROOT)),
                     "max_registers": max(regs, default=None),
                     "spill_store_bytes": sum(spills)}
        print(f"[build {name}] {out[name]['library']} in {secs:.1f} s | "
              f"ptxas: max {out[name]['max_registers']} registers/thread, "
              f"{out[name]['spill_store_bytes']} bytes of spill stores",
              flush=True)
    print(f"[build] {len(mods)} kernels in parallel, {wall:.1f} s wall",
          flush=True)
    out["wall_seconds"] = wall
    # the bf16 flash kernel (wgmma: HGMMA in the SASS), the topo sweep's and
    # the linear attention's tensor-core kernels (mma.sync: HMMA) must run
    # on the tensor cores
    from repro_torch.kernels import _nvcc

    cuobjdump = Path(_nvcc.nvcc()).with_name("cuobjdump")
    for name, op in (("flash_attention", "HGMMA"), ("topo_sweep", "HMMA"),
                     ("linear_attention", "HMMA")):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(ROOT / out[name]["library"])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        count = len(re.findall(rf"\b{op}\.", sass))
        out[name][f"{op.lower()}_instructions"] = count
        print(f"[build {name}] {count} {op} instructions in the SASS "
              "(cuobjdump -sass)", flush=True)
        if count == 0:
            raise AssertionError(f"the {name} library has no {op} "
                                 "instruction: its kernel is off the tensor "
                                 "cores")
    return out


def _check_one(x, y, v, cs, mode, single=False):
    """(rel err vs the plain version, abs err vs it, rel err vs the exact
    float64 product, the plain version's rel err vs that product, a
    diagnosis) of one kernel call. The plain version and the exact product
    are computed and synchronized before the kernel launches, so the
    reference is complete before the code under test runs. The diagnosis
    names the worst element (the kernel's, the plain and the exact value
    there) and holds a second plain computation against the kernel, so a
    failed check says which of the three results moved."""
    import torch
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.fdist_matvec.ref import (
        f_eval, fdist_matvec_batched_ref, fdist_matvec_ref)

    def plain():
        if single:
            return fdist_matvec_ref(x[0], y[0], v[0], cs, mode)[None]
        return fdist_matvec_batched_ref(x, y, v, cs, mode)

    want = plain()
    exact = torch.bmm(f_eval(x.double()[:, :, None] + y.double()[:, None, :],
                             cs.double(), mode), v.double())
    torch.cuda.synchronize()
    if single:
        got = ops.fdist_matvec(x[0], y[0], v[0], cs, mode)[None]
    else:
        got = ops.fdist_matvec_batched(x, y, v, cs, mode)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {tuple(got.shape)} {got.dtype}, "
                             f"plain {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"kernel gave non-finite values ({mode})")

    def diagnosis():
        at = tuple(int(i) for i in np.unravel_index(
            int((got.double() - want.double()).abs().argmax()),
            tuple(got.shape)))
        again = plain()
        torch.cuda.synchronize()
        return (f"worst at {at}: kernel "
                f"{float(got[at]):.6g}, plain {float(want[at]):.6g}, exact "
                f"{float(exact[at]):.6g}; plain computed again: rel err "
                f"{rel_err(got, again):.3e} vs the kernel, "
                f"{rel_err(again, want):.3e} vs the first plain")

    return (rel_err(got, want),
            float((got.double() - want.double()).abs().max()),
            rel_err(got, exact), rel_err(want, exact), diagnosis)


def phase_kernel_vs_plain(buckets, device):
    """Every mode at the test shapes (batched B=3 and one B=1 call each)
    and at the given main-path buckets (their real distances, random
    fields), fp32 and bf16 fields."""
    import torch

    rng = np.random.default_rng(0)
    rows = []
    cases = [("test", 3, a, b, d, None, None) for a, b, d in TEST_SHAPES]
    cases += [("test_B1", 1, a, b, d, None, None) for a, b, d in TEST_SHAPES]
    cases += [("bucket", bx.shape[0], bx.shape[1], by.shape[1], d, bx, by)
              for bx, by, d in buckets]
    for kind, B, a, b, d, bx, by in cases:
        if bx is None:
            x = torch.tensor(rng.uniform(0, 3, (B, a)), dtype=torch.float32,
                             device=device)
            y = torch.tensor(rng.uniform(0, 3, (B, b)), dtype=torch.float32,
                             device=device)
        else:
            x, y = bx, by
        v32 = torch.tensor(rng.normal(size=(B, b, d)), dtype=torch.float32,
                           device=device)
        for mode, coeffs in MODES:
            cs = torch.tensor(coeffs, dtype=torch.float32, device=device)
            for vdtype, tol in ((torch.float32, FP32_TOL),
                                (torch.bfloat16, BF16_TOL)):
                rel, ab, rel_x, plain_x, diagnosis = _check_one(
                    x, y, v32.to(vdtype), cs, mode, single=kind == "test_B1")
                if not (rel < tol and rel_x < tol):
                    raise AssertionError(
                        f"kernel {kind} (B={B}, a={a}, b={b}, d={d}) {mode} "
                        f"{vdtype}: rel err {rel:.3e} vs plain, {rel_x:.3e} "
                        f"vs exact; bound {tol}; {diagnosis()}")
                rows.append({"kind": kind, "B": B, "a": a, "b": b, "d": d,
                             "mode": mode, "dtype": str(vdtype).split(".")[1],
                             "rel_err": rel, "abs_err": ab,
                             "rel_err_exact": rel_x,
                             "plain_rel_err_exact": plain_x})
    def worst(key, dtype):
        return max(r[key] for r in rows if r["dtype"] == dtype)

    print(f"[kernel vs plain] {len(rows)} checks, 4 modes, "
          f"{len(cases)} shapes (B=1 included) | worst rel err fp32 "
          f"{worst('rel_err', 'float32'):.2e} vs plain, "
          f"{worst('rel_err_exact', 'float32'):.2e} vs exact (< {FP32_TOL}; "
          f"plain vs exact {worst('plain_rel_err_exact', 'float32'):.2e}); "
          f"bf16 {worst('rel_err', 'bfloat16'):.2e} vs plain (< {BF16_TOL})",
          flush=True)
    return rows


def synthetic_tree(cfg):
    from repro_torch.graphs.graph import synthetic_graph
    from repro_torch.graphs.mst import minimum_spanning_tree

    return minimum_spanning_tree(synthetic_graph(cfg["n"], cfg["extra"],
                                                 seed=1))


def families():
    from repro_torch.core import cordial as C

    return [("Exponential", C.Exponential(-0.5)),
            ("Polynomial", C.Polynomial((0.5, -0.2, 0.1))),
            ("ExpQuadratic", C.ExpQuadratic(-0.05, -0.2, 0.1)),
            ("Rational", C.Rational((1.0,), (1.0, 0.0, 0.8)))]


def _apply_checked(spec, params, fn, X, backend):
    """apply on the card; for backend "cuda", show that every cross bucket
    went through the kernel."""
    import torch
    from repro_torch import ftfi
    from repro_torch.kernels.fdist_matvec import ops

    before = ops.LAUNCHES
    Y = ftfi.apply(spec, params, fn, X, backend=backend, device=X.device)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES - before
    mode = ftfi.describe(spec, fn, backend=backend)["cross_engine"]
    if backend == "cuda" and launched != len(spec.cross_tgt_d0):
        raise AssertionError(
            f"{mode}: {launched} kernel launches for "
            f"{len(spec.cross_tgt_d0)} cross buckets")
    if Y.shape != X.shape or not bool(torch.isfinite(Y).all()):
        raise AssertionError(f"{mode}: bad output {tuple(Y.shape)}")
    return Y, launched, mode


def phase_tree(name, tree, fams, widths, cfg, device, exact_torch):
    """Build the plan on the host, apply both backends on the card, hold
    both against dense BTFI on the card."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core.integrate import BTFI

    t0 = time.perf_counter()
    spec, params = ftfi.build(tree, leaf_size=cfg["leaf"], device=device)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = BTFI(tree, device=device)
    t_dense = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    rows = []
    for d in widths:
        X = torch.tensor(rng.normal(size=(tree.num_vertices, d)),
                         dtype=torch.float32, device=device)
        for fname, fn in fams:
            want = dense.integrate(fn, X)
            y_cuda, launched, engine = _apply_checked(spec, params, fn, X,
                                                      "cuda")
            y_torch, _, engine_t = _apply_checked(spec, params, fn, X,
                                                  "torch")
            e_cuda, e_torch = rel_err(y_cuda, want), rel_err(y_torch, want)
            if not e_cuda <= EXACT_TOL:
                raise AssertionError(f"{name} {fname} d={d} cuda: rel err "
                                     f"{e_cuda:.3e} > {EXACT_TOL}")
            gated = fname in exact_torch
            if gated and not e_torch <= EXACT_TOL:
                raise AssertionError(f"{name} {fname} d={d} torch: rel err "
                                     f"{e_torch:.3e} > {EXACT_TOL}")
            rows.append({"tree": name, "family": fname, "d": d,
                         "engine_cuda": engine, "engine_torch": engine_t,
                         "launches": launched, "rel_err_cuda": e_cuda,
                         "rel_err_torch": e_torch, "torch_gated": gated})
            print(f"[main path {name}] n={tree.num_vertices} d={d} {fname}: "
                  f"cuda ({engine}, {launched} launches) rel err "
                  f"{e_cuda:.2e} | torch ({engine_t}) rel err {e_torch:.2e}"
                  f"{'' if gated else ' (approximation, not gated)'}",
                  flush=True)
    print(f"[main path {name}] plan build {t_build:.2f} s on the host, "
          f"{len(spec.cross_tgt_d0)} cross buckets, {spec.num_cross_jobs} "
          f"cross jobs, {len(spec.leaf_ids)} leaf buckets | dense oracle "
          f"set-up {t_dense:.2f} s", flush=True)
    return spec, params, dense, rows


def graph_dataset(cfg):
    """bench_graph_classification.make_dataset's graphs (3 families x
    per_class graphs of 24-60 vertices, seed 0)."""
    from repro_torch.graphs.graph import random_graph_family

    rng = np.random.default_rng(0)
    graphs = []
    for fam in ("ring_lattice", "pref_attach", "community"):
        for i in range(cfg["per_class"]):
            n = int(rng.integers(*cfg["size_range"]))
            # make_dataset(seed=0) seeds graph i with seed * 977 + i
            graphs.append(random_graph_family(fam, n, i))
    return graphs


def phase_forest(cfg, device):
    """One fused plan over the forest of MSTs, with per-tree weights,
    against the per-tree loop of apply on single trees. The field is
    bench_graph_classification.features_forest's block identity (N, n_max),
    which reads every graph's dense kernel off one multiply. That bench
    builds with leaf size 64, where every MST (<= 60 vertices) is one leaf
    and no cross job exists; `forest_leaf` splits the trees so that their
    cross jobs go through the kernel."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import Forest
    from repro_torch.graphs.mst import minimum_spanning_forest

    forest = Forest(minimum_spanning_forest(graph_dataset(cfg)))
    sizes, off = forest.tree_sizes, forest.offsets
    E = torch.zeros((forest.num_vertices, int(sizes.max())),
                    dtype=torch.float32, device=device)
    E[torch.arange(forest.num_vertices),
      torch.from_numpy(np.concatenate([np.arange(s) for s in sizes]))] = 1.0
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.uniform(0.5, 2.0, forest.num_trees),
                     dtype=torch.float32, device=device)
    fn = C.Exponential(-0.5)  # bench_graph_classification's heat kernel
    leaf = cfg["forest_leaf"]
    spec, params = ftfi.build(forest, leaf_size=leaf, device=device)
    params = ftfi.PlanParams(params.cross_tgt_d, params.cross_src_d,
                             params.leaf_dists, tree_w=w)
    Y, launched, engine = _apply_checked(spec, params, fn, E, "cuda")
    if launched == 0:
        raise AssertionError("the forest plan has no cross bucket")
    loop = []
    for t, tree in enumerate(forest.trees):
        s1, p1 = ftfi.build(tree, leaf_size=leaf, device=device)
        loop.append(w[t] * ftfi.apply(s1, p1, fn, E[off[t]:off[t + 1]],
                                      backend="cuda", device=device))
    err = rel_err(Y, torch.cat(loop))
    if not err <= EXACT_TOL:
        raise AssertionError(f"forest vs per-tree loop: rel err {err:.3e}")
    print(f"[main path forest] {forest.num_trees} MSTs, "
          f"{forest.num_vertices} vertices, leaf size {leaf}, block identity "
          f"field d={E.shape[1]}, tree_w: cuda ({engine}, {launched} "
          f"launches for {len(spec.cross_tgt_d0)} buckets) vs per-tree loop "
          f"rel err {err:.2e}", flush=True)
    return {"trees": forest.num_trees, "n": forest.num_vertices,
            "d": E.shape[1], "launches": launched, "rel_err": err}


def top_buckets(params, widths, count=3):
    """(x, y, d) of the `count` largest cross buckets (by B*Ut*Us) of a
    plan, for each width."""
    sizes = [x.numel() * y.shape[1] for x, y in zip(params.cross_tgt_d,
                                                     params.cross_src_d)]
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])[:count]
    return [(params.cross_tgt_d[i], params.cross_src_d[i], d)
            for d in widths for i in order]


def phase_times(spec, params, dense, cfg, device, card):
    """Per-bucket kernel / plain / bmm times and bounds, and whole-apply
    times, at the plan of phase 4(a) with Exponential(-0.5)."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.fdist_matvec.ref import (
        f_eval, fdist_matvec_batched_ref, fdist_matvec_ref)

    reps = cfg["reps"]
    fn = C.Exponential(-0.5)
    mode, coeffs = "exp", torch.tensor([-0.5, 1.0], device=device)
    rng = np.random.default_rng(11)
    out = {"card": card, "buckets": [], "apply": []}
    for d in cfg["widths"]:
        X = torch.tensor(rng.normal(size=(spec.n, d)), dtype=torch.float32,
                         device=device)
        for backend in ("cuda", "torch"):
            ms = host_ms(lambda: ftfi.apply(spec, params, fn, X,
                                            backend=backend, device=device),
                         reps)
            out["apply"].append({"d": d, "what": f"apply {backend}",
                                 "ms": ms})
        ms = host_ms(lambda: dense.integrate(fn, X), reps)
        out["apply"].append({"d": d, "what": "dense BTFI", "ms": ms})
        print(f"[times apply] d={d}: " + ", ".join(
            f"{r['what']} {r['ms']:.3f} ms" for r in out["apply"]
            if r["d"] == d) + f" | {card}", flush=True)
        for i, (x, y) in enumerate(zip(params.cross_tgt_d,
                                       params.cross_src_d)):
            B, a = x.shape
            b = y.shape[1]
            v = torch.tensor(rng.normal(size=(B, b, d)), dtype=torch.float32,
                             device=device)
            M = f_eval(x[:, :, None] + y[:, None, :], coeffs, mode)
            k_ms = device_ms(lambda: ops.fdist_matvec_batched(x, y, v, coeffs,
                                                            mode), reps)
            p_ms = device_ms(lambda: fdist_matvec_batched_ref(x, y, v, coeffs,
                                                            mode), reps)
            l_ms = device_ms(lambda: torch.bmm(M, v), reps)
            nbytes, ops_ = work(B, a, b, d, mode, 2)
            b_ms, b_by = bound(nbytes, ops_)
            del M
            row = {"bucket": i, "B": B, "a": a, "b": b, "d": d, "ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms, "bytes": nbytes,
                   "ops": ops_, "bound_ms": b_ms, "bound_by": b_by}
            out["buckets"].append(row)
            print(f"[times bucket] d={d} #{i} B={B} a={a} b={b}: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bmm {l_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}) | {card}", flush=True)
    # kernel 2 of the reference (single job) as the B = 1 launch, at the
    # first job of the widest bucket
    big = max(range(len(params.cross_tgt_d)),
              key=lambda i: params.cross_tgt_d[i].shape[1])
    x1, y1 = params.cross_tgt_d[big][0], params.cross_src_d[big][0]
    v1 = torch.tensor(rng.normal(size=(y1.shape[0], 4)), dtype=torch.float32,
                      device=device)
    M1 = f_eval(x1[:, None] + y1[None, :], coeffs, mode)
    single = {"a": x1.shape[0], "b": y1.shape[0], "d": 4,
              "ms": device_ms(lambda: ops.fdist_matvec(x1, y1, v1, coeffs,
                                                     mode), reps),
              "plain_ms": device_ms(lambda: fdist_matvec_ref(x1, y1, v1, coeffs,
                                                           mode), reps),
              # the yardstick of B1's bmm: one mm on a precomputed M
              "library_ms": device_ms(lambda: torch.mm(M1, v1), reps)}
    del M1
    single["bound_ms"], single["bound_by"] = bound(
        *work(1, single["a"], single["b"], 4, mode, 2))
    out["single"] = single
    print(f"[times single job] a={single['a']} b={single['b']} d=4: kernel "
          f"{single['ms']:.4f} ms, plain {single['plain_ms']:.4f} ms, mm "
          f"{single['library_ms']:.4f} ms, bound {single['bound_ms']:.5f} ms "
          f"| {card}", flush=True)
    return out


def phase_profile(spec, params, device, steps=10):
    """torch.profiler over `steps` calls of apply(backend="cuda") at d=4:
    device time per kernel name per call, and the device's busy share of
    the window's wall time (the profiler's own overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import ftfi
    from repro_torch.core import cordial as C

    fn = C.Exponential(-0.5)
    X = torch.tensor(np.random.default_rng(5).normal(size=(spec.n, 4)),
                     dtype=torch.float32, device=device)
    for _ in range(3):
        ftfi.apply(spec, params, fn, X, backend="cuda", device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ftfi.apply(spec, params, fn, X, backend="cuda", device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels.append({"name": ev.key[:90], "ms": us / 1e3 / steps,
                            "calls": ev.count / steps})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(k["ms"] for k in kernels)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy": device_ms / wall_ms, "kernels": kernels}
    print(f"[profile apply cuda d=4] wall {wall_ms:.3f} ms/call under the "
          f"profiler, device {device_ms:.3f} ms/call, busy share "
          f"{out['busy']:.2f}; top: " + "; ".join(
              f"{k['name'][:40]} {k['ms']:.3f} ms x{k['calls']:g}"
              for k in kernels[:6]), flush=True)
    return out


# ----------------------------------------------------------------------------
# slice 2: the topological Llama-3.2-1B served with the topo sweep kernel
# ----------------------------------------------------------------------------

# llama3_2_1b (src/repro_torch/configs/llama3_2_1b.py) at full width with the
# paper's topo attention; 4 requests right-padded to Lp, a cache of S
# positions for 32 decode steps
TOPO = {"arch": "llama3_2_1b", "lengths": (4096, 3001, 1537, 4096),
        "Lp": 4096, "S": 4128, "steps": 32, "gate_steps": 4,
        "degrees": (1, 2), "seed": 0,
        # (B, H, L, m, hd): the served layer's sweep, and two odd-L shapes
        # of tests/test_topo_attention.py
        "sweep_shapes": [(4, 32, 4096, 64, 64), (1, 2, 33, 4, 8),
                         (2, 2, 200, 4, 8)],
        "reps": 5, "prefill_reps": 3, "decode_reps": 10}
TOPO_PLAIN_TOL, TOPO_REF_TOL = 1e-4, 1e-3  # tests/test_topo_attention.py
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


def _topo_cfg(degree: int, impl: str = "cuda", dtype: str | None = None):
    from repro_torch.configs.base import get_config

    cfg = get_config(TOPO["arch"], attention_variant="topo", topo_g="exp",
                     topo_degree=degree, topo_attn_impl=impl,
                     topo_dist_scale=1.0 / TOPO["S"])
    return cfg.replace(dtype=dtype) if dtype else cfg


def _mask_coeffs(rng, H, degree, device):
    """Per-head mask scalars drawn as tests/test_topo_attention.py's
    _topo_params draws them (spread 0.5), shaped as
    attention.topo_mask_coeffs shapes them for g = exp."""
    import torch

    raw = torch.tensor(rng.uniform(-0.5, 0.5, (H, degree + 1)),
                       dtype=torch.float32, device=device)
    return torch.cat([raw[:, :1], -torch.nn.functional.softplus(raw[:, 1:])],
                     dim=1)


def topo_work(B, H, L, m, hd, C, R):
    """(bytes, operations) of one causal sweep: q, k, v, the mask pieces
    and the output each moved once; per (b, h, chunk) the causal half of
    q k^T and P v (C (C+1) / 2 pairs, what the mask needs), the row sums,
    and the state's read and write (2 C R m (hd + 1) operations each)."""
    nC = L // C
    tables = H if R == 0 else 2 * H * L * R
    nbytes = 4 * (2 * B * H * L * m + 2 * B * H * L * hd + H * C * C + tables)
    pairs = C * (C + 1) // 2
    r = max(R, 1)
    ops_ = B * H * nC * (pairs * (2 * m + 2 * hd + 2)
                         + 4 * C * r * m * (hd + 1) + 2 * C * hd)
    return nbytes, ops_


def _sweep_pieces(qf, kf, v, cs, dist_scale):
    """The kernel's inputs for one call of the fused forward (ops' own
    padding and mask tables): (qp, kp, vp, dmat_inc, mode kwargs, C)."""
    from repro_torch.kernels.topo_linear_attention import ops

    L = qf.shape[2]
    C = min(128, ops._round_up(L, 8))
    spec = ops.TopoSpec("exp", dist_scale, True, C, 16, 1e-6)
    qp, kp, vp, Lp = ops._pad_inputs(spec, qf, kf, v, cs)
    lg, alpha, beta, dmat, _ = ops._prepare(spec, cs, Lp)
    mode = (dict(log_gamma=lg) if lg is not None else
            dict(alpha=alpha.contiguous(), beta=beta.contiguous()))
    return qp, kp, vp, dmat.contiguous(), mode, C


def phase_topo_kernel_vs_plain(device):
    """3b: the sweep kernel against its plain version in decay and rank
    mode, causal and the bidirectional pair, at the served layer's shape
    and two odd-L test shapes; against the dense oracle at L <= 1024."""
    import torch
    from repro_torch.kernels.topo_linear_attention import ops
    from repro_torch.kernels.topo_linear_attention.ref import (
        topo_linear_attention_ref)

    rng = np.random.default_rng(13)
    rows, served = [], {}
    for shape in TOPO["sweep_shapes"]:
        B, H, L, m, hd = shape
        is_served = shape == TOPO["sweep_shapes"][0]
        ds = 1.0 / TOPO["S"] if is_served else 1.0 / L
        qf = torch.tensor(np.abs(rng.normal(size=(B, H, L, m))),
                          dtype=torch.float32, device=device)
        kf = torch.tensor(np.abs(rng.normal(size=(B, H, L, m))),
                          dtype=torch.float32, device=device)
        v = torch.tensor(rng.normal(size=(B, H, L, hd)), dtype=torch.float32,
                         device=device)
        for degree in TOPO["degrees"]:
            mode_name = "decay" if degree == 1 else "rank16"
            cs = _mask_coeffs(rng, H, degree, device)
            for causal in (True, False):
                kw = dict(g="exp", dist_scale=ds, causal=causal)
                got = ops.topo_linear_attention(qf, kf, v, cs,
                                                use_kernel=True, **kw)
                plain = ops.topo_linear_attention(qf, kf, v, cs,
                                                  use_kernel=False, **kw)
                torch.cuda.synchronize()
                if got.shape != plain.shape or not bool(
                        torch.isfinite(got).all()):
                    raise AssertionError(f"topo sweep {shape} {mode_name}: "
                                         f"bad output {tuple(got.shape)}")
                row = {"shape": shape, "mode": mode_name, "causal": causal,
                       "rel_err": rel_err(got, plain),
                       "abs_err": float((got - plain).abs().max()),
                       "rel_err_ref": None}
                if L <= 1024:
                    ref = topo_linear_attention_ref(qf, kf, v, cs, **kw)
                    row["rel_err_ref"] = rel_err(got, ref)
                if not row["rel_err"] <= TOPO_PLAIN_TOL or (
                        row["rel_err_ref"] is not None
                        and not row["rel_err_ref"] <= TOPO_REF_TOL):
                    raise AssertionError(f"topo sweep kernel {row}")
                rows.append(row)
            # the first sweep of the bidirectional pair, unnormalized
            qp, kp, vp, dmat, mode, C = _sweep_pieces(qf, kf, v, cs, ds)
            num, den = ops.topo_attention_sweep(qp, kp, vp, dmat,
                                                normalize=False, **mode)
            pnum, pden = ops._sweep(qp, kp, vp, dmat, mode.get("log_gamma"),
                                    mode.get("alpha"), mode.get("beta"))
            e_num, e_den = rel_err(num, pnum), rel_err(den, pden)
            if not (e_num <= TOPO_PLAIN_TOL and e_den <= TOPO_PLAIN_TOL):
                raise AssertionError(f"topo sweep {shape} {mode_name} "
                                     f"unnormalized: num {e_num:.2e}, den "
                                     f"{e_den:.2e}")
            rows.append({"shape": shape, "mode": mode_name,
                         "causal": "unnormalized", "rel_err": max(e_num,
                                                                  e_den),
                         "abs_err": float((num - pnum).abs().max()),
                         "rel_err_ref": None})
            if is_served:
                served[degree] = (qp, kp, vp, dmat, mode, C, shape)
    worst = max(r["rel_err"] for r in rows)
    worst_ref = max(r["rel_err_ref"] for r in rows
                    if r["rel_err_ref"] is not None)
    print(f"[topo kernel vs plain] {len(rows)} checks (decay and rank16; "
          f"causal, bidirectional pair, unnormalized sweep; shapes "
          f"{TOPO['sweep_shapes']}) | worst rel err {worst:.2e} vs plain "
          f"(< {TOPO_PLAIN_TOL}), {worst_ref:.2e} vs the dense oracle at "
          f"L <= 1024 (< {TOPO_REF_TOL})", flush=True)
    return rows, served


def _prompts(cfg):
    rng = np.random.default_rng(TOPO["seed"])
    lengths = np.array(TOPO["lengths"], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (len(lengths), TOPO["Lp"]))
    toks[np.arange(TOPO["Lp"])[None, :] >= lengths[:, None]] = 0
    return toks.astype(np.int32), lengths


def _serve(cfg, model, toks, lengths, steps, device, ops, feed=None):
    """prefill_into_cache, then `steps` decode steps at per-slot positions:
    greedy, or the tokens of `feed` (another run's) when given. Returns
    (prefill logits, prefill cache, step logits, fed tokens, launches of
    the kernel that `ops` counts in the prefill, and in the decode)."""
    import torch
    from repro_torch.models import api

    S = TOPO["S"]
    cache = api.init_cache(cfg, len(lengths), S, device=device)
    before = ops.LAUNCHES
    logits, cache = api.prefill_into_cache(cfg, model, cache, toks, lengths,
                                           S, device=device)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES - before
    prefill_cache = cache
    pos = torch.as_tensor(lengths, device=device).long()
    tok = logits.argmax(-1)[:, None] if feed is None else feed[0]
    step_logits, fed = [], [tok]
    before = ops.LAUNCHES
    for t in range(steps):
        lg, cache = api.decode_fn(cfg, model, cache, tok, pos, S,
                                  device=device)
        step_logits.append(lg)
        tok = lg[:, 0].argmax(-1)[:, None] if feed is None else feed[t + 1]
        fed.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    return (logits, prefill_cache, step_logits, fed, launched,
            ops.LAUNCHES - before)


def _check_served(cfg, logits, step_logits, fed):
    import torch

    V = cfg.padded_vocab()
    B = len(TOPO["lengths"])
    if logits.shape != (B, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    for lg in step_logits:
        if lg.shape != (B, 1, V) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"decode logits {tuple(lg.shape)}")
    toks = torch.cat(fed, dim=1)
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("a greedy token fell outside the vocabulary")


def phase_gate(label, cfg, plain_cfg, ops, device):
    """4b/4c gate: float32 (TF32 off), the same weights served through the
    kernel (`cfg`) and through its plain version (`plain_cfg`): prefill
    logits, cache and the first decode steps agree; one kernel launch per
    layer in the prefill, none in decode and none on the plain run; decode
    vs prefill of the extended prompt is printed, not gated."""
    import torch
    from repro_torch.models import api

    model = api.init_params(cfg, TOPO["seed"], device=device)
    toks, lengths = _prompts(cfg)
    n = TOPO["gate_steps"]
    got = _serve(cfg, model, toks, lengths, max(n, 2), device, ops)
    if got[4] != cfg.num_layers or got[5] != 0:
        raise AssertionError(f"{label} float32: {got[4]} kernel launches in "
                             f"the prefill for {cfg.num_layers} layers, "
                             f"{got[5]} in decode")
    want = _serve(plain_cfg, model, toks, lengths, n, device, ops,
                  feed=got[3])
    if want[4] or want[5]:
        raise AssertionError(f"{label}: the plain run launched the kernel")
    _check_served(cfg, got[0], got[2], got[3])
    e_logits = rel_err(got[0], want[0])
    e_cache = max(rel_err(got[1]["blocks0"][k], want[1]["blocks0"][k])
                  for k in got[1]["blocks0"])
    # the cache error of each layer, relative to the whole cache's max (the
    # gated measure): how the difference grows with depth
    top = {k: float(t.abs().max()) for k, t in want[1]["blocks0"].items()}
    by_layer = [max(float((got[1]["blocks0"][k][i].double()
                           - want[1]["blocks0"][k][i].double()).abs().max())
                    / max(top[k], 1e-30) for k in top)
                for i in range(cfg.num_layers)]
    e_steps = [rel_err(a, b) for a, b in zip(got[2][:n], want[2])]
    ok = (e_logits <= LOGIT_TOL and e_cache <= CACHE_TOL
          and max(e_steps) <= LOGIT_TOL)
    # decode vs prefill of the prompt extended by the fed tokens
    ext = np.zeros((len(lengths), TOPO["Lp"] + 2), np.int32)
    ext[:, :TOPO["Lp"]] = toks
    rows = np.arange(len(lengths))
    for k in (0, 1):
        ext[rows, lengths + k] = got[3][k][:, 0].cpu().numpy()
    e_dp = []
    for k in (1, 2):
        cache = api.init_cache(cfg, len(lengths), TOPO["S"], device=device)
        lg, _ = api.prefill_into_cache(cfg, model, cache, ext, lengths + k,
                                       TOPO["S"], device=device)
        e_dp.append(rel_err(got[2][k - 1][:, 0], lg))
    print(f"[{label} gate] float32, matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, depth {cfg.num_layers} "
          f"of {cfg.num_layers} layers, width {cfg.d_model}: kernel vs plain "
          f"prefill logits {e_logits:.2e} (< {LOGIT_TOL}), cache "
          f"{'/'.join(got[1]['blocks0'])} {e_cache:.2e} (< {CACHE_TOL}), "
          f"decode steps 1-{n} {max(e_steps):.2e} (< {LOGIT_TOL}); {got[4]} "
          f"launches in the prefill, {got[5]} in decode | not gated: decode "
          f"vs prefill of the extended prompt {e_dp[0]:.2e}, {e_dp[1]:.2e}; "
          f"cache error by depth: layer 0 {by_layer[0]:.1e}, layer "
          f"{len(by_layer) // 2} {by_layer[len(by_layer) // 2]:.1e}, layer "
          f"{len(by_layer) - 1} {by_layer[-1]:.1e}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel and plain paths disagree")
    return {"label": label, "dtype": "float32", "layers": cfg.num_layers,
            "rel_err_prefill_logits": e_logits, "rel_err_cache": e_cache,
            "rel_err_decode": e_steps, "rel_err_cache_by_layer": by_layer,
            "launches_per_prefill": got[4],
            "launches_in_decode": got[5], "decode_vs_prefill": e_dp}


def phase_serve(label, cfg, ops, device, card):
    """4b/4c main path + 5b/5c times at the config's dtype (bf16): 4
    requests, prefill_into_cache then 32 greedy decode steps, with the
    kernel count from 0 just before and read just after; then prefill and
    decode times and the profiles of one prefill and one decode step."""
    import torch
    from repro_torch.models import api

    model = api.init_params(cfg, TOPO["seed"], device=device)
    toks, lengths = _prompts(cfg)
    ops.LAUNCHES = 0
    by_mode = getattr(ops, "LAUNCHES_BY_MODE", {})
    for mode in by_mode:
        by_mode[mode] = 0
    t0 = time.perf_counter()
    logits, cache, step_logits, fed, _, _ = _serve(
        cfg, model, toks, lengths, TOPO["steps"], device, ops)
    serve_s = time.perf_counter() - t0
    launches = ops.LAUNCHES
    launches_by_mode = dict(by_mode)
    if launches != cfg.num_layers:
        raise AssertionError(f"{label}: {launches} kernel launches on the "
                             f"main path, expected {cfg.num_layers}")
    _check_served(cfg, logits, step_logits, fed)
    S, B = TOPO["S"], len(lengths)
    pre_ms = host_ms(lambda: api.prefill_into_cache(
        cfg, model, api.init_cache(cfg, B, S, device=device), toks, lengths,
        S, device=device), TOPO["prefill_reps"])
    tok, pos = fed[-1], torch.as_tensor(lengths, device=device).long() + 1
    dec_ms = host_ms(lambda: api.decode_fn(cfg, model, cache, tok, pos, S,
                                           device=device),
                     TOPO["decode_reps"])
    n_tok = int(lengths.sum())
    out = {"label": label, "dtype": cfg.dtype, "launches": launches,
           "launches_by_mode": launches_by_mode,
           "serve_seconds": serve_s, "prefill_ms": pre_ms,
           "prefill_tokens_per_s": n_tok / (pre_ms / 1e3),
           "decode_ms_per_step": dec_ms,
           "decode_tokens_per_s": B / (dec_ms / 1e3),
           "tokens": torch.cat(fed, 1)[:, :8].cpu().tolist(),
           "params": api.param_count(model), "card": card}
    kind = (cfg.attention_variant if cfg.family == "dense"
            else cfg.family)
    print(f"[{label} serve] {cfg.name} {kind}, {cfg.dtype}, "
          f"{cfg.num_layers} layers, {out['params']} params: 4 requests "
          f"(lengths {TOPO['lengths']}, S={S}), prefill + {TOPO['steps']} "
          f"greedy steps in {serve_s:.2f} s, {launches} kernel launches | "
          f"prefill {pre_ms:.1f} ms ({out['prefill_tokens_per_s']:.0f} "
          f"tok/s), decode {dec_ms:.2f} ms/step "
          f"({out['decode_tokens_per_s']:.0f} tok/s) | {card}", flush=True)
    out["profile_prefill"] = phase_calls_profile(
        f"{label} prefill", lambda: api.prefill_into_cache(
            cfg, model, api.init_cache(cfg, B, S, device=device), toks,
            lengths, S, device=device))
    out["profile_decode"] = phase_calls_profile(
        f"{label} decode step", lambda: api.decode_fn(
            cfg, model, cache, tok, pos, S, device=device), calls=4)
    return out


def phase_calls_profile(label, fn, calls=1, kinds=None):
    """torch.profiler over `calls` calls of fn(): device busy share of the
    window and the top device ops with their share of device time (per
    call); with `kinds` ({kind: substrings of op names}), also the device
    ms of every op by kind (the first kind that matches; "other" for
    none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    ops_ = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            ops_.append({"name": ev.key[:90], "ms": us / 1e3 / calls,
                         "calls": ev.count / calls})
    ops_.sort(key=lambda k: -k["ms"])
    dev_ms = sum(k["ms"] for k in ops_)
    for k in ops_:
        k["share"] = k["ms"] / dev_ms if dev_ms else 0.0
    out = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy": dev_ms / wall_ms, "launches": sum(k["calls"] for k in ops_),
           "ops": ops_[:12]}
    if kinds:
        out["kinds"] = {k: 0.0 for k in list(kinds) + ["other"]}
        for o in ops_:
            kind = next((k for k, subs in kinds.items()
                         if any(x in o["name"] for x in subs)), "other")
            out["kinds"][kind] += o["ms"]
    print(f"[profile {label}] wall {wall_ms:.2f} ms per call under the "
          f"profiler, device {dev_ms:.2f} ms, busy share {out['busy']:.2f}, "
          f"{out['launches']:.0f} device ops; top: " + "; ".join(
              f"{k['name'][:38]} {k['ms']:.2f} ms ({k['share']:.0%}) "
              f"x{k['calls']:g}" for k in ops_[:6]), flush=True)
    return out


def phase_topo_times(served, card, device):
    """5b: the sweep kernel's device time per launch at the served shape,
    for each mode, beside two bounds and its plain version's time; the
    dense oracle at L = 1024 for scale. The bounds: the work's bytes over
    HBM against its operations at fp32 outside the tensor cores (what a
    kernel of fp32 FMAs could reach), and against three TF32 products per
    fp32 product on the tensor cores (the 3xTF32 kernel's own bound)."""
    import torch
    from repro_torch.kernels.topo_linear_attention import ops
    from repro_torch.kernels.topo_linear_attention.ref import (
        topo_linear_attention_ref)

    reps = TOPO["reps"]
    out = {}
    for degree, (qp, kp, vp, dmat, mode, C, shape) in served.items():
        B, H, L, m, hd = shape
        R = 0 if "log_gamma" in mode else mode["alpha"].shape[-1]
        k_ms = device_ms(lambda: ops.topo_attention_sweep(qp, kp, vp, dmat,
                                                          **mode), reps)
        p_ms = device_ms(lambda: ops._emit(*ops._sweep(
            qp, kp, vp, dmat, mode.get("log_gamma"), mode.get("alpha"),
            mode.get("beta")), None, None, True, 1e-6), reps)
        nbytes, ops_ = topo_work(B, H, L, m, hd, C, R)
        b_ms, b_by = bound(nbytes, ops_, TF32_FLOPS_PER_S / 3)
        f_ms, f_by = bound(nbytes, ops_)
        name = "decay" if R == 0 else f"rank{R}"
        out[degree] = {"mode": name, "shape": shape, "C": C, "R": R,
                       "ms": k_ms, "plain_ms": p_ms, "bytes": nbytes,
                       "ops": ops_, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_fp32_ms": f_ms, "bound_fp32_by": f_by}
        print(f"[topo times {name}] B={B} H={H} L={L} m={m} hd={hd} C={C}: "
              f"kernel {k_ms:.3f} ms/launch, plain {p_ms:.3f} ms, bound "
              f"3xTF32 {b_ms:.3f} ms ({b_by}; {b_ms / k_ms:.0%} of it "
              f"reached), bound fp32 FMA {f_ms:.3f} ms ({f_by}), library "
              f"none | {card}", flush=True)
    rng = np.random.default_rng(3)
    B, H, _, m, hd = TOPO["sweep_shapes"][0]
    L = 1024
    q, k = (torch.tensor(np.abs(rng.normal(size=(B, H, L, m))),
                         dtype=torch.float32, device=device) for _ in range(2))
    v = torch.tensor(rng.normal(size=(B, H, L, hd)), dtype=torch.float32,
                     device=device)
    cs = _mask_coeffs(rng, H, 1, device)
    d_ms = device_ms(lambda: topo_linear_attention_ref(q, k, v, cs, g="exp",
                                                       dist_scale=1.0 / L),
                     reps)
    out["dense_ref_L1024_ms"] = d_ms
    print(f"[topo times dense oracle] B={B} H={H} L={L}: {d_ms:.3f} ms (for "
          f"scale only) | {card}", flush=True)
    return out


# ----------------------------------------------------------------------------
# slice 3: Llama-3.2-1B with full (rope + softmax) and Performer attention,
# served with the flash attention and linear attention kernels
# ----------------------------------------------------------------------------

# llama3_2_1b at full width, as published (rope 500000, GQA 32/8, head_dim
# 64), and its Performer variant (phi = relu); the requests of slice 2
DENSE = {"variants": ("full", "performer"),
         # (B, H, KV, L, hd): the served prefill's attention, and a ragged L
         "flash_shapes": [(4, 32, 8, 4096, 64), (4, 32, 8, 1000, 64)],
         # (B, H, L, m, hd): the served Performer prefill
         "linear_shape": (4, 32, 4096, 64, 64)}
FLASH_TOL = 2e-5  # tests/test_kernels.py::test_flash_attention, absolute
# bf16: one bf16 rounding of each output value (the spacing at |o| is at
# most 2^-7 |o|) on top of the float32 bound; on an H100 at the served shape
# the worst absolute difference read 1.95e-3
FLASH_BF16_ULP = 2.0 ** -7
LINEAR_TOL = 1e-5  # tests/test_kernels.py::test_linear_attention, relative


def bf16_roundings(got, want) -> float:
    """max over elements of |got - want| / (2^-7 max(|got|, |want|) + the
    float32 bound): at most 1 when the two differ by one bf16 rounding."""
    import torch

    got, want = got.float(), want.float()
    room = FLASH_BF16_ULP * torch.maximum(got.abs(), want.abs()) + FLASH_TOL
    return float(((got - want).abs() / room).max())


def _dense_cfg(variant: str, impl: str = "cuda", dtype: str | None = None):
    from repro_torch.configs.base import get_config

    cfg = get_config(TOPO["arch"], attention_variant=variant,
                     attn_impl=impl)
    return cfg.replace(dtype=dtype) if dtype else cfg


def _kernel_ops(variant: str):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linear_attention import ops as linear_ops

    return flash_ops if variant == "full" else linear_ops


def flash_work(B, H, KV, L, hd, causal, nbytes_el):
    """(bytes, operations) of one call: q, k, v and out each moved once;
    q k^T and P v over the (query, key) pairs the mask keeps (4 hd
    operations a pair; the softmax's exps not counted)."""
    pairs = L * (L + 1) // 2 if causal else L * L
    nbytes = nbytes_el * (2 * B * H * L * hd + 2 * B * KV * L * hd)
    return nbytes, B * H * pairs * 4 * hd


def linear_work(B, H, L, m, hd, v_bytes):
    """(bytes, operations) of one call: qf, kf (fp32), v, num and den (fp32)
    each moved once; the function's least operations, which do not depend
    on the kernel's chunk: those of a chunk of one row, per row the read of
    the state S, z and its update (4 m (hd + 1)) and the diagonal pair
    (2 m + 2 hd + 2)."""
    nbytes = (4 * 2 * B * H * L * m + v_bytes * B * H * L * hd
              + 4 * B * H * L * (hd + 1) + 4 * H)
    return nbytes, B * H * L * (4 * m * (hd + 1) + 2 * m + 2 * hd + 2)


def phase_attn_kernel_vs_plain(device):
    """3c: the flash attention kernel against its plain version at the
    served shape (causal and not, f32 and bf16) and at a ragged L, and
    against the dense oracle at L <= 1024; the linear attention kernel
    against its plain version at the served Performer shape, lg = 0 and
    per-head lg in [-0.05, 0), f32 and bf16 v, on num and on den, and
    against the dense oracle on four of its heads."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.linear_attention import ops as linear_ops
    from repro_torch.kernels.linear_attention.ref import linear_attention_ref

    rng = np.random.default_rng(17)
    rows, served = [], {}
    for B, H, KV, L, hd in DENSE["flash_shapes"]:
        base = [torch.tensor(rng.normal(size=(B, n, L, hd)),
                             dtype=torch.float32, device=device)
                for n in (H, KV, KV)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)
            for causal in (True, False):
                got = flash_ops.flash_attention(q, k, v, causal)
                plain = flash_ops.flash_attention(q, k, v, causal,
                                                  use_kernel=False)
                torch.cuda.synchronize()
                if got.shape != q.shape or got.dtype != dtype or not bool(
                        torch.isfinite(got.float()).all()):
                    raise AssertionError(f"flash kernel: bad output "
                                         f"{tuple(got.shape)} {got.dtype}")
                want = {"plain": plain}
                if L <= 1024:
                    G = H // KV
                    want["ref"] = attention_ref(
                        q, k.repeat_interleave(G, 1),
                        v.repeat_interleave(G, 1), causal)
                row = {"kernel": "flash_attention", "shape": (B, H, KV, L, hd),
                       "dtype": str(dtype).split(".")[1], "causal": causal,
                       "abs_err": float((got.float() - plain.float()).abs()
                                        .max()), "abs_err_ref": None}
                if "ref" in want:
                    row["abs_err_ref"] = float(
                        (got.float() - want["ref"].float()).abs().max())
                if dtype == torch.float32:
                    ok = all(float((got - w).abs().max()) <= FLASH_TOL
                             for w in want.values())
                else:  # held per value: at most one bf16 rounding apart
                    row["bf16_roundings"] = max(bf16_roundings(got, w)
                                                for w in want.values())
                    ok = row["bf16_roundings"] <= 1.0
                if not ok:
                    raise AssertionError(f"flash kernel {row} (bound "
                                         f"{FLASH_TOL} in float32, one bf16 "
                                         "rounding in bfloat16)")
                rows.append(row)
                if L == DENSE["flash_shapes"][0][3]:
                    served[("flash", row["dtype"], causal)] = (q, k, v)
            del q, k, v
    # peaked logits (q x 4) in bf16 at the served shape: the softmax's
    # weights concentrate, where one bf16 rounding of P would show most
    B, H, KV, L, hd = DENSE["flash_shapes"][0]
    q = torch.tensor(rng.normal(size=(B, H, L, hd)) * 4.0,
                     dtype=torch.bfloat16, device=device)
    k, v = (torch.tensor(rng.normal(size=(B, KV, L, hd)),
                         dtype=torch.bfloat16, device=device)
            for _ in range(2))
    for causal in (True, False):
        got = flash_ops.flash_attention(q, k, v, causal)
        plain = flash_ops.flash_attention(q, k, v, causal, use_kernel=False)
        torch.cuda.synchronize()
        row = {"kernel": "flash_attention", "shape": (B, H, KV, L, hd),
               "dtype": "bfloat16", "causal": causal, "peaked": True,
               "abs_err": float((got.float() - plain.float()).abs().max()),
               "abs_err_ref": None,
               "bf16_roundings": bf16_roundings(got, plain)}
        if not (bool(torch.isfinite(got.float()).all())
                and row["bf16_roundings"] <= 1.0):
            raise AssertionError(f"flash kernel, peaked logits: {row} (bound "
                                 "one bf16 rounding)")
        rows.append(row)
    del q, k, v
    B, H, L, m, hd = DENSE["linear_shape"]
    qf, kf = (torch.tensor(np.abs(rng.normal(size=(B, H, L, m))),
                           dtype=torch.float32, device=device)
              for _ in range(2))
    v32 = torch.tensor(rng.normal(size=(B, H, L, hd)), dtype=torch.float32,
                       device=device)
    gammas = {"lg0": torch.zeros(H, device=device),
              "lg_perhead": torch.tensor(-rng.uniform(1e-4, 0.05, H),
                                         dtype=torch.float32, device=device)}
    for name, lg in gammas.items():
        for v in (v32, v32.to(torch.bfloat16)):
            num, den = linear_ops.linear_attention(qf, kf, v, lg)
            pnum, pden = linear_ops.linear_attention(qf, kf, v, lg,
                                                     use_kernel=False)
            # the dense O(L^2) oracle over the whole length, on the first
            # batch row's first 4 heads (their scores take 268 MB)
            rnum, rden = linear_attention_ref(qf[:1, :4], kf[:1, :4],
                                              v[:1, :4], lg[:4])
            torch.cuda.synchronize()
            e_num, e_den = rel_err(num, pnum), rel_err(den, pden)
            r_num = rel_err(num[:1, :4], rnum)
            r_den = rel_err(den[:1, :4], rden)
            row = {"kernel": "linear_attention", "shape": (B, H, L, m, hd),
                   "dtype": str(v.dtype).split(".")[1], "gamma": name,
                   "rel_err_num": e_num, "rel_err_den": e_den,
                   "rel_err_num_ref": r_num, "rel_err_den_ref": r_den,
                   "abs_err": float((num - pnum).abs().max()),
                   "den_min": float(pden.min())}
            if not max(e_num, e_den, r_num, r_den) <= LINEAR_TOL:
                raise AssertionError(f"linear attention kernel {row} "
                                     f"(bound {LINEAR_TOL})")
            rows.append(row)
            served[("linear", row["dtype"], name)] = (qf, kf, v, lg)
    fl = [r for r in rows if r["kernel"] == "flash_attention"]
    li = [r for r in rows if r["kernel"] == "linear_attention"]
    f32, bf16 = (max(r["abs_err"] for r in fl if r["dtype"] == dt)
                 for dt in ("float32", "bfloat16"))
    roundings = max(r["bf16_roundings"] for r in fl
                    if r["dtype"] == "bfloat16" and not r.get("peaked"))
    peaked = max(r["bf16_roundings"] for r in fl if r.get("peaked"))
    vs_ref = max(r["abs_err_ref"] for r in fl if r["abs_err_ref"] is not None
                 and r["dtype"] == "float32")
    print(f"[attn kernels vs plain] flash: {len(fl)} checks (shapes "
          f"{DENSE['flash_shapes']}, causal and not, f32/bf16) | worst abs "
          f"err f32 {f32:.2e} (< {FLASH_TOL}), vs the dense oracle at "
          f"L <= 1024 {vs_ref:.2e}; bf16 {bf16:.2e} abs, {roundings:.3f} of "
          f"one bf16 rounding of the value (<= 1), peaked logits (q x 4) "
          f"{peaked:.3f}"
          f" | linear: {len(li)} checks at {DENSE['linear_shape']} (lg 0 and "
          f"per head, f32/bf16 v) | worst rel err num "
          f"{max(r['rel_err_num'] for r in li):.2e}, den "
          f"{max(r['rel_err_den'] for r in li):.2e}; vs the dense oracle "
          f"(b 0, heads 0-3) num {max(r['rel_err_num_ref'] for r in li):.2e},"
          f" den {max(r['rel_err_den_ref'] for r in li):.2e} (< "
          f"{LINEAR_TOL})", flush=True)
    return rows, served


def phase_attn_times(served, card):
    """5c: each kernel's device time per launch at the served shape, beside
    its bound, its plain version's time and, for flash attention, one
    `scaled_dot_product_attention` call on the same inputs (a yardstick,
    never on the path). Linear attention's bound is the work's bytes over
    HBM against its operations as 3xTF32 products on the tensor cores (the
    kernel's route); its operations as fp32 FMAs outside them beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linear_attention import kernel as linear_kernel
    from repro_torch.kernels.linear_attention import ops as linear_ops

    reps = TOPO["reps"]
    out = {}
    B, H, KV, L, hd = DENSE["flash_shapes"][0]
    for dtype in ("bfloat16", "float32"):
        for causal in (True, False):
            q, k, v = served[("flash", dtype, causal)]
            k_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                               causal), reps)
            p_ms = device_ms(lambda: flash_ops.flash_attention(
                q, k, v, causal, use_kernel=False), 2)
            l_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps)
            nbytes, ops_ = flash_work(B, H, KV, L, hd, causal,
                                      q.element_size())
            b_ms, b_by = bound(nbytes, ops_, BF16_FLOPS_PER_S
                               if dtype == "bfloat16" else FP32_FLOPS_PER_S)
            key = f"flash_{'causal' if causal else 'full'}_{dtype}"
            out[key] = {"shape": (B, H, KV, L, hd), "dtype": dtype,
                        "causal": causal, "ms": k_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "bytes": nbytes, "ops": ops_,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bound_fp32_ms": ops_ / FP32_FLOPS_PER_S * 1e3}
            print(f"[attn times flash {'causal' if causal else 'full'} "
                  f"{dtype}] B={B} H={H} KV={KV} L={L} hd={hd}: kernel "
                  f"{k_ms:.3f} ms/launch, plain {p_ms:.3f} ms, sdpa "
                  f"{l_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; fp32 "
                  f"operations {out[key]['bound_fp32_ms']:.3f} ms) | {card}",
                  flush=True)
    B, H, L, m, hd = DENSE["linear_shape"]
    C = linear_kernel.CHUNK
    for name in ("lg0", "lg_perhead"):
        qf, kf, v, lg = served[("linear", "bfloat16", name)]
        k_ms = device_ms(lambda: linear_ops.linear_attention(qf, kf, v, lg),
                         reps)
        p_ms = device_ms(lambda: linear_ops.linear_attention(
            qf, kf, v, lg, use_kernel=False), 2)
        nbytes, ops_ = linear_work(B, H, L, m, hd, v.element_size())
        b_ms, b_by = bound(nbytes, ops_, TF32_FLOPS_PER_S / 3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        tf32_ms = ops_ / (TF32_FLOPS_PER_S / 3) * 1e3
        fp32_ms = ops_ / FP32_FLOPS_PER_S * 1e3
        out[f"linear_{name}"] = {
            "shape": (B, H, L, m, hd), "C": C, "td":
                linear_kernel.TD, "v_dtype": "bfloat16",
            "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
            "bytes": nbytes, "ops": ops_, "bound_ms": b_ms,
            "bound_by": b_by, "bytes_ms": bytes_ms, "tf32x3_ms": tf32_ms,
            "bound_fp32_ms": max(bytes_ms, fp32_ms), "fp32_ms": fp32_ms}
        print(f"[attn times linear {name}] B={B} H={H} L={L} m={m} hd={hd} "
              f"C={C}, bf16 v: kernel {k_ms:.3f} ms/launch, plain "
              f"{p_ms:.3f} ms | bounds: bytes {bytes_ms:.3f} ms, 3xTF32 "
              f"{tf32_ms:.3f} ms, fp32 FMA {fp32_ms:.3f} ms: bound "
              f"{b_ms:.3f} ms ({b_by}; {b_ms / k_ms:.0%} of it reached), "
              f"library none | {card}", flush=True)
    return out


# ----------------------------------------------------------------------------
# slice 4: Falcon-Mamba-7B served with the selective scan kernel
# ----------------------------------------------------------------------------

# falcon_mamba_7b at full width (64 Mamba-1 blocks, d_model 4096, d_inner
# 8192, N = 16, dt_rank 256, vocab 65,024), full depth; the requests of
# slice 2
SSM = {"arch": "falcon_mamba_7b",
       # (Bt, L, din, N): the served prefill's scan
       "served_shape": (4, 4096, 8192, 16),
       # a ragged L and din, with an h0
       "ragged_shapes": [(2, 1000, 200, 4), (2, 1000, 200, 16)],
       # tests/test_kernels.py::test_selective_scan's (Bt, L, din, N)
       "oracle_shapes": [(2, 64, 32, 8), (2, 128, 64, 16)]}
SCAN_REL_TOL = 1e-5  # at the served shape, relative to max
SCAN_ABS_TOL = 2e-5  # tests/test_kernels.py::test_selective_scan


def _ssm_cfg(impl: str = "cuda", dtype: str | None = None):
    from repro_torch.configs.base import get_config

    cfg = get_config(SSM["arch"], attn_impl=impl)
    return cfg.replace(dtype=dtype) if dtype else cfg


def scan_work(Bt, L, din, N, in_bytes):
    """(bytes, fp32 operations, exps) of one scan from h0 = 0: u, dt, B, C
    (in_bytes each), A, D read once, y and h_final (fp32) written once; per
    state update dt A, the state's multiply-add and C h's (5 operations) and
    one exp; per (b, t, d) dt u, D u and its add (3)."""
    nbytes = (in_bytes * (2 * Bt * L * din + 2 * Bt * L * N)
              + 4 * (din * N + din + Bt * L * din + Bt * din * N))
    updates = Bt * L * din * N
    return nbytes, 5 * updates + 3 * Bt * L * din, updates


def scan_bound(nbytes, ops_, exps, sms, clock_mhz):
    """(least time in ms, "bytes" or "operations", the binding term): the
    larger of bytes over HBM, fp32 operations over the fp32 peak, and exps
    over the special function units (SFU_PER_CLOCK_PER_SM a clock on each
    of `sms` SMs at the card's maximum SM clock)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "fp32 operations": ops_ / FP32_FLOPS_PER_S,
             "sfu exps": exps / (SFU_PER_CLOCK_PER_SM * sms
                                 * clock_mhz * 1e6)}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            term, {k: v * 1e3 for k, v in terms.items()})


def _scan_inputs(rng, shape, dtype, device):
    """u, dt, A, B, C, D drawn as tests/test_kernels.py draws them; u, dt,
    B and C in `dtype`."""
    import torch

    Bt, L, din, N = shape

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32, device=device).to(dt)

    return (t(rng.standard_normal((Bt, L, din), np.float32), dtype),
            t(np.abs(rng.standard_normal((Bt, L, din), np.float32)) * 0.1,
              dtype),
            t(-np.abs(rng.standard_normal((din, N), np.float32)) - 0.1),
            t(rng.standard_normal((Bt, L, N), np.float32), dtype),
            t(rng.standard_normal((Bt, L, N), np.float32), dtype),
            t(rng.standard_normal(din, np.float32)))


def phase_scan_kernel_vs_plain(device):
    """3d: the selective scan kernel against its plain chunked version at
    the served shape (f32 and bf16 u, dt, B, C; y and h_final within
    SCAN_REL_TOL of their max) and at a ragged L and din with an h0
    (SCAN_ABS_TOL); against the sequential oracle at the ragged and the
    test shapes (SCAN_ABS_TOL)."""
    import torch
    from repro_torch.kernels.selective_scan import ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    rng = np.random.default_rng(19)
    rows, served = [], {}
    cases = [("served", SSM["served_shape"], dt, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("ragged", s, dt, True) for s in SSM["ragged_shapes"]
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("test", s, torch.float32, False) for s in SSM["oracle_shapes"]]
    for kind, shape, dtype, with_h0 in cases:
        Bt, L, din, N = shape
        args = _scan_inputs(rng, shape, dtype, device)
        h0 = (torch.tensor(rng.standard_normal((Bt, din, N), np.float32),
                           device=device) if with_h0 else None)
        y, h = ops.scan(*args, h0=h0)
        torch.cuda.synchronize()
        if (y.shape != (Bt, L, din) or h.shape != (Bt, din, N)
                or not bool(torch.isfinite(y).all())
                or not bool(torch.isfinite(h).all())):
            raise AssertionError(f"scan kernel {kind} {shape}: bad output "
                                 f"{tuple(y.shape)}, {tuple(h.shape)}")
        want = {}
        if kind != "test":
            want["plain"] = ops.scan(*args, h0=h0, use_kernel=False)
        if kind != "served":
            want["oracle"] = selective_scan_ref(*args, h0=h0)
        row = {"kind": kind, "shape": shape,
               "dtype": str(dtype).split(".")[1], "h0": with_h0}
        for name, (wy, wh) in want.items():
            row[f"abs_err_{name}"] = max(float((y - wy).abs().max()),
                                         float((h - wh).abs().max()))
            row[f"rel_err_{name}"] = max(rel_err(y, wy), rel_err(h, wh))
            ok = (row[f"rel_err_{name}"] <= SCAN_REL_TOL if kind == "served"
                  else row[f"abs_err_{name}"] <= SCAN_ABS_TOL)
            if not ok:
                raise AssertionError(f"selective scan kernel {row} (bound "
                                     f"{SCAN_REL_TOL} relative at the served "
                                     f"shape, {SCAN_ABS_TOL} absolute else)")
        del want
        rows.append(row)
        if kind == "served":
            served[row["dtype"]] = args
        del y, h
    srv = [r for r in rows if r["kind"] == "served"]
    ragged = max(r["abs_err_plain"] for r in rows if r["kind"] == "ragged")
    oracle = max(r["abs_err_oracle"] for r in rows if "abs_err_oracle" in r)
    print(f"[scan kernel vs plain] {len(rows)} checks | served "
          f"{SSM['served_shape']}: " + ", ".join(
              f"{r['dtype']} rel err {r['rel_err_plain']:.2e} (abs "
              f"{r['abs_err_plain']:.2e})" for r in srv)
          + f" (< {SCAN_REL_TOL}) | ragged {SSM['ragged_shapes']} with h0: "
          f"worst abs err {ragged:.2e} vs plain | vs the sequential oracle "
          f"(ragged and {SSM['oracle_shapes']}): worst abs err {oracle:.2e} "
          f"(< {SCAN_ABS_TOL})", flush=True)
    return rows, served


def phase_scan_times(served, info, card):
    """5d: the scan kernel's device time per launch at the served shape,
    f32 and bf16 inputs, beside its plain version's time and its bound
    (bytes, fp32 operations, or the exps on the SFUs). No single PyTorch
    call computes the scan, so there is no library time."""
    from repro_torch.kernels.selective_scan import ops

    Bt, L, din, N = SSM["served_shape"]
    out = {}
    for dtype, args in served.items():
        k_ms = device_ms(lambda: ops.scan(*args), TOPO["reps"])
        p_ms = device_ms(lambda: ops.scan(*args, use_kernel=False), 2)
        nbytes, ops_, exps = scan_work(Bt, L, din, N,
                                       args[0].element_size())
        b_ms, b_by, term, terms = scan_bound(nbytes, ops_, exps, info["sms"],
                                             info["sm_clock_max_mhz"])
        out[dtype] = {"shape": (Bt, L, din, N), "dtype": dtype, "ms": k_ms,
                      "plain_ms": p_ms, "library_ms": None, "bytes": nbytes,
                      "ops": ops_, "exps": exps, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_term": term,
                      "bound_terms_ms": terms}
        print(f"[scan times {dtype}] Bt={Bt} L={L} din={din} N={N}: kernel "
              f"{k_ms:.3f} ms/launch, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({term}; bytes {terms['bytes']:.3f}, fp32 "
              f"operations {terms['fp32 operations']:.3f}, sfu exps "
              f"{terms['sfu exps']:.3f} ms at {info['sm_clock_max_mhz']:.0f} "
              f"MHz), library none | {card}", flush=True)
    return out


# ----------------------------------------------------------------------------
# slice 8: the Toeplitz-FFT topo impl, and TopoViT-B/16 served through Alg. 1
# with the plan FastMult (no kernel of the port on this path)
# ----------------------------------------------------------------------------

# topovit_b16 (src/repro_torch/configs/topovit_b16.py) at full width and
# depth: 224 x 224 images as 196 patches of 16 x 16 x 3 = 768 values
VIT = {"arch": "topovit_b16", "patch_dim": 768, "classes": 1000,
       "gate_batch": 2, "serve_batch": 64, "seed": 0, "reps": 3,
       # the topo-LM layer of phase 3e: (B, L) checked, (B, L) timed
       "fft_check": (4, 1024), "fft_time": (4, 4096), "fft_degrees": (2, 3)}
FFT_REF_TOL = 1e-3  # tests/test_topo_attention.py:81, relative to max
VIT_REF_TOL, VIT_CPU_TOL = 1e-3, 1e-4  # tests/test_topo_attention.py:132
LAYOUT_OPS = {"aten::flip", "aten::clone", "aten::contiguous", "aten::copy_",
              "aten::constant_pad_nd", "aten::_fft_r2c", "aten::_fft_c2r"}


def _topo_layer(cfg, seed, device):
    """One topo attention layer of `cfg` (random projections, mask scalars
    drawn as tests/test_topo_attention.py's _topo_params draws them)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import Params

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    attn = A.Attention(cfg, torch.float32, device)
    topo = Params(A.topo_shapes(cfg), torch.float32, device)
    with torch.no_grad():
        for name, t in A.attn_init(gen, cfg).items():
            getattr(attn, name).copy_(t)
        topo.coeffs.copy_(torch.tensor(rng.uniform(
            -0.5, 0.5, tuple(topo.coeffs.shape)), dtype=torch.float32))
        topo.logit_scale.copy_(torch.tensor(rng.uniform(
            -0.3, 0.3, tuple(topo.logit_scale.shape)), dtype=torch.float32))
    return attn, topo, gen


def phase_topo_fft(card, device):
    """3e: topo_attention_train with impl "fft" (Alg. 1 with the
    Toeplitz-FFT FastMult, float64 FFTs) against "ref" (the dense oracle)
    at the served topo-LM's width, float32, degree 2 and 3, causal and
    bidirectional; then "fft" timed beside "cuda" (the sweep kernel, rank
    mode) at L = 4096."""
    import torch
    from repro_torch.models import attention as A

    out = {"checks": [], "times": []}
    for degree in VIT["fft_degrees"]:
        cfg = _topo_cfg(degree, "fft", "float32")
        attn, topo, gen = _topo_layer(cfg, degree, device)
        B, L = VIT["fft_check"]
        x = torch.randn((B, L, cfg.d_model), generator=gen,
                        device=device) * 0.5
        pos = torch.arange(L, device=device)[None].expand(B, L)
        for causal in (True, False):
            with torch.no_grad():
                got = A.topo_attention_train(cfg, attn, topo, x, pos, causal)
                want = A.topo_attention_train(
                    cfg.replace(topo_attn_impl="ref"), attn, topo, x, pos,
                    causal)
            err = rel_err(got, want)
            ok = bool(torch.isfinite(got).all()) and err <= FFT_REF_TOL
            out["checks"].append({"degree": degree, "causal": causal,
                                  "B": B, "L": L, "rel_err": err})
            print(f"[topo fft check] degree {degree}, "
                  f"{'causal' if causal else 'bidirectional'}, B={B} "
                  f"L={L} H={cfg.num_heads} KV={cfg.num_kv_heads} "
                  f"hd={cfg.head_dim} d_model={cfg.d_model}, float32: fft vs "
                  f"ref {err:.2e} (<= {FFT_REF_TOL})", flush=True)
            if not ok:
                raise AssertionError(f"topo fft degree {degree} causal "
                                     f"{causal}: {err:.3e} from ref")
        del x, got, want
        torch.cuda.empty_cache()
    cfg = _topo_cfg(2, "fft", "float32")
    attn, topo, gen = _topo_layer(cfg, 2, device)
    B, L = VIT["fft_time"]
    x = torch.randn((B, L, cfg.d_model), generator=gen, device=device) * 0.5
    pos = torch.arange(L, device=device)[None].expand(B, L)
    row = {"degree": 2, "B": B, "L": L, "causal": True}
    for impl in ("fft", "cuda"):
        c = cfg.replace(topo_attn_impl=impl)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            row[f"{impl}_ms"] = host_ms(lambda: A.topo_attention_train(
                c, attn, topo, x, pos, True), VIT["reps"])
        row[f"{impl}_peak_bytes"] = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        row["fft_vs_cuda_rel_err"] = rel_err(
            A.topo_attention_train(cfg, attn, topo, x, pos, True),
            A.topo_attention_train(cfg.replace(topo_attn_impl="cuda"), attn,
                                   topo, x, pos, True))
    out["times"].append(row)
    print(f"[topo fft times] one layer, degree 2 causal, B={B} L={L}, "
          f"float32, host clock to synchronize: fft {row['fft_ms']:.1f} ms "
          f"(peak {row['fft_peak_bytes'] / 2**30:.1f} GiB), cuda (B2 rank16) "
          f"{row['cuda_ms']:.1f} ms (peak "
          f"{row['cuda_peak_bytes'] / 2**30:.1f} GiB); fft vs cuda "
          f"{row['fft_vs_cuda_rel_err']:.2e} | {card}", flush=True)
    del x
    torch.cuda.empty_cache()
    return out


def _vit_cfg(impl: str = "cuda", dtype: str | None = None, **kw):
    from repro_torch.configs.base import get_config

    cfg = get_config(VIT["arch"], topo_attn_impl=impl, **kw)
    return cfg.replace(dtype=dtype) if dtype else cfg


def _patches(cfg, B, dtype, device):
    import torch

    rng = np.random.default_rng(VIT["seed"] + B)
    return torch.tensor(rng.normal(size=(B, cfg.num_prefix_embeddings,
                                         VIT["patch_dim"])),
                        dtype=dtype, device=device)


def _vit_forward(cfg, model, patches, device):
    import torch
    from repro_torch.models import vit

    with torch.no_grad():
        return vit.forward(cfg, model, patches, device=device)


def phase_vit_gate(device):
    """4e: TopoViT-B/16 at full width and depth in float32 (TF32 off), B =
    2, random weights from a seed: impl "cuda" on the card against "ref"
    (the dense MST mask) on the card, and against "torch" on the CPU (the
    same computation); no port kernel launches. Then "cuda" against "ref"
    on the card at the served batch, whose folded field runs in several
    column chunks."""
    import torch
    from repro_torch.core.masks import FIELD_COL_CHUNK
    from repro_torch.kernels.fdist_matvec import ops as fdist_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops
    from repro_torch.models import vit

    cfg = _vit_cfg("cuda", "float32")
    model = vit.init_params(cfg, VIT["seed"], VIT["classes"],
                            VIT["patch_dim"], device=device)
    patches = _patches(cfg, VIT["gate_batch"], torch.float32, device)
    before = (fdist_ops.LAUNCHES, topo_ops.LAUNCHES)
    got = _vit_forward(cfg, model, patches, device)
    torch.cuda.synchronize()
    launched = (fdist_ops.LAUNCHES - before[0], topo_ops.LAUNCHES - before[1])
    want = _vit_forward(cfg.replace(topo_attn_impl="ref"), model, patches,
                        device)
    cpu_model = vit.from_state_dict(cfg, {k: t.detach().cpu() for k, t in
                                          model.state_dict().items()})
    t0 = time.perf_counter()
    cpu = _vit_forward(cfg.replace(topo_attn_impl="torch"), cpu_model,
                       patches.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0
    e_ref, e_cpu = rel_err(got, want), rel_err(got.cpu(), cpu)
    shape_ok = tuple(got.shape) == (VIT["gate_batch"], VIT["classes"])
    ok = (shape_ok and bool(torch.isfinite(got).all()) and e_ref <= VIT_REF_TOL
          and e_cpu <= VIT_CPU_TOL and launched == (0, 0))
    print(f"[topovit gate] {cfg.name}, float32, matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, depth {cfg.num_layers} "
          f"of {cfg.num_layers}, width {cfg.d_model}, B={VIT['gate_batch']}: "
          f"logits {tuple(got.shape)}, cuda vs ref (card) {e_ref:.2e} (<= "
          f"{VIT_REF_TOL}), cuda (card) vs torch (CPU, {cpu_s:.1f} s) "
          f"{e_cpu:.2e} (<= {VIT_CPU_TOL}); port kernel launches fdist "
          f"{launched[0]}, topo sweep {launched[1]}", flush=True)
    if not ok:
        raise AssertionError("topovit float32 gate failed")
    # the served batch: its folded field spans several column chunks, so
    # the chunk-and-concatenate path is held against the dense mask here
    B = VIT["serve_batch"]
    cols = B * cfg.num_heads * cfg.head_dim * cfg.head_dim
    chunks = -(-cols // FIELD_COL_CHUNK)
    patches = _patches(cfg, B, torch.float32, device)
    got = _vit_forward(cfg, model, patches, device)
    want = _vit_forward(cfg.replace(topo_attn_impl="ref"), model, patches,
                        device)
    e_served = rel_err(got, want)
    ok = (chunks > 1 and tuple(got.shape) == (B, VIT["classes"])
          and bool(torch.isfinite(got).all()) and e_served <= VIT_REF_TOL)
    print(f"[topovit gate, served batch] float32, B={B}: a folded field of "
          f"{cols} columns, {chunks} chunks of {FIELD_COL_CHUNK}: cuda vs ref "
          f"(card) {e_served:.2e} (<= {VIT_REF_TOL})", flush=True)
    if not ok:
        raise AssertionError("topovit float32 gate at the served batch "
                             "failed")
    return {"dtype": "float32", "layers": cfg.num_layers,
            "batch": VIT["gate_batch"], "rel_err_vs_ref": e_ref,
            "rel_err_vs_cpu": e_cpu, "cpu_seconds": cpu_s,
            "served_batch": B, "served_columns": cols,
            "served_chunks": chunks, "rel_err_vs_ref_served": e_served,
            "kernel_launches": {"fdist_matvec": launched[0],
                                "topo_sweep": launched[1]}}


def _fastmult_profile(cfg, device):
    """Device time of one layer's two fastmults (the k (x) v field and
    phi(k)) at the served shape; and the ops of the Hankel engine's call on
    the plan's largest cross bucket at that width: what the profiler shows
    of the FFT's layout."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan_api
    from repro_torch.core.masks import make_tree_fastmult, mask_f
    from repro_torch.models import vit

    B, H, L, m = (VIT["serve_batch"], cfg.num_heads,
                  cfg.num_prefix_embeddings, cfg.head_dim)
    plan = vit.build_grid_plan(cfg, device=device)
    coeffs = [0.0, -1.0, -0.5]
    fm = make_tree_fastmult(plan, cfg.topo_g, coeffs, cfg.topo_dist_scale,
                            backend="cuda", device=device)
    # what each layer pays to build its closure (coeffs on the card, as
    # the forward passes them)
    coeffs_dev = torch.tensor(coeffs, device=device)
    build_ms = host_ms(lambda: make_tree_fastmult(
        plan, cfg.topo_g, coeffs_dev, cfg.topo_dist_scale, backend="cuda",
        device=device), 100)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    kf = torch.rand((B, H, L, m), generator=gen, device=device)
    v1 = torch.rand((B, H, L, m * cfg.head_dim), generator=gen,
                    device=device)
    fm(kf), fm(v1)
    prof = phase_calls_profile("topovit fastmult, one layer",
                               lambda: (fm(v1), fm(kf)))
    del v1
    spec = plan[0]
    t = plan_api._device_tables(spec, device)
    Bn, Us = spec.cross_src_mask[0].shape
    Xp = torch.rand((Bn, Us, B * H * m * cfg.head_dim), generator=gen,
                    device=device)
    fe = mask_f(cfg.topo_g, torch.tensor(coeffs, device=device),
                cfg.topo_dist_scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        plan_api.hankel_batched_matvec(
            fe, spec.grid_h, t["grid_tgt"][0], t["grid_src"][0],
            t["grid_tgt_t"][0], t["grid_src_t"][0], Xp)
        torch.cuda.synchronize()
    # the device kernels, and the host ops that copy or transform
    layout = [{"name": ev.key[:90], "calls": ev.count,
               "device_ms": getattr(ev, "self_device_time_total", 0) / 1e3}
              for ev in p.key_averages()
              if ev.key in LAYOUT_OPS or getattr(
                  ev, "self_device_time_total", 0) > 0]
    print(f"[topovit fft layout] hankel_batched_matvec on cross bucket 0, "
          f"Xp {tuple(Xp.shape)}: " + "; ".join(
              f"{k['name'][:48]} x{k['calls']} {k['device_ms']:.2f} ms"
              for k in layout), flush=True)
    print(f"[topovit fastmult build] make_tree_fastmult, host clock: "
          f"{build_ms:.4f} ms a build, against {prof['device_ms']:.2f} ms of "
          f"device time for the layer's two fastmults", flush=True)
    prof["build_ms"] = build_ms
    return prof, layout


def phase_vit_serve(card, device):
    """5e: TopoViT-B/16 served in bf16, impl "cuda", a batch of 64 images
    (224 x 224, 196 patches of 768), and the "performer" variant at the same
    shape: forward ms and images/s (host clock to synchronize), peak
    device memory, the profile of one forward, and the fastmult's share of
    device time (12 x one layer's two fastmults, profiled alone)."""
    import torch
    from repro_torch.kernels.fdist_matvec import ops as fdist_ops
    from repro_torch.models import vit

    B = VIT["serve_batch"]
    out = {}
    for variant in ("topo", "performer"):
        cfg = _vit_cfg("cuda", attention_variant=variant)
        model = vit.init_params(cfg, VIT["seed"], VIT["classes"],
                                VIT["patch_dim"], device=device)
        patches = _patches(cfg, B, torch.bfloat16, device)
        t0 = time.perf_counter()
        first = _vit_forward(cfg, model, patches, device)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if (tuple(first.shape) != (B, VIT["classes"])
                or not bool(torch.isfinite(first).all())):
            raise AssertionError(f"topovit {variant}: logits "
                                 f"{tuple(first.shape)} not finite")
        torch.cuda.reset_peak_memory_stats()
        before = fdist_ops.LAUNCHES
        ms = host_ms(lambda: _vit_forward(cfg, model, patches, device),
                     VIT["reps"])
        peak = torch.cuda.max_memory_allocated()
        row = {"variant": variant, "dtype": cfg.dtype, "batch": B,
               "layers": cfg.num_layers, "first_forward_s": first_s,
               "forward_ms": ms, "images_per_s": B / (ms / 1e3),
               "peak_bytes": peak,
               "fdist_launches": fdist_ops.LAUNCHES - before, "card": card}
        print(f"[topovit serve {variant}] {cfg.name}, bf16, "
              f"{cfg.num_layers} layers, B={B} images: first forward "
              f"{first_s:.2f} s (plan build included), forward {ms:.1f} ms "
              f"({row['images_per_s']:.1f} images/s), peak "
              f"{peak / 2**30:.2f} GiB allocated | {card}", flush=True)
        row["profile"] = phase_calls_profile(
            f"topovit {variant} forward",
            lambda: _vit_forward(cfg, model, patches, device))
        if variant == "topo":
            # for scale: the dense MST mask ("ref", O(L^2)) at L = 196
            ref_cfg = cfg.replace(topo_attn_impl="ref")
            row["ref_forward_ms"] = host_ms(lambda: _vit_forward(
                ref_cfg, model, patches, device), VIT["reps"])
            row["rel_err_vs_ref_bf16"] = rel_err(
                first, _vit_forward(ref_cfg, model, patches, device))
            print(f"[topovit serve topo, ref] the dense MST mask at B={B}: "
                  f"forward {row['ref_forward_ms']:.1f} ms (for scale); "
                  f"cuda vs ref logits in bf16 "
                  f"{row['rel_err_vs_ref_bf16']:.2e} (not gated)", flush=True)
            fm_prof, row["fft_layout"] = _fastmult_profile(cfg, device)
            row["fastmult_device_ms"] = cfg.num_layers * fm_prof["device_ms"]
            row["fastmult_share"] = (row["fastmult_device_ms"]
                                     / row["profile"]["device_ms"])
            row["fastmult_profile"] = fm_prof
            print(f"[topovit fastmult share] {cfg.num_layers} x "
                  f"{fm_prof['device_ms']:.2f} ms = "
                  f"{row['fastmult_device_ms']:.1f} ms of "
                  f"{row['profile']['device_ms']:.1f} ms device time a "
                  f"forward: {row['fastmult_share']:.0%}", flush=True)
        out[variant] = row
        del model, patches, first
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# slice 9: training. Every kernel wrapper is a torch.autograd.Function whose
# forward is the kernel and whose backward is its plain version's VJP (B1's
# v-grad: the kernel with x and y swapped); the paper's topological
# Llama-3.2-1B trained at full width through train.loop.run_training
# ----------------------------------------------------------------------------

# the trainer: llama3_2_1b, topo g = exp at degree 2 (the paper's learnable
# mask scalars, the sweep's rank-16 mode), dist scale 1/L, bf16, batch 4 x
# 2048 tokens; the float32 gates at B = 2, L = 512 (full depth for topo,
# 2 layers for the paths of earlier slices)
TRAIN = {"arch": "llama3_2_1b", "degree": 2, "batch": 4, "seq": 2048,
         "steps": 6, "seed": 0, "gate_batch": 2, "gate_seq": 512,
         "gate_degrees": (1, 2), "gate_layers": 2}
# 3f's shapes: the card tests' and, last in each list (the one timed), the
# trainer's layer (batch 4 x 2048): B2, B4 (B, H, L, m, hd), B5 (B, H, KV,
# L, hd). B6 (Bt, L, din, N) takes the float32 gate's Falcon-Mamba layer:
# its plain chunked scan keeps every doubling step of every chunk for the
# backward, ~70 GB at 4 x 2048. B1 (B, a, b, d) adds plan (a)'s cross
# buckets
GRAD_SHAPES = {
    "fdist_matvec": [(3,) + s for s in TEST_SHAPES],
    "topo_attention_sweep": TOPO["sweep_shapes"][1:] + [
        (TRAIN["batch"], 32, TRAIN["seq"], 64, 64)],
    "linear_attention": [(1, 2, 100, 16, 16),
                         (TRAIN["batch"], 32, TRAIN["seq"], 64, 64)],
    "flash_attention": [(1, 4, 2, 100, 64),
                        (TRAIN["batch"], 32, 8, TRAIN["seq"], 64)],
    "selective_scan": SSM["oracle_shapes"] + [
        (TRAIN["gate_batch"], TRAIN["gate_seq"], 8192, 16)]}
# grads of a kernel path against the plain path's, relative to max: the
# forward's bounds (PERF.md section 2)
GRAD_TOL = {"fdist_matvec": FP32_TOL, "topo_attention_sweep": 1e-4,
            "linear_attention": 1e-5, "flash_attention": 2e-5,
            "selective_scan": 1e-5}
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# the topo LM's grads with phi = relu at full depth: "cuda" against the
# plain impl within this many times the dense oracle's spread against the
# plain impl (relu's kink; PERF.md section 6 has the readings, 0.74x and
# 1.95x at degrees 1 and 2 on an H100)
RELU_FLOOR_K = 4.0
BACKWARD = {
    "fdist_matvec": ("v: the kernel itself, M^T u (x and y swapped, one "
                     "launch); x, y, coeffs: the VJP of the plain version "
                     "(kernels/fdist_matvec/ref.py)"),
    "topo_attention_sweep": ("the VJP of the plain chunked sweep "
                             "(ops._plain_forward), recomputed from qf, kf, "
                             "v, coeffs: the reference's _fused custom VJP"),
    "flash_attention": ("the VJP of the plain online-softmax twin "
                        "(ops.sdpa_chunked), recomputed from q, k, v"),
    "linear_attention": ("the VJP of the plain chunked twin "
                         "(ops.causal_linear_attention), recomputed from "
                         "qf, kf, v, log_gamma"),
    "selective_scan": ("the VJP of the plain chunked scan "
                       "(ops.selective_scan), recomputed from u, dt, A, B, "
                       "C, D, h0")}


def _kernel_grads(kernel, counter, fn, ins, need, label, expect_fwd,
                  expect_bwd, time_backward=False, exact=None):
    """One 3f check: fn(*ins, use_kernel) on the kernel path and on the
    plain path, the same upstream gradient into both; the grads of every
    input in `need` held against the plain path's; the launches of each
    pass counted (`counter()` reads the wrapper's count). `exact(ins,
    ups)` gives float64 grads {input index: tensor} of the inputs whose
    grad the kernel computes: the kernel's grad is held against them too,
    and the plain path's distance from them is recorded, so a failed check
    says which result moved."""
    import torch

    def run(use_kernel):
        xs = [None if t is None else t.detach().clone().requires_grad_(n)
              for t, n in zip(ins, need)]
        before = counter()
        out = fn(*xs, use_kernel=use_kernel)
        torch.cuda.synchronize()
        fwd = counter() - before
        return xs, (out if isinstance(out, tuple) else (out,)), fwd

    xs_k, out_k, fwd_k = run(True)
    gen = torch.Generator(device=out_k[0].device)
    gen.manual_seed(5)
    ups = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in out_k]
    wanted = [x for x in xs_k if x is not None and x.requires_grad]
    before = counter()
    got = torch.autograd.grad(out_k, wanted, ups, retain_graph=time_backward)
    torch.cuda.synchronize()
    bwd_k = counter() - before
    xs_p, out_p, fwd_p = run(False)
    before = counter()
    want = torch.autograd.grad(out_p, [x for x in xs_p if x is not None
                                       and x.requires_grad], ups)
    torch.cuda.synchronize()
    bwd_p = counter() - before
    if (fwd_k, bwd_k, fwd_p, bwd_p) != (expect_fwd, expect_bwd, 0, 0):
        raise AssertionError(
            f"{label}: launches forward {fwd_k}, backward {bwd_k} on the "
            f"kernel path (expected {expect_fwd}, {expect_bwd}); forward "
            f"{fwd_p}, backward {bwd_p} on the plain path (expected 0, 0)")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    index = [i for i, x in enumerate(xs_k) if x is not None
             and x.requires_grad]
    ex = exact(ins, ups) if exact is not None else {}
    e_exact = [(rel_err(got[index.index(i)], e),
                rel_err(want[index.index(i)], e)) for i, e in ex.items()
               if i in index]
    for g in got:
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{label}: a non-finite grad")
    # B1's v-grad in bf16 is the kernel's bf16 output: its forward's bound
    bf16 = any(t is not None and t.dtype == torch.bfloat16 for t in ins)
    tol = BF16_TOL if kernel == "fdist_matvec" and bf16 else GRAD_TOL[kernel]
    row = {"kernel": kernel, "case": label, "rel_err": max(errs),
           "abs_err": max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want)),
           "tol": tol, "launches_forward": fwd_k, "launches_backward": bwd_k,
           "rel_err_exact": max((k for k, _ in e_exact), default=None),
           "plain_rel_err_exact": max((p for _, p in e_exact), default=None)}
    if not (row["rel_err"] <= tol and all(k <= tol for k, _ in e_exact)):
        raise AssertionError(f"{label}: grads {errs} against the plain "
                             f"path's (< {tol}); against the exact float64 "
                             f"grads (kernel, plain): {e_exact}")
    if time_backward:
        # CUDA events time the backward as a caller waits for it at the
        # card; a plain VJP of many small ops can leave the card idle
        # between them, so the sum of its device ops comes from the
        # profiler too (the time the card spends in it)
        row["backward_ms"] = device_ms(lambda: torch.autograd.grad(
            out_k, wanted, ups, retain_graph=True), 3)
        row["backward_device_ms"] = phase_calls_profile(
            f"{label} backward", lambda: torch.autograd.grad(
                out_k, wanted, ups, retain_graph=True))["device_ms"]
        row["forward_ms"] = device_ms(lambda: fn(*[
            None if t is None else t.detach() for t in ins],
            use_kernel=True), 3)
    return row


def phase_kernel_grads(device, buckets):
    """3f: each wrapper's autograd.Function on the card: the grads of
    every differentiable input against the plain version's, under the same
    upstream gradient, at the card-test shapes and the shapes the training
    paths give it (GRAD_SHAPES);
    one launch per forward (two for the bidirectional sweep pair), none in
    the backward but B1's M^T u, none on the plain path; the backward's
    device time at the largest shape. B1 takes the card-test shapes and
    `buckets` (the main path's (x, y, d) cross buckets of plan (a)), with
    its v-grad held against the exact float64 M^T u as well."""
    import torch
    from repro_torch.kernels.fdist_matvec import ops as fdist_ops
    from repro_torch.kernels.fdist_matvec.ref import (
        f_eval, fdist_matvec_batched_ref)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linear_attention import ops as linear_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    rng = np.random.default_rng(29)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(
            dtype)

    rows = []
    # B1: x, y, v, coeffs
    fdist_cases = [(None, s, mode, cs, torch.float32, False)
                   for s in GRAD_SHAPES["fdist_matvec"] for mode, cs in MODES]
    largest = max(range(len(buckets)), key=lambda i: buckets[i][0].numel()
                  * buckets[i][1].shape[1])
    fdist_cases += [((bx, by), (bx.shape[0], bx.shape[1], by.shape[1], d),
                     "exp", MODES[1][1], dt, i == largest
                     and dt == torch.float32)
                    for i, (bx, by, d) in enumerate(buckets)
                    for dt in (torch.float32, torch.bfloat16)]

    def exact_v(ins, ups, mode):
        x, y, v, c = ins
        m = f_eval(x.double()[:, :, None] + y.double()[:, None, :],
                   c.double(), mode)
        return {2: torch.bmm(m.transpose(1, 2), ups[0].double())}

    for xy, (B, a, b, d), mode, cs, vdt, timed in fdist_cases:
        x, y = xy if xy is not None else (t(rng.uniform(0, 3, (B, a))),
                                          t(rng.uniform(0, 3, (B, b))))
        ins = [x, y, t(rng.normal(size=(B, b, d)), vdt), t(cs)]

        def fdist(x, y, v, c, use_kernel, mode=mode):
            if use_kernel:
                return fdist_ops.fdist_matvec_batched(x, y, v, c, mode)
            return fdist_matvec_batched_ref(x, y, v, c, mode)

        for need in ((True,) * 4, (False, False, True, False),
                     (True, True, False, True)):
            rows.append(_kernel_grads(
                "fdist_matvec", lambda: fdist_ops.LAUNCHES, fdist, ins, need,
                f"fdist {mode} {(B, a, b, d)} {str(vdt)[6:]} grads "
                f"{''.join('xyvc'[i] for i in range(4) if need[i])}", 1,
                int(need[2]), timed and all(need),
                None if vdt != torch.float32 else functools.partial(
                    exact_v, mode=mode)))
    # B2: qf, kf, v, coeffs in decay (degree 1) and rank16 (degree 2) mode
    for B, H, L, m, hd in GRAD_SHAPES["topo_attention_sweep"]:
        big = (B, H, L, m, hd) == GRAD_SHAPES["topo_attention_sweep"][-1]
        qf, kf = (t(np.abs(rng.normal(size=(B, H, L, m)))) for _ in range(2))
        v = t(rng.normal(size=(B, H, L, hd)))
        for degree in TOPO["degrees"]:
            cs = _mask_coeffs(rng, H, degree, device)
            for causal in ((True,) if big else (True, False)):
                def topo(q, k, v, c, use_kernel, causal=causal, L=L):
                    return topo_ops.topo_linear_attention(
                        q, k, v, c, g="exp", dist_scale=1.0 / L,
                        causal=causal, use_kernel=use_kernel)

                rows.append(_kernel_grads(
                    "topo_attention_sweep", lambda: topo_ops.LAUNCHES, topo,
                    [qf, kf, v, cs], (True,) * 4,
                    f"topo {'decay' if degree == 1 else 'rank16'} "
                    f"{(B, H, L, m, hd)} {'causal' if causal else 'bidir'}",
                    1 if causal else 2, 0, big))
    # B4: qf, kf, v, log_gamma (lg = 0 as the Performer, and per head)
    for B, H, L, m, hd in GRAD_SHAPES["linear_attention"]:
        big = (B, H, L, m, hd) == GRAD_SHAPES["linear_attention"][-1]
        qf, kf = (t(np.abs(rng.normal(size=(B, H, L, m)))) for _ in range(2))
        for vdt in ((torch.float32, torch.bfloat16) if big
                    else (torch.float32,)):
            v = t(rng.normal(size=(B, H, L, hd)), vdt)
            for lg in (t(np.zeros(H)), t(-rng.uniform(0, 0.05, H))):
                rows.append(_kernel_grads(
                    "linear_attention", lambda: linear_ops.LAUNCHES,
                    linear_ops.linear_attention, [qf, kf, v, lg], (True,) * 4,
                    f"linear {(B, H, L, m, hd)} v {str(vdt)[6:]} lg "
                    f"{'0' if not bool(lg.any()) else 'per head'}", 1, 0,
                    big and vdt == torch.float32 and not bool(lg.any())))
    # B5: q, k, v in float32 and bf16, causal and not
    for B, H, KV, L, hd in GRAD_SHAPES["flash_attention"]:
        big = (B, H, KV, L, hd) == GRAD_SHAPES["flash_attention"][-1]
        base = [rng.normal(size=(B, n, L, hd)) for n in (H, KV, KV)]
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                def flash(q, k, v, use_kernel, causal=causal):
                    return flash_ops.flash_attention(q, k, v, causal,
                                                     use_kernel=use_kernel)

                rows.append(_kernel_grads(
                    "flash_attention", lambda: flash_ops.LAUNCHES, flash,
                    [t(a, dt) for a in base], (True,) * 3,
                    f"flash {(B, H, KV, L, hd)} {str(dt)[6:]} "
                    f"{'causal' if causal else 'full'}", 1, 0,
                    big and causal and dt == torch.float32))
    # B6: u, dt, A, B, C, D (and h0), float32 and bf16 u/dt/B/C
    for shape in GRAD_SHAPES["selective_scan"]:
        big = shape == GRAD_SHAPES["selective_scan"][-1]
        for dt in ((torch.float32, torch.bfloat16) if big
                   else (torch.float32,)):
            args = list(_scan_inputs(rng, shape, dt, device))
            Bt, L, din, N = shape
            args.append(None if big else t(rng.standard_normal(
                (Bt, din, N))))

            def scan(u, dt_, A, Bm, Cm, D, h0, use_kernel):
                return scan_ops.scan(u, dt_, A, Bm, Cm, D, h0=h0,
                                     use_kernel=use_kernel)

            rows.append(_kernel_grads(
                "selective_scan", lambda: scan_ops.LAUNCHES, scan, args,
                (True,) * 6 + (not big,),
                f"scan {shape} {str(dt)[6:]}{'' if big else ' h0'}", 1, 0,
                big and dt == torch.float32))
        torch.cuda.empty_cache()
    for kernel in GRAD_TOL:
        mine = [r for r in rows if r["kernel"] == kernel]
        timed = [r for r in mine if "backward_ms" in r]
        worst = {}
        for r in mine:
            worst[r["tol"]] = max(worst.get(r["tol"], 0.0), r["rel_err"])
        exact = [r for r in mine if r["rel_err_exact"] is not None]
        print(f"[grads {kernel}] {len(mine)} checks: worst rel err against "
              f"the plain path's grads " + ", ".join(
                  f"{e:.2e} (< {tol:g})" for tol, e in worst.items())
              + (f"; the kernel's grads against the exact float64 ones "
                 f"{max(r['rel_err_exact'] for r in exact):.2e}, the plain "
                 f"path's {max(r['plain_rel_err_exact'] for r in exact):.2e}"
                 if exact else "") + "; launches per forward "
              f"{sorted({r['launches_forward'] for r in mine})}, per "
              f"backward {sorted({r['launches_backward'] for r in mine})} | "
              + "; ".join(f"{r['case']}: forward {r['forward_ms']:.3f} ms, "
                          f"backward {r['backward_ms']:.3f} ms (its device "
                          f"ops {r['backward_device_ms']:.3f} ms)"
                          for r in timed), flush=True)
    return rows


def _train_cfg(degree: int, impl: str = "cuda", dtype: str | None = None,
               L: int | None = None):
    """The slice's model: topo llama3_2_1b, g = exp, dist scale 1/L."""
    from repro_torch.configs.base import get_config

    cfg = get_config(TRAIN["arch"], attention_variant="topo", topo_g="exp",
                     topo_degree=degree, topo_attn_impl=impl,
                     topo_dist_scale=1.0 / (L or TRAIN["seq"]))
    return cfg.replace(dtype=dtype) if dtype else cfg


def _leaf(name: str) -> str:
    """The grads' unit of comparison: a block parameter stacked over the
    layers (the reference's leaf), the mask scalars (coeffs and
    logit_scale) as one: a0 and logit_scale cancel in the normalization, so
    their exact grads are 0 but for phi's +1e-6, and what the card gives
    for them is rounding."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return name
    return "blocks.topo" if parts[2] == "topo" else ".".join(
        ["blocks"] + parts[2:])


def _grad_errors(got: dict, want: dict):
    """({name: max |got - want| over the largest |want| of the name's
    leaf}, {name: the same over its own largest})."""
    top = {}
    for name, g in want.items():
        top[_leaf(name)] = max(top.get(_leaf(name), 0.0),
                               float(g.abs().max()))
    errs, own = {}, {}
    for name, g in want.items():
        diff = float((got[name].double() - g.double()).abs().max())
        errs[name] = diff / max(top[_leaf(name)], 1e-30)
        own[name] = diff / max(float(g.abs().max()), 1e-30)
    return errs, own


def phase_train_gate(label, cfg, plain_cfg, ops, device, floor_cfg=None):
    """4f: float32 (TF32 off), one `api.loss_fn` + backward through the
    kernels (`cfg`) and through the plain versions (`plain_cfg`) from the
    same weights and batch: the loss within TRAIN_LOSS_TOL relative, each
    grad within TRAIN_GRAD_TOL of its leaf's largest; the launches
    counted (one per layer forward, again in the remat's recompute; none
    on the plain run). The worst tensor, the error by depth and each
    tensor's error against its own largest are printed, not gated.

    With `floor_cfg` (the topo LM at full depth with phi = relu, its
    configured feature map) the grads are held instead within
    RELU_FLOOR_K times the spread of a third implementation (`floor_cfg`)
    against the plain one, or TRAIN_GRAD_TOL if that is larger. There the grads are a discontinuous function
    of the forward: from the second layer on, a q or k within rounding of
    0 takes the relu's kink one way or the other, so two correct float32
    forwards give grads that differ by far more than rounding (on an H100
    the plain sweep against the dense oracle reads 3.5e-3; PERF.md). At
    one layer both paths feed the relu the same bits, and the caller
    holds the relu grads there at TRAIN_GRAD_TOL."""
    import torch
    from repro_torch.data.synthetic import SyntheticLMStream
    from repro_torch.models import api, lm

    model = api.init_params(cfg, TRAIN["seed"], device=device)
    toks = SyntheticLMStream(cfg.vocab_size, TRAIN["gate_batch"],
                             TRAIN["gate_seq"], seed=TRAIN["seed"]).batch_at(
        0)["tokens"]

    def loss_and_grads(c):
        before = ops.LAUNCHES
        loss, _ = api.loss_fn(c, model, {"tokens": toks}, device=device)
        fwd = ops.LAUNCHES - before
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        return (float(loss.detach()),
                dict(zip(dict(model.named_parameters()), grads)),
                fwd, ops.LAUNCHES - before - fwd)

    t0 = time.perf_counter()
    loss_k, got, fwd_k, bwd_k = loss_and_grads(cfg)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_p, want, fwd_p, bwd_p = loss_and_grads(plain_cfg)
    plain_s = time.perf_counter() - t0
    n = cfg.num_layers
    remat = lm._remat(cfg)
    if (fwd_k, bwd_k, fwd_p, bwd_p) != (n, n if remat else 0, 0, 0):
        raise AssertionError(f"{label}: launches forward {fwd_k}, backward "
                             f"{bwd_k} (expected {n}, {n if remat else 0}); "
                             f"plain {fwd_p}, {bwd_p}")
    errs, own = _grad_errors(got, want)
    del got
    worst = max(errs, key=errs.get)
    worst_own = max(own, key=own.get)
    by_layer = [max(e for k, e in errs.items()
                    if k.startswith(f"blocks.{i}.")) for i in range(n)]
    e_loss = abs(loss_k - loss_p) / abs(loss_p)
    uses_phi = cfg.family == "dense" and cfg.attention_variant != "full"
    grad_tol, floor = TRAIN_GRAD_TOL, None
    if floor_cfg is not None:
        loss_f, third, _, _ = loss_and_grads(floor_cfg)
        f_errs, _ = _grad_errors(third, want)
        del third
        f_worst = max(f_errs, key=f_errs.get)
        floor = {"impl": floor_cfg.topo_attn_impl, "rel_err_grad":
                 f_errs[f_worst], "worst": f_worst,
                 "rel_err_loss": abs(loss_f - loss_p) / abs(loss_p)}
        grad_tol = max(TRAIN_GRAD_TOL, RELU_FLOOR_K * floor["rel_err_grad"])
    ok = (e_loss <= TRAIN_LOSS_TOL and all(np.isfinite([loss_k, loss_p]))
          and errs[worst] <= grad_tol)
    phi = f"phi {cfg.performer_phi}, " if uses_phi else ""
    print(f"[{label} train gate] float32, {phi}matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, {n} layers, width "
          f"{cfg.d_model}, B={TRAIN['gate_batch']} L={TRAIN['gate_seq']}, "
          f"remat {remat}: loss {loss_k:.6f} vs {loss_p:.6f}, rel "
          f"{e_loss:.2e} (< {TRAIN_LOSS_TOL}); grads worst {errs[worst]:.2e}"
          f" ({worst}) of the leaf's max (< {grad_tol:.2e}" + (
              f" = {RELU_FLOOR_K:g} x impl {floor['impl']}'s spread: relu "
              "kinks" if floor else "") +
          f"); launches {fwd_k} forward + {bwd_k} recomputed in the "
          f"backward, plain 0; {kernel_s:.2f} s vs {plain_s:.2f} s | not "
          f"gated: by depth layer 0 {by_layer[0]:.1e}, layer {n // 2} "
          f"{by_layer[n // 2]:.1e}, layer {n - 1} {by_layer[-1]:.1e}; "
          f"against each tensor's own max {own[worst_own]:.2e} "
          f"({worst_own})" + (
              f"; impl {floor['impl']} against the plain one: grads "
              f"{floor['rel_err_grad']:.2e} ({floor['worst']}), loss "
              f"{floor['rel_err_loss']:.2e}" if floor else ""), flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel and plain training paths "
                             "disagree")
    return {"label": label, "layers": n, "phi": cfg.performer_phi,
            "grad_tol": grad_tol, "loss": loss_k, "plain_loss": loss_p,
            "rel_err_loss": e_loss, "rel_err_grad": errs[worst],
            "worst": worst, "rel_err_grad_by_layer": by_layer,
            "rel_err_own_max": own[worst_own], "worst_own": worst_own,
            "floor": floor, "launches_forward": fwd_k,
            "launches_backward": bwd_k, "seconds": kernel_s,
            "plain_seconds": plain_s}


def phase_train_gates(topo_ops, scan_ops, device):
    """4f: the topo model at full depth (degree 1 and 2) with phi = relu
    as configured (the grads held against the dense oracle "ref"'s
    spread) and with phi = "sq", and at one layer with phi = relu;
    Performer at 2 layers with phi = relu and "sq"; full attention and
    Falcon-Mamba-7B at 2 layers. Loss and grads gated in every case."""
    import torch

    gates = []
    L, n = TRAIN["gate_seq"], TRAIN["gate_layers"]
    for degree in TRAIN["gate_degrees"]:
        full = _train_cfg(degree, "cuda", "float32", L)
        for phi, layers in (("relu", full.num_layers), ("sq", full.num_layers),
                            ("relu", 1)):
            cfg = full.replace(performer_phi=phi, num_layers=layers)
            deep_relu = phi == "relu" and layers > 1
            gates.append(phase_train_gate(
                f"topo degree {degree}", cfg,
                cfg.replace(topo_attn_impl="torch"), topo_ops, device,
                cfg.replace(topo_attn_impl="ref") if deep_relu else None))
            torch.cuda.empty_cache()
    for variant in DENSE["variants"]:
        for phi in (("relu", "sq") if variant == "performer" else ("relu",)):
            cfg = _dense_cfg(variant, "cuda", "float32").replace(
                num_layers=n, performer_phi=phi)
            gates.append(phase_train_gate(
                variant, cfg, cfg.replace(attn_impl="chunked"),
                _kernel_ops(variant), device))
            torch.cuda.empty_cache()
    cfg = _ssm_cfg("cuda", "float32").replace(num_layers=n)
    gates.append(phase_train_gate("falcon-mamba", cfg,
                                  cfg.replace(attn_impl="chunked"), scan_ops,
                                  device))
    torch.cuda.empty_cache()
    return gates


def phase_train(card, device, bwd_rank16_ms):
    """4f/5f main path: `train.loop.run_training` on the slice's model in
    bf16 at full width and depth for TRAIN["steps"] steps, the sweep's
    count from 0 just before and read just after; every loss finite; step
    time (median of steps 2 on), tokens/s, peak memory, the checkpoint's
    save time; the final checkpoint restored and held bit for bit against
    the live parameters and optimizer state; the resume through
    run_training (params bit for bit, the moments equal to the live ones
    cast to the params' dtype); then one step profiled: the
    busy share, the top device ops, the sweep's share and that of the
    plain rank-16 backward (16 x the device time of its ops in 3f)."""
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.topo_linear_attention import ops
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.loop import (TrainLoopConfig,
                                        make_accumulating_step, run_training)

    cfg = _train_cfg(TRAIN["degree"])
    B, L = TRAIN["batch"], TRAIN["seq"]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    loop = TrainLoopConfig(steps=TRAIN["steps"], batch_size=B, seq_len=L,
                           ckpt_every=10 ** 6, ckpt_dir=ckpt, keep=1,
                           seed=TRAIN["seed"], log_every=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_training(cfg, loop, verbose=False, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in res["losses"]]
    n = cfg.num_layers
    if launches != TRAIN["steps"] * 2 * n or not all(np.isfinite(losses)):
        raise AssertionError(f"trainer: {launches} sweep launches for "
                             f"{TRAIN['steps']} steps of {n} layers "
                             f"(expected {TRAIN['steps'] * 2 * n}: forward "
                             f"and remat), losses {losses}")
    step_ms = float(np.median(res["step_seconds"][1:])) * 1e3
    model, opt = res["params"], res["opt_state"]
    # the final checkpoint, restored on the host, against the live state
    mgr = CheckpointManager(ckpt, keep=1)
    like_opt = AdamWState(
        torch.zeros((), dtype=torch.int32),
        {k: torch.zeros_like(v, device="cpu") for k, v in opt.mu.items()},
        {k: torch.zeros_like(v, device="cpu") for k, v in opt.nu.items()})
    like = {k: torch.zeros_like(v, device="cpu")
            for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    got = mgr.restore(like, like_opt)
    restore_s = time.perf_counter() - t0
    mismatched = [k for k, v in model.state_dict().items()
                  if not torch.equal(like[k], v.cpu())]
    for part in ("mu", "nu"):
        mismatched += [f"{part}.{k}" for k, v in getattr(opt, part).items()
                       if not torch.equal(getattr(like_opt, part)[k],
                                          v.cpu())]
    if got["step"] != TRAIN["steps"] or int(like_opt.step) != int(opt.step) \
            or mismatched:
        raise AssertionError(f"checkpoint restore: step {got['step']}, "
                             f"opt step {int(like_opt.step)}; differs at "
                             f"{mismatched[:5]}")
    ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                     if f.is_file())
    del like, like_opt, got
    # the resume through run_training's own path (run again with the same
    # steps: it restores into adamw_init's state and runs no step). The
    # params come back bit for bit; mu and nu, float32 since the first
    # update, come back cast to the params' dtype, as the reference's
    # restore casts them: a bf16 resume is not bit-identical
    t0 = time.perf_counter()
    back = run_training(cfg, loop, verbose=False, device=device)
    resume_s = time.perf_counter() - t0
    live_sd, back_sd = model.state_dict(), back["params"].state_dict()
    mismatched = [k for k, v in live_sd.items()
                  if not torch.equal(back_sd[k], v)]
    moment_err = {}
    for part in ("mu", "nu"):
        live_m, back_m = getattr(opt, part), getattr(back["opt_state"], part)
        mismatched += [f"{part}.{k}" for k, v in live_m.items() if not
                       torch.equal(back_m[k], v.to(back_m[k].dtype))]
        moment_err[part] = max(
            float((back_m[k].float() - v.float()).abs().max())
            / max(float(v.abs().max()), 1e-30) for k, v in live_m.items())
    moment_dtypes = sorted({str(v.dtype)[6:] for v in back["opt_state"]
                            .mu.values()})
    if len(back["losses"]) or int(back["opt_state"].step) != int(opt.step) \
            or mismatched:
        raise AssertionError(f"resume: {len(back['losses'])} steps run, opt "
                             f"step {int(back['opt_state'].step)}; differs "
                             f"from the live state (moments cast) at "
                             f"{mismatched[:5]}")
    del back, live_sd, back_sd
    torch.cuda.empty_cache()
    # one more step, profiled (the stream's next batch)
    from repro_torch.data.synthetic import SyntheticLMStream
    from repro_torch.optim.adamw import AdamWConfig

    step = make_accumulating_step(cfg, AdamWConfig(
        total_steps=TRAIN["steps"], warmup_steps=1), 1, False, device)
    toks = torch.as_tensor(SyntheticLMStream(
        cfg.vocab_size, B, L, seed=TRAIN["seed"]).batch_at(TRAIN["steps"])[
        "tokens"], device=device).long()
    holder = {"opt": opt}

    def one_step():
        holder["opt"], _, _ = step(model, holder["opt"], None,
                                   {"tokens": toks})

    prof = phase_calls_profile("trainer step", one_step)
    sweep_ms = sum(o["ms"] for o in prof["ops"] if "topo_sweep" in o["name"])
    out = {"card": card, "params": api.param_count(model),
           "losses": losses, "launches": launches,
           "step_ms": step_ms, "step_ms_all": [x * 1e3 for x in
                                               res["step_seconds"]],
           "tokens_per_s": B * L / (step_ms / 1e3), "peak_gib": peak,
           "train_seconds": train_s, "ckpt_save_s": res["ckpt_seconds"][-1],
           "ckpt_restore_s": restore_s, "ckpt_bytes": ckpt_bytes,
           "resume_s": resume_s, "resume_moment_dtypes": moment_dtypes,
           "resume_moment_rel_err": moment_err,
           "profile": prof, "sweep_share": sweep_ms / prof["device_ms"],
           "device_share_of_step": prof["device_ms"] / step_ms,
           "plain_rank16_backward_share": n * bwd_rank16_ms
           / prof["device_ms"]}
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[trainer] {cfg.name} topo degree {TRAIN['degree']} (rank16), "
          f"{cfg.dtype}, {n} layers, {out['params']} params, B={B} L={L}: "
          f"{TRAIN['steps']} steps through run_training in {train_s:.1f} s, "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}; {launches} sweep "
          f"launches; {step_ms:.1f} ms/step (median of steps 2-"
          f"{TRAIN['steps']}), {out['tokens_per_s']:.0f} tokens/s; peak "
          f"{peak:.2f} GiB; checkpoint {ckpt_bytes / 2 ** 30:.2f} GiB saved "
          f"in {out['ckpt_save_s']:.1f} s, restored in {restore_s:.1f} s, "
          f"bit for bit; resumed through run_training in {resume_s:.1f} s: "
          f"params bit for bit, mu and nu cast to "
          f"{'/'.join(moment_dtypes)} (rel change mu "
          f"{moment_err['mu']:.2e}, nu {moment_err['nu']:.2e}); profiled "
          f"step: busy {prof['busy']:.2f} under the "
          f"profiler, device time {prof['device_ms']:.1f} ms = "
          f"{out['device_share_of_step']:.2f} of an unprofiled step, the sweep "
          f"{out['sweep_share']:.1%} of device time, the plain rank-16 "
          f"backward {out['plain_rank16_backward_share']:.1%} ({n} x "
          f"{bwd_rank16_ms:.2f} ms) | {card}", flush=True)
    return out


# ----------------------------------------------------------------------------
# slice 10: learnable tree metrics (A8c) and plan maintenance (A9a)
# ----------------------------------------------------------------------------

# configuration (j): bench_learnable_f._train_edges_case at cell (a)'s graph,
# full size: edge weights -> ftfi.reweight -> fastmult -> the relative error
# against the graph kernel's action, 50 AdamW steps on backend "cuda"; the
# rational fit beside it; 64 plan edits; the "auto" crossover grid
LEARN = {"n": 10000, "extra": 5000, "leaf": 64, "d": 8, "steps": 50,
         "lr": 5e-2, "warmup": 5, "clip": 10.0,
         "fit": {"num_deg": 2, "den_deg": 2, "num_pairs": 100,
                 "steps": 300},
         "edits": 64, "edit_seed": 22,
         "auto_ns": (100, 250, 500, 1000, 2000, 4000, 10000),
         "auto_widths": (4, 64),
         "reps": 20}
LEARN_GRAD_TOL = 1e-4  # phase 4f's bound, relative to the grad's max
UPDATE_TOL = 2e-5  # tests/test_plan_update.py:19 (TOL)


def _learn_problem(cfg, device):
    """(graph, MST, spec, birth params, D_G, lam, X, target) of (j): the
    plan built reweightable at leaf 64, D_G by `graph_all_pairs`, f =
    exp(lam s) with lam = -2 / mean(D_G), X (n, d) from default_rng(0), the
    target exp(lam D_G) @ X in float32 as the reference computes it."""
    import torch
    from repro_torch import ftfi
    from repro_torch.graphs.graph import synthetic_graph
    from repro_torch.graphs.mst import minimum_spanning_tree
    from repro_torch.graphs.traverse import graph_all_pairs

    g = synthetic_graph(cfg["n"], cfg["extra"], seed=1)
    tree = minimum_spanning_tree(g)
    t0 = time.perf_counter()
    spec, params = ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                              device=device, use_cache=False)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D_g = graph_all_pairs(g)
    apsp_s = time.perf_counter() - t0
    lam = -2.0 / float(np.mean(D_g))
    X = np.random.default_rng(0).normal(size=(cfg["n"], cfg["d"])).astype(
        np.float32)
    Yt = torch.tensor(np.exp(lam * D_g).astype(np.float32) @ X,
                      device=device)
    return {"g": g, "tree": tree, "spec": spec, "params": params, "D_g": D_g,
            "lam": lam, "X": torch.tensor(X, device=device), "Yt": Yt,
            "build_s": build_s, "apsp_s": apsp_s}


def _rel_err_fn(prob, backend, device):
    """theta -> ||fastmult(reweight(softplus(theta))) - Yt|| / ||Yt||."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C

    spec, X, Yt = prob["spec"], prob["X"], prob["Yt"]
    fm = ftfi.fastmult(spec, C.Exponential(prob["lam"]), backend=backend,
                       device=device)
    y_norm = torch.linalg.norm(Yt)

    def rel_err(th):
        pred = fm(ftfi.reweight(spec, torch.nn.functional.softplus(th)), X)
        return torch.linalg.norm(pred - Yt) / y_norm

    return rel_err


def phase_learn_gate(cfg, device):
    """4g: the learnable-metric gates on (j) in float32, every call on
    backend "cuda" directly (never through the ladder): `apply` on
    `reweight(spec, w0)` against the birth params (<= 1e-5); the relative
    error and the theta-gradient of the loss, "cuda" against "torch" at the
    same theta (<= 1e-5; <= 1e-4 of the grad's max); B1 launched once per
    cross bucket in each forward and not in the backward (X needs no
    grad)."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C
    from repro_torch.kernels.fdist_matvec import ops

    prob = _learn_problem(cfg, device)
    spec, params, tree = prob["spec"], prob["params"], prob["tree"]
    nb = len(spec.cross_tgt_d0)
    fn = C.Exponential(prob["lam"])
    w0 = torch.tensor(tree.weights, dtype=torch.float32, device=device)
    birth = ftfi.apply(spec, params, fn, prob["X"], backend="cuda",
                       device=device)
    rew = ftfi.apply(spec, ftfi.reweight(spec, w0), fn, prob["X"],
                     backend="cuda", device=device)
    e_birth = rel_err(rew, birth)
    if not e_birth <= EXACT_TOL:
        raise AssertionError(f"(j) apply on reweight(w0) vs birth params: "
                             f"{e_birth:.3e} > {EXACT_TOL}")
    theta0 = torch.log(torch.expm1(w0))
    got = {}
    for backend in ("cuda", "torch"):
        f = _rel_err_fn(prob, backend, device)
        th = theta0.clone().requires_grad_(True)
        before = ops.LAUNCHES
        err = f(th)
        fwd = ops.LAUNCHES - before
        (grad,) = torch.autograd.grad(err ** 2, th)
        torch.cuda.synchronize()
        got[backend] = (err.detach(), grad, fwd, ops.LAUNCHES - before - fwd)
    e_err = rel_err(got["cuda"][0], got["torch"][0])
    e_grad = rel_err(got["cuda"][1], got["torch"][1])
    launches = got["cuda"][2:]
    if not (e_err <= EXACT_TOL and e_grad <= LEARN_GRAD_TOL
            and launches == (nb, 0) and got["torch"][2:] == (0, 0)
            and bool(torch.isfinite(got["cuda"][1]).all())):
        raise AssertionError(
            f"(j) cuda vs torch: rel err {e_err:.3e} (<= {EXACT_TOL}), "
            f"theta-grad {e_grad:.3e} (<= {LEARN_GRAD_TOL}); B1 launches "
            f"forward/backward {launches} (expected ({nb}, 0)), torch "
            f"{got['torch'][2:]}")
    out = {"n": spec.n, "cross_buckets": nb,
           "bucket_shapes": [(int(x.shape[0]), int(x.shape[1]),
                              int(y.shape[1])) for x, y in
                             zip(params.cross_tgt_d, params.cross_src_d)],
           "num_edges": spec.num_edges, "lam": prob["lam"],
           "build_s": prob["build_s"], "graph_all_pairs_s": prob["apsp_s"],
           "reweight_vs_birth": e_birth, "err_cuda_vs_torch": e_err,
           "grad_cuda_vs_torch": e_grad, "launches_per_forward": launches[0],
           "err0": float(got["cuda"][0])}
    print(f"[learnable gate] (j) n={spec.n}, {nb} cross buckets "
          f"{out['bucket_shapes']}, {spec.num_edges} edges; reweightable "
          f"build {prob['build_s']:.2f} s, graph_all_pairs "
          f"{prob['apsp_s']:.1f} s on the host; apply(reweight(w0)) vs birth "
          f"{e_birth:.2e}; cuda vs torch: rel err {e_err:.2e}, theta-grad "
          f"{e_grad:.2e} of its max; B1 {launches[0]} launches a forward, "
          f"{launches[1]} in the backward", flush=True)
    return prob, out


def phase_learn_train(prob, cfg, device, card):
    """4g/5g, (j)'s main path: 50 AdamW steps (lr 5e-2, wd 0, warmup 5,
    clip 10: the reference bench's) of the edge weights on backend "cuda",
    B1's count from 0 just before and read just after; err0 and errT
    finite, errT < err0; step time (median of steps 2 on) by the host clock
    and by CUDA events; then the parts of one step timed apart (reweight,
    the forward, forward + backward, AdamW) and one step profiled."""
    import torch
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update)

    f = _rel_err_fn(prob, "cuda", device)
    w0 = torch.tensor(prob["tree"].weights, dtype=torch.float32,
                      device=device)
    theta = {"theta": torch.log(torch.expm1(w0)).requires_grad_(True)}
    ocfg = AdamWConfig(lr=cfg["lr"], weight_decay=0.0,
                       warmup_steps=cfg["warmup"], total_steps=cfg["steps"],
                       clip_norm=cfg["clip"])
    state = adamw_init(theta)
    err0 = float(f(theta["theta"]).detach())

    def step(st):
        (grad,) = torch.autograd.grad(f(theta["theta"]) ** 2,
                                      theta["theta"])
        st, _ = adamw_update({"theta": grad}, st, theta, ocfg)
        return st

    host, dev = [], []
    torch.cuda.synchronize()
    ops.LAUNCHES = 0
    for _ in range(cfg["steps"]):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        state = step(state)
        ev1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(ev0.elapsed_time(ev1))
    launches = ops.LAUNCHES
    errT = float(f(theta["theta"]).detach())
    nb = len(prob["spec"].cross_tgt_d0)
    if not (np.isfinite(err0) and np.isfinite(errT) and errT < err0
            and launches == cfg["steps"] * nb):
        raise AssertionError(f"(j) training: err0 {err0}, errT {errT}, "
                             f"{launches} B1 launches for {cfg['steps']} "
                             f"steps of {nb} buckets")
    th = theta["theta"].detach().clone()
    thg = th.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            f(th)

    def fwd_bwd():
        torch.autograd.grad(f(thg) ** 2, thg)

    def rew():
        from repro_torch import ftfi

        with torch.no_grad():
            ftfi.reweight(prob["spec"], torch.nn.functional.softplus(th))

    g_fix = torch.autograd.grad(f(thg) ** 2, thg)[0]
    scratch = {"theta": th.clone()}
    st2 = adamw_init(scratch)

    def adam():
        adamw_update({"theta": g_fix}, st2, scratch, ocfg)

    parts = {"reweight_ms": device_ms(rew, cfg["reps"]),
             "forward_ms": device_ms(fwd, cfg["reps"]),
             "forward_backward_ms": device_ms(fwd_bwd, cfg["reps"]),
             "adamw_ms": device_ms(adam, cfg["reps"])}
    parts["backward_ms"] = (parts["forward_backward_ms"]
                            - parts["forward_ms"])
    holder = {"st": state}

    def one_step():
        holder["st"] = step(holder["st"])

    prof = phase_calls_profile("learnable step (j)", one_step, kinds={
        "B1": ("fdist",), "index": ("index", "Index", "gather", "scatter"),
        "gemm": ("gemm", "Gemm", "gemv"), "reduce": ("reduce",),
        "sort": ("Radix", "sort"), "elementwise": ("elementwise",)})
    b1_ms = prof["kinds"]["B1"]
    out = {"card": card, "steps": cfg["steps"], "err0": err0, "errT": errT,
           "launches": launches,
           "step_host_ms": float(np.median(host[1:])),
           "step_device_ms": float(np.median(dev[1:])),
           "step_host_ms_all": host, **parts, "profile": prof,
           "b1_forward_ms_profiled": b1_ms}
    print(f"[learnable train] (j) {cfg['steps']} AdamW steps on cuda: err "
          f"{err0:.4f} -> {errT:.4f}; {launches} B1 launches; step "
          f"{out['step_host_ms']:.2f} ms host, {out['step_device_ms']:.2f} "
          f"ms CUDA events (median of steps 2-{cfg['steps']}); parts, device "
          f"ms: reweight {parts['reweight_ms']:.3f}, forward "
          f"{parts['forward_ms']:.3f}, backward {parts['backward_ms']:.3f}, "
          f"AdamW {parts['adamw_ms']:.3f}; the profiled step's device ms "
          f"by kind: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   prof["kinds"].items()) + f" | {card}",
          flush=True)
    return out


def phase_fit(prob, cfg, device):
    """4g: `fit_rational_f` on (j)'s graph and tree (degrees 2/2, 100
    pairs, 300 steps) with its relative Frobenius error against the
    identity f's (D_T and D_G computed once and passed in)."""
    from repro_torch.core.fit import (fit_rational_f,
                                      tree_metric_frobenius_error)
    from repro_torch.graphs.traverse import tree_all_pairs

    fc = cfg["fit"]
    t0 = time.perf_counter()
    dists = (tree_all_pairs(prob["tree"]), prob["D_g"])
    t_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fit_rational_f(prob["g"], prob["tree"], num_deg=fc["num_deg"],
                         den_deg=fc["den_deg"], num_pairs=fc["num_pairs"],
                         steps=fc["steps"], seed=0, eval_frobenius=True,
                         device=device, dists=dists)
    fit_s = time.perf_counter() - t0
    ident = tree_metric_frobenius_error(prob["g"], prob["tree"], dists=dists)
    if not (np.isfinite(res.rel_frobenius)
            and res.rel_frobenius < ident):
        raise AssertionError(f"rational fit: frob err {res.rel_frobenius} "
                             f"not below the identity's {ident}")
    out = {"frob_err": res.rel_frobenius, "identity_frob_err": ident,
           "loss0": float(res.losses[0]), "lossT": float(res.losses[-1]),
           "fit_s": fit_s, "tree_all_pairs_s": t_dt}
    print(f"[learnable fit] rational {fc['num_deg']}/{fc['den_deg']}, "
          f"{fc['num_pairs']} pairs, {fc['steps']} steps in {fit_s:.1f} s: "
          f"loss {out['loss0']:.4f} -> {out['lossT']:.5f}; frob err "
          f"{res.rel_frobenius:.4f} vs identity {ident:.4f}", flush=True)
    return out


class _Edits:
    """The edited tree beside update_plan's id semantics (one tree): an
    insert appends vertex n_t, a delete leaves a ghost row."""

    def __init__(self, tree):
        self.n = tree.num_vertices
        self.edges = [(int(u), int(v), float(w)) for u, v, w in
                      zip(tree.edges_u, tree.edges_v, tree.weights)]
        self.deg = np.bincount(np.r_[tree.edges_u, tree.edges_v],
                               minlength=self.n).tolist()
        self.ghosts = set()

    def insert(self, parent, w):
        self.edges.append((parent, self.n, float(w)))
        self.deg[parent] += 1
        self.deg.append(1)
        self.n += 1

    def leaves(self):
        return [v for v in range(1, self.n)
                if self.deg[v] == 1 and v not in self.ghosts]

    def delete(self, v):
        (e,) = [e for e in self.edges if v in e[:2]]
        self.edges.remove(e)
        self.deg[e[0]] -= 1
        self.deg[e[1]] -= 1
        self.ghosts.add(v)

    def rebuild(self):
        from repro_torch.graphs.graph import WeightedTree

        live = [v for v in range(self.n) if v not in self.ghosts]
        relab = {v: i for i, v in enumerate(live)}
        return WeightedTree(len(live), [relab[u] for u, _, _ in self.edges],
                            [relab[v] for _, v, _ in self.edges],
                            [w for _, _, w in self.edges]), np.asarray(live)


def phase_maintenance(prob, cfg, device, card):
    """4h/5g on (j)'s plan: 64 seeded edits through `update_plan` (inserts,
    deletes, one reweight) held on "cuda" against a fresh reweightable
    build of the edited tree on the live rows (<= 2e-5), ghost rows
    exactly 0; the disk plan cache in a temp dir (miss, hit, the hit's
    apply bit for bit the fresh build's, a corrupted entry rejected and
    rebuilt); `validate` on the healthy plan and on a flipped index; the
    ladder: an injected raise at ladder.cuda and a NaN output at
    ladder.out.cuda each raise `DeviceRungError` on the card (no demotion
    there) and each demote once to "torch" on a CPU copy of the plan
    (output within 1e-5 of the CPU's direct "cuda" output and of the
    card's), and an uninjected resilient fastmult on the card stays on the
    kernel. Host times: update_plan per op against a rebuild, cache hit
    against a build."""
    import shutil
    import tempfile
    import warnings

    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C
    from repro_torch.core import ladder, plan_cache
    from repro_torch.core.integrate import clear_plan_cache
    from repro_torch.core.itree_flat import clear_flat_cache
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.testing import faults

    spec, params, tree = prob["spec"], prob["params"], prob["tree"]
    fn = C.Exponential(prob["lam"])
    rng = np.random.default_rng(cfg["edit_seed"])
    model = _Edits(tree)
    ops_list = []
    for k in range(cfg["edits"]):
        if k == cfg["edits"] // 2:
            w = rng.uniform(0.1, 1.0, len(model.edges))
            model.edges = [(u, v, float(x)) for (u, v, _), x in
                           zip(model.edges, w)]
            ops_list.append(("reweight", w))
        elif rng.random() < 0.6:
            parent = int(rng.choice([v for v in range(model.n)
                                     if v not in model.ghosts]))
            w = float(rng.uniform(0.1, 1.0))
            model.insert(parent, w)
            ops_list.append(("insert_leaf", parent, w))
        else:
            v = int(rng.choice(model.leaves()))
            model.delete(v)
            ops_list.append(("delete_leaf", v))
    t0 = time.perf_counter()
    s2, p2 = ftfi.update_plan(spec, params, ops_list)
    torch.cuda.synchronize()
    upd_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    s1, p1 = ftfi.update_plan(spec, params, [ops_list[0]])
    torch.cuda.synchronize()
    upd1_ms = (time.perf_counter() - t0) * 1e3
    edited, rows = model.rebuild()
    t0 = time.perf_counter()
    rs, rp = ftfi.build(edited, leaf_size=cfg["leaf"], reweightable=True,
                        device=device, use_cache=False)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    X = torch.tensor(np.random.default_rng(4).normal(size=(s2.n, 4)),
                     dtype=torch.float32, device=device)
    rows_t = torch.as_tensor(rows, device=device)
    before = ops.LAUNCHES
    got = ftfi.apply(s2, p2, fn, X, backend="cuda", device=device)
    want = ftfi.apply(rs, rp, fn, X[rows_t], backend="cuda", device=device)
    upd_launches = ops.LAUNCHES - before
    e_upd = rel_err(got[rows_t], want)
    ghost = torch.ones(s2.n, dtype=torch.bool, device=device)
    ghost[rows_t] = False
    ghost_max = float(got[ghost].abs().max()) if bool(ghost.any()) else 0.0
    if not (e_upd <= UPDATE_TOL and ghost_max == 0.0
            and s2.ghosts.size == len(model.ghosts)):
        raise AssertionError(f"update_plan vs rebuild: {e_upd:.3e} (<= "
                             f"{UPDATE_TOL}), ghost rows max {ghost_max}")
    n_ins = sum(op[0] == "insert_leaf" for op in ops_list)
    n_del = sum(op[0] == "delete_leaf" for op in ops_list)

    # the disk plan cache: miss + store, hit, corrupt -> rejected, rebuilt
    cache = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    Xc = prob["X"]
    try:
        plan_cache.configure(cache, max_mb=1024)
        clear_plan_cache()
        clear_flat_cache()
        st0 = plan_cache.stats()
        t0 = time.perf_counter()
        ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                   device=device)
        torch.cuda.synchronize()
        miss_ms = (time.perf_counter() - t0) * 1e3
        clear_plan_cache()
        clear_flat_cache()
        t0 = time.perf_counter()
        hs, hp = ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                            device=device)
        torch.cuda.synchronize()
        hit_ms = (time.perf_counter() - t0) * 1e3
        st1 = plan_cache.stats()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # cuBLAS: no deterministic flag
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                y_fresh = ftfi.apply(spec, params, fn, Xc, backend="cuda",
                                     device=device)
                y_hit = ftfi.apply(hs, hp, fn, Xc, backend="cuda",
                                   device=device)
            finally:
                torch.use_deterministic_algorithms(False)
        bitwise = bool(torch.equal(y_fresh, y_hit))
        [entry] = [os.path.join(cache, f) for f in os.listdir(cache)]
        faults.corrupt_file(entry, flip_bytes=64, seed=5)
        clear_plan_cache()
        clear_flat_cache()
        cs, cp = ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                            device=device)
        st2 = plan_cache.stats()
    finally:
        plan_cache.configure(None)
        shutil.rmtree(cache, ignore_errors=True)
        clear_plan_cache()
        clear_flat_cache()
    cache_ok = (st1["misses"] - st0["misses"] == 1
                and st1["stores"] - st0["stores"] == 1
                and st1["hits"] - st0["hits"] == 1 and bitwise
                and hs.digest == spec.digest
                and st2["errors"] - st1["errors"] == 1
                and st2["hits"] == st1["hits"]
                and st2["stores"] - st1["stores"] == 1
                and cs.digest == spec.digest)
    if not cache_ok:
        raise AssertionError(f"plan cache: stats {st0} -> {st1} -> {st2}, "
                             f"hit apply bit for bit {bitwise}")

    # the guard
    healthy = ftfi.validate(spec, params)
    try:
        ftfi.validate(faults.flip_index(spec), params)
        flagged = False
    except ftfi.PlanValidationError:
        flagged = True
    if not (healthy and flagged):
        raise AssertionError(f"validate: healthy {healthy}, flipped index "
                             f"flagged {flagged}")

    # the ladder: each injected fault raises on the card and demotes once
    # on a CPU copy of the plan; then one clean kernel run on the card
    ref = ftfi.apply(spec, params, fn, Xc, backend="cuda", device=device)
    cpu = torch.device("cpu")
    hs_, hp_ = ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                          device=cpu, use_cache=False)
    Xh = Xc.cpu()
    ref_h = ftfi.apply(hs_, hp_, fn, Xh, backend="cuda", device=cpu)
    lad = {}
    for label, point, handler in (
            ("raise", "ladder.cuda", faults.always_raise(
                RuntimeError, "injected kernel launch failure")),
            ("nan", "ladder.out.cuda", faults.nan_output())):
        fm = ftfi.resilient_fastmult(spec, fn, backend="cuda", device=device)
        raised = None
        with faults.injected(point, handler), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fm(params, Xc)
            except ftfi.DeviceRungError as e:
                raised = str(e)
        card_warned = sum(issubclass(w.category, ftfi.BackendDemotionWarning)
                          for w in caught)
        fmh = ftfi.resilient_fastmult(hs_, fn, backend="cuda", device=cpu)
        with faults.injected(point, handler), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y = fmh(hp_, Xh)
        warned = sum(issubclass(w.category, ftfi.BackendDemotionWarning)
                     for w in caught)
        lad[label] = {"card_raised": raised, "card_level": fm.level,
                      "card_demotions": len(fm.demotions),
                      "card_warnings": card_warned, "cpu_level": fmh.level,
                      "cpu_rel_err": rel_err(y, ref_h),
                      "cpu_rel_err_vs_card": rel_err(y, ref.cpu()),
                      "cpu_warnings": warned}
        if not (raised and fm.level == "cuda" and not fm.demotions
                and card_warned == 0 and fmh.level == "torch"
                and lad[label]["cpu_rel_err"] <= EXACT_TOL
                and lad[label]["cpu_rel_err_vs_card"] <= EXACT_TOL
                and warned == 1):
            raise AssertionError(f"ladder {label}: {lad[label]}")
    fm = ftfi.resilient_fastmult(spec, fn, backend="cuda", device=device)
    before = ops.LAUNCHES
    y = fm(params, Xc)
    clean = ops.LAUNCHES - before
    # (two applies differ in the last bits: index_add_'s atomics)
    e_clean = rel_err(y, ref)
    if not (fm.level == "cuda" and clean == len(spec.cross_tgt_d0)
            and e_clean <= EXACT_TOL):
        raise AssertionError(f"uninjected ladder: level {fm.level}, "
                             f"{clean} B1 launches, rel err {e_clean:.3e}")
    out = {"card": card, "edits": len(ops_list), "inserts": n_ins,
           "deletes": n_del, "reweights": 1, "n_after": s2.n,
           "rel_err_vs_rebuild": e_upd, "ghost_rows": int(s2.ghosts.size),
           "ghost_max": ghost_max, "apply_launches": upd_launches,
           "update_ms": upd_ms, "update_ms_per_op": upd_ms / len(ops_list),
           "update_one_op_ms": upd1_ms, "rebuild_ms": rebuild_ms,
           "cache_miss_build_ms": miss_ms, "cache_hit_ms": hit_ms,
           "cache_hit_bitwise": bitwise, "cache_stats": st2,
           "validate_healthy": healthy, "validate_flagged": flagged,
           "ladder": lad, "ladder_clean_launches": clean,
           "ladder_clean_rel_err": e_clean,
           "ladder_stats": ladder.stats()}
    print(f"[maintenance] update_plan: {len(ops_list)} edits ({n_ins} "
          f"inserts, {n_del} deletes, 1 reweight) in {upd_ms:.1f} ms "
          f"({out['update_ms_per_op']:.2f} ms an op; one insert alone "
          f"{upd1_ms:.1f} ms) vs a reweightable rebuild {rebuild_ms:.1f} ms; "
          f"cuda apply vs rebuild on the live rows {e_upd:.2e}, "
          f"{s2.ghosts.size} ghost rows max {ghost_max}; plan cache: build "
          f"+ store {miss_ms:.1f} ms, hit {hit_ms:.1f} ms, hit apply bit for "
          f"bit {bitwise}, corrupted entry rejected and rebuilt; validate "
          f"ok/flagged; ladder on the card: raise and NaN each raised "
          f"DeviceRungError; on the CPU copy: raise -> "
          f"{lad['raise']['cpu_level']} ({lad['raise']['cpu_rel_err']:.1e})"
          f", NaN -> {lad['nan']['cpu_level']} "
          f"({lad['nan']['cpu_rel_err']:.1e}); clean card run {clean} B1 "
          "launches; "
          f"stats {out['ladder_stats']} | {card}", flush=True)
    return out


def phase_auto_crossover(cfg, device, card):
    """5g: `apply` host ms, "cuda" against "torch", Exponential(-0.5) (the
    reference threshold's family) on synthetic-graph MSTs, for the
    `backend="auto"` threshold. The crossover at width d is the smallest
    measured n from which "cuda" is at least as fast at every larger
    measured n (None: "torch" wins somewhere at the top)."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import cordial as C
    from repro_torch.core import ladder
    from repro_torch.graphs.graph import synthetic_graph
    from repro_torch.graphs.mst import minimum_spanning_tree

    fn = C.Exponential(-0.5)
    rows = []
    for n in cfg["auto_ns"]:
        tree = minimum_spanning_tree(synthetic_graph(n, n // 2, seed=1))
        spec, params = ftfi.build(tree, leaf_size=cfg["leaf"], device=device)
        for d in cfg["auto_widths"]:
            X = torch.tensor(np.random.default_rng(n + d).normal(size=(n, d)),
                             dtype=torch.float32, device=device)
            row = {"n": n, "d": d}
            for backend in ("cuda", "torch"):
                row[backend + "_ms"] = host_ms(
                    lambda: ftfi.apply(spec, params, fn, X, backend=backend,
                                       device=device), cfg["reps"])
            rows.append(row)
    cross = {}
    for d in cfg["auto_widths"]:
        at_d = [r for r in rows if r["d"] == d]
        cross[d] = None
        for r in reversed(at_d):
            if r["cuda_ms"] > r["torch_ms"]:
                break
            cross[d] = r["n"]
    out = {"card": card, "rows": rows, "crossover": cross,
           "committed_default": ladder.AUTO_CUDA_MIN_N}
    print("[auto crossover] apply host ms cuda/torch, Exponential(-0.5): "
          + "; ".join(f"n={r['n']} d={r['d']} {r['cuda_ms']:.3f}/"
                      f"{r['torch_ms']:.3f}" for r in rows)
          + f" | measured crossover {cross} vs committed default "
          f"FTFI_AUTO_CUDA_MIN_N={ladder.AUTO_CUDA_MIN_N} | {card}",
          flush=True)
    return out


def run(cfg, device, out_path=None) -> dict:
    """All phases; returns the record. Raises on any failed check."""
    import torch

    from repro_torch import ftfi
    from repro_torch.graphs.meshes import icosphere, mesh_graph
    from repro_torch.graphs.mst import minimum_spanning_tree
    from repro_torch.kernels.fdist_matvec import kernel as fdist_kernel
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    info = phase_device()
    build = phase_build()
    # the plan is built on the host first: phase 3 checks the kernel at its
    # three largest cross buckets
    tree = synthetic_tree(cfg)
    _, host_params = ftfi.build(tree, leaf_size=cfg["leaf"], device=device,
                                use_cache=False)  # phase 4 times a cold build
    buckets = top_buckets(host_params, cfg["widths"])
    checks = phase_kernel_vs_plain(buckets, device)
    del host_params

    fams = families()
    # the main path: counts from zero, read right after
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_TD.update({td: 0 for td in ops.LAUNCHES_BY_TD})
    spec, params, dense, rows_a = phase_tree(
        "synthetic", tree, fams, cfg["widths"], cfg, device,
        exact_torch={"Exponential", "Polynomial"})
    mesh = minimum_spanning_tree(mesh_graph(*icosphere(cfg["ico"])))
    _, _, dense_mesh, rows_b = phase_tree(
        f"icosphere{cfg['ico']}", mesh, [fams[3]], (4,), cfg, device,
        exact_torch=set())
    del dense_mesh
    forest = phase_forest(cfg, device)
    # by d-tile: 4, the one-row-a-thread form; 64, the register-blocked
    # tile (d = 64 and the forest's block identity)
    main_by_td = dict(ops.LAUNCHES_BY_TD)
    for d in cfg["widths"]:
        if main_by_td[fdist_kernel.tile_width(d)] == 0:
            raise AssertionError(f"the main path launched no fdist_matvec "
                                 f"kernel of d-tile {d}")

    card = info["nvidia_smi"]
    times = phase_times(spec, params, dense, cfg, device, card)
    times["profile"] = phase_profile(spec, params, device)
    kernels = []
    for d in cfg["widths"]:
        at_d = [r for r in times["buckets"] if r["d"] == d]
        # the least time for the work of all these launches together
        b_ms, b_by = bound(sum(r["bytes"] for r in at_d),
                           sum(r["ops"] for r in at_d))
        kernels.append({
            "name": f"fdist_matvec_batched[d={d}]", "route": "cuda",
            "source": "src/repro_torch/kernels/fdist_matvec/fdist_matvec.cu",
            "replaces": "src/repro/kernels/fdist_matvec/kernel.py:63",
            "launches": main_by_td[fdist_kernel.tile_width(d)],
            "max_abs_err": max(r["abs_err"] for r in checks
                               if r["kind"] == "bucket" and r["d"] == d
                               and r["dtype"] == "float32"),
            "ms": sum(r["ms"] for r in at_d),
            "plain_ms": sum(r["plain_ms"] for r in at_d),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sum(r["library_ms"] for r in at_d),
            "at": (f"sum over the {len(at_d)} cross buckets of the n="
                   f"{cfg['n']} synthetic MST plan, d={d}, exp; launches: "
                   f"those of d-tile {d} on the main path"),
        })
    del spec, params, dense

    # slice 2: the topo-LM served through the topo sweep kernel
    topo_checks, served = phase_topo_kernel_vs_plain(device)
    gates = []
    for degree in TOPO["degrees"]:
        gates.append(phase_gate(
            f"topo degree {degree}", _topo_cfg(degree, "cuda", "float32"),
            _topo_cfg(degree, "torch", "float32"), topo_ops, device))
        torch.cuda.empty_cache()
    serves = {}
    for degree in TOPO["degrees"]:  # each path counts from zero
        serves[degree] = phase_serve(f"topo degree {degree}",
                                     _topo_cfg(degree), topo_ops, device,
                                     card)
        torch.cuda.empty_cache()
    topo_times = phase_topo_times(served, card, device)
    for degree in TOPO["degrees"]:
        t = topo_times[degree]
        B, H, L, m, hd = t["shape"]
        errs = [r["abs_err"] for r in topo_checks  # the main path's launch
                if r["shape"] == t["shape"] and r["mode"] == t["mode"]
                and r["causal"] is True]
        kernels.append({
            "name": f"topo_attention_sweep[{t['mode']}]", "route": "cuda",
            "source": ("src/repro_torch/kernels/topo_linear_attention/"
                       "topo_sweep.cu"),
            "replaces": ("src/repro/kernels/topo_linear_attention/"
                         "kernel.py:132"),
            "launches": serves[degree]["launches"],
            "max_abs_err": max(errs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_fp32_ms": t["bound_fp32_ms"], "library_ms": None,
            "at": (f"one causal launch, B={B} H={H} L={L} m={m} hd={hd} "
                   f"C={t['C']}: one layer of the {TOPO['arch']} topo "
                   f"prefill at degree {degree}; bound_ms: 3xTF32 on the "
                   "tensor cores, bound_fp32_ms: fp32 outside them"),
        })
    del served

    # slice 3: Llama-3.2-1B with full and Performer attention, served
    # through the flash attention and linear attention kernels
    attn_checks, attn_served = phase_attn_kernel_vs_plain(device)
    dense_gates = []
    for variant in DENSE["variants"]:
        dense_gates.append(phase_gate(
            variant, _dense_cfg(variant, "cuda", "float32"),
            _dense_cfg(variant, "chunked", "float32"), _kernel_ops(variant),
            device))
        torch.cuda.empty_cache()
    dense_serves = {}
    for variant in DENSE["variants"]:  # each path counts from zero
        dense_serves[variant] = phase_serve(variant, _dense_cfg(variant),
                                            _kernel_ops(variant), device,
                                            card)
        torch.cuda.empty_cache()
    attn_times = phase_attn_times(attn_served, card)
    del attn_served
    B, H, KV, L, hd = DENSE["flash_shapes"][0]
    for causal in (True, False):
        mode = "causal" if causal else "full"
        t = attn_times[f"flash_{mode}_bfloat16"]
        errs = [r["abs_err"] for r in attn_checks
                if r["kernel"] == "flash_attention" and r["causal"] == causal
                and r["shape"] == (B, H, KV, L, hd)
                and r["dtype"] == "bfloat16" and not r.get("peaked")]
        kernels.append({
            "name": f"flash_attention[{mode}]", "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
            # the wrapper counts each mode apart: the main path launches
            # the kernel causal only
            "launches": dense_serves["full"]["launches_by_mode"][mode],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "at": (f"one {'causal' if causal else 'non-causal'} launch, "
                   f"bf16, B={B} H={H} KV={KV} L={L} hd={hd}: one layer of "
                   f"the {TOPO['arch']} full-attention prefill"
                   + ("" if causal else " (the same kernel and wrapper; the"
                      " main path launches it causal only, so 0 launches)")),
        })
    B, H, L, m, hd = DENSE["linear_shape"]
    t = attn_times["linear_lg0"]
    kernels.append({
        "name": "linear_attention", "route": "cuda",
        "source": ("src/repro_torch/kernels/linear_attention/"
                   "linear_attention.cu"),
        "replaces": "src/repro/kernels/linear_attention/kernel.py:59",
        "launches": dense_serves["performer"]["launches"],
        "max_abs_err": max(r["abs_err"] for r in attn_checks
                           if r["kernel"] == "linear_attention"),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bound_fp32_ms": t["bound_fp32_ms"],
        "library_ms": None,
        "at": (f"one launch, lg = 0, bf16 v, B={B} H={H} L={L} m={m} "
               f"hd={hd}, C={t['C']}: one layer of the {TOPO['arch']} "
               "Performer prefill; bound_ms: bytes against 3xTF32 on the "
               "tensor cores, bound_fp32_ms: against fp32 FMAs outside "
               "them"),
    })

    # slice 4: Falcon-Mamba-7B served through the selective scan kernel
    scan_checks, scan_served = phase_scan_kernel_vs_plain(device)
    scan_times = phase_scan_times(scan_served, info, card)
    del scan_served
    torch.cuda.empty_cache()
    # the float32 model (28 GB) is freed when its phase returns
    ssm_gate = phase_gate("falcon-mamba", _ssm_cfg("cuda", "float32"),
                          _ssm_cfg("chunked", "float32"), scan_ops, device)
    torch.cuda.empty_cache()
    ssm_serve = phase_serve("falcon-mamba", _ssm_cfg(), scan_ops, device,
                            card)
    torch.cuda.empty_cache()
    Bt, L, din, N = SSM["served_shape"]
    t = scan_times["bfloat16"]
    kernels.append({
        "name": "selective_scan", "route": "cuda",
        "source": ("src/repro_torch/kernels/selective_scan/"
                   "selective_scan.cu"),
        "replaces": "src/repro/kernels/selective_scan/kernel.py:47",
        "launches": ssm_serve["launches"],
        "max_abs_err": max(r["abs_err_plain"] for r in scan_checks
                           if r["kind"] == "served"),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "at": (f"one launch, bf16 u/dt/B/C, Bt={Bt} L={L} din={din} N={N}: "
               f"one layer of the {SSM['arch']} prefill; bound by "
               f"{t['bound_term']}; library none: no single PyTorch call "
               "computes the scan"),
    })
    # slice 8: the Toeplitz-FFT topo impl; TopoViT-B/16 (no port kernel)
    topo_fft = phase_topo_fft(card, device)
    vit_gate = phase_vit_gate(device)
    torch.cuda.empty_cache()
    vit_serve = phase_vit_serve(card, device)
    # slice 9: training. 3f the Functions' grads; 4f the float32 training
    # gates (topo at full depth, the earlier paths at 2 layers); 5f the
    # trainer, the slice's main path
    grad_rows = phase_kernel_grads(device, [b for b in buckets
                                            if b[2] == max(cfg["widths"])])
    torch.cuda.empty_cache()
    train_gates = phase_train_gates(topo_ops, scan_ops, device)
    timed = {r["case"]: r for r in grad_rows if "backward_ms" in r}
    rank16 = next(r for c, r in timed.items() if "rank16" in c)
    trainer = phase_train(card, device, rank16["backward_device_ms"])
    for k in kernels:
        name = k["name"].split("[")[0].replace("_batched", "")
        mode = k["name"].split("[")[-1].rstrip("]")
        row = next(r for c, r in timed.items() if r["kernel"] == name
                   and (name != "topo_attention_sweep" or mode in c))
        k.update(backward=BACKWARD[name], backward_ms=row["backward_ms"],
                 backward_device_ms=row["backward_device_ms"],
                 backward_at=row["case"])
        if k["name"] == "topo_attention_sweep[rank16]":
            k["train_launches"] = trainer["launches"]
    # slice 10: learnable tree metrics (4g; (j)'s training is the slice's
    # main path, B1's count from 0 around it) and plan maintenance (4h);
    # 5g's times. Only 4h's injected faults may reach the ladder: two
    # raised on the card, two demotions on the CPU copy.
    torch.cuda.empty_cache()
    from repro_torch.core import ladder

    ladder.reset_stats()
    prob, learn_gate = phase_learn_gate(LEARN, device)
    learn = phase_learn_train(prob, LEARN, device, card)
    fit = phase_fit(prob, LEARN, device)
    maint = phase_maintenance(prob, LEARN, device, card)
    del prob
    torch.cuda.empty_cache()
    auto = phase_auto_crossover(LEARN, device, card)
    for k in kernels:
        if k["name"].startswith("fdist_matvec_batched"):
            k.update(learn_launches=learn["launches"], learn_at=(
                f"(j): {LEARN['steps']} training steps, one launch per "
                f"cross bucket a forward (all d-tiles, d={LEARN['d']}); the "
                "backward runs the plain VJP (x, y grads)"),
                learn_backward_ms=learn["backward_ms"])
    want = {"demotions": 2, "errors": 2, "nonfinite": 2, "blocked": {}}
    if ladder.stats() != want:
        raise AssertionError(f"ladder: {ladder.stats()} at the end of the "
                             f"run; only 4h's injected demotions ({want}) "
                             f"may reach it")
    record = {"device": info, "build": build, "main_path": rows_a + rows_b,
              "forest": forest, "kernel_checks": checks, "times": times,
              "topo_kernel_checks": topo_checks, "topo_gates": gates,
              "topo_serve": serves, "topo_times": {
                  str(k): v for k, v in topo_times.items()},
              "attn_kernel_checks": attn_checks, "dense_gates": dense_gates,
              "dense_serve": dense_serves, "attn_times": attn_times,
              "scan_kernel_checks": scan_checks, "ssm_gate": ssm_gate,
              "ssm_serve": ssm_serve, "scan_times": scan_times,
              "topo_fft": topo_fft, "vit_gate": vit_gate,
              "vit_serve": vit_serve, "kernel_grads": grad_rows,
              "train_gates": train_gates, "trainer": trainer,
              "learn_gate": learn_gate, "learn_train": learn, "fit": fit,
              "maintenance": maint, "auto_crossover": auto,
              "kernels": kernels}
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    run(FULL, torch.device("cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
