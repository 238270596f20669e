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
into the cache, then greedy decode steps at per-slot positions) of the
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
float32 at 16 layers (16 launches per prefill, none in decode); then, in
bf16 at full depth, serves
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
2 images, and against "ref" at 32 (the field in two column chunks); then
serves a batch of 16 images in bf16, and the Performer variant at the
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
bf16, batch 4 x 2048, cut to 4 layers) for 6 steps through
`train.loop.run_training`:
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

The Integrator facade (slice 11): 4i runs `Integrator(tree,
backend="cuda")` and "torch" (device left at None: the card) at cell (a)'s
tree, each output bit for bit `ftfi.apply`'s on the same plan and within
1e-5 of the card's BTFI, one B1 launch per cross bucket on "cuda"; the
"host" backend (the recursive FTFI walk, ExpMP for Exponential) within
1e-5 of BTFI; `from_forest` on cell (c)'s forest against the host's
per-tree loop; `from_plan` on a saved and loaded plan, and a flipped index
refused. 4j is the paper's Fig. 4 on the card (bench_mesh_interpolation's
meshes, known vertices and f, plus icosphere(5) for the MST rows): MST,
random spanning tree, FRT tree and a forest of 4 FRT trees on "cuda", each
f's prediction within 1e-5 of the host walk on the same tree and each
method's best cosine within 1e-4 of the host's, and BTFI on the MST; 5h
times preprocessing and one integrate on each backend against BTFI, and
the facade against a bare `ftfi.apply`.

The DeepSeek family and three dense configs (slice 12): 3c holds the flash
attention kernel at MLA's head dims (q/k 192, v 128) and Gemma-7B's 256
(the served layers, L = 4096, and L = 1000, against the dense oracle
there) and at Qwen2's and Granite's GQA/MQA, f32 and bf16, against its
plain version; 4b gates, in float32 at full width and 2 layers, "cuda"
against "chunked" for DeepSeek-V2-Lite (2 requests, the MoE routing of
both runs equal first) and for Qwen2-1.5B, Gemma-7B and Granite-34B; 4f
gates DeepSeek-V3's `loss_fn` with MTP and its grads (2 layers, 16
experts); 5b serves DeepSeek-V2-Lite-16B (27 layers, 29.3 GiB in bf16) and
Gemma-7B at full depth on slice 2's requests (one B5 launch a layer in the
prefill, none in decode), profiles V2-Lite's MoE and MLA stages, reads its
routing at depth (the share dropped at capacity, "cuda" against
"chunked"), and times B5 at both new shapes beside
`scaled_dot_product_attention`.

The hybrid, encoder-decoder and vlm families (slice 13): 3c holds B5 under
a local window (RecurrentGemma's MQA G = 10 at hd 256, W = 2,048: the
served L = 4,096, a ragged L and L <= W), with Lq != Lk (Seamless's
cross-attention, 512 x 3,072 and a ragged 37 x 3,001) and causal at
LLaVA's GQA G = 7, f32 and bf16, against its plain version, and 3f the
window and cross modes' grads; (r) gates, float32 at full width, "cuda"
against "chunked": RecurrentGemma at 1 superblock + a tail rec (the ring's
kpos equal), Seamless at 2 + 2 layers (prefill_fn, then decode replay),
LLaVA at 2 layers (the text's prefill and decode, and prefill_fn over
1,152 patches); `loss_fn` + backward of RecurrentGemma (window binding)
and Seamless; then serves (o) RecurrentGemma-2B (26 layers, 8 "window"
launches a prefill) on slice 2's requests, (p) SeamlessM4T-medium (12 +
12 layers; prefill_fn over 4 x (3,072 frames + 512 tokens): 12 "full",
12 "causal", 12 "cross" launches; 64 decode_fn steps of replay) and (q)
LLaVA-NeXT-34B (60 layers, 64.1 GiB; prefill_fn over 1,152 patches ahead
of the text, then prefill_into_cache and decode steps on the text,
its lengths halved to fit the card), and times the new modes beside
`scaled_dot_product_attention` (the window as an explicit mask).

The serving engine (slice 14): `serve.engine.ServeEngine` over 4 slots
on cell (d)'s topo Llama-3.2-1B at degree 1, full width and depth. 4k
gates it in float32: (d) first, the fault matrix (serve.logits NaN-ing
one slot, serve.step raising: the clean run's tokens and the counters of
tests/test_serving_faults.py), then nothing armed; (a) 8 requests of
517-4,096 tokens through 4 slots with mid-wave admission, "cuda" against
"torch": equal tokens and counters, no failure counter set, the ladder
unmoved, B2 16 launches per plain prefill group and none in decode
(counted from 0 around the "cuda" run: the slice's main path), one
trace_guard record per bucket; (b) fused against replay; (c) 4 requests
with their own prompt trees served from one packed forest plan: the
packed prefill against single-tree prefills (<= 1e-5), batched tokens
against single-slot ones, an incremental eviction, no B2 launch. 5i
times the same traffic in bf16 (time to first token and total per
request, prefill and decode host ms, tokens/s, peak memory), one tree
group, and profiles one plain prefill group, one tree group (the
fastmult's share; on the model cut to 4 layers) and one decode tick.

Multi-rank FTFI (slice 15, cell (t)): `core.plan_shard` over
`torch.distributed`, each rank one process (`launch.mesh.run_local`, a
FileStore in a temporary directory). 4l(a) runs `apply_sharded` on one
NCCL rank at cell (a)'s plan (d = 4 and 64; the four B1 families on "cuda",
exp and poly on "torch") against single-device `apply` (<= 1e-5), one B1
launch per cross bucket; 4l(b) on one gloo group of 4 processes sharing
the card (D = 4 shards): exp, poly and rational on "cuda" and a raw
callable through the Chebyshev engine, grads into X and the params, a
64-edit `update_plan` plan and cell (c)'s forest, each against
single-device `apply` on the card (<= 1e-5), exactly one all_to_all and
one reduce_scatter per forward (the result comes back sharded by rows:
no all_gather) and one B1 launch per live cross bucket on each rank; 4l(c) the sharded kernel faces on a (2, 2) mesh
(B1 at (a)'s largest bucket with a ragged B; B2 at cell (d)'s shape in
decay and rank-16 mode, and at H = 30 and 31: 31 drops the head axis) against the
single-device calls (<= 1e-6, the largest difference printed); 4l(d)
TopoViT-B/16 at full width in float32 with `topo_shard_plan` over the 4
ranks, 2 images (cut from 8), against the single-device forward (<=
1e-4), 2 x 12 sharded fastmults with their collectives (the tokens
sharded by rows between them), and each block's
mask coefficient grads on one image against the single-device backward's
(<= 1e-3 of their largest, 4e's bound). 5j prints `shard_stats` at D = 1, 2, 4, 8 and each rank's
host and CUDA-event ms of `apply_sharded` and of each collective, labelled
"one rank" or "4 processes sharing one H100": none is a multi-GPU time.

The LM's parameter sharding (slice 16, path (u)): `launch.sharding`'s
rules as DTensor placements on a (2, 2) mesh over ("data", "model") of 4
gloo processes sharing the card, float32, every result against the
single-device one of the same seed, computed first in this process. 4m(a)
runs 2 steps of `launch.steps.make_train_step` on the full-width dense
(B5) and topological (degree 2, B2 rank-16) Llama-3.2-1B cut to 2 layers,
4 x 512 tokens: the losses within the reference's bounds, the step's
grads and grad norm within fixed bounds (a grad left partial must read
above them), the parameters after the first step within 1e-5 on the
elements whose one-device grad is clear of the rounding
(`PSHARD_PARAM_TOL`), one kernel launch a layer a forward on every rank. 4m(b): DeepSeek-V2-Lite (1 dense + 1 MoE layer,
64 experts over the model axis, 2 dispatch groups over data, MLA through
B5) and Falcon-Mamba-7B (2 layers, B6 on each rank's 4,096 channels)
losses within 1e-3, V2-Lite's routing equal per group. 4m(c): the dense
state saved from (2, 2), restored on one device and on (1, 4) bit for
bit, one more step on each, the two steps held to each other as 4m(a)'s. 4m(d): TopoViT-B/16, 8 images over data,
logits within 1e-4, the mask coefficients' grads finite and non-zero;
then (slice 19, ROADMAP C12) the same model with `topo_shard_plan`, the
plan's row blocks over the model axis: its logits (8 images) within 1e-4
of one device's and its mask coefficient grads (2 images) within 4l(d)'s
1e-3 of one device's, relative to the largest grad of all blocks (per
block, one block's grads 1/300 of the largest read ~3e-3 of its own max
between two single-device impls; printed beside), its fields traded between heads and
rows by 2 all_to_alls a layer (their 2 VJPs in the backward), no field
all_gathered either way, and a rank receiving at most half a layer's
bytes of gathering the fields whole (printed by kind and bytes a layer).
5k prints, per rank of "4 processes sharing one H100", the bytes of the
parameters, grads and AdamW state against one device's, peak memory,
step ms and the collectives of one step by kind, and the vocab-sharded
cross-entropy's collectives alone (none of the logits' size).

The cost count, the roofline and the dry run (slice 17, ROADMAP A13):
`roofline.count.CostCount` reads the served bf16 prefill of the 4 requests
(4 x 4,096, full width and depth) in cells (d) degree 1 and 2 and (e),
each kernel wrapper recording its work formula (`roofline/kernels.py`,
the formulas behind every bound this script prints). 4n holds the count
of the live run on the card (the kernels launched) against the same step
counted on the plain route under FakeTensorMode on the CPU: the flops and
the bytes must be equal, and the count must see every launch. 5l prints each prefill's
roofline terms (compute, memory, the bound) and the MFU (model_flops over
the median CUDA-event time at 989 TFLOP/s) and fails if the bound exceeds
1.05 of the time; then one dry-run record (`launch.dryrun.analyze_cell`:
Llama-3.2-1B x train_4k on a fake group of the 16 x 16 production mesh).
The plain counts and the dry run need no card: they run in spawned worker
processes, started once the card's prefills are timed (so no time is
taken under their load) and ended before the slice ends.

The field by rows and sharded serving (slice 18, ROADMAP A12c and A12d;
paths (t') and (v)). 4o(a), inside slice 15's gloo run: `apply_sharded`
on cell (a)'s plan with the field a `Shard(0)` DTensor (each rank its
rows), exp on "cuda", d = 64, B1 counted from 0 around the call: the
rows gathered against single-device `apply` (<= 1e-6), the result
sharded by rows, exactly one all_to_all and one reduce_scatter by
`launch.collectives`' counts and by a census of every collective, one B1
launch per live cross bucket. 4o(b): one gloo group of 4 processes
sharing the card on a (2, 2) mesh runs `launch.steps.make_serve_step` on
the full-width Llama-3.2-1B cut to 2 layers, float32 (dense and
topological at degree 2, B = 4 over 4,096 positions filled by the
single-device prefill of 4 x 512 tokens; dense at B = 1 over 32,768
with the sequence over data), 8 greedy steps each, the cache, token and
pos placed by `launch.specs.decode_shardings`: each step against the
single-device step computed first on the rank (tokens equal, logits
<= 1e-4, the rank's cache slab <= 1e-5), no collective sending a cache
slab's storage, the largest all_gather under 1/100 of the slab. 5m
prints 4o(a)'s per-rank host and CUDA-event ms and collective ms, 4o(b)'s
per-rank step ms, cache slab against one device's cache, peak memory and
collectives by kind and bytes, all labelled "4 processes sharing one
H100", and the dry-run records of Llama-3.2-1B x decode_32k and x
long_500k (slice 17's worker, after its train cell).

The reference's example entry points (slice 19): `phase_examples` runs
the `main` of each module of `repro_torch.examples` on the card, as a
user starts them (`python -m repro_torch.examples.<name>`): the quickstart
at its default n = 6,000 (B1 counted from 0 around it: one launch per
cross bucket of its "cuda" Integrator; every relative error against BTFI
<= 1e-5, the edge-weight gradient finite and non-zero), the mesh
interpolation (icosphere 3 and 4, the "host" walk; each best cosine in
(0, 1]), the served smoke Qwen2 (every request answered in full) and the
topological LM's training with `--topo-impl cuda`, cut to
`EXAMPLES["train_steps"]` steps for the script's time (B2 counted from 0
around it: one launch a layer a forward and one a layer in the remat's
recompute; every loss finite). Slice 20 adds the graph classification
(the paper's application (b)) with `--backend torch,cuda` at D&D's graph
sizes, 30-539 vertices, cut from D&D's 1,178 graphs to
`EXAMPLES["graph_classification"]`'s 300 for the script's time: its forest
plan has cross buckets (asserted), B1 is counted from 0 around it (one
launch a cross bucket an `integrate` of the "cuda" route, two calls), both
routes' kernels read with the host loop's float64 `eigvalsh` are within
1e-5 of the host loop and of each other, and B1 is timed against its
plain version, `bmm` and its bound at the plan's buckets (d = n_max).

Cut for the script's time when slice 16 came: the served paths' decode
steps 32 -> 8, 4e's float32 batch 64 -> 32 images (2 column chunks), 5e's
bf16 batch 64 -> 16 images, 4l(d) 8 -> 2 images. When slice 18 came: 5f's
depth 16 -> 4 layers (its checkpoint's save, restore and resume on the
host; slice 9 174.3 -> 66.6 s on one host). When slice 19 came (one host
read 1,058.2 s): 4c's float32 Falcon-Mamba gate 64 -> 16 layers (46.7 s
at 64), the traced decode steps 4 -> 1 a profile (91.1 s for the 11 at
4 calls: the profiler's events, not the steps), the training example
60 -> 30 steps, 5i's traced tree group 16 -> 4 layers (59.7 s at 16).

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
if (ROOT / "src" / "repro_torch").is_dir():
    sys.path.insert(0, str(ROOT / "src"))
    # each kernel's work and bound: one source with the port's cost count
    from repro_torch.roofline.kernels import (  # noqa: E402
        BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S,
        TF32_FLOPS_PER_S, bound, flash_work, linear_work, scan_bound,
        scan_work, topo_work)
    from repro_torch.roofline.kernels import fdist_work as work  # noqa: E402

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


_T0 = time.perf_counter()


def _stamp(label: str) -> None:
    """The script's elapsed host time at a slice's boundary (what the
    run's time limit reads)."""
    print(f"[elapsed] {time.perf_counter() - _T0:.1f} s: {label}",
          flush=True)


def _time_phases() -> None:
    """Print each phase's host seconds as it ends, its label if it takes
    one first: where the run's time limit goes. For the script's own
    process only (the ranks' workers import the module unwrapped)."""
    g = globals()

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                tag = f" {args[0]}" if args and isinstance(args[0], str) \
                    else ""
                _stamp(f"{name}{tag} took {time.perf_counter() - t0:.1f} s")
        return wrapper

    for name, fn in list(g.items()):
        if name.startswith("phase_") and callable(fn):
            g[name] = timed(name, fn)


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
    from repro_torch.examples.graph_classification import make_dataset

    return make_dataset(cfg["per_class"], cfg["size_range"])[0]


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
        # steps: the served paths' greedy decode steps (cut from 32 for the
        # script's time)
        "Lp": 4096, "S": 4128, "steps": 8, "gate_steps": 4,
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


def _prompts(cfg, req=None):
    """The requests of `req` (TOPO's by default: "lengths", padded to
    "Lp"): seeded tokens, zeros past each length."""
    req = req or TOPO
    rng = np.random.default_rng(TOPO["seed"])
    lengths = np.array(req["lengths"], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (len(lengths), req["Lp"]))
    toks[np.arange(req["Lp"])[None, :] >= lengths[:, None]] = 0
    return toks.astype(np.int32), lengths


def _serve(cfg, model, toks, lengths, steps, device, ops, feed=None,
           S=None):
    """prefill_into_cache, then `steps` decode steps at per-slot positions:
    greedy, or the tokens of `feed` (another run's) when given, with a
    cache of S positions (TOPO's by default). Returns (prefill logits,
    prefill cache, step logits, fed tokens, launches of the kernel that
    `ops` counts in the prefill, and in the decode)."""
    import torch
    from repro_torch.models import api

    S = S or TOPO["S"]
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
    B = logits.shape[0]
    if logits.shape != (B, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    for lg in step_logits:
        if lg.shape != (B, 1, V) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"decode logits {tuple(lg.shape)}")
    toks = torch.cat(fed, dim=1)
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("a greedy token fell outside the vocabulary")


def _routing(trace) -> list:
    """(expert ids, kept mask) of each dispatch `moe.TRACE` recorded."""
    return [(r["expert_ids"], r["keep"]) for r in trace]


def routing_diff(a: list, b: list) -> int:
    """How many (token, k) assignments differ between two runs' routings,
    in the expert chosen or in being kept."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} dispatches against {len(b)}")
    return sum(int(((ea != eb) | (ka != kb)).sum())
               for (ea, ka), (eb, kb) in zip(a, b))


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict (a decode cache)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _cache_by_layer(cfg, got, want) -> list:
    """Each layer's cache error, relative to the largest of its whole leaf
    (the gated measure), in layer order: how the difference grows with
    depth."""
    from repro_torch.models import lm

    where = {layer: (path, j, stacked)
             for path, _, layers, stacked in lm.slots(cfg)
             for j, layer in enumerate(layers)}
    out = []
    for layer in range(len(where)):
        path, j, stacked = where[layer]
        g, w = lm._node(got, path), lm._node(want, path)
        out.append(max(float((g[k][j] if stacked else g[k]).double().sub(
            (w[k][j] if stacked else w[k]).double()).abs().max())
            / max(float(w[k].double().abs().max()), 1e-30) for k in w))
    return out


def phase_gate(label, cfg, plain_cfg, ops, device, req=None, expect=None):
    """4b/4c gate: float32 (TF32 off), the same weights served through the
    kernel (`cfg`) and through its plain version (`plain_cfg`): prefill
    logits, cache (every segment) and the first decode steps agree; one
    kernel launch per layer in the prefill, none in decode and none on the
    plain run; decode vs prefill of the extended prompt is printed, not
    gated. `req` takes other requests than TOPO's ("lengths", "Lp", "S");
    `expect` other launches per prefill than one a layer (the hybrid's
    attention layers only).
    With MoE layers the gate first holds the routing: each MoE layer's
    expert ids and kept mask in the prefill must be equal between the two
    runs; differing assignments are counted (decode's too, printed)."""
    import torch
    from repro_torch.models import api
    from repro_torch.models import moe

    req = req or TOPO
    S = req["S"]
    model = api.init_params(cfg, TOPO["seed"], device=device)
    toks, lengths = _prompts(cfg, req)
    n = TOPO["gate_steps"]
    n_moe = sum(1 for blk in model.blocks if hasattr(blk, "moe"))

    def traced(c, steps, feed=None):
        moe.TRACE = []
        try:
            return (_serve(c, model, toks, lengths, steps, device, ops,
                           feed=feed, S=S), _routing(moe.TRACE))
        finally:
            moe.TRACE = None

    got, r_got = traced(cfg, max(n, 2))
    want, r_want = traced(plain_cfg, n, got[3])
    expect = cfg.num_layers if expect is None else expect
    if got[4] != expect or got[5] != 0:
        raise AssertionError(f"{label} float32: {got[4]} kernel launches in "
                             f"the prefill, expected {expect} for "
                             f"{cfg.num_layers} layers; {got[5]} in decode")
    if want[4] or want[5]:
        raise AssertionError(f"{label}: the plain run launched the kernel")
    route_pre = routing_diff(r_got[:n_moe], r_want[:n_moe])
    route_dec = routing_diff(r_got[n_moe:n_moe * (n + 1)], r_want[n_moe:])
    _check_served(cfg, got[0], got[2], got[3])
    e_logits = rel_err(got[0], want[0])
    g_flat, w_flat = _flat(got[1]), _flat(want[1])
    leaves = list(w_flat)
    # integer leaves (the local ring's kpos) must be equal
    if any(not torch.equal(g_flat[k], w) for k, w in w_flat.items()
           if not w.is_floating_point()):
        raise AssertionError(f"{label}: an integer cache leaf differs")
    e_cache = max(rel_err(g_flat[k], w_flat[k]) for k in leaves)
    by_layer = _cache_by_layer(cfg, got[1], want[1])
    e_steps = [rel_err(a, b) for a, b in zip(got[2][:n], want[2])]
    ok = (route_pre == 0 and e_logits <= LOGIT_TOL and e_cache <= CACHE_TOL
          and max(e_steps) <= LOGIT_TOL)
    # decode vs prefill of the prompt extended by the fed tokens
    ext = np.zeros((len(lengths), req["Lp"] + 2), np.int32)
    ext[:, :req["Lp"]] = toks
    rows = np.arange(len(lengths))
    for k in (0, 1):
        ext[rows, lengths + k] = got[3][k][:, 0].cpu().numpy()
    e_dp = []
    for k in (1, 2):
        cache = api.init_cache(cfg, len(lengths), S, device=device)
        lg, _ = api.prefill_into_cache(cfg, model, cache, ext, lengths + k,
                                       S, device=device)
        e_dp.append(rel_err(got[2][k - 1][:, 0], lg))
    print(f"[{label} gate] float32, matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, depth {cfg.num_layers} "
          f"of {cfg.num_layers} layers, width {cfg.d_model}, requests "
          f"{tuple(req['lengths'])} (S={S}): "
          + (f"routing of {n_moe} MoE layers: {route_pre} assignments differ "
             f"in the prefill (= 0), {route_dec} in decode; "
             if n_moe else "") +
          f"kernel vs plain "
          f"prefill logits {e_logits:.2e} (< {LOGIT_TOL}), cache "
          f"{'/'.join(sorted({k.split('.')[-1] for k in leaves}))} "
          f"{e_cache:.2e} (< {CACHE_TOL}), "
          f"decode steps 1-{n} {max(e_steps):.2e} (< {LOGIT_TOL}); {got[4]} "
          f"launches in the prefill, {got[5]} in decode | not gated: decode "
          f"vs prefill of the extended prompt {e_dp[0]:.2e}, {e_dp[1]:.2e}; "
          f"cache error by depth: layer 0 {by_layer[0]:.1e}, layer "
          f"{len(by_layer) // 2} {by_layer[len(by_layer) // 2]:.1e}, layer "
          f"{len(by_layer) - 1} {by_layer[-1]:.1e}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel and plain paths disagree")
    return {"label": label, "dtype": "float32", "layers": cfg.num_layers,
            "requests": list(req["lengths"]), "S": S,
            "routing_diff_prefill": route_pre,
            "routing_diff_decode": route_dec,
            "rel_err_prefill_logits": e_logits, "rel_err_cache": e_cache,
            "rel_err_decode": e_steps, "rel_err_cache_by_layer": by_layer,
            "launches_per_prefill": got[4],
            "launches_in_decode": got[5], "decode_vs_prefill": e_dp}


def phase_serve(label, cfg, ops, device, card, scopes=(), expect=None):
    """4b/4c main path + 5b/5c times at the config's dtype (bf16): 4
    requests, prefill_into_cache then TOPO["steps"] greedy decode steps,
    with the kernel count from 0 just before and read just after; then
    prefill and
    decode times, the peak device memory of the served run, and the
    profiles of one prefill and one decode step (with `scopes`' device
    ms). `expect`: the launches of the main path, one a layer unless
    given."""
    import torch
    from repro_torch.models import api

    model = api.init_params(cfg, TOPO["seed"], device=device)
    toks, lengths = _prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    by_mode = getattr(ops, "LAUNCHES_BY_MODE", {})
    for mode in by_mode:
        by_mode[mode] = 0
    t0 = time.perf_counter()
    logits, cache, step_logits, fed, _, _ = _serve(
        cfg, model, toks, lengths, TOPO["steps"], device, ops)
    serve_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = ops.LAUNCHES
    launches_by_mode = dict(by_mode)
    expect = cfg.num_layers if expect is None else expect
    if launches != expect:
        raise AssertionError(f"{label}: {launches} kernel launches on the "
                             f"main path, expected {expect}")
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
           "params": api.param_count(model), "peak_gib": peak_gib,
           "card": card}
    kind = (cfg.attention_variant if cfg.family == "dense"
            else cfg.family)
    print(f"[{label} serve] {cfg.name} {kind}, {cfg.dtype}, "
          f"{cfg.num_layers} layers, {out['params']} params: 4 requests "
          f"(lengths {TOPO['lengths']}, S={S}), prefill + {TOPO['steps']} "
          f"greedy steps in {serve_s:.2f} s, {launches} kernel launches | "
          f"prefill {pre_ms:.1f} ms ({out['prefill_tokens_per_s']:.0f} "
          f"tok/s), decode {dec_ms:.2f} ms/step "
          f"({out['decode_tokens_per_s']:.0f} tok/s), peak "
          f"{peak_gib:.2f} GiB | {card}", flush=True)
    out["profile_prefill"] = phase_calls_profile(
        f"{label} prefill", lambda: api.prefill_into_cache(
            cfg, model, api.init_cache(cfg, B, S, device=device), toks,
            lengths, S, device=device), scopes=scopes)
    out["profile_decode"] = phase_calls_profile(
        f"{label} decode step", lambda: api.decode_fn(
            cfg, model, cache, tok, pos, S, device=device), scopes=scopes)
    return out


def phase_calls_profile(label, fn, kinds=None, scopes=()):
    """torch.profiler over one call of fn(): device busy share of the
    window and the top device ops with their share of device time; with
    `kinds` ({kind: substrings of op names}), also the device ms of every
    op by kind (the first kind that matches; "other" for none); with
    `scopes` (names of `record_function` ranges or aten ops), the device
    ms each one's kernels took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ops_ = []
    for ev in events:
        us = getattr(ev, "self_device_time_total", 0)
        # a record_function range shows on the device too, as the span of
        # its kernels: not an op of its own
        if (ev.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not getattr(ev, "is_user_annotation", False)
                and ev.key not in scopes):
            ops_.append({"name": ev.key[:90], "ms": us / 1e3,
                         "calls": ev.count})
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
    if scopes:
        out["scopes"] = {name: 0.0 for name in scopes}
        for ev in events:
            if ev.key in out["scopes"] and ev.device_type != \
                    torch.autograd.DeviceType.CUDA:
                out["scopes"][ev.key] += (getattr(ev, "device_time_total", 0)
                                          / 1e3)
    print(f"[profile {label}] wall {wall_ms:.2f} ms per call under the "
          f"profiler, device {dev_ms:.2f} ms, busy share {out['busy']:.2f}, "
          f"{out['launches']:.0f} device ops; top: " + "; ".join(
              f"{k['name'][:38]} {k['ms']:.2f} ms ({k['share']:.0%}) "
              f"x{k['calls']:g}" for k in ops_[:6]) + (
              "; by scope: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                         out["scopes"].items())
              if scopes else ""), flush=True)
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
       # 4c's float32 gate, cut from 64 for the script's time
       "gate_layers": 16,
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
       # serve_batch: 4e's batch, whose folded field spans 2 column
       # chunks; time_batch: 5e's bf16 batch (cut from 64 images for the
       # script's time)
       "gate_batch": 2, "serve_batch": 32, "time_batch": 16, "seed": 0,
       "reps": 3,
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

    B, H, L, m = (VIT["time_batch"], cfg.num_heads,
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
    """5e: TopoViT-B/16 served in bf16, impl "cuda", a batch of 16 images
    (224 x 224, 196 patches of 768), and the "performer" variant at the same
    shape: forward ms and images/s (host clock to synchronize), peak
    device memory, the profile of one forward, and the fastmult's share of
    device time (12 x one layer's two fastmults, profiled alone)."""
    import torch
    from repro_torch.kernels.fdist_matvec import ops as fdist_ops
    from repro_torch.models import vit

    B = VIT["time_batch"]
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
         "gate_degrees": (1, 2), "gate_layers": 2,
         # 5f's depth, cut from 16 for the script's time: its checkpoint
         # save, host restore and resume (numpy on the host, ~12 GB of
         # state at full depth) took ~90 s of the run
         "layers": 4}
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
    logit_scale) as one (`blocks` or another stack of layers, an encoder's
    and a decoder's apart): a0 and logit_scale cancel in the normalization, so
    their exact grads are 0 but for phi's +1e-6, and what the card gives
    for them is rounding."""
    parts = name.split(".")
    if len(parts) < 3 or not parts[1].isdigit():
        return name
    return f"{parts[0]}.topo" if parts[2] == "topo" else ".".join(
        [parts[0]] + parts[2:])


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


def phase_train_gate(label, cfg, plain_cfg, ops, device, floor_cfg=None,
                     batch=None, seq=None, launches=None):
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
    holds the relu grads there at TRAIN_GRAD_TOL.

    `batch` and `seq` replace TRAIN's gate batch; the vlm's patches and the
    encdec's frames come from the stream as the training loop draws them.
    A model with the MTP head launches one kernel more a forward (the MTP
    block's attention, not recomputed by the remat); `launches` (forward,
    backward) replaces the expected counts (the hybrid's and encdec's
    attention calls)."""
    import torch
    from repro_torch.data.synthetic import SyntheticLMStream
    from repro_torch.models import api, lm

    batch, seq = batch or TRAIN["gate_batch"], seq or TRAIN["gate_seq"]
    model = api.init_params(cfg, TRAIN["seed"], device=device)
    data = SyntheticLMStream(
        cfg.vocab_size, batch, seq, seed=TRAIN["seed"],
        vlm_prefix=cfg.num_prefix_embeddings if cfg.family == "vlm" else 0,
        encdec_src=cfg.max_source_len if cfg.is_encdec else 0).batch_at(0)

    def loss_and_grads(c):
        before = ops.LAUNCHES
        loss, _ = api.loss_fn(c, model, data, device=device)
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
    n_fwd = n + (1 if cfg.mtp_depth > 0 else 0)
    launches = launches or (n_fwd, n if remat else 0)
    if (fwd_k, bwd_k, fwd_p, bwd_p) != (*launches, 0, 0):
        raise AssertionError(f"{label}: launches forward {fwd_k}, backward "
                             f"{bwd_k} (expected {launches}); plain "
                             f"{fwd_p}, {bwd_p}")
    errs, own = _grad_errors(got, want)
    del got
    worst = max(errs, key=errs.get)
    worst_own = max(own, key=own.get)
    layer_of = {}  # (stack, layer) in order, e.g. ("blocks_dec", 1)
    for k, e in errs.items():
        parts = k.split(".")
        if len(parts) > 2 and parts[1].isdigit():
            key = (parts[0], int(parts[1]))
            layer_of[key] = max(layer_of.get(key, 0.0), e)
    by_layer = list(layer_of.values())
    n = len(by_layer)
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
          f"{cfg.d_model}, B={batch} L={seq}"
          + (f" (+ {cfg.num_prefix_embeddings} patches)"
             if cfg.family == "vlm" else "")
          + (f" (+ {cfg.max_source_len} source frames)"
             if cfg.is_encdec else "") + ", "
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
    bf16 at full width, TRAIN["layers"] deep, for TRAIN["steps"] steps, the sweep's
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

    cfg = _train_cfg(TRAIN["degree"]).replace(num_layers=TRAIN["layers"])
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


def _random_edits(tree, edits: int, seed: int):
    """`edits` seeded update_plan ops on `tree` (inserts, deletes of live
    leaves, one reweight halfway), with the edited tree beside them."""
    rng = np.random.default_rng(seed)
    model = _Edits(tree)
    ops_list = []
    for k in range(edits):
        if k == edits // 2:
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
    return ops_list, model


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
    ops_list, model = _random_edits(tree, cfg["edits"], cfg["edit_seed"])
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


# ----------------------------------------------------------------------------
# slice 11: the Integrator facade (4i), the paper's Fig. 4 mesh
# interpolation (4j) and the facade's times against BTFI (5h)
# ----------------------------------------------------------------------------

# benchmarks/bench_mesh_interpolation.py:40-115: three meshes (FRT rows
# where n <= 3,000), 20% of the vertices known from one default_rng(0) in
# mesh order, f = 1 / (1 + lam x^2), leaf 128; plus cell (b)'s icosphere(5)
# for the MST rows
MESH = {"meshes": (("ico3", "ico", 3), ("ico4", "ico", 4),
                   ("torus", "torus", (48, 24)), ("ico5", "ico", 5)),
        "mst_only": ("ico5",), "frt_max_n": 3000, "known": 0.2,
        "lambdas": (1.0, 4.0, 16.0), "leaf": 128, "forest_trees": 4}
COS_TOL = 1e-4  # a method's best cosine, "cuda" against the host walk
FACADE = {"families": ("Exponential", "Rational", "Polynomial"),
          "host_reps": 2}


def _launches_checked(integ, fn, X, what):
    """integ.integrate(fn, X) on the card; on backend "cuda" with a kernel
    family, exactly one B1 launch per cross bucket of its plan."""
    import torch
    from repro_torch.core.engines import spec_of
    from repro_torch.kernels.fdist_matvec import ops

    before = ops.LAUNCHES
    Y = integ.integrate(fn, X)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES - before
    want = (len(integ.spec.cross_tgt_d0) if integ.backend == "cuda"
            and spec_of(fn).mode is not None else 0)
    if launched != want:
        raise AssertionError(f"{what}: {launched} fdist_matvec launches for "
                             f"{want} kernel cross buckets")
    if Y.shape != X.shape or not bool(torch.isfinite(Y).all()):
        raise AssertionError(f"{what}: bad output {tuple(Y.shape)}")
    return Y, launched


def _worst(got, want) -> str:
    """The element of the largest error, for a failed gate's message."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    i = np.unravel_index(int(np.argmax(np.abs(got - want))), got.shape)
    return f"worst at {tuple(int(k) for k in i)}: {got[i]!r} vs {want[i]!r}"


def _np(t):
    import torch

    return t.detach().double().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float64)


def phase_facade(cfg, device):
    """4i: `Integrator` on cell (a)'s tree. "cuda" and "torch" with device
    left at None (the card): bit for bit `ftfi.apply` on the same plan
    (deterministic index_add_), within EXACT_TOL of the card's BTFI ("torch"
    for its exact families), one B1 launch per cross bucket on "cuda",
    `describe`; "host" (the FTFI walk, ExpMP for Exponential) within
    EXACT_TOL of BTFI; `from_forest` on cell (c)'s forest, "cuda" against
    the host's per-tree loop; `from_plan` on a saved and loaded plan, and
    its plan guard."""
    import shutil
    import tempfile
    import warnings

    import torch
    from repro_torch import ftfi
    from repro_torch.core import Integrator
    from repro_torch.core.engines import spec_of
    from repro_torch.core.integrate import BTFI
    from repro_torch.graphs.graph import Forest
    from repro_torch.graphs.mst import minimum_spanning_forest
    from repro_torch.testing import faults

    tree = synthetic_tree(cfg)
    fams = families()
    t0 = time.perf_counter()
    integs = {b: Integrator(tree, backend=b, leaf_size=cfg["leaf"])
              for b in ("cuda", "torch")}
    host = Integrator(tree, backend="host", leaf_size=cfg["leaf"])
    build_s = time.perf_counter() - t0
    dense = BTFI(tree, device=device)
    rng = np.random.default_rng(17)
    rows = []
    for d in cfg["widths"]:
        X = torch.tensor(rng.normal(size=(tree.num_vertices, d)),
                         dtype=torch.float32, device=device)
        for fname, fn in fams:
            want = dense.integrate(fn, X)
            row = {"family": fname, "d": d}
            for b, integ in integs.items():
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # no deterministic cuBLAS
                    torch.use_deterministic_algorithms(True, warn_only=True)
                    try:
                        Y, launched = _launches_checked(
                            integ, fn, X, f"4i {b} {fname} d={d}")
                        Yf = ftfi.apply(integ.spec, integ.params, fn, X,
                                        backend=b, device=X.device)
                    finally:
                        torch.use_deterministic_algorithms(False)
                engine = integ.describe(fn)["cross_engine"]
                exact = b == "cuda" or fname in ("Exponential", "Polynomial")
                err = rel_err(Y, want)
                if not torch.equal(Y, Yf):
                    raise AssertionError(
                        f"4i {b} {fname} d={d}: Integrator.integrate is not "
                        f"ftfi.apply bit for bit ({_worst(_np(Y), _np(Yf))})")
                if exact and not err <= EXACT_TOL:
                    raise AssertionError(
                        f"4i {b} {fname} d={d}: rel err {err:.3e} vs BTFI > "
                        f"{EXACT_TOL} ({_worst(_np(Y), _np(want))})")
                want_engine = f"fdist_matvec:{spec_of(fn).mode}"
                if b == "cuda" and engine != want_engine:
                    raise AssertionError(f"4i cuda {fname}: engine {engine}")
                row.update({f"{b}_engine": engine, f"{b}_launches": launched,
                            f"{b}_rel_err": err, f"{b}_gated": exact})
            Yh = host.integrate(fn, X.double())
            err = rel_err(Yh, want)
            if (Yh.device != X.device or Yh.dtype != torch.float64
                    or not err <= EXACT_TOL):
                raise AssertionError(
                    f"4i host {fname} d={d}: rel err {err:.3e} vs BTFI "
                    f"(<= {EXACT_TOL}), {Yh.dtype} on {Yh.device} "
                    f"({_worst(_np(Yh), _np(want))})")
            row.update(host_engine=host.describe(fn)["cross_engine"],
                       host_rel_err=err)
            rows.append(row)
            print(f"[facade] n={tree.num_vertices} d={d} {fname}: cuda "
                  f"({row['cuda_engine']}, {row['cuda_launches']} launches) "
                  f"{row['cuda_rel_err']:.2e} | torch ({row['torch_engine']})"
                  f" {row['torch_rel_err']:.2e}"
                  + ("" if row["torch_gated"]
                     else " (approximation, not gated)")
                  + f" | host ({row['host_engine']}) {err:.2e} vs BTFI; "
                  "integrate == ftfi.apply bit for bit", flush=True)
    del dense

    # cell (c)'s forest: one fused plan against the host's per-tree loop
    forest = Forest(minimum_spanning_forest(graph_dataset(cfg)))
    fi = Integrator.from_forest(forest, backend="cuda",
                                leaf_size=cfg["forest_leaf"])
    fh = Integrator.from_forest(forest, backend="host",
                                leaf_size=cfg["forest_leaf"])
    Xf = torch.tensor(rng.normal(size=(forest.num_vertices, 8)),
                      dtype=torch.float32, device=device)
    forest_rows = []
    for fname, fn in fams:
        Y, launched = _launches_checked(fi, fn, Xf, f"4i forest {fname}")
        want = fh.integrate(fn, _np(Xf))
        err = rel_err(Y, torch.from_numpy(want).to(device))
        if launched == 0 or not err <= EXACT_TOL or fi.num_trees != 90:
            raise AssertionError(
                f"4i forest {fname}: {launched} launches, rel err {err:.3e} "
                f"vs the host loop, {fi.num_trees} trees "
                f"({_worst(_np(Y), want)})")
        forest_rows.append({"family": fname, "launches": launched,
                            "rel_err": err})
    print(f"[facade forest] {forest.num_trees} MSTs, leaf "
          f"{cfg['forest_leaf']}, d=8: cuda vs the host's per-tree loop "
          + ", ".join(f"{r['family']} {r['rel_err']:.2e} ({r['launches']} "
                      "launches)" for r in forest_rows), flush=True)

    # from_plan: a saved and loaded plan, and the plan guard
    integ = integs["cuda"]
    fn = fams[0][1]
    X = torch.tensor(rng.normal(size=(tree.num_vertices, 4)),
                     dtype=torch.float32, device=device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_facade_")
    try:
        path = os.path.join(tmp, "plan.npz")
        ftfi.save_plan(path, integ.spec, integ.params)
        spec2, params2 = ftfi.load_plan(path)
        loaded = Integrator.from_plan(spec2, params2, backend="cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                same = torch.equal(
                    _launches_checked(loaded, fn, X, "4i from_plan")[0],
                    integ.integrate(fn, X))
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    try:
        Integrator.from_plan(faults.flip_index(integ.spec), integ.params,
                             backend="cuda")
        refused = False
    except ftfi.PlanValidationError:
        refused = True
    if not (same and refused):
        raise AssertionError(f"4i from_plan: loaded plan equal {same}, "
                             f"flipped index refused {refused}")
    print(f"[facade from_plan] save_plan / load_plan / from_plan on cuda "
          f"equals the built Integrator bit for bit; a flipped index is "
          f"refused (PlanValidationError); facade build {build_s:.2f} s",
          flush=True)
    return {"rows": rows, "forest": forest_rows, "from_plan_equal": same,
            "flip_refused": refused, "build_s": build_s}


def random_spanning_tree(g, seed=0):
    """bench_mesh_interpolation's random spanning tree: the MST of the
    graph under uniform random weights, with its true edge lengths."""
    from repro_torch.graphs.graph import Graph, WeightedTree
    from repro_torch.graphs.mst import minimum_spanning_tree

    rng = np.random.default_rng(seed)
    g2 = Graph(g.num_vertices, g.edges_u, g.edges_v,
               rng.uniform(0.1, 1.0, g.num_edges))
    t = minimum_spanning_tree(g2)
    key = {(min(u, v), max(u, v)): w for u, v, w in
           zip(g.edges_u, g.edges_v, g.weights)}
    w = np.array([key[(min(u, v), max(u, v))]
                  for u, v in zip(t.edges_u, t.edges_v)])
    return WeightedTree(t.num_vertices, t.edges_u, t.edges_v, w)


def _cosine(pred, normals, known) -> float:
    """bench_mesh_interpolation._interpolate's score: the mean cosine of
    the normalized prediction and the true normal over unknown vertices."""
    pred = pred / np.maximum(np.linalg.norm(pred, axis=1, keepdims=True),
                             1e-12)
    return float(np.mean(np.sum(pred[~known] * normals[~known], axis=1)))


def phase_mesh(device, card):
    """4j: Fig. 4 on the card. For each mesh and method, the prediction
    M_f F of each f through the `Integrator` on "cuda" (B1 once per cross
    bucket) is held within EXACT_TOL of the host FTFI walk on the same
    tree, and the method's best cosine within COS_TOL of the host's;
    btfi_mst on the card against the host walk on the MST. Preprocessing
    seconds are cold (plan and flat-IT caches cleared), host clock to a
    synchronize."""
    import torch
    from repro_torch.core import Integrator, Rational
    from repro_torch.core.integrate import BTFI, clear_plan_cache
    from repro_torch.core.itree_flat import clear_flat_cache
    from repro_torch.graphs.frt import (forest_leaf_integrate, frt_forest,
                                        frt_tree)
    from repro_torch.graphs.meshes import (icosphere, mesh_graph, torus_mesh,
                                           vertex_normals)
    from repro_torch.graphs.mst import minimum_spanning_tree
    from repro_torch.graphs.traverse import graph_all_pairs
    from repro_torch.kernels.fdist_matvec import ops

    leaf, k = MESH["leaf"], MESH["forest_trees"]
    fns = [Rational((1.0,), (1.0, 0.0, lam)) for lam in MESH["lambdas"]]
    rng = np.random.default_rng(0)
    rows = []

    def cold(make):
        clear_plan_cache()
        clear_flat_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def leaf_field(F, n_tree):
        Ffull = np.zeros((n_tree, 3))
        Ffull[:F.shape[0]] = F
        return Ffull

    for name, kind, arg in MESH["meshes"]:
        verts, faces = icosphere(arg) if kind == "ico" else torus_mesh(*arg)
        normals = vertex_normals(verts, faces)
        g = mesh_graph(verts, faces)
        n = verts.shape[0]
        known = rng.random(n) < MESH["known"]
        F = np.where(known[:, None], normals, 0.0)
        Fd = torch.tensor(F, dtype=torch.float32, device=device)
        methods = []

        def mk_tree(make_tree):
            def make():
                t = make_tree()
                integ = Integrator(t, backend="cuda", leaf_size=leaf)
                _ = integ.params  # the plan's distances on the card
                return t, integ
            return make

        methods.append(("ftfi_mst", mk_tree(lambda: minimum_spanning_tree(g))))
        if name not in MESH["mst_only"]:
            methods.append(("ftfi_rst", mk_tree(
                lambda: random_spanning_tree(g))))
        for method, make in methods:
            (tree, integ), pre_s = cold(make)
            hint, host_pre_s = cold(lambda: Integrator(
                tree, backend="host", leaf_size=leaf))
            best, best_h, worst, launches = -1.0, -1.0, 0.0, 0
            for fn in fns:
                Y, launched = _launches_checked(integ, fn, Fd,
                                                f"4j {name} {method}")
                Yh = hint.integrate(fn, F)
                err = rel_err(Y, torch.from_numpy(Yh).to(device))
                if not err <= EXACT_TOL:
                    raise AssertionError(
                        f"4j {name} {method} {fn}: cuda vs host rel err "
                        f"{err:.3e} ({_worst(_np(Y), Yh)})")
                worst, launches = max(worst, err), launches + launched
                best = max(best, _cosine(_np(Y), normals, known))
                best_h = max(best_h, _cosine(Yh, normals, known))
            rows.append({"mesh": name, "n": n, "method": method,
                         "cos": best, "cos_host": best_h,
                         "pre_s": pre_s, "host_pre_s": host_pre_s,
                         "rel_err_vs_host": worst, "launches": launches,
                         "buckets": len(integ.spec.cross_tgt_d0)})
            if method == "ftfi_mst":  # the dense oracle on the same MST
                (dense, pre_b) = cold(lambda: BTFI(minimum_spanning_tree(g),
                                                   device=device))
                best_b, worst_b = -1.0, 0.0
                for fn in fns:
                    Yb = dense.integrate(fn, Fd)
                    Yh = hint.integrate(fn, F)
                    worst_b = max(worst_b, rel_err(
                        Yb, torch.from_numpy(Yh).to(device)))
                    best_b = max(best_b, _cosine(_np(Yb), normals, known))
                del dense
                if not worst_b <= EXACT_TOL:
                    raise AssertionError(f"4j {name} btfi_mst vs host: rel "
                                         f"err {worst_b:.3e}")
                rows.append({"mesh": name, "n": n, "method": "btfi_mst",
                             "cos": best_b, "cos_host": best_h,
                             "pre_s": pre_b, "host_pre_s": None,
                             "rel_err_vs_host": worst_b, "launches": 0,
                             "buckets": 0})
        if n <= MESH["frt_max_n"]:
            def make_frt():
                D = graph_all_pairs(g)
                t, lid = frt_tree(g, seed=0, D=D)
                integ = Integrator(t, backend="cuda", leaf_size=leaf)
                _ = integ.params
                return D, t, lid, integ
            (Dg, ft, lid, integ), pre_s = cold(make_frt)
            hint, host_pre_s = cold(lambda: Integrator(ft, backend="host",
                                                       leaf_size=leaf))
            Ffull = leaf_field(F, ft.num_vertices)
            Ffd = torch.tensor(Ffull, dtype=torch.float32, device=device)
            best, best_h, worst, launches = -1.0, -1.0, 0.0, 0
            for fn in fns:
                Y, launched = _launches_checked(integ, fn, Ffd,
                                                f"4j {name} ftfi_frt")
                Yh = hint.integrate(fn, Ffull)
                err = rel_err(Y, torch.from_numpy(Yh).to(device))
                if not err <= EXACT_TOL:
                    raise AssertionError(
                        f"4j {name} ftfi_frt {fn}: cuda vs host rel err "
                        f"{err:.3e} ({_worst(_np(Y), Yh)})")
                worst, launches = max(worst, err), launches + launched
                best = max(best, _cosine(_np(Y)[lid], normals, known))
                best_h = max(best_h, _cosine(Yh[lid], normals, known))
            rows.append({"mesh": name, "n": n, "method": "ftfi_frt",
                         "cos": best, "cos_host": best_h, "pre_s": pre_s,
                         "host_pre_s": host_pre_s, "rel_err_vs_host": worst,
                         "launches": launches,
                         "buckets": len(integ.spec.cross_tgt_d0)})

            def make_forest():
                forest, lid = frt_forest(g, k, seed=0, D=Dg)
                integ = Integrator.from_forest(forest, backend="cuda",
                                               leaf_size=leaf)
                _ = integ.params
                return forest, lid, integ
            (forest, lid, finteg), pre_s = cold(make_forest)
            fhost, host_pre_s = cold(lambda: Integrator.from_forest(
                forest, backend="host", leaf_size=leaf))
            del Dg
            best, best_h, worst, launches = -1.0, -1.0, 0.0, 0
            for fn in fns:
                before = len(finteg.spec.cross_tgt_d0)
                l0 = ops.LAUNCHES
                P = forest_leaf_integrate(forest, lid, finteg, fn, F)
                torch.cuda.synchronize()
                launched = ops.LAUNCHES - l0
                Ph = forest_leaf_integrate(forest, lid, fhost, fn, F)
                err = rel_err(P, torch.from_numpy(Ph).to(device))
                if launched != before or not err <= EXACT_TOL:
                    raise AssertionError(
                        f"4j {name} ftfi_frt_forest{k} {fn}: {launched} "
                        f"launches for {before} buckets, cuda vs host rel "
                        f"err {err:.3e} ({_worst(_np(P), Ph)})")
                worst, launches = max(worst, err), launches + launched
                best = max(best, _cosine(_np(P), normals, known))
                best_h = max(best_h, _cosine(Ph, normals, known))
            rows.append({"mesh": name, "n": n,
                         "method": f"ftfi_frt_forest{k}", "cos": best,
                         "cos_host": best_h, "pre_s": pre_s,
                         "host_pre_s": host_pre_s, "rel_err_vs_host": worst,
                         "launches": launches,
                         "buckets": len(finteg.spec.cross_tgt_d0)})
        for r in rows:
            if r["mesh"] != name:
                continue
            if not abs(r["cos"] - r["cos_host"]) <= COS_TOL:
                raise AssertionError(
                    f"4j {name} {r['method']}: best cosine {r['cos']:.6f} "
                    f"against the host's {r['cos_host']:.6f}")
            print(f"[fig4] {name} n={n} {r['method']}: cos {r['cos']:.4f} "
                  f"(host {r['cos_host']:.4f}), preprocessing "
                  f"{r['pre_s']:.3f} s"
                  + (f" (host {r['host_pre_s']:.3f} s)"
                     if r["host_pre_s"] is not None else "")
                  + f", cuda vs host rel err {r['rel_err_vs_host']:.2e}, "
                  f"{r['launches']} B1 launches ({r['buckets']} buckets x "
                  f"{len(fns)} f) | {card}", flush=True)
    return rows


def _walk_ms(fn, reps: int) -> float:
    """Host clock per call of a host-side integrate: one warm-up call, then
    `reps` timed."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_facade_times(cfg, device, card):
    """5h: preprocessing and one steady-state `integrate` at cell (a), d =
    4 and 64, Exponential(-0.5), Rational and Polynomial: "cuda", "torch"
    and "host" (the FTFI walk; ExpMP for Exponential) against the card's
    BTFI, each backend's speedup over BTFI in total (preprocessing +
    one integrate) and for the integrate alone, and the facade's overhead
    over a bare `ftfi.apply` (the memo hit against a fresh bind)."""
    import torch
    from repro_torch import ftfi
    from repro_torch.core import Integrator
    from repro_torch.core import cordial as C
    from repro_torch.core.integrate import BTFI, clear_plan_cache, compile_plan
    from repro_torch.core.itree_flat import build_flat_it, clear_flat_cache

    tree = synthetic_tree(cfg)
    leaf, reps = cfg["leaf"], cfg["reps"]
    clear_plan_cache()
    clear_flat_cache()
    pre = {}
    t0 = time.perf_counter()
    build_flat_it(tree, leaf_size=leaf)
    pre["flat_it_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_plan(tree, leaf_size=leaf)  # on the flat IT just built
    pre["plan_s"] = time.perf_counter() - t0
    integs = {}
    for b in ("cuda", "torch"):
        t0 = time.perf_counter()
        integs[b] = Integrator(tree, backend=b, leaf_size=leaf)
        _ = integs[b].params  # the plan's distances on the card
        torch.cuda.synchronize()
        pre[f"{b}_params_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = Integrator(tree, backend="host", leaf_size=leaf)
    pre["host_s"] = time.perf_counter() - t0  # ITNodes + ExpMP's BFS
    walk = Integrator(tree, backend="host", leaf_size=leaf, use_expmp=False)
    t0 = time.perf_counter()
    dense = BTFI(tree, device=device)
    torch.cuda.synchronize()
    pre["btfi_s"] = time.perf_counter() - t0  # host all-pairs + transfer
    # what each backend pays before its first integrate (cold caches)
    total_pre = {"cuda": pre["flat_it_s"] + pre["plan_s"]
                 + pre["cuda_params_s"],
                 "torch": pre["flat_it_s"] + pre["plan_s"]
                 + pre["torch_params_s"],
                 "host": pre["flat_it_s"] + pre["host_s"],
                 "btfi": pre["btfi_s"]}
    fams = {"Exponential": C.Exponential(-0.5),
            "Rational": C.Rational((1.0,), (1.0, 0.0, 0.8)),
            "Polynomial": C.Polynomial((0.5, -0.2, 0.1))}
    rng = np.random.default_rng(23)
    rows = []
    for d in cfg["widths"]:
        X = torch.tensor(rng.normal(size=(tree.num_vertices, d)),
                         dtype=torch.float32, device=device)
        Xn = X.cpu().numpy()
        for fname in FACADE["families"]:
            fn = fams[fname]
            row = {"d": d, "family": fname}
            row["btfi_ms"] = host_ms(lambda: dense.integrate(fn, X), reps)
            row["btfi_device_ms"] = device_ms(lambda: dense.integrate(fn, X),
                                              reps)
            for b, integ in integs.items():
                row[f"{b}_ms"] = host_ms(lambda: integ.integrate(fn, X), reps)
                row[f"{b}_device_ms"] = device_ms(
                    lambda: integ.integrate(fn, X), reps)
                row[f"{b}_apply_ms"] = host_ms(  # a fresh bind per call
                    lambda: ftfi.apply(integ.spec, integ.params, fn, X,
                                       backend=b, device=device), reps)
            row["host_ms"] = _walk_ms(lambda: host.integrate(fn, Xn),
                                      FACADE["host_reps"])
            row["host_engine"] = host.describe(fn)["cross_engine"]
            if fname == "Exponential":
                row["host_walk_ms"] = _walk_ms(
                    lambda: walk.integrate(fn, Xn), FACADE["host_reps"])
            for b in ("cuda", "torch", "host"):
                row[f"{b}_speedup_integrate"] = row["btfi_ms"] / row[f"{b}_ms"]
                row[f"{b}_speedup_total"] = (
                    (total_pre["btfi"] * 1e3 + row["btfi_ms"])
                    / (total_pre[b] * 1e3 + row[f"{b}_ms"]))
            rows.append(row)
            print(f"[facade times] n={tree.num_vertices} d={d} {fname}: "
                  f"integrate host ms (device ms): cuda {row['cuda_ms']:.3f}"
                  f" ({row['cuda_device_ms']:.3f}), torch "
                  f"{row['torch_ms']:.3f} ({row['torch_device_ms']:.3f}), "
                  f"host {row['host_ms']:.1f} ({row['host_engine']})"
                  + (f", host walk {row['host_walk_ms']:.1f}"
                     if "host_walk_ms" in row else "")
                  + f", BTFI {row['btfi_ms']:.3f} "
                  f"({row['btfi_device_ms']:.3f})"
                  f" | speedup over BTFI, integrate / total: " + ", ".join(
                      f"{b} {row[f'{b}_speedup_integrate']:.2f}x / "
                      f"{row[f'{b}_speedup_total']:.2f}x"
                      for b in ("cuda", "torch", "host"))
                  + f" | facade (memo hit) vs ftfi.apply (fresh bind): cuda "
                  f"{row['cuda_ms']:.3f} / {row['cuda_apply_ms']:.3f} ms, "
                  f"torch {row['torch_ms']:.3f} / {row['torch_apply_ms']:.3f}"
                  f" ms | {card}", flush=True)
    print(f"[facade preprocessing] n={tree.num_vertices}, leaf {leaf}, cold: "
          f"flat IT {pre['flat_it_s']:.3f} s, plan {pre['plan_s']:.3f} s, "
          f"Integrator cuda {pre['cuda_params_s']:.3f} s, torch "
          f"{pre['torch_params_s']:.3f} s (params to the card), host "
          f"{pre['host_s']:.3f} s (ITNodes, ExpMP's BFS), BTFI all-pairs "
          f"{pre['btfi_s']:.3f} s | {card}", flush=True)
    return {"card": card, "preprocessing_s": pre,
            "total_preprocessing_s": total_pre, "rows": rows}


# ----------------------------------------------------------------------------
# slice 12: the DeepSeek family (MoE + MLA) and three dense configs through
# the flash attention kernel at head dims (192, 128) and 256
# ----------------------------------------------------------------------------

# DeepSeek-V2-Lite-16B at full width (d_model 2048, 16 heads, MLA kv_lora
# 512, nope/rope/v 128/64/128, 64 routed experts top-6 + 2 shared, expert
# d_ff 1408, vocab 102,400) and depth (27 layers, the first dense) served in
# bf16 with Gemma-7B (head_dim 256) beside it, on the requests of slice 2;
# the float32 gates at 2 layers: V2-Lite on two requests (routing is
# discontinuous: few tokens keep the expected near-tie flips under one),
# Qwen2-1.5B, Gemma-7B and Granite-34B on slice 2's; DeepSeek-V3's
# training gate at full width, cut to 2 layers and 16 experts
DEEPSEEK = {"serve_archs": ("deepseek_v2_lite_16b", "gemma_7b"),
            "dense_archs": ("qwen2_1_5b", "gemma_7b", "granite_34b"),
            "gate_layers": 2,
            "moe_gate": {"lengths": (1024, 517), "Lp": 1024, "S": 1056},
            "train_arch": "deepseek_v3_671b", "train_layers": 2,
            "train_first_dense": 1, "train_experts": 16, "train_batch": 2,
            "train_seq": 1024,
            # 3c at the new head dims, (B, H, KV, L, hd, vd): the served
            # MLA and Gemma layers, both at a ragged L, and Qwen2's GQA
            # 12/2 and Granite's MQA 48/1 at hd 128
            "flash_shapes": [(4, 16, 16, 4096, 192, 128),
                             (4, 16, 16, 4096, 256, 256),
                             (4, 16, 16, 1000, 192, 128),
                             (4, 16, 16, 1000, 256, 256),
                             (4, 12, 2, 1000, 128, 128),
                             (4, 48, 1, 1000, 128, 128)]}
# record_function ranges of the MoE and MLA layers (models/moe.py,
# models/attention.py) whose device time the V2-Lite profiles report
MOE_SCOPES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine",
              "moe.shared", "mla.proj", "mla.absorbed")


def _wide_cfg(arch, impl="cuda", dtype=None, **kw):
    from repro_torch.configs.base import get_config

    cfg = get_config(arch, attn_impl=impl, **kw)
    return cfg.replace(dtype=dtype) if dtype else cfg


def phase_flash_wide_vs_plain(device):
    """3c at the new head dims: the flash attention kernel at MLA's (192,
    128) and Gemma's 256 (the served layers, L = 4096, and a ragged L =
    1000) and at Qwen2's and Granite's GQA/MQA at hd 128, causal and not,
    f32 and bf16, against its plain version and, at L <= 1024, the dense
    oracle; peaked logits (q x 4) in bf16 at the served shapes. 3c's
    bounds."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(23)
    rows, served = [], {}
    for B, H, KV, L, hd, vd in DEEPSEEK["flash_shapes"]:
        base = [torch.tensor(rng.normal(size=(B, n, L, d)),
                             dtype=torch.float32, device=device)
                for n, d in ((H, hd), (KV, hd), (KV, vd))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)
            for causal in (True, False):
                got = flash_ops.flash_attention(q, k, v, causal)
                plain = flash_ops.flash_attention(q, k, v, causal,
                                                  use_kernel=False)
                torch.cuda.synchronize()
                if got.shape != (B, H, L, vd) or got.dtype != dtype or not (
                        bool(torch.isfinite(got.float()).all())):
                    raise AssertionError(f"flash kernel: bad output "
                                         f"{tuple(got.shape)} {got.dtype}")
                want = {"plain": plain}
                if L <= 1024:
                    G = H // KV
                    want["ref"] = attention_ref(
                        q, k.repeat_interleave(G, 1),
                        v.repeat_interleave(G, 1), causal)
                row = {"kernel": "flash_attention",
                       "shape": (B, H, KV, L, hd, vd),
                       "dtype": str(dtype).split(".")[1], "causal": causal,
                       "abs_err": float((got.float() - plain.float()).abs()
                                        .max()), "abs_err_ref": None}
                if "ref" in want:
                    row["abs_err_ref"] = float(
                        (got.float() - want["ref"].float()).abs().max())
                if dtype == torch.float32:
                    ok = all(float((got - w).abs().max()) <= FLASH_TOL
                             for w in want.values())
                else:
                    row["bf16_roundings"] = max(bf16_roundings(got, w)
                                                for w in want.values())
                    ok = row["bf16_roundings"] <= 1.0
                if not ok:
                    raise AssertionError(f"flash kernel {row} (bound "
                                         f"{FLASH_TOL} in float32, one bf16 "
                                         "rounding in bfloat16)")
                rows.append(row)
            if (B, H, KV, L, hd, vd) in DEEPSEEK["flash_shapes"][:2]:
                served[(hd, vd, row["dtype"])] = (q, k, v)
            del q, k, v
        del base
    for B, H, KV, L, hd, vd in DEEPSEEK["flash_shapes"][:2]:
        q = torch.tensor(rng.normal(size=(B, H, L, hd)) * 4.0,
                         dtype=torch.bfloat16, device=device)
        k, v = (torch.tensor(rng.normal(size=(B, KV, L, d)),
                             dtype=torch.bfloat16, device=device)
                for d in (hd, vd))
        for causal in (True, False):
            got = flash_ops.flash_attention(q, k, v, causal)
            plain = flash_ops.flash_attention(q, k, v, causal,
                                              use_kernel=False)
            torch.cuda.synchronize()
            row = {"kernel": "flash_attention",
                   "shape": (B, H, KV, L, hd, vd), "dtype": "bfloat16",
                   "causal": causal, "peaked": True,
                   "abs_err": float((got.float() - plain.float()).abs()
                                    .max()),
                   "abs_err_ref": None,
                   "bf16_roundings": bf16_roundings(got, plain)}
            if not (bool(torch.isfinite(got.float()).all())
                    and row["bf16_roundings"] <= 1.0):
                raise AssertionError(f"flash kernel, peaked logits: {row} "
                                     "(bound one bf16 rounding)")
            rows.append(row)
        del q, k, v
    f32 = max(r["abs_err"] for r in rows if r["dtype"] == "float32")
    vs_ref = max(r["abs_err_ref"] for r in rows
                 if r["abs_err_ref"] is not None and r["dtype"] == "float32")
    roundings = max(r["bf16_roundings"] for r in rows
                    if r["dtype"] == "bfloat16" and not r.get("peaked"))
    peaked = max(r["bf16_roundings"] for r in rows if r.get("peaked"))
    print(f"[flash wide vs plain] {len(rows)} checks (B, H, KV, L, hd, vd) "
          f"in {DEEPSEEK['flash_shapes']}, causal and not, f32/bf16 | worst "
          f"abs err f32 {f32:.2e} (< {FLASH_TOL}), vs the dense oracle at L "
          f"<= 1024 {vs_ref:.2e}; bf16 {roundings:.3f} of one bf16 rounding "
          f"(<= 1), peaked logits (q x 4) {peaked:.3f}", flush=True)
    return rows, served


def _sdpa_backend(q, k, v, causal, mask=None, **kw) -> str:
    """The backend `scaled_dot_product_attention` picks for these inputs:
    the choice its own dispatcher makes (`torch._fused_sdp_choice`)."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, causal,
                                              **kw)).name


def phase_flash_wide_times(served, card):
    """5c at the new head dims: one launch's device time at the served MLA
    and Gemma layers (bf16 causal, the main path's launch; bf16 full and
    f32 causal beside it), its bound, the plain version's time and one
    `scaled_dot_product_attention` call on the same inputs (a yardstick,
    never on the path; the kernel it ran is named)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops

    reps = TOPO["reps"]
    out = {}
    for B, H, KV, L, hd, vd in DEEPSEEK["flash_shapes"][:2]:
        for dtype, causal in (("bfloat16", True), ("bfloat16", False),
                              ("float32", True)):
            q, k, v = served[(hd, vd, dtype)]
            k_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                               causal), reps)
            p_ms = device_ms(lambda: flash_ops.flash_attention(
                q, k, v, causal, use_kernel=False), 2)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)

            l_ms = device_ms(sdpa, reps)
            backend = _sdpa_backend(q, k, v, causal)
            nbytes, ops_ = flash_work(B, H, KV, L, hd, causal,
                                      q.element_size(), vd)
            b_ms, b_by = bound(nbytes, ops_, BF16_FLOPS_PER_S
                               if dtype == "bfloat16" else FP32_FLOPS_PER_S)
            key = f"flash_{hd}_{vd}_{'causal' if causal else 'full'}_{dtype}"
            out[key] = {"shape": (B, H, KV, L, hd, vd), "dtype": dtype,
                        "causal": causal, "ms": k_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "library_backend": backend,
                        "bytes": nbytes, "ops": ops_, "bound_ms": b_ms,
                        "bound_by": b_by}
            print(f"[attn times flash {'causal' if causal else 'full'} "
                  f"{dtype}] B={B} H={H} KV={KV} L={L} hd={hd} vd={vd}: "
                  f"kernel {k_ms:.3f} ms/launch, plain {p_ms:.3f} ms, sdpa "
                  f"{l_ms:.3f} ms ({backend}), bound {b_ms:.3f} ms "
                  f"({b_by}; {b_ms / k_ms:.0%} of it reached) | {card}",
                  flush=True)
    return out


def phase_moe_routing(cfg, device):
    """The served V2-Lite's routing at full depth, bf16: one prefill on
    "cuda" and one on "chunked" (the plain B5) from the same weights with
    `moe.TRACE` on: the share of (token, expert) assignments dropped at
    capacity, by layer and over all, and how many assignments the two
    runs route differently. Printed, not gated."""
    import torch
    from repro_torch.models import api
    from repro_torch.models import moe

    model = api.init_params(cfg, TOPO["seed"], device=device)
    toks, lengths = _prompts(cfg)
    S, B = TOPO["S"], len(lengths)
    routes = {}
    for impl in ("cuda", "chunked"):
        c = cfg.replace(attn_impl=impl)
        moe.TRACE = []
        try:
            api.prefill_into_cache(c, model, api.init_cache(c, B, S,
                                                            device=device),
                                   toks, lengths, S, device=device)
            routes[impl] = moe.TRACE
        finally:
            moe.TRACE = None
    torch.cuda.synchronize()
    recs = routes["cuda"]
    dropped = [float((~r["keep"]).float().mean()) for r in recs]
    # the padding's share: T counts every padded position, as the
    # reference's does
    real = torch.as_tensor(np.arange(TOPO["Lp"])[None, :] < lengths[:, None],
                           device=device).reshape(-1)
    dropped_real = [float((~r["keep"][real]).float().mean()) for r in recs]
    diff = routing_diff(_routing(routes["cuda"]), _routing(routes["chunked"]))
    n_assign = sum(r["keep"].numel() for r in recs)
    out = {"layers": len(recs), "C": recs[0]["C"],
           "tokens": int(recs[0]["keep"].shape[0]),
           "dropped_share": float(np.mean(dropped)),
           "dropped_share_by_layer": dropped,
           "dropped_share_real_tokens": float(np.mean(dropped_real)),
           "routing_diff_cuda_vs_chunked": diff,
           "assignments": n_assign}
    print(f"[deepseek-v2-lite routing] bf16, {len(recs)} MoE layers, T = "
          f"{out['tokens']} (padding included), C = {out['C']}: dropped at "
          f"capacity {out['dropped_share']:.4%} of assignments (layers "
          f"{min(dropped):.4%}-{max(dropped):.4%}; real tokens "
          f"{out['dropped_share_real_tokens']:.4%}) | not gated: \"cuda\" vs "
          f"\"chunked\" route {diff} of {n_assign} assignments differently",
          flush=True)
    return out


def phase_deepseek(card, device):
    """Slice 12's phases: 3c at the new head dims, the float32 gates (4b:
    V2-Lite with its routing, the three dense configs), the V3 training
    gate (4f), then V2-Lite and Gemma-7B served at full depth in bf16 (5b,
    each the path whose B5 launches the kernels line counts), V2-Lite's
    routing at depth, and 5c's times. Returns (record, kernels rows)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    checks, served = phase_flash_wide_vs_plain(device)
    gates = [phase_gate(
        "deepseek-v2-lite", _wide_cfg("deepseek_v2_lite_16b", "cuda",
                                      "float32",
                                      num_layers=DEEPSEEK["gate_layers"]),
        _wide_cfg("deepseek_v2_lite_16b", "chunked", "float32",
                  num_layers=DEEPSEEK["gate_layers"]), flash_ops, device,
        req=DEEPSEEK["moe_gate"])]
    torch.cuda.empty_cache()
    for arch in DEEPSEEK["dense_archs"]:
        cfg = _wide_cfg(arch, "cuda", "float32",
                        num_layers=DEEPSEEK["gate_layers"])
        gates.append(phase_gate(arch, cfg, cfg.replace(attn_impl="chunked"),
                                flash_ops, device))
        torch.cuda.empty_cache()
    cfg = _wide_cfg(DEEPSEEK["train_arch"], "cuda", "float32",
                    num_layers=DEEPSEEK["train_layers"],
                    first_dense_layers=DEEPSEEK["train_first_dense"],
                    num_experts=DEEPSEEK["train_experts"])
    train_gate = phase_train_gate(
        "deepseek-v3 (mtp)", cfg, cfg.replace(attn_impl="chunked"),
        flash_ops, device, batch=DEEPSEEK["train_batch"],
        seq=DEEPSEEK["train_seq"])
    torch.cuda.empty_cache()
    serves = {}
    for arch in DEEPSEEK["serve_archs"]:  # each path counts from zero
        cfg = _wide_cfg(arch)
        serves[arch] = phase_serve(arch, cfg, flash_ops, device, card,
                                   scopes=MOE_SCOPES if cfg.moe else ())
        if serves[arch]["launches_by_mode"] != {
                "causal": cfg.num_layers, "full": 0, "window": 0, "cross": 0}:
            raise AssertionError(f"{arch}: B5 launches by mode "
                                 f"{serves[arch]['launches_by_mode']}")
        torch.cuda.empty_cache()
    routing = phase_moe_routing(_wide_cfg("deepseek_v2_lite_16b"), device)
    torch.cuda.empty_cache()
    times = phase_flash_wide_times(served, card)
    del served
    torch.cuda.empty_cache()
    kernels = []
    for arch, (B, H, KV, L, hd, vd) in zip(DEEPSEEK["serve_archs"],
                                           DEEPSEEK["flash_shapes"]):
        t = times[f"flash_{hd}_{vd}_causal_bfloat16"]
        errs = [r["abs_err"] for r in checks
                if r["shape"] == (B, H, KV, L, hd, vd) and r["causal"]
                and r["dtype"] == "bfloat16" and not r.get("peaked")]
        kernels.append({
            "name": f"flash_attention[causal,hd={hd},vd={vd}]",
            "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
            "launches": serves[arch]["launches_by_mode"]["causal"],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_backend": t["library_backend"],
            "at": (f"one causal launch, bf16, B={B} H={H} KV={KV} L={L} "
                   f"hd={hd} vd={vd}: one layer of the {arch} prefill; "
                   f"launches: that served prefill + {TOPO['steps']} "
                   "decode steps"),
        })
    record = {"flash_wide_checks": checks, "deepseek_gates": gates,
              "deepseek_train_gate": train_gate, "deepseek_serve": serves,
              "deepseek_routing": routing, "flash_wide_times": times}
    return record, kernels


# ----------------------------------------------------------------------------
# slice 13: the hybrid, encoder-decoder and vlm families (ROADMAP A10b):
# RecurrentGemma-2B (local attention: B5 under a window), SeamlessM4T-medium
# (an encoder, a decoder and cross-attention: B5 with Lq != Lk) and
# LLaVA-NeXT-34B (GQA 56/8 over projected patches ahead of the text)
# ----------------------------------------------------------------------------

A10B = {"hybrid": "recurrentgemma_2b", "encdec": "seamless_m4t_medium",
        "vlm": "llava_next_34b",
        # 3c: (B, H, KV, L, W, hd) windowed: the served RecurrentGemma
        # layer, a ragged L and L <= W; (B, H, KV, Lq, Lk, hd) cross: the
        # served Seamless decoder layer and a ragged pair; (B, H, KV, L, hd)
        # causal at LLaVA's GQA 56/8 (G = 7): its served prefill_fn layer
        # (1,152 patches + the halved text's 2,048) and at the full text's
        # 5,248
        "window_shapes": [(4, 10, 1, 4096, 2048, 256),
                          (4, 10, 1, 3001, 2048, 256),
                          (4, 10, 1, 1537, 2048, 256)],
        "cross_shapes": [(4, 16, 16, 512, 3072, 64),
                         (4, 16, 16, 37, 3001, 64)],
        "gqa7_shapes": [(4, 56, 8, 3200, 128), (4, 56, 8, 5248, 128)],
        # 3f: the window and cross modes' grads, (B, H, KV, Lq, Lk, hd, W)
        "grad_shapes": [(1, 10, 1, 1000, 1000, 256, 256),
                        (2, 16, 16, 128, 700, 64, 0)],
        # (p): B requests of `src` frames and a `prompt`-token decoder
        # prompt; decode replay of `replay` prompt tokens, then greedy
        # steps, `steps` decode_fn calls in all over a self cache of S
        "encdec_req": {"B": 4, "src": 3072, "prompt": 512, "replay": 32,
                       "steps": 64, "S": 576},
        # (q): the vlm's patches ahead of the text: TOPO's requests with
        # their lengths halved. At full length the text's prefill_into_cache
        # ran out of the card's 79 GiB (73.6 GiB allocated beside 4.7 GiB
        # reserved, the weights 64.1 GiB; PERF.md section 4)
        "patches": 1152,
        "vlm_req": {"lengths": (2048, 1500, 768, 2048), "Lp": 2048,
                    "S": 2080},
        # (r) float32 gates' depths; the training gates' (batch, seq) (the
        # hybrid's longer than its window, so the window binds)
        "gate_superblocks": 1, "gate_tail": ("rec",), "gate_layers": 2,
        "train_hybrid": (1, 3072), "train_encdec": (2, 512),
        "reps": 3}


def _a10b_cfg(family, impl="cuda", dtype=None, **kw):
    from repro_torch.configs.base import get_config

    cfg = get_config(A10B[family], attn_impl=impl, **kw)
    return cfg.replace(dtype=dtype) if dtype else cfg


def _hybrid_gate_kw() -> dict:
    """RecurrentGemma cut to 1 superblock (rec, rec, attn) and a tail rec."""
    n, tail = A10B["gate_superblocks"], A10B["gate_tail"]
    return dict(num_superblocks=n, tail_blocks=tail,
                num_layers=3 * n + len(tail))


def _encdec_gate_kw() -> dict:
    n = A10B["gate_layers"]
    return dict(encoder_layers=n, decoder_layers=n, num_layers=2 * n)


def _flash_check(rows, label, got, plain, dtype):
    """One 3c row: the kernel's output against the plain version, 2e-5
    absolute in float32, one bf16 rounding + 2e-5 in bfloat16."""
    import torch

    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"flash kernel {label}: non-finite output")
    row = {"kernel": "flash_attention", "case": label,
           "dtype": str(dtype).split(".")[1],
           "abs_err": float((got.float() - plain.float()).abs().max())}
    if dtype == torch.float32:
        ok = row["abs_err"] <= FLASH_TOL
    else:
        row["bf16_roundings"] = bf16_roundings(got, plain)
        ok = row["bf16_roundings"] <= 1.0
    if not ok:
        raise AssertionError(f"flash kernel {row} (bound {FLASH_TOL} in "
                             "float32, one bf16 rounding in bfloat16)")
    rows.append(row)
    return row


def phase_flash_a10b_vs_plain(device):
    """3c for the new modes: B5 under a window (RecurrentGemma's served
    layer, MQA G = 10 at hd 256, W = 2048; a ragged L; L <= W), with Lq !=
    Lk (Seamless's served cross-attention and a ragged pair) and causal at
    LLaVA's G = 7, f32 and bf16, against its plain version; one launch
    each, counted under its mode. Returns (rows, the served shapes' bf16
    and f32 inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    rng = np.random.default_rng(29)
    rows, served = [], {}
    cases = ([("window", (B, H, KV, L, L, hd), True, W)
              for B, H, KV, L, W, hd in A10B["window_shapes"]]
             + [("cross", shape, False, 0)
                for shape in A10B["cross_shapes"]])
    first = {"window": 0, "cross": len(A10B["window_shapes"]),
             "causal": len(cases)}
    cases += [("causal", (B, H, KV, L, L, hd), True, 0)
              for B, H, KV, L, hd in A10B["gqa7_shapes"]]
    for i, (mode, shape, causal, W) in enumerate(cases):
        B, H, KV, Lq, Lk, hd = shape
        base = [torch.tensor(rng.normal(size=(B, n, L, hd)),
                             dtype=torch.float32, device=device)
                for n, L in ((H, Lq), (KV, Lk), (KV, Lk))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)
            before = dict(flash_ops.LAUNCHES_BY_MODE)
            got = flash_ops.flash_attention(q, k, v, causal, window=W)
            torch.cuda.synchronize()
            if (flash_ops.LAUNCHES_BY_MODE[mode] != before[mode] + 1
                    or got.shape != q.shape):
                raise AssertionError(f"flash kernel {mode} {shape}: not one "
                                     f"{mode} launch, or {tuple(got.shape)}")
            plain = flash_ops.flash_attention(q, k, v, causal, window=W,
                                              use_kernel=False)
            row = _flash_check(rows, f"{mode} {shape} W={W}", got, plain,
                               dtype)
            row.update(mode=mode, shape=shape, window=W)
            if i == first[mode]:
                served[(mode, row["dtype"])] = (q, k, v, W)
            del q, k, v, got, plain
        del base
        torch.cuda.empty_cache()
    worst = {}
    for r in rows:
        key = (r["mode"], r["dtype"])
        worst[key] = max(worst.get(key, 0.0),
                         r.get("bf16_roundings", r["abs_err"]))
    modes = ("window", "cross", "causal")
    print(f"[flash a10b vs plain] {len(rows)} checks: window "
          f"{A10B['window_shapes']} (B, H, KV, L, W, hd), cross "
          f"{A10B['cross_shapes']} (B, H, KV, Lq, Lk, hd), causal G = 7 "
          f"{A10B['gqa7_shapes']}, f32/bf16 | worst abs err f32: " + ", ".join(
              f"{m} {worst[(m, 'float32')]:.2e}" for m in modes)
          + f" (< {FLASH_TOL}); bf16 roundings: " + ", ".join(
              f"{m} {worst[(m, 'bfloat16')]:.3f}" for m in modes)
          + " (<= 1)", flush=True)
    return rows, served


def phase_flash_a10b_grads(device):
    """3f for the new modes: the window and cross modes' grads through the
    kernel path (the plain VJP with the forward's window and k/v length)
    against the plain path's, one launch a forward, none in the
    backward."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    rng = np.random.default_rng(31)
    rows = []
    for B, H, KV, Lq, Lk, hd, W in A10B["grad_shapes"]:
        ins = [torch.tensor(rng.normal(size=(B, n, L, hd)),
                            dtype=torch.float32, device=device)
               for n, L in ((H, Lq), (KV, Lk), (KV, Lk))]

        def flash(q, k, v, use_kernel, causal=Lq == Lk, W=W):
            return flash_ops.flash_attention(q, k, v, causal, window=W,
                                             use_kernel=use_kernel)

        rows.append(_kernel_grads(
            "flash_attention", lambda: flash_ops.LAUNCHES, flash, ins,
            [True, True, True], f"flash {'window' if W else 'cross'} "
            f"{(B, H, KV, Lq, Lk, hd)} W={W} float32", 1, 0))
    print("[flash a10b grads] " + "; ".join(
        f"{r['case']}: rel err {r['rel_err']:.2e} (< {r['tol']}), launches "
        f"{r['launches_forward']} forward, {r['launches_backward']} backward"
        for r in rows), flush=True)
    return rows


def phase_flash_a10b_times(served, card):
    """5c for the new modes: one launch's device time at the served shapes
    (bf16, the main paths' launches; f32 beside it), its bound, the plain
    version's time and one `scaled_dot_product_attention` call on the
    same inputs (the window as an explicit boolean mask; GQA through
    enable_gqa; a yardstick, never on the path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops

    reps = A10B["reps"]
    out = {}
    for (mode, dtype), (q, k, v, W) in sorted(served.items()):
        B, H, Lq, hd = q.shape
        KV, Lk = k.shape[1], k.shape[2]
        causal = mode != "cross"
        k_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal,
                                                           window=W), reps)
        p_ms = device_ms(lambda: flash_ops.flash_attention(
            q, k, v, causal, window=W, use_kernel=False), 1)
        kw = {"enable_gqa": True} if KV != H else {}
        mask = None
        if W:
            i = torch.arange(Lq, device=q.device)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)

        def sdpa():
            if mask is not None:
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask, **kw)
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  **kw)

        try:
            l_ms = device_ms(sdpa, reps)
            backend = _sdpa_backend(q, k, v, causal and mask is None, mask,
                                    **kw)
        except (RuntimeError, TypeError) as err:  # no such call here
            l_ms, backend = None, f"none: {str(err)[:80]}"
        nbytes, ops_ = flash_work(B, H, KV, Lq, hd, causal,
                                  q.element_size(), Lk=Lk, window=W)
        b_ms, b_by = bound(nbytes, ops_, BF16_FLOPS_PER_S
                           if dtype == "bfloat16" else FP32_FLOPS_PER_S)
        out[f"flash_{mode}_{dtype}"] = {
            "shape": (B, H, KV, Lq, Lk, hd), "window": W, "dtype": dtype,
            "mode": mode, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "library_backend": backend, "bytes": nbytes, "ops": ops_,
            "bound_ms": b_ms, "bound_by": b_by}
        lib = f"{l_ms:.3f} ms ({backend})" if l_ms is not None else backend
        print(f"[attn times flash {mode} {dtype}] B={B} H={H} KV={KV} "
              f"Lq={Lq} Lk={Lk} hd={hd} W={W}: kernel {k_ms:.3f} ms/launch, "
              f"plain {p_ms:.3f} ms, sdpa {lib}, bound {b_ms:.3f} ms "
              f"({b_by}; {b_ms / k_ms:.0%} of it reached) | {card}",
              flush=True)
    return out


def _frames(B, S, device, seed=0):
    """(B, S, 1024) seeded normals on the device: the stub frontends'
    frames (encdec) or patch embeddings (vlm)."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(B, S, 1024)), dtype=torch.float32,
                        device=device)


def _encdec_prompts(cfg, device):
    req = A10B["encdec_req"]
    toks, _ = _prompts(cfg, {"lengths": (req["prompt"],) * req["B"],
                             "Lp": req["prompt"]})
    return {"tokens": toks, "src_embeds": _frames(req["B"], req["src"],
                                                  device)}


def phase_encdec_gate(cfg, plain_cfg, device):
    """(r) for the encoder-decoder family, float32 at full width: prefill_fn
    ("cuda" against "chunked" on the same weights: logits <= 1e-4; one B5
    launch per attention call: encoder "full", decoder "causal" and
    "cross"), then 4 decode steps of replay from the empty cache (logits
    <= 1e-4, every cache leaf <= 1e-5, no launch)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api

    req = A10B["encdec_req"]
    B, S = req["B"], req["S"]
    model = api.init_params(cfg, TOPO["seed"], device=device)
    batch = _encdec_prompts(cfg, device)
    toks = batch["tokens"]
    res = {}
    for c in (cfg, plain_cfg):
        before = dict(flash_ops.LAUNCHES_BY_MODE)
        logits = api.prefill_fn(c, model, batch, device=device)
        launched = {m: flash_ops.LAUNCHES_BY_MODE[m] - before[m]
                    for m in before}
        cache = api.init_cache(c, B, S, device=device)
        steps, before = [], flash_ops.LAUNCHES
        for t in range(TOPO["gate_steps"]):
            lg, cache = api.decode_fn(c, model, cache, toks[:, t:t + 1], t, S,
                                      device=device)
            steps.append(lg)
        torch.cuda.synchronize()
        res[c.attn_impl] = (logits, launched, steps, cache,
                            flash_ops.LAUNCHES - before)
    got, want = res[cfg.attn_impl], res[plain_cfg.attn_impl]
    n = cfg.decoder_layers
    expect = {"causal": n, "full": cfg.encoder_layers, "window": 0,
              "cross": n}
    if got[1] != expect or got[4] or any(want[1].values()) or want[4]:
        raise AssertionError(f"encdec gate: B5 launches {got[1]} (expected "
                             f"{expect}), {got[4]} in decode; plain "
                             f"{want[1]}, {want[4]}")
    e_logits = rel_err(got[0], want[0])
    e_steps = [rel_err(a, b) for a, b in zip(got[2], want[2])]
    g_flat, w_flat = _flat(got[3]), _flat(want[3])
    # the cross memory nothing writes is 0 on both paths
    e_cache = max((rel_err(g_flat[k], w) if float(w.abs().max()) else
                   float(g_flat[k].abs().max())) for k, w in w_flat.items())
    ok = (e_logits <= LOGIT_TOL and max(e_steps) <= LOGIT_TOL
          and e_cache <= CACHE_TOL)
    print(f"[seamless gate] float32, matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, {cfg.encoder_layers} + "
          f"{n} layers, width {cfg.d_model}, B={B}, {req['src']} frames, "
          f"{req['prompt']}-token prompt: prefill_fn logits {e_logits:.2e} "
          f"(< {LOGIT_TOL}), B5 launches {got[1]}; decode replay steps 1-"
          f"{len(e_steps)} {max(e_steps):.2e} (< {LOGIT_TOL}), cache "
          f"{e_cache:.2e} (< {CACHE_TOL}), {got[4]} launches", flush=True)
    if not ok:
        raise AssertionError("seamless: the kernel and plain paths disagree")
    return {"label": "seamless", "layers": [cfg.encoder_layers, n],
            "rel_err_prefill_logits": e_logits, "rel_err_decode": e_steps,
            "rel_err_cache": e_cache, "launches_by_mode": got[1],
            "launches_in_decode": got[4]}


def _vlm_batch(cfg, device, req=None):
    """`patches` patch embeddings ahead of the requests of `req` (TOPO's by
    default)."""
    toks, lengths = _prompts(cfg, req)
    return {"tokens": toks, "patch_embeds": _frames(
        len(lengths), A10B["patches"], device, seed=1)}, lengths


def phase_vlm_prefill_gate(cfg, plain_cfg, device):
    """(r) for the vlm's own prefill, float32 at full width: prefill_fn over
    [projected patches ; TOPO's text], "cuda" against "chunked": logits <=
    1e-4, one causal B5 launch a layer, none on the plain run."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api

    model = api.init_params(cfg, TOPO["seed"], device=device)
    batch, _ = _vlm_batch(cfg, device)
    out = {}
    for c in (cfg, plain_cfg):
        before = flash_ops.LAUNCHES
        out[c.attn_impl] = (api.prefill_fn(c, model, batch, device=device),
                            flash_ops.LAUNCHES - before)
    torch.cuda.synchronize()
    got, want = out[cfg.attn_impl], out[plain_cfg.attn_impl]
    e = rel_err(got[0], want[0])
    print(f"[llava prefill gate] float32, {cfg.num_layers} layers, width "
          f"{cfg.d_model}, {A10B['patches']} patches + {TOPO['Lp']} tokens: "
          f"prefill_fn logits {e:.2e} (< {LOGIT_TOL}), {got[1]} B5 launches "
          f"(plain {want[1]})", flush=True)
    if e > LOGIT_TOL or got[1] != cfg.num_layers or want[1]:
        raise AssertionError("llava prefill: the kernel and plain paths "
                             "disagree")
    return {"label": "llava prefill_fn", "rel_err_prefill_logits": e,
            "launches": got[1]}


def _reset(ops):
    ops.LAUNCHES = 0
    for mode in ops.LAUNCHES_BY_MODE:
        ops.LAUNCHES_BY_MODE[mode] = 0


def phase_serve_encdec(cfg, device, card):
    """(p) main path: SeamlessM4T-medium at full width and depth in bf16 as
    the reference serves the family: prefill_fn over B requests of `src`
    frames and a `prompt`-token decoder prompt (the memory path: 12 "full",
    12 "causal" and 12 "cross" B5 launches), then decode replay through
    decode_fn from the empty cache, `replay` prompt tokens fed and the
    rest greedy, `steps` calls in all (no launch); B5's counts from 0
    around both. Then times, peak memory and the profiles of one prefill
    and one decode step."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api

    req = A10B["encdec_req"]
    B, S = req["B"], req["S"]
    model = api.init_params(cfg, TOPO["seed"], device=device)
    batch = _encdec_prompts(cfg, device)
    toks_t = torch.as_tensor(batch["tokens"], device=device).long()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(flash_ops)
    t0 = time.perf_counter()
    logits = api.prefill_fn(cfg, model, batch, device=device)
    cache = api.init_cache(cfg, B, S, device=device)
    tok, step_logits, fed = toks_t[:, :1], [], []
    for t in range(req["steps"]):
        lg, cache = api.decode_fn(cfg, model, cache, tok, t, S, device=device)
        step_logits.append(lg)
        tok = (toks_t[:, t + 1:t + 2] if t + 1 < req["replay"]
               else lg[:, 0].argmax(-1)[:, None])
        fed.append(tok)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(flash_ops.LAUNCHES_BY_MODE)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.decoder_layers
    if launches != {"full": cfg.encoder_layers, "causal": n, "cross": n,
                    "window": 0}:
        raise AssertionError(f"seamless serve: B5 launches {launches}")
    _check_served(cfg, logits[:, 0], step_logits, fed)
    reps = A10B["reps"]
    pre_ms = host_ms(lambda: api.prefill_fn(cfg, model, batch,
                                            device=device), reps)
    dec_ms = host_ms(lambda: api.decode_fn(cfg, model, cache, tok,
                                           req["steps"], S, device=device),
                     TOPO["decode_reps"])
    out = {"label": "seamless", "dtype": cfg.dtype,
           "launches_by_mode": launches, "launches": sum(launches.values()),
           "serve_seconds": serve_s, "prefill_ms": pre_ms,
           "prefill_positions_per_s": B * (req["src"] + req["prompt"])
           / (pre_ms / 1e3), "decode_ms_per_step": dec_ms,
           "decode_tokens_per_s": B / (dec_ms / 1e3),
           "params": api.param_count(model), "peak_gib": peak_gib,
           "card": card}
    print(f"[seamless serve] {cfg.name} encdec, {cfg.dtype}, "
          f"{cfg.encoder_layers} + {n} layers, {out['params']} params: "
          f"prefill_fn of {B} x ({req['src']} frames + {req['prompt']} "
          f"tokens), {req['steps']} decode_fn steps ({req['replay']} "
          f"replayed) in {serve_s:.2f} s, B5 launches {launches} | prefill "
          f"{pre_ms:.1f} ms ({out['prefill_positions_per_s']:.0f} "
          f"positions/s), decode {dec_ms:.2f} ms/step "
          f"({out['decode_tokens_per_s']:.0f} tok/s), peak {peak_gib:.2f} "
          f"GiB | {card}", flush=True)
    out["profile_prefill"] = phase_calls_profile(
        "seamless prefill", lambda: api.prefill_fn(cfg, model, batch,
                                                   device=device))
    out["profile_decode"] = phase_calls_profile(
        "seamless decode step", lambda: api.decode_fn(
            cfg, model, cache, tok, req["steps"], S, device=device))
    return out


def phase_serve_vlm(cfg, device, card):
    """(q) main path: LLaVA-NeXT-34B at full width and depth in bf16:
    prefill_fn over `patches` patch embeddings ahead of the text of
    `vlm_req` (one causal B5 launch a layer at L = patches + Lp), then, as
    the reference serves the family, prefill_into_cache and TOPO's greedy
    decode steps on the text (one more launch a layer, none in decode);
    B5's counts from 0 around all of it. Then times, peak memory and the
    profiles of one prefill_fn and one decode step. The run fails past 76
    GiB of device memory."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api

    req = A10B["vlm_req"]
    model = api.init_params(cfg, TOPO["seed"], device=device)
    batch, lengths = _vlm_batch(cfg, device, req)
    toks = batch["tokens"]
    B, S = len(lengths), req["S"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(flash_ops)
    t0 = time.perf_counter()
    vlm_logits = api.prefill_fn(cfg, model, batch, device=device)
    logits, cache = api.prefill_into_cache(
        cfg, model, api.init_cache(cfg, B, S, device=device), toks, lengths,
        S, device=device)
    pos = torch.as_tensor(lengths, device=device).long()
    tok, step_logits, fed = logits.argmax(-1)[:, None], [], []
    for _ in range(TOPO["steps"]):
        lg, cache = api.decode_fn(cfg, model, cache, tok, pos, S,
                                  device=device)
        step_logits.append(lg)
        tok = lg[:, 0].argmax(-1)[:, None]
        fed.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(flash_ops.LAUNCHES_BY_MODE)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"causal": 2 * cfg.num_layers, "full": 0, "window": 0,
                    "cross": 0}:
        raise AssertionError(f"llava serve: B5 launches {launches}")
    _check_served(cfg, vlm_logits[:, 0], [], [vlm_logits.argmax(-1)])
    _check_served(cfg, logits, step_logits, fed)
    reps = A10B["reps"]
    pre_ms = host_ms(lambda: api.prefill_fn(cfg, model, batch,
                                            device=device), reps)
    text_ms = host_ms(lambda: api.prefill_into_cache(
        cfg, model, api.init_cache(cfg, B, S, device=device), toks, lengths,
        S, device=device), 1)
    # a step at the first decode positions again (pos after the run is S)
    pos = torch.as_tensor(lengths, device=device).long() + 1
    dec_ms = host_ms(lambda: api.decode_fn(cfg, model, cache, tok, pos, S,
                                           device=device),
                     TOPO["decode_reps"])
    n_pos = B * (A10B["patches"] + req["Lp"])
    out = {"label": "llava", "dtype": cfg.dtype,
           "launches_by_mode": launches, "launches": launches["causal"],
           "serve_seconds": serve_s, "prefill_ms": pre_ms,
           "prefill_positions_per_s": n_pos / (pre_ms / 1e3),
           "text_prefill_into_cache_ms": text_ms,
           "decode_ms_per_step": dec_ms,
           "decode_tokens_per_s": B / (dec_ms / 1e3),
           "params": api.param_count(model), "peak_gib": peak_gib,
           "card": card}
    print(f"[llava serve] {cfg.name} vlm, {cfg.dtype}, {cfg.num_layers} "
          f"layers, {out['params']} params: prefill_fn of {B} x "
          f"({A10B['patches']} patches + {req['Lp']} tokens), then "
          f"prefill_into_cache of the text (lengths {req['lengths']}, "
          f"S={S}) and {TOPO['steps']} greedy steps in {serve_s:.2f} s, B5 "
          f"launches {launches} | prefill_fn {pre_ms:.1f} ms "
          f"({out['prefill_positions_per_s']:.0f} positions/s), text "
          f"prefill_into_cache {text_ms:.1f} ms, decode {dec_ms:.2f} ms/step"
          f" ({out['decode_tokens_per_s']:.0f} tok/s), peak {peak_gib:.2f} "
          f"GiB | {card}", flush=True)
    if peak_gib > 76.0:
        raise AssertionError(f"llava serve: peak {peak_gib:.2f} GiB > 76 "
                             "GiB: halve the text lengths")
    out["profile_prefill"] = phase_calls_profile(
        "llava prefill_fn", lambda: api.prefill_fn(cfg, model, batch,
                                                   device=device))
    out["profile_decode"] = phase_calls_profile(
        "llava decode step", lambda: api.decode_fn(
            cfg, model, cache, tok, pos, S, device=device))
    return out


def phase_a10b_checks(device):
    """Slice 13's checks before its served paths: 3c and 3f for B5's window
    and cross modes and LLaVA's G = 7; the float32 gates (r) for
    RecurrentGemma (1 superblock + a tail rec), Seamless (2 + 2) and LLaVA
    (2 layers: the text path, and prefill_fn over the patches); the
    training gates (loss_fn + backward in float32: RecurrentGemma at 4
    layers with the window binding, Seamless at 2 + 2). Returns (record,
    the served shapes' inputs for 5c)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    checks, served = phase_flash_a10b_vs_plain(device)
    grads = phase_flash_a10b_grads(device)
    torch.cuda.empty_cache()
    hcfg = _a10b_cfg("hybrid", "cuda", "float32", **_hybrid_gate_kw())
    n_attn = A10B["gate_superblocks"]
    gates = [phase_gate("recurrentgemma", hcfg,
                        hcfg.replace(attn_impl="chunked"), flash_ops, device,
                        expect=n_attn)]
    torch.cuda.empty_cache()
    ecfg = _a10b_cfg("encdec", "cuda", "float32", **_encdec_gate_kw())
    gates.append(phase_encdec_gate(ecfg, ecfg.replace(attn_impl="chunked"),
                                   device))
    torch.cuda.empty_cache()
    vcfg = _a10b_cfg("vlm", "cuda", "float32",
                     num_layers=A10B["gate_layers"])
    gates.append(phase_gate("llava", vcfg, vcfg.replace(attn_impl="chunked"),
                            flash_ops, device))
    gates.append(phase_vlm_prefill_gate(
        vcfg, vcfg.replace(attn_impl="chunked"), device))
    torch.cuda.empty_cache()
    hb, hl = A10B["train_hybrid"]
    train = [phase_train_gate("recurrentgemma", hcfg,
                              hcfg.replace(attn_impl="chunked"), flash_ops,
                              device, batch=hb, seq=hl,
                              launches=(n_attn, n_attn))]
    torch.cuda.empty_cache()
    eb, el = A10B["train_encdec"]
    calls = ecfg.encoder_layers + 2 * ecfg.decoder_layers
    train.append(phase_train_gate("seamless", ecfg,
                                  ecfg.replace(attn_impl="chunked"),
                                  flash_ops, device, batch=eb, seq=el,
                                  launches=(calls, calls)))
    torch.cuda.empty_cache()
    return {"a10b_flash_checks": checks, "a10b_flash_grads": grads,
            "a10b_gates": gates, "a10b_train_gates": train}, served


def phase_a10b_serve(card, device):
    """Slice 13's main paths: (o) RecurrentGemma-2B, (p) SeamlessM4T-medium
    and (q) LLaVA-NeXT-34B served at full width and depth in bf16, B5's
    counts from 0 around each."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    # (o): TOPO's requests, one "window" launch per attention layer (8) in
    # the prefill, none in decode
    cfg = _a10b_cfg("hybrid")
    n_attn = cfg.num_superblocks * cfg.superblock.count("attn")
    hybrid = phase_serve("recurrentgemma", cfg, flash_ops, device, card,
                         expect=n_attn)
    if hybrid["launches_by_mode"] != {"window": n_attn, "causal": 0,
                                      "full": 0, "cross": 0}:
        raise AssertionError(f"recurrentgemma serve: B5 launches "
                             f"{hybrid['launches_by_mode']}")
    torch.cuda.empty_cache()
    encdec = phase_serve_encdec(_a10b_cfg("encdec"), device, card)
    torch.cuda.empty_cache()
    vlm = phase_serve_vlm(_a10b_cfg("vlm"), device, card)
    torch.cuda.empty_cache()
    return {"recurrentgemma": hybrid, "seamless": encdec, "llava": vlm}


def a10b_kernel_rows(checks, serves, times) -> list:
    """The kernels line's rows of B5's new modes: each at its served shape,
    its launches those of its served run."""
    rows = []
    for mode, label, arch, what in (
            ("window", "recurrentgemma", A10B["hybrid"],
             "local attention layer"),
            ("cross", "seamless", A10B["encdec"], "decoder cross-attention"),
            ("causal", "llava", A10B["vlm"], "prefill_fn layer (GQA 56/8)")):
        t = times[f"flash_{mode}_bfloat16"]
        B, H, KV, Lq, Lk, hd = t["shape"]
        errs = [r["abs_err"] for r in checks if r["mode"] == mode
                and r["dtype"] == "bfloat16" and r["shape"] == t["shape"]]
        rows.append({
            "name": f"flash_attention[{mode},hd={hd},G={H // KV}]",
            "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
            "launches": serves[label]["launches_by_mode"][mode],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_backend": t["library_backend"],
            "at": (f"one {mode} launch, bf16, B={B} H={H} KV={KV} Lq={Lq} "
                   f"Lk={Lk} hd={hd} W={t['window']}: one {what} of the "
                   f"{arch} prefill; launches: its served run's {mode} "
                   "launches"),
        })
    return rows


def phase_a10b(card, device):
    """Slice 13: checks, 5c's times of the new modes (their inputs freed
    before LLaVA's 64 GiB of weights arrive), then the three served paths.
    Returns (record, kernels rows)."""
    import torch

    record, served = phase_a10b_checks(device)
    times = phase_flash_a10b_times(served, card)
    del served
    torch.cuda.empty_cache()
    serves = phase_a10b_serve(card, device)
    record.update(a10b_serve=serves, a10b_flash_times=times)
    return record, a10b_kernel_rows(record["a10b_flash_checks"], serves,
                                    times)


# ----------------------------------------------------------------------------
# slice 14: the serving engine (continuous batching with mid-wave admission,
# tree-masked prefill from one packed forest plan, the fault matrix) on
# cell (d)'s topo Llama-3.2-1B at degree 1: B2 in each plain prefill group
# ----------------------------------------------------------------------------

# cell (s): 8 requests through 4 slots (requests 5-8 admit mid-wave as the
# budgets free the slots); (b) 4 prompts fused against replay; (c) 4 tree
# requests over random_tree(n, seed=i), a quarter of (d)'s lengths (the
# 750-token request's early end patches the live plan); (d) the faults of
# tests/test_serving_faults.py:332-365 on 2 requests
ENGINE = {"slots": 4, "max_len": 4160, "seed": 0, "leaf": 8,
          "lengths": (4096, 3001, 1537, 4096, 2048, 517, 1024, 3500),
          "max_new": (32, 8, 24, 16, 32, 12, 20, 28),
          "replay": (4, 64, 8),  # requests, prompt length, new tokens
          "tree_lengths": (1024, 750, 384, 1024),
          "tree_max_new": (16, 4, 16, 16),
          # 5i's traced tree group: the model cut to these layers (at 16
          # the profiler took ~60 s over its 57,325 device ops)
          "tree_profile_layers": 4,
          "fault": (2, 64, 4)}  # requests, prompt length, new tokens
ENGINE_PACKED_TOL = 1e-5  # tests/test_serve_prefill.py:271
ENGINE_FAILURES = ("prefill_failures", "step_failures", "slot_faults",
                   "evictions", "failed", "stopped_inflight")
ENGINE_SCOPE = "topo.tree_fastmult"  # models/attention.py's profiler range


def _engine_cfg(impl="cuda", dtype=None):
    """Cell (d)'s model at degree 1 (`_topo_cfg`)."""
    return _topo_cfg(1, impl, dtype)


def _engine_prompts(cfg, lengths, seed=None):
    rng = np.random.default_rng(ENGINE["seed"] if seed is None else seed)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in lengths]


def _engine_trees(lengths):
    from repro_torch.graphs.graph import random_tree

    return [random_tree(int(n), seed=i) for i, n in enumerate(lengths)]


class _EngineProbe:
    """Wraps one ServeEngine's model calls (the gates' engines, not the
    timed ones): B2's launches in plain prefill groups, in tree groups and
    in decode; the prompt bucket of each prefill call; and, for each
    emitted token, the top-2 logit gap of the row it came from (read on the
    card from the call's logits)."""

    def __init__(self, eng, ops):
        self.eng, self.ops = eng, ops
        self.launches = {"_prefill": 0, "_prefill_tree": 0, "_decode": 0}
        self.buckets = []
        self.gaps: dict = {}
        self._top2 = None
        for name in self.launches:
            setattr(eng, name, self._wrap(name, getattr(eng, name)))
        emit = eng._emit

        def _emit(req, token):
            s = next(s for s, r in enumerate(eng.slot_req) if r is req)
            top = self._top2[s]
            self.gaps.setdefault(req.rid, []).append(float(top[0] - top[1]))
            emit(req, token)

        eng._emit = _emit

    def _wrap(self, name, fn):
        def call(*args):
            before = self.ops.LAUNCHES
            logits, cache = fn(*args)
            rows = logits[:, -1] if logits.ndim == 3 else logits
            self._top2 = rows.float().topk(2, dim=-1).values.cpu().numpy()
            self.launches[name] += self.ops.LAUNCHES - before
            if name != "_decode":
                self.buckets.append(int(args[0].shape[1]))
            return logits, cache

        return call


def _engine_run(cfg, model, prompts, max_new, device, ops=None, trees=None,
                **kw):
    """A ServeEngine over 4 slots (or `kw`'s) serving the prompts; with
    `ops`, probed. Returns (engine, requests, probe, ticks, seconds)."""
    import torch
    from repro_torch.serve.engine import Request, ServeEngine

    opts = dict(batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
                mask_leaf_size=ENGINE["leaf"])
    opts.update(kw)
    eng = ServeEngine(cfg, model, device=device, **opts)
    probe = _EngineProbe(eng, ops) if ops is not None else None
    reqs = [Request(rid=i, prompt=p, max_new_tokens=int(mn),
                    tree=None if trees is None else trees[i])
            for i, (p, mn) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    ticks = eng.run()
    torch.cuda.synchronize()
    return eng, reqs, probe, ticks, time.perf_counter() - t0


def _engine_counters(eng) -> dict:
    """stats() without the `_s` times."""
    return {k: v for k, v in eng.stats().items() if not k.endswith("_s")}


def _clean_outcome(label, eng, reqs):
    """Every request done with its whole answer, no failure counter set."""
    st = eng.stats()
    bad = [r.rid for r in reqs if not r.done or r.error is not None
           or r.retries or r.truncated
           or len(r.out) != r.max_new_tokens]
    bad_counts = {k: st[k] for k in ENGINE_FAILURES if st[k]}
    if bad or bad_counts:
        raise AssertionError(
            f"{label}: requests {bad} not served whole "
            f"({[(r.rid, r.error, r.retries) for r in reqs if r.rid in bad]})"
            f", failure counters {bad_counts}: nothing was injected")


def _same_tokens(label, runs):
    """Each request's tokens equal across the runs {name: (reqs, probe)};
    on a difference, the top-2 logit gaps at that token in every run."""
    names = list(runs)
    first = runs[names[0]][0]
    for i, r in enumerate(first):
        for name in names[1:]:
            other = runs[name][0][i]
            if other.out == r.out:
                continue
            j = next((k for k, (a, b) in enumerate(zip(r.out, other.out))
                      if a != b), min(len(r.out), len(other.out)))
            gaps = {}
            for n in names:
                got = runs[n][1].gaps.get(runs[n][0][i].rid, [])
                gaps[n] = got[j] if j < len(got) else None
            raise AssertionError(
                f"{label}: request {r.rid} differs at token {j} "
                f"({names[0]} {r.out[:j + 1]}, {name} {other.out[:j + 1]}); "
                f"top-2 logit gap there: {gaps}")


def phase_engine_faults(cfg, model, device):
    """4k (d), float32, before the measured runs: 2 requests through 2
    slots, clean, then with serve.logits NaN-ing slot 1 at tick 2 and with
    serve.step raising at tick 3 (tests/test_serving_faults.py:332-365):
    the tokens of the clean run and those tests' counters. Then every
    fault is disarmed."""
    from repro_torch.testing import faults

    n, L, new = ENGINE["fault"]
    prompts = _engine_prompts(cfg, (L,) * n, seed=7)
    kw = dict(batch_slots=2)
    clean = _engine_run(cfg, model, prompts, (new,) * n, device, **kw)
    _clean_outcome("4k (d) clean", clean[0], clean[1])
    cases = {
        "slot fault": ("serve.logits", faults.nan_slot_at_tick(slot=1, k=2),
                       {"slot_faults": 1, "evictions": 1, "retries": 1,
                        "failed": 0}, [0, 1]),
        "step crash": ("serve.step", faults.raise_at_tick(3),
                       {"step_failures": 1, "evictions": 2, "failed": 0},
                       None),
    }
    out = {}
    for name, (point, handler, want, retries) in cases.items():
        try:
            with faults.injected(point, handler):
                eng, reqs, _, ticks, _ = _engine_run(
                    cfg, model, prompts, (new,) * n, device, **kw)
        finally:
            faults.clear()
        st = eng.stats()
        got = {k: st[k] for k in want}
        if (got != want or any(r.error is not None or not r.done
                               for r in reqs)
                or [r.out for r in reqs] != [r.out for r in clean[1]]
                or (retries is not None
                    and [r.retries for r in reqs] != retries)):
            raise AssertionError(
                f"4k (d) {name}: counters {got} (want {want}), retries "
                f"{[r.retries for r in reqs]}, errors "
                f"{[r.error for r in reqs]}, tokens equal to the clean "
                f"run's: {[r.out for r in reqs] == [r.out for r in clean[1]]}")
        out[name] = {"point": point, "counters": got, "ticks": ticks,
                     "retries": [r.retries for r in reqs]}
    faults.clear()
    if faults.armed():
        raise AssertionError(f"faults still armed: {faults.armed()}")
    print(f"[engine faults 4k(d)] float32, {n} requests of {L} tokens, "
          f"{new} new, 2 slots: slot fault (serve.logits, slot 1, tick 2) "
          f"{out['slot fault']['counters']}, retries "
          f"{out['slot fault']['retries']}; step crash (serve.step, tick 3) "
          f"{out['step crash']['counters']}; tokens equal to the clean "
          f"run's; nothing armed after", flush=True)
    return out


def phase_engine_batching(cfg, model, device, ops):
    """4k (a), float32: ENGINE's 8 requests through 4 slots on "cuda"
    against "torch" (the plain sweep), the same weights. The "cuda" run is
    the slice's main path: B2's count from 0 just before it, read just
    after."""
    from repro_torch.analysis import trace_guard
    from repro_torch.core import ladder

    prompts = _engine_prompts(cfg, ENGINE["lengths"])
    lad = ladder.stats()
    runs = {}
    for impl in ("cuda", "torch"):
        c = cfg.replace(topo_attn_impl=impl)
        trace_guard.reset()
        if impl == "cuda":
            ops.LAUNCHES = 0
        eng, reqs, probe, ticks, secs = _engine_run(
            c, model, prompts, ENGINE["max_new"], device, ops=ops)
        runs[impl] = {"eng": eng, "reqs": reqs, "probe": probe,
                      "ticks": ticks, "seconds": secs,
                      "launches": ops.LAUNCHES,
                      "counters": _engine_counters(eng),
                      "trace_guard": trace_guard.stats()}
        _clean_outcome(f"4k (a) {impl}", eng, reqs)
        buckets = sorted(set(probe.buckets))
        want_tg = {"sites": {"serve.decode": 1,
                             "serve.prefill": len(buckets)},
                   "keys": {f"serve.prefill [L{b}]": 1 for b in buckets}}
        if runs[impl]["trace_guard"] != want_tg:
            raise AssertionError(f"4k (a) {impl}: trace_guard "
                                 f"{runs[impl]['trace_guard']}, want "
                                 f"{want_tg}")
    _same_tokens("4k (a) cuda vs torch", {
        k: (v["reqs"], v["probe"]) for k, v in runs.items()})
    cu, pl = runs["cuda"], runs["torch"]
    if cu["counters"] != pl["counters"]:
        raise AssertionError(f"4k (a): counters differ: {cu['counters']} "
                             f"against {pl['counters']}")
    if ladder.stats() != lad:
        raise AssertionError(f"4k (a): the ladder moved: {ladder.stats()}")
    calls = cu["counters"]["prefill_calls"]
    n_layers = cfg.num_layers
    if (cu["launches"] != n_layers * calls or cu["launches"] == 0
            or cu["probe"].launches["_prefill"] != cu["launches"]
            or cu["probe"].launches["_decode"] or pl["probe"].launches[
                "_prefill"] or pl["probe"].launches["_decode"]):
        raise AssertionError(f"4k (a): B2 launches {cu['launches']} for "
                             f"{calls} prefill calls of {n_layers} layers; "
                             f"by call: cuda {cu['probe'].launches}, torch "
                             f"{pl['probe'].launches}")
    if calls < 3:
        raise AssertionError(f"4k (a): {calls} prefill calls: no mid-wave "
                             "admission")
    gaps = [g for v in cu["probe"].gaps.values() for g in v]
    print(f"[engine batching 4k(a)] float32, {len(prompts)} requests "
          f"(lengths {ENGINE['lengths']}, new {ENGINE['max_new']}) through "
          f"{ENGINE['slots']} slots, max_len {ENGINE['max_len']}: cuda and "
          f"torch give equal tokens and counters ({calls} prefill calls, "
          f"buckets {sorted(set(cu['probe'].buckets))}, {cu['ticks']} "
          f"ticks, {cu['counters']['decode_tokens']} decode tokens); B2 "
          f"{cu['launches']} launches = {n_layers} x {calls} prefill calls, "
          f"0 in decode; trace_guard {cu['trace_guard']['sites']}; least "
          f"top-2 logit gap {min(gaps):.3e}; ladder unchanged", flush=True)
    return {"requests": list(ENGINE["lengths"]),
            "max_new": list(ENGINE["max_new"]),
            "launches": cu["launches"], "prefill_calls": calls,
            "buckets": cu["probe"].buckets, "ticks": cu["ticks"],
            "counters": {k: v for k, v in cu["counters"].items()
                         if not isinstance(v, dict)},
            "trace_guard": cu["trace_guard"], "min_top2_gap": min(gaps),
            "tokens": [r.out[:8] for r in cu["reqs"]]}


def phase_engine_replay(cfg, model, device, ops):
    """4k (b), float32: 4 prompts fused against replay, the same tokens;
    replay prefills nothing."""
    n, L, new = ENGINE["replay"]
    prompts = _engine_prompts(cfg, (L,) * n, seed=5)
    runs = {}
    for mode in ("fused", "replay"):
        eng, reqs, probe, ticks, _ = _engine_run(
            cfg, model, prompts, (new,) * n, device, ops=ops,
            prefill_mode=mode)
        _clean_outcome(f"4k (b) {mode}", eng, reqs)
        runs[mode] = (reqs, probe, eng.stats(), ticks)
    _same_tokens("4k (b) fused vs replay",
                 {k: v[:2] for k, v in runs.items()})
    f, r = runs["fused"][2], runs["replay"][2]
    if f["prefill_calls"] != 1 or r["prefill_calls"] != 0:
        raise AssertionError(f"4k (b): prefill calls fused "
                             f"{f['prefill_calls']}, replay "
                             f"{r['prefill_calls']}")
    print(f"[engine replay 4k(b)] float32, {n} prompts of {L} tokens, {new} "
          f"new: fused ({runs['fused'][3]} ticks, 1 prefill call) and "
          f"replay ({runs['replay'][3]} ticks, 0) give equal tokens",
          flush=True)
    return {"ticks": {k: v[3] for k, v in runs.items()},
            "prefill_tokens": {k: v[2]["prefill_tokens"]
                               for k, v in runs.items()}}


def _tree_group(cfg, model, prompts, trees, device):
    """One tree-masked prefill group of every prompt, through a fresh
    engine's own call (its cache untouched, its forest plan built by its
    mask manager). Returns (logits (B, V), engine, (tokens, lengths,
    pack, unpack), the prefill's host seconds)."""
    import torch
    from repro_torch.serve.engine import ServeEngine, _next_pow2

    B = len(prompts)
    eng = ServeEngine(cfg, model, batch_slots=B, max_len=ENGINE["max_len"],
                      mask_leaf_size=ENGINE["leaf"], device=device)
    Lp = _next_pow2(max(8, max(len(p) for p in prompts)))
    toks = np.zeros((B, Lp), np.int32)
    for s, (p, t) in enumerate(zip(prompts, trees)):
        eng.masks.admit(s, t)
        toks[s, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    pack, unpack = eng.masks.pack_maps(Lp, list(range(B)), B)
    t0 = time.perf_counter()
    logits, _ = eng._prefill_tree(toks, lens, eng.masks.spec,
                                  eng.masks.params, pack, unpack)
    torch.cuda.synchronize()
    return logits, eng, (toks, lens, pack, unpack), time.perf_counter() - t0


def phase_engine_trees(cfg, model, device, ops):
    """4k (c), float32: the packed forest prefill of ENGINE's 4 tree
    requests against each one's single-tree prefill (<= 1e-5, the bound of
    tests/test_serve_prefill.py:271); each request's engine tokens batched
    (4 slots, the short one evicted early: an incremental plan patch)
    against its single-slot engine's; no B2 launch in a tree group."""
    lengths, new = ENGINE["tree_lengths"], ENGINE["tree_max_new"]
    prompts = _engine_prompts(cfg, lengths, seed=3)
    trees = _engine_trees(lengths)
    before = ops.LAUNCHES
    packed, packed_eng, _, packed_s = _tree_group(cfg, model, prompts,
                                                  trees, device)
    errs = []
    for s in range(len(trees)):
        single = _tree_group(cfg, model, prompts[s:s + 1], trees[s:s + 1],
                             device)[0]
        errs.append(rel_err(packed[s], single[0]))
    if not max(errs) <= ENGINE_PACKED_TOL:
        raise AssertionError(f"4k (c): packed vs single-tree prefill "
                             f"logits {errs} (> {ENGINE_PACKED_TOL})")
    singles = []
    for s in range(len(trees)):
        eng, reqs, probe, _, _ = _engine_run(
            cfg, model, prompts[s:s + 1], new[s:s + 1], device, ops=ops,
            trees=trees[s:s + 1], batch_slots=1)
        _clean_outcome(f"4k (c) single {s}", eng, reqs)
        singles.append((reqs[0], probe))
    batched, reqs, probe, ticks, secs = _engine_run(
        cfg, model, prompts, new, device, ops=ops, trees=trees)
    _clean_outcome("4k (c) batched", batched, reqs)
    for s, r in enumerate(reqs):
        _same_tokens(f"4k (c) request {s} batched vs single-slot",
                     {"batched": ([r], probe),
                      "single": ([singles[s][0]], singles[s][1])})
    fm = batched.stats()["forest_masks"]
    launches = ops.LAUNCHES - before
    if (fm["builds"] < 1 or fm["incremental_evictions"] < 1
            or fm["swaps_validated"] < fm["builds"] or launches):
        raise AssertionError(f"4k (c): forest masks {fm}, B2 launches "
                             f"{launches} in tree groups (want 0)")
    B, N = len(trees), int(packed_eng.masks.spec.n)
    print(f"[engine trees 4k(c)] float32, {B} tree requests (lengths "
          f"{lengths}, random_tree(n, seed=i), new {new}), forest N = {N}: "
          f"packed vs single-tree prefill logits "
          f"{max(errs):.2e} (<= {ENGINE_PACKED_TOL}; packed prefill "
          f"{packed_s:.2f} s); batched tokens equal single-slot; forest "
          f"masks {fm}; {ticks} ticks in {secs:.2f} s; B2 launches 0",
          flush=True)
    return {"lengths": list(lengths), "forest_n": N,
            "packed_vs_single": errs, "packed_prefill_s": packed_s,
            "forest_masks": fm, "ticks": ticks, "seconds": secs}


def phase_engine_gates(device, ops):
    """4k: (d) the injected faults, then (a), (b), (c), on one float32
    model at full width and depth."""
    import torch
    from repro_torch.models import api
    from repro_torch.testing import faults

    cfg = _engine_cfg("cuda", "float32")
    model = api.init_params(cfg, ENGINE["seed"], device=device)
    out = {"faults": phase_engine_faults(cfg, model, device)}
    faults.clear()
    if faults.armed():
        raise AssertionError(f"faults armed before 4k: {faults.armed()}")
    out["batching"] = phase_engine_batching(cfg, model, device, ops)
    out["replay"] = phase_engine_replay(cfg, model, device, ops)
    out["trees"] = phase_engine_trees(cfg, model, device, ops)
    del model
    torch.cuda.empty_cache()
    return out


def phase_engine_times(card, device):
    """5i, bf16: ENGINE's 8 requests through 4 slots, timed (host clock):
    each request's time to first token and total, prefill calls and ms,
    decode ms per tick, generated tokens/s, peak memory; one tree group
    (the 4 tree requests); the profiles of one plain prefill group (the
    first 4 prompts at 4,096), one tree group (on the model cut to
    ENGINE["tree_profile_layers"]) and one decode tick."""
    import torch
    from repro_torch.models import api
    from repro_torch.serve.engine import _next_pow2
    from repro_torch.testing import faults

    if faults.armed():
        raise AssertionError(f"faults armed before 5i: {faults.armed()}")
    cfg = _engine_cfg("cuda")
    model = api.init_params(cfg, ENGINE["seed"], device=device)
    prompts = _engine_prompts(cfg, ENGINE["lengths"])
    n, L, new = ENGINE["replay"]
    _engine_run(cfg, model, _engine_prompts(cfg, (L,) * n, seed=5),
                (new,) * n, device)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, _, ticks, secs = _engine_run(cfg, model, prompts,
                                            ENGINE["max_new"], device)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _clean_outcome("5i", eng, reqs)
    st = eng.stats()
    gen = sum(len(r.out) for r in reqs)
    per = [{"rid": r.rid, "prompt": len(r.prompt), "new": len(r.out),
            "ttft_ms": (r.t_first_token - r.t_submit) * 1e3,
            "total_ms": (r.t_done - r.t_submit) * 1e3} for r in reqs]
    out = {"ticks": ticks, "seconds": secs, "requests": per,
           "prefill_calls": st["prefill_calls"],
           "prefill_ms": st["prefill_s"] * 1e3,
           "decode_ms_per_tick": st["decode_s"] * 1e3 / ticks,
           "generated_tokens": gen, "generated_tokens_per_s": gen / secs,
           "peak_gib": peak, "card": card,
           "health": eng.health_banner(), "plan": eng.plan_banner()}
    print(f"[engine times 5i] {cfg.name} topo degree 1, bf16, "
          f"{len(reqs)} requests through {ENGINE['slots']} slots: {ticks} "
          f"ticks in {secs:.3f} s, {gen} generated tokens "
          f"({out['generated_tokens_per_s']:.1f} tok/s); "
          f"{st['prefill_calls']} prefill calls, {out['prefill_ms']:.1f} "
          f"host ms; decode {out['decode_ms_per_tick']:.2f} ms a tick; "
          f"peak {peak:.2f} GiB | {card}", flush=True)
    print("[engine times 5i] per request (prompt, new): ttft / total ms: "
          + "; ".join(f"{p['rid']} ({p['prompt']}, {p['new']}) "
                      f"{p['ttft_ms']:.1f} / {p['total_ms']:.1f}"
                      for p in per) + f" | {card}", flush=True)
    print(f"[engine times 5i] {out['health']}", flush=True)
    print(f"[engine times 5i] {out['plan']}", flush=True)
    lengths = ENGINE["tree_lengths"]
    tprompts = _engine_prompts(cfg, lengths, seed=3)
    trees = _engine_trees(lengths)
    teng, treqs, _, tticks, tsecs = _engine_run(
        cfg, model, tprompts, ENGINE["tree_max_new"], device, trees=trees)
    _clean_outcome("5i trees", teng, treqs)
    tst = teng.stats()
    out["tree"] = {"ticks": tticks, "seconds": tsecs,
                   "prefill_calls": tst["prefill_calls"],
                   "prefill_ms": tst["prefill_s"] * 1e3,
                   "decode_ms_per_tick": tst["decode_s"] * 1e3 / tticks,
                   "ttft_ms": [(r.t_first_token - r.t_submit) * 1e3
                               for r in treqs],
                   "forest_masks": tst["forest_masks"]}
    print(f"[engine times 5i trees] bf16, {len(treqs)} tree requests "
          f"(lengths {lengths}): {tticks} ticks in {tsecs:.3f} s; tree "
          f"prefill {out['tree']['prefill_ms']:.1f} host ms "
          f"({tst['prefill_calls']} call); decode "
          f"{out['tree']['decode_ms_per_tick']:.2f} ms a tick; ttft "
          f"{max(out['tree']['ttft_ms']):.1f} ms (the forest builds "
          f"included) | {card}", flush=True)
    # profiles: one plain prefill group, one tree group, one decode tick
    B = ENGINE["slots"]
    Lp = _next_pow2(max(ENGINE["lengths"][:B]))
    toks = np.zeros((B, Lp), np.int32)
    for s, p in enumerate(prompts[:B]):
        toks[s, :len(p)] = p
    lens = np.array([len(p) for p in prompts[:B]], np.int32)
    out["profile_prefill"] = phase_calls_profile(
        "engine plain prefill group", lambda: eng._prefill(toks, lens))
    cfg_t = cfg.replace(num_layers=ENGINE["tree_profile_layers"])
    _, geng, (ttoks, tlens, pack, unpack), _ = _tree_group(
        cfg_t, api.init_params(cfg_t, ENGINE["seed"], device=device),
        tprompts, trees, device)
    prof = phase_calls_profile(
        f"engine tree prefill group, {cfg_t.num_layers} layers",
        lambda: geng._prefill_tree(
            ttoks, tlens, geng.masks.spec, geng.masks.params, pack, unpack),
        scopes=(ENGINE_SCOPE,))
    prof["fastmult_share"] = (prof["scopes"][ENGINE_SCOPE]
                              / prof["device_ms"])
    out["profile_tree_prefill"] = prof
    dtoks = np.array([[r.out[-1]] for r in reqs[:B]], np.int32)
    pos = np.array([len(r.prompt) + 1 for r in reqs[:B]], np.int32)
    out["profile_decode"] = phase_calls_profile(
        "engine decode tick", lambda: eng._decode(dtoks, pos))
    print(f"[engine times 5i profiles] plain prefill group busy "
          f"{out['profile_prefill']['busy']:.2f}; tree group "
          f"({cfg_t.num_layers} layers) busy "
          f"{prof['busy']:.2f}, the fastmult {prof['fastmult_share']:.0%} "
          f"of its device time ({prof['scopes'][ENGINE_SCOPE]:.1f} of "
          f"{prof['device_ms']:.1f} ms); decode tick busy "
          f"{out['profile_decode']['busy']:.2f} | {card}", flush=True)
    del model, eng, teng, geng
    torch.cuda.empty_cache()
    return out


def phase_engine(card, device):
    """Slice 14: 4k's gates (the engine's main path, B2 counted from 0
    around 4k (a)'s "cuda" run), then 5i's times. Returns the record."""
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    gates = phase_engine_gates(device, topo_ops)
    times = phase_engine_times(card, device)
    return {"engine_gates": gates, "engine_times": times}


# ----------------------------------------------------------------------------
# slice 15: multi-rank FTFI over torch.distributed (core.plan_shard)
# ----------------------------------------------------------------------------

# cell (t): the sharded executor on the one card. 4l(a) one NCCL rank, 4l(b)
# to 4l(d) one gloo group of 4 processes sharing the card; none of these
# times is a multi-GPU time
# vit_batch: 4l(d)'s images (cut from 8 for the script's time)
SHARD = {"ranks": 4, "d": 64, "edits": 64, "edit_seed": 22, "vit_batch": 2,
         "vit_grad_batch": 1, "face_topo": (4, 32, 4096, 64, 64),
         "face_topo_h": (30, 31), "reps": 5, "stats_D": (1, 2, 4, 8),
         "timeout": 600}
SHARD_FACE_TOL = 1e-6  # tests/test_torch_plan_shard.py, relative to max
SHARD_VIT_TOL = 1e-4  # tests/test_distribution.py:93
# 4l(d)'s mask coefficient grads, relative to each block's largest: 4e's
# bound for two single-device impls of the ViT ("cuda" vs "ref"). The
# grads sum many terms that cancel, through `index_add_`'s atomics, so two
# single-device impls differ too (4l(d) prints "torch" vs "cuda"); a
# rank-sum left out would differ by ~1
SHARD_GRAD_TOL = 1e-3
SHARD_LABELS = {"nccl": "one rank", "gloo": "4 processes sharing one H100"}


def _event_ms(fn, reps: int) -> float:
    """CUDA-event time per call of fn() on this rank's stream, warm: the
    host's launch gaps and the waits inside collectives included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _shard_setup():
    """Rank start-up: the float32 settings of the parent (phase_device)."""
    import torch

    from repro_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve_device(None)


def _shard_check(label, got, want, tol):
    """got (a DTensor sharded by rows is gathered first) against want."""
    import torch

    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    err = rel_err(got, want)
    if not (got.shape == want.shape and bool(torch.isfinite(got).all())
            and err <= tol):
        raise AssertionError(f"{label}: sharded vs single-device {err:.3e} "
                             f"(<= {tol}), shape {tuple(got.shape)}")
    return err


def _shard_times(spec, params, mesh, fn, X, reps) -> dict:
    """Host ms and CUDA-event ms of apply_sharded (X whole or a DTensor
    sharded by rows) against single-device apply ("cuda", d of X), and the
    ms of each of its collectives at this plan's buffer shapes (host clock
    to synchronize, all ranks started together by a barrier)."""
    import torch
    import torch.distributed as dist

    from repro_torch import ftfi
    from repro_torch.core import plan_shard
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding

    dev = X.device
    axis = sharding.plan_axis(mesh)
    D, group = sharding.axis_size(mesh, axis), sharding.axis_group(mesh, axis)
    sp = plan_shard.partition_plan(spec, D)

    def sharded():
        return ftfi.apply_sharded(spec, params, fn, X, mesh=mesh,
                                  backend="cuda")

    Xw = X.full_tensor() if hasattr(X, "full_tensor") else X

    def single():
        return ftfi.apply(spec, params, fn, Xw, backend="cuda", device=dev)

    out = {}
    for name, f in (("sharded", sharded), ("single", single)):
        dist.barrier()
        out[f"{name}_host_ms"] = host_ms(f, reps)
        dist.barrier()
        out[f"{name}_event_ms"] = _event_ms(f, reps)
    d = X.shape[1]
    bufs = {"all_to_all": (C.all_to_all, torch.randn(
                (D * max(sp.halo_width, 1), d), device=dev)),
            "reduce_scatter": (C.reduce_scatter, torch.randn(
                (D * sp.block, d), device=dev))}
    for name, (f, buf) in bufs.items():
        dist.barrier()
        out[f"{name}_ms"] = host_ms(lambda: f(buf, group), reps)
        out[f"{name}_bytes"] = buf.numel() * 4
    # no host route: each collective runs on the buffers where they lie
    out["route"] = f"{dist.get_backend(group)} on {dev.type} tensors"
    return out


def _shard_nccl_rank(a) -> dict:
    """4l(a): one NCCL rank. apply_sharded on plan (a) at each width, the
    four kernel families on "cuda" and exp/poly on "torch", against
    single-device apply; one B1 launch per cross bucket on "cuda"."""
    import torch

    from repro_torch import ftfi
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.launch import collectives as C
    from repro_torch.launch import mesh as M

    dev = _shard_setup()
    mesh = M.make_plan_mesh()
    spec, params = ftfi.load_plan(a["a"], device=dev)
    nb = len(spec.cross_tgt_d0)
    rows = []
    # the slice's main path: B1 counted from 0 around each sharded call
    # (the single-device calls it is held against are not counted)
    main_by_td = {td: 0 for td in ops.LAUNCHES_BY_TD}
    for d in a["widths"]:
        X = torch.tensor(np.random.default_rng(11 + d).normal(
            size=(spec.n, d)), dtype=torch.float32, device=dev)
        for fname, fn in families():
            for backend in (("cuda", "torch")
                            if fname in ("Exponential", "Polynomial")
                            else ("cuda",)):
                ops.LAUNCHES = 0
                ops.LAUNCHES_BY_TD.update({td: 0 for td in main_by_td})
                C.reset_counts()
                got = ftfi.apply_sharded(spec, params, fn, X, mesh=mesh,
                                         backend=backend)
                torch.cuda.synchronize()
                launched, counts = ops.LAUNCHES, dict(C.COUNTS)
                for td, c in ops.LAUNCHES_BY_TD.items():
                    main_by_td[td] += c
                want = ftfi.apply(spec, params, fn, X, backend=backend,
                                  device=dev)
                err = _shard_check(f"4l(a) {fname} d={d} {backend}", got,
                                   want, EXACT_TOL)
                if launched != (nb if backend == "cuda" else 0):
                    raise AssertionError(f"4l(a) {fname} d={d} {backend}: "
                                         f"{launched} B1 launches, {nb} "
                                         "cross buckets")
                rows.append({"family": fname, "d": d, "backend": backend,
                             "rel_err": err, "launches": launched,
                             "collectives": counts})
    from repro_torch.kernels.fdist_matvec import kernel as fdist_kernel

    for d in a["widths"]:
        if main_by_td[fdist_kernel.tile_width(d)] == 0:
            raise AssertionError(f"4l(a) launched no fdist_matvec kernel of "
                                 f"d-tile {d}")
    X = torch.tensor(np.random.default_rng(5).normal(size=(spec.n, a["d"])),
                     dtype=torch.float32, device=dev)
    times = _shard_times(spec, params, mesh, families()[0][1], X, a["reps"])
    return {"rows": rows, "cross_buckets": nb,
            "launches": sum(main_by_td.values()),
            "launches_by_td": main_by_td, "times": times,
            "device": str(dev)}


def _shard_grads(spec, params, fn, X, mesh):
    """Grads of sum(Y * W) in X and the three distance groups, sharded and
    single-device on "cuda"; the relative error of each."""
    import torch

    from repro_torch import ftfi

    W = torch.tensor(np.random.default_rng(9).normal(size=tuple(X.shape)),
                     dtype=torch.float32, device=X.device)
    grads = []
    for sharded in (True, False):
        x = X.clone().requires_grad_(True)
        p = ftfi.PlanParams(*(tuple(t.detach().clone().requires_grad_(True)
                                    for t in group) for group in (
            params.cross_tgt_d, params.cross_src_d, params.leaf_dists)))
        y = (ftfi.apply_sharded(spec, p, fn, x, mesh=mesh, backend="cuda")
             if sharded else ftfi.apply(spec, p, fn, x, backend="cuda",
                                        device=X.device))
        if sharded:  # the rows of every rank
            y = y.full_tensor()
        (y * W).sum().backward()
        grads.append({"X": x.grad,
                      **{name: torch.cat([t.grad.reshape(-1)
                                          for t in getattr(p, name)])
                         for name in ("cross_tgt_d", "cross_src_d",
                                      "leaf_dists")}})
    return {k: _shard_check(f"4l(b) grad {k}", grads[0][k], grads[1][k],
                            EXACT_TOL) for k in grads[0]}


def _shard_gloo_rank(a) -> dict:
    """4l(b)-(d) and 5j's per-rank times on one of 4 gloo ranks sharing the
    card."""
    import torch
    import torch.distributed as dist

    from repro_torch import ftfi
    from repro_torch.core import cordial as Cf
    from repro_torch.core import plan_shard
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.fdist_matvec.ops import (
        fdist_matvec_batched, fdist_matvec_batched_sharded)
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops
    from repro_torch.launch import collectives as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding
    from repro_torch.models import vit

    dev = _shard_setup()
    rank = dist.get_rank()
    mesh = M.make_plan_mesh()  # ("data",) of 4: D = 4 shards
    out = {"rank": rank, "device": str(dev)}
    spec, params = ftfi.load_plan(a["a"], device=dev)
    sp = plan_shard.partition_plan(spec, dist.get_world_size())
    live = sum(plan_shard.live_buckets(sp, rank))
    X = torch.tensor(np.random.default_rng(5).normal(size=(spec.n, a["d"])),
                     dtype=torch.float32, device=dev)
    fams = dict(families())
    cases = [("Exponential", fams["Exponential"], "cuda"),
             ("Polynomial", fams["Polynomial"], "cuda"),
             ("Rational", fams["Rational"], "cuda"),
             ("raw 1/(1+s^2)", lambda s: 1.0 / (1.0 + s * s), "torch")]
    rows = []
    main = 0  # the slice's main path on this rank: B1 from 0 around each
    for fname, fn, backend in cases:  # sharded call
        ops.LAUNCHES = 0
        C.reset_counts()
        got = ftfi.apply_sharded(spec, params, fn, X, mesh=mesh,
                                 backend=backend)
        torch.cuda.synchronize()
        launched, counts = ops.LAUNCHES, dict(C.COUNTS)
        main += launched
        want = ftfi.apply(spec, params, fn, X, backend=backend, device=dev)
        err = _shard_check(f"4l(b) {fname}", got, want, EXACT_TOL)
        if counts != {"all_to_all": 1, "reduce_scatter": 1}:
            raise AssertionError(f"4l(b) {fname}: collectives {counts}")
        if launched != (live if backend == "cuda" else 0):
            raise AssertionError(f"4l(b) {fname}: {launched} B1 launches on "
                                 f"rank {rank}, {live} live cross buckets")
        rows.append({"family": fname, "backend": backend, "rel_err": err,
                     "launches": launched, "collectives": counts,
                     "engine": ftfi.describe(spec, fn, backend)[
                         "cross_engine"]})
    out["launches"] = main
    if main == 0:
        raise AssertionError(f"4l(b): rank {rank} launched no B1")
    out.update(rows=rows, live_buckets=live, cross_buckets=len(
        spec.cross_tgt_d0), stats=sp.stats)
    out["grad_rel_err"] = _shard_grads(spec, params, fams["Exponential"], X,
                                       mesh)
    s2, p2 = ftfi.load_plan(a["a_edit"], device=dev)
    X2 = torch.tensor(np.random.default_rng(6).normal(size=(s2.n, a["d"])),
                      dtype=torch.float32, device=dev)
    out["edited_rel_err"] = _shard_check(
        "4l(b) update_plan-edited (a)", ftfi.apply_sharded(
            s2, p2, fams["Exponential"], X2, mesh=mesh, backend="cuda"),
        ftfi.apply(s2, p2, fams["Exponential"], X2, backend="cuda",
                   device=dev), EXACT_TOL)
    fs, fp = ftfi.load_plan(a["c"], device=dev)
    sizes = np.asarray(fs.tree_sizes)
    E = torch.zeros((fs.n, int(sizes.max())), dtype=torch.float32,
                    device=dev)
    E[torch.arange(fs.n), torch.from_numpy(np.concatenate(
        [np.arange(s) for s in sizes])).to(dev)] = 1.0
    out["forest_rel_err"] = _shard_check(
        "4l(b) forest (c)", ftfi.apply_sharded(
            fs, fp, Cf.Exponential(-0.5), E, mesh=mesh, backend="cuda"),
        ftfi.apply(fs, fp, Cf.Exponential(-0.5), E, backend="cuda",
                   device=dev), EXACT_TOL)
    out["times"] = _shard_times(spec, params, mesh, fams["Exponential"], X,
                                a["reps"])
    out["field_rows"] = _shard_rows(spec, params, mesh, fams["Exponential"],
                                    X, live, a["reps"])

    # 4l(c): the kernel faces on a (data 2, model 2) mesh
    mesh2 = M.make_local_mesh(2, 2)
    sizes_b = [x.numel() * y.shape[1] for x, y in zip(params.cross_tgt_d,
                                                       params.cross_src_d)]
    i = int(np.argmax(sizes_b))
    B = params.cross_tgt_d[i].shape[0]
    Bf = B - 1 if B % 2 == 0 else B  # ragged over the 2 data ranks
    x = params.cross_tgt_d[i][:Bf].contiguous()
    y = params.cross_src_d[i][:Bf].contiguous()
    v = torch.tensor(np.random.default_rng(8).normal(
        size=(Bf, y.shape[1], a["d"])), dtype=torch.float32, device=dev)
    cs = torch.tensor(MODES[1][1], dtype=torch.float32, device=dev)
    faces = []
    before = ops.LAUNCHES
    got = fdist_matvec_batched_sharded(x, y, v, cs, mesh=mesh2, mode="exp")
    face_launches = ops.LAUNCHES - before
    want = fdist_matvec_batched(x, y, v, cs, mode="exp")
    faces.append({"face": "fdist_matvec_batched_sharded", "shape": (
        Bf, x.shape[1], y.shape[1], a["d"]), "launches": face_launches,
        "max_abs_diff": float((got - want).abs().max()),
        "bitwise": bool(torch.equal(got, want)),
        "rel_err": _shard_check("4l(c) fdist face", got, want,
                                SHARD_FACE_TOL)})
    Bq, H, L, m, hd = a["face_topo"]
    rng = np.random.default_rng(12)

    def t(shape, pos=False):
        arr = rng.normal(size=shape)
        return torch.tensor(np.abs(arr) if pos else arr,
                            dtype=torch.float32, device=dev)

    qf, kf, vv = t((Bq, H, L, m), True), t((Bq, H, L, m), True), t(
        (Bq, H, L, hd))
    for mode, deg in (("decay", 1), ("rank16", 2)):
        co = t((H, deg + 1)) * 0.3
        for h in (H, *a["face_topo_h"]):
            kw = dict(g="exp", dist_scale=1.0 / L, causal=True)
            before = topo_ops.LAUNCHES
            got = topo_ops.topo_linear_attention_sharded(
                qf[:, :h], kf[:, :h], vv[:, :h], co[:h], mesh=mesh2, **kw)
            torch.cuda.synchronize()
            launched = topo_ops.LAUNCHES - before
            want = topo_ops.topo_linear_attention(qf[:, :h], kf[:, :h],
                                                  vv[:, :h], co[:h], **kw)
            faces.append({
                "face": "topo_linear_attention_sharded", "mode": mode,
                "shape": (Bq, h, L, m, hd), "launches": launched,
                "head_axis": "model" if h % 2 == 0 else "dropped",
                "max_abs_diff": float((got - want).abs().max()),
                "bitwise": bool(torch.equal(got, want)),
                "rel_err": _shard_check(f"4l(c) topo face {mode} H={h}",
                                        got, want, SHARD_FACE_TOL)})
            if launched != 1:
                raise AssertionError(f"4l(c) topo face {mode} H={h}: "
                                     f"{launched} B2 launches on rank {rank}")
    del qf, kf, vv
    out["faces"] = faces

    # 4l(d): TopoViT-B/16 at full width with topo_shard_plan over the 4 ranks
    cfg = _vit_cfg("cuda", "float32", topo_shard_plan=True)
    model = vit.init_params(cfg, VIT["seed"], VIT["classes"],
                            VIT["patch_dim"], device=dev)
    patches = _patches(cfg, a["vit_batch"], torch.float32, dev)
    C.reset_counts()
    b1, b2 = ops.LAUNCHES, topo_ops.LAUNCHES
    with sharding.use_sharding(mesh):
        t0 = time.perf_counter()
        got = _vit_forward(cfg, model, patches, dev)
        torch.cuda.synchronize()
        vit_s = time.perf_counter() - t0
    counts = dict(C.COUNTS)
    want = _vit_forward(cfg.replace(topo_shard_plan=False), model, patches,
                        dev)
    err = _shard_check("4l(d) TopoViT logits", got, want, SHARD_VIT_TOL)
    n_fm = 2 * cfg.num_layers
    if counts != {"all_to_all": n_fm, "reduce_scatter": n_fm}:
        raise AssertionError(f"4l(d): collectives {counts}, {n_fm} sharded "
                             "fastmults expected")
    # the mask coefficients' grads, sharded against single-device on the
    # same image: each rank reads only its share of every block's
    # coefficients, so their grads must be summed over the ranks
    p1 = _patches(cfg, a["vit_grad_batch"], torch.float32, dev)
    coeffs = [blk.topo.coeffs for blk in model.blocks]
    with sharding.use_sharding(mesh):
        g_sh = torch.autograd.grad(vit.forward(cfg, model, p1,
                                               device=dev).sum(), coeffs)
    # the single-device backwards on rank 0 alone (four at once do not fit
    # on the card beside the parent's memory), sent to every rank through
    # the host: impl "cuda" (the reference of the check) and "torch" (the
    # float32 spread of two single-device runs, printed)
    torch.cuda.empty_cache()
    dist.barrier()
    n_c = sum(c.numel() for c in coeffs)
    flat = torch.zeros(2 * n_c)
    if rank == 0:
        flat = torch.cat([g.reshape(-1) for impl in ("cuda", "torch")
                          for g in torch.autograd.grad(vit.forward(
                              cfg.replace(topo_shard_plan=False,
                                          topo_attn_impl=impl), model, p1,
                              device=dev).sum(), coeffs)]).cpu()
        torch.cuda.empty_cache()
    dist.broadcast(flat, src=0)
    sizes = [c.numel() for c in coeffs]
    g_one, g_torch = ([g.view_as(c).to(dev) for g, c in zip(
        part.split(sizes), coeffs)] for part in flat.split(n_c))
    gerr = [_shard_check(f"4l(d) block {i} mask coefficient grads", gs, g1,
                         SHARD_GRAD_TOL)
            for i, (gs, g1) in enumerate(zip(g_sh, g_one))]
    gfloor = [rel_err(gt, g1) for gt, g1 in zip(g_torch, g_one)]
    gmax = [float(g.abs().max()) for g in g_one]
    if min(gmax) <= 0:
        raise AssertionError(f"4l(d): mask coefficient grads {gmax}")
    out["vit"] = {"batch": a["vit_batch"], "layers": cfg.num_layers,
                  "rel_err": err, "collectives": counts,
                  "sharded_forward_s": vit_s,
                  "port_kernel_launches": (ops.LAUNCHES - b1,
                                           topo_ops.LAUNCHES - b2),
                  "mask_grad_max_by_layer": gmax,
                  "mask_grad_rel_err_by_layer": gerr,
                  "mask_grad_single_spread_by_layer": gfloor}
    return out


def _shard_rows(spec, params, mesh, fn, X, live, reps) -> dict:
    """4o(a), slice 18: apply_sharded on the field sharded by rows (a
    `Shard(0)` DTensor of X; each rank its block), B1 counted from 0
    around the call (the slice's main path): the rows gathered against
    single-device apply (<= SHARD_FACE_TOL), the result sharded by rows,
    one B1 launch per live cross bucket, and exactly one all_to_all and
    one reduce_scatter by `launch.collectives`' counts and by a census of
    every collective the rank issues (no all_gather). 5m: its times."""
    import torch

    from repro_torch import ftfi
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding

    axis = sharding.plan_axis(mesh)
    Xs = sharding.from_replica(X, mesh, C.row_placements(mesh, axis))
    ops.LAUNCHES = 0
    C.reset_counts()
    census = sharding.CollectiveCensus()
    with census:
        got = ftfi.apply_sharded(spec, params, fn, Xs, mesh=mesh,
                                 backend="cuda")
        torch.cuda.synchronize()
    launched, counts = ops.LAUNCHES, dict(C.COUNTS)
    k = sharding.axis_rank(mesh, axis)
    lo, hi = C.row_bounds(spec.n, sharding.axis_size(mesh, axis), k)
    placed = [repr(p) for p in got.placements]
    local = tuple(got.to_local().shape)
    want = ftfi.apply(spec, params, fn, X, backend="cuda", device=X.device)
    err = _shard_check("4o(a) the field by rows", got, want, SHARD_FACE_TOL)
    if placed != ["Shard(dim=0)"] or local != (hi - lo, X.shape[1]):
        raise AssertionError(f"4o(a): result placed {placed}, local rows "
                             f"{local}, rows [{lo}, {hi}) expected")
    want_counts = {"all_to_all": 1, "reduce_scatter": 1}
    if counts != want_counts or census.counts != want_counts:
        raise AssertionError(f"4o(a): collectives {counts}, census "
                             f"{census.counts}; {want_counts} expected")
    if launched != live or launched == 0:
        raise AssertionError(f"4o(a): {launched} B1 launches, {live} live "
                             "cross buckets")
    return {"rel_err": err, "placements": placed, "local_rows": local,
            "launches": launched, "collectives": census.counts,
            "collective_bytes": census.bytes,
            "times": _shard_times(spec, params, mesh, fn, Xs, reps)}


def _edited_plan(tree, cfg, device):
    """Cell (a)'s tree built reweightable and edited by `SHARD["edits"]`
    seeded update_plan ops."""
    from repro_torch import ftfi

    spec, params = ftfi.build(tree, leaf_size=cfg["leaf"], reweightable=True,
                              device=device)
    ops_list, _ = _random_edits(tree, SHARD["edits"], SHARD["edit_seed"])
    return ftfi.update_plan(spec, params, ops_list)


def shard_kernel_rows(kernels, shard, widths) -> None:
    """Add slice 15's launches (4l's ranks, counted from 0 in each) to the
    kernels line's B1 and B2 rows."""
    from repro_torch.kernels.fdist_matvec import kernel as fdist_kernel

    nccl, gloo = shard["shard_nccl"], shard["shard_gloo"]

    def faces(g, pick):
        return sum(f["launches"] for f in g["faces"] if pick(f))

    for k in kernels:
        for d in widths:
            if k["name"] != f"fdist_matvec_batched[d={d}]":
                continue
            on = d == SHARD["d"]  # 4l(b)/(c) run at this width only
            k.update(
                shard_launches={
                    "nccl_one_rank": nccl["launches_by_td"][
                        fdist_kernel.tile_width(d)],
                    "gloo_per_rank": [g["launches"] if on else 0
                                      for g in gloo]},
                shard_face_launches=[faces(g, lambda f: f["face"] ==
                                           "fdist_matvec_batched_sharded")
                                     if on else 0 for g in gloo],
                shard_at=("4l(a): apply_sharded on one NCCL rank, one "
                          "launch per cross bucket; 4l(b): per rank of 4 "
                          "gloo processes sharing the card, one launch per "
                          "live cross bucket; 4l(c): the sharded face on a "
                          "(2, 2) mesh, per rank"),
                rows_launches=[g["field_rows"]["launches"] if on else 0
                               for g in gloo],
                rows_at=("4o(a), slice 18: apply_sharded on the field "
                         "sharded by rows, per rank of 4 gloo processes "
                         "sharing the card, one launch per live cross "
                         "bucket"))
        for mode in ("decay", "rank16"):
            if k["name"] == f"topo_attention_sweep[{mode}]":
                k.update(shard_face_launches=[
                    faces(g, lambda f: f.get("mode") == mode) for g in gloo],
                    shard_at=("4l(c): topo_linear_attention_sharded on a "
                              "(2, 2) mesh of gloo ranks sharing the card, "
                              "per rank, at H = 32, 30 and 31"))


def phase_shard(cfg, device, card):
    """Slice 15 (cell (t)): the plans are built on the host and saved to a
    temporary directory; 4l(a) runs on one NCCL rank, 4l(b)-(d) and 5j's
    per-rank times on one gloo group of 4 processes sharing the card
    (`launch.mesh.run_local`); 5j's partition statistics on the host.
    Returns the record."""
    import shutil
    import tempfile

    from repro_torch import ftfi
    from repro_torch.graphs.graph import Forest
    from repro_torch.graphs.mst import minimum_spanning_forest
    from repro_torch.launch import mesh as M
    from repro_torch.models import vit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        tree = synthetic_tree(cfg)
        spec, params = ftfi.build(tree, leaf_size=cfg["leaf"], device=device)
        ftfi.save_plan(f"{tmp}/a.npz", spec, params)
        s2, p2 = _edited_plan(tree, cfg, device)
        ftfi.save_plan(f"{tmp}/a_edit.npz", s2, p2)
        forest = Forest(minimum_spanning_forest(graph_dataset(cfg)))
        fs, fp = ftfi.build(forest, leaf_size=cfg["forest_leaf"],
                            device=device)
        w = np.random.default_rng(3).uniform(0.5, 2.0, forest.num_trees)
        ftfi.save_plan(f"{tmp}/c.npz", fs, ftfi.PlanParams(
            fp.cross_tgt_d, fp.cross_src_d, fp.leaf_dists,
            tree_w=np.asarray(w, np.float32)))
        gs, _ = vit.build_grid_plan(_vit_cfg(), device)
        stats = {name: {D: ftfi.shard_stats(s, D) for D in SHARD["stats_D"]}
                 for name, s in (("a", spec), ("c", fs), ("vit_grid", gs))}
        for name, by_d in stats.items():
            for D, st in by_d.items():
                print(f"[5j shard_stats] {name} D={D}: block {st['block']}, "
                      f"halo width {st['halo_width']}, halo total "
                      f"{st['halo_total']}, src rows {st['src_rows']}, tgt "
                      f"rows {st['tgt_rows']} (host)", flush=True)
        del s2, p2, fp
        args = {"a": f"{tmp}/a.npz", "a_edit": f"{tmp}/a_edit.npz",
                "c": f"{tmp}/c.npz", "widths": cfg["widths"], **SHARD}
        t0 = time.perf_counter()
        (nccl,) = M.run_local(_shard_nccl_rank, 1, (args,), backend="nccl",
                              timeout=SHARD["timeout"])
        nccl_s = time.perf_counter() - t0
        for r in nccl["rows"]:
            print(f"[4l(a) nccl, one rank] {r['family']} d={r['d']} "
                  f"{r['backend']}: apply_sharded vs apply {r['rel_err']:.2e}"
                  f" (<= {EXACT_TOL}), B1 launches {r['launches']} "
                  f"({nccl['cross_buckets']} cross buckets), collectives "
                  f"{r['collectives']}", flush=True)
        t0 = time.perf_counter()
        gloo = M.run_local(_shard_gloo_rank, SHARD["ranks"], (args,),
                           backend="gloo", timeout=SHARD["timeout"])
        gloo_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for g in gloo:
        k = g["rank"]
        for r in g["rows"]:
            print(f"[4l(b) gloo rank {k}/4] {r['family']} ({r['engine']}, "
                  f"{r['backend']}): vs apply {r['rel_err']:.2e} (<= "
                  f"{EXACT_TOL}), B1 launches {r['launches']} = live buckets "
                  f"{g['live_buckets']} of {g['cross_buckets']}, collectives "
                  f"{r['collectives']}", flush=True)
        print(f"[4l(b) gloo rank {k}/4] grads vs apply's "
              + ", ".join(f"{n} {e:.2e}" for n, e in
                          g["grad_rel_err"].items())
              + f" (<= {EXACT_TOL}); {SHARD['edits']}-edit plan "
              f"{g['edited_rel_err']:.2e}; forest (c) "
              f"{g['forest_rel_err']:.2e}", flush=True)
        for f in g["faces"]:
            print(f"[4l(c) gloo rank {k}/4] {f['face']} "
                  f"{f.get('mode', '')} {f['shape']}"
                  f"{' head axis ' + f['head_axis'] if 'head_axis' in f else ''}"
                  f": max |diff| {f['max_abs_diff']:.3e}, bitwise "
                  f"{f['bitwise']}, launches {f['launches']}", flush=True)
        v = g["vit"]
        print(f"[4l(d) gloo rank {k}/4] TopoViT-B/16 float32 B={v['batch']}"
              f" topo_shard_plan: logits vs single-device {v['rel_err']:.2e}"
              f" (<= {SHARD_VIT_TOL}), collectives {v['collectives']}, "
              f"sharded forward {v['sharded_forward_s']:.2f} s; mask "
              f"coefficient grads ({SHARD['vit_grad_batch']} image) vs "
              f"single-device, worst block "
              f"{max(v['mask_grad_rel_err_by_layer']):.2e} (<= "
              f"{SHARD_GRAD_TOL}); single-device 'torch' vs 'cuda' "
              f"{max(v['mask_grad_single_spread_by_layer']):.2e}",
              flush=True)
    for label, recs in (("nccl", [nccl]), ("gloo", gloo)):
        for g in recs:
            t = g["times"]
            print(f"[5j times, {SHARD_LABELS[label]}] rank "
                  f"{g.get('rank', 0)}: apply_sharded host "
                  f"{t['sharded_host_ms']:.3f} ms, events "
                  f"{t['sharded_event_ms']:.3f} ms | single-device apply host "
                  f"{t['single_host_ms']:.3f} ms, events "
                  f"{t['single_event_ms']:.3f} ms | all_to_all "
                  f"{t['all_to_all_ms']:.3f} ms ({t['all_to_all_bytes']} B), "
                  f"reduce_scatter {t['reduce_scatter_ms']:.3f} ms "
                  f"({t['reduce_scatter_bytes']} B) ({t['route']}) "
                  f"| plan (a), exp, cuda, d={SHARD['d']} | {card}",
                  flush=True)
    for g in gloo:
        r, t = g["field_rows"], g["field_rows"]["times"]
        print(f"[4o(a) gloo rank {g['rank']}/4] apply_sharded on the field "
              f"sharded by rows: gathered vs apply {r['rel_err']:.2e} (<= "
              f"{SHARD_FACE_TOL}), result {r['placements']} with local rows "
              f"{r['local_rows']}, B1 launches {r['launches']}, collectives "
              f"{r['collectives']} ({r['collective_bytes']} B sent)",
              flush=True)
        print(f"[5m 4o(a) times, {SHARD_LABELS['gloo']}] rank {g['rank']}: "
              f"apply_sharded (rows in, rows out) host "
              f"{t['sharded_host_ms']:.3f} ms, events "
              f"{t['sharded_event_ms']:.3f} ms | single-device apply host "
              f"{t['single_host_ms']:.3f} ms, events "
              f"{t['single_event_ms']:.3f} ms | all_to_all "
              f"{t['all_to_all_ms']:.3f} ms ({t['all_to_all_bytes']} B), "
              f"reduce_scatter {t['reduce_scatter_ms']:.3f} ms "
              f"({t['reduce_scatter_bytes']} B) ({t['route']}) | plan (a), "
              f"exp, cuda, d={SHARD['d']} | {card}", flush=True)
    print(f"[slice 15] nccl run {nccl_s:.1f} s, gloo run {gloo_s:.1f} s "
          "(process start-up included; 4o(a) of slice 18 inside the gloo "
          "run); no time here is a multi-GPU time", flush=True)
    return {"shard_stats": {k: {str(D): s for D, s in v.items()}
                            for k, v in stats.items()},
            "shard_nccl": nccl, "shard_gloo": gloo,
            "shard_seconds": {"nccl": nccl_s, "gloo": gloo_s}}


PSHARD = {"ranks": 4, "mesh": (2, 2), "batch": 4, "seq": 512, "layers": 2,
          # vit_grad_batch: 4m(d)'s backward, one image a data rank (the 4
          # ranks' backward of 8 images ran out of the card beside each
          # other, as 4l(d)'s did)
          "steps": 2, "seed": 0, "moe_groups": 2, "vit_batch": 8,
          "vit_grad_batch": 2,
          "timeout": 900}
# tests/test_distribution.py's bounds: the dense step's loss (:52-55), the
# topo LM's (:185-189), the archs' losses (:86), TopoViT's logits (:134)
PSHARD_TOL = {"dense": 1e-4, "topo": 1e-3, "moe": 1e-3, "ssm": 1e-3,
              "vit": 1e-4}
# The step's grads at the seed's weights, each relative to its leaf's max
# (4f's unit, `_leaf`): fixed bounds over the sharded-vs-one-device
# readings on the card (H100 80GB HBM3, 700 W): dense 9.434e-6, topo
# 9.458e-3 (the topo LM's relu feature map: 4f's kink). A grad left
# partial (its reduction over the data or model axis skipped) reads far
# above either: the script reads that too and fails if it does not
PSHARD_GRAD_TOL = {"dense": 1e-4, "topo": 3e-2}
# The parameters after a step, held on the elements where one device's
# grad g of that step is clear of the rounding: |g| >= PSHARD_PICK x the
# grad bound x its leaf's max, and |g| x the clip scale >= 1e3 eps. After
# the first step Adam's update is g / (|g| + eps): where the sharded g has
# g's sign (|g| >= 2 x the grads' error) the two updates differ by at most
# eps / |g| of lr. After a later step from one state, m_hat / sqrt(v_hat)
# moves by ~2 |dg| / |g|: 100 x the bound keeps that under 2e-2 of lr.
# Elsewhere rounding may flip a near-eps grad's update by up to 2 lr: the
# largest difference there is printed, not held
PSHARD_PARAM_TOL = 1e-5
PSHARD_PICK = {"first": 2.0, "later": 100.0}
# tests/test_distribution.py's AdamWConfig
PSHARD_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10,
              "weight_decay": 0.0}
PSHARD_LABEL = "4 processes sharing one H100"


def _pshard_cfg(name):
    """The models of 4m: full width, depth cut to PSHARD["layers"],
    float32, each on its kernel."""
    n = PSHARD["layers"]
    if name == "dense":
        return _dense_cfg("full", "cuda", "float32").replace(num_layers=n)
    if name == "topo":
        return _train_cfg(2, "cuda", "float32", L=PSHARD["seq"]).replace(
            num_layers=n)
    if name == "moe":
        return _wide_cfg("deepseek_v2_lite_16b", "cuda", "float32").replace(
            num_layers=n, first_dense_layers=1,
            moe_groups=PSHARD["moe_groups"])
    if name == "ssm":
        return _ssm_cfg("cuda", "float32").replace(num_layers=n)
    return _vit_cfg("cuda", "float32")


def _pshard_ops(name):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    return {"dense": flash_ops, "moe": flash_ops, "topo": topo_ops,
            "ssm": scan_ops}[name]


def _pshard_batch(cfg, device):
    import torch

    rng = np.random.default_rng(PSHARD["seed"])
    return {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (PSHARD["batch"], PSHARD["seq"])),
        device=device)}


def _pshard_trace(records) -> list:
    return [{"expert_ids": r["expert_ids"].cpu(), "keep": r["keep"].cpu(),
             "C": r["C"]} for r in records]


def _pshard_single(tmp, device) -> dict:
    """The single-device results of 4m, once, before the group starts (four
    single-device runs at once would not fit beside each other): the
    states after each train step to `tmp`, the losses, routing and logits
    returned."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import api, moe, vit
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    out = {}
    for name in ("dense", "topo"):
        cfg = _pshard_cfg(name)
        model = api.init_params(cfg, PSHARD["seed"], device=device)
        params = dict(model.named_parameters())
        batch = _pshard_batch(cfg, device)
        grads = torch.autograd.grad(api.loss_fn(cfg, model, batch)[0],
                                    list(params.values()))
        torch.save({n: g.cpu() for n, g in zip(params, grads)},
                   f"{tmp}/{name}_grads.pt")
        del grads
        opt = adamw_init(params)
        step = steps.make_train_step(cfg, AdamWConfig(**PSHARD_OPT))
        losses, norms = [], []
        for i in range(PSHARD["steps"]):
            _, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                torch.save({k: v.detach().cpu() for k, v in
                            model.state_dict().items()},
                           f"{tmp}/{name}_step1.pt")
        out[name] = {"losses": losses, "grad_norms": norms}
        del model, opt, params
        torch.cuda.empty_cache()
    for name in ("moe", "ssm"):
        cfg = _pshard_cfg(name)
        model = api.init_params(cfg, PSHARD["seed"], device=device)
        moe.TRACE = [] if name == "moe" else None
        try:
            loss = api.loss_fn(cfg, model, _pshard_batch(cfg, device))[0]
            out[name] = {"loss": float(loss)}
            if name == "moe":
                out[name]["routing"] = _pshard_trace(moe.TRACE)
        finally:
            moe.TRACE = None
        del model, loss
        torch.cuda.empty_cache()
    cfg = _pshard_cfg("vit")
    model = vit.init_params(cfg, VIT["seed"], VIT["classes"],
                            VIT["patch_dim"], device=device)
    patches = _patches(cfg, PSHARD["vit_batch"], torch.float32, device)
    out["vit"] = {"logits": _vit_forward(cfg, model, patches, device).cpu()}
    # the mask coefficients' grads of 4m(d)'s plan run: impl "cuda" (the
    # reference of the check) and "torch" (two single-device runs' spread)
    p1 = _patches(cfg, PSHARD["vit_grad_batch"], torch.float32, device)
    for impl, key in (("cuda", "coeff_grads"), ("torch", "coeff_grads_torch")):
        out["vit"][key] = [g.cpu() for g in torch.autograd.grad(
            vit.forward(cfg.replace(topo_attn_impl=impl), model, p1,
                        device=device).sum(),
            [b.topo.coeffs for b in model.blocks])]
    del model
    torch.cuda.empty_cache()
    return out


def _leaf_tops(grads) -> dict:
    """{leaf (`_leaf`): the largest |grad| of its parameters}."""
    top = {}
    for n, w in grads.items():
        top[_leaf(n)] = max(top.get(_leaf(n), 0.0), float(w.abs().max()))
    return top


def _pshard_grad_check(cfg, model, batch, path, device) -> dict:
    """The sharded loss's grads at the seed's weights, placed as their
    parameters, against the single-device grads saved at `path`, relative
    to their leaf's largest (4f's unit), each rank over its slabs, the max
    over the ranks: {"max", "name", "partial"}; "partial": the same
    reading of the grads still partial (a reduction skipped), where a
    grad comes out partial."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.models import api
    from repro_torch.optim.adamw import place_grads

    params = dict(model.named_parameters())
    with api.sharded_scope(model):
        raw = torch.autograd.grad(api.loss_fn(cfg, model, batch)[0],
                                  list(params.values()))
    grads = place_grads(dict(zip(params, raw)), params)
    want = torch.load(path, mmap=True)
    top = _leaf_tops(want)
    diffs = torch.zeros((2, len(params)), device=device)
    for i, (n, g) in enumerate(grads.items()):
        w = sharding.slab(want[n], g.device_mesh, g.placements)
        diffs[0, i] = (sharding.local(g) - w.to(device)).abs().max()
        r = raw[i]
        if any(pl.is_partial() for pl in r.placements):
            w = sharding.slab(want[n], r.device_mesh, r.placements)
            diffs[1, i] = (sharding.local(r) - w.to(device)).abs().max()
    dist.all_reduce(diffs, op=dist.ReduceOp.MAX)
    scale = torch.tensor([1 / max(top[_leaf(n)], 1e-30) for n in params],
                         device=device)
    errs, bare = (diffs * scale).cpu().tolist()
    worst = max(range(len(errs)), key=errs.__getitem__)
    return {"max": errs[worst], "name": list(params)[worst],
            "partial": max(bare)}


def _pshard_params(model, state_path, grads_path, gnorm: float,
                   pick: float, device) -> dict:
    """`model`'s parameters after a step against one device's saved at
    `state_path`, on the elements PSHARD_PARAM_TOL's comment picks: one
    device's grad g of that step (`grads_path`) with |g| >= pick x its
    leaf's max and |g| min(1, clip / gnorm) >= 1e3 eps. Each rank over its
    slabs, no gather, the max over the ranks: {"max", "name", "share" (of
    the elements picked), "rest" (the largest difference elsewhere, not
    held)}."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.optim.adamw import AdamWConfig

    want = torch.load(state_path, mmap=True)
    grads = torch.load(grads_path, mmap=True)
    top = _leaf_tops(grads)
    oc = AdamWConfig(**PSHARD_OPT)
    floor = 1e3 * oc.eps / min(1.0, oc.clip_norm / (gnorm + 1e-9))
    names = [n for n, _ in model.named_parameters()]
    worst = torch.zeros((2, len(names)), device=device)
    count = torch.zeros(2, dtype=torch.float64, device=device)
    with torch.no_grad():
        for i, (n, p) in enumerate(model.named_parameters()):
            w, g = want[n], grads[n]
            if sharding.is_dtensor(p):
                w = sharding.slab(w, p.device_mesh, p.placements)
                g = sharding.slab(g, p.device_mesh, p.placements)
            g = g.to(device).abs()
            d = (sharding.local(p) - w.to(device)).abs()
            sel = g >= max(pick * top[_leaf(n)], floor)
            worst[0, i] = torch.where(sel, d, 0).max()
            worst[1, i] = torch.where(sel, 0, d).max()
            count += torch.stack([sel.sum(), torch.tensor(
                sel.numel(), device=device)]).double()
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    dist.all_reduce(count)
    i = int(worst[0].argmax())
    return {"max": float(worst[0, i]), "name": names[i],
            "share": float(count[0] / count[1]),
            "rest": float(worst[1].max())}


def _pshard_bytes(tensors) -> tuple:
    """(this rank's bytes, the whole tensors' bytes)."""
    from repro_torch.launch import sharding

    mine = whole = 0
    for t in tensors:
        whole += t.numel() * t.element_size()
        mine += sharding.local(t).numel() * t.element_size()
    return mine, whole


def _pshard_step(cfg, model, opt, batch, census: bool) -> dict:
    """One train step, timed (host clock to synchronize and CUDA events,
    all ranks started together), its peak memory and (census) its
    collectives."""
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding, steps
    from repro_torch.optim.adamw import AdamWConfig

    step = steps.make_train_step(cfg, AdamWConfig(**PSHARD_OPT))
    c = sharding.CollectiveCensus()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with c if census else contextlib.nullcontext():
        _, opt, m = step(model, opt, batch)
    end.record()
    torch.cuda.synchronize()
    rec = {"host_ms": (time.perf_counter() - t0) * 1e3,
           "event_ms": start.elapsed_time(end),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "opt": opt}
    if census:
        rec["collectives"] = {k: {"count": c.counts[k], "bytes": c.bytes[k],
                                  "largest": c.largest[k]} for k in c.counts}
    return rec


def _pshard_ce_census(cfg, device) -> dict:
    """The collectives of the vocab-sharded cross-entropy alone, forward
    and backward, at 4m(a)'s shape: logits (B, L - 1, V) sharded batch
    over data and vocab over model."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import sharding
    from repro_torch.models.layers import cross_entropy_loss

    mesh = sharding.current_mesh()
    V = cfg.padded_vocab()
    b = PSHARD["batch"] // mesh.size(0)
    L = PSHARD["seq"] - 1
    g = torch.Generator(device=device)
    g.manual_seed(PSHARD["seed"] + sharding.axis_rank(mesh, "model"))
    local = torch.randn((b, L, V // mesh.size(1)), generator=g,
                        device=device, requires_grad=True)
    logits = DTensor.from_local(local, mesh, [Shard(0), Shard(2)],
                                run_check=False)
    labels = sharding.distribute_batch(
        _pshard_batch(cfg, device)["tokens"][:, 1:], mesh)
    c = sharding.CollectiveCensus()
    with c, sharding.dtensor_scope():
        cross_entropy_loss(logits, labels, V).backward()
    logit_bytes = local.numel() * local.element_size()
    largest = max(c.largest.values())
    if largest * 100 > logit_bytes:
        raise AssertionError(f"4m(a) cross-entropy: a collective of "
                             f"{largest} B against {logit_bytes} B of "
                             "logits a rank")
    return {"counts": c.counts, "bytes": c.bytes, "largest": largest,
            "logit_bytes_per_rank": logit_bytes}


def _pshard_rank(a) -> dict:
    """4m(a)-(d) and 5k on one of 4 gloo ranks sharing the card, a (2, 2)
    mesh over ("data", "model")."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding
    from repro_torch.models import api, moe, vit
    from repro_torch.optim.adamw import adamw_init

    dev = _shard_setup()
    rank = dist.get_rank()
    mesh = M.make_local_mesh(*PSHARD["mesh"])
    data = sharding.axis_rank(mesh, "data")
    out = {"rank": rank, "coords": (data, sharding.axis_rank(mesh, "model"))}
    single = a["single"]

    # 4m(a): the sharded train steps, and 5k on the dense one
    for name in ("dense", "topo"):
        cfg = _pshard_cfg(name)
        model = api.init_params(cfg, PSHARD["seed"], device=dev)
        ops = _pshard_ops(name)
        with sharding.use_sharding(mesh):
            sharding.distribute_params(model, mesh)
            torch.cuda.empty_cache()
            batch = _pshard_batch(cfg, dev)
            gcheck = _pshard_grad_check(cfg, model, batch,
                                        f"{a['tmp']}/{name}_grads.pt", dev)
            torch.cuda.empty_cache()
            opt = adamw_init(dict(model.named_parameters()))
            ops.LAUNCHES = 0
            recs = []
            g_tol = PSHARD_GRAD_TOL[name]
            for i in range(PSHARD["steps"]):
                r = _pshard_step(cfg, model, opt, batch,
                                 census=name == "dense"
                                 and i == PSHARD["steps"] - 1)
                opt = r.pop("opt")
                recs.append(r)
                if i == 0:
                    pcheck = _pshard_params(
                        model, f"{a['tmp']}/{name}_step1.pt",
                        f"{a['tmp']}/{name}_grads.pt",
                        single[name]["grad_norms"][0],
                        PSHARD_PICK["first"] * g_tol, dev)
            launches = ops.LAUNCHES
            tol = PSHARD_TOL[name]
            dl = max(abs(r["loss"] - w) for r, w in
                     zip(recs, single[name]["losses"]))
            gn = single[name]["grad_norms"][0]
            dn = abs(recs[0]["grad_norm"] - gn) / gn
            # one launch a layer a forward, and the remat's recompute of
            # each block in the backward runs its forward again
            per_step = cfg.num_layers * (2 if cfg.remat else 1)
            if launches != per_step * PSHARD["steps"]:
                raise AssertionError(f"4m(a) {name} rank {rank}: {launches} "
                                     f"kernel launches, {per_step} a step "
                                     "expected")
            if not (dl < tol and gcheck["max"] < g_tol and dn < g_tol
                    and pcheck["max"] < PSHARD_PARAM_TOL
                    and pcheck["share"] > 0):
                raise AssertionError(
                    f"4m(a) {name} rank {rank}: losses {dl:.3e} (< {tol}), "
                    f"grads {gcheck['max']:.3e} (< {g_tol}) at "
                    f"{gcheck['name']}, grad norm {dn:.3e} (< {g_tol}), "
                    f"parameters after a step {pcheck['max']:.3e} (< "
                    f"{PSHARD_PARAM_TOL}) at {pcheck['name']} on "
                    f"{pcheck['share']:.3%} of them, from one device's")
            if not gcheck["partial"] > g_tol:
                raise AssertionError(
                    f"4m(a) {name} rank {rank}: a grad left partial reads "
                    f"{gcheck['partial']:.3e}, under the bound {g_tol}: "
                    "the gate cannot tell a skipped reduction")
            rec = {"losses": [r["loss"] for r in recs], "loss_diff": dl,
                   "grad_rel_err": gcheck["max"],
                   "grad_worst": gcheck["name"],
                   "grad_partial": gcheck["partial"], "grad_norm_diff": dn,
                   "params": pcheck, "launches": launches,
                   "launches_per_step": per_step, "steps": recs}
            if name == "dense":
                params = list(model.parameters())
                rec["bytes"] = {
                    "params": _pshard_bytes(params),
                    "grads": _pshard_bytes(params),  # placed as the params
                    "adamw": _pshard_bytes(list(opt.mu.values())
                                           + list(opt.nu.values()))}
                rec["ce"] = _pshard_ce_census(cfg, dev)
                # 4m(c): save from (2, 2); restore on (1, 4); one more step
                mgr = CheckpointManager(a["ckpt"], keep=2)
                dist.barrier()
                t0 = time.perf_counter()
                saved = mgr.save(PSHARD["steps"], model, opt)
                rec["save_s"] = time.perf_counter() - t0
                del model, opt, params
                torch.cuda.empty_cache()
            out[name] = rec
        if name == "dense":
            out["ckpt"] = _pshard_restore(a, cfg, saved, dev)
        else:
            del model, opt
        torch.cuda.empty_cache()

    # 4m(b): the sharded losses
    for name in ("moe", "ssm"):
        cfg = _pshard_cfg(name)
        model = api.init_params(cfg, PSHARD["seed"], device=dev)
        ops = _pshard_ops(name)
        with sharding.use_sharding(mesh):
            sharding.distribute_params(model, mesh)
            torch.cuda.empty_cache()
            moe.TRACE = [] if name == "moe" else None
            try:
                ops.LAUNCHES = 0
                t0 = time.perf_counter()
                loss = float(sharding.full(api.loss_fn(
                    cfg, model, _pshard_batch(cfg, dev))[0]))
                rec = {"loss": loss, "loss_diff": abs(
                    loss - single[name]["loss"]), "launches": ops.LAUNCHES,
                    "seconds": time.perf_counter() - t0}
                if name == "moe":
                    rec.update(_pshard_routing(moe.TRACE, single[name][
                        "routing"], cfg, data, sharding.axis_size(
                            mesh, "data")))
            finally:
                moe.TRACE = None
        if rec["launches"] != cfg.num_layers:
            raise AssertionError(f"4m(b) {name} rank {rank}: "
                                 f"{rec['launches']} kernel launches, "
                                 f"{cfg.num_layers} expected")
        if not rec["loss_diff"] < PSHARD_TOL[name]:
            raise AssertionError(f"4m(b) {name} rank {rank}: loss "
                                 f"{rec['loss_diff']:.3e} from one device's")
        if rec.get("routing_mismatches"):
            raise AssertionError(f"4m(b) moe rank {rank}: "
                                 f"{rec['routing_mismatches']} routing "
                                 "assignments differ from one device's")
        out[name] = rec
        del model
        torch.cuda.empty_cache()

    # 4m(d): TopoViT-B/16, batch over data, params by the rules
    cfg = _pshard_cfg("vit")
    model = vit.init_params(cfg, VIT["seed"], VIT["classes"],
                            VIT["patch_dim"], device=dev)
    patches = _patches(cfg, PSHARD["vit_batch"], torch.float32, dev)
    with sharding.use_sharding(mesh):
        sharding.distribute_params(model, mesh)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with sharding.dtensor_scope():
            with torch.no_grad():
                logits = vit.forward(cfg, model, patches, device=dev)
            vit_s = time.perf_counter() - t0
            vit.forward(cfg, model, _patches(
                cfg, PSHARD["vit_grad_batch"], torch.float32, dev),
                device=dev).sum().backward()
        got = sharding.full(logits.detach()).cpu()
        grads = [sharding.full(b.topo.coeffs.grad).cpu()
                 for b in model.blocks]
    d = float((got - single["vit"]["logits"]).abs().max())
    gmax = [float(g.abs().max()) for g in grads]
    if not (d < PSHARD_TOL["vit"] and all(
            bool(torch.isfinite(g).all()) for g in grads) and min(gmax) > 0):
        raise AssertionError(f"4m(d) rank {rank}: logits {d:.3e} from one "
                             f"device's, coefficient grads {gmax}")
    out["vit"] = {"logit_diff": d, "placements": str(logits.placements),
                  "coeff_grad_max": gmax, "seconds": vit_s}
    out["vit_plan"] = _pshard_vit_plan(cfg, model, mesh, single["vit"], dev)
    return out


def _pshard_vit_plan(cfg, model, mesh, single, dev) -> dict:
    """4m(d) with `topo_shard_plan` (ROADMAP C12): the sharded model's
    TopoViT with the plan's row blocks over the model axis, its logits and
    mask coefficient grads against one device's, and its collectives by a
    census of the forward and of the backward. Each layer trades the
    fields between heads and rows by 2 all_to_alls (their VJPs in the
    backward) and all_gathers no field (no 4-D tensor)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.models import vit

    rank = dist.get_rank()
    cfg = cfg.replace(topo_shard_plan=True)
    M = sharding.axis_size(mesh, "model")
    B, L, layers = PSHARD["vit_batch"], cfg.num_prefix_embeddings, \
        cfg.num_layers
    D = sharding.axis_size(mesh, "data")

    def gathered(images):  # 3 heads slabs in, the rows out, float32
        return 4 * (M - 1) / M * (images // D * cfg.num_heads * L
                                  * cfg.head_dim * 4)

    fwd = sharding.CollectiveCensus(keep=True)
    bwd = sharding.CollectiveCensus(keep=True)
    with sharding.use_sharding(mesh):
        with sharding.dtensor_scope():
            t0 = time.perf_counter()
            with torch.no_grad(), fwd:
                logits = vit.forward(cfg, model, _patches(
                    cfg, B, torch.float32, dev), device=dev)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            model.zero_grad(set_to_none=True)
            out = vit.forward(cfg, model, _patches(
                cfg, PSHARD["vit_grad_batch"], torch.float32, dev),
                device=dev)
            with bwd:  # every parameter's grad: each VJP of the layer
                out.sum().backward()
        got = sharding.full(logits).cpu()
        grads = [sharding.full(b.topo.coeffs.grad).cpu()
                 for b in model.blocks]
    d = float((got - single["logits"]).abs().max())
    # each block's grads relative to the largest of all blocks (the mask
    # scalars as one leaf, 4f's unit): a block whose grads are ~1/300 of
    # the largest reads ~3e-3 of its own max between two single-device
    # runs (card "cuda" vs CPU "torch", and card "cuda" vs card "torch"
    # below), so 4l(d)'s per-block unit cannot hold at these images
    ones = single["coeff_grads"]
    top = max(float(g1.abs().max()) for g1 in ones)
    gerr = max(float((g - g1).abs().max()) for g, g1 in zip(grads, ones)) / top
    rec = {"logit_diff": d, "coeff_grad_err": gerr, "forward_s": fwd_s,
           "coeff_grad_rel_err_by_block": [
               rel_err(g, g1) for g, g1 in zip(grads, ones)],
           "single_spread": max(float((g - g1).abs().max()) for g, g1 in zip(
               single["coeff_grads_torch"], ones)) / top,
           "single_spread_by_block": [rel_err(g, g1) for g, g1 in zip(
               single["coeff_grads_torch"], ones)]}
    for key, census, images in (("forward", fwd, B),
                                ("backward", bwd, PSHARD["vit_grad_batch"])):
        sent = list(zip(census.sent_kinds, census.sent))
        fields = [t for k, t in sent if k == "all_to_all" and t.dim() == 4]
        rec[key] = {
            "by_kind": {k: {"count": census.counts[k] / layers,
                            "bytes": census.bytes[k] / layers}
                        for k in sorted(census.counts)},
            "field_all_gathers": sum(k == "all_gather" and t.dim() == 4
                                     for k, t in sent),
            "exchanges_a_layer": len(fields) / layers,
            "received_a_layer": sum(t.numel() * t.element_size()
                                    for t in fields) * (M - 1) / M / layers,
            "gathered_a_layer": gathered(images), "images": images}
        if not (rec[key]["field_all_gathers"] == 0
                and rec[key]["exchanges_a_layer"] == 2
                and rec[key]["received_a_layer"] <= gathered(images) / 2):
            raise AssertionError(f"4m(d) topo_shard_plan rank {rank} "
                                 f"{key}: {rec[key]}")
    if not (d < PSHARD_TOL["vit"] and gerr < SHARD_GRAD_TOL):
        raise AssertionError(f"4m(d) topo_shard_plan rank {rank}: logits "
                             f"{d:.3e} (< {PSHARD_TOL['vit']}), coefficient "
                             f"grads {gerr:.3e} of the largest (< "
                             f"{SHARD_GRAD_TOL}) from one device's")
    return rec


def _pshard_routing(got, want, cfg, data: int, D: int) -> dict:
    """This rank's routing records against one device's on the rank's
    groups: expert ids and kept masks, assignment by assignment."""
    G = cfg.moe_groups
    layers = len(want) // G
    per = len(got) // layers
    first = data * per if per < G else 0
    mism = 0
    for li in range(layers):
        for j in range(per):
            g, w = got[li * per + j], want[li * G + first + j]
            mism += int((g["expert_ids"].cpu() != w["expert_ids"]).sum())
            mism += int((g["keep"].cpu() != w["keep"]).sum())
            mism += int(g["C"] != w["C"])
    return {"routing_groups": per * layers, "routing_mismatches": mism,
            "routing_assignments": sum(int(r["keep"].numel()) for r in got)}


def _pshard_restore(a, cfg, saved, dev) -> dict:
    """4m(c): restore the (2, 2) checkpoint on one device (rank 0, plain
    tensors) and on a (1, 4) mesh, each against the saved arrays bit for
    bit, then one more step on each: the (1, 4) step held to the
    one-device step from the same state as 4m(a)'s step is (its loss,
    grad norm, and the parameters on the picked elements)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding, steps
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    tmp = a["tmp"]
    batch = _pshard_batch(cfg, dev)
    if dist.get_rank() == 0:
        model = api.init_params(cfg, PSHARD["seed"] + 1, device=dev)
        params = dict(model.named_parameters())
        opt = adamw_init(params)
        CheckpointManager(a["ckpt"]).restore(model, opt)
        one = {"bitwise": _pshard_bitwise(saved, model, opt)}
        grads = torch.autograd.grad(api.loss_fn(cfg, model, batch)[0],
                                    list(params.values()))
        torch.save({n: g.cpu() for n, g in zip(params, grads)},
                   f"{tmp}/restored_grads.pt")
        del grads
        _, opt, m = steps.make_train_step(cfg, AdamWConfig(**PSHARD_OPT))(
            model, opt, batch)
        one.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, f"{tmp}/restored_step.pt")
        torch.save(one, f"{tmp}/restored.pt")
        del model, opt, params
        torch.cuda.empty_cache()
    dist.barrier()
    one = torch.load(f"{tmp}/restored.pt")
    mesh14 = M.make_local_mesh(1, PSHARD["ranks"])
    model = api.init_params(cfg, PSHARD["seed"] + 1, device=dev)
    with sharding.use_sharding(mesh14):
        sharding.distribute_params(model, mesh14)
        torch.cuda.empty_cache()
        opt = adamw_init(dict(model.named_parameters()))
        t0 = time.perf_counter()
        CheckpointManager(a["ckpt"]).restore(model, opt)
        restore_s = time.perf_counter() - t0
        bitwise = _pshard_bitwise(saved, model, opt)
        r = _pshard_step(cfg, model, opt, batch, census=False)
        g_tol = PSHARD_GRAD_TOL["dense"]
        pcheck = _pshard_params(model, f"{tmp}/restored_step.pt",
                                f"{tmp}/restored_grads.pt", one["grad_norm"],
                                PSHARD_PICK["later"] * g_tol, dev)
    dl = abs(r["loss"] - one["loss"])
    dn = abs(r["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    if not (bitwise and one["bitwise"]):
        raise AssertionError(f"4m(c): restores bit for bit: (1, 4) "
                             f"{bitwise}, one device {one['bitwise']}")
    if not (dl < PSHARD_TOL["dense"] and dn < g_tol
            and pcheck["max"] < PSHARD_PARAM_TOL and pcheck["share"] > 0):
        raise AssertionError(
            f"4m(c): the step after the (1, 4) restore against one "
            f"device's: loss {dl:.3e}, grad norm {dn:.3e}, parameters "
            f"{pcheck['max']:.3e} (< {PSHARD_PARAM_TOL}) at "
            f"{pcheck['name']} on {pcheck['share']:.3%} of them")
    return {"restore_s": restore_s, "bitwise": bitwise,
            "one_bitwise": one["bitwise"], "loss": r["loss"],
            "one_loss": one["loss"], "loss_diff": dl, "grad_norm_diff": dn,
            "params": pcheck}


def _pshard_bitwise(saved, model, opt) -> bool:
    """Whether every tensor of `model` and `opt` (DTensors or plain) holds
    its slab of the arrays saved under `saved`, bit for bit."""
    import torch

    from repro_torch.launch import sharding

    trees = {"params": dict(model.named_parameters()),
             "opt": {**{f"mu.{k}": v for k, v in opt.mu.items()},
                     **{f"nu.{k}": v for k, v in opt.nu.items()}}}
    for part, tensors in trees.items():
        with np.load(f"{saved}/{part}.npz") as z:
            for k, t in tensors.items():
                want = torch.from_numpy(z[k])
                if sharding.is_dtensor(t):
                    want = sharding.slab(want, t.device_mesh, t.placements)
                if not torch.equal(sharding.local(t).detach().cpu(), want):
                    return False
    return True


def pshard_kernel_rows(kernels, rec) -> None:
    """Add slice 16's per-rank launches (4m, counted from 0 in each rank
    around each gate) to the kernels line's B2, B5 and B6 rows."""
    ranks = rec["param_shard_ranks"]
    at = {"topo_attention_sweep[rank16]": (
              "topo", "4m(a): the topo Llama-3.2-1B's sharded train step, "
              "degree 2, per rank of 4 gloo processes sharing the card"),
          "flash_attention[causal]": (
              "dense", "4m(a): the dense Llama-3.2-1B's sharded train step,"
              " per rank of 4 gloo processes sharing the card"),
          "flash_attention[causal,hd=192,vd=128]": (
              "moe", "4m(b): DeepSeek-V2-Lite's sharded loss (MLA), per "
              "rank"),
          "selective_scan": (
              "ssm", "4m(b): Falcon-Mamba-7B's sharded loss, per rank")}
    for k in kernels:
        if k["name"] in at:
            name, where = at[k["name"]]
            k.update(param_shard_launches=[r[name]["launches"]
                                           for r in ranks],
                     param_shard_at=where)


def phase_param_shard(card, device) -> dict:
    """Slice 16 (path (u)): the LM's parameter sharding on a (2, 2) mesh of
    4 gloo processes sharing the card. The single-device results first, in
    this process, saved to a temporary directory; then 4m(a)-(d) and 5k in
    the ranks. Returns the record."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as M

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pshard_")
    try:
        t0 = time.perf_counter()
        single = _pshard_single(tmp, device)
        single_s = time.perf_counter() - t0
        args = {"tmp": tmp, "ckpt": f"{tmp}/ckpt", "single": single}
        t0 = time.perf_counter()
        ranks = M.run_local(_pshard_rank, PSHARD["ranks"], (args,),
                            backend="gloo", timeout=PSHARD["timeout"])
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _pshard_print(single, ranks, card)
    print(f"[slice 16] single-device results {single_s:.1f} s, gloo run "
          f"{ranks_s:.1f} s (process start-up included); no time here is a "
          "multi-GPU time", flush=True)
    return {"param_shard_ranks": ranks, "param_shard_single": {
                k: {kk: vv for kk, vv in v.items()
                    if kk in ("losses", "loss", "grad_norms")}
                for k, v in single.items()},
            "param_shard_seconds": {"single": single_s, "gloo": ranks_s}}


def _pshard_print(single, ranks, card) -> None:
    for g in ranks:
        k = g["rank"]
        for name in ("dense", "topo"):
            r = g[name]
            pc = r["params"]
            print(f"[4m(a) {name} rank {k}/4 {g['coords']}] "
                  f"{PSHARD['steps']} steps, losses {r['losses']} vs one "
                  f"device {single[name]['losses']}: {r['loss_diff']:.3e} (< "
                  f"{PSHARD_TOL[name]}); grads {r['grad_rel_err']:.3e} of "
                  f"their leaf's max at {r['grad_worst']} (< "
                  f"{PSHARD_GRAD_TOL[name]}; left partial they read "
                  f"{r['grad_partial']:.3e}); grad norm "
                  f"{r['grad_norm_diff']:.3e} relative; parameters after "
                  f"step 1 {pc['max']:.3e} at {pc['name']} (< "
                  f"{PSHARD_PARAM_TOL}) on the {pc['share']:.3%} picked, "
                  f"{pc['rest']:.3e} elsewhere (not held) | kernel launches "
                  f"{r['launches']} ({r['launches_per_step']} a step: one a"
                  " layer a forward, the remat recompute included)",
                  flush=True)
        c = g["ckpt"]
        pc = c["params"]
        print(f"[4m(c) rank {k}/4] saved from (2, 2) in "
              f"{g['dense']['save_s']:.1f} s; restored on (1, 4) in "
              f"{c['restore_s']:.1f} s, bit for bit {c['bitwise']} (one "
              f"device {c['one_bitwise']}); one more step on each: loss "
              f"{c['loss']:.6f} vs {c['one_loss']:.6f} ({c['loss_diff']:.3e})"
              f", grad norm {c['grad_norm_diff']:.3e} relative, parameters "
              f"{pc['max']:.3e} (< {PSHARD_PARAM_TOL}) on the "
              f"{pc['share']:.3%} picked, {pc['rest']:.3e} elsewhere",
              flush=True)
        for name in ("moe", "ssm"):
            r = g[name]
            extra = (f", routing: {r['routing_groups']} groups, "
                     f"{r['routing_mismatches']} of "
                     f"{r['routing_assignments']} assignments differ"
                     if name == "moe" else "")
            print(f"[4m(b) {name} rank {k}/4] loss {r['loss']:.6f} vs one "
                  f"device {single[name]['loss']:.6f}: {r['loss_diff']:.3e}"
                  f" (< {PSHARD_TOL[name]}); kernel launches "
                  f"{r['launches']}{extra}; {r['seconds']:.1f} s",
                  flush=True)
        v = g["vit"]
        print(f"[4m(d) rank {k}/4] TopoViT-B/16 float32, "
              f"{PSHARD['vit_batch']} images, batch over data: logits "
              f"{v['logit_diff']:.3e} from one device's (< "
              f"{PSHARD_TOL['vit']}), {v['placements']}; mask coefficient "
              f"grads ({PSHARD['vit_grad_batch']} images) max "
              f"{min(v['coeff_grad_max']):.3e}.."
              f"{max(v['coeff_grad_max']):.3e}; forward {v['seconds']:.1f} s",
              flush=True)
        v = g["vit_plan"]
        print(f"[4m(d) topo_shard_plan rank {k}/4] logits "
              f"{v['logit_diff']:.3e} from one device's (< "
              f"{PSHARD_TOL['vit']}); mask coefficient grads "
              f"{v['coeff_grad_err']:.3e} of the largest of all blocks (< "
              f"{SHARD_GRAD_TOL}; two single-device impls "
              f"{v['single_spread']:.3e}); by block, of each block's own "
              f"largest: {max(v['coeff_grad_rel_err_by_block']):.3e} at "
              f"most (single-device impls "
              f"{max(v['single_spread_by_block']):.3e}); forward "
              f"{v['forward_s']:.1f} s", flush=True)
        for key in ("forward", "backward"):
            c = v[key]
            print(f"[4m(d) topo_shard_plan rank {k}/4] {key}, a layer: "
                  + ", ".join(f"{kind} x{r['count']:g} {r['bytes']:.0f} B "
                              "sent" for kind, r in c["by_kind"].items())
                  + f"; heads<->rows all_to_alls {c['exchanges_a_layer']:g}"
                  f", received {c['received_a_layer']:.0f} B against "
                  f"{c['gathered_a_layer']:.0f} B by gathering the fields "
                  f"whole ({c['images']} images); field all_gathers "
                  f"{c['field_all_gathers']} | {PSHARD_LABEL}", flush=True)
        d = g["dense"]
        b = d["bytes"]
        for part in ("params", "grads", "adamw"):
            mine, whole = b[part]
            print(f"[5k {PSHARD_LABEL}] rank {k}: {part} {mine} B of "
                  f"{whole} B on one device ({mine / whole:.3f})",
                  flush=True)
        for i, s in enumerate(d["steps"]):
            print(f"[5k {PSHARD_LABEL}] rank {k}: dense step {i + 1} host "
                  f"{s['host_ms']:.1f} ms, events {s['event_ms']:.1f} ms, "
                  f"peak {s['peak_bytes'] / 2**30:.2f} GiB allocated | "
                  f"{card}", flush=True)
        coll = d["steps"][-1]["collectives"]
        print(f"[5k {PSHARD_LABEL}] rank {k}: collectives of one dense "
              "step: " + ", ".join(
                  f"{kind} x{v['count']} {v['bytes']} B (largest "
                  f"{v['largest']} B)" for kind, v in sorted(coll.items())),
              flush=True)
        ce = d["ce"]
        print(f"[5k {PSHARD_LABEL}] rank {k}: the vocab-sharded "
              f"cross-entropy alone: {ce['counts']}, {ce['bytes']} B, "
              f"largest {ce['largest']} B against "
              f"{ce['logit_bytes_per_rank']} B of logits a rank",
              flush=True)



# ----------------------------------------------------------------------------
# slice 17: the cost count, the roofline and the dry run (ROADMAP A13)
# ----------------------------------------------------------------------------

# 4n/5l: the served bf16 prefill of TOPO's 4 requests (4 x Lp tokens, a
# cache of S) at full width and depth in cells (d) (degree 1, 2) and (e);
# 5l's prefill times are the median of `reps` CUDA-event spans
ROOF = {"reps": 3, "bound_share_max": 1.05,
        "dry_run": ("llama3_2_1b", "train_4k"),
        # slice 18 (5m): the decode cells, after the train cell
        "dry_run_decode": ("decode_32k", "long_500k")}


def _roof_cells():
    """(label, config, the ops module whose kernel the prefill runs)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    return [("(d) degree 1", _topo_cfg(1), topo_ops),
            ("(d) degree 2", _topo_cfg(2), topo_ops),
            ("(e) full", _dense_cfg("full"), flash_ops)]


def _count_prefill(cfg, model, toks, lengths, device) -> dict:
    """The cost count's record of one served prefill (prefill_into_cache
    of the 4 requests into an empty cache of S positions)."""
    import torch
    from repro_torch.models import api
    from repro_torch.roofline.count import CostCount

    S = TOPO["S"]
    cache = api.init_cache(cfg, len(lengths), S, device=device)
    with torch.no_grad(), CostCount() as count:
        count.track_arguments(list(model.parameters()), cache)
        count.track_outputs(api.prefill_into_cache(
            cfg, model, cache, toks, lengths, S, device=device))
    return count.record()


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call of fn() over `reps` calls (each
    call's own span: host gaps between its kernels included)."""
    import torch

    fn()
    spans = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b))
    return float(np.median(spans))


def _roof_plain_count(i: int):
    """4n's plain route (run in a worker process): cell i's served prefill
    under FakeTensorMode on the CPU, the model made there (nothing
    allocated). Returns (record, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import api

    _, cfg, _ = _roof_cells()[i]
    toks, lengths = _prompts(cfg)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = api.init_params(cfg, TOPO["seed"], device="cpu")
        rec = _count_prefill(cfg, model, toks, lengths, "cpu")
    return rec, time.perf_counter() - t0


def _roof_dry_run(shapes):
    """Dry-run records (run in a worker process) of ROOF["dry_run"]'s arch
    at each of `shapes` in turn on the single-pod mesh, a fake group of
    256 ranks: 5l's train cell, then 5m's decode cells (slice 18).
    Returns [(shape, record, seconds)]."""
    from repro_torch.launch import dryrun

    arch, _ = ROOF["dry_run"]
    out = []
    with dryrun.fake_group(dryrun.MESHES["16x16"][1]):
        mesh = dryrun.production_mesh(False)
        for sh in shapes:
            t0 = time.perf_counter()
            rec = dryrun.analyze_cell(arch, sh, mesh, "16x16",
                                      extrapolate=False)
            out.append((sh, rec, time.perf_counter() - t0))
    return out


def phase_roofline(card, device) -> dict:
    """4n: each cell's served prefill counted live on the card (the
    kernels launched) and on the plain route under FakeTensorMode on the
    CPU: the flops and bytes must be equal. 5l: its roofline terms beside its median
    CUDA-event time, the MFU and the bound's share of the time (failing
    past ROOF["bound_share_max"]); one dry-run record. The plain counts
    and the dry run need no card: they run in worker processes (spawned,
    ended here), started only once the card's prefills are timed, so no
    time is taken with the host under their load; the live counts run
    meanwhile."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.models import api
    from repro_torch.roofline.analysis import PEAK_FLOPS, roofline_terms

    cells = _roof_cells()
    out = {}
    times = []
    for label, cfg, kops in cells:
        toks, lengths = _prompts(cfg)
        B, S = len(lengths), TOPO["S"]
        model = api.init_params(cfg, TOPO["seed"], device=device)
        cache0 = api.init_cache(cfg, B, S, device=device)
        times.append(_event_ms(lambda: api.prefill_into_cache(
            cfg, model, cache0, toks, lengths, S, device=device),
            ROOF["reps"]))
        del model, cache0
        torch.cuda.empty_cache()
    with ProcessPoolExecutor(len(cells) + 1,
                             mp_context=mp.get_context("spawn")) as pool:
        dry = pool.submit(_roof_dry_run,
                          (ROOF["dry_run"][1],) + ROOF["dry_run_decode"])
        plain = [pool.submit(_roof_plain_count, i)
                 for i in range(len(cells))]
        # the live counts, on the host while the workers run (no timing)
        live = []
        for (label, cfg, kops), t_ms in zip(cells, times):
            toks, lengths = _prompts(cfg)
            model = api.init_params(cfg, TOPO["seed"], device=device)
            kops.LAUNCHES = 0
            rec = _count_prefill(cfg, model, toks, lengths, device)
            live.append((rec, kops.LAUNCHES, t_ms))
            del model
            torch.cuda.empty_cache()
        for (label, cfg, _), (rec, launches, t_ms), fut in zip(cells, live,
                                                               plain):
            fake, fake_s = fut.result()
            shape = {"global_batch": len(TOPO["lengths"]),
                     "seq_len": TOPO["Lp"], "kind": "prefill"}
            name = next(iter(rec["kernels"]), None)
            seen = {k: v["calls"] for k, v in rec["kernels"].items()}
            print(f"[4n {label}] served bf16 prefill, "
                  f"{len(TOPO['lengths'])} requests x {TOPO['Lp']} (lengths "
                  f"{TOPO['lengths']}, S={TOPO['S']}), {cfg.num_layers} "
                  f"layers: counted flops live on the card "
                  f"{rec['flops']:.6e}, on the plain route under "
                  f"FakeTensorMode on the CPU {fake['flops']:.6e} (equal: "
                  f"{rec['flops'] == fake['flops']}); bytes "
                  f"{rec['bytes_accessed']:.6e} / "
                  f"{fake['bytes_accessed']:.6e} (equal: "
                  f"{rec['bytes_accessed'] == fake['bytes_accessed']}); "
                  "calls the count saw "
                  f"{seen} live, "
                  f"{ {k: v['calls'] for k, v in fake['kernels'].items()} } "
                  f"plain; launched {launches}; the plain count took "
                  f"{fake_s:.1f} s in a worker", flush=True)
            if (rec["flops"], rec["bytes_accessed"]) != (
                    fake["flops"], fake["bytes_accessed"]) or (
                    launches != cfg.num_layers or seen.get(name) != launches):
                raise AssertionError(f"4n {label}: the count's flops or "
                                     "bytes differ by route, or it missed a "
                                     "launch")
            terms = roofline_terms(rec, cfg, shape, 1)
            t_s = t_ms / 1e3
            mfu = terms["model_flops"] / (t_s * PEAK_FLOPS)
            share = terms["roofline_bound_s"] / t_s
            print(f"[5l {label}] prefill {t_ms:.3f} ms (median of "
                  f"{ROOF['reps']} CUDA-event spans) | {card}; compute_s "
                  f"{terms['compute_s']:.6f}, memory_s "
                  f"{terms['memory_s']:.6f}, roofline_bound_s "
                  f"{terms['roofline_bound_s']:.6f} ({terms['dominant']}), "
                  f"model_flops {terms['model_flops']:.6e}, mfu {mfu:.4f}, "
                  f"bound_share {share:.4f} (<= {ROOF['bound_share_max']}); "
                  f"peak counted {rec['peak_bytes_per_device'] / 2**30:.2f} "
                  "GiB", flush=True)
            if share > ROOF["bound_share_max"]:
                raise AssertionError(
                    f"5l {label}: the roofline bound "
                    f"{terms['roofline_bound_s']:.4f} s exceeds the "
                    f"measured {t_s:.4f} s")
            out[label] = {"live": rec, "plain": fake, "launches": launches,
                          "prefill_ms": t_ms, "terms": terms, "mfu": mfu,
                          "bound_share": share, "plain_count_s": fake_s,
                          "card": card}
        dry_runs = dry.result()
    arch, _ = ROOF["dry_run"]
    for shape, rec, wall in dry_runs:
        tag = "5l" if shape == ROOF["dry_run"][1] else "5m"
        print(f"[{tag} dry run] {arch} x {shape} x 16x16 (a fake group of "
              f"256 ranks in a worker process, FakeTensorMode on the CPU) "
              f"in {wall:.1f} s wall: " + json.dumps(
                  {k: v for k, v in rec.items() if k != "kernels"}),
              flush=True)
        out["dry_run" if tag == "5l" else f"dry_run_{shape}"] = dict(
            rec, wall_s=wall)
    return out


# slice 18 (path (v)): the decode step on DTensors. Llama-3.2-1B at full
# width cut to 2 layers (as 4m), float32: dense and topological (degree 2)
# at B = 4 over a cache of 4,096 positions filled by the single-device
# prefill of 4 x 512 tokens, and dense at B = 1 over 32,768 positions (the
# sequence over data); 8 greedy steps each
SSHARD = {"ranks": 4, "mesh": (2, 2), "layers": 2, "batch": 4, "S": 4096,
          "prompt": 512, "steps": 8, "long_S": 32768, "seed": 0,
          "timeout": 600}
SSHARD_LOGIT_TOL, SSHARD_CACHE_TOL = 1e-4, 1e-5  # tests/test_torch_steps.py
SSHARD_CASES = ("dense", "topo", "long")


def _sshard_cfg(name):
    n = SSHARD["layers"]
    if name == "topo":
        return _topo_cfg(2, "cuda", "float32").replace(
            num_layers=n, topo_dist_scale=1.0 / SSHARD["S"])
    return _dense_cfg("full", "cuda", "float32").replace(num_layers=n)


def _cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _stepped(step, *args):
    """One `make_serve_step` call and the logits its `api.decode_fn`
    returned: the checked logits, token and cache and the timed call are
    one computation."""
    from repro_torch.models import api

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


def _sshard_case(name, mesh, dev) -> dict:
    """4o(b) for one case on this rank: the single-device prefill fills the
    cache, then each step runs on one device (`make_serve_step`, its
    logits read inside it) and on the sharded model (the cache, token and
    pos placed by `launch.specs.decode_shardings`), compared at once:
    tokens equal, logits and the rank's cache slab within their bounds, no
    collective sending a cache slab (a census holding every tensor sent)
    and the largest all_gather under 1/100 of the rank's slab."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops
    from repro_torch.launch import sharding, specs, steps
    from repro_torch.models import api, lm

    cfg = _sshard_cfg(name)
    B = 1 if name == "long" else SSHARD["batch"]
    S = SSHARD["long_S"] if name == "long" else SSHARD["S"]
    P = SSHARD["prompt"]
    torch.cuda.reset_peak_memory_stats()
    model = api.init_params(cfg, SSHARD["seed"], device=dev)
    rng = np.random.default_rng(SSHARD["seed"])
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, P)), device=dev)
    cache = api.init_cache(cfg, B, S, device=dev)
    logits, cache = api.prefill_into_cache(
        cfg, model, cache, toks, torch.full((B,), P, device=dev), S,
        device=dev)
    token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    sharded = lm.from_state_dict(cfg, {k: v.clone() for k, v in
                                       model.state_dict().items()})
    step = steps.make_serve_step(cfg, S, device=dev)
    c1, t1, rows = cache, token, []
    with sharding.use_sharding(mesh):
        sharding.distribute_params(sharded, mesh)
        pls = specs.decode_shardings(cfg, cache, B, S, mesh)
        c2 = specs.distribute_cache(cache, pls["cache"], mesh)
        t2 = sharding.from_replica(token, mesh, pls["token"])
        slab = sum(sharding.local(t).numel() * sharding.local(t).element_size()
                   for _, t in _cache_leaves(c2))
        whole = sum(t.numel() * t.element_size()
                    for _, t in _cache_leaves(cache))
        flash_ops.LAUNCHES = topo_ops.LAUNCHES = 0
        for i in range(SSHARD["steps"]):
            pos = P + i
            t1, c1, lg1 = _stepped(step, model, c1, t1, pos)
            posd = sharding.from_replica(torch.tensor(pos, device=dev), mesh,
                                         pls["pos"])
            census = sharding.CollectiveCensus(keep=True)
            held = {sharding.local(t).untyped_storage().data_ptr()
                    for _, t in _cache_leaves(c2)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with census:
                t2, c2, lg2 = _stepped(step, sharded, c2, t2, posd)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            held |= {sharding.local(t).untyped_storage().data_ptr()
                     for _, t in _cache_leaves(c2)}
            moved = sum(t.untyped_storage().data_ptr() in held
                        for t in census.sent)
            if not torch.equal(sharding.full(t2), t1):
                raise AssertionError(f"4o(b) {name} step {i}: tokens differ")
            lerr = rel_err(sharding.full(lg2), lg1)
            cerr = max(
                float((sharding.local(t).double() - sharding.slab(
                    w, mesh, t.placements).double()).abs().max()
                    / w.abs().max().clamp_min(1e-30))
                for (_, t), (_, w) in zip(_cache_leaves(c2),
                                          _cache_leaves(c1)))
            gathered = census.largest.get("all_gather", 0)
            if (lerr > SSHARD_LOGIT_TOL or cerr > SSHARD_CACHE_TOL or moved
                    or gathered >= slab / 100):
                raise AssertionError(
                    f"4o(b) {name} step {i}: logits {lerr:.2e} (<= "
                    f"{SSHARD_LOGIT_TOL}), cache {cerr:.2e} (<= "
                    f"{SSHARD_CACHE_TOL}), {moved} cache slabs sent, largest "
                    f"all_gather {gathered} B of a {slab} B slab")
            rows.append({"logit_err": lerr, "cache_err": cerr, "ms": ms,
                         "counts": dict(census.counts),
                         "bytes": dict(census.bytes),
                         "largest": dict(census.largest)})
        launches = (flash_ops.LAUNCHES, topo_ops.LAUNCHES)
    return {"B": B, "S": S, "layers": cfg.num_layers, "steps": rows,
            "cache_slab_bytes": slab, "cache_bytes": whole,
            "placements": {n: [repr(p) for p in pl]
                           for n, pl in _cache_leaves(pls["cache"])},
            "token_placements": [repr(p) for p in pls["token"]],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches": launches}


def _sshard_rank(a) -> dict:
    """4o(b) and 5m on one of 4 gloo ranks sharing the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    dev = _shard_setup()
    mesh = M.make_local_mesh(*SSHARD["mesh"])
    out = {"rank": dist.get_rank()}
    for name in SSHARD_CASES:
        out[name] = _sshard_case(name, mesh, dev)
        torch.cuda.empty_cache()
    return out


def phase_serve_shard(card, device) -> dict:
    """Slice 18 (path (v)): `make_serve_step` on DTensors, one gloo group of
    4 processes sharing the card on a (2, 2) mesh (4o(b), every check in
    the ranks); 5m prints each rank's step times, the cache slab against
    one device's cache, peak memory and the collectives by kind and
    bytes."""
    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    ranks = M.run_local(_sshard_rank, SSHARD["ranks"], ({},), backend="gloo",
                        timeout=SSHARD["timeout"])
    wall = time.perf_counter() - t0
    for r in ranks:
        for name in SSHARD_CASES:
            c = r[name]
            steps_ = c["steps"]
            ms = sorted(x["ms"] for x in steps_)
            print(f"[4o(b) gloo rank {r['rank']}/4] {name}: Llama-3.2-1B "
                  f"full width, {c['layers']} layers, float32, B={c['B']}, "
                  f"S={c['S']}, {len(steps_)} steps of make_serve_step on a "
                  f"(2, 2) mesh: tokens equal, logits worst "
                  f"{max(x['logit_err'] for x in steps_):.2e} (<= "
                  f"{SSHARD_LOGIT_TOL}), cache worst "
                  f"{max(x['cache_err'] for x in steps_):.2e} (<= "
                  f"{SSHARD_CACHE_TOL}); cache placed "
                  f"{sorted(set(map(tuple, c['placements'].values())))}, "
                  f"token {c['token_placements']}; B5/B2 launches in the "
                  f"sharded steps {c['kernel_launches']}", flush=True)
            print(f"[5m 4o(b) {PSHARD_LABEL}] rank {r['rank']} {name}: "
                  f"decode step {ms[len(ms) // 2]:.3f} ms median (min "
                  f"{ms[0]:.3f}, max {ms[-1]:.3f}; host clock to "
                  f"synchronize), cache slab {c['cache_slab_bytes']} B of "
                  f"{c['cache_bytes']} B on one device, peak "
                  f"{c['peak_bytes'] / 2**30:.2f} GiB (this process, both "
                  f"models); collectives of one step "
                  f"{steps_[-1]['counts']}, bytes {steps_[-1]['bytes']}, "
                  f"largest {steps_[-1]['largest']} | {card}", flush=True)
    print(f"[slice 18] 4o(b) gloo run {wall:.1f} s (process start-up "
          "included); no time here is a multi-GPU time", flush=True)
    return {"serve_shard": ranks, "serve_shard_s": wall}


# ----------------------------------------------------------------------------
# slice 19: the reference's example entry points
# ----------------------------------------------------------------------------

# the training example's steps, cut from its default 300 for the script's
# time (its two variants train 2 x 300 steps otherwise)
EXAMPLES = {"train_steps": 30, "rel_tol": EXACT_TOL,
            # D&D's sizes (TU Dortmund: 284.3 vertices a graph on average)
            # at 300 of its 1,178 graphs
            "graph_classification": ["--backend", "torch,cuda",
                                     "--n-per-class", "100",
                                     "--size-range", "30-540"],
            "reps": 10}


def phase_examples(card) -> dict:
    """Slice 19: each module of `repro_torch.examples` through its `main`
    on the card, as `python -m repro_torch.examples.<name>` runs it. B1
    counted from 0 around the quickstart (one launch per cross bucket of
    its "cuda" Integrator), B2 around the training example (one a layer a
    forward, and one a layer in the remat's recompute, in the topo
    variant). Returns the record; raises on a failed check."""
    import torch

    from repro_torch.examples import (mesh_interpolation, quickstart,
                                      serve_lm, train_topological_lm)
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops

    rec, secs = {}, {}
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    q = quickstart.main([])
    secs["quickstart"] = time.perf_counter() - t0
    errs = [q["host_rel_err"], q["fastmult_rel_err"]] + [
        b["rel_err"] for b in q["backends"].values()]
    buckets = q["backends"]["cuda"]["cross_buckets"]
    if not (max(errs) <= EXAMPLES["rel_tol"] and ops.LAUNCHES == buckets
            and q["edge_grad_finite"] and q["edge_grad_l1"] > 0):
        raise AssertionError(f"[examples] quickstart: rel errs {errs} (<= "
                             f"{EXAMPLES['rel_tol']}), {ops.LAUNCHES} B1 "
                             f"launches for {buckets} cross buckets, edge "
                             f"grad |g|_1 {q['edge_grad_l1']}")
    rec["quickstart"] = dict(q, launches=ops.LAUNCHES)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    m = mesh_interpolation.main([])
    secs["mesh_interpolation"] = time.perf_counter() - t0
    if not all(0.0 < r["cosine"] <= 1.0 and r["lambda"] in (1.0, 4.0, 16.0)
               for r in m.values()):
        raise AssertionError(f"[examples] mesh_interpolation: {m}")
    rec["mesh_interpolation"] = {str(k): v for k, v in m.items()}

    t0 = time.perf_counter()
    sv = serve_lm.main([])
    secs["serve_lm"] = time.perf_counter() - t0
    if not (sv["tokens"] == 12 * sv["requests"]
            and all(e is None for e in sv["errors"])):
        raise AssertionError(f"[examples] serve_lm: {sv['tokens']} tokens "
                             f"for {sv['requests']} requests, errors "
                             f"{sv['errors']}")
    rec["serve_lm"] = {k: sv[k] for k in ("requests", "tokens", "ticks",
                                          "seconds")}
    torch.cuda.empty_cache()

    steps = EXAMPLES["train_steps"]
    topo_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    tr = train_topological_lm.main(["--topo-impl", "cuda", "--steps",
                                    str(steps)])
    secs["train_topological_lm"] = time.perf_counter() - t0
    cfg = train_topological_lm.small_lm("topo", 128, "cuda")
    want = steps * cfg.num_layers * (2 if cfg.remat else 1)
    finite = all(np.all(np.isfinite(v)) and len(v) == steps
                 for v in tr["losses"].values())
    if not (finite and topo_ops.LAUNCHES == want):
        raise AssertionError(f"[examples] train_topological_lm: losses "
                             f"finite {finite}, {topo_ops.LAUNCHES} B2 "
                             f"launches, {want} expected")
    rec["train_topological_lm"] = dict(tr, launches=topo_ops.LAUNCHES,
                                       steps=steps)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["graph_classification"] = _graph_classification(card)
    secs["graph_classification"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rec["seconds"] = secs
    for name, t in secs.items():
        print(f"[examples] {name}: {t:.1f} s | {card}", flush=True)
    print(f"[examples] quickstart: {ops.LAUNCHES} B1 launches ({buckets} "
          f"cross buckets), rel errs {max(errs):.2e} at most; training: "
          f"{topo_ops.LAUNCHES} B2 launches over {steps} steps", flush=True)
    return rec


def _graph_classification(card) -> dict:
    """Slice 20: the graph-classification example's `main` on the card at
    D&D's sizes. B1 counted from 0 around it (its "torch" route, host
    loop and BGFI launch none); the inputs of the "cuda" route's first
    `integrate` kept for B1's times at d = n_max against its plain version,
    `bmm` on a precomputed M and its bound. Returns the record; raises on a
    failed check."""
    import torch

    from repro_torch.examples import graph_classification
    from repro_torch.kernels.fdist_matvec import ops
    from repro_torch.kernels.fdist_matvec.ref import (
        f_eval, fdist_matvec_batched_ref)

    forward, seen = ops._forward, []

    def keep(x, y, v, coeffs, mode):  # the inputs only; ops counts
        seen.append((x, y, v, coeffs, mode))
        return forward(x, y, v, coeffs, mode)

    ops.LAUNCHES = 0
    ops._forward = keep
    try:
        g = graph_classification.main(EXAMPLES["graph_classification"])
    finally:
        ops._forward = forward
    launches = ops.LAUNCHES
    feats = g.pop("features")
    cuda, plain = g["backends"]["cuda"], g["backends"]["torch"]
    buckets = cuda["cross_buckets"]
    want = buckets * cuda["integrate_calls"]
    errs = {"cuda_f64": cuda["rel_err_f64"], "torch_f64": plain["rel_err_f64"],
            "cuda_vs_torch_f64": graph_classification._rel_err(
                feats["cuda_f64"], feats["torch_f64"])}
    if not (buckets >= 1 and launches == want == len(seen)
            and max(errs.values()) <= EXAMPLES["rel_tol"]
            and cuda["plan_reused"]):
        raise AssertionError(
            f"[examples] graph_classification: {buckets} cross buckets (>= 1),"
            f" {launches} B1 launches ({want} expected), rel errs {errs} (<= "
            f"{EXAMPLES['rel_tol']}), plan reused {cuda['plan_reused']}")
    g.update(launches=launches, rel_errs=errs)

    # B1 at the plan's buckets: the first integrate's inputs, d = n_max
    reps, rows = EXAMPLES["reps"], []
    for x, y, v, coeffs, mode in seen[:buckets]:
        B, a = x.shape
        b, d = v.shape[1:]
        got = ops.fdist_matvec_batched(x, y, v, coeffs, mode)
        ref = fdist_matvec_batched_ref(x, y, v, coeffs, mode)
        M = f_eval(x[:, :, None] + y[:, None, :], coeffs, mode)
        nbytes, ops_ = work(B, a, b, d, mode, coeffs.shape[0])
        b_ms, b_by = bound(nbytes, ops_)
        rows.append({
            "B": B, "a": a, "b": b, "d": d,
            "abs_err": float((got - ref).abs().max()),
            "ms": device_ms(lambda: ops.fdist_matvec_batched(
                x, y, v, coeffs, mode), reps),
            "plain_ms": device_ms(lambda: fdist_matvec_batched_ref(
                x, y, v, coeffs, mode), reps),
            "library_ms": device_ms(lambda: torch.bmm(M, v), reps),
            "bytes": nbytes, "ops": ops_, "bound_ms": b_ms, "bound_by": b_by})
        del M, got, ref
        r = rows[-1]
        print(f"[examples] graph_classification B1 bucket B={B} a={a} b={b} "
              f"d={d}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bmm {r['library_ms']:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), |kernel - plain| {r['abs_err']:.2e} | {card}",
              flush=True)
    del seen
    if not max(r["abs_err"] for r in rows) < FP32_TOL:
        raise AssertionError(f"[examples] graph_classification: B1 vs its "
                             f"plain version {rows} (< {FP32_TOL})")
    b_ms, b_by = bound(sum(r["bytes"] for r in rows),
                       sum(r["ops"] for r in rows))
    g["b1"] = {"buckets": rows, "d": rows[0]["d"],
               "ms": sum(r["ms"] for r in rows),
               "plain_ms": sum(r["plain_ms"] for r in rows),
               "library_ms": sum(r["library_ms"] for r in rows),
               "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": max(r["abs_err"] for r in rows)}
    print(f"[examples] graph_classification: {g['graphs']} graphs, "
          f"{g['vertices']} vertices, n_max {g['n_max']}; {buckets} cross "
          f"buckets, {launches} B1 launches over 2 integrates; features "
          f"(float64 reads) rel errs {errs}; float32 spectra rel errs "
          f"cuda {cuda['rel_err']:.2e}, torch {plain['rel_err']:.2e}; "
          f"accuracy cuda {cuda['acc']:.3f}±{cuda['acc_std']:.3f}, host loop "
          f"{g['host_loop']['acc']:.3f}, BGFI {g['bgfi']['acc']:.3f}; forest "
          f"steady cuda {cuda['steady_ms']:.1f} ms, torch "
          f"{plain['steady_ms']:.1f} ms, host loop "
          f"{g['host_loop']['ms']:.1f} ms, BGFI {g['bgfi']['ms']:.1f} ms; "
          f"B1 at d={g['b1']['d']}: {g['b1']['ms']:.4f} ms over {buckets} "
          f"buckets (plain {g['b1']['plain_ms']:.4f}, bmm "
          f"{g['b1']['library_ms']:.4f}, bound {b_ms:.5f} ms) | {card}",
          flush=True)
    return g


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

    _stamp("slice 2 starts")
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

    _stamp("slice 3 starts")
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

    _stamp("slice 4 starts")
    # slice 4: Falcon-Mamba-7B served through the selective scan kernel
    scan_checks, scan_served = phase_scan_kernel_vs_plain(device)
    scan_times = phase_scan_times(scan_served, info, card)
    del scan_served
    torch.cuda.empty_cache()
    # the float32 model (28 GB) is freed when its phase returns
    ssm_gate = phase_gate(
        "falcon-mamba", _ssm_cfg("cuda", "float32").replace(
            num_layers=SSM["gate_layers"]), _ssm_cfg("chunked", "float32")
        .replace(num_layers=SSM["gate_layers"]), scan_ops, device)
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
    _stamp("slice 8 starts")
    # slice 8: the Toeplitz-FFT topo impl; TopoViT-B/16 (no port kernel)
    topo_fft = phase_topo_fft(card, device)
    _stamp("4e starts")
    vit_gate = phase_vit_gate(device)
    torch.cuda.empty_cache()
    _stamp("5e starts")
    vit_serve = phase_vit_serve(card, device)
    _stamp("slice 9 starts")
    # slice 9: training. 3f the Functions' grads; 4f the float32 training
    # gates (topo at full depth, the earlier paths at 2 layers); 5f the
    # trainer, the slice's main path
    grad_rows = phase_kernel_grads(device, [b for b in buckets
                                            if b[2] == max(cfg["widths"])])
    torch.cuda.empty_cache()
    train_gates = phase_train_gates(topo_ops, scan_ops, device)
    timed = {r["case"]: r for r in grad_rows if "backward_ms" in r}
    rank16 = next(r for c, r in timed.items() if "rank16" in c)
    _stamp("5f starts")
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
    _stamp("slice 10 starts")
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
    _stamp("slice 11 starts")
    # slice 11: the Integrator facade (4i) and Fig. 4's mesh interpolation
    # (4j), the slice's main path, B1's counts from 0 around them; 5h's
    # times
    torch.cuda.empty_cache()
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_TD.update({td: 0 for td in ops.LAUNCHES_BY_TD})
    facade = phase_facade(cfg, device)
    mesh_rows = phase_mesh(device, card)
    facade_by_td = dict(ops.LAUNCHES_BY_TD)
    for d in cfg["widths"]:
        if facade_by_td[fdist_kernel.tile_width(d)] == 0:
            raise AssertionError(f"4i/4j launched no fdist_matvec kernel of "
                                 f"d-tile {d}")
    torch.cuda.empty_cache()
    facade_times = phase_facade_times(cfg, device, card)
    for k in kernels:
        for d in cfg["widths"]:
            if k["name"] == f"fdist_matvec_batched[d={d}]":
                k.update(facade_launches=facade_by_td[
                    fdist_kernel.tile_width(d)], facade_at=(
                    "4i + 4j: Integrator(..., backend='cuda') at cell (a) "
                    "(d=4, 64), the forest of cell (c), from_plan, and the "
                    "Fig. 4 meshes (d=3); launches of this d-tile"))
    if ladder.stats() != want:
        raise AssertionError(f"ladder: {ladder.stats()} after 4i-5h; they "
                             "may not reach it")
    _stamp("slice 12 starts")
    # slice 12: the DeepSeek family and the dense configs through B5 at
    # head dims (192, 128) and 256; V2-Lite and Gemma-7B served at full
    # depth are its main paths, B5's counts from 0 around each
    torch.cuda.empty_cache()
    deepseek, wide_rows = phase_deepseek(card, device)
    kernels += wide_rows
    _stamp("slice 13 starts")
    # slice 13: the hybrid, encdec and vlm families through B5's window and
    # cross modes; RecurrentGemma-2B, SeamlessM4T-medium and LLaVA-NeXT-34B
    # served at full depth are its main paths, B5's counts from 0 around
    # each
    torch.cuda.empty_cache()
    a10b, a10b_rows = phase_a10b(card, device)
    kernels += a10b_rows
    _stamp("slice 14 starts")
    # slice 14: the serving engine on cell (d)'s model at degree 1 (4k:
    # B2 counted from 0 around its "cuda" run of (a), its main path; 5i)
    torch.cuda.empty_cache()
    engine = phase_engine(card, device)
    for k in kernels:
        if k["name"] == "topo_attention_sweep[decay]":
            k.update(engine_launches=engine["engine_gates"]["batching"][
                "launches"], engine_at=(
                "4k (a): ServeEngine, 8 requests through 4 slots, "
                "float32, topo_attn_impl 'cuda'; one launch per layer per "
                "plain prefill group (16 x prefill_calls), none in decode "
                "or in a tree group"))
    _stamp("slice 15 starts")
    # slice 15: multi-rank FTFI (cell (t)); B1 counted from 0 inside each
    # rank around 4l(a) and 4l(b), the slice's main path, B1/B2 around each
    # kernel face of 4l(c)
    torch.cuda.empty_cache()
    shard = phase_shard(cfg, device, card)
    shard_kernel_rows(kernels, shard, cfg["widths"])
    # slice 16: the LM's parameter sharding (path (u)); B2, B5 and B6
    # counted from 0 inside each rank around each gate of 4m, its main path
    torch.cuda.empty_cache()
    _stamp("slice 16 starts")
    pshard = phase_param_shard(card, device)
    pshard_kernel_rows(kernels, pshard)
    _stamp("slice 16 ends")
    # slice 17: the cost count on the card (4n, a gate: the same flops on
    # the card and on the plain route), the roofline, the MFU and one dry
    # run (5l)
    torch.cuda.empty_cache()
    _stamp("slice 17 starts")
    roof = phase_roofline(card, device)
    _stamp("slice 17 ends")
    # slice 18: the decode step on DTensors (4o(b), no kernel launches:
    # decode attends with the plain softmax over the cache); 4o(a) ran
    # inside slice 15's gloo run, its B1 counted from 0 around its call
    torch.cuda.empty_cache()
    _stamp("slice 18 starts")
    serve_shard = phase_serve_shard(card, device)
    _stamp("slice 18 ends")
    # slice 19: the reference's example entry points on the card (B1
    # counted from 0 around the quickstart, B2 around the training)
    torch.cuda.empty_cache()
    _stamp("slice 19 starts")
    examples = phase_examples(card)
    _stamp("slice 19 ends")
    for k in kernels:
        if k["name"].startswith("fdist_matvec_batched"):
            gc = examples["graph_classification"]
            k.update(examples_launches=examples["quickstart"]["launches"]
                     + gc["launches"], examples_at=(
                         "the quickstart example's step 5: Integrator(..., "
                         "backend='cuda') at n = 1,500, d = 8 (d-tile 16), "
                         "and graph_classification --backend torch,cuda at "
                         f"D&D's sizes: {gc['graphs']} MSTs in one forest "
                         f"plan, d = n_max = {gc['n_max']} (d-tile 64), 2 "
                         "integrates; one launch per cross bucket; all "
                         "d-tiles"))
            if k["name"] == "fdist_matvec_batched[d=64]":
                k["examples_b1"] = {key: gc["b1"][key] for key in (
                    "d", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")}
        if k["name"] == "topo_attention_sweep[decay]":
            k.update(examples_launches=examples["train_topological_lm"][
                "launches"], examples_at=(
                f"train_topological_lm --topo-impl cuda, "
                f"{EXAMPLES['train_steps']} steps of the 4-layer topo LM "
                "(decay mode): a launch a layer a forward and a layer in "
                "the remat's recompute"))
    record = {**deepseek, **a10b, **engine, **shard, **pshard, **serve_shard,
              "roofline": roof, "examples": examples,
              "device": info, "build": build, "main_path": rows_a + rows_b,
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
              "facade": facade, "mesh": mesh_rows,
              "facade_times": facade_times, "kernels": kernels}
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
    _time_phases()
    run(FULL, torch.device("cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
