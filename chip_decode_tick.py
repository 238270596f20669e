#!/usr/bin/env python3
"""The served decode step and the serving engine's decode tick of the
full-width Llama-3.2-1B on a CUDA card, for the `repro_torch` that
PYTHONPATH finds, so that two trees can be timed in one call.

Run from the root of a checkout, on a machine with one CUDA card:

    PYTHONPATH=<tree>/src python3 chip_decode_tick.py --label <name> \
        [--out results.json]

For the topological variant at degree 1 (cell (d) of PERF.md) and the
dense one (cell (e)), both in bf16, with random weights from a seed, it
fills a cache of 4 rows by one `api.prefill_into_cache` of `PROMPT`
tokens each and then reports:

  * `launch.steps.make_serve_step`: the host ms of each of `STEPS` calls
    (after `WARM` more), each from its start to `torch.cuda.synchronize`;
  * `serve.engine.ServeEngine`: 4 requests of `PROMPT` tokens over 4
    slots, `NEW` new tokens each; the ms of each decode call
    (`ServeEngine._decode`, to `torch.cuda.synchronize`) after the first
    `WARM`, and `stats()["decode_s"]` over the decode ticks.

The prefills run the plain paths ("torch" / "chunked"), so that nothing
is compiled: the decode step is the same on every `attn_impl`. Nothing
here is a gate; it measures, and prints one JSON line per variant and
the card's name and power limit. It imports neither jax nor the
reference package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

PROMPT, STEPS, WARM, NEW, SEED = 1024, 24, 4, 28, 0
SLOTS, MAX_LEN = 4, 1088


def _cfg(variant: str):
    from repro_torch.configs.base import get_config

    if variant == "topo":
        return get_config("llama3_2_1b", attention_variant="topo",
                          topo_g="exp", topo_degree=1, topo_attn_impl="torch",
                          topo_dist_scale=1.0 / MAX_LEN, dtype="bfloat16")
    return get_config("llama3_2_1b", attention_variant="full",
                      attn_impl="chunked", dtype="bfloat16")


def _stats(ms) -> dict:
    ms = sorted(ms)
    return {"median_ms": ms[len(ms) // 2], "min_ms": ms[0], "max_ms": ms[-1],
            "n": len(ms)}


def _time_variant(variant: str, dev) -> dict:
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = _cfg(variant)
    model = api.init_params(cfg, SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT))
    cache = api.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
    logits, cache = api.prefill_into_cache(
        cfg, model, cache, torch.as_tensor(prompts, device=dev),
        torch.full((SLOTS,), PROMPT, device=dev), MAX_LEN, device=dev)
    token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    step = steps.make_serve_step(cfg, MAX_LEN, device=dev)
    step_ms = []
    for i in range(WARM + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        token, cache = step(model, cache, token, PROMPT + i)
        torch.cuda.synchronize()
        if i >= WARM:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    del cache
    torch.cuda.empty_cache()

    eng = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                      device=dev)
    tick_ms, real = [], eng._decode

    def timed(*args):
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._decode = timed
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.tolist(), max_new_tokens=NEW))
    eng.run()
    st = eng.stats()
    return {"variant": variant, "B": SLOTS, "S": MAX_LEN, "prompt": PROMPT,
            "serve_step": _stats(step_ms),
            "engine_decode": _stats(tick_ms[WARM:]),
            "engine_decode_calls": len(tick_ms),
            "engine_decode_s_per_call": st["decode_s"] / max(len(tick_ms),
                                                             1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    rows = []
    for variant in ("topo", "full"):
        rec = dict(_time_variant(variant, dev), label=a.label, card=card)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
