"""Serving CLI:  PYTHONPATH=src python -m repro_torch.launch.serve
   --arch llama3_2_1b [--smoke] [--variant topo] [--requests 8]
   [--slots 4] [--max-new 16] [--max-len 128] [--plan plan.npz]
   [--prefill-mode fused|replay] [--device cpu]

The reference's flags. Without --smoke the full config serves at its own
dtype on the CUDA card; --smoke takes the reduced config in float32, and
--device cpu runs on the CPU (the default is the card, raising without
one). --variant sets the attention variant with topo_dist_scale =
1/max_len. Attention (or the scan) runs on the kernels: topo_attn_impl
"cuda" for topo, attn_impl "cuda" otherwise (on the CPU, their plain
versions). Prompts are 8 seeded tokens each, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def config_from_args(args):
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    overrides = {"dtype": "float32"} if args.smoke else {}
    if args.variant:
        overrides["attention_variant"] = args.variant
        overrides["topo_dist_scale"] = 1.0 / args.max_len
    variant = overrides.get("attention_variant", cfg.attention_variant)
    if cfg.family == "dense" and variant == "topo":
        overrides["topo_attn_impl"] = "cuda"
    else:
        overrides["attn_impl"] = "cuda"
    return cfg.replace(**overrides)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--variant", default=None,
                    choices=[None, "full", "performer", "topo"])
    ap.add_argument("--plan", default=None,
                    help="ftfi.save_plan artifact (.npz) to serve with: "
                         "loads the integration plan instead of rebuilding "
                         "the IT at startup")
    ap.add_argument("--prefill-mode", choices=("fused", "replay"),
                    default="fused",
                    help="fused: one prefill-into-cache call per admission "
                         "group (mid-wave admission); replay: token-by-"
                         "token prompt replay through decode")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = config_from_args(args)
    params = api.init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_len=args.max_len, plan=args.plan,
                      prefill_mode=args.prefill_mode, device=args.device)
    print(f"serving {args.arch} | slots={args.slots} max_len={args.max_len} "
          f"variant={cfg.attention_variant} prefill={eng.prefill_mode} "
          f"device={eng.device}")
    print(eng.plan_banner())
    rng = np.random.default_rng(0)
    reqs = []
    for r in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=8).tolist()
        reqs.append(Request(rid=r, prompt=prompt,
                            max_new_tokens=args.max_new))
        eng.submit(reqs[-1])
    t0 = time.time()
    ticks = eng.run()
    dt = time.time() - t0
    # what was generated (evicted retries, truncation and failures all mean
    # requests * max_new would over-report)
    st = eng.stats()
    gen_tokens = sum(len(r.out) for r in reqs)
    print(f"served {st['completed']}/{args.requests} requests "
          f"({st['failed']} failed, {st['truncated']} truncated) / "
          f"{gen_tokens} generated tokens in {ticks} ticks, {dt:.2f}s "
          f"({gen_tokens / dt:.1f} tok/s generated; "
          f"prefill {st['prefill_tokens'] / dt:.1f} tok/s, "
          f"decode {st['decode_tokens'] / dt:.1f} tok/s)")
    print(eng.health_banner())
    return eng, reqs


if __name__ == "__main__":
    main()
