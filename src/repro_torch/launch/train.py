"""Training CLI:  PYTHONPATH=src python -m repro_torch.launch.train
   --arch llama3_2_1b [--smoke] [--steps N] [--batch B] [--seq L]
   [--variant topo] [--device cpu] ...

The reference's flags. Without --smoke the full config trains at its own
dtype on the CUDA card; --smoke takes the reduced config in float32, and
--device cpu runs on the CPU (the default is the card, raising without
one). --variant sets the attention variant with topo_dist_scale = 1/seq.
Attention (or the scan) runs on the kernels: topo_attn_impl "cuda" for
topo, attn_impl "cuda" otherwise (on the CPU, their plain versions).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, run_training


def config_from_args(args):
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    overrides = {"dtype": "float32"} if args.smoke else {}
    if args.variant:
        overrides["attention_variant"] = args.variant
        overrides["topo_dist_scale"] = 1.0 / args.seq
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
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--variant", default=None,
                    choices=[None, "full", "performer", "topo"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = config_from_args(args)
    loop = TrainLoopConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        microbatches=args.microbatches, ckpt_every=args.ckpt_every,
        seed=args.seed, compress_grads=args.compress_grads)
    if args.ckpt_dir:
        loop.ckpt_dir = args.ckpt_dir
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 20))
    res = run_training(cfg, loop, opt, device=args.device)
    print(f"final loss: {res['losses'][-1]:.4f} "
          f"(first: {res['losses'][0]:.4f}); "
          f"stragglers flagged: {len(res['straggler_events'])}")
    return res


if __name__ == "__main__":
    main()
