"""End-to-end driver: train a small LM with the paper's Topological
Performer attention for a few hundred steps and compare against the
unmasked Performer baseline (the paper's Table-1 comparison, LM-scale).

    python -m repro_torch.examples.train_topological_lm [--steps 300] \\
        [--topo-impl cuda] [--device cpu]

The synthetic stream contains copy spans, so attention that can express
distance structure (the 3-parameter topological mask) has signal to win on.

The reference's examples/train_topological_lm.py on the port. `--topo-impl`
takes the port's names: "cuda" (the reference's "pallas": the topo sweep
kernel on the card, its plain version on the CPU), "fft" and "ref". Each
variant checkpoints into a directory of its own under `--ckpt-dir`
(default: a temporary directory, removed at the end), so a run starts
from step 0."""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, run_training


def small_lm(variant: str, seq_len: int, topo_impl: str = "fft",
             topo_degree: int = 1) -> ModelConfig:
    return ModelConfig(
        name=f"lm-{variant}", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=1024, vocab_size=512,
        attention_variant=variant, performer_phi="relu", topo_g="exp",
        topo_degree=topo_degree, topo_synced=True,
        topo_dist_scale=1.0 / seq_len, topo_attn_impl=topo_impl,
        dtype="float32", tie_embeddings=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--topo-impl", default="fft",
                    choices=("ref", "fft", "cuda"),
                    help="sequence-mask impl for the topo variant "
                         "(cfg.topo_attn_impl)")
    ap.add_argument("--topo-degree", type=int, default=1,
                    help="mask polynomial degree (2+ exercises the general "
                         "non-separable path)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: a temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results = {}
    with tempfile.TemporaryDirectory(prefix="topolm_") as tmp:
        root = args.ckpt_dir or tmp
        for variant in ("performer", "topo"):
            cfg = small_lm(variant, args.seq, args.topo_impl,
                           args.topo_degree)
            loop = TrainLoopConfig(
                steps=args.steps, batch_size=args.batch, seq_len=args.seq,
                ckpt_dir=os.path.join(root, f"topolm_{variant}"),
                ckpt_every=args.steps, log_every=max(1, args.steps // 6),
                seed=0)
            opt = AdamWConfig(lr=1e-3, total_steps=args.steps,
                              warmup_steps=args.steps // 10)
            print(f"\n=== training variant={variant} "
                  f"({'3 extra mask params/layer' if variant == 'topo' else 'no mask'}) ===")
            res = run_training(cfg, loop, opt, device=dev)
            results[variant] = res["losses"]

    tail = max(5, args.steps // 10)
    base = float(np.mean(results["performer"][-tail:]))
    topo = float(np.mean(results["topo"][-tail:]))
    print("\n=== summary (mean loss over final steps) ===")
    print(f"performer (unmasked): {base:.4f}")
    print(f"topological (masked): {topo:.4f}")
    print(f"delta: {base - topo:+.4f} "
          f"({'topological mask wins' if topo < base else 'baseline wins'})")
    return {"losses": {k: v.tolist() for k, v in results.items()},
            "performer": base, "topo": topo, "delta": base - topo}


if __name__ == "__main__":
    main()
