"""Batched serving example: continuous-batching engine over a small LM.

    python -m repro_torch.examples.serve_lm [--device cpu]

The reference's examples/serve_lm.py on the port: the smoke Qwen2-1.5B in
float32, random weights from seed 0, 10 requests of 6 prompt tokens
through 4 slots."""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen2_1_5b").replace(dtype="float32")
    params = api.init_params(cfg, 0, device=dev)
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=96, device=dev)

    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=6).tolist(),
                max_new_tokens=12)
        for i in range(10)
    ]
    for r in requests:
        engine.submit(r)

    t0 = time.time()
    ticks = engine.run()
    dt = time.time() - t0
    tok = sum(len(r.out) for r in requests)
    print(f"served {len(requests)} requests, {tok} tokens, {ticks} ticks, "
          f"{dt:.2f}s -> {tok/dt:.1f} tok/s (batched decode)")
    for r in requests[:3]:
        print(f"  req {r.rid}: prompt={r.prompt} -> out={r.out}")
    return {"requests": len(requests), "tokens": tok, "ticks": ticks,
            "seconds": dt, "vocab_size": cfg.vocab_size,
            "outs": [list(r.out) for r in requests],
            "errors": [r.error for r in requests]}


if __name__ == "__main__":
    main()
