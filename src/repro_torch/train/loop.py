"""Fault-tolerant training loop: the reference's `train/loop.py` over a
`DecoderLM` on the card (or the CPU when asked).

  - deterministic data keyed by global step (`data.synthetic`), so a
    restart resumes bit-identically;
  - atomic checkpoints every `ckpt_every` steps, keep-k, auto-resume from
    the latest (`checkpoint.manager`);
  - straggler watchdog: EMA step time, outliers logged;
  - optional int8 error-feedback gradient compression (`optim.compress`);
  - microbatching: the batch reshaped as the reference reshapes it, the
    mean of the microbatches' losses and grads;
  - crash injection hook (`fail_at_step`) for the restart test.

The step runs eagerly (the reference's `jax.jit` is not copied, and there
is no `torch.compile`): autograd through `api.loss_fn`, whose kernels'
backwards are their plain versions' VJPs, then `optim.adamw`, in place.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import compress_grads, compressor_init


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    microbatches: int = 1
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    fail_at_step: int | None = None  # crash injection (tests)
    compress_grads: bool = False
    straggler_factor: float = 2.0


class StragglerWatchdog:
    def __init__(self, factor: float = 2.0, warmup: int = 5):
        self.ema = None
        self.factor = factor
        self.warmup = warmup
        self.count = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float):
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_slow = (self.count > self.warmup) and dt > self.factor * self.ema
        if is_slow:
            self.events.append((step, dt, self.ema))
        # slow steps should not poison the baseline
        alpha = 0.1 if not is_slow else 0.01
        self.ema = (1 - alpha) * self.ema + alpha * dt
        return is_slow


def make_accumulating_step(cfg, opt_cfg: AdamWConfig, microbatches: int,
                           use_compression: bool, device=None):
    """step(model, opt_state, comp_state, batch) -> (opt_state, comp_state,
    metrics); the model's parameters are updated in place. With
    microbatches > 1, each entry of batch (the tokens, and the vlm's or
    encdec's embeddings) is (microbatches, B / microbatches, ...), and the
    loss and each grad are the mean over the microbatches."""

    def step(model, opt_state, comp_state, batch):
        params = dict(model.named_parameters())

        def value_and_grad(mb):
            loss, _ = api.loss_fn(cfg, model, mb, device)
            return loss.detach(), torch.autograd.grad(loss,
                                                      list(params.values()))

        if microbatches == 1:
            loss, grads = value_and_grad(batch)
        else:
            losses, sums = [], None
            for i in range(microbatches):
                lmb, gmb = value_and_grad({k: t[i] for k, t in batch.items()})
                losses.append(lmb)
                sums = ([g.float() for g in gmb] if sums is None
                        else [s.add_(g.float()) for s, g in zip(sums, gmb)])
                del gmb
            loss = torch.stack(losses).mean()
            grads = [(s / microbatches).to(p.dtype)
                     for s, p in zip(sums, params.values())]
            del sums
        grads = dict(zip(params, grads))
        if use_compression:
            grads, comp_state = compress_grads(grads, comp_state)
        opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return opt_state, comp_state, dict(metrics, loss=loss)

    return step


def run_training(model_cfg, loop_cfg: TrainLoopConfig,
                 opt_cfg: AdamWConfig | None = None, verbose: bool = True,
                 device=None):
    """Train `model_cfg` from `api.init_params(model_cfg, loop_cfg.seed)`
    on the synthetic stream for loop_cfg.steps steps, resuming from the
    latest checkpoint in loop_cfg.ckpt_dir.

    Returns {"params": the model, "opt_state", "losses" (np.ndarray of the
    steps run), "step_seconds" (host clock, each ending in the loss's read
    to the host), "ckpt_seconds" (each save), "straggler_events",
    "final_step"}."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop_cfg.steps, warmup_steps=max(
        1, loop_cfg.steps // 20))
    model = api.init_params(model_cfg, loop_cfg.seed, device=dev)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    comp_state = (compressor_init(params) if loop_cfg.compress_grads
                  else None)

    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    start_step = 0
    restored = mgr.restore(model, opt_state)
    if restored is not None:
        start_step = restored["step"]
        if verbose:
            print(f"[resume] restored checkpoint at step {start_step}")

    stream = SyntheticLMStream(
        model_cfg.vocab_size, loop_cfg.batch_size, loop_cfg.seq_len,
        seed=loop_cfg.seed,
        vlm_prefix=(model_cfg.num_prefix_embeddings
                    if model_cfg.family == "vlm" else 0),
        encdec_src=(model_cfg.max_source_len if model_cfg.is_encdec else 0))
    step_fn = make_accumulating_step(model_cfg, opt_cfg,
                                     loop_cfg.microbatches,
                                     loop_cfg.compress_grads, dev)

    watchdog = StragglerWatchdog(loop_cfg.straggler_factor)
    losses, step_s, ckpt_s = [], [], []
    for step in range(start_step, loop_cfg.steps):
        if loop_cfg.fail_at_step is not None and step == loop_cfg.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = {k: torch.as_tensor(a, device=dev)
                 for k, a in stream.batch_at(step).items()}
        batch["tokens"] = batch["tokens"].long()
        if loop_cfg.microbatches > 1:
            batch = {k: t.reshape((loop_cfg.microbatches,
                                   t.shape[0] // loop_cfg.microbatches)
                                  + tuple(t.shape[1:]))
                     for k, t in batch.items()}
        t0 = time.perf_counter()
        opt_state, comp_state, metrics = step_fn(model, opt_state, comp_state,
                                                 batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = watchdog.observe(step, dt)
        losses.append(loss)
        step_s.append(dt)
        if verbose and (step % loop_cfg.log_every == 0 or slow):
            tag = " [STRAGGLER]" if slow else ""
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms){tag}", flush=True)
        if (step + 1) % loop_cfg.ckpt_every == 0 or step + 1 == loop_cfg.steps:
            t0 = time.perf_counter()
            mgr.save(step + 1, model, opt_state)
            ckpt_s.append(time.perf_counter() - t0)
    return {"params": model, "opt_state": opt_state,
            "losses": np.array(losses), "step_seconds": step_s,
            "ckpt_seconds": ckpt_s, "straggler_events": watchdog.events,
            "final_step": loop_cfg.steps}
