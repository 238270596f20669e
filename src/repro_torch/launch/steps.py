"""Step functions over a model: the reference's `launch/steps.py`.

Each is a plain function of the module and works alike on plain tensors
(one device) and on DTensors (`launch.sharding.distribute_params`): on a
sharded model the forward and its backward run in
`launch.sharding.dtensor_scope`, and AdamW reduces each grad to its
parameter's placements before the update. The reference's `jax.jit` is not
copied: the step runs eagerly.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def make_train_step(cfg, opt_cfg: AdamWConfig, device=None):
    """train_step(model, opt_state, batch) -> (model, opt_state, metrics):
    the loss and grads of `api.loss_fn`, then AdamW in place. metrics:
    "loss" (a plain tensor, whole on every rank of a sharded model),
    `loss_fn`'s metrics, "grad_norm" and "lr"."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        with api.sharded_scope(model):
            loss, metrics = api.loss_fn(cfg, model, batch, device)
            grads = torch.autograd.grad(loss, list(params.values()))
            loss = sharding.full(loss)
        opt_state, opt_metrics = adamw_update(dict(zip(params, grads)),
                                              opt_state, params, opt_cfg)
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg, device=None):
    """prefill_step(model, batch) -> last-position logits (B, 1, V)."""
    def prefill_step(model, batch):
        with api.sharded_scope(model):
            return api.prefill_fn(cfg, model, batch, device)

    return prefill_step


def make_serve_step(cfg, seq_len: int, device=None):
    """serve_step(model, cache, token, pos) -> (the greedy next token
    (B, 1) int32, new_cache). On a sharded model the cache, token and pos
    are DTensors placed by `launch.specs.cache_shardings` /
    `batch_shardings` (or plain: the token is put on the batch axes, pos
    replicated); the token and the cache come back in the same placements.
    No collective moves the cache (`sharding.cache_face`), and the greedy
    pick meets each rank's vocab slab's best over the model axis
    (`sharding.argmax_last`) without gathering the logits."""
    def serve_step(model, cache, token, pos):
        logits, cache = api.decode_fn(cfg, model, cache, token, pos,
                                      seq_len, device)
        new_token = sharding.argmax_last(logits[:, -1]).to(torch.int32)
        return new_token[:, None], cache

    return serve_step
