"""The backward every kernel wrapper's `torch.autograd.Function` shares.

The reference runs each Pallas kernel as the forward only and
differentiates its XLA twin in the backward (`_fused` / `_fused_bwd` in its
`kernels/topo_linear_attention/ops.py`). The port does the same: the
backward is the VJP of the plain version, recomputed from the inputs the
forward saved, so no backward kernel exists.
"""
from __future__ import annotations

import torch


def plain_vjp(plain_fn, saved, needs, grads):
    """Grads of `plain_fn(*saved)` under the upstream `grads` (a tensor, or
    a tuple matching plain_fn's outputs). Returns one entry per entry of
    `saved`: its grad where `needs` says so, else None (also for a None
    input)."""
    ins = [None if t is None else t.detach().requires_grad_(bool(need))
           for t, need in zip(saved, needs)]
    wanted = [t for t in ins if t is not None and t.requires_grad]
    if not wanted:
        return (None,) * len(ins)
    with torch.enable_grad():
        got = iter(torch.autograd.grad(plain_fn(*ins), wanted, grads))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in ins)
