"""Fault-injection harness for the serving/robustness stack.

Production code declares *fault points* — named sites where a registered
handler may raise (`fire`) or rewrite a value in flight (`transform`).
With no handler registered both are free no-ops (one dict lookup), so the
hooks stay in the hot path permanently; tests arm them via the `injected`
context manager to prove each fault class either recovers or degrades to
the host-exact output (tests/test_serving_faults.py).

The reference's `repro.testing.faults`, with torch in place of jax. Fault
points currently wired in the port:

  ladder.<level>        fired before the degradation ladder runs backend
                        <level> ("cuda" | "torch" | "host") — raising here
                        simulates a kernel build/launch failure
  ladder.out.<level>    transforms that level's output field — returning
                        NaNs simulates a numerically-broken kernel

(The reference's serve.* points come with the serving engine, ROADMAP
A11.)

Helpers below build the common fault shapes: `raise_at_tick`,
`nan_slot_at_tick`, `corrupt_file` (bit flips / truncation for artifact
tests) and `flip_index` (out-of-bounds index corruption on a PlanSpec).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np

_active: dict[str, Callable] = {}


def inject(point: str, handler: Callable) -> None:
    """Arm `handler` at `point`. fire-handlers take **ctx and may raise;
    transform-handlers take (value, **ctx) and return the replacement."""
    _active[point] = handler


def clear(point: str | None = None) -> None:
    if point is None:
        _active.clear()
    else:
        _active.pop(point, None)


@contextlib.contextmanager
def injected(point: str, handler: Callable):
    """Arm a handler for the duration of a with-block (always disarmed)."""
    inject(point, handler)
    try:
        yield
    finally:
        clear(point)


def active(point: str) -> bool:
    return point in _active


def fire(point: str, **ctx) -> None:
    """Invoke the handler at `point` (no-op when unarmed). The handler may
    raise — that IS the injected fault."""
    handler = _active.get(point)
    if handler is not None:
        handler(**ctx)


def transform(point: str, value, **ctx):
    """Pass `value` through the handler at `point` (identity when unarmed)."""
    handler = _active.get(point)
    return value if handler is None else handler(value, **ctx)


# ----------------------------------------------------------------------------
# handler factories / corruption helpers
# ----------------------------------------------------------------------------


def raise_at_tick(k: int, exc: type = RuntimeError,
                  msg: str = "injected fault") -> Callable:
    """fire-handler: raise `exc` exactly when ctx tick == k."""

    def handler(**ctx):
        if ctx.get("tick") == k:
            raise exc(f"{msg} (tick {k})")

    return handler


def always_raise(exc: type = RuntimeError,
                 msg: str = "injected fault") -> Callable:
    def handler(**ctx):
        raise exc(msg)

    return handler


def nan_output() -> Callable:
    """transform-handler: replace the whole output with NaNs (broken
    kernel writing garbage)."""

    def handler(value, **ctx):
        import torch

        if isinstance(value, torch.Tensor):
            return torch.full_like(value, float("nan"))
        return np.full_like(value, np.nan)

    return handler


def nan_slot_at_tick(slot: int, k: int) -> Callable:
    """transform-handler for serve.logits: NaN one slot's logits row at
    tick k (per-request corruption that must not kill the batch)."""

    def handler(value, *, tick=None, **ctx):
        if tick == k:
            value = np.array(value, copy=True)
            value[slot] = np.nan
        return value

    return handler


def corrupt_file(path, *, flip_bytes: int = 0, truncate_to: int | None = None,
                 seed: int = 0) -> None:
    """Corrupt an artifact on disk: XOR-flip `flip_bytes` random bytes
    and/or truncate the file to `truncate_to` bytes."""
    with open(path, "rb") as fh:
        data = bytearray(fh.read())
    if truncate_to is not None:
        data = data[:truncate_to]
    if flip_bytes and data:
        rng = np.random.default_rng(seed)
        # skip the first 512 bytes: flipping the zip local-file header makes
        # every corruption a trivial "not an npz" parse error; flipping the
        # payload exercises the semantic validation path
        lo = min(512, len(data) - 1)
        for pos in rng.integers(lo, len(data), size=flip_bytes):
            data[pos] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))


def flip_index(spec, field: str = "src_gather", entry: int = 0,
               value: int | None = None):
    """A copy of `spec` with one index entry flipped out of bounds (default:
    way past the vertex space) — the exact corruption class the plan guard
    exists to catch before the fused gather dereferences it."""
    arr = np.array(getattr(spec, field), copy=True)
    arr[entry] = (2 ** 30) if value is None else value
    return dataclasses.replace(spec, **{field: arr})
