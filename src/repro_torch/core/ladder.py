"""Backend degradation ladder: supervised fallback `cuda -> torch -> host`.

The paper's headline is that FTFIs are *exact* — every backend computes the
same M_f X — which makes the slower backends free correctness fallbacks:
a CUDA kernel that fails to build or launch, or returns non-finite
garbage, should demote to the next rung with a structured warning, never
tear down the request it was serving.

Rungs, from fastest to most conservative:

  cuda     the executor with the fdist_matvec kernel (on CPU tensors its
           wrapper runs the plain version)
  torch    the same executor with the plain PyTorch engines
  host     the "torch" executor on a CPU copy of params and X, the result
           moved back to X's device: op by op on the host, no kernel and
           no device — the terminal rung shares no failure domain with
           the card (the reference's eager host rung)

Two failure classes trigger demotion:
  * any exception out of a rung (kernel build/launch failure) — counted in
    `stats()['errors']`;
  * a non-finite output, caught by one `torch.isfinite(Y).all()` read on
    the host — counted in `stats()['nonfinite']`.

The ladder demotes only on CPU tensors (`device="cpu"`), where the "cuda"
rung is B1's plain twin. On the card it holds the rung it was given: a
rung that raises or returns a non-finite output there raises
`DeviceRungError` (counted in the same stats), so no call on card tensors
is ever served by the plain engines or the CPU in the kernel's place.

Demotion is sticky per closure (`ResilientFastMult`) so a broken rung is
not retried every call, and can be made global (`block_backend`) so
`effective_backend` stops selecting a rung that already failed a probe;
on the card a blocked rung is refused, not skipped, and
`backend="auto"` resolves by size alone (`auto_backend`). The terminal
rung never demotes: a non-finite output there is returned with a warning
(garbage input, not a backend fault). Demotions are loud: a
`BackendDemotionWarning` and a counter, every time.

The reference's `repro.core.ladder`, rung for rung (its "pallas" is
"cuda" here, its "plan" is "torch").
"""
from __future__ import annotations

import os
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.testing import faults

LADDER = ("cuda", "torch", "host")

# backend="auto" size threshold: from this vertex count up "auto" picks the
# kernel rung, below it the plain engines. Measured on an NVIDIA H100 80GB
# HBM3 at 700 W (`chip_smoke.py` phase 5g: `apply` host ms, "cuda" against
# "torch", Exponential(-0.5), synthetic-graph MSTs at leaf 64, n = 100 to
# 10,000, d = 4 and 64, two runs): "cuda" was the faster at every n from
# 250 up at both widths in both runs (one kernel a bucket against the
# rank-1 engine's several launches, both host-bound); at n = 100, d = 64
# the runs disagreed ("torch" 0.526 against 0.714 ms in one, 1.199
# against 1.049 ms in the other). The reference's
# `FTFI_AUTO_PALLAS_MIN_N = 4000` was measured on a CPU and says nothing
# about the card.
AUTO_CUDA_MIN_N = int(os.environ.get("FTFI_AUTO_CUDA_MIN_N", "250"))

_stats = {"demotions": 0, "errors": 0, "nonfinite": 0}
_blocked: dict[str, str] = {}


class BackendDemotionWarning(UserWarning):
    """A backend rung failed and the computation fell through to the next
    one. The message carries (from, to, reason)."""


class LadderExhaustedError(RuntimeError):
    """Every rung failed, including the host path."""


class DeviceRungError(RuntimeError):
    """A rung failed (raised, or gave a non-finite output) on card tensors,
    or was blocked. The ladder does not demote there: nothing on the card
    is served by the plain engines or the CPU in a kernel's place."""


def stats() -> dict:
    return {**_stats, "blocked": dict(_blocked)}


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def chain_from(backend: str) -> tuple:
    """The fallback chain starting at `backend` (host is always terminal)."""
    if backend not in LADDER:
        raise ValueError(f"unknown ladder backend {backend!r}; "
                         f"expected one of {LADDER}")
    return LADDER[LADDER.index(backend):]


def block_backend(name: str, reason: str) -> None:
    """Globally stop selecting rung `name` (e.g. after a failed probe):
    `effective_backend` and every new ladder closure skip it."""
    if name == "host":
        raise ValueError("the host rung is the terminal oracle and cannot "
                         "be blocked")
    if name not in _blocked:
        _blocked[name] = reason
        warnings.warn(f"backend {name!r} blocked for this process: {reason}",
                      BackendDemotionWarning, stacklevel=2)


def unblock_backends() -> None:
    _blocked.clear()


def auto_backend(n: int | None) -> str:
    """What `backend="auto"` builds with: "cuda" at or above
    `AUTO_CUDA_MIN_N` vertices, else "torch" (without `n`, "torch")."""
    return "cuda" if n is not None and n >= AUTO_CUDA_MIN_N else "torch"


def effective_backend(backend: str, n: int | None = None) -> str:
    """First non-blocked rung at or below `backend` ("auto" resolved by
    `auto_backend(n)` first) — the rung a CPU-tensor caller should build
    with. Nothing on the card's path routes through it."""
    if backend == "auto":
        backend = auto_backend(n)
    for level in chain_from(backend):
        if level not in _blocked:
            return level
    return "host"


def _demote(frm: str, to: str, reason: str, where: str) -> None:
    _stats["demotions"] += 1
    warnings.warn(
        f"{where}: backend {frm!r} demoted to {to!r}: {reason}",
        BackendDemotionWarning, stacklevel=3)


class ResilientFastMult:
    """(params, X) -> Y closure with the fallback chain baked in.

    Each rung's executor is built lazily (`plan_api.fastmult`); the output
    passes the finiteness gate, one scalar read on the host. Demotion is
    sticky: once rung i fails, calls start at rung i+1 (`reset()` re-arms
    the full chain; `demotions` records (from, to, reason) history).
    `device` (None = the card) is where X, params and Y live. On CPU
    tensors the chain runs cuda -> torch -> host; on the card the closure
    holds its one rung and a failure raises `DeviceRungError`."""

    def __init__(self, spec, fn, *, backend: str = "cuda", degree: int = 32,
                 device=None, name: str = "ftfi"):
        from repro_torch.core import plan_api

        self._plan_api = plan_api
        self.spec = spec
        self.fn = fn
        self.degree = degree
        self.device = resolve_device(device)
        self.name = name
        self.on_card = self.device.type != "cpu"
        if self.on_card:
            level = auto_backend(spec.n) if backend == "auto" else backend
            chain_from(level)
            if level in _blocked:
                raise DeviceRungError(
                    f"{name}: backend {level!r} is blocked ({_blocked[level]})"
                    "; on the card the ladder does not demote")
            self.levels = (level,)
        else:
            self.levels = tuple(
                l for l in chain_from(effective_backend(backend, n=spec.n))
                if l == "host" or l not in _blocked)
        self._idx = 0
        self._runners: dict[str, Callable] = {}
        self.demotions: list[tuple] = []

    @property
    def level(self) -> str:
        return self.levels[self._idx]

    def reset(self) -> None:
        self._idx = 0

    def _runner(self, level: str) -> Callable:
        run = self._runners.get(level)
        if run is not None:
            return run
        if level == "host":
            cpu = torch.device("cpu")
            fm = self._plan_api.fastmult(self.spec, self.fn, backend="torch",
                                         degree=self.degree, device=cpu)
            dev = self.device

            def run(params, X):
                if isinstance(X, torch.Tensor):
                    X = X.to(cpu)
                return fm(params, X).to(dev)
        else:
            run = self._plan_api.fastmult(self.spec, self.fn, backend=level,
                                          degree=self.degree,
                                          device=self.device)
        self._runners[level] = run
        return run

    def __call__(self, params, X):
        last = len(self.levels) - 1
        while True:
            level = self.levels[self._idx]
            point = f"ladder.{level}"
            try:
                faults.fire(point)
                Y = self._runner(level)(params, X)
                Y = faults.transform(f"ladder.out.{level}", Y)
                # the finiteness gate: one all-reduce, one scalar read
                ok = bool(torch.isfinite(Y).all())
            except Exception as e:
                _stats["errors"] += 1
                reason = f"{type(e).__name__}: {e}"
                if self.on_card:
                    raise DeviceRungError(
                        f"{self.name}: backend {level!r} failed on the card "
                        f"({reason}); the ladder demotes only on CPU "
                        "tensors") from e
                if self._idx >= last:
                    raise LadderExhaustedError(
                        f"{self.name}: every backend rung failed; terminal "
                        f"rung {level!r} raised {type(e).__name__}: {e}"
                    ) from e
                self._record_demotion(level, reason)
                continue
            if ok:
                return Y
            _stats["nonfinite"] += 1
            if self.on_card:
                raise DeviceRungError(
                    f"{self.name}: backend {level!r} gave a non-finite "
                    "output on the card; the ladder demotes only on CPU "
                    "tensors")
            if self._idx >= last:
                # the host rung IS the oracle: non-finite here means the
                # inputs are bad, which is the caller's problem, not a
                # backend fault
                warnings.warn(
                    f"{self.name}: non-finite output at the terminal host "
                    "rung — inputs are non-finite, returning as-is",
                    BackendDemotionWarning, stacklevel=2)
                return Y
            self._record_demotion(level, "non-finite output")

    def _record_demotion(self, frm: str, reason: str) -> None:
        self._idx += 1
        to = self.levels[self._idx]
        self.demotions.append((frm, to, reason))
        _demote(frm, to, reason, self.name)


def resilient_fastmult(spec, fn, *, backend: str = "cuda", degree: int = 32,
                       device=None, name: str = "ftfi") -> ResilientFastMult:
    """The ladder-supervised twin of `ftfi.fastmult`: same (params, X) -> Y
    signature, but on CPU tensors kernel failures and non-finite outputs
    demote down the chain instead of propagating (on the card they raise
    `DeviceRungError`)."""
    return ResilientFastMult(spec, fn, backend=backend, degree=degree,
                             device=device, name=name)


def apply_resilient(spec, params, fn, X, *, backend: str = "cuda",
                    degree: int = 32, device=None):
    """One-shot `ftfi.apply` under ladder supervision (fresh chain per
    call; use `resilient_fastmult` to keep demotions sticky)."""
    return ResilientFastMult(spec, fn, backend=backend, degree=degree,
                             device=device)(params, X)


def probe_backend(spec, params, backend: str, *, fn=None,
                  device=None) -> str | None:
    """Try one tiny integrate on `backend`; return None when healthy, else
    the failure reason. Dispatch sites use this at build time to demote
    BEFORE a broken rung reaches live traffic."""
    from repro_torch.core import cordial as C

    fn = fn if fn is not None else C.Exponential(-1.0)
    X = np.zeros((spec.n, 1), np.float32)
    X[0, 0] = 1.0
    try:
        faults.fire(f"ladder.{backend}")
        from repro_torch.core import plan_api

        if backend == "host":  # the plain engines on the CPU
            Y = plan_api.apply(spec, params, fn, X, backend="torch",
                               device="cpu")
        else:
            Y = plan_api.apply(spec, params, fn, X, backend=backend,
                               device=device)
        Y = faults.transform(f"ladder.out.{backend}", Y)
        if not bool(torch.isfinite(Y).all()):
            return "non-finite probe output"
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return None
