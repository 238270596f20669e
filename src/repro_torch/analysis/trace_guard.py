"""Retrace sentinel: compile-count accounting for the serving engine's
entry points.

The reference's pure-stdlib `repro.analysis.trace_guard`, copied. The
reference's sites record from inside jitted bodies, so a record marks a
compile. The port does not jit: its sites record on the first call of each
(site, bucket) an owner sees, where the reference would have compiled
(`ServeEngine`: `serve.decode` once, `serve.prefill` and
`serve.prefill_tree` once per pow2 prompt bucket, the tree site also per
forest plan). So a scenario leaves the same `stats()` in both packages, and
a key that changes on every call (the silent retrace-per-call the
reference guards against) shows here as a count that grows the same way.
Cache layers call :func:`record` with an ``event=`` tag for hit/miss
accounting. Tests wrap a workload in :func:`expect_stable` (fail on any new
record of a declared-stable site) or diff :func:`stats` against per-site
budgets via :func:`check`.

Pure stdlib: importing it costs nothing.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = [
    "RetraceError", "record", "compiles", "stats", "reset",
    "declare_stable", "expect_stable", "check", "snapshot",
]


class RetraceError(AssertionError):
    """A declared-stable entry point retraced."""


_lock = threading.Lock()
_counts: dict[str, int] = {}          # site -> total records
_by_key: dict[tuple[str, str], int] = {}  # (site, detail) -> records
_stable: dict[str, int] = {}          # site -> max allowed compiles


def record(site: str, detail: str = "", event: str = "compile") -> None:
    """Record one compile (or cache event) at ``site``.

    Call this where the reference's jitted body would trace: once per new
    (site, bucket), so the count equals the reference's compiles.  For
    cache layers, pass ``event="hit"``/``event="miss"`` — those are
    accounted under ``site:hit`` / ``site:miss`` and never trip stability
    checks on ``site`` itself.
    """
    key = site if event == "compile" else f"{site}:{event}"
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1
        if detail:
            _by_key[(key, detail)] = _by_key.get((key, detail), 0) + 1


def compiles(site: str) -> int:
    with _lock:
        return _counts.get(site, 0)


def stats() -> dict:
    """Snapshot of all counters: {"sites": {site: n}, "keys": {...}}."""
    with _lock:
        keys = {f"{s} [{d}]": n for (s, d), n in sorted(_by_key.items())}
        return {"sites": dict(sorted(_counts.items())), "keys": keys}


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
        _by_key.clear()
        _stable.clear()


def declare_stable(site: str, max_compiles: int = 1) -> None:
    """Declare that ``site`` may compile at most ``max_compiles`` times
    (checked by :func:`check`)."""
    with _lock:
        _stable[site] = int(max_compiles)


@contextmanager
def expect_stable(*sites: str, max_compiles: int = 0):
    """Fail with :class:`RetraceError` if any of ``sites`` compiles more
    than ``max_compiles`` times inside the block.

    ``max_compiles=0`` is the steady-state assertion: every bucket was
    already seen, re-running the workload must record nothing new.
    """
    before = snapshot()
    yield
    after = snapshot()
    bad = []
    for s in sites:
        delta = after.get(s, 0) - before.get(s, 0)
        if delta > max_compiles:
            bad.append(f"{s}: {delta} compiles (budget {max_compiles})")
    if bad:
        raise RetraceError(
            "retrace budget exceeded: " + "; ".join(bad))


def check(budgets: dict[str, int] | None = None) -> list[str]:
    """Diff recorded compile counts against per-site budgets.

    ``budgets`` maps site -> max compiles; sites previously registered via
    :func:`declare_stable` are merged in.  Returns a list of violation
    strings (empty = clean).
    """
    with _lock:
        merged = dict(_stable)
        counts = dict(_counts)
    if budgets:
        merged.update({k: int(v) for k, v in budgets.items()})
    issues = []
    for site, limit in sorted(merged.items()):
        n = counts.get(site, 0)
        if n > limit:
            issues.append(
                f"trace_guard: {site} compiled {n}x (budget {limit})")
    return issues
