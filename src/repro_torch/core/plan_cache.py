"""Disk-persistent LRU plan cache.

`compile_plan` / `compile_forest_plan` consult this cache after the
in-memory BoundedLRU misses and BEFORE any IT build: a hit is one
`load_plan` npz read reconstructed through `plan_from_spec` (zero IT
rebuild), which turns cold *process* starts — serving restarts, benchmark
reruns, per-request trees that recur across workers — into a file read.

Configuration (environment, overridable programmatically):

  FTFI_PLAN_CACHE          cache directory; unset/empty -> cache disabled
  FTFI_PLAN_CACHE_MAX_MB   total size budget in MB (default 512); the
                           least-recently-USED artifacts (hits touch mtime)
                           are evicted once the budget is exceeded.
                           Non-numeric or non-positive values warn once
                           and fall back to the default, never crash.

Artifacts are the standard `save_plan` npz format keyed by a sha1 over the
full compile key (content fingerprint(s), leaf_size, seed, grid detection,
reweightable) plus the serialization schema version — so incompatible
artifacts from older code versions can never be loaded. Key, artifact
format and file names are the reference's (`repro.core.plan_cache`), so
one cache directory serves both packages: an entry either one wrote is a
hit in the other. Writes are atomic (tmp file + os.replace) and every
cache error degrades to a miss: a corrupt or torn artifact is deleted and
the plan is rebuilt. Hits load onto the CPU (the plan is host data; params
go to their device in `specialize`).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import warnings

_ENV_DIR = "FTFI_PLAN_CACHE"
_ENV_MAX_MB = "FTFI_PLAN_CACHE_MAX_MB"
_DEFAULT_MAX_MB = 512.0
_PREFIX = "ftfi-plan-"

_UNSET = object()
_dir_override: object = _UNSET
_max_mb_override: object = _UNSET
_warned_max_mb: str | None = None
_stats = {"hits": 0, "misses": 0, "stores": 0, "evictions": 0,
          "errors": 0, "validation_rejects": 0}


def configure(directory, max_mb: float | None = None) -> None:
    """Programmatic override of the environment configuration:
    `configure("/path")` enables the cache there, `configure(None)`
    disables it. `max_mb` optionally overrides the size budget."""
    global _dir_override, _max_mb_override
    _dir_override = os.fspath(directory) if directory else None
    if max_mb is not None:
        _max_mb_override = float(max_mb)


def reset_to_env() -> None:
    """Drop programmatic overrides: follow FTFI_PLAN_CACHE(_MAX_MB) again."""
    global _dir_override, _max_mb_override
    _dir_override = _UNSET
    _max_mb_override = _UNSET


def cache_dir() -> str | None:
    if _dir_override is not _UNSET:
        return _dir_override  # type: ignore[return-value]
    return os.environ.get(_ENV_DIR) or None


def enabled() -> bool:
    return cache_dir() is not None


def _max_bytes() -> int:
    if _max_mb_override is not _UNSET:
        return int(float(_max_mb_override) * 1e6)  # type: ignore[arg-type]
    raw = os.environ.get(_ENV_MAX_MB)
    if raw is None:
        return int(_DEFAULT_MAX_MB * 1e6)
    # defensive parse: an operator typo in the env must degrade to the
    # default budget with one warning, never crash the serving process or
    # silently evict everything (a negative/zero budget would)
    global _warned_max_mb
    try:
        mb = float(raw)
        if mb <= 0 or mb != mb:  # reject <= 0 and NaN
            raise ValueError(f"non-positive budget {mb!r}")
    except ValueError as e:
        if _warned_max_mb != raw:  # warn once per distinct bad value
            _warned_max_mb = raw
            warnings.warn(
                f"{_ENV_MAX_MB}={raw!r} is not a positive number ({e}); "
                f"using the default {_DEFAULT_MAX_MB:.0f} MB budget",
                UserWarning, stacklevel=2)
        return int(_DEFAULT_MAX_MB * 1e6)
    return int(mb * 1e6)


def key_str(key) -> str:
    """Stable hex digest of a compile-cache key tuple. The serialization
    schema version is mixed in so artifacts written by an incompatible
    PlanSpec layout are unreachable rather than mis-loaded."""
    from repro_torch.core.plan_api import _SAVE_VERSION, _SPEC_SCHEMA

    h = hashlib.sha1()
    h.update(f"v{_SAVE_VERSION}.{_SPEC_SCHEMA}|".encode())
    h.update(repr(key).encode())
    return h.hexdigest()


def _path(keyhex: str) -> str:
    return os.path.join(cache_dir(), f"{_PREFIX}{keyhex}.npz")


def _entries(directory: str) -> list:
    """(mtime, size, path) for every cache artifact in `directory`."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_PREFIX) and name.endswith(".npz")):
            continue
        p = os.path.join(directory, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out.append((st.st_mtime, st.st_size, p))
    return out


def load(keyhex: str):
    """(spec, params) on hit — touching the artifact's mtime for LRU — or
    None. Unreadable artifacts are deleted and count as misses."""
    if not enabled():
        return None
    path = _path(keyhex)
    if not os.path.exists(path):
        _stats["misses"] += 1
        return None
    from repro_torch.core.plan_api import load_plan
    from repro_torch.core.plan_guard import PlanValidationError

    try:
        # load_plan runs the full plan_guard pass in "strict" mode here
        # regardless of the global policy: a cache hit has a free fallback
        # (rebuild), so a bad artifact is ALWAYS a miss, never an executor
        # input — counted separately from torn-file errors
        spec, params = load_plan(path, device="cpu", validate=False)
        from repro_torch.core import plan_guard

        plan_guard.validate(spec, params, where=f"plan_cache({path})",
                            policy_override="strict")
        os.utime(path)  # LRU: a hit makes the artifact most-recently-used
    except Exception as e:
        if isinstance(e, PlanValidationError):
            _stats["validation_rejects"] += 1
        _stats["errors"] += 1
        _stats["misses"] += 1
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    _stats["hits"] += 1
    return spec, params


def store(keyhex: str, spec, params) -> None:
    """Atomically write one artifact, then evict least-recently-used
    artifacts until the directory is back under the size budget. Errors
    (read-only dir, disk full, races) are swallowed: the cache is an
    optimization, never a correctness dependency."""
    if not enabled():
        return
    directory = cache_dir()
    from repro_torch.core.plan_api import save_plan

    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
        try:
            os.close(fd)
            save_plan(tmp, spec, params)
            # fsync BEFORE the atomic rename: without it a hard kill can
            # leave a fully-renamed but truncated artifact (the rename can
            # hit disk before the data does), which would then be served as
            # a "valid" cache file until the guard rejects it
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, _path(keyhex))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    except Exception:
        _stats["errors"] += 1
        return
    _stats["stores"] += 1
    _evict(directory)


def _evict(directory: str) -> None:
    budget = _max_bytes()
    entries = sorted(_entries(directory))  # oldest mtime first
    total = sum(size for _, size, _ in entries)
    for _, size, path in entries:
        if total <= budget:
            break
        try:
            os.remove(path)
        except OSError:
            continue
        total -= size
        _stats["evictions"] += 1


def clear() -> None:
    """Remove every cache artifact (cache disabled -> no-op)."""
    directory = cache_dir()
    if directory is None:
        return
    for _, _, path in _entries(directory):
        try:
            os.remove(path)
        except OSError:
            pass


def stats() -> dict:
    directory = cache_dir()
    entries = _entries(directory) if directory else []
    return {"dir": directory, "enabled": directory is not None,
            "entries": len(entries),
            "bytes": int(sum(size for _, size, _ in entries)),
            "max_bytes": _max_bytes(), **_stats}
