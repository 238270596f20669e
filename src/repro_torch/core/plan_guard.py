"""Plan-artifact validation: the trust boundary in front of the executor.

`ftfi.load_plan`, the disk plan cache, and `ftfi.update_plan` all hand
index arrays to the executor's gathers and `index_add_`s, which do no
bounds checking on the card — a bit-flipped `src_gather` entry reads
garbage (or traps the device) instead of failing loudly.
`check_spec(spec, params)` bounds-checks every index array against its
target extent, verifies bucket-offset monotonicity and mask/shape
agreement, ghost-mask consistency, reweight/update-table coherence, and
schema/fingerprint integrity; `validate(...)` applies the policy knob:

  strict   (default) raise `PlanValidationError` on the first bad artifact
  warn     log a `PlanGuardWarning` and report failure (caller rejects/
           demotes: the disk cache treats it as a miss and rebuilds)
  off      skip validation entirely (trusted artifacts, benchmarking)

The policy comes from `FTFI_PLAN_GUARD` (env) or `set_policy(...)`;
`stats()` exposes the counters. Every check of the spec is a vectorized
single pass (min/max/any) over host numpy; params may be numpy arrays or
torch tensors on any device (their finiteness is read there, one scalar a
bucket).

The reference's `repro.core.plan_guard`, check for check. Its mesh check
reads `plan_shard.SHARD_LAYOUT_VERSION` and counts the devices a mesh can
be formed from where the reference counts `jax.device_count()`: the ranks
of the initialized process group, else the visible CUDA cards, else 1 (one
CPU device).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from repro_torch.core.plan_shard import SHARD_LAYOUT_VERSION

_ENV_POLICY = "FTFI_PLAN_GUARD"
_POLICIES = ("strict", "warn", "off")
_policy_override: str | None = None

_stats = {"validations": 0, "failures": 0, "raised": 0, "warned": 0}


class PlanValidationError(ValueError):
    """A plan artifact failed validation: its index arrays, bucket layout,
    or metadata are inconsistent and MUST NOT reach the fused executor."""


class PlanGuardWarning(UserWarning):
    """Non-strict policy: a plan artifact failed validation and was
    rejected (rebuilt/demoted) instead of raising."""


def set_policy(policy: str | None) -> None:
    """Programmatic policy override; `None` follows FTFI_PLAN_GUARD again."""
    global _policy_override
    if policy is not None and policy not in _POLICIES:
        raise ValueError(f"unknown plan-guard policy {policy!r}; "
                         f"expected one of {_POLICIES}")
    _policy_override = policy


def policy() -> str:
    if _policy_override is not None:
        return _policy_override
    p = os.environ.get(_ENV_POLICY, "strict").strip().lower()
    return p if p in _POLICIES else "strict"


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


# ----------------------------------------------------------------------------
# checks (pure: return a list of issue strings, never raise)
# ----------------------------------------------------------------------------

# Every integer index array on a PlanSpec, by field kind. The executor and
# the update/reweight paths address at most n+1 <= 2^31 rows, so these are
# int32 end-to-end — int64 doubles artifact size and device transfer for
# nothing (the dtype-discipline check below gates on it).
_INDEX_FIELDS = (
    "pivots", "src_gather", "src_seg", "tgt_gather", "tgt_scatter",
    "children", "root_refs", "job_bucket", "job_row", "leaf_bucket",
    "leaf_row", "path_rows", "path_edges", "ghosts", "edges_u", "edges_v",
)
_INDEX_TUPLE_FIELDS = (
    "leaf_ids", "cross_piv", "cross_tgt_rep", "cross_tgt_lca",
    "cross_src_rep", "cross_src_lca", "leaf_lca",
)


def _iter_index_arrays(spec):
    """Yield (field_name, array) for every index array on the spec."""
    for name in _INDEX_FIELDS:
        a = getattr(spec, name, None)
        if a is not None:
            yield name, a
    for name in _INDEX_TUPLE_FIELDS:
        val = getattr(spec, name, None)
        if val is None:
            continue
        for i, a in enumerate(val):
            yield f"{name}[{i}]", a


def check_index_dtypes(spec) -> list[str]:
    """Flag any integer index array that is not int32 (dtype discipline)."""
    issues = []
    for name, a in _iter_index_arrays(spec):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer) and a.dtype != np.int32:
            issues.append(f"{name}: index array dtype {a.dtype}, expected "
                          f"int32 (wastes memory/bandwidth end-to-end)")
    return issues


def coerce_index_dtypes(spec):
    """Downcast non-int32 integer index arrays to int32, bounds-guarded.

    Returns ``(new_spec, coerced_field_names)``; raises
    :class:`PlanValidationError` if any value does not fit in int32 (a
    corrupt artifact, not a dtype drift). Used by `load_plan` so pre-schema-4
    artifacts (which saved int64 update tables) land in canonical form."""
    import dataclasses

    i32 = np.iinfo(np.int32)
    replace: dict = {}
    coerced: list[str] = []

    def fix(name, a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.integer) or a.dtype == np.int32:
            return a, False
        if a.size and (int(a.min()) < i32.min or int(a.max()) > i32.max):
            raise PlanValidationError(
                f"{name}: index values span [{a.min()}, {a.max()}], which "
                f"does not fit int32 — refusing to downcast a corrupt "
                f"artifact")
        return a.astype(np.int32), True

    for name in _INDEX_FIELDS:
        a = getattr(spec, name, None)
        if a is None:
            continue
        b, did = fix(name, a)
        if did:
            replace[name] = b
            coerced.append(name)
    for name in _INDEX_TUPLE_FIELDS:
        val = getattr(spec, name, None)
        if val is None:
            continue
        out, any_did = [], False
        for i, a in enumerate(val):
            b, did = fix(f"{name}[{i}]", a)
            out.append(b)
            any_did = any_did or did
        if any_did:
            replace[name] = tuple(out)
            coerced.append(name)
    if not replace:
        return spec, []
    return dataclasses.replace(spec, **replace), coerced


def _all_finite(a) -> bool:
    """Every value finite? A torch tensor is read where it lies (one
    scalar to the host), anything else through numpy."""
    if hasattr(a, "detach"):  # a torch tensor
        import torch

        # one scalar to the host, as the reference's np.isfinite read
        return bool(torch.isfinite(a.detach()).all())  # noqa: repro-lint
    return bool(np.isfinite(np.asarray(a)).all())


def _idx_in(name, arr, lo, hi, issues):
    """All entries of integer array `arr` in [lo, hi)? One min/max pass."""
    if arr is None or arr.size == 0:
        return
    if not np.issubdtype(arr.dtype, np.integer):
        issues.append(f"{name}: dtype {arr.dtype} is not integral")
        return
    mn, mx = int(arr.min()), int(arr.max())
    if mn < lo or mx >= hi:
        issues.append(f"{name}: values span [{mn}, {mx}] outside the valid "
                      f"range [{lo}, {hi})")


def _offsets_ok(name, offs, masks, total, issues):
    """Bucket offsets must be the exact running sum of B_i * U_i (monotone
    by construction) and `total` their final value."""
    if len(offs) != len(masks):
        issues.append(f"{name}: {len(offs)} offsets for {len(masks)} buckets")
        return
    expect = 0
    for i, (off, m) in enumerate(zip(offs, masks)):
        if int(off) != expect:
            issues.append(f"{name}[{i}]: offset {int(off)} != running flat "
                          f"size {expect} (non-monotonic or corrupt layout)")
            return
        expect += int(m.shape[0]) * int(m.shape[1])
    if int(total) != expect:
        issues.append(f"{name}: group total {int(total)} != flat layout "
                      f"size {expect}")


def mesh_device_count() -> int:
    """Devices a mesh can be formed from here: the world size of the
    initialized process group (one rank a device), else the visible CUDA
    cards, else 1 — the reference's `jax.device_count()` on one CPU
    device."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return max(torch.cuda.device_count(), 1)


def check_spec(spec, params=None, max_issues: int = 16) -> list[str]:
    """Every inconsistency that could make the fused executor read or write
    out of bounds (or silently mis-integrate), as human-readable strings.
    Purely host-side numpy; does not raise."""
    issues: list[str] = []

    def done() -> bool:
        return len(issues) >= max_issues

    # -- schema / provenance integrity --------------------------------------
    n = spec.n
    if not isinstance(n, (int, np.integer)) or n < 1:
        issues.append(f"n={n!r}: not a positive integer")
        return issues  # nothing below is meaningful
    if not (isinstance(spec.fingerprint, str) and spec.fingerprint
            and all(c in "0123456789abcdef" for c in spec.fingerprint)):
        issues.append(f"fingerprint {spec.fingerprint!r}: not a hex digest")
    if len(spec.tree_sizes) != spec.num_trees:
        issues.append(f"num_trees={spec.num_trees} but "
                      f"{len(spec.tree_sizes)} tree_sizes")
    if sum(int(t) for t in spec.tree_sizes) != n:
        issues.append(f"tree_sizes sum {sum(spec.tree_sizes)} != n={n}")
    # -- mesh / shard-layout provenance -------------------------------------
    # A plan saved with `save_plan(..., mesh=...)` records the mesh it was
    # laid out for; executing it on a process that cannot form that mesh
    # (fewer devices, newer incompatible shard layout) must fail at load,
    # not deep inside shard_map with an opaque collective error.
    shard_layout = int(getattr(spec, "shard_layout", 0) or 0)
    mesh_devices = int(getattr(spec, "mesh_devices", 0) or 0)
    if shard_layout:
        if shard_layout > SHARD_LAYOUT_VERSION:
            issues.append(
                f"shard_layout={shard_layout}: artifact uses a newer shard "
                f"layout than this build supports "
                f"(SHARD_LAYOUT_VERSION={SHARD_LAYOUT_VERSION})")
        if mesh_devices:
            avail = mesh_device_count()
            if mesh_devices > avail:
                issues.append(
                    f"mesh_devices={mesh_devices}: sharded artifact needs "
                    f"{mesh_devices} devices but only {avail} are visible "
                    f"(axes {tuple(getattr(spec, 'mesh_axes', ()) or ())})")
    if done():
        return issues

    nb = len(spec.cross_tgt_mask)
    nl = len(spec.leaf_ids)
    for name, want in (("cross_src_mask", nb), ("cross_tgt_d0", nb),
                       ("cross_src_d0", nb), ("leaf_mask", nl),
                       ("leaf_dists0", nl)):
        if len(getattr(spec, name)) != want:
            issues.append(f"{name}: {len(getattr(spec, name))} buckets, "
                          f"expected {want}")
    if done():
        return issues

    # -- per-bucket shape agreement -----------------------------------------
    for i in range(nb):
        tm, sm = spec.cross_tgt_mask[i], spec.cross_src_mask[i]
        if tm.dtype != bool or sm.dtype != bool:
            issues.append(f"cross bucket {i}: masks are not boolean")
        if tm.shape[0] != sm.shape[0]:
            issues.append(f"cross bucket {i}: tgt rows {tm.shape[0]} != "
                          f"src rows {sm.shape[0]}")
        if spec.cross_tgt_d0[i].shape != tm.shape:
            issues.append(f"cross bucket {i}: tgt_d0 shape "
                          f"{spec.cross_tgt_d0[i].shape} != mask {tm.shape}")
        if spec.cross_src_d0[i].shape != sm.shape:
            issues.append(f"cross bucket {i}: src_d0 shape "
                          f"{spec.cross_src_d0[i].shape} != mask {sm.shape}")
        if done():
            return issues
    for i in range(nl):
        ids, m, d = spec.leaf_ids[i], spec.leaf_mask[i], spec.leaf_dists0[i]
        B, K = ids.shape
        if m.shape != (B, K) or m.dtype != bool:
            issues.append(f"leaf bucket {i}: mask shape/dtype mismatch")
        if d.shape != (B, K, K):
            issues.append(f"leaf bucket {i}: dists shape {d.shape} != "
                          f"({B}, {K}, {K})")
        _idx_in(f"leaf_ids[{i}]", ids, 0, n + 1, issues)
        if m.shape == ids.shape and ids.size and m.any():
            live_max = int(ids[m].max()) if m.any() else -1
            if live_max >= n:
                issues.append(f"leaf_ids[{i}]: live (unmasked) slot points "
                              f"at pad row {live_max} >= n={n}")
        if done():
            return issues

    # -- bucket-offset monotonicity / flat-layout totals --------------------
    _offsets_ok("cross_src_off", spec.cross_src_off, spec.cross_src_mask,
                spec.n_src_groups, issues)
    _offsets_ok("cross_tgt_off", spec.cross_tgt_off, spec.cross_tgt_mask,
                spec.n_tgt_groups, issues)
    if done():
        return issues

    # -- index dtype discipline: int32 end-to-end ---------------------------
    issues.extend(check_index_dtypes(spec))
    if done():
        return issues

    # -- fused executor index arrays: every gather/scatter bounds-checked ---
    # gather FROM Xpad (n+1 rows incl. the pad row) / scatter INTO out (same)
    _idx_in("pivots", spec.pivots, 0, n + 1, issues)
    _idx_in("src_gather", spec.src_gather, 0, n + 1, issues)
    _idx_in("tgt_scatter", spec.tgt_scatter, 0, n + 1, issues)
    # segment/group ids against their group extents
    _idx_in("src_seg", spec.src_seg, 0, max(spec.n_src_groups, 1), issues)
    _idx_in("tgt_gather", spec.tgt_gather, 0, max(spec.n_tgt_groups, 1),
            issues)
    if spec.src_gather.shape != spec.src_seg.shape:
        issues.append(f"src_gather/src_seg length mismatch: "
                      f"{spec.src_gather.shape} vs {spec.src_seg.shape}")
    if spec.tgt_gather.shape != spec.tgt_scatter.shape:
        issues.append(f"tgt_gather/tgt_scatter length mismatch: "
                      f"{spec.tgt_gather.shape} vs {spec.tgt_scatter.shape}")
    if done():
        return issues

    # -- ghost-mask consistency ---------------------------------------------
    if spec.ghosts is not None and spec.ghosts.size:
        _idx_in("ghosts", spec.ghosts, 0, n, issues)
        g = np.unique(spec.ghosts)
        if g.size != spec.ghosts.size:
            issues.append("ghosts: duplicated vertex ids")
        for name, arr in (("src_gather", spec.src_gather),
                          ("tgt_scatter", spec.tgt_scatter)):
            if arr.size and np.isin(arr, g).any():
                issues.append(f"{name}: references deleted (ghost) vertices "
                              "— their rows must carry no flat entries")
        for i in range(nl):
            m = spec.leaf_mask[i]
            if m.any() and np.isin(spec.leaf_ids[i][m], g).any():
                issues.append(f"leaf_ids[{i}]: live slot references a ghost")
        if done():
            return issues

    # -- reweight tables ----------------------------------------------------
    if spec.path_rows is not None:
        _idx_in("path_rows", spec.path_rows, 0, n, issues)
        _idx_in("path_edges", spec.path_edges, 0, max(spec.num_edges, 1),
                issues)
        if spec.path_rows.shape != spec.path_edges.shape:
            issues.append("path_rows/path_edges length mismatch")
        for name in ("cross_piv", "cross_tgt_rep", "cross_tgt_lca",
                     "cross_src_rep", "cross_src_lca", "leaf_lca"):
            val = getattr(spec, name)
            if val is None:
                issues.append(f"{name}: missing on a reweightable spec")
                continue
            for i, a in enumerate(val):
                _idx_in(f"{name}[{i}]", a, 0, n + 1, issues)
                if done():
                    return issues
    if spec.edges_u is not None:
        for name in ("edges_u", "edges_v"):
            a = getattr(spec, name)
            if a.shape[0] != spec.num_edges:
                issues.append(f"{name}: {a.shape[0]} entries != "
                              f"num_edges={spec.num_edges}")
            _idx_in(name, a, 0, n, issues)
        if spec.edge_w0 is not None and np.asarray(spec.edge_w0).size:
            w = np.asarray(spec.edge_w0)
            if not np.isfinite(w).all():
                issues.append("edge_w0: non-finite edge weights")

    # -- update tables ------------------------------------------------------
    if spec.children is not None:
        num_internal = spec.children.shape[0]
        if spec.pivots.shape[0] != num_internal:
            issues.append(f"children: {num_internal} internal nodes but "
                          f"{spec.pivots.shape[0]} pivots")
        if spec.job_bucket is not None:
            _idx_in("job_bucket", spec.job_bucket, 0, max(nb, 1), issues)
        if spec.leaf_bucket is not None:
            _idx_in("leaf_bucket", spec.leaf_bucket, 0, max(nl, 1), issues)
    if done():
        return issues

    # -- params: the dynamic half must match the static layout --------------
    if params is not None:
        for name, want in (("cross_tgt_d", nb), ("cross_src_d", nb),
                           ("leaf_dists", nl)):
            val = getattr(params, name)
            if len(val) != want:
                issues.append(f"params.{name}: {len(val)} buckets, "
                              f"expected {want}")
                continue
            shapes = ([m.shape for m in spec.cross_tgt_mask],
                      [m.shape for m in spec.cross_src_mask],
                      [d.shape for d in spec.leaf_dists0])[
                          ("cross_tgt_d", "cross_src_d",
                           "leaf_dists").index(name)]
            for i, a in enumerate(val):
                if tuple(a.shape) != tuple(shapes[i]):
                    issues.append(f"params.{name}[{i}]: shape "
                                  f"{tuple(a.shape)} != spec layout "
                                  f"{tuple(shapes[i])}")
                elif not _all_finite(a):
                    # masked/pad slots legitimately carry garbage values but
                    # never non-finite ones: NaN * 0-mass still poisons sums
                    issues.append(f"params.{name}[{i}]: non-finite distances")
                if done():
                    return issues
        if params.tree_w is not None:
            tw = params.tree_w
            if tuple(tw.shape) != (spec.num_trees,):
                issues.append(f"params.tree_w: shape {tuple(tw.shape)} != "
                              f"({spec.num_trees},)")
            elif not _all_finite(tw):
                issues.append("params.tree_w: non-finite weights")
    return issues


def validate(spec, params=None, *, where: str = "plan",
             policy_override: str | None = None) -> bool:
    """Apply the policy to `check_spec`: True = safe to execute.

    strict -> raise PlanValidationError; warn -> PlanGuardWarning + False
    (callers reject: cache miss, load failure, demotion); off -> True
    without checking."""
    pol = policy_override if policy_override is not None else policy()
    if pol == "off":
        return True
    _stats["validations"] += 1
    issues = check_spec(spec, params)
    if not issues:
        return True
    _stats["failures"] += 1
    msg = (f"{where}: plan artifact failed validation "
           f"({len(issues)} issue{'s' if len(issues) > 1 else ''}):\n  "
           + "\n  ".join(issues))
    if pol == "strict":
        _stats["raised"] += 1
        raise PlanValidationError(msg)
    _stats["warned"] += 1
    warnings.warn(msg, PlanGuardWarning, stacklevel=2)
    return False
