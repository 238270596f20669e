"""Functional plan API: static `PlanSpec` + `PlanParams` of torch tensors.

  PlanSpec    hashable, static: index arrays, bucket layout, masks, grid
              metadata, provenance (content hash, seed, leaf_size). Every
              array is host-side numpy, bit for bit the reference package's,
              and `digest` hashes the same bytes, so a plan carries its
              identity across the two packages. The device copies of its
              index arrays (int64 for `index_select`/`index_add_`) are made
              once per device and cached on the spec.

  PlanParams  dynamic: leaf/cross distances and per-tree output weights as
              float32 torch tensors.

Entry points (also exposed as `repro_torch.ftfi`):

  build(tree_or_forest, ...)      -> (spec, params)
  apply(spec, params, fn, X)      -> Y
  fastmult(spec, fn)              -> (params, X) -> Y
  reweight(spec, edge_w)          -> PlanParams   (differentiable in edge_w)
  update_plan(spec, params, ops)  -> (spec', params')  incremental edits
  describe(spec, fn)              -> engine choice
  save_plan / load_plan           npz round trip, the reference's format,
                                  bounds-checked by `plan_guard` on load;
                                  `save_plan(..., mesh=)` stamps the mesh
  apply(..., mesh=)               the multi-rank executor (`plan_shard`)
  from_numpy(spec_fields, params_fields) -> (spec, params) from the numpy
                                     arrays of a live reference pair

Backends: "torch" runs the plain engines (the reference's "plan");
"cuda" runs the fdist_matvec kernel for the in-kernel families
(`KERNEL_MODES`) and the plain engines for the rest (the reference's
"pallas"); "auto" picks one of the two by the plan's size
(`ladder.auto_backend`). Every entry point takes
`device=None`, meaning the CUDA card.

Reweight exactness: the IT decomposition is purely combinatorial (it covers
every vertex pair regardless of weights), so recomputing distances as
d(u,v) = depth[u] + depth[v] - 2 depth[lca(u,v)] with depth = root-path edge
sums yields the TRUE integration for ANY positive edge weights — provided
each distance slot maps to one vertex. `build(..., reweightable=True)`
therefore expands distance groups to per-vertex slots (and disables the
grid/Hankel engine, whose integer grid would not survive retraining).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import plan_guard
from repro_torch.core.engines.spec import FamilySpec, spec_of
from repro_torch.core.integrate import (CrossBucket, IntegrationPlan,
                                        LeafBucket, compile_forest_plan,
                                        compile_plan)
from repro_torch.core.plan_guard import PlanValidationError  # noqa: F401
from repro_torch.device import resolve_device

KERNEL_MODES = ("poly", "exp", "expq", "rational")
BACKENDS = ("torch", "cuda", "auto")

_SAVE_VERSION = 1
# PlanSpec field-layout generation, mixed into disk-cache keys (the
# reference's: a cache directory is shared between the two packages)
_SPEC_SCHEMA = 4


# ----------------------------------------------------------------------------
# PlanSpec / PlanParams
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class PlanSpec:
    """Static half of a plan: the reference's fields, in the reference's
    order. Hashable by content digest; every array is host-side numpy.
    Tuples are indexed by cross/leaf bucket."""

    n: int
    num_trees: int
    tree_sizes: tuple
    leaf_size: int
    seed: int
    fingerprint: str
    grid_h: float | None
    reweightable: bool
    # cross buckets (static layout; build-time distances kept for the
    # grid/Hankel engine, which requires host-side integer grid indices)
    cross_tgt_mask: tuple  # of (B, Ut) bool
    cross_src_mask: tuple  # of (B, Us) bool
    cross_src_off: tuple
    cross_tgt_off: tuple
    cross_tgt_d0: tuple  # of (B, Ut) float64
    cross_src_d0: tuple
    # leaf buckets
    leaf_ids: tuple  # of (B, K) int32, padded with n
    leaf_mask: tuple  # of (B, K) bool
    leaf_dists0: tuple  # of (B, K, K) float64
    # fused executor index arrays
    pivots: np.ndarray
    src_gather: np.ndarray
    src_seg: np.ndarray
    n_src_groups: int
    tgt_gather: np.ndarray
    tgt_scatter: np.ndarray
    n_tgt_groups: int
    num_cross_jobs: int
    # reweight tables (only for reweightable builds)
    num_edges: int = 0
    path_rows: np.ndarray | None = None  # (P,) vertex per root-path entry
    path_edges: np.ndarray | None = None  # (P,) edge id per entry
    cross_piv: tuple | None = None  # of (B,) pivot vertex per job row
    cross_tgt_rep: tuple | None = None  # of (B, Ut) representative vertex
    cross_tgt_lca: tuple | None = None  # of (B, Ut) lca(piv, rep)
    cross_src_rep: tuple | None = None
    cross_src_lca: tuple | None = None
    leaf_lca: tuple | None = None  # of (B, K, K) lca(ids_i, ids_j)
    # update tables (IT skeleton + job/leaf coordinates; `update_plan`
    # patches single leaves with them)
    children: np.ndarray | None = None  # (I, 2) canonical IT child refs
    root_refs: np.ndarray | None = None  # (num_trees,) per-tree root ref
    job_bucket: np.ndarray | None = None  # (2I,) bucket index per cross job
    job_row: np.ndarray | None = None  # (2I,) row within bucket
    leaf_bucket: np.ndarray | None = None  # (L,) bucket per leaf node
    leaf_row: np.ndarray | None = None  # (L,) row within leaf bucket
    edges_u: np.ndarray | None = None  # (E,) packed edge endpoints (global)
    edges_v: np.ndarray | None = None
    edge_w0: np.ndarray | None = None  # (E,) build-time edge weights
    ghosts: np.ndarray | None = None  # deleted-vertex ids (update_plan)
    # mesh/device provenance of sharded artifacts (0/empty = not sharded)
    mesh_devices: int = 0
    mesh_axes: tuple = ()
    shard_layout: int = 0

    def __post_init__(self):
        # digest is lazy (hashing the index arrays is not free); the device
        # tables are derived data, memoized per device
        object.__setattr__(self, "_digest", None)
        object.__setattr__(self, "_device_tables", {})

    @property
    def digest(self) -> str:
        if self._digest is None:
            h = hashlib.sha1()
            for f in dataclasses.fields(self):
                _mix(h, getattr(self, f.name))
            object.__setattr__(self, "_digest", h.hexdigest())
        return self._digest

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return (type(other) is PlanSpec
                and other.digest == self.digest)

    def __repr__(self):
        return (f"PlanSpec(n={self.n}, num_trees={self.num_trees}, "
                f"leaf_size={self.leaf_size}, seed={self.seed}, "
                f"grid_h={self.grid_h}, reweightable={self.reweightable}, "
                f"sha={self.digest[:12]})")


def _mix(h, val):
    if val is None:
        h.update(b"\x00N")
    elif isinstance(val, np.ndarray):
        h.update(str(val.dtype).encode())
        h.update(np.int64(val.shape).tobytes())
        h.update(np.ascontiguousarray(val).tobytes())
    elif isinstance(val, (tuple, list)):
        h.update(b"\x00T%d" % len(val))
        for v in val:
            _mix(h, v)
    else:
        h.update(repr(val).encode())


@dataclasses.dataclass
class PlanParams:
    """Dynamic half of a plan: float32 torch tensors on one device.

    `tree_w` is the per-tree output weight vector (None = all ones): the
    multiply is linear, so scaling tree t's output rows equals scaling its
    mask."""

    cross_tgt_d: tuple  # of (B, Ut)
    cross_src_d: tuple  # of (B, Us)
    leaf_dists: tuple  # of (B, K, K)
    tree_w: torch.Tensor | None = None  # (num_trees,) or None


def _params_on(params: PlanParams, device: torch.device) -> PlanParams:
    def mv(t):
        if isinstance(t, torch.Tensor):  # no copy when already in place
            return t.to(device=device, dtype=torch.float32)
        # numpy: a private float32 copy (float64 rounds to nearest, as the
        # reference's jnp.asarray does under its default 32-bit mode)
        return torch.from_numpy(np.array(t, dtype=np.float32)).to(device)

    return PlanParams(
        cross_tgt_d=tuple(mv(t) for t in params.cross_tgt_d),
        cross_src_d=tuple(mv(t) for t in params.cross_src_d),
        leaf_dists=tuple(mv(t) for t in params.leaf_dists),
        tree_w=None if params.tree_w is None else mv(params.tree_w))


def _device_tables(spec: PlanSpec, device: torch.device) -> dict:
    """The spec's index arrays and masks as tensors on `device`, made once
    per (spec, device)."""
    hit = spec._device_tables.get(device)
    if hit is not None:
        return hit

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def msk(a):
        return torch.from_numpy(np.asarray(a, bool)).to(device)

    t = {
        "leaf_ids": [idx(a) for a in spec.leaf_ids],
        "leaf_mask": [msk(a) for a in spec.leaf_mask],
        "leaf_pair_mask": [msk(a[:, :, None] & a[:, None, :])
                           for a in spec.leaf_mask],
        "cross_tgt_mask": [msk(a) for a in spec.cross_tgt_mask],
        "cross_src_mask": [msk(a) for a in spec.cross_src_mask],
        "pivots": idx(spec.pivots),
        "src_gather": idx(spec.src_gather),
        "src_seg": idx(spec.src_seg),
        "tgt_gather": idx(spec.tgt_gather),
        "tgt_scatter": idx(spec.tgt_scatter),
        "tree_sizes": idx(spec.tree_sizes),
    }
    if spec.grid_h is not None:  # integer grid indices of the Hankel engine
        t["grid_tgt"] = [np.rint(a / spec.grid_h).astype(np.int64)
                         for a in spec.cross_tgt_d0]
        t["grid_src"] = [np.rint(a / spec.grid_h).astype(np.int64)
                         for a in spec.cross_src_d0]
        t["grid_tgt_t"] = [idx(a) for a in t["grid_tgt"]]
        t["grid_src_t"] = [idx(a) for a in t["grid_src"]]
    spec._device_tables[device] = t
    return t


def _reweight_tables(spec: PlanSpec, device: torch.device) -> dict:
    """The reweight tables of a reweightable spec on `device` (int64), made
    once per (spec, device) beside `_device_tables`."""
    t = _device_tables(spec, device)
    hit = t.get("rw")
    if hit is not None:
        return hit

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    t["rw"] = rw = {
        "path_rows": idx(spec.path_rows),
        "path_edges": idx(spec.path_edges),
        "cross": [(idx(p[:, None]), idx(tr), idx(tl), idx(sr), idx(sl))
                  for p, tr, tl, sr, sl in zip(
                      spec.cross_piv, spec.cross_tgt_rep,
                      spec.cross_tgt_lca, spec.cross_src_rep,
                      spec.cross_src_lca)],
        "leaf": [(idx(ids[:, :, None]), idx(ids[:, None, :]), idx(lca))
                 for ids, lca in zip(spec.leaf_ids, spec.leaf_lca)],
    }
    return rw


# ----------------------------------------------------------------------------
# specialize: IntegrationPlan -> (PlanSpec, PlanParams)
# ----------------------------------------------------------------------------


def specialize(plan: IntegrationPlan, device=None):
    """Split a compiled `IntegrationPlan` into its functional (spec, params)
    pair. The spec is memoized on the plan, so content-cached plans share
    one spec (and so one set of device tables); params are fresh tensors
    on `device`."""
    dev = resolve_device(device)
    spec = _plan_spec(plan)
    return spec, _birth_params(spec, dev)


def _plan_spec(plan: IntegrationPlan) -> PlanSpec:
    """The plan's PlanSpec, made once and memoized on the plan."""
    spec = getattr(plan, "_spec", None)
    if spec is None:
        rw = plan.rw or {}
        upd = plan.upd or {}
        spec = PlanSpec(
            n=plan.n,
            num_trees=max(len(plan.tree_sizes), 1),
            tree_sizes=tuple(plan.tree_sizes) or (plan.n,),
            leaf_size=plan.leaf_size,
            seed=plan.seed,
            fingerprint=plan.fingerprint,
            grid_h=plan.grid_h,
            reweightable=plan.reweightable,
            cross_tgt_mask=tuple(cb.tgt_d_mask for cb in plan.cross_buckets),
            cross_src_mask=tuple(cb.src_d_mask for cb in plan.cross_buckets),
            cross_src_off=tuple(cb.src_off for cb in plan.cross_buckets),
            cross_tgt_off=tuple(cb.tgt_off for cb in plan.cross_buckets),
            cross_tgt_d0=tuple(cb.tgt_d for cb in plan.cross_buckets),
            cross_src_d0=tuple(cb.src_d for cb in plan.cross_buckets),
            leaf_ids=tuple(lb.ids for lb in plan.leaf_buckets),
            leaf_mask=tuple(lb.mask for lb in plan.leaf_buckets),
            leaf_dists0=tuple(lb.dists for lb in plan.leaf_buckets),
            pivots=plan.pivots,
            src_gather=plan.src_gather,
            src_seg=plan.src_seg,
            n_src_groups=plan.n_src_groups,
            tgt_gather=plan.tgt_gather,
            tgt_scatter=plan.tgt_scatter,
            n_tgt_groups=plan.n_tgt_groups,
            num_cross_jobs=plan.num_cross_jobs,
            num_edges=int(rw.get("num_edges", 0)),
            path_rows=rw.get("path_rows"),
            path_edges=rw.get("path_edges"),
            cross_piv=(tuple(cb.piv for cb in plan.cross_buckets)
                       if rw else None),
            cross_tgt_rep=(tuple(cb.tgt_rep for cb in plan.cross_buckets)
                           if rw else None),
            cross_tgt_lca=tuple(rw["cross_tgt_lca"]) if rw else None,
            cross_src_rep=(tuple(cb.src_rep for cb in plan.cross_buckets)
                           if rw else None),
            cross_src_lca=tuple(rw["cross_src_lca"]) if rw else None,
            leaf_lca=tuple(rw["leaf_lca"]) if rw else None,
            children=upd.get("children"),
            root_refs=upd.get("root_refs"),
            job_bucket=upd.get("job_bucket"),
            job_row=upd.get("job_row"),
            leaf_bucket=upd.get("leaf_bucket"),
            leaf_row=upd.get("leaf_row"),
            edges_u=rw.get("edges_u"),
            edges_v=rw.get("edges_v"),
            edge_w0=rw.get("edge_w0"),
            ghosts=np.zeros(0, np.int32) if upd else None,
        )
        plan._spec = spec
    return spec


def _birth_params(spec: PlanSpec, device: torch.device) -> PlanParams:
    # float64 build-time distances -> float32 tensors: the same rounding as
    # the reference's jnp.asarray under its default 32-bit mode
    return _params_on(PlanParams(cross_tgt_d=spec.cross_tgt_d0,
                                 cross_src_d=spec.cross_src_d0,
                                 leaf_dists=spec.leaf_dists0), device)


def plan_from_spec(spec: PlanSpec) -> IntegrationPlan:
    """Reconstruct an `IntegrationPlan` from a spec — the path of loaded
    artifacts and disk-cache hits: zero IT rebuild by construction. The
    spec is memoized on the plan, so `specialize` hands it back as is, with
    params made on the caller's device from the spec's build-time
    distances (the float32 bits `save_plan` stored)."""
    cbs = []
    for i in range(len(spec.cross_tgt_d0)):
        cbs.append(CrossBucket(
            tgt_d=spec.cross_tgt_d0[i], tgt_d_mask=spec.cross_tgt_mask[i],
            src_d=spec.cross_src_d0[i], src_d_mask=spec.cross_src_mask[i],
            src_off=spec.cross_src_off[i], tgt_off=spec.cross_tgt_off[i],
            piv=spec.cross_piv[i] if spec.cross_piv else None,
            tgt_rep=spec.cross_tgt_rep[i] if spec.cross_tgt_rep else None,
            src_rep=spec.cross_src_rep[i] if spec.cross_src_rep else None,
        ))
    lbs = [LeafBucket(ids=spec.leaf_ids[i], mask=spec.leaf_mask[i],
                      dists=spec.leaf_dists0[i])
           for i in range(len(spec.leaf_ids))]
    plan = IntegrationPlan(
        n=spec.n, cross_buckets=cbs, leaf_buckets=lbs, pivots=spec.pivots,
        grid_h=spec.grid_h, src_gather=spec.src_gather, src_seg=spec.src_seg,
        n_src_groups=spec.n_src_groups, tgt_gather=spec.tgt_gather,
        tgt_scatter=spec.tgt_scatter, n_tgt_groups=spec.n_tgt_groups,
        num_cross_jobs=spec.num_cross_jobs, fingerprint=spec.fingerprint,
        leaf_size=spec.leaf_size, seed=spec.seed,
        tree_sizes=spec.tree_sizes, reweightable=spec.reweightable)
    if spec.path_rows is not None:
        plan.rw = {"path_rows": spec.path_rows,
                   "path_edges": spec.path_edges,
                   "num_edges": spec.num_edges,
                   "cross_tgt_lca": list(spec.cross_tgt_lca),
                   "cross_src_lca": list(spec.cross_src_lca),
                   "leaf_lca": list(spec.leaf_lca)}
        if spec.edges_u is not None:
            plan.rw.update(edges_u=spec.edges_u, edges_v=spec.edges_v,
                           edge_w0=spec.edge_w0)
    if spec.children is not None:
        plan.upd = {"children": spec.children, "root_refs": spec.root_refs,
                    "job_bucket": spec.job_bucket, "job_row": spec.job_row,
                    "leaf_bucket": spec.leaf_bucket,
                    "leaf_row": spec.leaf_row}
    plan._spec = spec
    return plan


def build(tree_or_forest, *, leaf_size: int = 64, seed: int = 0,
          reweightable: bool = False, detect_grid_spacing: bool = True,
          use_cache: bool = True, device=None):
    """Compile a tree or `Forest` into a functional (spec, params) pair with
    params on `device`.

    `reweightable=True` additionally records the (pivot, representative,
    LCA) tables and root-path edge CSR that let `reweight(spec, edge_w)`
    re-derive `params` differentiably from edge weights — at the cost of
    per-vertex (uncollapsed) distance groups and no grid/Hankel engine."""
    from repro_torch.graphs.graph import Forest

    dev = resolve_device(device)
    if isinstance(tree_or_forest, Forest):
        plan = compile_forest_plan(
            tree_or_forest, leaf_size=leaf_size, seed=seed,
            detect_grid_spacing=detect_grid_spacing, use_cache=use_cache,
            reweightable=reweightable)
    else:
        plan = compile_plan(
            tree_or_forest, leaf_size=leaf_size, seed=seed,
            detect_grid_spacing=detect_grid_spacing, use_cache=use_cache,
            reweightable=reweightable)
    return specialize(plan, dev)


# ----------------------------------------------------------------------------
# batched cross engines (the plain, non-kernel engines)
# ----------------------------------------------------------------------------


def chebyshev_batched_matvec(fn_eval, tgt_d, tgt_mask, src_d, src_mask, Xp,
                             degree: int = 32):
    """Batched low-rank multiply via per-node 2D Chebyshev interpolation."""
    big = 1e30
    x_lo = torch.where(tgt_mask, tgt_d, big).amin(dim=1)  # (B,)
    x_hi = torch.where(tgt_mask, tgt_d, -big).amax(dim=1)
    y_lo = torch.where(src_mask, src_d, big).amin(dim=1)
    y_hi = torch.where(src_mask, src_d, -big).amax(dim=1)
    r = degree
    k = np.arange(r)
    t = _host_table(np.cos((2 * k + 1) * np.pi / (2 * r)), tgt_d)  # (r,)
    xc = (x_lo[:, None] + x_hi[:, None]) / 2 + (x_hi - x_lo)[:, None] / 2 * t
    yc = (y_lo[:, None] + y_hi[:, None]) / 2 + (y_hi - y_lo)[:, None] / 2 * t
    Bmat = fn_eval(xc[:, :, None] + yc[:, None, :])  # (B, r, r)
    Lx = _lagrange_batched(tgt_d, xc)  # (B, Kx, r)
    Ly = _lagrange_batched(src_d, yc)  # (B, Ky, r)
    tmp = torch.einsum("bkr,bkd->brd", Ly, Xp)
    tmp = torch.einsum("bqr,brd->bqd", Bmat, tmp)
    return torch.einsum("bkq,bqd->bkd", Lx, tmp)


def _host_table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy table on `like`'s device in its dtype, cast on the host: a
    graph trace then holds the table in that dtype, not as numpy's
    float64 (the values are the same either way)."""
    dt = np.dtype(str(like.dtype).removeprefix("torch."))
    return torch.from_numpy(np.asarray(a, dtype=dt)).to(like.device)


def _lagrange_batched(pts, nodes):
    r = nodes.shape[1]
    k = np.arange(r)
    w = _host_table(((-1.0) ** k) * np.sin((2 * k + 1) * np.pi / (2 * r)),
                    pts)  # (r,)
    diff = pts[:, :, None] - nodes[:, None, :]  # (B, K, r)
    small = diff.abs() < 1e-12
    diff = torch.where(small, 1.0, diff)
    terms = w[None, None, :] / diff
    L = terms / terms.sum(dim=-1, keepdim=True)
    any_small = small.any(dim=-1, keepdim=True)
    return torch.where(any_small, small.to(L.dtype), L)


def polynomial_batched_matvec(coeffs, tgt_d, tgt_mask, src_d, src_mask, Xp):
    """Exact batched multiply for f = polynomial(coeffs).
    O((Kt+Ks) * deg) per node."""
    coeffs = torch.as_tensor(coeffs, dtype=Xp.dtype, device=Xp.device)
    Bdeg = coeffs.shape[0] - 1
    xpow = _powers_b(tgt_d, Bdeg)  # (B, Kt, deg+1)
    ypow = _powers_b(src_d, Bdeg)  # (B, Ks, deg+1)
    ypow = ypow * src_mask[:, :, None]
    S = torch.einsum("bku,bkd->bud", ypow, Xp)  # (B, deg+1, d)
    Wrows = []
    for l in range(Bdeg + 1):
        acc = 0.0
        for tt in range(l, Bdeg + 1):
            acc = acc + coeffs[tt] * math.comb(tt, l) * S[:, tt - l]
        Wrows.append(acc)
    W = torch.stack(Wrows, dim=1)  # (B, deg+1, d)
    return torch.einsum("bkl,bld->bkd", xpow, W)


def _powers_b(x, B):
    pows = [torch.ones_like(x)]
    for _ in range(B):
        pows.append(pows[-1] * x)
    return torch.stack(pows, dim=-1)


def exponential_batched_matvec(lam, scale, tgt_d, tgt_mask, src_d, src_mask,
                               Xp):
    """Exact rank-1 multiply for f = scale * exp(lam s), numerically shifted.
    Padded source groups carry zero mass in Xp. The shift m is taken over
    the live groups; padded groups are evaluated at the shift itself
    (exp(0)) before the mask zeroes them, and a row with no live group (a
    job emptied by `update_plan`'s deletes) shifts by 0, so no exp
    overflows into an inf * 0 in the values or in their gradient."""
    ly = lam * src_d  # (B, Us)
    m = torch.where(src_mask, ly, -math.inf).amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(torch.where(src_mask, ly, m) - m) * src_mask
    t = torch.einsum("bu,bud->bd", e, Xp)  # (B, d)
    return scale * torch.exp(lam * tgt_d + m)[:, :, None] * t[:, None, :]


def hankel_batched_matvec(fn_eval, h: float, it: np.ndarray, isrc: np.ndarray,
                          it_t: torch.Tensor, isrc_t: torch.Tensor, Xp):
    """Exact multiply for ANY f on grid-aligned distances (spacing h).

    `it`/`isrc` are the integer grid indices of the build-time (host numpy)
    target/source distances, `it_t`/`isrc_t` their device copies: M embeds
    into a Hankel matrix and the multiply becomes an FFT correlation with
    F[k] = f(k h) — the paper's rational-weight embedding (App. A.2.3),
    batched over IT nodes."""
    Ms = int(isrc.max()) + 1 if isrc.size else 1
    L = (int(it.max()) if it.size else 0) + Ms  # covers all k + m
    return hankel_grid_matvec(fn_eval, h, it_t, isrc_t, Xp, L, Ms)


def hankel_grid_matvec(fn_eval, h: float, it_t: torch.Tensor,
                       isrc_t: torch.Tensor, Xp, L: int, Ms: int):
    """The Hankel-FFT multiply of `hankel_batched_matvec` with the
    transform sizes given: L grid values of f, Ms source grid slots (the
    sharded executor passes a bucket's global sizes with one rank's
    rows)."""
    F = fn_eval(h * torch.arange(L, dtype=Xp.dtype, device=Xp.device))  # (L,)
    B, Us, d = Xp.shape
    # scatter source mass onto the grid: P[b, m] = sum_{u: isrc[b,u]=m} Xp[b,u]
    rows = (torch.arange(B, device=Xp.device)[:, None] * Ms + isrc_t)
    P = Xp.new_zeros(B * Ms, d).index_add_(0, rows.reshape(-1),
                                           Xp.reshape(-1, d))
    P = P.reshape(B, Ms, d)
    n = 1 << int(np.ceil(np.log2(L + Ms)))
    Ff = torch.fft.rfft(F, n=n)  # (n//2+1,)
    Pf = torch.fft.rfft(P.flip(1), n=n, dim=1)  # (B, n//2+1, d)
    full = torch.fft.irfft(Ff[None, :, None] * Pf, n=n, dim=1)
    out_full = full[:, Ms - 1: Ms - 1 + L]  # (B, L, d): out[b,k]=sum F[k+m]P[m]
    return torch.gather(out_full, 1,
                        it_t[:, :, None].expand(-1, -1, d))


# ----------------------------------------------------------------------------
# engine selection + the executor
# ----------------------------------------------------------------------------


def select_cross(spec: PlanSpec, fspec: FamilySpec, backend: str = "torch",
                 degree: int = 32):
    """(engine_name, cross_multiply) for this (spec, f-family, backend).

    cross_multiply(i, tgt_d, tgt_mask, src_d, src_mask, Xp) -> (B, Ut, d)
    receives the bucket index plus the *params* distance arrays and the
    device tables' masks, so every engine but the grid/Hankel one
    differentiates into reweighted distances.

    `backend="auto"` resolves by the plan's size alone
    (`ladder.auto_backend`): "cuda" from `ladder.AUTO_CUDA_MIN_N` vertices
    up, else "torch"."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: choose from {BACKENDS}")
    if backend == "auto":
        from repro_torch.core import ladder

        backend = ladder.auto_backend(spec.n)
    if backend == "cuda" and fspec.mode in KERNEL_MODES:
        from repro_torch.kernels.fdist_matvec.ops import fdist_matvec_batched

        coeffs = torch.from_numpy(np.asarray(fspec.coeffs, np.float32))
        mode, scale = fspec.mode, fspec.scale
        coeffs_on: dict = {}

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            dev = tgt_d.device
            if dev not in coeffs_on:
                coeffs_on[dev] = coeffs.to(dev)
            out = fdist_matvec_batched(
                tgt_d.float().contiguous(), src_d.float().contiguous(),
                Xp.float().contiguous(), coeffs_on[dev], mode=mode)
            # the kernel's rational family is unit-scaled: 1 / (1 + c0 s^2)
            return out * scale if mode == "rational" else out

        return f"fdist_matvec:{fspec.mode}", cross
    if fspec.mode == "poly":
        cs = fspec.coeffs

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            return polynomial_batched_matvec(cs, tgt_d, tgt_mask, src_d,
                                             src_mask, Xp)

        return "polynomial", cross
    if fspec.mode == "exp":
        lam, scale = fspec.coeffs

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            return exponential_batched_matvec(lam, scale, tgt_d, tgt_mask,
                                              src_d, src_mask, Xp)

        return "exponential", cross
    if spec.grid_h is not None and not spec.reweightable:
        h, fe = spec.grid_h, fspec.fn_eval

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            t = _device_tables(spec, Xp.device)
            return hankel_batched_matvec(
                fe, h, t["grid_tgt"][i], t["grid_src"][i],
                t["grid_tgt_t"][i], t["grid_src_t"][i], Xp)

        return "hankel_fft", cross
    fe = fspec.fn_eval

    def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
        return chebyshev_batched_matvec(fe, tgt_d, tgt_mask, src_d, src_mask,
                                        Xp, degree=degree)

    return "chebyshev", cross


def _execute(spec: PlanSpec, params: PlanParams, fn_eval: Callable,
             cross_multiply: Callable, X: torch.Tensor):
    """The fused executor: one gather + segment-sum (Eq. 3), one cross
    dispatch per size bucket, one gather + scatter-add (Eq. 4), diagonal
    corrections, per-tree output weights. Everything dynamic comes from
    `params`; everything indexing/shaping from `spec`. X, params and the
    result share one device."""
    t = _device_tables(spec, X.device)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    d = X.shape[1]
    Xpad = torch.cat([X, X.new_zeros(1, d)], dim=0)
    out = torch.zeros_like(Xpad)

    for i in range(len(spec.leaf_ids)):
        ids, mask = t["leaf_ids"][i], t["leaf_mask"][i]
        Xl = Xpad[ids]  # (B, K, d)
        M = fn_eval(params.leaf_dists[i])  # (B, K, K)
        M = torch.where(t["leaf_pair_mask"][i], M, 0.0)
        contrib = torch.bmm(M, Xl) * mask[:, :, None]
        out.index_add_(0, ids.reshape(-1), contrib.reshape(-1, d))

    if spec.n_src_groups:
        # Eq. 3 for every node at once: X'[g] = sum of source-vertex fields
        # per distance group (pivot/pad groups are empty -> zero)
        Xp_flat = X.new_zeros(spec.n_src_groups, d).index_add_(
            0, t["src_seg"], Xpad[t["src_gather"]])
        parts = []
        for i in range(len(spec.cross_src_mask)):
            B, Us = spec.cross_src_mask[i].shape
            Ut = spec.cross_tgt_mask[i].shape[1]
            off = spec.cross_src_off[i]
            Xp = Xp_flat[off:off + B * Us].reshape(B, Us, d)
            res = cross_multiply(
                i, params.cross_tgt_d[i], t["cross_tgt_mask"][i],
                params.cross_src_d[i], t["cross_src_mask"][i], Xp)
            parts.append(res.reshape(B * Ut, d))
        cross_flat = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        # Eq. 4 for every node at once: gather each target's group value and
        # scatter-add into the output field
        out.index_add_(0, t["tgt_scatter"], cross_flat[t["tgt_gather"]])

    # diagonal corrections: -f(0) X[p] once per internal node
    f0 = fn_eval(X.new_zeros(1))[0]
    out.index_add_(0, t["pivots"], -f0 * Xpad[t["pivots"]])

    res = out[:-1]
    if params.tree_w is not None:
        w = torch.repeat_interleave(params.tree_w, t["tree_sizes"],
                                    output_size=spec.n)
        res = res * w[:, None].to(res.dtype)
    return res[:, 0] if squeeze else res


def _fspec(fn) -> FamilySpec:
    return fn if isinstance(fn, FamilySpec) else spec_of(fn)


def apply(spec: PlanSpec, params: PlanParams, fn, X, *,
          backend: str = "torch", degree: int = 32, device=None, mesh=None,
          axis: str | None = None):
    """Integration: Y = M_f X with distances/weights from `params`.

    `fn` is a CordialFn, FamilySpec, or torch-evaluable callable. `backend`
    picks the cross-engine family: "torch" (exact LDR + Hankel on grids +
    Chebyshev) or "cuda" (the fdist_matvec kernel for the in-kernel
    families). X (numpy or torch, (n,) or (n, d)) and params are moved to
    `device` as float32.

    `mesh` (a `DeviceMesh`, optionally with `axis`) routes through the
    multi-rank executor — see `plan_shard.apply_sharded`: X is then a
    DTensor field sharded by rows or the whole field, and Y each rank's
    rows, a DTensor sharded by rows over the plan axis (`full_tensor()`
    gathers it)."""
    if mesh is not None:
        from repro_torch.core.plan_shard import apply_sharded

        return apply_sharded(spec, params, fn, X, mesh=mesh, axis=axis,
                             backend=backend, degree=degree, device=device)
    return fastmult(spec, fn, backend=backend, degree=degree,
                    device=device)(params, X)


def fastmult(spec: PlanSpec, fn, *, backend: str = "torch", degree: int = 32,
             device=None) -> Callable:
    """(params, X) -> Y closure with the engine choice and device baked
    in. Its first call at each field shape records `ftfi.fastmult` in
    `analysis.trace_guard`, where the reference's jitted closure traces."""
    from repro_torch.analysis import trace_guard

    dev = resolve_device(device)
    fspec = _fspec(fn)
    _, cross = select_cross(spec, fspec, backend=backend, degree=degree)
    fe = fspec.fn_eval
    seen: set = set()

    def fm(params, X):
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if X.shape not in seen:
            seen.add(X.shape)
            trace_guard.record("ftfi.fastmult", detail=spec.digest[:12])
        return _execute(spec, _params_on(params, dev), fe, cross, X)

    return fm


def describe(spec: PlanSpec, fn, backend: str = "torch", degree: int = 32
             ) -> dict:
    name, _ = select_cross(spec, _fspec(fn), backend=backend, degree=degree)
    return {"api": "ftfi", "backend": backend, "cross_engine": name,
            "grid_h": spec.grid_h, "num_trees": spec.num_trees,
            "reweightable": spec.reweightable}


# ----------------------------------------------------------------------------
# reweight: edge weights -> PlanParams (differentiable)
# ----------------------------------------------------------------------------


def reweight(spec: PlanSpec, edge_w, tree_w=None) -> PlanParams:
    """Re-derive every plan distance from edge weights, differentiably.

    depth[v] = sum of edge weights on v's root path (one gather +
    `index_add_` over the spec's root-path CSR), then every distance slot
    is d(u, v) = depth[u] + depth[v] - 2 depth[lca(u, v)] via the
    build-time (pivot, representative, LCA) tables. Exact for ANY positive
    weights on the same topology — the IT decomposition is combinatorial —
    so tree metrics become learnable parameters: the result feeds `apply`
    / `fastmult` on either backend, and autograd carries the loss back into
    `edge_w`. Requires `build(..., reweightable=True)`.

    `edge_w` is a (num_edges,) tensor (or array) in packed per-tree edge
    order (the concatenation of each tree's `weights` array); the params
    land on its device, in its dtype. `tree_w` optionally sets per-tree
    output weights on the returned params."""
    if spec.path_rows is None:
        raise ValueError(
            "spec was not built with reweightable=True: rebuild via "
            "ftfi.build(tree, reweightable=True) to record the distance "
            "derivation tables")
    edge_w = torch.as_tensor(edge_w)
    if tuple(edge_w.shape) != (spec.num_edges,):
        raise ValueError(
            f"edge_w must have shape ({spec.num_edges},) — packed per-tree "
            f"edge order — got {tuple(edge_w.shape)}")
    t = _reweight_tables(spec, edge_w.device)
    depth = edge_w.new_zeros(spec.n + 1).index_add_(
        0, t["path_rows"], edge_w.index_select(0, t["path_edges"]))
    # (row n: the pad, depth 0.) Gathers by index_select: its backward is
    # one index_add_, where a subscript's (index_put_ with accumulate)
    # sorts its indices and serializes the many repeats of a pivot

    def _at(idx):
        return depth.index_select(0, idx.reshape(-1)).view(idx.shape)

    def _pair(u, v, l):
        return _at(u) + _at(v) - 2.0 * _at(l)

    ctd = tuple(_pair(p, tr, tl) for p, tr, tl, _, _ in t["cross"])
    csd = tuple(_pair(p, sr, sl) for p, _, _, sr, sl in t["cross"])
    ld = tuple(_pair(u, v, l) for u, v, l in t["leaf"])
    return PlanParams(cross_tgt_d=ctd, cross_src_d=csd, leaf_dists=ld,
                      tree_w=None if tree_w is None
                      else torch.as_tensor(tree_w, device=edge_w.device))


# ----------------------------------------------------------------------------
# serialization: the reference's npz artifact (schema 4, no pickle)
# ----------------------------------------------------------------------------

_SPEC_ARRAY_FIELDS = ("pivots", "src_gather", "src_seg", "tgt_gather",
                      "tgt_scatter", "path_rows", "path_edges",
                      "children", "root_refs", "job_bucket", "job_row",
                      "leaf_bucket", "leaf_row", "edges_u", "edges_v",
                      "edge_w0", "ghosts")
_SPEC_TUPLE_FIELDS = ("cross_tgt_mask", "cross_src_mask", "cross_tgt_d0",
                      "cross_src_d0", "leaf_ids", "leaf_mask", "leaf_dists0",
                      "cross_piv", "cross_tgt_rep", "cross_tgt_lca",
                      "cross_src_rep", "cross_src_lca", "leaf_lca")
_SPEC_SCALAR_FIELDS = ("n", "num_trees", "tree_sizes", "leaf_size", "seed",
                       "fingerprint", "grid_h", "reweightable",
                       "cross_src_off", "cross_tgt_off", "n_src_groups",
                       "n_tgt_groups", "num_cross_jobs", "num_edges",
                       "mesh_devices", "mesh_axes", "shard_layout")
# absent in pre-schema-3 artifacts; the loader falls back to these
_SPEC_SCALAR_DEFAULTS = {"mesh_devices": 0, "mesh_axes": (),
                         "shard_layout": 0}
_PARAM_TUPLE_FIELDS = ("cross_tgt_d", "cross_src_d", "leaf_dists")


def save_plan(path, spec: PlanSpec, params: PlanParams, *,
              mesh=None) -> None:
    """Serialize (spec, params) to one .npz artifact (no pickle), in the
    reference's format: either package loads the other's artifacts.

    `mesh` (a `DeviceMesh`) stamps mesh/device provenance (device count,
    axis names, shard layout version) into the artifact: loading it where
    that mesh cannot be formed then fails fast in `plan_guard` /
    `apply_sharded` instead of crashing at gather time."""
    if mesh is not None:
        from repro_torch.core.plan_shard import SHARD_LAYOUT_VERSION
        from repro_torch.launch import sharding

        spec = dataclasses.replace(
            spec, mesh_devices=sharding.mesh_size(mesh),
            mesh_axes=tuple(str(a) for a in sharding.mesh_axes(mesh)),
            shard_layout=SHARD_LAYOUT_VERSION)
    arrays: dict = {}
    meta: dict = {"version": _SAVE_VERSION}
    for name in _SPEC_SCALAR_FIELDS:
        meta[name] = getattr(spec, name)
    for name in _SPEC_ARRAY_FIELDS:
        val = getattr(spec, name)
        meta[f"has_{name}"] = val is not None
        if val is not None:
            arrays[f"s_{name}"] = val
    for name in _SPEC_TUPLE_FIELDS:
        val = getattr(spec, name)
        meta[f"len_{name}"] = -1 if val is None else len(val)
        if val is not None:
            for i, a in enumerate(val):
                arrays[f"s_{name}_{i}"] = a
    for name in _PARAM_TUPLE_FIELDS:
        for i, a in enumerate(getattr(params, name)):
            arrays[f"p_{name}_{i}"] = _to_numpy(a)
    meta["has_tree_w"] = params.tree_w is not None
    if params.tree_w is not None:
        arrays["p_tree_w"] = _to_numpy(params.tree_w)
    arrays["__meta__"] = np.array(json.dumps(meta))
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_plan(path, device=None, validate: bool = True):
    """Deserialize a `save_plan` artifact (this package's or the
    reference's) -> (spec, params on `device`). Never touches the IT/plan
    builders.

    The artifact is untrusted input: a torn zip, a missing member or
    mangled metadata always raises `PlanValidationError`. Index tables
    saved as int64 (the reference's schema <= 3) are downcast to int32,
    bounds-guarded. `validate=True` (default) then runs the full
    `plan_guard` bounds/consistency pass under the configured policy
    (`FTFI_PLAN_GUARD`), before any params reach the device."""
    dev = resolve_device(device)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"][()]))
            if meta.get("version") != _SAVE_VERSION:
                raise PlanValidationError(
                    f"unsupported plan artifact version: "
                    f"{meta.get('version')!r}")
            kwargs: dict = {}
            for name in _SPEC_SCALAR_FIELDS:
                val = meta.get(name, _SPEC_SCALAR_DEFAULTS.get(name))
                if isinstance(val, list):
                    val = tuple(val)
                kwargs[name] = val
            for name in _SPEC_ARRAY_FIELDS:
                kwargs[name] = (z[f"s_{name}"]
                                if meta.get(f"has_{name}", False) else None)
            for name in _SPEC_TUPLE_FIELDS:
                ln = meta[f"len_{name}"]
                kwargs[name] = (None if ln < 0 else
                                tuple(z[f"s_{name}_{i}"] for i in range(ln)))
            spec = PlanSpec(**kwargs)
            nb = meta["len_cross_tgt_d0"]
            nl = meta["len_leaf_dists0"]
            fields = {
                "cross_tgt_d": tuple(z[f"p_cross_tgt_d_{i}"]
                                     for i in range(nb)),
                "cross_src_d": tuple(z[f"p_cross_src_d_{i}"]
                                     for i in range(nb)),
                "leaf_dists": tuple(z[f"p_leaf_dists_{i}"]
                                    for i in range(nl)),
                "tree_w": z["p_tree_w"] if meta["has_tree_w"] else None,
            }
    except PlanValidationError:
        raise
    except Exception as e:
        # torn zip / missing npz member / mangled json / wrong field: one
        # clear error class so callers reject cleanly
        raise PlanValidationError(
            f"load_plan({path!s}): corrupt or truncated plan artifact "
            f"({type(e).__name__}: {e})") from e
    spec, _ = plan_guard.coerce_index_dtypes(spec)
    params = PlanParams(**fields)
    if validate:
        plan_guard.validate(spec, params, where=f"load_plan({path!s})")
    return spec, _params_on(params, dev)


def from_numpy(spec_fields: dict, params_fields: dict, device=None):
    """Build a (spec, params) pair from the numpy arrays of a live reference
    pair: `spec_fields` maps every PlanSpec field name to its value (numpy
    arrays, tuples of them, Python scalars), `params_fields` maps
    cross_tgt_d / cross_src_d / leaf_dists (sequences of arrays) and,
    optionally, tree_w. Values are copied bit for bit; params land on
    `device` as float32."""
    names = {f.name for f in dataclasses.fields(PlanSpec)}
    if set(spec_fields) != names:
        raise ValueError(
            f"spec_fields must name every PlanSpec field: missing "
            f"{sorted(names - set(spec_fields))}, unknown "
            f"{sorted(set(spec_fields) - names)}")
    spec = PlanSpec(**{k: (tuple(np.asarray(a) for a in v)
                           if k in _SPEC_TUPLE_FIELDS and v is not None
                           else v)
                       for k, v in spec_fields.items()})
    unknown = set(params_fields) - set(_PARAM_TUPLE_FIELDS) - {"tree_w"}
    if unknown or not set(_PARAM_TUPLE_FIELDS) <= set(params_fields):
        raise ValueError(
            f"params_fields must hold {_PARAM_TUPLE_FIELDS} (and optionally "
            f"tree_w), got {sorted(params_fields)}")
    tree_w = params_fields.get("tree_w")
    params = PlanParams(
        **{k: tuple(np.asarray(a) for a in params_fields[k])
           for k in _PARAM_TUPLE_FIELDS},
        tree_w=None if tree_w is None else np.asarray(tree_w))
    return spec, _params_on(params, resolve_device(device))


# incremental edits live in their own module but belong to this API surface
# (imported at the bottom: plan_update imports this module)
from repro_torch.core.plan_update import update_plan  # noqa: E402,F401
