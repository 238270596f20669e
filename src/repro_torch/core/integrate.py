"""Tree-field integration: the BTFI oracle, the recursive host FTFI, the
ExpMP message-passing integrator, and the plan data (compile_plan). The
plan *executor* lives in `repro_torch.core.plan_api`; the public entry
point is `repro_torch.core.engines.Integrator`.

Correctness invariant: the *additive* decomposition counts every ordered
pair (v, j) exactly once.

  At internal node nu with children L, R sharing pivot p:
    - recursion on L covers pairs L x L; on R covers R x R;
    - the two cross jobs cover (L\\{p}) x (R\\{p}) and (R\\{p}) x (L\\{p})
      (targets and sources both exclude the pivot);
    - the only overlap is the diagonal pair (p, p), counted twice ->
      one correction of -f(0) X[p] per internal node.
  Across the whole IT: two distinct leaves intersect in at most one vertex
  (a shared pivot), so off-diagonal pairs are never double counted by leaves;
  a pair (u, v), u != v is separated at exactly one IT node (their "meet"),
  so it is covered by exactly one cross job or exactly one leaf; diagonal
  pairs (v, v) appear once per leaf containing v = 1 + #(nodes where v is
  pivot), matched by the per-node corrections.

The recursive evaluator (FTFI) follows the paper's Eq. 2-4 verbatim (pivot
kept in the source group, subtracted via the f(left-d[tau(v)]) X'[0]
correction); the plan executor uses the optimized masked-source form. Both
are validated against the dense BTFI oracle.

The host-side plan builder here is the reference's, array for array: the
same tree gives a bitwise-identical plan, so `PlanSpec.digest` agrees
across the two packages.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.cordial import CordialFn
from repro_torch.core.integrator_tree import ITNode, build_integrator_tree
from repro_torch.core.itree_flat import (_ranges, build_flat_forest,
                                         build_flat_it, tree_fingerprint)
from repro_torch.core.lru import BoundedLRU
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import WeightedTree
from repro_torch.graphs.traverse import (TreeLCA, tree_all_pairs,
                                         tree_bfs_order)

# ----------------------------------------------------------------------------
# BTFI: brute-force oracle (paper's baseline)
# ----------------------------------------------------------------------------


class BTFI:
    """Materialize M_f = f(all-pairs tree distances); multiply densely.

    The distances are computed in float64 on the host, then held on
    `device` in `dtype`."""

    def __init__(self, tree: WeightedTree, dtype=torch.float32, device=None):
        self.dists = torch.as_tensor(tree_all_pairs(tree), dtype=dtype,
                                     device=resolve_device(device))

    def integrate(self, fn, X) -> torch.Tensor:
        from repro_torch.core.engines.spec import spec_of

        X = torch.as_tensor(X, dtype=self.dists.dtype,
                            device=self.dists.device)
        return spec_of(fn).fn_eval(self.dists) @ X


def _acc_dtype(X: np.ndarray):
    """float32 fields stay float32 (the walks are bandwidth-bound), every
    other dtype accumulates in float64."""
    return X.dtype if X.dtype in (np.float32, np.float64) else np.float64


# ----------------------------------------------------------------------------
# FTFI: recursive exact integrator (host / numpy)
# ----------------------------------------------------------------------------


class FTFI:
    """Fast tree-field integrator on the host. Preprocessing = IT
    construction (once); `integrate(fn, X)` is exact for any CordialFn,
    through each node's structured multiply (`fn.matvec`)."""

    def __init__(self, tree: WeightedTree, leaf_size: int = 64, seed: int = 0):
        self.n = tree.num_vertices
        self.root = build_integrator_tree(tree, leaf_size=leaf_size, seed=seed)

    def integrate(self, fn: CordialFn, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        out = np.zeros_like(X, dtype=_acc_dtype(X))
        self._walk(self.root, fn, X, out)
        return out[:, 0] if squeeze else out

    def _walk(self, node: ITNode, fn: CordialFn, X: np.ndarray,
              out: np.ndarray):
        if node.is_leaf:
            out[node.vertex_ids] += fn(node.leaf_dists) @ X[node.vertex_ids]
            return
        p = node.pivot
        # the segment layouts were made at build time: ITNode is immutable,
        # so the walk is thread-safe and plans can share one IT
        for src_sorted, starts, tgt_ids, tgt_id_d, tgt_d, src_d in (
            (node.right_sorted_ids, node.right_seg_starts,
             node.left_ids, node.left_id_d, node.left_d, node.right_d),
            (node.left_sorted_ids, node.left_seg_starts,
             node.right_ids, node.right_id_d, node.right_d, node.left_d),
        ):
            # X'[u] = sum over source vertices in distance-group u (Eq. 3);
            # the pivot IS included (group 0), per the paper.
            Xp = np.add.reduceat(X[src_sorted], starts, axis=0).astype(
                out.dtype)
            # cross values per target distance-group: C @ X' (Eq. 4)
            cross = fn.matvec(tgt_d, src_d, Xp)  # (U_tgt, d)
            # Eq. 4 correction: remove the source-pivot column f(tgt_d) X'[0]
            vals = cross - fn(tgt_d)[:, None] * Xp[0][None, :]
            # targets exclude the pivot (tgt_ids[0] == pivot by construction)
            out[tgt_ids[1:]] += vals[tgt_id_d[1:]]
        out[p] -= fn.f0 * X[p]  # diagonal (p, p) double-count correction
        self._walk(node.left, fn, X, out)
        self._walk(node.right, fn, X, out)


# ----------------------------------------------------------------------------
# Exponential-kernel specialization: two-pass message passing
# ----------------------------------------------------------------------------


class ExpMP:
    """Exact integrator for f(x) = scale * exp(lam * x) on a weighted tree
    via the classic up/down sweep:

      up[v]   = X_v + sum_c e^{lam w_c} up[c]          (subtree mass)
      down[c] = e^{lam w_c} (down[p] + up[p] - e^{lam w_c} up[c])
      out[v]  = up[v] + down[v]

    Two passes over (N, d), O(N d) time, no IT needed: the rank-1
    cordiality of exp pushed to its limit."""

    def __init__(self, tree: WeightedTree, root: int = 0):
        self.order, self.parent, self.parent_w = tree_bfs_order(tree, root)

    def integrate(self, lam: float, X: np.ndarray, scale: float = 1.0):
        X = np.asarray(X)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        order, parent = self.order, self.parent
        e = np.exp(lam * self.parent_w)  # per-vertex edge factor to parent
        up = X.astype(_acc_dtype(X)).copy()
        for v in order[::-1]:
            pv = parent[v]
            if pv >= 0:
                up[pv] += e[v] * up[v]
        down = np.zeros_like(up)
        for v in order[1:]:
            pv = parent[v]
            down[v] = e[v] * (down[pv] + up[pv] - e[v] * up[v])
        out = scale * (up + down)
        return out[:, 0] if squeeze else out


# ----------------------------------------------------------------------------
# Plan compilation: flatten the IT into padded, bucketed, static arrays plus
# concatenated gather/segment/scatter index plans for the fused executor
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class CrossBucket:
    """Group-distance arrays for one size bucket, padded to the bucket maxima
    (the cross-engine inputs). The per-vertex gather/scatter plumbing lives in
    the flat index arrays on `IntegrationPlan`; `src_off`/`tgt_off` locate
    this bucket's (B*U) group block inside those flat layouts.

    `piv` / `tgt_rep` / `src_rep` (reweightable builds only) record, per
    job row, the pivot vertex and one representative vertex per distance
    group (padding repeats the pivot, whose pivot-distance is 0 like the
    original padding): d[b, u] = dist(piv[b], rep[b, u])."""

    tgt_d: np.ndarray  # (B, U_t) float
    tgt_d_mask: np.ndarray  # (B, U_t) bool
    src_d: np.ndarray  # (B, U_s) float
    src_d_mask: np.ndarray  # (B, U_s) bool
    src_off: int = 0  # offset of this bucket's B*U_s groups in the flat X'
    tgt_off: int = 0  # offset of this bucket's B*U_t groups in the flat cross
    piv: np.ndarray | None = None  # (B,) pivot vertex per job row
    tgt_rep: np.ndarray | None = None  # (B, U_t) group representative vertex
    src_rep: np.ndarray | None = None  # (B, U_s)


@dataclasses.dataclass
class LeafBucket:
    ids: np.ndarray  # (B, K)
    mask: np.ndarray  # (B, K)
    dists: np.ndarray  # (B, K, K)


@dataclasses.dataclass
class IntegrationPlan:
    """Static integration plan. Beyond the padded per-bucket engine inputs,
    the whole executor data-flow is precompiled into four flat index arrays:

      X'_flat  = segment_sum(Xpad[src_gather], src_seg)   # one gather+segsum
      cross    = per-bucket engine on X'_flat slices       # one dispatch each
      out     += scatter_add at tgt_scatter of cross[tgt_gather]
    """

    n: int
    cross_buckets: list
    leaf_buckets: list
    pivots: np.ndarray  # (P,) vertex ids, one per internal node (with repeats)
    grid_h: float | None = None  # common distance grid (if any) for hankel engine
    # fused executor index arrays (real entries only — no padding, no masks)
    src_gather: np.ndarray | None = None  # (S,) vertex ids into Xpad
    src_seg: np.ndarray | None = None  # (S,) flat source-group index
    n_src_groups: int = 0  # sum over buckets of B*U_s
    tgt_gather: np.ndarray | None = None  # (T,) flat cross-group index
    tgt_scatter: np.ndarray | None = None  # (T,) vertex ids into out
    n_tgt_groups: int = 0  # sum over buckets of B*U_t
    num_cross_jobs: int = 0
    # provenance (stamped by compile_plan / compile_forest_plan): the
    # functional PlanSpec carries these across process/device boundaries
    fingerprint: str = ""
    leaf_size: int = 0
    seed: int = 0
    tree_sizes: tuple = ()
    reweightable: bool = False
    rw: dict | None = None  # reweight tables (LCA + root-path CSR)
    # update tables (stamped by _assemble_plan): IT skeleton + the
    # (bucket, row) coordinates of every cross job and leaf
    upd: dict | None = None


_PLAN_CACHE = BoundedLRU(32)


def clear_plan_cache() -> None:
    """Drop the in-memory compiled plans (and the specs memoized on them,
    with their device tables)."""
    _PLAN_CACHE.clear()


def _upd_tables(flat, job_bucket, job_row, leaf_bucket, leaf_row) -> dict:
    """Update tables: the IT skeleton (children refs + per-tree roots) and
    the (bucket, row) coordinate of every cross job / leaf. Kept so the
    plan carries the reference's full PlanSpec (`update_plan` walks a
    vertex's IT chain with them)."""
    root_refs = (flat.root_refs if flat.root_refs is not None
                 else np.array([flat.root_ref], np.int64))
    return {"children": flat.children.astype(np.int32),
            "root_refs": np.asarray(root_refs).astype(np.int32),
            "job_bucket": np.asarray(job_bucket, np.int32),
            "job_row": np.asarray(job_row, np.int32),
            "leaf_bucket": np.asarray(leaf_bucket, np.int32),
            "leaf_row": np.asarray(leaf_row, np.int32)}


def _assemble_plan(flat, n: int, detect_grid_spacing: bool,
                   expand_groups: bool = False) -> IntegrationPlan:
    """Flatten a (tree or forest) FlatIT into one IntegrationPlan: cross jobs
    and leaves from EVERY tree share one global index space and are merged
    into the same size-class buckets, so the executor's dispatch count is a
    function of size diversity, not of how many trees the plan covers.

    Vectorized over the IT's concatenated side CSR (`FlatIT.side_cat` /
    `leaf_cat`): one stable argsort groups jobs into size-class buckets,
    `np.maximum.reduceat` yields the bucket maxima, and every padded bucket
    array plus all four flat executor index arrays fill through `_ranges`
    scatters.

    `expand_groups` (reweightable builds): every vertex is its own
    distance group and representative, so re-deriving distances per
    representative stays exact under ANY edge reweighting — two vertices
    that tie under the build weights need not tie under new ones."""
    num_i = flat.num_internal
    J = 2 * num_i
    sc = flat.side_cat
    k, u = sc["k"], sc["u"]
    kptr, uptr = sc["kptr"], sc["uptr"]
    ids_c, idd_c, d_c = sc["ids"], sc["id_d"], sc["d"]
    # job j's target side IS side j (side 2i = left, 2i+1 = right); its
    # source side is the sibling j ^ 1; both jobs of node i share its pivot
    piv_job = np.repeat(flat.pivots, 2)
    g = k if expand_groups else u  # distance-group count per side (incl piv)
    mem = k - 1  # member count per side (targets/sources exclude the pivot)

    cross_buckets = []
    job_bucket = np.zeros(J, np.int32)
    job_row = np.zeros(J, np.int32)
    src_gather = src_seg = tgt_gather = tgt_scatter = np.zeros(0, np.int64)
    src_goff = tgt_goff = 0
    if J:
        # bucket by ceil(log2(max member count)) => <=2x padding waste;
        # stable sort keeps insertion order within each bucket
        bkey = np.ceil(np.log2(np.maximum(
            np.maximum(mem, mem[np.arange(J) ^ 1]), 2))).astype(np.int64)
        order = np.argsort(bkey, kind="stable")
        sib = order ^ 1  # source side of each sorted job
        _, bstarts = np.unique(bkey[order], return_index=True)
        nb = bstarts.size
        bcounts = np.diff(np.r_[bstarts, J])
        Ut = np.maximum.reduceat(g[order], bstarts)
        Us = np.maximum.reduceat(g[sib], bstarts)
        tgt_off = np.zeros(nb + 1, np.int64)
        np.cumsum(bcounts * Ut, out=tgt_off[1:])
        src_off = np.zeros(nb + 1, np.int64)
        np.cumsum(bcounts * Us, out=src_off[1:])
        row = np.arange(J) - np.repeat(bstarts, bcounts)
        bix = np.repeat(np.arange(nb), bcounts)
        job_bucket[order] = bix
        job_row[order] = row

        if expand_groups:  # per-vertex distances: d[id_d], all sides at once
            dvert = d_c[np.repeat(uptr[:-1], k) + idd_c]
        for bi in range(nb):
            lo = int(bstarts[bi])
            hi = lo + int(bcounts[bi])
            js, ss = order[lo:hi], sib[lo:hi]
            B, Utb, Usb = hi - lo, int(Ut[bi]), int(Us[bi])
            cb = CrossBucket(
                tgt_d=np.zeros((B, Utb), dtype=np.float64),
                tgt_d_mask=np.zeros((B, Utb), dtype=bool),
                src_d=np.zeros((B, Usb), dtype=np.float64),
                src_d_mask=np.zeros((B, Usb), dtype=bool),
                src_off=int(src_off[bi]), tgt_off=int(tgt_off[bi]),
            )
            gt, gs = g[js], g[ss]
            rt = np.repeat(np.arange(B), gt)
            ct = _ranges(np.zeros(B, np.int64), gt)
            rs = np.repeat(np.arange(B), gs)
            cs = _ranges(np.zeros(B, np.int64), gs)
            if expand_groups:
                cb.tgt_d[rt, ct] = dvert[_ranges(kptr[js], gt)]
                cb.src_d[rs, cs] = dvert[_ranges(kptr[ss], gs)]
            else:
                cb.tgt_d[rt, ct] = d_c[_ranges(uptr[js], gt)]
                cb.src_d[rs, cs] = d_c[_ranges(uptr[ss], gs)]
            cb.tgt_d_mask[rt, ct] = True
            cb.src_d_mask[rs, cs] = True
            if expand_groups:  # rep tables: padding repeats the pivot
                pj = piv_job[js]
                cb.piv = pj.astype(np.int32)
                cb.tgt_rep = np.repeat(pj, Utb).reshape(B, Utb).astype(
                    np.int32)
                cb.src_rep = np.repeat(pj, Usb).reshape(B, Usb).astype(
                    np.int32)
                cb.tgt_rep[rt, ct] = ids_c[_ranges(kptr[js], gt)]
                cb.src_rep[rs, cs] = ids_c[_ranges(kptr[ss], gs)]
            cross_buckets.append(cb)
        src_goff, tgt_goff = int(src_off[-1]), int(tgt_off[-1])

        # flat executor arrays in (bucket, job) order — one concatenation
        # pass per kind instead of per-job list appends
        mem_t, mem_s = mem[order], mem[sib]
        tjob = tgt_off[bix] + row * Ut[bix]
        sjob = src_off[bix] + row * Us[bix]
        tgt_scatter = ids_c[_ranges(kptr[order] + 1, mem_t)]
        src_gather = ids_c[_ranges(kptr[sib] + 1, mem_s)]
        if expand_groups:  # expanded group index of vertex j is j itself
            tidd = _ranges(np.ones(J, np.int64), mem_t)
            sidd = _ranges(np.ones(J, np.int64), mem_s)
        else:
            tidd = idd_c[_ranges(kptr[order] + 1, mem_t)]
            sidd = idd_c[_ranges(kptr[sib] + 1, mem_s)]
        tgt_gather = np.repeat(tjob, mem_t) + tidd
        src_seg = np.repeat(sjob, mem_s) + sidd

    # --- leaf buckets by ceil(log2(k)): a mixed-size forest pads each leaf
    # to its size class, not to the global maximum
    lc = flat.leaf_cat
    lk, lptr, ldptr = lc["k"], lc["ptr"], lc["dptr"]
    Lf = lk.size
    leaf_bucket = np.zeros(Lf, np.int32)
    leaf_row = np.zeros(Lf, np.int32)
    leaf_buckets = []
    if Lf:
        lkey = np.ceil(np.log2(np.maximum(lk, 2))).astype(np.int64)
        lorder = np.argsort(lkey, kind="stable")
        _, lstarts = np.unique(lkey[lorder], return_index=True)
        lcounts = np.diff(np.r_[lstarts, Lf])
        leaf_bucket[lorder] = np.repeat(np.arange(lstarts.size), lcounts)
        leaf_row[lorder] = np.arange(Lf) - np.repeat(lstarts, lcounts)
        for bi in range(lstarts.size):
            lv = lorder[int(lstarts[bi]):int(lstarts[bi]) + int(lcounts[bi])]
            ks = lk[lv]
            B, K = lv.size, int(ks.max())
            lb = LeafBucket(
                ids=np.full((B, K), n, dtype=np.int32),
                mask=np.zeros((B, K), dtype=bool),
                dists=np.zeros((B, K, K), dtype=np.float64),
            )
            r = np.repeat(np.arange(B), ks)
            c = _ranges(np.zeros(B, np.int64), ks)
            lb.ids[r, c] = lc["ids"][_ranges(lptr[lv], ks)]
            lb.mask[r, c] = True
            # raveled (row, col) targets of every k_i x k_i block at once
            pw = _ranges(np.zeros(B, np.int64), ks * ks)
            kk = np.repeat(ks, ks * ks)
            pos = (np.repeat(np.arange(B) * K * K, ks * ks)
                   + (pw // kk) * K + pw % kk)
            lb.dists.reshape(-1)[pos] = lc["dflat"][_ranges(ldptr[lv],
                                                            ks * ks)]
            leaf_buckets.append(lb)

    h = None
    if detect_grid_spacing:
        from repro_torch.core.cordial import detect_grid
        # one detection over the merged distances reconciles per-tree grids:
        # the common h of a forest is the gcd of its trees' spacings (None if
        # any tree is off-grid or the joint span is FFT-impractical)
        all_d = np.unique(d_c) if d_c.size else np.zeros(1)
        h = detect_grid(all_d, np.zeros(1))
    return IntegrationPlan(
        n=n, cross_buckets=cross_buckets, leaf_buckets=leaf_buckets,
        pivots=flat.pivots.astype(np.int32), grid_h=h,
        src_gather=src_gather.astype(np.int32),
        src_seg=src_seg.astype(np.int32),
        n_src_groups=src_goff,
        tgt_gather=tgt_gather.astype(np.int32),
        tgt_scatter=tgt_scatter.astype(np.int32),
        n_tgt_groups=tgt_goff,
        num_cross_jobs=J,
        upd=_upd_tables(flat, job_bucket, job_row, leaf_bucket, leaf_row),
    )


def _disk_cache_load(key) -> IntegrationPlan | None:
    """Consult the disk-persistent plan cache (`core/plan_cache.py`): a hit
    is one file read turned into a plan by `plan_from_spec`, zero IT
    rebuild. None unless a cache directory is configured."""
    from repro_torch.core import plan_cache

    if not plan_cache.enabled():
        return None
    hit = plan_cache.load(plan_cache.key_str(key))
    if hit is None:
        return None
    from repro_torch.core import plan_api

    return plan_api.plan_from_spec(hit[0])


def _disk_cache_store(key, plan: IntegrationPlan) -> None:
    from repro_torch.core import plan_cache

    if not plan_cache.enabled():
        return
    from repro_torch.core import plan_api

    spec = plan_api._plan_spec(plan)
    plan_cache.store(plan_cache.key_str(key), spec,
                     plan_api._birth_params(spec, torch.device("cpu")))


def compile_plan(tree: WeightedTree, leaf_size: int = 64, seed: int = 0,
                 detect_grid_spacing: bool = True, use_cache: bool = True,
                 reweightable: bool = False) -> IntegrationPlan:
    """Compile (or fetch from the content-hash caches) the integration plan
    of one tree. `seed` is part of the cache key: differently-seeded builds
    must never alias to the first build.

    Cache hierarchy: the in-memory BoundedLRU first, then (when the
    `FTFI_PLAN_CACHE` directory is configured) the disk-persistent artifact
    cache, whose keys are the reference's: either package hits the other's
    entries. `use_cache=False` bypasses both.

    `reweightable=True` expands distance groups to per-vertex slots, skips
    grid detection (an integer grid would not survive weight training) and
    attaches the LCA / root-path tables `plan_api.reweight` re-derives
    distances from."""
    if reweightable:
        detect_grid_spacing = False
    fp = tree_fingerprint(tree)
    if use_cache:
        key = (fp, max(int(leaf_size), 6), int(seed), detect_grid_spacing,
               reweightable)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
        hit = _disk_cache_load(key)
        if hit is not None:
            _PLAN_CACHE.put(key, hit)
            return hit

    flat = build_flat_it(tree, leaf_size=leaf_size, seed=seed,
                         use_cache=use_cache)
    plan = _assemble_plan(flat, tree.num_vertices, detect_grid_spacing,
                          expand_groups=reweightable)
    plan.fingerprint = fp
    plan.leaf_size = max(int(leaf_size), 6)
    plan.seed = int(seed)
    plan.tree_sizes = (tree.num_vertices,)
    plan.reweightable = reweightable
    if reweightable:
        _attach_reweight_tables(plan, [tree])
    if use_cache:
        _PLAN_CACHE.put(key, plan)
        _disk_cache_store(key, plan)
    return plan


def compile_forest_plan(forest, leaf_size: int = 64, seed: int = 0,
                        detect_grid_spacing: bool = True,
                        use_cache: bool = True,
                        reweightable: bool = False) -> IntegrationPlan:
    """Compile a whole `Forest` into ONE IntegrationPlan.

    Per-tree plans are never materialized: the batched flat-IT build decomposes
    all trees in one level sweep, and `_assemble_plan` concatenates their cross
    jobs and leaves into a single global index space (shared `src_gather` /
    `src_seg` / `tgt_gather` / `tgt_scatter`, buckets merged across trees by
    size class, grid_h reconciled over the merged distances). The executor
    then runs the ENTIRE forest as the same handful of fused gather /
    segment-sum / scatter ops. Caches and `reweightable` as `compile_plan`.

    The packed field layout is `Forest`'s: vertex v of tree t at row
    `forest.offsets[t] + v`; the multiply is block-diagonal by construction
    (no index from one tree ever references another tree's rows)."""
    if reweightable:
        detect_grid_spacing = False
    fps = tuple(tree_fingerprint(t) for t in forest.trees)
    if use_cache:
        key = ("forest", fps, max(int(leaf_size), 6), int(seed),
               detect_grid_spacing, reweightable)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
        hit = _disk_cache_load(key)
        if hit is not None:
            _PLAN_CACHE.put(key, hit)
            return hit

    flat = build_flat_forest(forest.trees, leaf_size=leaf_size, seed=seed,
                             use_cache=use_cache)
    plan = _assemble_plan(flat, forest.num_vertices, detect_grid_spacing,
                          expand_groups=reweightable)
    plan.fingerprint = hashlib.sha1(
        "".join(fps).encode()).hexdigest()
    plan.leaf_size = max(int(leaf_size), 6)
    plan.seed = int(seed)
    plan.tree_sizes = tuple(int(s) for s in forest.tree_sizes)
    plan.reweightable = reweightable
    if reweightable:
        _attach_reweight_tables(plan, forest.trees)
    if use_cache:
        _PLAN_CACHE.put(key, plan)
        _disk_cache_store(key, plan)
    return plan


# ----------------------------------------------------------------------------
# reweight tables: everything a differentiable edge_w -> distances map needs
# ----------------------------------------------------------------------------


def _root_path_pairs(trees):
    """(rows, edges): for every vertex v (global packed id), one entry per
    edge on v's root path — so depth[v] = sum of edge_w over v's entries is
    one gather + segment-sum. Edges are numbered in packed per-tree order
    (the concatenation of each tree's `weights` arrays)."""
    rows_parts, edge_parts = [], []
    voff = eoff = 0
    for t in trees:
        n = t.num_vertices
        _, parent, _ = tree_bfs_order(t, 0)
        eu = t.edges_u.astype(np.int64)
        ev = t.edges_v.astype(np.int64)
        idx = np.arange(eu.size, dtype=np.int64)
        pe = np.full(n, -1, np.int64)  # edge to parent, per non-root vertex
        m = parent[ev] == eu
        pe[ev[m]] = idx[m]
        m = parent[eu] == ev
        pe[eu[m]] = idx[m]
        a = np.flatnonzero(parent >= 0)
        origin = a.copy()
        while a.size:  # climb all root paths one ancestor level at a time
            rows_parts.append(origin + voff)
            edge_parts.append(pe[a] + eoff)
            a = parent[a]
            keep = parent[a] >= 0  # pe[a] valid only for non-root ancestors
            origin, a = origin[keep], a[keep]
        voff += n
        eoff += eu.size
    if not rows_parts:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate(rows_parts).astype(np.int32),
            np.concatenate(edge_parts).astype(np.int32))


def _forest_lca_query(lcas, offsets, u, v):
    """Elementwise LCA of global vertex pairs (each pair within one tree)."""
    shape = u.shape
    u = np.asarray(u, np.int64).ravel()
    v = np.asarray(v, np.int64).ravel()
    out = np.empty(u.shape, np.int64)
    tid = np.searchsorted(offsets, u, side="right") - 1
    for t in np.unique(tid):
        sel = tid == t
        off = int(offsets[t])
        out[sel] = lcas[t].lca(u[sel] - off, v[sel] - off) + off
    return out.reshape(shape)


def _attach_reweight_tables(plan: IntegrationPlan, trees) -> None:
    """Stamp the LCA tables (cross + leaf) and root-path CSR onto the plan:
    with these, every distance slot is depth[u] + depth[v] - 2 depth[lca],
    a pure (differentiable) function of the edge weights."""
    sizes = np.array([t.num_vertices for t in trees], np.int64)
    offsets = np.zeros(sizes.size + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    lcas = [TreeLCA(t) for t in trees]
    n = plan.n

    ctl, csl = [], []
    for cb in plan.cross_buckets:
        pv_t = np.broadcast_to(cb.piv[:, None], cb.tgt_rep.shape)
        pv_s = np.broadcast_to(cb.piv[:, None], cb.src_rep.shape)
        ctl.append(_forest_lca_query(lcas, offsets, pv_t,
                                     cb.tgt_rep).astype(np.int32))
        csl.append(_forest_lca_query(lcas, offsets, pv_s,
                                     cb.src_rep).astype(np.int32))
    ll = []
    for lb in plan.leaf_buckets:
        B, K = lb.ids.shape
        u = np.broadcast_to(lb.ids[:, :, None].astype(np.int64), (B, K, K))
        v = np.broadcast_to(lb.ids[:, None, :].astype(np.int64), (B, K, K))
        valid = (u < n) & (v < n)
        out = np.full((B, K, K), n, np.int64)  # pad -> sentinel depth row
        if valid.any():
            out[valid] = _forest_lca_query(lcas, offsets, u[valid], v[valid])
        ll.append(out.astype(np.int32))
    rows, edges = _root_path_pairs(trees)
    # packed global edge endpoints + build weights: `update_plan` needs the
    # live edge list to validate leaf deletions and to re-derive distances
    # host-side after structural edits
    eu_parts, ev_parts, ew_parts = [], [], []
    for t, off in zip(trees, offsets[:-1]):
        eu_parts.append(t.edges_u.astype(np.int64) + off)
        ev_parts.append(t.edges_v.astype(np.int64) + off)
        ew_parts.append(t.weights.astype(np.float64))
    plan.rw = {"cross_tgt_lca": ctl, "cross_src_lca": csl, "leaf_lca": ll,
               "path_rows": rows, "path_edges": edges,
               "num_edges": int(sum(t.num_edges for t in trees)),
               "edges_u": (np.concatenate(eu_parts).astype(np.int32)
                           if eu_parts else np.zeros(0, np.int32)),
               "edges_v": (np.concatenate(ev_parts).astype(np.int32)
                           if ev_parts else np.zeros(0, np.int32)),
               "edge_w0": (np.concatenate(ew_parts)
                           if ew_parts else np.zeros(0, np.float64))}
