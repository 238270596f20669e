"""Tree-field integration: the BTFI oracle and the plan data (compile_plan).
The plan *executor* lives in `repro_torch.core.plan_api`.

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

The host-side plan builder here is the reference's, array for array: the
same tree gives a bitwise-identical plan, so `PlanSpec.digest` agrees
across the two packages.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.engines.spec import spec_of
from repro_torch.core.itree_flat import (_ranges, build_flat_forest,
                                         build_flat_it, tree_fingerprint)
from repro_torch.core.lru import BoundedLRU
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import WeightedTree
from repro_torch.graphs.traverse import tree_all_pairs

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
        X = torch.as_tensor(X, dtype=self.dists.dtype,
                            device=self.dists.device)
        return spec_of(fn).fn_eval(self.dists) @ X


# ----------------------------------------------------------------------------
# Plan compilation: flatten the IT into padded, bucketed, static arrays plus
# concatenated gather/segment/scatter index plans for the fused executor
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class CrossBucket:
    """Group-distance arrays for one size bucket, padded to the bucket maxima
    (the cross-engine inputs). The per-vertex gather/scatter plumbing lives in
    the flat index arrays on `IntegrationPlan`; `src_off`/`tgt_off` locate
    this bucket's (B*U) group block inside those flat layouts."""

    tgt_d: np.ndarray  # (B, U_t) float
    tgt_d_mask: np.ndarray  # (B, U_t) bool
    src_d: np.ndarray  # (B, U_s) float
    src_d_mask: np.ndarray  # (B, U_s) bool
    src_off: int = 0  # offset of this bucket's B*U_s groups in the flat X'
    tgt_off: int = 0  # offset of this bucket's B*U_t groups in the flat cross


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
    # update tables (stamped by _assemble_plan): IT skeleton + the
    # (bucket, row) coordinates of every cross job and leaf
    upd: dict | None = None


_PLAN_CACHE = BoundedLRU(32)


def _upd_tables(flat, job_bucket, job_row, leaf_bucket, leaf_row) -> dict:
    """Update tables: the IT skeleton (children refs + per-tree roots) and
    the (bucket, row) coordinate of every cross job / leaf. Kept so the
    plan carries the reference's full PlanSpec (incremental plan updates
    read them)."""
    root_refs = (flat.root_refs if flat.root_refs is not None
                 else np.array([flat.root_ref], np.int64))
    return {"children": flat.children.astype(np.int32),
            "root_refs": np.asarray(root_refs).astype(np.int32),
            "job_bucket": np.asarray(job_bucket, np.int32),
            "job_row": np.asarray(job_row, np.int32),
            "leaf_bucket": np.asarray(leaf_bucket, np.int32),
            "leaf_row": np.asarray(leaf_row, np.int32)}


def _assemble_plan(flat, n: int, detect_grid_spacing: bool) -> IntegrationPlan:
    """Flatten a (tree or forest) FlatIT into one IntegrationPlan: cross jobs
    and leaves from EVERY tree share one global index space and are merged
    into the same size-class buckets, so the executor's dispatch count is a
    function of size diversity, not of how many trees the plan covers.

    Vectorized over the IT's concatenated side CSR (`FlatIT.side_cat` /
    `leaf_cat`): one stable argsort groups jobs into size-class buckets,
    `np.maximum.reduceat` yields the bucket maxima, and every padded bucket
    array plus all four flat executor index arrays fill through `_ranges`
    scatters."""
    num_i = flat.num_internal
    J = 2 * num_i
    sc = flat.side_cat
    k, u = sc["k"], sc["u"]
    kptr, uptr = sc["kptr"], sc["uptr"]
    ids_c, idd_c, d_c = sc["ids"], sc["id_d"], sc["d"]
    # job j's target side IS side j (side 2i = left, 2i+1 = right); its
    # source side is the sibling j ^ 1
    g = u  # distance-group count per side (incl piv)
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
            cb.tgt_d[rt, ct] = d_c[_ranges(uptr[js], gt)]
            cb.src_d[rs, cs] = d_c[_ranges(uptr[ss], gs)]
            cb.tgt_d_mask[rt, ct] = True
            cb.src_d_mask[rs, cs] = True
            cross_buckets.append(cb)
        src_goff, tgt_goff = int(src_off[-1]), int(tgt_off[-1])

        # flat executor arrays in (bucket, job) order — one concatenation
        # pass per kind instead of per-job list appends
        mem_t, mem_s = mem[order], mem[sib]
        tjob = tgt_off[bix] + row * Ut[bix]
        sjob = src_off[bix] + row * Us[bix]
        tgt_scatter = ids_c[_ranges(kptr[order] + 1, mem_t)]
        src_gather = ids_c[_ranges(kptr[sib] + 1, mem_s)]
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


def _no_reweight(reweightable: bool) -> None:
    if reweightable:
        raise NotImplementedError(
            "reweightable plans (learnable edge weights) are not ported yet: "
            "ROADMAP Queue A item 8")


def compile_plan(tree: WeightedTree, leaf_size: int = 64, seed: int = 0,
                 detect_grid_spacing: bool = True, use_cache: bool = True,
                 reweightable: bool = False) -> IntegrationPlan:
    """Compile (or fetch from the in-memory content-hash cache) the
    integration plan of one tree. `seed` is part of the cache key:
    differently-seeded builds must never alias to the first build."""
    _no_reweight(reweightable)
    fp = tree_fingerprint(tree)
    if use_cache:
        key = (fp, max(int(leaf_size), 6), int(seed), detect_grid_spacing,
               reweightable)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit

    flat = build_flat_it(tree, leaf_size=leaf_size, seed=seed,
                         use_cache=use_cache)
    plan = _assemble_plan(flat, tree.num_vertices, detect_grid_spacing)
    plan.fingerprint = fp
    plan.leaf_size = max(int(leaf_size), 6)
    plan.seed = int(seed)
    plan.tree_sizes = (tree.num_vertices,)
    plan.reweightable = reweightable
    if use_cache:
        _PLAN_CACHE.put(key, plan)
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
    segment-sum / scatter ops.

    The packed field layout is `Forest`'s: vertex v of tree t at row
    `forest.offsets[t] + v`; the multiply is block-diagonal by construction
    (no index from one tree ever references another tree's rows)."""
    _no_reweight(reweightable)
    fps = tuple(tree_fingerprint(t) for t in forest.trees)
    if use_cache:
        key = ("forest", fps, max(int(leaf_size), 6), int(seed),
               detect_grid_spacing, reweightable)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit

    flat = build_flat_forest(forest.trees, leaf_size=leaf_size, seed=seed,
                             use_cache=use_cache)
    plan = _assemble_plan(flat, forest.num_vertices, detect_grid_spacing)
    plan.fingerprint = hashlib.sha1(
        "".join(fps).encode()).hexdigest()
    plan.leaf_size = max(int(leaf_size), 6)
    plan.seed = int(seed)
    plan.tree_sizes = tuple(int(s) for s in forest.tree_sizes)
    plan.reweightable = reweightable
    if use_cache:
        _PLAN_CACHE.put(key, plan)
    return plan
