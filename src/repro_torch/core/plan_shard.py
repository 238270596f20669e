"""Multi-device FTFI over `torch.distributed`: the leaf-block partitioner
and the per-rank plan executor (the reference's `core/plan_shard.py`).

The fused executor in `plan_api._execute` is a single-device program: one
gather + segment-sum over the whole source index space, one cross dispatch
per size bucket, one gather + scatter-add over the whole target space. This
module partitions that global index space into per-rank *leaf blocks* and
runs the same computation on every rank of a process group, with exact
collectives:

  - the vertex space [0, n) is cut into `num_shards` equal contiguous
    blocks (the `plan_leaves` logical axis). Trees in a packed `Forest`
    occupy contiguous id ranges, so forest plans shard naturally per tree —
    only trees straddling a block boundary contribute halo traffic;
  - every *contribution* (leaf-bucket row, cross job, pivot correction) is
    assigned to one shard (greedy LPT on its flat entry count), so
    scatter-adds stay rank-local up to the final reduction;
  - cross buckets / leaf rows that read remote field rows get them through
    a host-precomputed **halo/exchange table**: each rank gathers the rows
    its neighbours need, one `all_to_all` swaps them, and local indices
    into the received pool are baked into the per-shard index arrays (no
    full-field gather, ever);
  - per-rank partial outputs meet in one `reduce_scatter` over the plan
    axis — an exact reduction — that leaves each rank its own row block of
    the (n, d) result, a DTensor sharded by rows (the reference's
    out_specs=P(axis)); nothing gathers the field. So `apply_sharded`
    matches the single-device `plan_api.apply` to float round-off.

The partitioner (`partition_plan`, `ShardPlan`) is host numpy copied from
the reference: its tables equal the reference's array for array. Each rank
uploads only its own slice of them (`_rank_tables`, once per rank and
device). The forward is differentiable in X and the params
(`launch.collectives` gives each collective its VJP): the params' grads
are summed over the plan axis, a row-sharded field's grad is sharded by
rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lru import BoundedLRU

# bumped whenever the per-shard table layout below changes: recorded into
# sharded artifacts' provenance and rejected by plan_guard when a newer
# artifact meets an older codebase
SHARD_LAYOUT_VERSION = 1

_PART_CACHE = BoundedLRU(8)
# (spec digest, world size) pairs that `sharded_fastmult` has recorded
_RECORDED: set = set()


# ----------------------------------------------------------------------------
# ShardPlan: host-side per-device tables
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class ShardPlan:
    """Per-device decomposition of one PlanSpec. All arrays are numpy and
    stacked along a leading (D,) shard axis; `block` is the per-device
    vertex count (the padded global field is (D * block, d)). Index
    conventions inside a shard's local field buffer `xfull`:

      [0, block)                     owned vertex rows
      block                          zero pad row
      [block + 1, block + 1 + D*Emax) halo rows received via all_to_all
    """

    num_shards: int
    block: int
    halo_width: int  # Emax: max rows exchanged per (sender, receiver) pair
    halo_total: int  # sum of remote rows referenced across shards
    send_idx: np.ndarray  # (D, D, Emax) local row ids to send (pad=block)
    # leaf buckets (tuples over bucket index)
    leaf_sel: tuple  # (D, Rmax_i) row ids into the bucket (pad=0)
    leaf_gather: tuple  # (D, Rmax_i, K) xfull indices (pad=block)
    leaf_mask: tuple  # (D, Rmax_i, K) bool
    leaf_scatter: tuple  # (D, Rmax_i, K) out rows (pad/masked=dump)
    # cross buckets
    job_sel: tuple  # (D, Jmax_i) row ids into the bucket (pad=0)
    job_tmask: tuple  # (D, Jmax_i, Ut)
    job_smask: tuple  # (D, Jmax_i, Us)
    loff_src: tuple  # local flat source-group offset per bucket
    loff_tgt: tuple
    n_src_loc: int
    n_tgt_loc: int
    src_gather_l: np.ndarray  # (D, Smax) xfull indices (pad=block)
    src_seg_l: np.ndarray  # (D, Smax) local groups (pad=n_src_loc)
    tgt_gather_l: np.ndarray  # (D, Tmax) local target groups (pad=0)
    tgt_scatter_l: np.ndarray  # (D, Tmax) out rows (pad=dump)
    # pivot diagonal corrections
    piv_gather_l: np.ndarray  # (D, Pmax) xfull indices (pad=block)
    piv_scatter_l: np.ndarray  # (D, Pmax) out rows (pad=dump)
    # grid/Hankel engine: per-shard static integer grid indices + global
    # (shard-invariant) transform sizes; None unless the spec is grid-aligned
    hankel_it: tuple | None
    hankel_isrc: tuple | None
    hankel_LM: tuple | None  # of (L_i, Ms_i)
    # per-(rank, device) tensors of the rank's slice (`_rank_tables`)
    _tables: dict = dataclasses.field(default_factory=dict)

    @property
    def stats(self) -> dict:
        return {"num_shards": self.num_shards, "block": self.block,
                "halo_width": self.halo_width,
                "halo_total": self.halo_total,
                # per-device flat work (padded gather lengths): the
                # weak-scaling gate checks these shrink vs the global plan
                "src_rows": int(self.src_gather_l.shape[1]),
                "tgt_rows": int(self.tgt_gather_l.shape[1]),
                "shard_layout": SHARD_LAYOUT_VERSION}


def _owner(v, block, D):
    return np.minimum(np.asarray(v, np.int64) // block, D - 1)


def _greedy_assign(w, D):
    """LPT scheduling: heaviest item first onto the least-loaded shard.
    Deterministic (stable sort, lowest-index tie-break); near-optimal
    makespan, which is what bounds the padded per-shard table width."""
    import heapq
    w = np.asarray(w, np.int64)
    out = np.zeros(w.size, np.int64)
    if D <= 1 or not w.size:
        return out
    heap = [(0, k) for k in range(D)]
    heapq.heapify(heap)
    for j in np.argsort(-w, kind="stable"):
        load, k = heapq.heappop(heap)
        out[j] = k
        heapq.heappush(heap, (load + int(w[j]), k))
    return out


def partition_plan(spec, num_shards: int) -> ShardPlan:
    """Split `spec`'s global index space into `num_shards` leaf blocks.

    Pure host-side numpy; memoized on (spec digest, num_shards). Cross jobs
    and leaf rows are load-balanced across shards by their flat entry
    counts (greedy LPT — vertex ids carry no locality, so ownership-based
    placement would pile everything on the low blocks); every remote
    *input* row a shard needs is routed through the exchange table, and the
    partial outputs meet in one exact reduce_scatter."""
    key = (spec.digest, int(num_shards))
    hit = _PART_CACHE.get(key)
    if hit is not None:
        return hit
    D = int(num_shards)
    n = spec.n
    block = max(-(-n // D), 1)
    dump = D * block  # scatter row that is dropped before the reduction

    nb = len(spec.cross_src_mask)
    Bs = np.array([m.shape[0] for m in spec.cross_src_mask], np.int64)
    Us = np.array([m.shape[1] for m in spec.cross_src_mask], np.int64)
    Ut = np.array([m.shape[1] for m in spec.cross_tgt_mask], np.int64)
    soff = np.asarray(spec.cross_src_off, np.int64)
    toff = np.asarray(spec.cross_tgt_off, np.int64)
    jbase = np.zeros(nb + 1, np.int64)
    np.cumsum(Bs, out=jbase[1:])
    total_jobs = int(jbase[-1])

    # ---- decompose the global flat entry tables -------------------------
    tg = np.asarray(spec.tgt_gather, np.int64)
    tv = np.asarray(spec.tgt_scatter, np.int64)
    tb = np.searchsorted(toff, tg, side="right") - 1 if tg.size else tg
    trel = tg - toff[tb] if tg.size else tg
    trow = trel // Ut[tb] if tg.size else tg
    tcol = trel - trow * Ut[tb] if tg.size else tg

    sg = np.asarray(spec.src_gather, np.int64)
    ss = np.asarray(spec.src_seg, np.int64)
    sb = np.searchsorted(soff, ss, side="right") - 1 if ss.size else ss
    srel = ss - soff[sb] if ss.size else ss
    srow = srel // Us[sb] if ss.size else ss
    scol = srel - srow * Us[sb] if ss.size else ss

    # ---- assign jobs to shards: greedy balance on flat entry counts -----
    w_job = np.ones(total_jobs, np.int64)  # +1 spreads zero-weight jobs
    if tg.size:
        w_job += np.bincount(jbase[tb] + trow, minlength=total_jobs)
    if sg.size:
        w_job += np.bincount(jbase[sb] + srow, minlength=total_jobs)
    job_shard = _greedy_assign(w_job, D)

    # per-bucket shard membership -> padded (D, Jmax) selections
    job_sel, job_valid, job_slot = [], [], np.zeros(total_jobs, np.int64)
    Jmax = np.zeros(nb, np.int64)
    for i in range(nb):
        shards = job_shard[jbase[i]:jbase[i + 1]]
        counts = np.bincount(shards, minlength=D)
        Jmax[i] = max(int(counts.max()) if counts.size else 0, 1)
        sel = np.zeros((D, Jmax[i]), np.int32)
        val = np.zeros((D, Jmax[i]), bool)
        order = np.argsort(shards, kind="stable")
        slot = np.arange(shards.size) - np.concatenate(
            [[0], np.cumsum(counts)])[shards[order]]
        job_slot[jbase[i] + order] = slot
        sel[shards[order], slot] = order.astype(np.int32)
        val[shards[order], slot] = True
        job_sel.append(sel)
        job_valid.append(val)

    loff_src = np.zeros(nb + 1, np.int64)
    np.cumsum(Jmax * Us, out=loff_src[1:])
    loff_tgt = np.zeros(nb + 1, np.int64)
    np.cumsum(Jmax * Ut, out=loff_tgt[1:])
    n_src_loc = int(loff_src[-1])
    n_tgt_loc = int(loff_tgt[-1])

    # ---- leaf rows: greedy balance on live-entry counts -----------------
    nlb = len(spec.leaf_ids)
    leaf_live, leaf_w = [], []
    for i in range(nlb):
        mask = np.asarray(spec.leaf_mask[i], bool)
        rows = np.flatnonzero(mask.any(axis=1))
        leaf_live.append(rows)
        leaf_w.append(mask[rows].sum(axis=1).astype(np.int64) + 1)
    lsh = _greedy_assign(np.concatenate(leaf_w) if nlb else
                         np.zeros(0, np.int64), D)
    leaf_rows, off = [], 0  # (rows, shard) per leaf bucket
    for rows in leaf_live:
        leaf_rows.append((rows, lsh[off:off + rows.size]))
        off += rows.size

    # ---- halo: remote vertex rows each shard reads ----------------------
    need = [[] for _ in range(D)]  # remote global vertex ids per shard
    if sg.size:
        esh = job_shard[jbase[sb] + srow]
        rem = (sg < n) & (_owner(sg, block, D) != esh)
        for k in range(D):
            m = rem & (esh == k)
            if m.any():
                need[k].append(sg[m])
    for i in range(nlb):
        rows, rs = leaf_rows[i]
        if not rows.size:
            continue
        ids = np.asarray(spec.leaf_ids[i], np.int64)[rows]
        mask = np.asarray(spec.leaf_mask[i], bool)[rows]
        own = _owner(ids, block, D)
        for k in range(D):
            m = mask & (own != k) & (rs[:, None] == k) & (ids < n)
            if m.any():
                need[k].append(ids[m])
    need = [np.unique(np.concatenate(v)) if v else np.zeros(0, np.int64)
            for v in need]
    halo_total = int(sum(v.size for v in need))

    # send lists per (owner j -> shard k); Emax pads the exchange uniform
    send_lists = [[None] * D for _ in range(D)]
    Emax = 0
    for k in range(D):
        own = _owner(need[k], block, D)
        for j in range(D):
            sl = need[k][own == j]
            send_lists[j][k] = sl
            Emax = max(Emax, sl.size)
    send_idx = np.full((D, D, Emax), block, np.int32)
    for j in range(D):
        for k in range(D):
            sl = send_lists[j][k]
            send_idx[j, k, :sl.size] = (sl - j * block).astype(np.int32)

    def xidx(k, vs):
        """xfull indices on shard k for global vertex ids `vs` (pad id n
        and out-of-range -> the zero row)."""
        vs = np.asarray(vs, np.int64)
        res = np.full(vs.shape, block, np.int32)
        pad = vs >= n
        own = _owner(vs, block, D)
        mine = (own == k) & ~pad
        res[mine] = (vs[mine] - k * block).astype(np.int32)
        rem = ~mine & ~pad
        for j in range(D):
            mj = rem & (own == j)
            if mj.any():
                pos = np.searchsorted(send_lists[j][k], vs[mj])
                res[mj] = (block + 1 + j * Emax + pos).astype(np.int32)
        return res

    # ---- per-shard flat source entries ----------------------------------
    if sg.size:
        esh = job_shard[jbase[sb] + srow]
        lseg = loff_src[sb] + job_slot[jbase[sb] + srow] * Us[sb] + scol
        counts = np.bincount(esh, minlength=D)
        Smax = max(int(counts.max()), 1)
        src_gather_l = np.full((D, Smax), block, np.int32)
        src_seg_l = np.full((D, Smax), n_src_loc, np.int32)
        for k in range(D):
            m = esh == k
            src_gather_l[k, :int(m.sum())] = xidx(k, sg[m])
            src_seg_l[k, :int(m.sum())] = lseg[m].astype(np.int32)
    else:
        src_gather_l = np.full((D, 1), block, np.int32)
        src_seg_l = np.full((D, 1), n_src_loc, np.int32)

    # ---- per-shard flat target entries ----------------------------------
    if tg.size:
        esh = job_shard[jbase[tb] + trow]
        lgat = loff_tgt[tb] + job_slot[jbase[tb] + trow] * Ut[tb] + tcol
        lsca = np.where(tv < n, tv, dump)
        counts = np.bincount(esh, minlength=D)
        Tmax = max(int(counts.max()), 1)
        tgt_gather_l = np.zeros((D, Tmax), np.int32)
        tgt_scatter_l = np.full((D, Tmax), dump, np.int32)
        for k in range(D):
            m = esh == k
            tgt_gather_l[k, :int(m.sum())] = lgat[m].astype(np.int32)
            tgt_scatter_l[k, :int(m.sum())] = lsca[m].astype(np.int32)
    else:
        tgt_gather_l = np.zeros((D, 1), np.int32)
        tgt_scatter_l = np.full((D, 1), dump, np.int32)

    # ---- pivots (always owned by their shard) ---------------------------
    piv = np.asarray(spec.pivots, np.int64)
    live_p = piv[piv < n]
    psh = _owner(live_p, block, D)
    counts = np.bincount(psh, minlength=D) if live_p.size else np.zeros(
        D, np.int64)
    Pmax = max(int(counts.max()) if live_p.size else 0, 1)
    piv_gather_l = np.full((D, Pmax), block, np.int32)
    piv_scatter_l = np.full((D, Pmax), dump, np.int32)
    for k in range(D):
        pv = live_p[psh == k]
        piv_gather_l[k, :pv.size] = (pv - k * block).astype(np.int32)
        piv_scatter_l[k, :pv.size] = pv.astype(np.int32)

    # ---- leaf tables ----------------------------------------------------
    leaf_sel, leaf_gather, leaf_mask_sh, leaf_scatter = [], [], [], []
    for i in range(nlb):
        rows, rs = leaf_rows[i]
        ids = np.asarray(spec.leaf_ids[i], np.int64)
        mask = np.asarray(spec.leaf_mask[i], bool)
        K = ids.shape[1]
        counts = np.bincount(rs, minlength=D) if rows.size else np.zeros(
            D, np.int64)
        Rmax = max(int(counts.max()) if rows.size else 0, 1)
        sel = np.zeros((D, Rmax), np.int32)
        gat = np.full((D, Rmax, K), block, np.int32)
        msk = np.zeros((D, Rmax, K), bool)
        sca = np.full((D, Rmax, K), dump, np.int32)
        for k in range(D):
            rk = rows[rs == k]
            sel[k, :rk.size] = rk.astype(np.int32)
            if rk.size:
                gat[k, :rk.size] = xidx(k, ids[rk])
                msk[k, :rk.size] = mask[rk]
                sca[k, :rk.size] = np.where(mask[rk], ids[rk],
                                            dump).astype(np.int32)
        leaf_sel.append(sel)
        leaf_gather.append(gat)
        leaf_mask_sh.append(msk)
        leaf_scatter.append(sca)

    # ---- cross masks (padded job rows keep slot 0 live so the engines'
    # masked reductions stay finite; their outputs are never gathered) ----
    job_tmask, job_smask = [], []
    for i in range(nb):
        tm = np.asarray(spec.cross_tgt_mask[i], bool)[job_sel[i]]
        sm = np.asarray(spec.cross_src_mask[i], bool)[job_sel[i]]
        pad = ~job_valid[i]
        tm[pad] = False
        sm[pad] = False
        tm[pad, 0] = True
        sm[pad, 0] = True
        job_tmask.append(tm)
        job_smask.append(sm)

    # ---- grid/Hankel static integer indices -----------------------------
    hankel_it = hankel_isrc = hankel_LM = None
    if spec.grid_h is not None and not spec.reweightable:
        h = spec.grid_h
        hankel_it, hankel_isrc, hankel_LM = [], [], []
        for i in range(nb):
            it_g = np.rint(np.asarray(spec.cross_tgt_d0[i]) / h).astype(
                np.int64)
            is_g = np.rint(np.asarray(spec.cross_src_d0[i]) / h).astype(
                np.int64)
            Ms = int(is_g.max()) + 1 if is_g.size else 1
            L = (int(it_g.max()) if it_g.size else 0) + Ms
            hankel_it.append(it_g[job_sel[i]].astype(np.int32))
            hankel_isrc.append(is_g[job_sel[i]].astype(np.int32))
            hankel_LM.append((L, Ms))
        hankel_it = tuple(hankel_it)
        hankel_isrc = tuple(hankel_isrc)
        hankel_LM = tuple(hankel_LM)

    sp = ShardPlan(
        num_shards=D, block=block, halo_width=int(Emax),
        halo_total=halo_total, send_idx=send_idx,
        leaf_sel=tuple(leaf_sel), leaf_gather=tuple(leaf_gather),
        leaf_mask=tuple(leaf_mask_sh), leaf_scatter=tuple(leaf_scatter),
        job_sel=tuple(job_sel), job_tmask=tuple(job_tmask),
        job_smask=tuple(job_smask),
        loff_src=tuple(int(o) for o in loff_src[:-1]),
        loff_tgt=tuple(int(o) for o in loff_tgt[:-1]),
        n_src_loc=n_src_loc, n_tgt_loc=n_tgt_loc,
        src_gather_l=src_gather_l, src_seg_l=src_seg_l,
        tgt_gather_l=tgt_gather_l, tgt_scatter_l=tgt_scatter_l,
        piv_gather_l=piv_gather_l, piv_scatter_l=piv_scatter_l,
        hankel_it=hankel_it, hankel_isrc=hankel_isrc, hankel_LM=hankel_LM)
    _PART_CACHE.put(key, sp)
    return sp


# ----------------------------------------------------------------------------
# the per-rank executor
# ----------------------------------------------------------------------------


def live_buckets(sp: ShardPlan, k: int) -> list:
    """Per cross bucket, whether any of rank k's targets reads its output:
    the buckets rank k multiplies (one fdist_matvec launch each on
    "cuda")."""
    tgl = np.asarray(sp.tgt_gather_l[k], np.int64)
    live_t = tgl[np.asarray(sp.tgt_scatter_l[k]) < sp.num_shards * sp.block]
    Jt = [s.shape[1] * m.shape[2] for s, m in zip(sp.job_sel, sp.job_tmask)]
    lo = np.asarray(sp.loff_tgt, np.int64)
    return [bool(((live_t >= lo[i]) & (live_t < lo[i] + Jt[i])).any())
            for i in range(len(lo))]


def _rank_tables(sp: ShardPlan, k: int, device: torch.device) -> dict:
    """Rank k's slice of the shard plan as tensors on `device` (int64
    indices, bool masks), made once per (rank, device). `live` marks the
    cross buckets whose output rank k's targets read: a bucket no target
    reads (only padded rows on this rank) is not multiplied at all."""
    key = (int(k), str(device))
    hit = sp._tables.get(key)
    if hit is not None:
        return hit

    def idx(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    def msk(a):
        return torch.from_numpy(np.ascontiguousarray(a, bool)).to(device)

    tgl = np.asarray(sp.tgt_gather_l[k], np.int64)
    lm = [np.asarray(a[k], bool) for a in sp.leaf_mask]
    t = {"send": idx(sp.send_idx[k].reshape(-1)),
         "sgl": idx(sp.src_gather_l[k]), "ssl": idx(sp.src_seg_l[k]),
         "tgl": idx(tgl), "tsl": idx(sp.tgt_scatter_l[k]),
         "pvg": idx(sp.piv_gather_l[k]), "pvs": idx(sp.piv_scatter_l[k]),
         "leaf_sel": [idx(a[k]) for a in sp.leaf_sel],
         "leaf_g": [idx(a[k]) for a in sp.leaf_gather],
         "leaf_m": [msk(m) for m in lm],
         "leaf_pm": [msk(m[:, :, None] & m[:, None, :]) for m in lm],
         "leaf_s": [idx(a[k]).reshape(-1) for a in sp.leaf_scatter],
         "job_sel": [idx(a[k]) for a in sp.job_sel],
         "tmask": [msk(a[k]) for a in sp.job_tmask],
         "smask": [msk(a[k]) for a in sp.job_smask],
         "live": live_buckets(sp, k)}
    if sp.hankel_it is not None:
        t["h_it"] = [idx(a[k]) for a in sp.hankel_it]
        t["h_isrc"] = [idx(a[k]) for a in sp.hankel_isrc]
    sp._tables[key] = t
    return t


def check_mesh(spec, mesh) -> None:
    """Reject a sharded artifact on a mismatched mesh with a clear error
    (instead of a gather-time crash deep inside the executor)."""
    from repro_torch.core.plan_guard import PlanValidationError
    from repro_torch.launch import sharding

    if getattr(spec, "shard_layout", 0) > SHARD_LAYOUT_VERSION:
        raise PlanValidationError(
            f"plan artifact uses shard layout v{spec.shard_layout}, this "
            f"codebase supports <= v{SHARD_LAYOUT_VERSION}")
    nd = getattr(spec, "mesh_devices", 0)
    if nd and mesh is not None and sharding.mesh_size(mesh) != nd:
        raise PlanValidationError(
            f"sharded plan artifact was laid out for {nd} devices "
            f"(axes {tuple(getattr(spec, 'mesh_axes', ()) or ())}), but the "
            f"target mesh has {sharding.mesh_size(mesh)} devices "
            f"(axes {sharding.mesh_axes(mesh)}); re-save the artifact on the "
            f"serving mesh or pass a matching mesh")


def _execute_sharded(spec, sp: ShardPlan, params, fn_eval, cross_multiply,
                     use_hankel: bool, x, group, k: int):
    """Rank k's share of `plan_api._execute`, the shard_map body of the
    reference: the halo all_to_all and the reduce_scatter of the partial
    outputs. x (hi - lo, d) is rank k's rows [lo, hi) of the field
    (`launch.collectives.row_bounds`); returns the same rows of M_f X (the
    reference's in_specs = out_specs = P(axis))."""
    from repro_torch.core.plan_api import hankel_grid_matvec
    from repro_torch.launch import collectives as C

    D, block, Emax = sp.num_shards, sp.block, sp.halo_width
    dump = D * block
    lo, hi = C.row_bounds(spec.n, D, k)
    x = torch.cat([x, x.new_zeros(block - x.shape[0], x.shape[1])])
    d = x.shape[1]
    t = _rank_tables(sp, k, x.device)
    nb, nlb = len(sp.job_sel), len(sp.leaf_sel)
    Us = [m.shape[2] for m in sp.job_smask]
    Ut = [m.shape[2] for m in sp.job_tmask]
    # every rank reads its own rows of the distances and the tree weights:
    # their grads are summed over the plan axis in the backward
    nt, ns = len(params.cross_tgt_d), len(params.cross_src_d)
    tw = () if params.tree_w is None else (params.tree_w,)
    dists = C.replicated(params.cross_tgt_d + params.cross_src_d
                         + params.leaf_dists + tw, group)
    ctd, csd = dists[:nt], dists[nt:nt + ns]
    ld = dists[nt + ns:nt + ns + len(params.leaf_dists)]

    xl = torch.cat([x, x.new_zeros(1, d)], dim=0)
    if Emax:
        recv = C.all_to_all(xl[t["send"]], group)  # (D * Emax, d)
        xfull = torch.cat([xl, recv], dim=0)
    else:
        xfull = xl
    outp = x.new_zeros(dump + 1, d)

    for i in range(nlb):
        m = t["leaf_m"][i]
        Xl = xfull[t["leaf_g"][i]]  # (Rmax, K, d)
        M = fn_eval(ld[i][t["leaf_sel"][i]])
        M = torch.where(t["leaf_pm"][i], M, 0.0)
        contrib = torch.bmm(M, Xl) * m[:, :, None]
        outp.index_add_(0, t["leaf_s"][i], contrib.reshape(-1, d))

    if sp.n_src_loc:
        Xp_loc = x.new_zeros(sp.n_src_loc + 1, d).index_add_(
            0, t["ssl"], xfull[t["sgl"]])[:-1]
        parts = []
        for i in range(nb):
            J = sp.job_sel[i].shape[1]
            if not t["live"][i]:  # no target of this rank reads the bucket
                parts.append(x.new_zeros(J * Ut[i], d))
                continue
            off = sp.loff_src[i]
            Xp = Xp_loc[off:off + J * Us[i]].reshape(J, Us[i], d)
            if use_hankel:
                L_i, Ms_i = sp.hankel_LM[i]
                res = hankel_grid_matvec(fn_eval, spec.grid_h,
                                         t["h_it"][i], t["h_isrc"][i], Xp,
                                         L_i, Ms_i)
            else:
                sel = t["job_sel"][i]
                res = cross_multiply(i, ctd[i][sel], t["tmask"][i],
                                     csd[i][sel], t["smask"][i], Xp)
            parts.append(res.reshape(J * Ut[i], d))
        cflat = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        outp.index_add_(0, t["tsl"], cflat[t["tgl"]])

    f0 = fn_eval(x.new_zeros(1))[0]
    outp.index_add_(0, t["pvs"], -f0 * xfull[t["pvg"]])
    # the exact meeting point of all cross-shard contributions: this rank's
    # rows of the result
    res = C.reduce_scatter(outp[:-1], group)[:hi - lo]
    if tw:
        w = torch.repeat_interleave(
            dists[-1], torch.as_tensor(spec.tree_sizes, device=x.device),
            output_size=spec.n)[lo:hi]
        res = res * w[:, None].to(res.dtype)
    return res


def _mesh_of(mesh):
    from repro_torch.launch import sharding

    if mesh is None:
        mesh = sharding.current_mesh()
    if mesh is None:
        raise ValueError(
            "apply_sharded needs a mesh: pass mesh=... or call under "
            "launch.sharding.use_sharding(mesh)")
    return mesh


def sharded_row_fastmult(spec, fn, *, mesh=None, axis: str | None = None,
                         backend: str = "torch", degree: int = 32,
                         device=None):
    """(params, x) -> y on this rank's rows of the field: x (hi - lo, d)
    holds rows [lo, hi) (`launch.collectives.row_bounds(spec.n, D, k)`
    for rank k of the D on the plan axis), and y holds the same rows of
    M_f X. The reference's shard_map body (in_specs = out_specs =
    P(axis)) with the mesh, the plan axis (default: the one bound to
    `plan_leaves`, `data` on the standard meshes), the engine choice and
    the device baked in. Every rank of the mesh calls it with the same
    params and its own rows. Differentiable in params and x: x's grad is
    its rows of the field's grad.

    The engine is `plan_api.select_cross`'s, as single-device `apply`
    takes it: on "cuda" each rank launches the fdist_matvec kernel on its
    own live cross buckets for the in-kernel families. `device` None
    means the mesh's: a "cpu" mesh runs on the CPU, a card mesh on this
    rank's card."""
    from repro_torch.analysis import trace_guard
    from repro_torch.core.plan_api import _fspec, _params_on, select_cross
    from repro_torch.launch import sharding

    mesh = _mesh_of(mesh)
    check_mesh(spec, mesh)
    axis = axis or sharding.plan_axis(mesh)
    group = sharding.axis_group(mesh, axis)
    k = sharding.axis_rank(mesh, axis)
    dev = _rank_device(mesh, device)
    sp = partition_plan(spec, sharding.axis_size(mesh, axis))
    fspec = _fspec(fn)
    name, cross = select_cross(spec, fspec, backend=backend, degree=degree)
    use_hankel = name == "hankel_fft"
    if use_hankel and sp.hankel_it is None:  # pragma: no cover - guard
        raise ValueError("grid engine selected but shard plan lacks grid "
                         "tables")
    key = (spec.digest, sharding.mesh_size(mesh))
    if key not in _RECORDED:  # once per (plan, world): no tracer here
        _RECORDED.add(key)
        trace_guard.record("ftfi.sharded_fastmult", detail=spec.digest[:12])
    fe = fspec.fn_eval

    def rows(params, x):
        return _execute_sharded(spec, sp, _params_on(params, dev), fe, cross,
                                use_hankel, x.to(torch.float32), group, k)

    return rows


def _rank_device(mesh, device):
    """`device`, else the mesh's device type: a "cpu" mesh runs on the
    CPU, a card mesh on this rank's card."""
    from repro_torch.device import resolve_device

    return resolve_device(device if device is not None or
                          mesh.device_type == "cuda" else mesh.device_type)


def sharded_fastmult(spec, fn, *, mesh=None, axis: str | None = None,
                     backend: str = "torch", degree: int = 32, device=None):
    """(params, X) -> Y closure over the sharded executor (the sharded
    face of `plan_api.fastmult`; `sharded_row_fastmult` on whole fields).
    Every rank of the mesh calls it with the same params and X, a DTensor
    field sharded by rows over the plan axis or a plain tensor (the whole
    field on every rank), and gets its rows of Y: a DTensor sharded by
    rows over the plan axis, as the reference's `out_specs=P(axis)` hands
    each device its block."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding

    mesh = _mesh_of(mesh)
    axis = axis or sharding.plan_axis(mesh)
    rows = sharded_row_fastmult(spec, fn, mesh=mesh, axis=axis,
                                backend=backend, degree=degree, device=device)
    dev = _rank_device(mesh, device)
    group = sharding.axis_group(mesh, axis)
    D = sharding.axis_size(mesh, axis)
    lo, hi = C.row_bounds(spec.n, D, sharding.axis_rank(mesh, axis))

    def fm(params, X):
        if sharding.is_dtensor(X):
            out_mesh, x = X.device_mesh, C.local_rows(X.to(torch.float32),
                                                      axis)
        else:  # the whole field alike on every rank: the rank's rows are
            # cut from it with no collective (its grad gathered back)
            out_mesh = mesh
            x = torch.as_tensor(X, dtype=torch.float32, device=dev)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        if not sharding.is_dtensor(X):
            pad = x.new_zeros(D * -(-spec.n // D) - spec.n, x.shape[1])
            x = C.scatter_block(torch.cat([x, pad]), group)[:hi - lo]
        y = rows(params, x)
        return C.rows_dtensor(y[:, 0] if squeeze else y, out_mesh, axis,
                              spec.n)

    return fm


def apply_sharded(spec, params, fn, X, *, mesh=None, axis: str | None = None,
                  backend: str = "torch", degree: int = 32, device=None):
    """Multi-rank `plan_api.apply`: Y = M_f X with the plan's index space
    partitioned into per-rank leaf blocks over the mesh's plan axis.

    `mesh` defaults to the active `launch.sharding.use_sharding` mesh;
    `axis` to the mesh axis bound to the `plan_leaves` logical axis. X is
    a DTensor field sharded by rows over `axis` (each rank reads its own
    block) or a plain tensor, the same on every rank. Y is a DTensor
    sharded by rows over `axis` (`launch.collectives.row_placements`):
    each rank holds its rows, `Y.full_tensor()` gathers the whole. Exact:
    halo rows move through one all_to_all and partial outputs through one
    reduce_scatter, with no gather of the field (the reference's
    discipline), so parity with the single-device executor is float
    round-off only. Differentiable in `params` and `X` like `apply`: the
    params' grads are summed over the plan axis, a row-sharded X's grad is
    sharded by rows and a plain X's is whole on every rank.
    Tensors that a raw callable `fn` captures (mask coefficients) are read
    by each rank for its own share only: pass them through
    `launch.collectives.replicated` first, as `masks.make_tree_fastmult`
    does, so that their grads are summed over the plan axis."""
    return sharded_fastmult(spec, fn, mesh=mesh, axis=axis, backend=backend,
                            degree=degree, device=device)(params, X)


def shard_stats(spec, num_shards: int) -> dict:
    """Partition diagnostics: per-device block size, halo width/total (the
    halo-exchange cost model's inputs: one all_to_all moves
    `num_shards * halo_width` rows per device)."""
    return partition_plan(spec, num_shards).stats
