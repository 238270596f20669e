"""Incremental plan updates: patch a compiled (PlanSpec, PlanParams) pair
under single-leaf edits without re-running the IT decomposition.

`update_plan(spec, params, ops)` applies a sequence of

  ("insert_leaf", parent, weight)   attach a new leaf under `parent`
  ("delete_leaf", vertex)           remove a degree-1 non-root vertex
  ("reweight", edge_w)              replace ALL edge weights at once

and returns a fresh (spec', params') whose integration output equals a
from-scratch `ftfi.build(edited_tree, reweightable=True)` — the equality
oracle tests/test_torch_plan_update.py sweeps randomly. The reference's
`repro.core.plan_update`, edit for edit: the same ops give the same index
tables.

Why this is exact, in brief:

- A new leaf v under `parent` has the same IT chain as `parent` (v's set
  membership mirrors its only neighbor all the way down), so walking the
  canonical IT skeleton (`spec.children` / `spec.root_refs`) from the root
  and adding v to parent's side at every internal node — one target slot in
  that side's job, one source slot in the sibling job — plus parent's leaf
  block reproduces exactly the cross/leaf coverage a rebuild would emit:
  every pair (v, x) is covered once, at the meet node of (parent, x), or in
  parent's leaf.
- A deleted degree-1 vertex is on no path between other vertices, so at
  every node where it was the pivot one whole side is the singleton {v}:
  after blanking v's slots both cross jobs of such a node carry zero mass,
  and the remaining plan is a valid decomposition of the smaller tree. The
  deleted row keeps its index (recorded in `spec.ghosts`): its output row
  is exactly zero and its input row is ignored, so plans stay statically
  shaped under deletion — re-compact via a full rebuild when desired.
- Structural edits never move existing vertices in the metric, so every
  pre-existing distance slot keeps its value: only the new leaf's slots
  need fresh distances, d(p, v) = depth[p] + depth[v] - 2 depth[lca] from
  the root-path CSR. A `reweight` op invalidates everything and triggers
  the same full re-derivation `ftfi.reweight` performs.

Cost model (the reason this beats recompiling): per structural edit the
work is O(IT depth) slot claims plus O(changed rows) distance fills. The
expensive bookkeeping is batched per `update_plan` call, not per edit:
new flat cross entries are materialized (and existing ones remapped, if
any bucket grew) once in `finish`, and only the buckets an edit touched
are re-uploaded to device — untouched buckets keep the input params'
arrays. No IT build, no LCA recomputation, no content hashing (the spec
digest stays lazy).

Requires `build(..., reweightable=True)` (per-vertex slots + LCA tables)
compiled by this codebase version (update tables present). A spec laid out
for a device mesh keeps its provenance (`mesh_devices`, `mesh_axes`,
`shard_layout`) through an edit, and the sharded executor
(`plan_shard.apply_sharded`) consumes the edited plan as it is, with the
field sharded by rows or whole.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device


def _i32(a):
    """int32 view-or-cast (no copy when already int32)."""
    return np.asarray(a, np.int32)


def _remap_flat(vals, old_off, old_U, new_off, new_U):
    """Re-express flat group indices (off_b + row * U_b + col) after some
    buckets' group widths U changed: decompose against the old layout,
    recompose against the new one."""
    if vals.size == 0:
        return vals
    b = np.searchsorted(old_off[1:-1], vals, side="right")
    rel = vals - old_off[b]
    row = rel // old_U[b]
    col = rel - row * old_U[b]
    return (new_off[b] + row * new_U[b] + col).astype(vals.dtype)


class _State:
    """Mutable working copy of every spec table an edit can touch.

    Distance arrays are copy-on-write: buckets an edit never touches keep
    referencing the input spec's arrays (and, at `finish`, the input
    params' device arrays). New flat cross entries are kept in (bucket,
    row, col, vertex) form and materialized once in `finish`, so bucket
    growth never triggers per-edit remaps of the big flat arrays."""

    def __init__(self, spec):
        if (spec.path_rows is None or spec.children is None
                or spec.edges_u is None):
            raise ValueError(
                "update_plan requires a reweightable plan with update "
                "tables: rebuild via ftfi.build(tree, reweightable=True) "
                "with this codebase version (older artifacts lack the IT "
                "skeleton / edge tables)")
        self.n = spec.n
        self.tree_sizes = list(spec.tree_sizes)
        self.fingerprint = spec.fingerprint
        self.pivots = spec.pivots.copy()  # per internal node
        self.children = spec.children
        self.root_refs = spec.root_refs
        self.job_bucket = spec.job_bucket
        self.job_row = spec.job_row
        self.leaf_bucket = spec.leaf_bucket
        self.leaf_row = spec.leaf_row
        self.ghosts = list(np.asarray(
            spec.ghosts if spec.ghosts is not None else [], np.int64))
        self.piv = [p.copy() for p in spec.cross_piv]
        self.tgt_rep = [r.copy() for r in spec.cross_tgt_rep]
        self.src_rep = [r.copy() for r in spec.cross_src_rep]
        self.tgt_lca = [a.copy() for a in spec.cross_tgt_lca]
        self.src_lca = [a.copy() for a in spec.cross_src_lca]
        self.tgt_mask = [m.copy() for m in spec.cross_tgt_mask]
        self.src_mask = [m.copy() for m in spec.cross_src_mask]
        self.leaf_ids = [a.copy() for a in spec.leaf_ids]
        self.leaf_mask = [m.copy() for m in spec.leaf_mask]
        self.leaf_lca = [a.copy() for a in spec.leaf_lca]
        self.tgt_gather = spec.tgt_gather.copy()
        self.tgt_scatter = spec.tgt_scatter.copy()
        self.src_gather = spec.src_gather.copy()
        self.src_seg = spec.src_seg.copy()
        self.path_rows = spec.path_rows.copy()
        self.path_edges = spec.path_edges.copy()
        self.edges_u = spec.edges_u.copy()
        self.edges_v = spec.edges_v.copy()
        self.edge_w = spec.edge_w0.astype(np.float64).copy()
        # flat-layout snapshot for the single deferred remap in finish()
        self.tgt_off0, self.tgt_U0 = self._offs(self.tgt_mask)
        self.src_off0, self.src_U0 = self._offs(self.src_mask)
        self.grew_cross = False
        # pending flat entries: (bucket, row, col, vertex), materialized
        # against the FINAL layout in finish()
        self.new_tgt: list[tuple] = []
        self.new_src: list[tuple] = []
        # distances: copy-on-write views of the spec's build-time arrays
        self.tgt_d = list(spec.cross_tgt_d0)
        self.src_d = list(spec.cross_src_d0)
        self.leaf_d = list(spec.leaf_dists0)
        self._owned_cross = set()
        self._owned_leaf = set()
        self.cross_touched = set()  # buckets whose params need re-upload
        self.leaf_touched = set()
        self.dirty_weights = False  # reweight op: re-derive everything
        self._depth = None  # lazy depth cache, invalidated per op

    # -- layout helpers -----------------------------------------------------

    def _voffs(self):
        off = np.zeros(len(self.tree_sizes) + 1, np.int64)
        np.cumsum(self.tree_sizes, out=off[1:])
        return off

    def _offs(self, masks):
        U = np.array([m.shape[1] for m in masks], np.int64)
        cnt = np.array([m.shape[0] for m in masks], np.int64)
        off = np.zeros(U.size + 1, np.int64)
        np.cumsum(cnt * U, out=off[1:])
        return off, U

    def depth(self):
        """Root-path depth per vertex (index n = pad sentinel, 0)."""
        if self._depth is None:
            d = np.zeros(self.n + 1, np.float64)
            np.add.at(d, self.path_rows, self.edge_w[self.path_edges])
            self._depth = d
        return self._depth

    def _own_cross(self, bi):
        if bi not in self._owned_cross:
            self.tgt_d[bi] = self.tgt_d[bi].copy()
            self.src_d[bi] = self.src_d[bi].copy()
            self._owned_cross.add(bi)
        self.cross_touched.add(bi)

    def _own_leaf(self, bi):
        if bi not in self._owned_leaf:
            self.leaf_d[bi] = self.leaf_d[bi].copy()
            self._owned_leaf.add(bi)
        self.leaf_touched.add(bi)

    def _grow_cross(self, bi, tgt: bool):
        """Add one pad column to bucket bi's target (or source) side. The
        flat arrays are NOT remapped here — finish() remaps once against
        the final layout."""
        masks = self.tgt_mask if tgt else self.src_mask
        reps = self.tgt_rep if tgt else self.src_rep
        lcas = self.tgt_lca if tgt else self.src_lca
        ds = self.tgt_d if tgt else self.src_d
        B = masks[bi].shape[0]
        pad = self.piv[bi][:, None]
        self._own_cross(bi)
        masks[bi] = np.concatenate([masks[bi], np.zeros((B, 1), bool)], 1)
        reps[bi] = np.concatenate([reps[bi], pad], 1)
        lcas[bi] = np.concatenate([lcas[bi], pad], 1)
        ds[bi] = np.concatenate([ds[bi], np.zeros((B, 1))], 1)
        self.grew_cross = True

    def _claim_cross(self, job, v, lca_val, d_val, tgt: bool):
        """Give vertex v a live slot in `job`'s target (or source) side:
        reuse the first pad column, else widen the bucket. The flat entry
        is queued for finish()."""
        bi = int(self.job_bucket[job])
        row = int(self.job_row[job])
        masks = self.tgt_mask if tgt else self.src_mask
        free = np.flatnonzero(~masks[bi][row])
        if free.size:
            c = int(free[0])
            self._own_cross(bi)
        else:
            c = masks[bi].shape[1]
            self._grow_cross(bi, tgt)
        masks = self.tgt_mask if tgt else self.src_mask
        (self.tgt_rep if tgt else self.src_rep)[bi][row, c] = v
        (self.tgt_lca if tgt else self.src_lca)[bi][row, c] = lca_val
        (self.tgt_d if tgt else self.src_d)[bi][row, c] = d_val
        masks[bi][row, c] = True
        (self.new_tgt if tgt else self.new_src).append((bi, row, c, v))

    def _grow_leaf(self, bi):
        B, K = self.leaf_ids[bi].shape
        self.leaf_ids[bi] = np.concatenate(
            [self.leaf_ids[bi], np.full((B, 1), self.n,
                                        self.leaf_ids[bi].dtype)], 1)
        self.leaf_mask[bi] = np.concatenate(
            [self.leaf_mask[bi], np.zeros((B, 1), bool)], 1)
        lca = np.full((B, K + 1, K + 1), self.n, self.leaf_lca[bi].dtype)
        lca[:, :K, :K] = self.leaf_lca[bi]
        self.leaf_lca[bi] = lca
        self._own_leaf(bi)
        d = np.zeros((B, K + 1, K + 1))
        d[:, :K, :K] = self.leaf_d[bi]
        self.leaf_d[bi] = d

    # -- ops ----------------------------------------------------------------

    def insert_leaf(self, parent: int, weight: float):
        parent = int(parent)
        if not (0 <= parent < self.n):
            raise ValueError(f"insert_leaf: parent {parent} out of range")
        if parent in self.ghosts:
            raise ValueError(f"insert_leaf: parent {parent} was deleted")
        voffs = self._voffs()
        t = int(np.searchsorted(voffs, parent, side="right")) - 1
        pos = int(voffs[t + 1])  # new vertex id: end of tree t's block
        # edge slot: end of tree t's packed edge block (computed BEFORE the
        # vertex shift so endpoint->tree mapping uses the current offsets)
        etree = np.searchsorted(voffs, self.edges_u, side="right") - 1
        epos = int(np.searchsorted(etree, t, side="right"))

        # shift every vertex-id table: ids >= pos move up one (this carries
        # the pad sentinel n -> n+1 along with the real ids above pos). When
        # the new id lands at the END of the id space — the last (or only)
        # tree — every real id is < pos, so only the sentinel-bearing tables
        # need the scan.
        shift = [self.pivots] + self.leaf_ids + self.leaf_lca
        if pos < self.n:
            shift += ([self.tgt_scatter, self.src_gather, self.path_rows,
                       self.edges_u, self.edges_v]
                      + self.piv + self.tgt_rep + self.src_rep
                      + self.tgt_lca + self.src_lca)
            self.ghosts = [g + 1 if g >= pos else g for g in self.ghosts]
            self.new_tgt = [(b, r, c, v + 1 if v >= pos else v)
                            for b, r, c, v in self.new_tgt]
            self.new_src = [(b, r, c, v + 1 if v >= pos else v)
                            for b, r, c, v in self.new_src]
        for arr in shift:
            arr[arr >= pos] += 1

        v = pos
        self.edges_u = np.insert(self.edges_u, epos, parent)
        self.edges_v = np.insert(self.edges_v, epos, v)
        self.edge_w = np.insert(self.edge_w, epos, float(weight))
        self.path_edges[self.path_edges >= epos] += 1
        # v's root path = parent's root path + the new edge
        pe = self.path_edges[self.path_rows == parent]
        self.path_rows = np.concatenate(
            [self.path_rows, np.full(pe.size + 1, v, self.path_rows.dtype)])
        self.path_edges = np.concatenate(
            [self.path_edges, pe, np.asarray([epos], self.path_edges.dtype)])
        self.tree_sizes[t] += 1
        self.n += 1
        self._depth = None
        depth = self.depth()

        # walk parent's IT chain: at each internal node v joins parent's
        # side — one target slot in that side's job, one source slot in the
        # sibling job — and finally parent's leaf block
        ref = int(self.root_refs[t])
        while ref >= 0:
            i = ref
            p = int(self.pivots[i])
            if parent == p:
                side = 0  # pivot belongs to both sides; descend left
                lca_val = p  # lca(p, v) = p when v hangs off the pivot
            else:
                jt = 2 * i  # job 2i targets the LEFT side
                bi, row = int(self.job_bucket[jt]), int(self.job_row[jt])
                hit = np.flatnonzero(
                    (self.tgt_rep[bi][row] == parent)
                    & self.tgt_mask[bi][row])
                if hit.size:
                    side = 0
                    lca_val = int(self.tgt_lca[bi][row, hit[0]])
                else:
                    jt = 2 * i + 1
                    bi, row = (int(self.job_bucket[jt]),
                               int(self.job_row[jt]))
                    hit = np.flatnonzero(
                        (self.tgt_rep[bi][row] == parent)
                        & self.tgt_mask[bi][row])
                    side = 1
                    # v hangs off parent, so lca(p, v) = lca(p, parent)
                    lca_val = int(self.tgt_lca[bi][row, hit[0]])
            d_val = depth[p] + depth[v] - 2.0 * depth[lca_val]
            self._claim_cross(2 * i + side, v, lca_val, d_val, tgt=True)
            self._claim_cross(2 * i + 1 - side, v, lca_val, d_val, tgt=False)
            ref = int(self.children[i, side])
        li = -ref - 1
        bi, row = int(self.leaf_bucket[li]), int(self.leaf_row[li])
        free = np.flatnonzero(~self.leaf_mask[bi][row])
        if free.size:
            c = int(free[0])
            self._own_leaf(bi)
        else:
            c = self.leaf_ids[bi].shape[1]
            self._grow_leaf(bi)
        cp = int(np.flatnonzero(self.leaf_ids[bi][row] == parent)[0])
        self.leaf_ids[bi][row, c] = v
        self.leaf_mask[bi][row, c] = True
        # lca(v, u) = lca(parent, u) for every other member u (v is a leaf
        # below parent); the copied diagonal entry lca(parent, parent) =
        # parent doubles as lca(v, parent), and v's own diagonal is v
        lca = self.leaf_lca[bi]
        lca[row, c, :] = lca[row, cp, :]
        lca[row, :, c] = lca[row, :, cp]
        lca[row, c, c] = v
        # distances for v's leaf row/col (pad members hit the sentinel
        # depth row -> masked garbage, same as a full re-derivation)
        dv = (depth[v] + depth[self.leaf_ids[bi][row]]
              - 2.0 * depth[lca[row, c, :]])
        self.leaf_d[bi][row, c, :] = dv
        self.leaf_d[bi][row, :, c] = dv
        return v

    def delete_leaf(self, v: int):
        v = int(v)
        if not (0 <= v < self.n):
            raise ValueError(f"delete_leaf: vertex {v} out of range")
        if v in self.ghosts:
            raise ValueError(f"delete_leaf: vertex {v} already deleted")
        inc = np.flatnonzero((self.edges_u == v) | (self.edges_v == v))
        if inc.size != 1:
            raise ValueError(
                f"delete_leaf: vertex {v} has degree {inc.size}, only "
                "degree-1 leaves can be deleted incrementally")
        if not np.any(self.path_rows == v):
            raise ValueError(
                f"delete_leaf: vertex {v} is a tree root; re-root via a "
                "full rebuild instead")
        e = int(inc[0])
        # blank every cross slot representing v (pad: rep/lca -> pivot).
        # Where v itself was a pivot, one whole side was the singleton {v},
        # so both jobs of that node now carry zero mass and their (stale)
        # distances are multiplied by empty sources — harmless by design.
        # Distance values at blanked slots stay stale on purpose: they are
        # masked out AND carry no flat entries, exactly like build padding.
        for bi in range(len(self.piv)):
            for rep, lca, mask in ((self.tgt_rep, self.tgt_lca,
                                    self.tgt_mask),
                                   (self.src_rep, self.src_lca,
                                    self.src_mask)):
                m = (rep[bi] == v) & mask[bi]
                if m.any():
                    r, _ = np.nonzero(m)
                    rep[bi][m] = self.piv[bi][r]
                    lca[bi][m] = self.piv[bi][r]
                    mask[bi][m] = False
        # v as pivot: drop its -f(0) diagonal correction (sentinel row n)
        self.pivots[self.pivots == v] = self.n
        # blank v's leaf slots (ids -> pad sentinel, lca row+col -> sentinel)
        for bi in range(len(self.leaf_ids)):
            m = self.leaf_ids[bi] == v
            if m.any():
                r, c = np.nonzero(m)
                self.leaf_ids[bi][m] = self.n
                self.leaf_mask[bi][m] = False
                self.leaf_lca[bi][r, c, :] = self.n
                self.leaf_lca[bi][r, :, c] = self.n
        # v neither contributes mass nor receives field (pending entries
        # from earlier inserts in this op batch are filtered the same way)
        keep = self.tgt_scatter != v
        self.tgt_scatter = self.tgt_scatter[keep]
        self.tgt_gather = self.tgt_gather[keep]
        keep = self.src_gather != v
        self.src_gather = self.src_gather[keep]
        self.src_seg = self.src_seg[keep]
        self.new_tgt = [e_ for e_ in self.new_tgt if e_[3] != v]
        self.new_src = [e_ for e_ in self.new_src if e_[3] != v]
        # remove v's edge and root path; only v's own path references the
        # edge (the root side survives), so the CSR stays consistent
        assert np.all(self.path_rows[self.path_edges == e] == v)
        keep = self.path_rows != v
        self.path_rows = self.path_rows[keep]
        self.path_edges = self.path_edges[keep]
        self.edges_u = np.delete(self.edges_u, e)
        self.edges_v = np.delete(self.edges_v, e)
        self.edge_w = np.delete(self.edge_w, e)
        self.path_edges[self.path_edges > e] -= 1
        self.ghosts.append(v)
        self._depth = None

    def reweight(self, edge_w):
        edge_w = np.asarray(edge_w, np.float64)
        if edge_w.shape != self.edge_w.shape:
            raise ValueError(
                f"reweight: expected {self.edge_w.shape[0]} edge weights "
                f"(current edge count), got {edge_w.shape}")
        self.edge_w = edge_w.copy()
        self.dirty_weights = True
        self._depth = None

    # -- finish: materialize flat entries, emit (spec', params') ------------

    def finish(self, spec, params, device=None):
        if self.dirty_weights:
            # a reweight moved every vertex in the metric: re-derive ALL
            # distances from the CSR + LCA tables (ftfi.reweight, host-side)
            depth = self.depth()

            def pair(u, v, l):
                return depth[u] + depth[v] - 2.0 * depth[l]

            for bi in range(len(self.piv)):
                pv = self.piv[bi][:, None]
                self.tgt_d[bi] = pair(pv, self.tgt_rep[bi], self.tgt_lca[bi])
                self.src_d[bi] = pair(pv, self.src_rep[bi], self.src_lca[bi])
                self.cross_touched.add(bi)
            for bi in range(len(self.leaf_ids)):
                ids = self.leaf_ids[bi]
                self.leaf_d[bi] = pair(ids[:, :, None], ids[:, None, :],
                                       self.leaf_lca[bi])
                self.leaf_touched.add(bi)

        # materialize the deferred flat entries against the FINAL layout,
        # remapping the pre-existing entries once iff any bucket grew
        tgt_off, tgt_U = self._offs(self.tgt_mask)
        src_off, src_U = self._offs(self.src_mask)
        if self.grew_cross:
            self.tgt_gather = _remap_flat(self.tgt_gather, self.tgt_off0,
                                          self.tgt_U0, tgt_off, tgt_U)
            self.src_seg = _remap_flat(self.src_seg, self.src_off0,
                                       self.src_U0, src_off, src_U)
        if self.new_tgt:
            b, r, c, v = (np.asarray(a, np.int64)
                          for a in zip(*self.new_tgt))
            self.tgt_gather = np.concatenate(
                [self.tgt_gather, _i32(tgt_off[b] + r * tgt_U[b] + c)])
            self.tgt_scatter = np.concatenate([self.tgt_scatter, _i32(v)])
        if self.new_src:
            b, r, c, v = (np.asarray(a, np.int64)
                          for a in zip(*self.new_src))
            self.src_seg = np.concatenate(
                [self.src_seg, _i32(src_off[b] + r * src_U[b] + c)])
            self.src_gather = np.concatenate([self.src_gather, _i32(v)])

        new_spec = dataclasses.replace(
            spec,
            n=self.n,
            tree_sizes=tuple(self.tree_sizes),
            fingerprint=self.fingerprint,
            pivots=_i32(self.pivots),
            cross_tgt_mask=tuple(self.tgt_mask),
            cross_src_mask=tuple(self.src_mask),
            cross_tgt_off=tuple(int(o) for o in tgt_off[:-1]),
            cross_src_off=tuple(int(o) for o in src_off[:-1]),
            cross_tgt_d0=tuple(self.tgt_d),
            cross_src_d0=tuple(self.src_d),
            leaf_ids=tuple(_i32(a) for a in self.leaf_ids),
            leaf_mask=tuple(self.leaf_mask),
            leaf_dists0=tuple(self.leaf_d),
            src_gather=_i32(self.src_gather),
            src_seg=_i32(self.src_seg),
            n_src_groups=int(src_off[-1]),
            tgt_gather=_i32(self.tgt_gather),
            tgt_scatter=_i32(self.tgt_scatter),
            n_tgt_groups=int(tgt_off[-1]),
            num_edges=int(self.edge_w.size),
            path_rows=_i32(self.path_rows),
            path_edges=_i32(self.path_edges),
            cross_piv=tuple(_i32(p) for p in self.piv),
            cross_tgt_rep=tuple(_i32(r) for r in self.tgt_rep),
            cross_tgt_lca=tuple(_i32(a) for a in self.tgt_lca),
            cross_src_rep=tuple(_i32(r) for r in self.src_rep),
            cross_src_lca=tuple(_i32(a) for a in self.src_lca),
            leaf_lca=tuple(_i32(a) for a in self.leaf_lca),
            edges_u=_i32(self.edges_u),
            edges_v=_i32(self.edges_v),
            edge_w0=self.edge_w.copy(),
            ghosts=np.asarray(self.ghosts, np.int32),
        )
        from repro_torch.core.plan_api import (PlanParams, _birth_params,
                                               _params_on)

        if params is None:
            return new_spec, _birth_params(new_spec, resolve_device(device))
        # params: re-upload only the touched buckets, as float32, to the
        # device of the input params; untouched buckets keep the input
        # params' tensors (their values are unchanged)
        dev = params.cross_tgt_d[0].device if params.cross_tgt_d else (
            params.leaf_dists[0].device if params.leaf_dists
            else torch.device("cpu"))
        ct, lt = sorted(self.cross_touched), sorted(self.leaf_touched)
        up = _params_on(PlanParams(
            cross_tgt_d=tuple(self.tgt_d[i] for i in ct),
            cross_src_d=tuple(self.src_d[i] for i in ct),
            leaf_dists=tuple(self.leaf_d[i] for i in lt)), dev)
        t_up = dict(zip(ct, up.cross_tgt_d))
        s_up = dict(zip(ct, up.cross_src_d))
        l_up = dict(zip(lt, up.leaf_dists))
        ctd = tuple(t_up.get(i, params.cross_tgt_d[i])
                    for i in range(len(self.tgt_d)))
        csd = tuple(s_up.get(i, params.cross_src_d[i])
                    for i in range(len(self.src_d)))
        ld = tuple(l_up.get(i, params.leaf_dists[i])
                   for i in range(len(self.leaf_d)))
        new_params = PlanParams(cross_tgt_d=ctd, cross_src_d=csd,
                                leaf_dists=ld, tree_w=params.tree_w)
        return new_spec, new_params


def update_plan(spec, params, ops, device=None):
    """Apply a sequence of structural/weight edits to a compiled plan.

    ops: iterable of
      ("insert_leaf", parent, weight)  new vertex appended at the end of
                                       parent's tree block (its global id is
                                       that block's old end; later trees
                                       shift up by one)
      ("delete_leaf", vertex)          degree-1 non-root vertex; its row
                                       stays allocated (output exactly 0,
                                       input ignored) and is listed in
                                       spec'.ghosts
      ("reweight", edge_w)             replace all edge weights (packed
                                       per-tree order, CURRENT edge count)

    Returns (spec', params') — exact for the edited tree/forest, verified
    against from-scratch rebuilds in tests. The provenance fingerprint is
    chained per op: sha1(old_fingerprint + repr(op)), so identical edit
    histories map to identical fingerprints. Requires a plan built with
    `reweightable=True` (update tables + LCA derivation present).

    With `params=None` the birth params of spec' land on `device` (None =
    the card); otherwise only the touched buckets are re-uploaded, to the
    device of `params`, and `device` is not read."""
    st = _State(spec)
    for op in ops:
        # a tensor argument (edge weights) is read as host numpy, so the
        # chained fingerprint is the reference's for the same values
        op = tuple(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                   else a for a in op)
        kind = op[0]
        if kind == "insert_leaf":
            st.insert_leaf(op[1], op[2])
        elif kind == "delete_leaf":
            st.delete_leaf(op[1])
        elif kind == "reweight":
            st.reweight(op[1])
        else:
            raise ValueError(f"unknown update op: {op[0]!r}")
        st.fingerprint = hashlib.sha1(
            (st.fingerprint + repr((kind,) + tuple(
                np.asarray(a).tolist() if isinstance(a, np.ndarray) else a
                for a in op[1:]))).encode()).hexdigest()
    new_spec, new_params = st.finish(spec, params, device)
    # the patched plan feeds the same unchecked fused dispatch as a loaded
    # artifact: bounds/consistency-check it under the plan_guard policy
    # before anyone executes it
    from repro_torch.core import plan_guard

    plan_guard.validate(new_spec, new_params, where="update_plan")
    return new_spec, new_params
