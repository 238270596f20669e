"""Flat, vectorized IntegratorTree builder (paper Sec 3.1, Lemma 3.1).

A frontier-at-a-time sweep: every decomposition level processes ALL active
subtrees in one batch of numpy array passes over CSR adjacency —

  1. one restricted BFS per level (all subtree roots at once) gives order,
     parents, hop depths and root distances for every active subtree;
  2. subtree sizes come from a reverse level-by-level `np.add.at`, the heavy
     child per vertex from one `np.maximum.at`, and the pivot of every
     subtree from a segmented argmin of max(heavy, n_sub - size) — a TRUE
     centroid (all components <= n_sub/2) with no re-rooting walk;
  3. a second joint BFS rooted at the pivots yields pivot distances and
     branch (component) labels; a greedy largest-first pass over components
     (O(#components), not O(#vertices)) splits each subtree into the
     balanced (left, right) sides of Lemma 3.1;
  4. distance groups for all nodes of the level come from ONE lexsort over
     (group, distance) — unique distances, inverse indices and segment-sum
     run boundaries all fall out of the same run-length pass;
  5. leaf pairwise distances are computed in one shot per level from
     root-distance + LCA prefix arrays, d(u,v) = d(u) + d(v) - 2 d(lca),
     via batched binary lifting over the level's BFS forest — no per-leaf,
     per-source traversals.

Because every level already batches an arbitrary number of independent
subtrees, a whole FOREST of trees builds in the same sweep: `build_flat_forest`
seeds level 0 with one subtree per tree (vertex ids offset into the packed
forest layout) and ONE frontier loop decomposes all trees' levels together —
90 small graphs cost the same handful of numpy passes as one graph.

Results are cached per (content hash, leaf_size, seed) in one shared
BoundedLRU for trees and forests: repeated builds over the same topology
amortize to a dict lookup. `seed` must be part of the key even though the
current builder is deterministic — a seeded builder variant must never
alias differently-seeded builds to the first one built.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

from repro_torch.core.lru import BoundedLRU
from repro_torch.graphs.graph import WeightedTree


@dataclasses.dataclass(frozen=True)
class FlatSide:
    """One side of an internal IT node. `ids[0]` is the pivot; the remaining
    ids are ordered by ascending pivot distance, so `ids` IS the segment-sum
    layout (`seg_starts` are the run boundaries of equal distance groups)."""

    ids: np.ndarray  # (k,) global vertex ids, pivot first
    id_d: np.ndarray  # (k,) index into `d` per vertex (monotone)
    d: np.ndarray  # (u,) unique pivot distances, d[0] == 0.0
    seg_starts: np.ndarray  # (u,) run starts of equal distance groups in ids


@dataclasses.dataclass(frozen=True)
class FlatIT:
    """Flat IT: internal nodes + leaves as parallel arrays/lists.

    `children[i]` holds two refs: >= 0 is an internal node index, < 0 is a
    leaf encoded as -(leaf_index + 1). `root_ref` uses the same encoding.
    For forest builds, `root_refs[t]` is tree t's root in the same encoding
    and all vertex ids are global (offset into the packed forest layout);
    `root_ref` stays the first tree's root for single-tree compatibility.
    """

    n: int
    leaf_size: int
    root_ref: int
    pivots: np.ndarray  # (I,) global pivot ids
    node_depth: np.ndarray  # (I,)
    children: np.ndarray  # (I, 2)
    left: list  # list[FlatSide]
    right: list  # list[FlatSide]
    leaf_ids: list  # list[np.ndarray]
    leaf_dists: list  # list[np.ndarray (k,k)]
    leaf_depth: np.ndarray  # (L,)
    root_refs: np.ndarray | None = None  # (K,) per-tree roots (forest builds)

    @property
    def num_internal(self) -> int:
        return int(self.pivots.size)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_ids)

    # cached_property writes the instance __dict__ directly, which bypasses
    # the frozen-dataclass __setattr__ — the concatenated views below are
    # derived data, so caching them on the (immutable) instance is safe and
    # amortizes across repeated plan assemblies over one IT
    @functools.cached_property
    def side_cat(self) -> dict:
        """Concatenated CSR over ALL job sides, interleaved as side 2i =
        left[i], side 2i+1 = right[i]. `kptr`/`uptr` are the exclusive
        prefix sums of per-side vertex / unique-distance counts, so the
        vectorized plan assembly addresses every side with array ops
        instead of re-walking the per-node FlatSide objects."""
        sides: list = []
        for i in range(self.num_internal):
            sides.append(self.left[i])
            sides.append(self.right[i])
        k = np.array([s.ids.size for s in sides], np.int64)
        u = np.array([s.d.size for s in sides], np.int64)
        kptr = np.zeros(k.size + 1, np.int64)
        np.cumsum(k, out=kptr[1:])
        uptr = np.zeros(u.size + 1, np.int64)
        np.cumsum(u, out=uptr[1:])

        def cat(arrs, dtype):
            return (np.concatenate(arrs) if arrs
                    else np.zeros(0, dtype))

        return {
            "k": k, "u": u, "kptr": kptr, "uptr": uptr,
            "ids": cat([s.ids for s in sides], np.int64),
            "id_d": cat([s.id_d for s in sides], np.int64),
            "d": cat([s.d for s in sides], np.float64),
        }

    @functools.cached_property
    def leaf_cat(self) -> dict:
        """Concatenated leaf arrays: ids CSR plus the raveled distance
        matrices (`dptr` is the exclusive prefix sum of k_i^2)."""
        k = np.array([ids.size for ids in self.leaf_ids], np.int64)
        ptr = np.zeros(k.size + 1, np.int64)
        np.cumsum(k, out=ptr[1:])
        dptr = np.zeros(k.size + 1, np.int64)
        np.cumsum(k * k, out=dptr[1:])
        ids = (np.concatenate(self.leaf_ids) if self.leaf_ids
               else np.zeros(0, np.int64))
        dflat = (np.concatenate([D.ravel() for D in self.leaf_dists])
                 if self.leaf_dists else np.zeros(0, np.float64))
        return {"k": k, "ptr": ptr, "dptr": dptr, "ids": ids,
                "dflat": dflat}


# ----------------------------------------------------------------------------
# content-hash cache
# ----------------------------------------------------------------------------

_CACHE = BoundedLRU(32)


def clear_flat_cache() -> None:
    _CACHE.clear()


def tree_fingerprint(tree: WeightedTree) -> str:
    """Content hash of a tree's topology + weights (plan/IT cache key)."""
    h = hashlib.sha1()
    h.update(np.int64(tree.num_vertices).tobytes())
    h.update(np.ascontiguousarray(tree.edges_u).tobytes())
    h.update(np.ascontiguousarray(tree.edges_v).tobytes())
    h.update(np.ascontiguousarray(tree.weights).tobytes())
    return h.hexdigest()


def build_flat_it(tree: WeightedTree, leaf_size: int = 64, seed: int = 0,
                  use_cache: bool = True) -> FlatIT:
    """Build (or fetch from cache) the flat IT for `tree`.

    `seed` is kept for API compatibility with the reference builder (the
    construction is fully deterministic) but is still part of the cache
    key: differently-seeded builds must never alias.
    """
    leaf_size = max(int(leaf_size), 6)
    if use_cache:
        key = (tree_fingerprint(tree), leaf_size, int(seed))
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
    flat = _build([tree], leaf_size)
    if use_cache:
        _CACHE.put(key, flat)
    return flat


def flat_stats(flat: FlatIT) -> dict:
    """Diagnostics matching `integrator_tree.it_stats` without materializing
    ITNodes: max depth, node counts, Lemma-3.1 balance check (each side of
    an internal node holds at least a quarter of its n - 1 vertices past
    the pivot, the pivot counted on both sides)."""
    k = np.array([[lt.ids.size, rt.ids.size]
                  for lt, rt in zip(flat.left, flat.right)],
                 np.int64).reshape(-1, 2)
    nn = k.sum(axis=1, keepdims=True) - 1
    return {
        "max_depth": int(max(flat.node_depth.max(initial=0),
                             flat.leaf_depth.max(initial=0))),
        "internal": flat.num_internal,
        "leaves": flat.num_leaves,
        "balance_ok": bool(np.all(nn / 4.0 <= k)),
    }


def build_flat_forest(trees, leaf_size: int = 64, seed: int = 0,
                      use_cache: bool = True) -> FlatIT:
    """Build (or fetch from cache) ONE flat IT covering every tree of a
    forest: level 0 starts with one active subtree per tree (vertex ids
    offset into the packed layout), so a single frontier loop decomposes all
    trees' levels together. Shares the content-hash cache with
    `build_flat_it` (keyed by the tuple of per-tree fingerprints)."""
    trees = list(getattr(trees, "trees", trees))
    if not trees:
        raise ValueError("build_flat_forest needs at least one tree")
    leaf_size = max(int(leaf_size), 6)
    if use_cache:
        key = (tuple(tree_fingerprint(t) for t in trees), leaf_size,
               int(seed))
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
    flat = _build(trees, leaf_size)
    if use_cache:
        _CACHE.put(key, flat)
    return flat


# ----------------------------------------------------------------------------
# vectorized primitives
# ----------------------------------------------------------------------------


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenation of arange(starts[i], starts[i]+counts[i]) without loops."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    nz = counts > 0
    starts, counts = starts[nz], counts[nz]
    res = np.ones(total, np.int64)
    res[0] = starts[0]
    cs = np.cumsum(counts)[:-1]
    res[cs] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(res)


def _slot_csr(eu, ev, ew, S):
    """Symmetric CSR over slot ids from an undirected edge list."""
    deg = np.bincount(eu, minlength=S) + np.bincount(ev, minlength=S)
    indptr = np.zeros(S + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    src = np.concatenate([eu, ev])
    dst = np.concatenate([ev, eu])
    w = np.concatenate([ew, ew])
    o = np.argsort(src, kind="stable")
    return indptr, dst[o], w[o]


def _forest_bfs(indptr, nbr, nw, roots, S):
    """Joint BFS over a forest restricted to the slot adjacency.

    Returns (parent, hop_depth, root_dist, levels); slots unreachable from
    `roots` keep parent == -1 and depth == -1. On a tree no vertex can be
    discovered twice in one frontier expansion, so no dedup is needed.
    """
    parent = np.full(S, -1, np.int64)
    dep = np.full(S, -1, np.int64)
    dist = np.zeros(S, np.float64)
    dep[roots] = 0
    levels = [roots]
    frontier = roots
    while frontier.size:
        counts = indptr[frontier + 1] - indptr[frontier]
        idx = _ranges(indptr[frontier], counts)
        if idx.size == 0:
            break
        nb = nbr[idx]
        src = np.repeat(frontier, counts)
        m = dep[nb] < 0
        nxt = nb[m]
        if nxt.size == 0:
            break
        psrc = src[m]
        parent[nxt] = psrc
        dep[nxt] = dep[psrc] + 1
        dist[nxt] = dist[psrc] + nw[idx][m]
        levels.append(nxt)
        frontier = nxt
    return parent, dep, dist, levels


def _leaf_distance_matrices(sub_ptr, leaf_subs, parent, dep, droot, size, sub):
    """All leaves of a level in one shot via the Euler-interval recurrence

        dist(v, .) = dist(parent(v), .) + w(v)   (minus 2 w(v) inside
                                                  subtree(v))

    computed level-synchronously across every leaf at once: one preorder
    (tin/tout) pass and one row-block update per BFS depth — O(sum k^2) work
    in a handful of numpy passes, no per-leaf per-source traversals."""
    num_sub = sub_ptr.size - 1
    leaf_idx = np.full(num_sub, -1, np.int64)
    leaf_idx[leaf_subs] = np.arange(leaf_subs.size, dtype=np.int64)
    ks = (sub_ptr[leaf_subs + 1] - sub_ptr[leaf_subs]).astype(np.int64)
    kmax = int(ks.max())
    rowbase = np.zeros(leaf_subs.size, np.int64)
    np.cumsum(ks[:-1], out=rowbase[1:])

    ls = _ranges(sub_ptr[leaf_subs], ks)  # all leaf slots
    # preorder tin within each leaf: children get consecutive subranges of
    # the parent interval, ordered by slot id (segmented exclusive scan)
    S = parent.size
    tin = np.zeros(S, np.int64)
    order = np.lexsort((ls, parent[ls], dep[ls]))
    ls_sorted = ls[order]
    dep_sorted = dep[ls_sorted]
    bounds = np.searchsorted(dep_sorted, np.arange(dep_sorted[-1] + 2))
    levels = [ls_sorted[bounds[d]:bounds[d + 1]]
              for d in range(bounds.size - 1)]
    for lv in levels[1:]:
        par = parent[lv]
        cs = np.cumsum(size[lv]) - size[lv]
        gstart = np.r_[True, par[1:] != par[:-1]]
        excl = cs - cs[np.flatnonzero(gstart)][np.cumsum(gstart) - 1]
        tin[lv] = tin[par] + 1 + excl
    tout = tin + size

    D_e = np.zeros((int(ks.sum()), kmax), np.float64)
    # root rows: distances from each leaf root, laid out in euler order
    D_e[rowbase[leaf_idx[sub[ls]]], tin[ls]] = droot[ls]
    cols = np.arange(kmax)[None, :]
    for lv in levels[1:]:
        rb = rowbase[leaf_idx[sub[lv]]]
        w = droot[lv] - droot[parent[lv]]
        blk = D_e[rb + tin[parent[lv]]] + w[:, None]
        inside = (cols >= tin[lv][:, None]) & (cols < tout[lv][:, None])
        blk -= 2.0 * w[:, None] * inside
        D_e[rb + tin[lv]] = blk
    mats = []
    for i, s in enumerate(leaf_subs):
        sl = np.arange(sub_ptr[s], sub_ptr[s + 1], dtype=np.int64)
        perm = tin[sl]
        mats.append(D_e[rowbase[i] + perm][:, perm])
    return mats


# ----------------------------------------------------------------------------
# the level sweep
# ----------------------------------------------------------------------------


def _build(trees: list, leaf_size: int) -> FlatIT:
    # level 0 has one active subtree per tree; vertex ids are offsets into
    # the packed forest layout (single trees are the K == 1 special case)
    sizes0 = np.array([t.num_vertices for t in trees], np.int64)
    offsets = np.zeros(sizes0.size + 1, np.int64)
    np.cumsum(sizes0, out=offsets[1:])
    n = int(offsets[-1])
    verts = np.arange(n, dtype=np.int64)
    sub = np.repeat(np.arange(sizes0.size, dtype=np.int64), sizes0)
    eu = np.concatenate([t.edges_u.astype(np.int64) + offsets[i]
                         for i, t in enumerate(trees)])
    ev = np.concatenate([t.edges_v.astype(np.int64) + offsets[i]
                         for i, t in enumerate(trees)])
    ew = np.concatenate([t.weights.astype(np.float64) for t in trees])
    num_sub = sizes0.size
    pend_parent = np.full(num_sub, -1, np.int64)
    pend_side = np.zeros(num_sub, np.int64)
    depth = 0

    pivots, node_depth, children = [], [], []
    lefts, rights = [], []
    leaf_ids, leaf_dists, leaf_depth = [], [], []
    root_refs = None

    while num_sub:
        S = verts.size
        sub_ptr = np.searchsorted(sub, np.arange(num_sub + 1))
        sizes = np.diff(sub_ptr)
        split_mask = sizes > leaf_size
        split_subs = np.flatnonzero(split_mask)
        leaf_subs = np.flatnonzero(~split_mask)

        # record refs for this level's subtrees (creation order matches)
        int_rank = np.cumsum(split_mask) - split_mask
        leaf_rank = np.cumsum(~split_mask) - (~split_mask)
        ref = np.where(split_mask, len(pivots) + int_rank,
                       -(len(leaf_ids) + leaf_rank) - 1)
        if root_refs is None:
            root_refs = ref.astype(np.int64).copy()  # level 0: tree roots
        for s in range(num_sub):
            if pend_parent[s] >= 0:
                children[pend_parent[s]][pend_side[s]] = int(ref[s])

        indptr, nbr, nw = _slot_csr(eu, ev, ew, S)
        parent1, dep1, droot1, levels1 = _forest_bfs(
            indptr, nbr, nw, sub_ptr[:-1].copy(), S)
        size = np.ones(S, np.int64)
        for lev in levels1[:0:-1]:
            np.add.at(size, parent1[lev], size[lev])

        if leaf_subs.size:
            mats = _leaf_distance_matrices(sub_ptr, leaf_subs, parent1, dep1,
                                           droot1, size, sub)
            for s, D in zip(leaf_subs, mats):
                leaf_ids.append(verts[sub_ptr[s]:sub_ptr[s + 1]].copy())
                leaf_dists.append(D)
                leaf_depth.append(depth)

        if not split_subs.size:
            break

        # --- heavy child, centroid (segmented argmin) ----------------------
        heavy = np.zeros(S, np.int64)
        nonroot = parent1 >= 0
        np.maximum.at(heavy, parent1[nonroot], size[nonroot])
        maxcomp = np.maximum(heavy, sizes[sub] - size)
        minval = np.minimum.reduceat(maxcomp, sub_ptr[:-1])
        pos = np.flatnonzero(maxcomp == minval[sub])
        _, first = np.unique(sub[pos], return_index=True)
        pivot_slot = pos[first]  # (num_sub,) centroid slot per subtree

        # --- BFS from pivots: distances + branch (component) labels -------
        parent2, _, pdist, levels2 = _forest_bfs(
            indptr, nbr, nw, pivot_slot[split_subs], S)
        branch = np.full(S, -1, np.int64)
        pc = levels2[1]  # children of pivots == component roots
        branch[pc] = pc
        for lev in levels2[2:]:
            branch[lev] = branch[parent2[lev]]
        comp_size = np.bincount(branch[branch >= 0], minlength=S)

        # --- greedy balanced partition, largest component first ------------
        pc_sub, pc_size = sub[pc], comp_size[pc]
        order = np.lexsort((-pc_size, pc_sub))
        side_of_branch = np.zeros(S, np.int8)
        cur, lt, rt = -1, 0, 0
        for i in order:
            if pc_sub[i] != cur:
                cur, lt, rt = pc_sub[i], 0, 0
            if lt <= rt:
                lt += pc_size[i]
            else:
                side_of_branch[pc[i]] = 1
                rt += pc_size[i]
        side = np.zeros(S, np.int8)
        nonpiv = branch >= 0  # within split subtrees: everything but the pivot
        side[nonpiv] = side_of_branch[branch[nonpiv]]

        # --- distance groups for ALL nodes of the level in one lexsort ----
        slots_np = np.flatnonzero(nonpiv)
        gkey = sub[slots_np] * 2 + side[slots_np]
        ds = pdist[slots_np]
        o2 = np.lexsort((ds, gkey))
        sslots, gs, dsort = slots_np[o2], gkey[o2], ds[o2]
        gchange = np.r_[True, gs[1:] != gs[:-1]]
        rstart = gchange | np.r_[True, dsort[1:] != dsort[:-1]]
        run_id = np.cumsum(rstart) - 1
        gidx = np.cumsum(gchange) - 1
        inv = run_id - run_id[np.flatnonzero(gchange)][gidx]
        gstarts = np.flatnonzero(gchange)
        gends = np.r_[gstarts[1:], gs.size]
        gvals = gs[gchange]

        def _emit_side(s, side_val):
            gi = np.searchsorted(gvals, 2 * s + side_val)
            lo, hi = gstarts[gi], gends[gi]
            pg = verts[pivot_slot[s]]
            ids = np.concatenate(([pg], verts[sslots[lo:hi]]))
            id_d = np.concatenate(([0], inv[lo:hi] + 1))
            d = np.concatenate(([0.0], dsort[lo:hi][rstart[lo:hi]]))
            seg = np.concatenate(([0], np.flatnonzero(rstart[lo:hi]) + 1))
            return FlatSide(ids=ids, id_d=id_d.astype(np.int64), d=d,
                            seg_starts=seg.astype(np.int64))

        for s in split_subs:
            pivots.append(int(verts[pivot_slot[s]]))
            node_depth.append(depth)
            children.append([0, 0])
            lefts.append(_emit_side(s, 0))
            rights.append(_emit_side(s, 1))

        # --- next-level state: split edges/slots, duplicate pivots --------
        child_base = np.full(num_sub, -1, np.int64)
        child_base[split_subs] = np.arange(split_subs.size, dtype=np.int64) * 2
        keep = slots_np  # non-pivot slots of split subtrees
        piv_slots = pivot_slot[split_subs]
        entry_sub = np.concatenate([
            child_base[sub[keep]] + side[keep],
            child_base[split_subs], child_base[split_subs] + 1])
        entry_vert = np.concatenate(
            [verts[keep], verts[piv_slots], verts[piv_slots]])
        o3 = np.argsort(entry_sub, kind="stable")
        pos_arr = np.empty(entry_sub.size, np.int64)
        pos_arr[o3] = np.arange(entry_sub.size, dtype=np.int64)
        K, P = keep.size, piv_slots.size
        old2new = np.full(S, -1, np.int64)
        old2new[keep] = pos_arr[:K]
        piv_left = np.full(S, -1, np.int64)
        piv_left[piv_slots] = pos_arr[K:K + P]
        piv_right = np.full(S, -1, np.int64)
        piv_right[piv_slots] = pos_arr[K + P:]

        in_split_e = split_mask[sub[eu]]
        a, b, w = eu[in_split_e], ev[in_split_e], ew[in_split_e]
        a_piv = branch[a] < 0  # only the pivot has no branch in a split sub
        b_piv = branch[b] < 0
        # a pivot-incident edge follows the side of its non-pivot endpoint;
        # all other edges stay inside one branch, hence one side
        eu = np.where(a_piv,
                      np.where(side[b] == 0, piv_left[a], piv_right[a]),
                      old2new[a])
        ev = np.where(b_piv,
                      np.where(side[a] == 0, piv_left[b], piv_right[b]),
                      old2new[b])
        ew = w
        verts = entry_vert[o3]
        sub = entry_sub[o3]
        num_new = 2 * split_subs.size
        pend_parent = np.empty(num_new, np.int64)
        pend_side = np.empty(num_new, np.int64)
        new_refs = ref[split_subs]
        pend_parent[0::2] = new_refs
        pend_parent[1::2] = new_refs
        pend_side[0::2] = 0
        pend_side[1::2] = 1
        num_sub = num_new
        depth += 1

    return FlatIT(
        n=n, leaf_size=leaf_size, root_ref=int(root_refs[0]),
        pivots=np.asarray(pivots, np.int64),
        node_depth=np.asarray(node_depth, np.int64),
        children=(np.asarray(children, np.int64).reshape(-1, 2)
                  if children else np.zeros((0, 2), np.int64)),
        left=lefts, right=rights,
        leaf_ids=leaf_ids, leaf_dists=leaf_dists,
        leaf_depth=np.asarray(leaf_depth, np.int64),
        root_refs=root_refs,
    )
