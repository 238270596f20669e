"""Minimum spanning trees: per-graph Kruskal with union-find (O(E log E)),
and a vectorized Borůvka `minimum_spanning_forest` that computes EVERY
graph's MST in one pass over the disjoint union — the multi-graph analogue
of the flat-IT level sweep (no per-graph Python loop)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph, WeightedTree


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True


def minimum_spanning_tree(g: Graph) -> WeightedTree:
    """Kruskal MST. Raises if the graph is disconnected."""
    order = np.argsort(g.weights, kind="stable")
    uf = _UnionFind(g.num_vertices)
    keep = np.zeros(g.num_edges, dtype=bool)
    taken = 0
    for e in order:
        if uf.union(int(g.edges_u[e]), int(g.edges_v[e])):
            keep[e] = True
            taken += 1
            if taken == g.num_vertices - 1:
                break
    if taken != g.num_vertices - 1:
        raise ValueError("graph is disconnected: MST does not exist")
    return WeightedTree(
        g.num_vertices, g.edges_u[keep], g.edges_v[keep], g.weights[keep]
    )


def minimum_spanning_forest(graphs) -> list:
    """MSTs of MANY graphs in one vectorized Borůvka sweep.

    All edge lists are concatenated into one disjoint-union graph (vertex
    ids offset per graph) and O(log n) Borůvka rounds run as whole-array
    numpy passes: each round every component picks its minimum outgoing edge
    under the strict total order (weight, edge index) — the tie-break makes
    the chosen MST unique, matching `minimum_spanning_tree`'s stable-sort
    Kruskal whenever weights are distinct — and components merge by pointer
    jumping. ~10 array ops per round regardless of how many graphs.

    Returns a list of per-graph `WeightedTree`s (local vertex ids); raises if
    any graph is disconnected."""
    graphs = list(graphs)
    sizes = np.array([g.num_vertices for g in graphs], dtype=np.int64)
    off = np.zeros(sizes.size + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    N = int(off[-1])
    u = np.concatenate([g.edges_u.astype(np.int64) + off[i]
                        for i, g in enumerate(graphs)])
    v = np.concatenate([g.edges_v.astype(np.int64) + off[i]
                        for i, g in enumerate(graphs)])
    w = np.concatenate([g.weights for g in graphs])
    E = u.size
    gid = np.repeat(np.arange(sizes.size), [g.num_edges for g in graphs])

    order = np.argsort(w, kind="stable")  # strict total order (w, edge idx)
    rank = np.empty(E, np.int64)
    rank[order] = np.arange(E)

    comp = np.arange(N)
    keep = np.zeros(E, dtype=bool)
    # live edge set shrinks geometrically: intra-component edges are dropped
    # each round so late rounds touch only the few remaining bridges
    lu, lv, lrank = u, v, rank
    while True:
        cu, cv = comp[lu], comp[lv]
        alive = cu != cv
        if not alive.any():
            break
        cu, cv, lrank = cu[alive], cv[alive], lrank[alive]
        lu, lv = lu[alive], lv[alive]
        best = np.full(N, E, np.int64)  # per component root: best edge rank
        np.minimum.at(best, cu, lrank)
        np.minimum.at(best, cv, lrank)
        picks = np.flatnonzero(best < E)  # component roots that found an edge
        eids = order[best[picks]]
        keep[eids] = True  # duplicates (mutual picks) collapse in the bool
        a, b = comp[u[eids]], comp[v[eids]]
        ptr = np.arange(N)
        ptr[picks] = np.where(a == picks, b, a)  # root -> opposite root
        # the pick graph has out-degree 1; its only cycles are mutual picks
        # (strict total order), broken by rooting the smaller label
        mutual = ptr[ptr] == np.arange(N)
        root = mutual & (np.arange(N) < ptr)
        ptr[root] = np.flatnonzero(root)
        while True:  # pointer jumping to the new component roots
            nxt = ptr[ptr]
            if np.array_equal(nxt, ptr):
                break
            ptr = nxt
        comp = ptr[comp]

    trees = []
    kept_gid = gid[keep]
    ku = (u[keep] - off[kept_gid]).astype(np.int32)
    kv = (v[keep] - off[kept_gid]).astype(np.int32)
    kw = w[keep]
    bounds = np.searchsorted(kept_gid, np.arange(sizes.size + 1))
    for i, g in enumerate(graphs):
        lo, hi = bounds[i], bounds[i + 1]
        if hi - lo != g.num_vertices - 1:
            raise ValueError(
                f"graph {i} is disconnected: MST does not exist")
        trees.append(WeightedTree(g.num_vertices, ku[lo:hi], kv[lo:hi],
                                  kw[lo:hi]))
    return trees
