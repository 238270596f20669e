"""Traversals: tree distances (single-source, sampled-pair, all-pairs),
Dijkstra.

Host-side numpy. Tree single-source is O(N); sampled pairs use
binary-lifting LCA (O(N log N) build, O(log N)/query); all-pairs is the
BTFI/oracle path, O(N^2) time and memory, computed row-blocked with the
Euler-interval update
  dist(v, u) = dist(parent(v), u) ± w(v, parent)
(minus inside subtree(v), plus outside) — used only for validation and the
brute-force baselines the paper compares against. Graph all-pairs runs
scipy's compiled Dijkstra over the graph's CSR (one source a row, the
same relaxations as `dijkstra`, so the same float64 sums).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graphs.graph import Graph, WeightedTree


def tree_bfs_order(tree: WeightedTree, root: int = 0):
    """DFS preorder from root. Returns (order, parent, parent_w)."""
    indptr, indices, data = tree.csr()
    n = tree.num_vertices
    parent = -np.ones(n, dtype=np.int64)
    parent_w = np.zeros(n, dtype=np.float64)
    order = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    stack = [root]
    visited[root] = True
    k = 0
    while stack:
        u = stack.pop()
        order[k] = u
        k += 1
        for ei in range(indptr[u], indptr[u + 1]):
            v = indices[ei]
            if not visited[v]:
                visited[v] = True
                parent[v] = u
                parent_w[v] = data[ei]
                stack.append(v)
    if k != n:
        raise ValueError("tree is disconnected")
    return order, parent, parent_w


def tree_distances_from(tree: WeightedTree, source: int) -> np.ndarray:
    """Shortest-path distances from `source` to every vertex (O(N))."""
    order, parent, parent_w = tree_bfs_order(tree, source)
    dist = np.zeros(tree.num_vertices, dtype=np.float64)
    for u in order[1:]:
        dist[u] = dist[parent[u]] + parent_w[u]
    return dist


class TreeLCA:
    """Binary-lifting LCA with O(N log N) build; batched O(log N) queries."""

    def __init__(self, tree: WeightedTree, root: int = 0):
        n = tree.num_vertices
        order, parent, parent_w = tree_bfs_order(tree, root)
        self.d_root = np.zeros(n, dtype=np.float64)
        self.depth = np.zeros(n, dtype=np.int64)
        for u in order[1:]:
            self.d_root[u] = self.d_root[parent[u]] + parent_w[u]
            self.depth[u] = self.depth[parent[u]] + 1
        LOG = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
        up = np.zeros((LOG, n), dtype=np.int64)
        up[0] = np.where(parent < 0, np.arange(n), parent)
        for k in range(1, LOG):
            up[k] = up[k - 1][up[k - 1]]
        self.up = up

    def lca(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        u = np.asarray(u, dtype=np.int64).copy()
        v = np.asarray(v, dtype=np.int64).copy()
        up, depth = self.up, self.depth
        swap = depth[u] < depth[v]
        u[swap], v[swap] = v[swap], u[swap]
        diff = depth[u] - depth[v]
        for k in range(up.shape[0]):
            sel = ((diff >> k) & 1) == 1
            u[sel] = up[k][u[sel]]
        same = u == v
        for k in range(up.shape[0] - 1, -1, -1):
            differs = ~same & (up[k][u] != up[k][v])
            u[differs] = up[k][u[differs]]
            v[differs] = up[k][v[differs]]
        return np.where(same, u, up[0][u])

    def distance(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        a = self.lca(u, v)
        return self.d_root[u] + self.d_root[v] - 2.0 * self.d_root[a]


def tree_pair_distances(tree: WeightedTree, us: np.ndarray, vs: np.ndarray):
    """Distances for sampled vertex pairs (Sec 4.3 training data)."""
    return TreeLCA(tree).distance(us, vs)


def _euler_intervals(tree: WeightedTree, root: int = 0):
    """Returns (euler_pos, tin, tout, order, parent, parent_w): vertex v's
    subtree occupies euler positions [tin[v], tout[v])."""
    indptr, indices, data = tree.csr()
    n = tree.num_vertices
    parent = -np.ones(n, dtype=np.int64)
    parent_w = np.zeros(n, dtype=np.float64)
    tin = np.zeros(n, dtype=np.int64)
    tout = np.zeros(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    # iterative DFS with explicit post-processing for tout
    stack = [(root, False)]
    visited[root] = True
    t = 0
    k = 0
    while stack:
        u, processed = stack.pop()
        if processed:
            tout[u] = t
            continue
        tin[u] = t
        t += 1
        order[k] = u
        k += 1
        stack.append((u, True))
        for ei in range(indptr[u], indptr[u + 1]):
            v = indices[ei]
            if not visited[v]:
                visited[v] = True
                parent[v] = u
                parent_w[v] = data[ei]
                stack.append((v, False))
    euler_pos = tin  # each vertex appears once at position tin
    return euler_pos, tin, tout, order, parent, parent_w


def tree_all_pairs(tree: WeightedTree, dtype=np.float64) -> np.ndarray:
    """All-pairs tree distances (O(N^2)); the BTFI preprocessing oracle."""
    n = tree.num_vertices
    euler_pos, tin, tout, order, parent, parent_w = _euler_intervals(tree)
    dist_e = np.zeros((n, n), dtype=dtype)  # rows: vertex id, cols: euler order
    root = order[0]
    # root row: distances from root, laid out in euler order
    d_root = np.zeros(n, dtype=np.float64)
    for u in order[1:]:
        d_root[u] = d_root[parent[u]] + parent_w[u]
    row = np.empty(n, dtype=dtype)
    row[euler_pos] = d_root.astype(dtype)
    dist_e[root] = row
    for u in order[1:]:
        w = dtype(parent_w[u])
        r = dist_e[parent[u]] + w
        r[tin[u]:tout[u]] -= dtype(2.0) * w
        dist_e[u] = r
    # un-permute columns back to vertex ids: out[u, v] = dist_e[u, euler_pos[v]]
    return dist_e[:, euler_pos]


def dijkstra(g: Graph, source: int) -> np.ndarray:
    """Single-source shortest paths on a weighted graph (binary heap)."""
    indptr, indices, data = g.csr()
    n = g.num_vertices
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    done = np.zeros(n, dtype=bool)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for ei in range(indptr[u], indptr[u + 1]):
            v = indices[ei]
            nd = d + data[ei]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def graph_all_pairs(g: Graph) -> np.ndarray:
    """All-pairs shortest paths (n x n float64) — baseline/oracle only.

    scipy.sparse.csgraph's Dijkstra from every source over the graph's
    adjacency, parallel edges reduced to their lightest (a CSR matrix would
    sum them). Each distance is the float64 sum of its path's weights from
    the source outward, as `dijkstra` sums it."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra as cs_dijkstra

    n = g.num_vertices
    u = np.concatenate([g.edges_u, g.edges_v]).astype(np.int64)
    v = np.concatenate([g.edges_v, g.edges_u]).astype(np.int64)
    w = np.concatenate([g.weights, g.weights])
    key = u * n + v
    order = np.lexsort((w, key))  # by (u, v), the lightest first
    key, w = key[order], w[order]
    first = np.r_[True, key[1:] != key[:-1]]
    key, w = key[first], w[first]
    adj = csr_matrix((w, (key // n, key % n)), shape=(n, n))
    return cs_dijkstra(adj, directed=True)
