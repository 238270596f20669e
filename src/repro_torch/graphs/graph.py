"""Weighted undirected graphs and trees (host-side numpy).

All heavy per-field computation happens in PyTorch; graph *construction* and
decomposition are host-side preprocessing (built once per topology, reused for
any number of tensor fields — matching the paper's IT amortization argument).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph in COO form with a CSR adjacency view."""

    num_vertices: int
    edges_u: np.ndarray  # (E,) int32
    edges_v: np.ndarray  # (E,) int32
    weights: np.ndarray  # (E,) float64, positive

    # CSR adjacency (built lazily)
    _indptr: np.ndarray | None = None
    _indices: np.ndarray | None = None
    _data: np.ndarray | None = None

    def __post_init__(self):
        self.edges_u = np.asarray(self.edges_u, dtype=np.int32)
        self.edges_v = np.asarray(self.edges_v, dtype=np.int32)
        self.weights = np.asarray(self.weights, dtype=np.float64)
        if self.weights.size and self.weights.min() <= 0:
            raise ValueError("edge weights must be positive")

    @property
    def num_edges(self) -> int:
        return int(self.edges_u.shape[0])

    def csr(self):
        """Symmetric CSR adjacency: (indptr, indices, data)."""
        if self._indptr is None:
            n = self.num_vertices
            u = np.concatenate([self.edges_u, self.edges_v])
            v = np.concatenate([self.edges_v, self.edges_u])
            w = np.concatenate([self.weights, self.weights])
            order = np.argsort(u, kind="stable")
            u, v, w = u[order], v[order], w[order]
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(indptr, u + 1, 1)
            np.cumsum(indptr, out=indptr)
            self._indptr, self._indices, self._data = indptr, v, w
        return self._indptr, self._indices, self._data


class WeightedTree(Graph):
    """A connected acyclic Graph (N-1 edges). Construction validates tree-ness."""

    def __post_init__(self):
        super().__post_init__()
        if self.num_edges != self.num_vertices - 1:
            raise ValueError(
                f"tree must have N-1 edges, got {self.num_edges} for N={self.num_vertices}"
            )


class Forest:
    """An ordered collection of `WeightedTree`s integrated as ONE unit.

    The packed-field layout is the concatenation of the per-tree vertex
    spaces: vertex v of tree t lives at global row `offsets[t] + v`, so a
    packed field has shape (sum_t n_t, d) and a forest integration is a
    block-diagonal multiply — every tree's M_f applied to its own rows, with
    zero cross-tree coupling. `compile_forest_plan`
    (repro_torch.core.integrate) compiles the whole forest into one fused
    IntegrationPlan; `repro_torch.ftfi.build` is the public entry point.
    """

    def __init__(self, trees):
        trees = list(trees)
        if not trees:
            raise ValueError("Forest needs at least one tree")
        for t in trees:
            if not isinstance(t, WeightedTree):
                raise TypeError(
                    f"Forest members must be WeightedTree, got {type(t).__name__}")
        self.trees = trees
        sizes = np.array([t.num_vertices for t in trees], dtype=np.int64)
        self.offsets = np.zeros(sizes.size + 1, dtype=np.int64)
        np.cumsum(sizes, out=self.offsets[1:])

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    @property
    def num_vertices(self) -> int:
        """Total vertices across the forest (the packed-field length)."""
        return int(self.offsets[-1])

    @property
    def tree_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def pack(self, fields) -> np.ndarray:
        """Stack per-tree fields [(n_t, ...)] into one packed (N, ...) field."""
        fields = [np.asarray(f) for f in fields]
        if len(fields) != self.num_trees:
            raise ValueError(
                f"expected {self.num_trees} fields, got {len(fields)}")
        for t, f in enumerate(fields):
            if f.shape[0] != int(self.offsets[t + 1] - self.offsets[t]):
                raise ValueError(
                    f"field {t}: {f.shape[0]} rows != tree size "
                    f"{int(self.offsets[t + 1] - self.offsets[t])}")
        return np.concatenate(fields, axis=0)

    def unpack(self, X) -> list:
        """Split a packed (N, ...) array into per-tree views [(n_t, ...)]."""
        X = np.asarray(X)
        if X.shape[0] != self.num_vertices:
            raise ValueError(
                f"packed field has {X.shape[0]} rows, forest has "
                f"{self.num_vertices} vertices")
        return [X[self.offsets[t]:self.offsets[t + 1]]
                for t in range(self.num_trees)]

    def broadcast(self, per_tree) -> np.ndarray:
        """Broadcast per-tree coefficients (K,) or (K, d) to per-vertex rows
        (N,) / (N, d) of the packed layout — e.g. FRT averaging weights or
        per-request mask scales applied to a packed field/output."""
        per_tree = np.asarray(per_tree)
        if per_tree.shape[0] != self.num_trees:
            raise ValueError(
                f"expected leading dim {self.num_trees}, got {per_tree.shape}")
        return np.repeat(per_tree, self.tree_sizes, axis=0)

    def __repr__(self):
        return (f"Forest(num_trees={self.num_trees}, "
                f"num_vertices={self.num_vertices})")


# ----------------------------------------------------------------------------
# Generators (procedural substitutes for the paper's datasets; see DESIGN §7)
# ----------------------------------------------------------------------------

def path_graph(n: int, weights: np.ndarray | None = None) -> WeightedTree:
    w = np.ones(n - 1) if weights is None else np.asarray(weights, dtype=np.float64)
    return WeightedTree(n, np.arange(n - 1), np.arange(1, n), w)


def random_tree(n: int, seed: int = 0, weight_range=(0.1, 1.0)) -> WeightedTree:
    """Uniform random attachment tree with random weights."""
    rng = np.random.default_rng(seed)
    parents = np.array([rng.integers(0, i) for i in range(1, n)], dtype=np.int32)
    w = rng.uniform(*weight_range, size=n - 1)
    return WeightedTree(n, parents, np.arange(1, n, dtype=np.int32), w)


def caterpillar_tree(n: int, seed: int = 0) -> WeightedTree:
    """Path spine with leaves — adversarial for naive separators."""
    rng = np.random.default_rng(seed)
    spine = n // 2
    u = list(range(spine - 1))
    v = list(range(1, spine))
    for leaf in range(spine, n):
        u.append(int(rng.integers(0, spine)))
        v.append(leaf)
    w = rng.uniform(0.1, 1.0, size=n - 1)
    return WeightedTree(n, np.array(u), np.array(v), w)


def star_tree(n: int, seed: int = 0) -> WeightedTree:
    rng = np.random.default_rng(seed)
    return WeightedTree(
        n, np.zeros(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32),
        rng.uniform(0.1, 1.0, size=n - 1),
    )


def synthetic_graph(n: int, extra_edges: int, seed: int = 0,
                    weight_range=(0.1, 1.0)) -> Graph:
    """Paper Sec 4.1: path graph + random extra edges with random weights."""
    rng = np.random.default_rng(seed)
    u = list(range(n - 1))
    v = list(range(1, n))
    seen = set(zip(u, v))
    added = 0
    while added < extra_edges:
        a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
        if a == b:
            continue
        a, b = min(a, b), max(a, b)
        if (a, b) in seen:
            continue
        seen.add((a, b))
        u.append(a)
        v.append(b)
        added += 1
    w = rng.uniform(*weight_range, size=len(u))
    return Graph(n, np.array(u), np.array(v), w)


def grid_graph(rows: int, cols: int, seed: int | None = None) -> Graph:
    """2D grid graph (the TopoViT image-patch encoding). Unit or jittered weights."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    if seed is None:
        w = np.ones(u.size)
    else:
        w = np.random.default_rng(seed).uniform(0.5, 1.5, size=u.size)
    return Graph(rows * cols, u, v, w)


def random_graph_family(kind: str, n: int, seed: int) -> Graph:
    """Graph-classification families (substitute for TUDatasets; DESIGN §7).

    Three structurally distinct families whose f-distance spectra differ:
      'ring_lattice'  — Watts-Strogatz-like ring with shortcuts
      'pref_attach'   — Barabasi-Albert-like preferential attachment
      'community'     — two dense communities with a sparse bridge
    """
    rng = np.random.default_rng(seed)
    if kind == "ring_lattice":
        u = list(range(n)) + list(range(n))
        v = [(i + 1) % n for i in range(n)] + [(i + 2) % n for i in range(n)]
        nshort = max(1, n // 10)
        for _ in range(nshort):
            a, b = rng.integers(0, n, size=2)
            if a != b:
                u.append(int(a)); v.append(int(b))
    elif kind == "pref_attach":
        u, v = [0], [1]
        degree = [1, 1]
        for newv in range(2, n):
            for _ in range(2):
                probs = np.array(degree) / sum(degree)
                t = int(rng.choice(newv, p=probs))
                u.append(t); v.append(newv)
                degree[t] += 1
            degree.append(2)
    elif kind == "community":
        half = n // 2
        u, v = [], []
        for comm in (range(half), range(half, n)):
            comm = list(comm)
            for i in comm:
                for _ in range(3):
                    j = int(rng.choice(comm))
                    if i != j:
                        u.append(i); v.append(j)
        u.append(0); v.append(half)  # bridge
        # ensure connectivity inside communities via a spine
        u += list(range(n - 1)); v += list(range(1, n))
    else:
        raise ValueError(kind)
    # dedupe
    uu, vv = np.minimum(u, v), np.maximum(u, v)
    pairs = np.unique(np.stack([uu, vv], 1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    w = rng.uniform(0.5, 1.5, size=pairs.shape[0])
    return Graph(n, pairs[:, 0], pairs[:, 1], w)
