"""FRT trees (Fakcharoenphol–Rao–Talwar 2004): randomized O(log n)-distortion
hierarchically-separated tree embeddings — the paper's Fig-4 baseline.

The HST's leaves are the graph vertices; internal nodes are cluster ids.
Returned as a WeightedTree over (n_leaves + n_internal) vertices with
`leaf_ids` mapping graph vertex -> tree vertex, so FTFI runs on it directly
(field zero on internal nodes).

The FRT guarantee is in EXPECTATION over the random permutation/radius, so
the paper's Fig-4 metric approximation averages over k sampled trees:
`frt_forest` samples k trees and `frt_integrate_forest` runs them as ONE
fused forest integration (one plan execution for all k trees), averaging
the per-tree leaf outputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.graph import Forest, Graph, WeightedTree
from repro_torch.graphs.traverse import graph_all_pairs


def frt_tree(g: Graph, seed: int = 0, D: np.ndarray | None = None):
    """Returns (tree, leaf_ids) — leaf_ids[v] is the tree vertex of graph
    vertex v (identity: leaves occupy ids 0..n-1). `D` is the all-pairs
    graph metric; pass it in when sampling many trees of one graph (the
    Dijkstra sweep dominates construction and is seed-independent)."""
    rng = np.random.default_rng(seed)
    if D is None:
        D = graph_all_pairs(g)
    n = g.num_vertices
    diam = float(D.max())
    beta = float(rng.uniform(1.0, 2.0))
    perm = rng.permutation(n)
    D_perm = D[perm]  # row r: distances from the r-th center in perm order

    # levels: delta_i = beta * 2^i ; top level has one cluster of radius >= diam
    top = 0
    while beta * (2.0 ** top) < diam:
        top += 1

    edges_u, edges_v, weights = [], [], []
    next_id = n  # internal node ids start after the leaves

    def build(members: np.ndarray, level: int) -> int:
        """Returns the tree node id representing this cluster."""
        nonlocal next_id
        if members.size == 1:
            return int(members[0])
        if level < -60:  # duplicate points (zero distance): numeric guard
            root = int(members[0])
            for m in members[1:]:
                edges_u.append(root)
                edges_v.append(int(m))
                weights.append(1e-12)
            return root
        node = next_id
        next_id += 1
        delta_child = beta * (2.0 ** (level - 1))
        # edge weight = parent's delta: guarantees d_T(u,v) >= 2*delta_level
        # >= d_G(u,v) for pairs separated at this level (domination)
        w_edge = beta * (2.0 ** level)
        # partition: each member joins the first center (in perm order)
        # within distance delta_child: the first True down each column
        # (every member is within 0 of itself, so one exists)
        assigned = np.argmax(D_perm[:, members] < delta_child, axis=0)
        for rank in np.unique(assigned):
            sub = members[assigned == rank]
            child = build(sub, level - 1)
            edges_u.append(node)
            edges_v.append(child)
            weights.append(w_edge)
        return node

    root = build(np.arange(n), top)
    tree = WeightedTree(next_id, np.array(edges_u), np.array(edges_v),
                        np.array(weights))
    return tree, np.arange(n)


def frt_integrate(g: Graph, fn, X: np.ndarray, seed: int = 0, leaf_size=64):
    """f-integration of a leaf field using ONE sampled FRT tree metric."""
    from repro_torch.core.integrate import FTFI

    tree, leaf_ids = frt_tree(g, seed)
    Xfull = np.zeros((tree.num_vertices,) + X.shape[1:], dtype=X.dtype)
    Xfull[leaf_ids] = X
    out = FTFI(tree, leaf_size=leaf_size).integrate(fn, Xfull)
    return out[leaf_ids]


def frt_forest(g: Graph, num_trees: int, seed: int = 0,
               D: np.ndarray | None = None):
    """Sample `num_trees` independent FRT trees of `g` as one `Forest`.

    The seed-independent all-pairs metric is computed ONCE and shared by
    every sample (pass `D` to reuse an already-computed metric). Returns
    (forest, leaf_ids): graph vertex v of tree t sits at packed row
    `forest.offsets[t] + leaf_ids[v]` (leaf ids are the identity 0..n-1)."""
    if D is None:
        D = graph_all_pairs(g)
    trees = [frt_tree(g, seed=seed + 977 * t, D=D)[0]
             for t in range(num_trees)]
    return Forest(trees), np.arange(g.num_vertices)


def forest_leaf_integrate(forest: Forest, leaf_ids: np.ndarray, integrator,
                          fn, X: np.ndarray) -> np.ndarray:
    """One fused integration of a leaf field over every tree of an FRT
    forest, averaged: the field is replicated into each tree's block at
    `offsets[t] + leaf_ids` (zero on internal cluster vertices), one
    `integrator.integrate` call covers all trees, and the per-tree leaf
    outputs are meaned. Reused by callers that sweep many f over one
    prebuilt forest (e.g. the Fig-4 bench). A numpy result (the host
    backend) comes back as numpy, a tensor on its device."""
    X = np.asarray(X)
    off = forest.offsets
    Xp = np.zeros((forest.num_vertices,) + X.shape[1:], dtype=X.dtype)
    for t in range(forest.num_trees):
        Xp[off[t] + leaf_ids] = X
    out = integrator.integrate(fn, Xp)
    if isinstance(out, torch.Tensor):  # the plan backends: on its device
        rows = torch.from_numpy(np.concatenate(
            [off[t] + leaf_ids for t in range(forest.num_trees)])).to(
                out.device)
        return out[rows].reshape(forest.num_trees, -1,
                                 *out.shape[1:]).mean(dim=0)
    return np.mean(np.stack([out[off[t] + leaf_ids]
                             for t in range(forest.num_trees)]), axis=0)


def frt_integrate_forest(g: Graph, fn, X: np.ndarray, num_trees: int = 8,
                         seed: int = 0, leaf_size: int = 64,
                         backend: str = "torch", device=None):
    """Averaged f-integration over `num_trees` sampled FRT tree metrics as
    ONE batched forest integration (Fig. 4's expectation estimate), on
    `backend` ("torch" or "cuda" on `device`, None: the CUDA card; or
    "host")."""
    from repro_torch.core.engines import Integrator

    forest, leaf_ids = frt_forest(g, num_trees, seed=seed)
    integ = Integrator.from_forest(forest, backend=backend,
                                   leaf_size=leaf_size, device=device)
    return forest_leaf_integrate(forest, leaf_ids, integ, fn, X)
