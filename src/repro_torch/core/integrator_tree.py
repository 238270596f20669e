"""IntegratorTree (IT): the paper's Sec-3.1 data structure.

The recursive `ITNode` view over the flat, vectorized builder in
`repro_torch.core.itree_flat` (frontier-at-a-time numpy, content-hash
cached): `build_integrator_tree` materializes it for the host FTFI walk
(`integrate.FTFI`); the plan compiler consumes the flat form directly.

Each non-leaf node stores the balanced-separator split (T_left, T_right,
pivot) from Lemma 3.1 plus the distance-group arrays (left-ids / left-d /
left-id-d); vertex ids are ordered by ascending pivot distance, so the
segment-sum layout (`left_sorted_ids`, `left_seg_starts`) coincides with the
id arrays themselves.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.itree_flat import FlatIT, build_flat_it
from repro_torch.graphs.graph import WeightedTree


@dataclasses.dataclass(frozen=True)
class ITNode:
    """Immutable IT node: every array an integrator needs is computed once at
    build time, so the same IT can be walked concurrently from many threads
    and reused across plans without integrate-time mutation."""

    vertex_ids: np.ndarray  # (k,) global ids of this sub-tree's vertices
    depth: int
    # leaf payload: raw pairwise distances for the sub-tree (f applied lazily)
    leaf_dists: np.ndarray | None = None
    # internal payload
    pivot: int | None = None  # global id
    left: "ITNode | None" = None
    right: "ITNode | None" = None
    left_ids: np.ndarray | None = None  # (kL,) global ids (incl. pivot)
    right_ids: np.ndarray | None = None
    left_d: np.ndarray | None = None  # (uL,) unique pivot distances (left_d[0]=0)
    right_d: np.ndarray | None = None
    left_id_d: np.ndarray | None = None  # (kL,) index into left_d per vertex
    right_id_d: np.ndarray | None = None
    # segment-sum layout per side: vertex ids sorted by distance group (stable)
    # plus the run boundaries of equal groups — np.add.reduceat over these is
    # ~50x faster than np.add.at for wide fields (e.g. GW transport plans)
    left_sorted_ids: np.ndarray | None = None  # (kL,) ids ordered by left_id_d
    left_seg_starts: np.ndarray | None = None  # (uL,) run starts in the order
    right_sorted_ids: np.ndarray | None = None
    right_seg_starts: np.ndarray | None = None

    @property
    def is_leaf(self) -> bool:
        return self.leaf_dists is not None


def _materialize(flat: FlatIT, ref: int) -> ITNode:
    if ref < 0:
        li = -ref - 1
        return ITNode(vertex_ids=flat.leaf_ids[li],
                      depth=int(flat.leaf_depth[li]),
                      leaf_dists=flat.leaf_dists[li])
    L, R = flat.left[ref], flat.right[ref]
    return ITNode(
        vertex_ids=np.concatenate([L.ids, R.ids[1:]]),
        depth=int(flat.node_depth[ref]),
        pivot=int(flat.pivots[ref]),
        left=_materialize(flat, int(flat.children[ref, 0])),
        right=_materialize(flat, int(flat.children[ref, 1])),
        left_ids=L.ids, right_ids=R.ids,
        left_d=L.d, right_d=R.d,
        left_id_d=L.id_d, right_id_d=R.id_d,
        # ids are emitted in ascending-distance order, so the segment layout
        # is the identity permutation
        left_sorted_ids=L.ids, left_seg_starts=L.seg_starts,
        right_sorted_ids=R.ids, right_seg_starts=R.seg_starts,
    )


def build_integrator_tree(tree: WeightedTree, leaf_size: int = 64,
                          seed: int = 0) -> ITNode:
    """Construct the IT for `tree` (paper Sec 3.1). leaf_size = t (>=6).

    Delegates to the flat vectorized builder (cached per tree content hash)
    and materializes the recursive node view on top of its arrays.
    """
    flat = build_flat_it(tree, leaf_size=leaf_size, seed=seed)
    return _materialize(flat, flat.root_ref)


def it_stats(root: ITNode) -> dict:
    """Diagnostics: depth, node counts, balance check."""
    stats = {"max_depth": 0, "internal": 0, "leaves": 0, "balance_ok": True}

    def walk(node: ITNode):
        stats["max_depth"] = max(stats["max_depth"], node.depth)
        if node.is_leaf:
            stats["leaves"] += 1
            return
        stats["internal"] += 1
        nn = node.vertex_ids.size
        for side in (node.left_ids, node.right_ids):
            if not (nn / 4.0 <= side.size):
                stats["balance_ok"] = False
        walk(node.left)
        walk(node.right)

    walk(root)
    return stats
