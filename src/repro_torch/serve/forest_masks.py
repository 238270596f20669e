"""Forest-masked serving: one packed FTFI plan over every live slot's tree.

Each request may carry its own `WeightedTree` over its prompt tokens; the
engine packs the live slots' trees into ONE `Forest` and compiles a single
block-diagonal integration plan (`ftfi.build(forest, reweightable=True)`),
so a batched tree-masked prefill is one plan execution instead of one
build per request. The layout is block-diagonal (zero cross-tree
coupling), so rows of other slots, and ghost rows left by incremental
deletes, are neutral for any slot's attention output.

Membership churn is handled the cheap way wherever the layout allows:

* **admit** repacks (a join changes the packed row space): a full
  `ftfi.build`, content-addressed through the disk plan cache when
  configured;
* **evict** patches the live plan with `ftfi.update_plan` delete_leaf ops
  (leaves first, down to the tree's root, whose row the incremental engine
  cannot remove: it stays as a masked ghost); when the ghost fraction
  passes `rebuild_ghost_frac` the manager rebuilds.

Every installed plan (built, patched or loaded from the registry) goes
through `plan_guard.validate` before the engine reads it.

`PlanRegistry` is the content-addressed artifact store: `put(tree)`
compiles once and persists a `ftfi.save_plan` npz plus a tree sidecar
keyed by the plan fingerprint, so requests can name their topology by sha
(`Request(plan_sha=...)`). File names and npz layout are the reference's
(`repro.serve.forest_masks`): one directory serves both packages.
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch import ftfi
from repro_torch.core import plan_guard
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import Forest, WeightedTree


class PlanRegistry:
    """Content-addressed store of per-request tree plans.

    Layout: `<root>/plan-<sha>.npz` (a `ftfi.save_plan` artifact) and
    `<root>/tree-<sha>.npz` (the raw tree: the forest manager packs the
    topology itself, not the single-tree plan). `sha` is the first 12 hex
    characters of the plan's fingerprint, so the name certifies the
    content. Plans are built and resolved with params on `device` (None:
    the CUDA card)."""

    def __init__(self, root, leaf_size: int = 8, device=None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.leaf_size = int(leaf_size)
        self.device = resolve_device(device)
        self._trees: dict[str, WeightedTree] = {}

    def put(self, tree: WeightedTree) -> str:
        """Compile and persist `tree`; returns its content sha
        (idempotent)."""
        spec, params = ftfi.build(tree, leaf_size=self.leaf_size,
                                  reweightable=True, device=self.device)
        sha = spec.fingerprint[:12]
        plan_p = self.root / f"plan-{sha}.npz"
        if not plan_p.exists():
            ftfi.save_plan(plan_p, spec, params)
        tree_p = self.root / f"tree-{sha}.npz"
        if not tree_p.exists():
            np.savez(tree_p, num_vertices=np.int64(tree.num_vertices),
                     edges_u=np.asarray(tree.edges_u),
                     edges_v=np.asarray(tree.edges_v),
                     weights=np.asarray(tree.weights))
        self._trees[sha] = tree
        return sha

    def resolve(self, sha: str):
        """sha -> validated (spec, params); PlanValidationError on
        damage."""
        return ftfi.load_plan(self.root / f"plan-{sha}.npz",
                              device=self.device)

    def resolve_tree(self, sha: str) -> WeightedTree:
        """sha -> the raw WeightedTree (from the sidecar; cached)."""
        if sha not in self._trees:
            p = self.root / f"tree-{sha}.npz"
            if not p.exists():
                raise KeyError(f"plan registry has no tree for sha {sha}")
            with np.load(p) as z:
                self._trees[sha] = WeightedTree(
                    num_vertices=int(z["num_vertices"]),
                    edges_u=z["edges_u"], edges_v=z["edges_v"],
                    weights=z["weights"])
        return self._trees[sha]


def _peel_order(tree: WeightedTree, keep_local: int) -> list[int]:
    """Leaves-first deletion order for every vertex except `keep_local`.

    Each emitted vertex has degree 1 at its turn, which is what
    `update_plan`'s delete_leaf requires."""
    n = tree.num_vertices
    adj: list[set] = [set() for _ in range(n)]
    for u, v in zip(tree.edges_u, tree.edges_v):
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))
    order: list[int] = []
    frontier = [v for v in range(n) if len(adj[v]) == 1 and v != keep_local]
    while frontier:
        v = frontier.pop()
        order.append(v)
        for u in adj[v]:
            adj[u].discard(v)
            if len(adj[u]) == 1 and u != keep_local:
                frontier.append(u)
        adj[v].clear()
    return order


class ForestMaskManager:
    """Tracks which slot serves which tree and keeps ONE packed forest plan
    (spec, params on `device`) current across admissions and evictions.

    Offsets are per-slot row offsets into the packed space; `pack_maps`
    gives the (pack, unpack) index maps the tree-masked prefill reads for
    one prefill group. A group's maps cover ONLY that group's slots: other
    live blocks (and ghost rows) carry junk, but the block-diagonal mask
    gives them zero coupling with the group's rows.
    """

    def __init__(self, num_slots: int, leaf_size: int = 8,
                 rebuild_ghost_frac: float = 0.5, device=None):
        self.B = int(num_slots)
        self.leaf_size = int(leaf_size)
        self.rebuild_ghost_frac = float(rebuild_ghost_frac)
        self.device = resolve_device(device)
        self.slot_tree: list[WeightedTree | None] = [None] * self.B
        self.slot_offset = np.full(self.B, -1, dtype=np.int64)
        self.spec = self.params = None
        self.stats = {"builds": 0, "incremental_evictions": 0,
                      "ghost_rebuilds": 0, "fallback_rebuilds": 0,
                      "swaps_validated": 0}

    # -- plan membership ----------------------------------------------------

    def any_active(self) -> bool:
        return any(t is not None for t in self.slot_tree)

    def admit(self, slot: int, tree: WeightedTree) -> None:
        """Install `tree` for `slot`. Joins always repack: appending to a
        packed forest would need an insert_leaf cascade per vertex and a
        root graft the incremental engine does not support, while a fresh
        forest build is cached (memory and, when configured, disk)."""
        self.slot_tree[slot] = tree
        self._rebuild()

    def evict(self, slot: int) -> None:
        """Drop `slot`'s tree. Patches the live plan incrementally (other
        slots keep their row offsets) unless ghosts pile up or the
        incremental engine refuses (then a full rebuild, counted)."""
        tree = self.slot_tree[slot]
        if tree is None:
            return
        self.slot_tree[slot] = None
        if not self.any_active():
            self.spec = self.params = None
            self.slot_offset[:] = -1
            return
        off = int(self.slot_offset[slot])
        roots = self._plan_roots()
        keep = 0
        for v in range(tree.num_vertices):
            if off + v in roots:
                keep = v
                break
        ops = [("delete_leaf", off + v) for v in _peel_order(tree, keep)]
        try:
            self.spec, self.params = ftfi.update_plan(self.spec, self.params,
                                                      ops)
            self.stats["incremental_evictions"] += 1
            self.stats["swaps_validated"] += 1  # update_plan validates
        except (ValueError, ftfi.PlanValidationError):
            self.stats["fallback_rebuilds"] += 1
            self._rebuild()
            return
        self.slot_offset[slot] = -1
        ghosts = self.spec.ghosts
        n_ghost = 0 if ghosts is None else len(ghosts)
        if n_ghost > self.rebuild_ghost_frac * self.spec.n:
            self.stats["ghost_rebuilds"] += 1
            self._rebuild()

    def _plan_roots(self) -> set:
        """Vertices absent from the root-path CSR = the per-tree plan roots
        (delete_leaf cannot remove them)."""
        if self.spec is None or self.spec.path_rows is None:
            return set()
        return set(range(self.spec.n)) - set(
            int(v) for v in np.unique(self.spec.path_rows))

    def _rebuild(self) -> None:
        live = [(s, t) for s, t in enumerate(self.slot_tree) if t is not None]
        self.slot_offset[:] = -1
        if not live:
            self.spec = self.params = None
            return
        forest = Forest([t for _, t in live])
        self.spec, self.params = ftfi.build(forest, leaf_size=self.leaf_size,
                                            reweightable=True,
                                            device=self.device)
        plan_guard.validate(self.spec, self.params,
                            where="forest-mask swap")
        self.stats["builds"] += 1
        self.stats["swaps_validated"] += 1
        for (s, _), off in zip(live, forest.offsets[:-1]):
            self.slot_offset[s] = int(off)

    # -- index maps for the attention layer ---------------------------------

    def pack_maps(self, Lp: int, slots: list[int], batch_size: int):
        """(pack (N,), unpack (batch_size * Lp,)) int32 maps for a prefill
        group over the engine's full slot batch (batch row == slot index).

        Only the listed `slots`' blocks are mapped: every other packed row
        (other live slots mid-decode, ghosts) stays -1 and so contributes
        no mass and receives no field; every other batch row's tokens stay
        -1 and get zero attention output (those rows are length-0 padding
        in the prefill call anyway)."""
        if self.spec is None:
            raise RuntimeError("pack_maps called with no live forest plan")
        N = int(self.spec.n)
        pack = np.full(N, -1, dtype=np.int32)
        unpack = np.full(batch_size * Lp, -1, dtype=np.int32)
        for s in slots:
            tree = self.slot_tree[s]
            off = int(self.slot_offset[s])
            if tree is None or off < 0:
                raise RuntimeError(f"slot {s} has no tree in the forest plan")
            n = tree.num_vertices
            idx = np.arange(n, dtype=np.int32)
            pack[off + idx] = s * Lp + idx
            unpack[s * Lp + idx] = off + idx
        return pack, unpack
