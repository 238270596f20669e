"""Incremental plan updates on the port (`ftfi.update_plan`).

The oracle is the reference's: after any sequence of insert_leaf /
delete_leaf / reweight ops, integrating through the patched plan must
match a from-scratch reweightable build of the edited tree or forest on the
live rows (within 2e-5 relative, `TOL` of tests/test_plan_update.py), and
ghost rows must be exactly zero and ignore their input. Here the single-op
cases and the random op sweeps of that file are one parametrised test on
the port alone; then the port's `update_plan` is held against the
reference's on the same ops (every index table equal, distances within
1e-6), and the reference's error, provenance and peel-to-root cases run
on the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import ftfi as R  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402

CPU = "cpu"
FNS = [TC.Exponential(-0.5, 1.1), TC.Polynomial((0.4, -0.15, 0.05))]
TOL = 2e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


class _Model:
    """Pure-python mirror of update_plan's id/edge semantics (the
    reference test's), used to build the rebuild oracle."""

    def __init__(self, trees):
        self.sizes = [t.num_vertices for t in trees]
        self.edges = [[(int(u), int(v), float(w)) for u, v, w in
                       zip(t.edges_u, t.edges_v, t.weights)] for t in trees]
        self.ghosts = [set() for _ in trees]

    def offsets(self):
        return np.concatenate([[0], np.cumsum(self.sizes)])

    def locate(self, g):
        off = self.offsets()
        t = int(np.searchsorted(off, g, side="right")) - 1
        return t, int(g - off[t])

    def insert(self, parent_g, w):
        t, p = self.locate(parent_g)
        v = self.sizes[t]
        self.edges[t].append((p, v, float(w)))
        self.sizes[t] += 1
        return int(self.offsets()[t]) + v

    def degree(self, t, v):
        return sum(v in (u, x) for u, x, _ in self.edges[t])

    def delete(self, g):
        t, v = self.locate(g)
        assert self.degree(t, v) == 1 and v != 0
        self.edges[t] = [e for e in self.edges[t] if v not in e[:2]]
        self.ghosts[t].add(v)

    def reweight(self, rng):
        w = rng.uniform(0.1, 2.0, sum(len(e) for e in self.edges))
        i = 0
        for t in range(len(self.edges)):
            self.edges[t] = [(u, v, float(w[i + j]))
                             for j, (u, v, _) in enumerate(self.edges[t])]
            i += len(self.edges[t])
        return w

    def live_leaves(self):
        out = []
        off = self.offsets()
        for t in range(len(self.edges)):
            deg = {}
            for u, v, _ in self.edges[t]:
                deg[u] = deg.get(u, 0) + 1
                deg[v] = deg.get(v, 0) + 1
            out += [int(off[t]) + v for v, d in deg.items()
                    if d == 1 and v != 0 and v not in self.ghosts[t]]
        return out

    def live_vertices(self):
        off = self.offsets()
        return [int(off[t]) + v for t in range(len(self.sizes))
                for v in range(self.sizes[t]) if v not in self.ghosts[t]]

    def rebuild(self):
        """(tree_or_forest, live_global_rows): compacted rebuild oracle."""
        trees, rows = [], []
        off = self.offsets()
        for t in range(len(self.sizes)):
            live = [v for v in range(self.sizes[t])
                    if v not in self.ghosts[t]]
            relab = {v: i for i, v in enumerate(live)}
            eu = [relab[u] for u, v, _ in self.edges[t]]
            ev = [relab[v] for _, v, _ in self.edges[t]]
            w = [x for _, _, x in self.edges[t]]
            trees.append(TG.WeightedTree(len(live), eu, ev, w))
            rows += [int(off[t]) + v for v in live]
        obj = trees[0] if len(trees) == 1 else TG.Forest(trees)
        return obj, np.asarray(rows)


def _apply(spec, params, fn, X, backend="torch"):
    return T.apply(spec, params, fn, X, backend=backend, device=CPU).numpy()


def _check_vs_rebuild(spec, params, model, rng, label):
    obj, rows = model.rebuild()
    rspec, rparams = T.build(obj, leaf_size=8, reweightable=True, device=CPU)
    X = rng.normal(size=(spec.n, 3)).astype(np.float32)
    for fn in FNS:
        ref = _apply(rspec, rparams, fn, X[rows])
        for backend in ("torch", "cuda"):
            got = _apply(spec, params, fn, X, backend)
            assert _rel(got[rows], ref) < TOL, (label, backend)
            ghost_rows = np.setdiff1d(np.arange(spec.n), rows)
            if ghost_rows.size:
                assert float(np.max(np.abs(got[ghost_rows]))) == 0.0, label
                X2 = X.copy()
                X2[ghost_rows] = 1e6
                got2 = _apply(spec, params, fn, X2, backend)
                assert _rel(got2[rows], ref) < TOL, (label, backend)


def _random_ops(model, rng, count):
    ops = []
    for _ in range(count):
        kind = rng.choice(["insert", "insert", "delete", "reweight"])
        if kind == "insert":
            parent = int(rng.choice(model.live_vertices()))
            w = float(rng.uniform(0.2, 1.5))
            model.insert(parent, w)
            ops.append(("insert_leaf", parent, w))
        elif kind == "delete":
            leaves = model.live_leaves()
            if leaves:
                v = int(rng.choice(leaves))
                model.delete(v)
                ops.append(("delete_leaf", v))
        else:
            ops.append(("reweight", model.reweight(rng)))
    return ops


def _trees(G, forest, seed):
    rng = np.random.default_rng(seed)
    if forest:
        return [G.random_tree(int(s), seed=seed * 10 + i)
                for i, s in enumerate(rng.integers(10, 30, size=4))]
    return [G.random_tree(40 + 5 * seed, seed=seed)]


CASES = ([("insert", False, s) for s in (0, 1)]
         + [("delete", False, s) for s in (0, 1)]
         + [("reweight", False, s) for s in (0, 1)]
         + [("sweep", forest, s) for forest, s in
            ((False, 3), (False, 4), (True, 5), (True, 6))])


@pytest.mark.parametrize("case,forest,seed", CASES)
def test_update_matches_rebuild(case, forest, seed):
    """The single-op cases (insert, delete, reweight) and the random mixed
    op sweeps (chained generations and one batch, trees and forests) of
    tests/test_plan_update.py, against the port's own rebuild."""
    rng = np.random.default_rng(seed)
    trees = _trees(TG, forest, seed)
    obj = trees[0] if len(trees) == 1 else TG.Forest(trees)
    spec0, pp0 = T.build(obj, leaf_size=8, reweightable=True, device=CPU)
    model = _Model(trees)
    if case == "insert":
        parent = int(rng.choice(model.live_vertices()))
        model.insert(parent, 0.7)
        s, p = T.update_plan(spec0, pp0, [("insert_leaf", parent, 0.7)])
    elif case == "delete":
        leaf = int(rng.choice(model.live_leaves()))
        model.delete(leaf)
        s, p = T.update_plan(spec0, pp0, [("delete_leaf", leaf)])
    elif case == "reweight":
        s, p = T.update_plan(spec0, pp0, [("reweight", model.reweight(rng))])
    else:
        ops = _random_ops(model, rng, 8)
        s, p = spec0, pp0
        for op in ops:  # chained: each op patches the previous generation
            s, p = T.update_plan(s, p, [op])
        _check_vs_rebuild(s, p, model, rng, f"chained seed={seed}")
        sb, pb = T.update_plan(spec0, pp0, ops)  # one batch
        assert sb.fingerprint == s.fingerprint
        s, p = sb, pb
    _check_vs_rebuild(s, p, model, rng, f"{case} seed={seed}")


@pytest.mark.parametrize("forest,seed", [(False, 7), (True, 8)])
def test_update_matches_reference_update(forest, seed):
    """The port's update_plan against the reference's on the same plan and
    ops: every index table and mask equal, fingerprints equal, the
    distances within 1e-6 (of the largest)."""
    rng = np.random.default_rng(seed)
    tt, rt = _trees(TG, forest, seed), _trees(RG, forest, seed)
    tobj = tt[0] if len(tt) == 1 else TG.Forest(tt)
    robj = rt[0] if len(rt) == 1 else RG.Forest(rt)
    ts, tp = T.build(tobj, leaf_size=8, reweightable=True, device=CPU)
    rs, rp = R.build(robj, leaf_size=8, reweightable=True)
    ops = _random_ops(_Model(tt), rng, 10)
    ts, tp = T.update_plan(ts, tp, ops)
    rs, rp = R.update_plan(rs, rp, ops)
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(rs, f.name)
        if f.name in ("cross_tgt_d0", "cross_src_d0", "leaf_dists0",
                      "edge_w0"):
            continue
        if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for name in ("cross_tgt_d", "cross_src_d", "leaf_dists"):
        for a, b in zip(getattr(tp, name), getattr(rp, name)):
            b = np.asarray(b, np.float64)
            scale = max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a.numpy() - b).max()) / scale <= 1e-6


def test_update_without_params_gives_reference_birth_params():
    """`update_plan(spec, None, ops, device="cpu")` returns the edited
    plan's birth params on the asked device, the reference's
    `update_plan(spec, None, ops)` params within 1e-6."""
    rng = np.random.default_rng(9)
    tt, rt = _trees(TG, False, 9), _trees(RG, False, 9)
    ts, _ = T.build(tt[0], leaf_size=8, reweightable=True, device=CPU)
    rs, _ = R.build(rt[0], leaf_size=8, reweightable=True)
    ops = _random_ops(_Model(tt), rng, 6)
    ts, tp = T.update_plan(ts, None, ops, device=CPU)
    rs, rp = R.update_plan(rs, None, ops)
    assert ts.digest == rs.digest
    for name in ("cross_tgt_d", "cross_src_d", "leaf_dists"):
        for a, b in zip(getattr(tp, name), getattr(rp, name)):
            assert a.device.type == CPU and a.dtype == torch.float32
            b = np.asarray(b, np.float64)
            scale = max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a.numpy() - b).max()) / scale <= 1e-6


def test_updated_plan_keeps_untouched_buckets():
    """Only the touched buckets are re-uploaded: an insert's untouched
    buckets keep the input params' tensors."""
    tree = TG.random_tree(60, seed=11)
    spec, pp = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    s, p = T.update_plan(spec, pp, [("insert_leaf", 7, 0.9)])
    kept = sum(a is b for a, b in zip(p.cross_tgt_d + p.leaf_dists,
                                      pp.cross_tgt_d + pp.leaf_dists))
    assert 0 < kept < len(pp.cross_tgt_d) + len(pp.leaf_dists)
    assert all(t.dtype == torch.float32 for t in p.cross_tgt_d)


def test_update_preserves_tree_w_and_chains_fingerprint():
    tree = TG.random_tree(30, seed=2)
    spec, pp = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    pp = dataclasses.replace(pp, tree_w=torch.tensor([1.5]))
    ops = [("insert_leaf", 5, 0.8), ("delete_leaf", 29)]
    s1, p1 = T.update_plan(spec, pp, ops)
    s2, p2 = T.update_plan(spec, pp, ops)
    assert s1.fingerprint == s2.fingerprint
    assert s1.fingerprint != spec.fingerprint
    assert s1.digest == s2.digest
    assert p1.tree_w is pp.tree_w


def test_update_error_cases():
    tree = TG.random_tree(30, seed=8)
    spec, pp = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    model = _Model([tree])
    leaf = model.live_leaves()[0]
    s0, p0 = T.build(tree, leaf_size=8, device=CPU)
    with pytest.raises(ValueError, match="reweightable"):
        T.update_plan(s0, p0, [("insert_leaf", 0, 1.0)])
    internal = next(v for v in range(30) if model.degree(0, v) > 1)
    with pytest.raises(ValueError, match="degree"):
        T.update_plan(spec, pp, [("delete_leaf", internal)])
    with pytest.raises(ValueError, match="out of range"):
        T.update_plan(spec, pp, [("insert_leaf", 30, 1.0)])
    with pytest.raises(ValueError, match="already deleted"):
        T.update_plan(spec, pp, [("delete_leaf", leaf),
                                 ("delete_leaf", leaf)])
    with pytest.raises(ValueError, match="was deleted"):
        T.update_plan(spec, pp, [("delete_leaf", leaf),
                                 ("insert_leaf", leaf, 1.0)])
    with pytest.raises(ValueError, match="edge weights"):
        T.update_plan(spec, pp, [("reweight", np.ones(7))])
    with pytest.raises(ValueError, match="unknown update op"):
        T.update_plan(spec, pp, [("frobnicate", 3)])
    sharded = dataclasses.replace(spec, mesh_devices=4, shard_layout=1)
    with pytest.raises(NotImplementedError, match="A12"):
        T.update_plan(sharded, pp, [("insert_leaf", 0, 1.0)])


def test_deleting_all_but_root_leaves_zero_plan():
    tree = TG.random_tree(10, seed=13)
    spec, pp = T.build(tree, leaf_size=4, reweightable=True, device=CPU)
    model = _Model([tree])
    while model.live_leaves():
        v = model.live_leaves()[0]
        model.delete(v)
        spec, pp = T.update_plan(spec, pp, [("delete_leaf", v)])
    assert sorted(model.live_vertices()) == [0]
    fn = TC.Exponential(-0.3, 2.0)
    X = np.ones((spec.n, 2), np.float32)
    out = _apply(spec, pp, fn, X)
    np.testing.assert_allclose(out[0], fn.f0 * X[0], rtol=1e-6)
    assert float(np.max(np.abs(out[1:]))) == 0.0
