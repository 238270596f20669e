"""Learnable tree metrics on the port: `reweightable=True` builds and
`ftfi.reweight` against the reference's on the same trees and weights.

The reweighted distances are held within 1e-6 of the largest distance
(float32 root-path sums may reassociate between `index_add_` and
`segment_sum`), `apply` on them within 1e-5 on both backends (backend
"cuda" on CPU tensors runs the kernel's plain version), and the edge
gradient of sum(R * apply(...)) within 1e-4 of its max against
`jax.grad`. Also the reference's own reweight cases, ported: birth params
reproduced, exactness under new weights (against the dense oracle),
central finite differences, forests with packed edges, and the error
cases."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import ftfi as R  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core.integrate import BTFI  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402

CPU = "cpu"
BACKENDS = ["torch", "cuda"]


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def _case(kind):
    """(reference object, port object, leaf size) on the same numbers."""
    if kind == "tree":
        return RG.random_tree(48, seed=4), TG.random_tree(48, seed=4), 8
    sizes = (12, 17, 9, 20)
    return (RG.Forest([RG.random_tree(s, seed=i)
                       for i, s in enumerate(sizes)]),
            TG.Forest([TG.random_tree(s, seed=i)
                       for i, s in enumerate(sizes)]), 6)


def _flat(params):
    return [np.asarray(a.detach().cpu() if hasattr(a, "detach") else a,
                       np.float64)
            for name in ("cross_tgt_d", "cross_src_d", "leaf_dists")
            for a in getattr(params, name)]


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The port's spec and the reference's readings at one set of weights,
    field and cotangent (computed once per kind, jitted: eager jax is
    slow): reweighted distances, apply, and the edge gradient of
    sum(R * apply)."""
    robj, tobj, leaf = _case(kind)
    rspec, _ = R.build(robj, leaf_size=leaf, reweightable=True)
    tspec, _ = T.build(tobj, leaf_size=leaf, reweightable=True, device=CPU)
    assert tspec.digest == rspec.digest  # the same tables, bit for bit
    rng = np.random.default_rng(3)
    w = rng.uniform(0.2, 1.5, tspec.num_edges).astype(np.float32)
    X = rng.normal(size=(tspec.n, 2)).astype(np.float32)
    Rw = rng.normal(size=(tspec.n, 2)).astype(np.float32)
    fm = R.fastmult(rspec, RC.Exponential(-0.8))

    def out(wj):
        return fm(R.reweight(rspec, wj), jnp.asarray(X))

    def loss(wj):
        return jnp.sum(jnp.asarray(Rw) * out(wj))

    want = {"dists": _flat(jax.jit(lambda wj: R.reweight(rspec, wj))(
                jnp.asarray(w))),
            "out": np.asarray(jax.jit(out)(jnp.asarray(w))),
            "grad": np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(w)))}
    return tspec, w, X, Rw, want


@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_reweighted_distances_match_reference(kind):
    tspec, w, _, _, want = _reference(kind)
    got = _flat(T.reweight(tspec, torch.from_numpy(w)))
    scale = max(float(np.max(np.abs(a))) for a in want["dists"])
    err = max(float(np.max(np.abs(g - r)))
              for g, r in zip(got, want["dists"]))
    assert err / scale <= 1e-6, err / scale


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_apply_on_reweighted_params_matches_reference(kind, backend):
    tspec, w, X, _, want = _reference(kind)
    got = T.apply(tspec, T.reweight(tspec, torch.from_numpy(w)),
                  TC.Exponential(-0.8), X, backend=backend, device=CPU)
    assert _rel(got, want["out"]) <= 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_edge_gradient_matches_jax_grad(kind, backend):
    tspec, w, X, Rw, want = _reference(kind)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = T.apply(tspec, T.reweight(tspec, wt), TC.Exponential(-0.8), X,
                  backend=backend, device=CPU)
    (out * torch.from_numpy(Rw)).sum().backward()
    g = want["grad"]
    assert np.abs(g).max() > 0
    assert float(np.abs(wt.grad.numpy() - g).max() / np.abs(g).max()) <= 1e-4


def test_reweight_identity_matches_birth_params():
    tree = TG.random_tree(45, seed=5)
    spec, params = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    fn = TC.Exponential(-0.6, 1.1)
    X = np.random.default_rng(0).normal(size=(45, 2))
    a = T.apply(spec, params, fn, X, device=CPU)
    for backend in BACKENDS:
        b = T.apply(spec, T.reweight(spec, tree.weights), fn, X,
                    backend=backend, device=CPU)
        assert _rel(b, a) < 1e-5


def test_reweight_exact_under_new_weights():
    """The IT decomposition is combinatorial, so reweighted params give the
    TRUE integration for any positive weights on the same topology."""
    rng = np.random.default_rng(7)
    tree = TG.random_tree(40, seed=3)
    spec, _ = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    w1 = rng.uniform(0.2, 2.0, size=tree.num_edges)
    t1 = TG.WeightedTree(tree.num_vertices, tree.edges_u, tree.edges_v, w1)
    fn = TC.Exponential(-0.6, 1.1)
    X = torch.tensor(rng.normal(size=(40, 2)), dtype=torch.float32)
    ref = BTFI(t1, dtype=torch.float64, device=CPU).integrate(fn, X.double())
    got = T.apply(spec, T.reweight(spec, w1), fn, X, device=CPU)
    assert _rel(got, ref) < 1e-5


def test_reweight_gradcheck_finite_differences():
    """Autograd through `reweight` edge weights matches central finite
    differences (the reference's gradcheck, on the port)."""
    rng = np.random.default_rng(8)
    tree = TG.random_tree(16, seed=8)
    spec, _ = T.build(tree, leaf_size=6, reweightable=True, device=CPU)
    fn = TC.Exponential(-0.8)
    X = torch.tensor(rng.normal(size=(16, 2)), dtype=torch.float32)
    Rw = torch.tensor(rng.normal(size=(16, 2)), dtype=torch.float32)
    w0 = torch.tensor(tree.weights, dtype=torch.float32)

    def loss(w):
        return torch.sum(Rw * T.apply(spec, T.reweight(spec, w), fn, X,
                                      device=CPU))

    w = w0.clone().requires_grad_(True)
    loss(w).backward()
    g = w.grad.numpy()
    assert np.all(np.isfinite(g)) and np.sum(np.abs(g)) > 0
    h = 3e-3
    for i in range(w0.shape[0]):
        e = torch.zeros_like(w0)
        e[i] = h
        fd = (float(loss(w0 + e)) - float(loss(w0 - e))) / (2 * h)
        ref_scale = max(abs(fd), float(np.max(np.abs(g))), 1e-4)
        assert abs(g[i] - fd) / ref_scale < 5e-2, (i, g[i], fd)


def test_reweight_requires_reweightable_spec():
    tree = TG.random_tree(20, seed=1)
    spec, _ = T.build(tree, leaf_size=8, device=CPU)
    with pytest.raises(ValueError, match="reweightable"):
        T.reweight(spec, tree.weights)
    rspec, _ = T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    assert rspec.grid_h is None  # a trained metric has no static grid
    with pytest.raises(ValueError, match="edge_w"):
        T.reweight(rspec, np.ones(3))


def test_reweight_forest_packed_edges():
    """Forest reweight: one packed edge vector re-derives every tree's
    block, and per-tree output weights ride along."""
    rng = np.random.default_rng(9)
    trees = [TG.random_tree(12, seed=i) for i in range(3)]
    forest = TG.Forest(trees)
    spec, _ = T.build(forest, leaf_size=6, reweightable=True, device=CPU)
    w1 = rng.uniform(0.3, 1.5, size=spec.num_edges)
    tw = rng.uniform(0.5, 2.0, size=3)
    fn = TC.Exponential(-0.5)
    X = torch.tensor(rng.normal(size=(forest.num_vertices, 2)),
                     dtype=torch.float32)
    off, parts = 0, []
    for t, (a, b) in zip(trees, zip(forest.offsets[:-1], forest.offsets[1:])):
        t1 = TG.WeightedTree(t.num_vertices, t.edges_u, t.edges_v,
                             w1[off:off + t.num_edges])
        off += t.num_edges
        parts.append(BTFI(t1, dtype=torch.float64, device=CPU).integrate(
            fn, X[a:b].double()))
    ref = torch.cat(parts) * torch.from_numpy(
        forest.broadcast(tw))[:, None]
    got = T.apply(spec, T.reweight(spec, w1, tree_w=tw), fn, X, device=CPU)
    assert _rel(got, ref) < 1e-5
