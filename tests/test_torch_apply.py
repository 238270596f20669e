"""The port's `apply` against the reference's on the same numpy inputs:
backend "torch" vs "plan" and backend "cuda" on CPU tensors (the kernel's
plain version) vs "pallas" (interpret mode), on a random tree, a grid MST
(Hankel engine) and a mixed forest with per-tree weights; plans carried
across through the reference's npz and through `from_numpy`; and the
device rule (no device means the card, and no card means an error)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import ftfi as R  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import mst as RMST  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import mst as TMST  # noqa: E402
from repro_torch.kernels.fdist_matvec import ops  # noqa: E402


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


# (reference f, port f): the families of the slice, built from the same
# numbers in each package
FAMILIES = {
    "Exponential": (RC.Exponential(-0.7, 1.3), TC.Exponential(-0.7, 1.3)),
    "Polynomial": (RC.Polynomial((0.5, -0.2, 0.1)),
                   TC.Polynomial((0.5, -0.2, 0.1))),
    "ExpQuadratic": (RC.ExpQuadratic(-0.05, -0.2, 0.1),
                     TC.ExpQuadratic(-0.05, -0.2, 0.1)),
    "Rational": (RC.Rational((1.0,), (1.0, 0.0, 0.8)),
                 TC.Rational((1.0,), (1.0, 0.0, 0.8))),
    "AnyFn": (RC.AnyFn(lambda z: 1.0 / (1.0 + z)),
              TC.AnyFn(lambda z: 1.0 / (1.0 + z))),
}
TOPOLOGIES = {
    "random_tree": (lambda G, M: G.random_tree(260, seed=1), 16),
    "grid_mst": (lambda G, M: M.minimum_spanning_tree(G.grid_graph(13, 17)),
                 16),
}
BACKENDS = [("torch", "plan"), ("cuda", "pallas")]


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_apply_matches_reference(family, topology, port_backend, ref_backend):
    make, leaf = TOPOLOGIES[topology]
    rtree, ttree = make(RG, RMST), make(TG, TMST)
    X = np.random.default_rng(5).normal(size=(rtree.num_vertices, 3))
    rf, tf = FAMILIES[family]
    rs, rp = R.build(rtree, leaf_size=leaf)
    ts, tp = T.build(ttree, leaf_size=leaf, device="cpu")
    want = np.asarray(jax.jit(R.fastmult(rs, rf, backend=ref_backend))(
        rp, jnp.asarray(X, jnp.float32)))
    got = T.apply(ts, tp, tf, X, backend=port_backend, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert _rel(got, want) < 1e-5
    ref_engine = R.describe(rs, rf, backend=ref_backend)["cross_engine"]
    port_engine = T.describe(ts, tf, backend=port_backend)["cross_engine"]
    assert port_engine == ref_engine


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
def test_apply_forest_with_tree_weights_matches_reference(port_backend,
                                                          ref_backend):
    def forest(G):
        trees = [G.random_tree(14 + 5 * i, seed=i) for i in range(9)]
        return G.Forest(trees + [G.path_graph(30), G.star_tree(22, seed=7)])

    rfor, tfor = forest(RG), forest(TG)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(rfor.num_vertices, 2))
    w = rng.uniform(0.5, 2.0, rfor.num_trees)
    rf, tf = FAMILIES["Exponential"]
    rs, rp = R.build(rfor, leaf_size=8)
    ts, tp = T.build(tfor, leaf_size=8, device="cpu")
    rp = dataclasses.replace(rp, tree_w=jnp.asarray(w, jnp.float32))
    tp = dataclasses.replace(tp, tree_w=torch.tensor(w, dtype=torch.float32))
    want = np.asarray(jax.jit(R.fastmult(rs, rf, backend=ref_backend))(
        rp, jnp.asarray(X, jnp.float32)))
    got = T.apply(ts, tp, tf, X, backend=port_backend, device="cpu")
    assert _rel(got, want) < 1e-5
    # and block-diagonal: tree t's rows are its own apply, times w[t]
    off = tfor.offsets
    for t in (0, 5, 10):
        s1, p1 = T.build(tfor.trees[t], leaf_size=8, device="cpu")
        one = T.apply(s1, p1, tf, X[off[t]:off[t + 1]], backend=port_backend,
                      device="cpu")
        assert _rel(got[off[t]:off[t + 1]], w[t] * one.numpy()) < 1e-5


def test_fastmult_and_vector_fields():
    tree = TG.random_tree(120, seed=3)
    spec, params = T.build(tree, leaf_size=16, device="cpu")
    fn = TC.Polynomial((0.5, -0.2, 0.1))
    X = np.random.default_rng(1).normal(size=120)
    fm = T.fastmult(spec, fn, backend="cuda", device="cpu")
    y1 = fm(params, X)
    y2 = T.apply(spec, params, fn, X[:, None], backend="cuda", device="cpu")
    assert y1.shape == (120,)
    assert torch.equal(y1, y2[:, 0])


def test_reference_npz_and_from_numpy_carry_plans_across(tmp_path):
    rtree = RG.random_tree(200, seed=8)
    rs, rp = R.build(rtree, leaf_size=16)
    path = os.path.join(tmp_path, "plan.npz")
    R.save_plan(path, rs, rp)
    ts_own, tp_own = T.build(TG.random_tree(200, seed=8), leaf_size=16,
                             device="cpu")
    ts_npz, tp_npz = T.load_plan(path, device="cpu")
    ts_live, tp_live = T.from_numpy(
        {f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)},
        {"cross_tgt_d": [np.asarray(a) for a in rp.cross_tgt_d],
         "cross_src_d": [np.asarray(a) for a in rp.cross_src_d],
         "leaf_dists": [np.asarray(a) for a in rp.leaf_dists]},
        device="cpu")
    assert ts_npz.digest == ts_live.digest == ts_own.digest == rs.digest
    X = np.random.default_rng(4).normal(size=(200, 3))
    fn = TC.ExpQuadratic(-0.05, -0.2, 0.1)
    for backend in ("torch", "cuda"):
        own = T.apply(ts_own, tp_own, fn, X, backend=backend, device="cpu")
        for s, p in ((ts_npz, tp_npz), (ts_live, tp_live)):
            assert torch.equal(T.apply(s, p, fn, X, backend=backend,
                                       device="cpu"), own)
    # the port's own artifact round-trips and the reference reads it
    path2 = os.path.join(tmp_path, "port.npz")
    T.save_plan(path2, ts_own, tp_own)
    rs2, rp2 = R.load_plan(path2)
    assert rs2.digest == rs.digest
    for a, b in zip(rp2.cross_tgt_d, rp.cross_tgt_d):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_load_plan_rejects_malformed_artifacts(tmp_path):
    spec, params = T.build(TG.random_tree(60, seed=2), leaf_size=8,
                           device="cpu")
    good = os.path.join(tmp_path, "good.npz")
    T.save_plan(good, spec, params)
    blob = open(good, "rb").read()
    torn = os.path.join(tmp_path, "torn.npz")
    open(torn, "wb").write(blob[: len(blob) // 2])
    with pytest.raises(T.PlanValidationError):
        T.load_plan(torn, device="cpu")
    with np.load(good) as z:  # drop one member
        arrays = {k: z[k] for k in z.files if k != "s_src_seg"}
    missing = os.path.join(tmp_path, "missing.npz")
    np.savez(missing, **arrays)
    with pytest.raises(T.PlanValidationError):
        T.load_plan(missing, device="cpu")
    arrays = dict(np.load(good))
    arrays["__meta__"] = np.array("{not json")
    badmeta = os.path.join(tmp_path, "badmeta.npz")
    np.savez(badmeta, **arrays)
    with pytest.raises(T.PlanValidationError):
        T.load_plan(badmeta, device="cpu")


def test_unknown_backend_raises():
    spec, params = T.build(TG.random_tree(40, seed=0), leaf_size=8,
                           device="cpu")
    for backend in ("auto", "plan", "pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            T.apply(spec, params, TC.Exponential(-0.5), np.ones(40),
                    backend=backend, device="cpu")


def test_no_device_means_the_card_and_never_the_cpu(monkeypatch):
    tree = TG.random_tree(50, seed=0)
    spec, params = T.build(tree, leaf_size=8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((50, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.apply(spec, params, TC.Exponential(-0.5), X, backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build(tree, leaf_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.fastmult(spec, TC.Exponential(-0.5))
    before = ops.LAUNCHES
    T.apply(spec, params, TC.Exponential(-0.5), X, backend="cuda",
            device="cpu")
    assert ops.LAUNCHES == before


def test_apply_cuda_backend_refuses_fields_that_require_grad():
    """backend "cuda" no longer refuses an X that requires grad: the cross
    buckets go through the fdist wrapper's autograd.Function (the v-grad
    is M^T u, the wrapper's forward with x and y swapped), so d/dX of
    `apply` on "cuda" equals that of backend "torch" (the exact engines);
    under no_grad it runs as before."""
    tree = TG.random_tree(120, seed=2)
    spec, params = T.build(tree, leaf_size=8, device="cpu")
    fn = TC.Exponential(-0.5)
    rng = np.random.default_rng(0)
    X0 = torch.tensor(rng.normal(size=(120, 3)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(120, 3)), dtype=torch.float32)
    with torch.no_grad():
        got = T.apply(spec, params, fn, X0, backend="cuda", device="cpu")
        want = T.apply(spec, params, fn, X0, backend="torch", device="cpu")
    assert _rel(got, want) < 1e-5
    grads = {}
    for backend in ("cuda", "torch"):
        X = X0.clone().requires_grad_(True)
        (T.apply(spec, params, fn, X, backend=backend, device="cpu")
         * W).sum().backward()
        assert bool(torch.isfinite(X.grad).all())
        grads[backend] = X.grad
    assert _rel(grads["cuda"], grads["torch"]) < 1e-5

