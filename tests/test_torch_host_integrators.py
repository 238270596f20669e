"""The port's host integrators against the reference's on the same numpy
inputs: the recursive FTFI walk over the tree x f matrix of
tests/test_core.py (the same numpy arithmetic, so to 1e-12, and against
the port's dense BTFI in float64 at the reference's 1e-8), ExpMP, the
immutable `ITNode` view and `it_stats`, and each host matvec of
`core/cordial.py`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import cordial as RC  # noqa: E402
from repro.core import integrate as RI  # noqa: E402
from repro.core import integrator_tree as RIT  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import mst as RMST  # noqa: E402
from repro_torch.core import Integrator  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core import integrate as TI  # noqa: E402
from repro_torch.core import integrator_tree as TIT  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import mst as TMST  # noqa: E402

SAME = 1e-12  # the same numpy arithmetic in both packages
ORACLE = 1e-8  # tests/test_core.py:47

# tests/test_core.py:16-36, built in each package
TREES = {
    "random_tree": lambda G, M: G.random_tree(157, seed=1),
    "caterpillar": lambda G, M: G.caterpillar_tree(120, seed=2),
    "star": lambda G, M: G.star_tree(80, seed=3),
    "path": lambda G, M: G.path_graph(100),
    "grid_mst": lambda G, M: M.minimum_spanning_tree(
        G.grid_graph(10, 10, seed=4)),
}
FNS = {
    "Polynomial": lambda C: C.Polynomial((0.5, -0.2, 0.1)),
    "Exponential": lambda C: C.Exponential(-0.7),
    "ExpPoly": lambda C: C.ExpPoly(-0.5, (1.0, 0.3)),
    "Trig_cos": lambda C: C.Trigonometric(0.9, 0.1, "cos"),
    "Trig_sin": lambda C: C.Trigonometric(1.3, 0.0, "sin"),
    "Rational": lambda C: C.Rational((1.0,), (1.0, 0.0, 0.5)),
    "ExpQuadratic": lambda C: C.ExpQuadratic(-0.02, -0.1, 0.0),
    "ExpRational": lambda C: C.ExpRational(-0.3, 0.8),
    "AnyFn": lambda C: C.AnyFn(lambda z: np.log1p(z) * np.exp(-0.2 * z)),
}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def _pair(tree: str):
    return (TREES[tree](RG, RMST), TREES[tree](TG, TMST))


@pytest.mark.parametrize("fname", list(FNS))
@pytest.mark.parametrize("tree", list(TREES))
def test_ftfi_matches_reference_and_btfi(tree, fname):
    rtree, ttree = _pair(tree)
    X = np.random.default_rng(len(tree)).normal(size=(ttree.num_vertices, 3))
    want = RI.FTFI(rtree, leaf_size=16).integrate(FNS[fname](RC), X)
    fn = FNS[fname](TC)
    got = TI.FTFI(ttree, leaf_size=16).integrate(fn, X)
    assert got.dtype == np.float64 and _rel(got, want) <= SAME
    # the port's BTFI distances in float64, f applied on the host
    D = TI.BTFI(ttree, dtype=torch.float64, device="cpu").dists.numpy()
    assert _rel(got, fn(D) @ X) <= ORACLE


def test_ftfi_keeps_float32_and_vectors():
    """float32 fields stay float32 (as the reference's); a vector field
    comes back a vector."""
    rtree, ttree = _pair("random_tree")
    X = np.random.default_rng(1).normal(size=157).astype(np.float32)
    got = TI.FTFI(ttree, leaf_size=16).integrate(TC.Rational(
        (1.0,), (1.0, 0.0, 0.5)), X)
    want = RI.FTFI(rtree, leaf_size=16).integrate(RC.Rational(
        (1.0,), (1.0, 0.0, 0.5)), X)
    assert got.dtype == want.dtype == np.float32 and got.shape == (157,)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("lam,scale", [(-0.4, 0.7), (-1.1, 1.0), (0.2, 0.3)])
@pytest.mark.parametrize("tree", ["random_tree", "star", "path"])
def test_expmp_matches_reference(tree, lam, scale):
    """tests/test_engines.py::test_expmp_equals_btfi's cases: ExpMP and the
    host backend's routing of Exponential through it."""
    rtree, ttree = _pair(tree)
    X = np.random.default_rng(3).normal(size=(ttree.num_vertices, 3))
    want = RI.ExpMP(rtree).integrate(lam, X, scale=scale)
    assert _rel(TI.ExpMP(ttree).integrate(lam, X, scale=scale), want) <= SAME
    integ = Integrator(ttree, backend="host", leaf_size=16)
    fn = TC.Exponential(lam, scale)
    assert integ.describe(fn)["cross_engine"] == "exp_message_passing"
    assert _rel(integ.integrate(fn, X), want) <= SAME


def _nodes(node):
    yield node
    if not node.is_leaf:
        yield from _nodes(node.left)
        yield from _nodes(node.right)


def test_itnode_view_matches_reference():
    """Immutable nodes; node for node the reference's arrays; it_stats."""
    rtree, ttree = _pair("random_tree")
    root = TIT.build_integrator_tree(ttree, leaf_size=16)
    with pytest.raises(dataclasses.FrozenInstanceError):
        root.pivot = 0
    ref = RIT.build_integrator_tree(rtree, leaf_size=16)
    fields = [f.name for f in dataclasses.fields(TIT.ITNode)
              if f.name not in ("left", "right")]
    count = 0
    for a, b in zip(_nodes(root), _nodes(ref), strict=True):
        for name in fields:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None and y is None) or np.array_equal(x, y), name
        count += 1
    assert count > 20
    assert TIT.it_stats(root) == RIT.it_stats(ref)
    assert TIT.it_stats(root)["balance_ok"]


def _inputs(seed, grid=False):
    r = np.random.default_rng(seed)
    if grid:
        return (r.integers(0, 30, 23) * 0.25, r.integers(0, 30, 19) * 0.25,
                r.normal(size=(19, 2)))
    return r.uniform(0, 4, 23), r.uniform(0, 4, 19), r.normal(size=(19, 2))


MATVECS = {
    "dense": lambda C, x, y, V: C.dense_matvec(np.cos, x, y, V),
    "polynomial": lambda C, x, y, V: C.polynomial_matvec(
        np.array([0.3, -0.2, 0.05, 0.01]), x, y, V),
    "exponential": lambda C, x, y, V: C.exponential_matvec(-0.6, x, y, V,
                                                           scale=1.4),
    "exp_poly": lambda C, x, y, V: C.exp_poly_matvec(
        -0.5, np.array([1.0, 0.3]), x, y, V),
    "trig_sin": lambda C, x, y, V: C.trig_matvec(0.7, 0.2, x, y, V,
                                                 kind="sin"),
    "hankel_fft": lambda C, x, y, V: C.hankel_fft_matvec(
        lambda z: np.cos(z) / (1 + z), x, y, V, 0.25),
    "chebyshev_adaptive": lambda C, x, y, V: C.chebyshev_matvec(
        lambda z: 1.0 / (1.0 + 4.0 * z * z), x, y, V, degree=8, tol=1e-10),
    "cauchy": lambda C, x, y, V: C.cauchy_matvec(x + 0.5, y + 0.5, V),
}


@pytest.mark.parametrize("engine", list(MATVECS))
def test_host_matvecs_match_reference(engine):
    x, y, V = _inputs(7, grid=engine == "hankel_fft")
    want = MATVECS[engine](RC, x, y, V)
    got = MATVECS[engine](TC, x, y, V)
    assert got.shape == want.shape and _rel(got, want) <= SAME
    if engine != "chebyshev_adaptive":  # approximate by design
        return
    dense = RC.dense_matvec(lambda z: 1.0 / (1.0 + 4.0 * z * z), x, y, V)
    assert _rel(got, dense) <= 1e-8
