"""The port's FRT trees, its approximate integrators (RFF and NU-FFT, paper
App. A.2) and its mesh generators against the reference's on the same
numpy inputs: `frt_tree` and `frt_forest` edge for edge and weight for
weight from the same seed, the FRT integrations, `torus_mesh` and
`vertex_normals`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import approx as RA  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.graphs import frt as RFRT  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import meshes as RM  # noqa: E402
from repro_torch.core import Integrator  # noqa: E402
from repro_torch.core import approx as TA  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.graphs import frt as TFRT  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import meshes as TM  # noqa: E402

CPU = "cpu"
SAME = 1e-12  # the same numpy arithmetic in both packages
TOL = 1e-5  # tests/test_forest.py / tests/test_plan_api.py

GRAPHS = {
    "icosphere2": lambda G, M: M.mesh_graph(*M.icosphere(2)),
    "synthetic": lambda G, M: G.synthetic_graph(120, 60, seed=4),
}


def _rel(got, ref):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def _same_tree(a, b):
    assert a.num_vertices == b.num_vertices
    for f in ("edges_u", "edges_v", "weights"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_frt_tree_matches_reference(graph, seed):
    rg, tg = GRAPHS[graph](RG, RM), GRAPHS[graph](TG, TM)
    rtree, rleaf = RFRT.frt_tree(rg, seed=seed)
    ttree, tleaf = TFRT.frt_tree(tg, seed=seed)
    _same_tree(ttree, rtree)
    assert np.array_equal(tleaf, rleaf)


def test_frt_forest_and_integrations_match_reference():
    """frt_forest (seeds + 977 t) tree for tree; frt_integrate (the host
    walk on one tree) to 1e-12; frt_integrate_forest on "torch" and
    "cuda" (CPU tensors) and, through forest_leaf_integrate's average, on
    "host" against the reference's (its exact host loop)."""
    rg, tg = GRAPHS["icosphere2"](RG, RM), GRAPHS["icosphere2"](TG, TM)
    rforest, _ = RFRT.frt_forest(rg, 3, seed=1)
    tforest, leaf = TFRT.frt_forest(tg, 3, seed=1)
    for a, b in zip(tforest.trees, rforest.trees, strict=True):
        _same_tree(a, b)
    X = np.random.default_rng(2).normal(size=(tg.num_vertices, 3))
    rfn = RC.Rational((1.0,), (1.0, 0.0, 4.0))
    tfn = TC.Rational((1.0,), (1.0, 0.0, 4.0))
    assert _rel(TFRT.frt_integrate(tg, tfn, X, seed=2, leaf_size=32),
                RFRT.frt_integrate(rg, rfn, X, seed=2, leaf_size=32)) <= SAME
    want = RFRT.frt_integrate_forest(rg, rfn, X, num_trees=3, seed=1,
                                     leaf_size=32, backend="host")
    for b in ("torch", "cuda"):
        got = TFRT.frt_integrate_forest(tg, tfn, X, num_trees=3, seed=1,
                                        leaf_size=32, backend=b, device=CPU)
        assert isinstance(got, torch.Tensor) and _rel(got, want) <= TOL
    host = Integrator.from_forest(tforest, backend="host", leaf_size=32)
    got = TFRT.forest_leaf_integrate(tforest, leaf, host, tfn, X)
    assert isinstance(got, np.ndarray) and _rel(got, want) <= SAME


def test_rff_and_nufft_match_reference():
    """tests/test_core.py::test_rff_and_nufft's inputs through both
    packages, and the port's NU-FFT against the dense product."""
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 3, 150), rng.uniform(0, 3, 140)
    V = rng.normal(size=(140, 2))
    f = (lambda z: np.exp(-0.5 * z * z))
    got = TA.nufft_integrate(f, x, y, V, n_quad=256)
    assert _rel(got, RA.nufft_integrate(f, x, y, V, n_quad=256)) <= SAME
    assert _rel(got, f(x[:, None] + y[None, :]) @ V) <= 1e-6
    assert _rel(TA.gaussian_rff_matvec(x, y, V, sigma=1.0, m=4000, seed=1),
                RA.gaussian_rff_matvec(x, y, V, sigma=1.0, m=4000,
                                       seed=1)) <= SAME
    om, tp = rng.normal(size=64), rng.uniform(-1, 1, 64)
    assert _rel(TA.rff_matvec(x, y, V, om, tp),
                RA.rff_matvec(x, y, V, om, tp)) <= SAME
    pts = rng.uniform(0, 2 * np.pi, 50)
    vals = rng.normal(size=50) + 1j * rng.normal(size=50)
    Fk, ks = TA.nufft1(pts, vals, 32)
    rFk, rks = RA.nufft1(pts, vals, 32)
    assert np.array_equal(ks, rks)
    assert np.max(np.abs(Fk - rFk)) <= SAME * np.max(np.abs(rFk))
    g = TA.nufft2(pts, Fk, ks)
    assert np.max(np.abs(g - RA.nufft2(pts, rFk, rks))) <= SAME * np.max(
        np.abs(g))


def test_meshes_match_reference():
    tv, tf = TM.torus_mesh(12, 6)
    rv, rf = RM.torus_mesh(12, 6)
    assert np.array_equal(tv, rv) and np.array_equal(tf, rf)
    assert np.array_equal(TM.vertex_normals(tv, tf), RM.vertex_normals(rv, rf))
    iv, i_f = TM.icosphere(2)
    n = TM.vertex_normals(iv, i_f)
    assert np.array_equal(n, RM.vertex_normals(*RM.icosphere(2)))
    # on a unit sphere the area-weighted normal is the position
    assert np.max(np.abs(n - iv)) < 0.05
