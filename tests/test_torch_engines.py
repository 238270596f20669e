"""The port's `Integrator` facade against the reference's on the same numpy
inputs: the backend registry, every port backend against its counterpart
("host" against "host", "torch" and "cuda" against "plan"; "cuda" also
against "pallas" in interpret mode on one small tree), `describe`,
`grid_h`, the fastmult memo, `from_forest`, `from_plan` on a plan the
reference saved, `make_tree_fastmult` over an Integrator, the ViT grid
integrator's build probe on a CPU device, and the device rule. The
facade on the card: `tests/test_torch_engines_cuda.py`."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import ftfi as RF  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.core import engines as RE  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro_torch import ftfi as TF  # noqa: E402
from repro_torch.core import Integrator, available_backends  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core import ladder  # noqa: E402
from repro_torch.core import masks as TMK  # noqa: E402
from repro_torch.core.engines import spec_of  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

CPU = "cpu"
TOL = 1e-5  # tests/test_engines.py:51

# tests/test_engines.py:21-30: one f per kernel family, then two general
# f, built from the same numbers in each package
FNS = {
    "Polynomial": lambda C: C.Polynomial((0.5, -0.2, 0.1)),
    "Exponential": lambda C: C.Exponential(-0.7, 1.3),
    "ExpQuadratic": lambda C: C.ExpQuadratic(-0.05, -0.2, 0.1),
    "Rational": lambda C: C.Rational((2.0,), (1.0, 0.0, 0.8)),
    "ExpPoly": lambda C: C.ExpPoly(-0.5, (1.0, 0.3)),
    "AnyFn": lambda C: C.AnyFn(lambda z: (z + 1.0) ** -0.5),
}
KERNEL_FNS = ["Polynomial", "Exponential", "ExpQuadratic", "Rational"]
TREES = {"random_tree": lambda G: G.random_tree(157, seed=1),
         "caterpillar": lambda G: G.caterpillar_tree(90, seed=3)}
# port backend -> the reference's counterpart (outputs; describe)
COUNTERPART = {"host": ("host", "host"), "torch": ("plan", "plan"),
               "cuda": ("plan", "pallas")}


def _rel(got, ref):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


@functools.lru_cache(maxsize=None)
def _field(tree: str) -> np.ndarray:
    n = TREES[tree](TG).num_vertices
    return np.random.default_rng(len(tree)).normal(size=(n, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _ref_integ(tree: str, backend: str):
    return RE.Integrator(TREES[tree](RG), backend=backend, leaf_size=16)


@functools.lru_cache(maxsize=None)
def _port_integ(tree: str, backend: str):
    return Integrator(TREES[tree](TG), backend=backend, leaf_size=16,
                      device=CPU)


@functools.lru_cache(maxsize=None)
def _ref_outs(tree: str, backend: str) -> dict:
    """The reference Integrator's output for every f of FNS. On "plan" it
    runs its own (spec, params) through `ftfi.fastmult`, the executor its
    `integrate` runs, every f in one jit (eagerly, AnyFn takes ~10x the
    time; one compile per f, ~1.5x)."""
    integ, X = _ref_integ(tree, backend), _field(tree)
    fns = {name: make(RC) for name, make in FNS.items()}
    if backend == "host":
        return {name: np.asarray(integ.integrate(fn, X), np.float64)
                for name, fn in fns.items()}
    outs = jax.jit(lambda params, X: {
        name: RF.fastmult(integ.spec, fn)(params, X)
        for name, fn in fns.items()})(integ.params, X)
    return {name: np.asarray(y, np.float64) for name, y in outs.items()}


def test_backend_registry():
    for b in ("host", "torch", "cuda"):
        assert b in available_backends()
    with pytest.raises(ValueError, match="unknown backend"):
        Integrator(TG.random_tree(20, seed=0), backend="nope", device=CPU)


@pytest.mark.parametrize("port_backend", list(COUNTERPART))
@pytest.mark.parametrize("fname", list(FNS))
@pytest.mark.parametrize("tree", list(TREES))
def test_integrator_matches_reference(tree, fname, port_backend):
    """tests/test_engines.py::test_integrator_equals_btfi's matrix held
    against the reference's Integrator on the counterpart backend, and
    `describe` against the counterpart's describe."""
    ref_b, ref_describe = COUNTERPART[port_backend]
    integ = _port_integ(tree, port_backend)
    fn = FNS[fname](TC)
    got = integ.integrate(fn, _field(tree))
    if port_backend == "host":
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
    else:
        assert got.device.type == "cpu" and got.dtype == torch.float32
    assert _rel(got, _ref_outs(tree, ref_b)[fname]) <= TOL
    want = _ref_integ(tree, ref_describe).describe(FNS[fname](RC))
    assert integ.describe(fn) == want | {"backend": port_backend}


def test_cuda_backend_matches_pallas_interpret():
    """The reference's "pallas" backend (interpret mode) at one small tree:
    `describe` for the four kernel families and one output."""
    rtree, ttree = RG.random_tree(60, seed=2), TG.random_tree(60, seed=2)
    ref = RE.Integrator(rtree, backend="pallas", leaf_size=16)
    integ = Integrator(ttree, backend="cuda", leaf_size=16, device=CPU)
    for fname in KERNEL_FNS:
        engine = integ.describe(FNS[fname](TC))["cross_engine"]
        assert engine == ref.describe(FNS[fname](RC))["cross_engine"]
        assert engine == f"fdist_matvec:{spec_of(FNS[fname](TC)).mode}"
    X = np.random.default_rng(2).normal(size=(60, 3)).astype(np.float32)
    want = np.asarray(ref.integrate(FNS["Rational"](RC), X))
    assert _rel(integ.integrate(FNS["Rational"](TC), X), want) <= TOL


def test_grid_h_matches_reference():
    """Unit weights give grid_h 1 on every backend, as the reference's;
    irrational weights none, and the general f takes Hankel or Chebyshev
    as in the reference."""
    general = (lambda C: C.AnyFn(lambda z: 1.0 / (1.0 + z)))
    for make, leaf in ((lambda G: G.path_graph(64), 8),
                       (lambda G: G.random_tree(50, seed=5), 8)):
        want = RE.Integrator(make(RG), backend="plan", leaf_size=leaf)
        for b in ("host", "torch", "cuda"):
            integ = Integrator(make(TG), backend=b, leaf_size=leaf,
                               device=CPU)
            assert integ.grid_h == want.grid_h
            if b != "host":
                assert (integ.describe(general(TC))["cross_engine"]
                        == want.describe(general(RC))["cross_engine"])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fastmult_memo_hit_without_rebind(backend):
    """tests/test_engines.py::test_fastmult_cache_hit_no_retrace on the
    port: equal f share one closure, a hit binds no engine again, and the
    call warns that the closure-capturing path is deprecated."""
    integ = Integrator(TG.random_tree(70, seed=4), backend=backend,
                       leaf_size=16, device=CPU)
    X = np.random.default_rng(4).normal(size=(70, 3))
    with pytest.warns(DeprecationWarning, match="ftfi.fastmult"):
        fm1 = integ.fastmult(TC.Exponential(-0.7, 1.3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fm2 = integ.fastmult(TC.Exponential(-0.7, 1.3))  # equal, distinct
        assert fm1 is fm2 and integ._impl.bind_count == 1
        y = fm1(X)
        assert torch.equal(fm1(X), y)
        assert torch.equal(integ.integrate(TC.Exponential(-0.7, 1.3), X), y)
        assert integ._impl.bind_count == 1
        assert integ.fastmult(TC.Exponential(-0.2)) is not fm1
        assert integ._impl.bind_count == 2
        # an opaque callable is keyed by identity
        f = (lambda z: torch.exp(-z))
        assert integ.fastmult(f) is integ.fastmult(f)
        assert integ._impl.bind_count == 3
    # a second Integrator over the same topology shares the plan's memo
    other = Integrator(TG.random_tree(70, seed=4), backend=backend,
                       leaf_size=16, device=CPU)
    with pytest.warns(DeprecationWarning):
        assert other.fastmult(TC.Exponential(-0.7, 1.3)) is fm1
    assert other._impl.bind_count == 0


def test_from_forest_matches_reference():
    """TypeError on a non-Forest; the fused plan and the host's per-tree
    loop against the reference's per-tree host loop on a forest of five
    trees."""
    with pytest.raises(TypeError, match="Forest"):
        Integrator.from_forest([TG.random_tree(10, seed=0)], device=CPU)
    sizes = (23, 31, 40, 17, 36)
    rforest = RG.Forest([RG.random_tree(n, seed=i)
                         for i, n in enumerate(sizes)])
    tforest = TG.Forest([TG.random_tree(n, seed=i)
                         for i, n in enumerate(sizes)])
    X = np.random.default_rng(5).normal(size=(sum(sizes), 2)).astype(
        np.float32)
    fn = "Rational"
    want = RE.Integrator.from_forest(rforest, backend="host",
                                     leaf_size=8).integrate(FNS[fn](RC), X)
    for b in ("torch", "cuda", "host"):
        integ = Integrator.from_forest(tforest, backend=b, leaf_size=8,
                                       device=CPU)
        assert integ.num_trees == 5
        assert integ.describe(FNS[fn](TC))["num_trees"] == 5
        got = integ.integrate(FNS[fn](TC), X)
        assert _rel(got, want) <= (1e-12 if b == "host" else TOL)


def test_from_plan_reference_artifact(tmp_path):
    """A plan saved by the reference's `ftfi.save_plan` integrates through
    the port's `Integrator.from_plan` as through the reference's; the plan
    guard refuses a flipped index; the host backend has no plan to load."""
    rtree = RG.random_tree(120, seed=6)
    rspec, rparams = RF.build(rtree, leaf_size=16)
    path = str(tmp_path / "plan.npz")
    RF.save_plan(path, rspec, rparams)
    X = np.random.default_rng(6).normal(size=(120, 3)).astype(np.float32)
    ref = RE.Integrator.from_plan(rspec, rparams, backend="plan")
    fn = "Polynomial"
    want = np.asarray(ref.integrate(FNS[fn](RC), X))
    spec, params = TF.load_plan(path, device=CPU)
    assert spec.digest == ref.spec.digest
    for b in ("torch", "cuda"):
        integ = Integrator.from_plan(spec, params, backend=b, device=CPU)
        assert integ.spec is spec and integ.num_trees == 1
        assert _rel(integ.integrate(FNS[fn](TC), X), want) <= TOL
    # params=None: the spec's build-time distances, the same numbers
    assert torch.equal(
        Integrator.from_plan(spec, device=CPU).integrate(FNS[fn](TC), X),
        Integrator.from_plan(spec, params, device=CPU).integrate(
            FNS[fn](TC), X))
    with pytest.raises(TF.PlanValidationError):
        Integrator.from_plan(faults.flip_index(spec), params, device=CPU)
    with pytest.raises(ValueError, match="host"):
        Integrator.from_plan(spec, params, backend="host", device=CPU)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tree_fastmult_takes_an_integrator(backend):
    """`make_tree_fastmult` over an Integrator gives the numbers of the
    same call over its (spec, params) pair; its own backend is the
    default; a "host" Integrator (no plan) is refused."""
    tree = TG.random_tree(48, seed=8)
    integ = Integrator(tree, backend=backend, leaf_size=8, device=CPU)
    X = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 48, 3)).astype(np.float32))
    cs = [0.1, -0.5, -0.2]
    got = TMK.make_tree_fastmult(integ, "exp", cs, 0.5, device=CPU)(X)
    want = TMK.make_tree_fastmult((integ.spec, integ.params), "exp", cs,
                                  0.5, backend=backend, device=CPU)(X)
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="host"):
        TMK.make_tree_fastmult(Integrator(tree, backend="host", leaf_size=8),
                               "exp", cs, device=CPU)


def test_vit_grid_integrator_demotes_once_on_cpu(monkeypatch):
    """A fault injected at the "cuda" rung fails the ViT grid's build
    probe on a CPU device: the rung is blocked once and the grid is
    served by "torch", with the logits of "torch"; no other probe runs."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.lru import BoundedLRU
    from repro_torch.models import vit as TV

    monkeypatch.setattr(TV, "_GRID_INTEGRATOR_CACHE", BoundedLRU(8))
    cfg = get_smoke_config("topovit_b16").replace(topo_attn_impl="cuda")
    fired = []

    def fail(**ctx):
        fired.append(1)
        raise RuntimeError("injected kernel failure")

    ladder.reset_stats()
    try:
        with faults.injected("ladder.cuda", fail), \
                pytest.warns(ladder.BackendDemotionWarning, match="probe"):
            integ = TV.build_grid_integrator(cfg, device=CPU)
        assert integ.backend == "torch" and fired == [1]
        assert "cuda" in ladder.stats()["blocked"]
        with faults.injected("ladder.cuda", fail):
            assert TV.build_grid_integrator(cfg, device=CPU) is integ
        assert fired == [1]
        model = TV.init_params(cfg, 0, 10, 48, device=CPU)
        patches = np.random.default_rng(9).normal(
            size=(2, cfg.num_prefix_embeddings, 48)).astype(np.float32)
        with torch.no_grad():
            got = TV.forward(cfg, model, patches, device=CPU)
            want = TV.forward(cfg.replace(topo_attn_impl="torch"), model,
                              patches, device=CPU)
        assert torch.equal(got, want)
    finally:
        ladder.unblock_backends()
        ladder.reset_stats()
    # healthy: the probe passes and the grid keeps "cuda"
    monkeypatch.setattr(TV, "_GRID_INTEGRATOR_CACHE", BoundedLRU(8))
    assert TV.build_grid_integrator(cfg, device=CPU).backend == "cuda"


def test_execute_plan_matches_reference():
    """The legacy `execute_plan` over a compiled plan, as
    tests/test_core.py drives the reference's: a polynomial
    `batched_matvec` and a CrossBucket `cross_multiply` (dense per bucket)
    against the reference's, and the default Chebyshev engine."""
    import jax.numpy as jnp
    from repro.core import engines as RENG
    from repro.core import integrate as RI
    from repro_torch.core import integrate as TI
    from repro_torch.core import plan_api
    from repro_torch.core.engines import execute_plan

    rplan = RI.compile_plan(RG.random_tree(150, seed=5), leaf_size=16)
    tplan = TI.compile_plan(TG.random_tree(150, seed=5), leaf_size=16)
    X = np.random.default_rng(5).normal(size=(150, 2)).astype(np.float32)
    cs = (0.3, -0.1, 0.05)

    def poly(z):
        return cs[0] + cs[1] * z + cs[2] * z * z

    # the reference's executor under jit (eager, it takes ~15 s here)
    want = np.asarray(jax.jit(lambda X: RENG.execute_plan(
        rplan, X, poly, batched_matvec=lambda *a:
        RENG.polynomial_batched_matvec(jnp.asarray(cs), *a)))(X))
    got = execute_plan(tplan, X, poly, batched_matvec=lambda *a:
                       plan_api.polynomial_batched_matvec(cs, *a),
                       device=CPU)
    assert _rel(got, want) <= TOL

    def dense(cb, Xp):
        s = torch.from_numpy(cb.tgt_d)[:, :, None] + torch.from_numpy(
            cb.src_d)[:, None, :]
        return torch.bmm(poly(s).float(), Xp)

    got = execute_plan(tplan, X, poly, cross_multiply=dense, device=CPU)
    assert _rel(got, want) <= TOL

    # the default engine is the plan's Chebyshev, as `apply` runs it
    def rat(z):
        return 1.0 / (1.0 + z)

    spec, params = plan_api.specialize(tplan, CPU)
    assert torch.equal(execute_plan(tplan, X, rat, device=CPU),
                       TF.apply(spec, params, rat, X, device=CPU))


def test_device_rule_and_host_tensors():
    """The plan backends default to the card and raise without one; the
    host backend needs none and returns a tensor on its field's device in
    its dtype."""
    tree = TG.random_tree(40, seed=3)
    if not torch.cuda.is_available():
        for b in ("torch", "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Integrator(tree, backend=b, leaf_size=8)
    host = Integrator(tree, backend="host", leaf_size=8)
    X = torch.randn(40, 2, dtype=torch.float64)
    y = host.integrate(TC.Exponential(-0.5), X)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float64
    assert _rel(y, host.integrate(TC.Exponential(-0.5), X.numpy())) == 0.0
    assert repr(host) == "Integrator(backend='host', grid_h=None)"
