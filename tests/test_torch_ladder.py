"""The backend degradation ladder (`core/ladder.py`) on the port, on the
CPU, held against the reference's ladder: the ladder cases of
tests/test_serving_faults.py run on one plan that the reference builds and
`from_numpy` carries across, the same faults injected into both packages
(the port's rungs cuda -> torch -> host are the reference's pallas -> plan
-> host; "cuda" on CPU tensors is B1's plain twin). Every output is held
against the reference's `apply(..., backend="plan")`, and the demotions
and counters against the reference's ladder. Plus what is the port's own:
the ladder never demotes on the card (tests/test_torch_cuda.py), so
dispatch is not steered by a blocked rung and "auto" resolves by size."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import ftfi as R  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.core import ladder as r_ladder  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.testing import faults as r_faults  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core import ladder  # noqa: E402
from repro_torch.core.ladder import (BackendDemotionWarning,  # noqa: E402
                                     LadderExhaustedError)
from repro_torch.kernels.fdist_matvec import ops  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

CPU = "cpu"
# the port's rung names against the reference's
RUNG = {"cuda": "pallas", "torch": "plan", "host": "host"}
TOL = 1e-5  # tests/test_serving_faults.py's parity bound


@pytest.fixture(autouse=True)
def _clean_robustness_state():
    for f, lad in ((faults, ladder), (r_faults, r_ladder)):
        f.clear()
        lad.unblock_backends()
    try:
        yield
    finally:
        for f, lad in ((faults, ladder), (r_faults, r_ladder)):
            f.clear()
            lad.unblock_backends()


def _carry(rs, rp):
    """The reference's live pair as the port's, bit for bit."""
    return T.from_numpy(
        {f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)},
        {k: [np.asarray(a) for a in getattr(rp, k)]
         for k in ("cross_tgt_d", "cross_src_d", "leaf_dists")},
        device=CPU)


@pytest.fixture(scope="module")
def pairs():
    """(reference pair, port pair) on tests/test_serving_faults.py's plan."""
    rs, rp = R.build(RG.random_tree(60, seed=7), leaf_size=8)
    return (rs, rp), _carry(rs, rp)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


_REF_CLOSURES: dict = {}


def _reference_closure(rs, backend):
    """One reference closure per rung, re-armed per use, so its jitted
    runners compile once for the whole file."""
    fm = _REF_CLOSURES.get(backend)
    if fm is None:
        fm = _REF_CLOSURES[backend] = r_ladder.resilient_fastmult(
            rs, RC.Exponential(-0.5), backend=backend)
    fm.reset()
    fm.demotions = []
    return fm


def _both(pairs, X, injects, sticky_calls=1):
    """Run the port's and the reference's ladder, from the kernel rung on
    f = exp(-0.5 s), under the same faults: `injects` is [(port point,
    handler maker)], the reference's point named by RUNG. Returns (port Y,
    port closure, port stats, reference Y, reference closure, reference
    stats, reference "plan" output)."""
    (rs, rp), (ts, tp) = pairs
    ref = np.asarray(R.apply(rs, rp, RC.Exponential(-0.5), X,
                             backend="plan"))
    out = []
    for pkg, f, lad, params in (("port", faults, ladder, tp),
                                ("ref", r_faults, r_ladder, rp)):
        lad.reset_stats()
        fm = (T.resilient_fastmult(ts, TC.Exponential(-0.5), backend="cuda",
                                   device=CPU) if pkg == "port"
              else _reference_closure(rs, "pallas"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", lad.BackendDemotionWarning)
            for point, make in injects:
                if pkg == "ref":
                    lvl = point.split(".")[-1]
                    point = point[:-len(lvl)] + RUNG[lvl]
                f.inject(point, make(f))
            try:
                for _ in range(sticky_calls):
                    Y = fm(params, X)
            finally:
                f.clear()
        out += [np.asarray(Y), fm, lad.stats()]
    return (*out, ref)


def _same_history(fm, rfm):
    assert [(RUNG[a], RUNG[b], why) for a, b, why in fm.demotions] == \
        rfm.demotions
    assert RUNG[fm.level] == rfm.level


def test_ladder_kernel_raise_demotes_with_parity(pairs):
    (_, _), (ts, tp) = pairs
    X = np.random.default_rng(2).normal(size=(ts.n, 2)).astype(np.float32)
    ladder.reset_stats()
    with faults.injected("ladder.cuda", faults.always_raise(
            RuntimeError, "kernel launch failed")):
        with pytest.warns(BackendDemotionWarning, match="cuda.*torch"):
            Y = T.apply_resilient(ts, tp, TC.Exponential(-0.5), X,
                                  backend="cuda", device=CPU)
    st = ladder.stats()
    assert st["errors"] == 1 and st["demotions"] == 1
    Yp, fm, st, Yr, rfm, rst, ref = _both(
        pairs, X, [("ladder.cuda", lambda f: f.always_raise(
            RuntimeError, "kernel launch failed"))])
    assert _rel(Y, ref) <= TOL and _rel(Yp, ref) <= TOL
    assert _rel(Yp, Yr) <= TOL
    assert st == rst
    _same_history(fm, rfm)


def test_ladder_nan_output_demotes(pairs):
    (_, _), (ts, _) = pairs
    X = np.random.default_rng(3).normal(size=(ts.n, 2)).astype(np.float32)
    Yp, fm, st, Yr, rfm, rst, ref = _both(
        pairs, X, [("ladder.out.cuda", lambda f: f.nan_output())])
    assert _rel(Yp, ref) <= TOL and _rel(Yp, Yr) <= TOL
    assert st == rst and st["nonfinite"] == 1 and st["demotions"] == 1
    _same_history(fm, rfm)


def test_ladder_nan_output_reaches_host_exact(pairs):
    (_, _), (ts, _) = pairs
    X = np.random.default_rng(3).normal(size=(ts.n, 2)).astype(np.float32)
    Yp, fm, st, Yr, rfm, rst, ref = _both(
        pairs, X, [("ladder.cuda", lambda f: f.always_raise()),
                            ("ladder.out.torch", lambda f: f.nan_output())])
    assert fm.level == "host"
    assert _rel(Yp, ref) <= TOL  # host rung result, exact
    assert _rel(Yp, Yr) <= TOL
    assert st == rst and st["demotions"] == 2
    _same_history(fm, rfm)


def test_ladder_demotion_is_sticky(pairs):
    (_, _), (ts, _) = pairs
    X = np.random.default_rng(4).normal(size=(ts.n, 2)).astype(np.float32)
    Yp, fm, st, Yr, rfm, rst, ref = _both(
        pairs, X, [("ladder.cuda", lambda f: f.always_raise())],
        sticky_calls=2)  # the second call starts at "torch": no 2nd error
    assert st["errors"] == 1 and st == rst
    assert fm.demotions == [("cuda", "torch",
                             "RuntimeError: injected fault")]
    _same_history(fm, rfm)
    assert _rel(Yp, ref) <= TOL
    fm.reset()
    assert fm.level == "cuda"


def test_ladder_uninjected_stays_on_the_kernel_rung(pairs):
    (_, _), (ts, tp) = pairs
    fm = T.resilient_fastmult(ts, TC.Exponential(-0.5), device=CPU)
    X = np.ones((ts.n, 2), np.float32)
    ladder.reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error", BackendDemotionWarning)
        Y = fm(tp, X)
    assert fm.level == "cuda" and fm.demotions == []
    assert ladder.stats()["demotions"] == 0
    want = T.apply(ts, tp, TC.Exponential(-0.5), X, backend="cuda",
                   device=CPU)
    assert torch.equal(Y, want)
    (rs, rp), _ = pairs
    ref = R.apply(rs, rp, RC.Exponential(-0.5), X, backend="plan")
    assert _rel(Y, ref) <= TOL


def test_ladder_exhaustion_is_structured(pairs):
    (rs, rp), (ts, tp) = pairs
    X = np.zeros((ts.n, 1), np.float32)
    for f, lad, spec, params, fn, top, kw, err in (
            (faults, ladder, ts, tp, TC.Exponential(-0.5), "cuda",
             {"device": CPU}, LadderExhaustedError),
            (r_faults, r_ladder, rs, rp, RC.Exponential(-0.5), "pallas", {},
             r_ladder.LadderExhaustedError)):
        lad.reset_stats()
        for lvl in lad.LADDER:
            f.inject(f"ladder.{lvl}", f.always_raise())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", lad.BackendDemotionWarning)
            with pytest.raises(err, match="every backend rung"):
                lad.apply_resilient(spec, params, fn, X, backend=top, **kw)
        f.clear()
    assert ladder.stats() == r_ladder.stats()


@functools.lru_cache(maxsize=None)
def _reference_edge_grad():
    """jax.grad of sum(apply(reweight(w))^2) on the reference's "plan"
    backend (jitted: computed once)."""
    rtree = RG.random_tree(30, seed=3)
    rs, rp = R.build(rtree, leaf_size=6, reweightable=True)
    X = np.random.default_rng(5).normal(size=(30, 2)).astype(np.float32)
    fn = RC.Exponential(-0.7)

    @jax.jit
    def loss(w):
        return jnp.sum(R.apply(rs, R.reweight(rs, w), fn, X,
                               backend="plan") ** 2)

    w0 = np.asarray(rtree.weights, np.float32)
    return rs, rp, X, w0, np.asarray(jax.grad(loss)(w0))


def test_ladder_grads_flow_through_every_rung():
    """A reweighted plan trains through the ladder: the edge gradient is
    the reference's whichever rung computed the output."""
    rs, rp, X, w0, want = _reference_edge_grad()
    ts, _ = _carry(rs, rp)
    for broken in ((), ("cuda",), ("cuda", "torch")):
        w = torch.tensor(w0, requires_grad=True)
        fm = T.resilient_fastmult(ts, TC.Exponential(-0.7), device=CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", BackendDemotionWarning)
            for lvl in broken:
                faults.inject(f"ladder.{lvl}", faults.always_raise())
            fm(T.reweight(ts, w), torch.from_numpy(X)).square().sum(
            ).backward()
            faults.clear()
        assert fm.level == ladder.LADDER[len(broken)]
        assert float(np.abs(w.grad.numpy() - want).max()
                     / np.abs(want).max()) <= 1e-4


def test_block_backend_steers_dispatch():
    """A blocked rung is skipped by `effective_backend` as in the
    reference, on CPU tensors only: the ViT's dispatch keeps the name it
    was given, since the ladder never moves a card path off its kernel."""
    from repro_torch.models import attention as A

    cfg = get_smoke_config("llama3_2_1b").replace(topo_backend="cuda")
    assert A.resolve_topo_backend(cfg) == "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", BackendDemotionWarning)
        ladder.block_backend("cuda", "probe failed (test)")
        r_ladder.block_backend("pallas", "probe failed (test)")
    for lvl in ("cuda", "torch", "host"):
        assert RUNG[ladder.effective_backend(lvl)] == \
            r_ladder.effective_backend(RUNG[lvl])
    assert A.resolve_topo_backend(cfg) == "cuda"
    assert ladder.effective_backend("auto", n=10 ** 9) == "torch"
    assert ladder.auto_backend(10 ** 9) == "cuda"
    with pytest.raises(ValueError, match="terminal"):
        ladder.block_backend("host", "nope")
    ladder.unblock_backends()
    assert ladder.effective_backend("cuda") == "cuda"


def test_probe_backend_reports_failure(pairs):
    (rs, rp), (ts, tp) = pairs
    assert ladder.probe_backend(ts, tp, "torch", device=CPU) is None
    assert ladder.probe_backend(ts, tp, "host", device=CPU) is None
    assert r_ladder.probe_backend(rs, rp, "plan") is None
    with faults.injected("ladder.cuda", faults.always_raise(
            RuntimeError, "no card")):
        reason = ladder.probe_backend(ts, tp, "cuda", device=CPU)
    with r_faults.injected("ladder.pallas", r_faults.always_raise(
            RuntimeError, "no card")):
        r_reason = r_ladder.probe_backend(rs, rp, "pallas")
    assert reason == r_reason == "RuntimeError: no card"
    with faults.injected("ladder.out.torch", faults.nan_output()):
        reason = ladder.probe_backend(ts, tp, "torch", device=CPU)
    with r_faults.injected("ladder.out.plan", r_faults.nan_output()):
        r_reason = r_ladder.probe_backend(rs, rp, "plan")
    assert reason == r_reason == "non-finite probe output"


def test_auto_backend_resolves_by_size(pairs, monkeypatch):
    """"auto" picks the kernel rung from AUTO_CUDA_MIN_N vertices up, and
    computes the reference's M_f X either way."""
    (rs, rp), (spec, params) = pairs
    X = np.ones((spec.n, 2), np.float32)
    ref = np.asarray(R.apply(rs, rp, RC.Exponential(-0.5), X,
                             backend="plan"))
    fn = TC.Exponential(-0.5)
    assert ladder.effective_backend("auto") == "torch"
    for thresh, launches in ((spec.n + 1, 0),
                             (spec.n, len(spec.cross_tgt_d0))):
        monkeypatch.setattr(ladder, "AUTO_CUDA_MIN_N", thresh)
        before = ops.LAUNCHES
        with monkeypatch.context() as m:
            calls = []
            real = ops._forward

            def counting(*a, **k):
                calls.append(1)
                return real(*a, **k)

            m.setattr(ops, "_forward", counting)
            Y = T.apply(spec, params, fn, X, backend="auto", device=CPU)
        assert len(calls) == launches and ops.LAUNCHES == before
        assert _rel(Y, ref) <= TOL
        assert T.describe(spec, fn, backend="auto")["cross_engine"] == (
            "fdist_matvec:exp" if launches else "exponential")
    with pytest.raises(ValueError, match="unknown ladder backend"):
        ladder.chain_from("plan")
