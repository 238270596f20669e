"""Plan-artifact validation (`core/plan_guard.py`) and the disk plan cache
(`core/plan_cache.py`) on the port: the guard, damaged-artifact and cache
cases of tests/test_serving_faults.py and tests/test_plan_cache.py (the
`Integrator` and serve-engine ones wait for their modules), plus what
carries across packages: a cache directory written by the reference hits
in the port and the reverse, a reference artifact saved with int64 index
tables loads as int32, and the reweightable and updated specs round-trip
through save/load with their update tables and ghosts."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import ftfi as R  # noqa: E402
from repro.core import clear_flat_cache as r_clear_flat  # noqa: E402
from repro.core import clear_plan_cache as r_clear_plan  # noqa: E402
from repro.core import plan_cache as r_cache  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core import plan_cache, plan_guard  # noqa: E402
from repro_torch.core.integrate import clear_plan_cache  # noqa: E402
from repro_torch.core.itree_flat import clear_flat_cache  # noqa: E402
from repro_torch.core.plan_guard import (PlanGuardWarning,  # noqa: E402
                                         PlanValidationError)
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _strict_guard():
    old = plan_guard.policy()
    plan_guard.set_policy("strict")
    try:
        yield
    finally:
        plan_guard.set_policy(old)


@pytest.fixture(scope="module")
def plan_pair():
    return T.build(TG.random_tree(60, seed=7), leaf_size=8, device=CPU)


@pytest.fixture
def cache_dir(tmp_path):
    d = tmp_path / "plans"
    plan_cache.configure(d, max_mb=64)
    clear_flat_cache()
    clear_plan_cache()
    try:
        yield d
    finally:
        plan_cache.reset_to_env()
        clear_flat_cache()
        clear_plan_cache()


def _forget():
    """A fresh process: the in-memory caches of both packages gone."""
    clear_flat_cache()
    clear_plan_cache()
    r_clear_flat()
    r_clear_plan()


def _delta(fn):
    before = plan_cache.stats()
    out = fn()
    after = plan_cache.stats()
    keys = ("hits", "misses", "stores", "evictions", "errors")
    return out, {k: after[k] - before[k] for k in keys}


def _apply(spec, params, X):
    return T.apply(spec, params, TC.Exponential(-0.5), X, device=CPU)


# ----------------------------------------------------------------------------
# the guard
# ----------------------------------------------------------------------------


def test_guard_accepts_healthy_plan(plan_pair):
    spec, params = plan_pair
    assert plan_guard.check_spec(spec, params) == []
    assert T.validate(spec, params) is True


@pytest.mark.parametrize("field", ["src_gather", "tgt_scatter", "pivots",
                                   "src_seg", "tgt_gather"])
def test_guard_catches_flipped_index(plan_pair, field):
    spec, params = plan_pair
    bad = faults.flip_index(spec, field=field)
    with pytest.raises(PlanValidationError, match=field):
        T.validate(bad, params)


def test_guard_catches_nan_params(plan_pair):
    spec, params = plan_pair
    dists = list(params.cross_src_d)
    d0 = dists[0].clone()
    d0.view(-1)[0] = float("nan")
    dists[0] = d0
    bad = dataclasses.replace(params, cross_src_d=tuple(dists))
    with pytest.raises(PlanValidationError, match="finite"):
        T.validate(spec, bad)


def test_guard_warn_policy_rejects_without_raising(plan_pair):
    spec, params = plan_pair
    bad = faults.flip_index(spec, field="src_gather")
    before = plan_guard.stats()
    with pytest.warns(PlanGuardWarning):
        ok = plan_guard.validate(bad, params, policy_override="warn")
    assert ok is False
    after = plan_guard.stats()
    assert after["failures"] == before["failures"] + 1
    assert after["warned"] == before["warned"] + 1


def test_guard_off_policy_skips(plan_pair):
    spec, params = plan_pair
    bad = faults.flip_index(spec, field="src_gather")
    assert plan_guard.validate(bad, params, policy_override="off") is True


def test_guard_policy_follows_env(monkeypatch):
    plan_guard.set_policy(None)
    monkeypatch.setenv("FTFI_PLAN_GUARD", "warn")
    assert plan_guard.policy() == "warn"
    monkeypatch.setenv("FTFI_PLAN_GUARD", "bogus")
    assert plan_guard.policy() == "strict"
    with pytest.raises(ValueError, match="unknown plan-guard policy"):
        plan_guard.set_policy("lenient")


def test_guard_matches_reference_issues(plan_pair):
    """The port's guard finds the reference's issues on the same corrupt
    spec (the checks are the reference's, string for string)."""
    from repro.core import plan_guard as r_guard
    from repro.testing import faults as r_faults

    rspec, rparams = R.build(RG.random_tree(60, seed=7), leaf_size=8)
    spec, params = plan_pair
    assert spec.digest == rspec.digest
    for field in ("src_gather", "pivots", "tgt_gather"):
        got = plan_guard.check_spec(faults.flip_index(spec, field=field),
                                    params)
        want = r_guard.check_spec(r_faults.flip_index(rspec, field=field),
                                  rparams)
        assert got == want and got


# ----------------------------------------------------------------------------
# load_plan on damaged and foreign artifacts
# ----------------------------------------------------------------------------


def test_load_plan_truncated_artifact(tmp_path, plan_pair):
    spec, params = plan_pair
    p = tmp_path / "plan.npz"
    T.save_plan(p, spec, params)
    faults.corrupt_file(p, truncate_to=p.stat().st_size // 2)
    with pytest.raises(PlanValidationError, match="corrupt or truncated"):
        T.load_plan(p, device=CPU)


def test_load_plan_bitflipped_artifact(tmp_path, plan_pair):
    spec, params = plan_pair
    p = tmp_path / "plan.npz"
    T.save_plan(p, spec, params)
    faults.corrupt_file(p, flip_bytes=64, seed=11)
    with pytest.raises(PlanValidationError):
        T.load_plan(p, device=CPU)


def test_load_plan_roundtrip_still_validates(tmp_path, plan_pair):
    spec, params = plan_pair
    p = tmp_path / "plan.npz"
    T.save_plan(p, spec, params)
    before = plan_guard.stats()["validations"]
    spec2, params2 = T.load_plan(p, device=CPU)
    assert plan_guard.stats()["validations"] == before + 1
    X = np.random.default_rng(0).normal(size=(spec.n, 2)).astype(np.float32)
    assert torch.equal(_apply(spec, params, X), _apply(spec2, params2, X))


def test_load_plan_flags_corrupt_index_table(tmp_path, plan_pair):
    """An artifact that parses but points outside the vertex space is
    refused by the guard, before any params reach a device."""
    spec, params = plan_pair
    p = tmp_path / "plan.npz"
    T.save_plan(p, faults.flip_index(spec, field="tgt_scatter"), params)
    with pytest.raises(PlanValidationError, match="tgt_scatter"):
        T.load_plan(p, device=CPU)
    spec2, _ = T.load_plan(p, device=CPU, validate=False)
    assert int(spec2.tgt_scatter.max()) == 2 ** 30


def test_load_plan_coerces_int64_tables(tmp_path):
    """A reference artifact with int64 update tables (its schema <= 3)
    loads with every index table int32, bounds-guarded."""
    rspec, rparams = R.build(RG.random_tree(50, seed=4), leaf_size=8,
                             reweightable=True)
    old = dataclasses.replace(
        rspec, children=rspec.children.astype(np.int64),
        root_refs=rspec.root_refs.astype(np.int64),
        path_rows=rspec.path_rows.astype(np.int64))
    p = tmp_path / "old.npz"
    R.save_plan(p, old, rparams)
    spec, _ = T.load_plan(p, device=CPU)
    assert plan_guard.check_index_dtypes(spec) == []
    assert spec.digest == rspec.digest
    huge = dataclasses.replace(
        rspec, children=rspec.children.astype(np.int64) + 2 ** 40)
    R.save_plan(p, huge, rparams)
    with pytest.raises(PlanValidationError, match="int32"):
        T.load_plan(p, device=CPU)


def test_update_plan_output_is_validated():
    spec, params = T.build(TG.random_tree(40, seed=9), leaf_size=8,
                           reweightable=True, device=CPU)
    before = plan_guard.stats()["validations"]
    spec2, params2 = T.update_plan(spec, params, [("insert_leaf", 0, 0.5)])
    assert plan_guard.stats()["validations"] == before + 1
    assert plan_guard.check_spec(spec2, params2) == []


@pytest.mark.parametrize("kind", ["reweightable", "updated", "reference"])
def test_save_load_round_trip_update_tables(tmp_path, kind):
    """Reweightable and updated specs (update tables, edge list, ghosts)
    round-trip through save/load, the port's and the reference's, and the
    loaded plan still updates."""
    if kind == "reference":
        spec, pp = R.build(RG.random_tree(90, seed=11), leaf_size=8,
                           reweightable=True)
        spec, pp = R.update_plan(spec, pp, [("delete_leaf", 89)])
        path = tmp_path / "ref.npz"
        R.save_plan(path, spec, pp)
    else:
        spec, pp = T.build(TG.random_tree(90, seed=11), leaf_size=8,
                           reweightable=True, device=CPU)
        if kind == "updated":
            spec, pp = T.update_plan(spec, pp, [("insert_leaf", 4, 0.9),
                                                ("delete_leaf", 89)])
        path = tmp_path / "plan.npz"
        T.save_plan(path, spec, pp)
    spec2, pp2 = T.load_plan(path, device=CPU)
    assert spec2.digest == spec.digest
    if kind != "reweightable":
        assert spec2.ghosts.tolist() == [89]
    for a, b in zip(pp2.leaf_dists, pp.leaf_dists):
        assert np.array_equal(a.numpy(), np.asarray(b))
    s3, _ = T.update_plan(spec2, pp2, [("insert_leaf", 4, 0.9)])
    assert s3.n == spec.n + 1


def test_save_load_non_reweightable_refuses_update(tmp_path):
    spec, pp = T.build(TG.random_tree(90, seed=11), leaf_size=8, device=CPU)
    path = tmp_path / "plan.npz"
    T.save_plan(path, spec, pp)
    spec2, pp2 = T.load_plan(path, device=CPU)
    assert spec2.edges_u is None and spec2.edge_w0 is None
    with pytest.raises(ValueError, match="reweightable"):
        T.update_plan(spec2, pp2, [("insert_leaf", 4, 0.9)])


# ----------------------------------------------------------------------------
# the disk plan cache
# ----------------------------------------------------------------------------


def test_build_stores_then_cold_process_rebuild_hits(cache_dir):
    tree = TG.random_tree(300, seed=0)
    (spec1, pp1), d = _delta(
        lambda: T.build(tree, leaf_size=16, reweightable=True, device=CPU))
    assert d["stores"] == 1 and d["hits"] == 0
    assert plan_cache.stats()["entries"] == 1
    _forget()
    (spec2, pp2), d = _delta(
        lambda: T.build(tree, leaf_size=16, reweightable=True, device=CPU))
    assert d["hits"] == 1 and d["stores"] == 0
    assert spec2.digest == spec1.digest
    X = np.random.default_rng(1).normal(size=(300, 3)).astype(np.float32)
    assert torch.equal(_apply(spec1, pp1, X), _apply(spec2, pp2, X))


def test_distinct_compile_keys_get_distinct_artifacts(cache_dir):
    tree = TG.random_tree(120, seed=3)
    T.build(tree, leaf_size=8, device=CPU)
    T.build(tree, leaf_size=16, device=CPU)
    T.build(tree, leaf_size=8, reweightable=True, device=CPU)
    assert plan_cache.stats()["entries"] == 3


@pytest.mark.parametrize("damage", ["garbage", "bitflip"])
def test_corrupt_artifact_is_deleted_and_rebuilt(cache_dir, damage):
    tree = TG.random_tree(200, seed=5)
    spec1, pp1 = T.build(tree, leaf_size=16, device=CPU)
    [artifact] = list(cache_dir.glob("ftfi-plan-*.npz"))
    if damage == "garbage":
        artifact.write_bytes(b"this is not an npz")
    else:
        faults.corrupt_file(artifact, flip_bytes=48, seed=3)
    _forget()
    (spec2, pp2), d = _delta(lambda: T.build(tree, leaf_size=16, device=CPU))
    assert d["errors"] == 1 and d["hits"] == 0
    assert d["misses"] >= 1 and d["stores"] == 1
    assert spec2.digest == spec1.digest
    X = np.random.default_rng(1).normal(size=(200, 2)).astype(np.float32)
    assert torch.equal(_apply(spec1, pp1, X), _apply(spec2, pp2, X))


def test_lru_eviction_under_tiny_budget(cache_dir):
    plan_cache.configure(cache_dir, max_mb=0.05)
    _, d = _delta(lambda: [T.build(TG.random_tree(150, seed=s), leaf_size=8,
                                   device=CPU) for s in range(6)])
    assert d["stores"] == 6
    st = plan_cache.stats()
    assert d["evictions"] >= 1
    assert st["bytes"] <= st["max_bytes"]
    assert 0 < st["entries"] < 6


def test_clear_and_disable(cache_dir):
    tree = TG.random_tree(100, seed=7)
    T.build(tree, leaf_size=8, device=CPU)
    assert plan_cache.stats()["entries"] == 1
    plan_cache.clear()
    assert plan_cache.stats()["entries"] == 0
    plan_cache.configure(None)
    assert not plan_cache.enabled()
    _forget()
    _, d = _delta(lambda: T.build(tree, leaf_size=8, device=CPU))
    assert d == {"hits": 0, "misses": 0, "stores": 0, "evictions": 0,
                 "errors": 0}


def test_cache_max_mb_env_parse_is_defensive(monkeypatch, tmp_path):
    monkeypatch.setenv("FTFI_PLAN_CACHE_MAX_MB", "not-a-number")
    plan_cache.configure(tmp_path / "p")
    try:
        with pytest.warns(UserWarning, match="FTFI_PLAN_CACHE_MAX_MB"):
            assert plan_cache.stats()["max_bytes"] == int(512e6)
    finally:
        plan_cache.reset_to_env()


@pytest.mark.parametrize("reweightable", [False, True])
def test_cache_is_shared_with_the_reference(cache_dir, reweightable):
    """One FTFI_PLAN_CACHE directory serves both packages: the same key
    hex, the same artifact. The reference's entry hits in the port (and
    the port's in the reference), with the same spec digest."""
    r_cache.configure(cache_dir, max_mb=64)
    try:
        _forget()
        rspec, _ = R.build(RG.random_tree(130, seed=2), leaf_size=8,
                           reweightable=reweightable)
        (tspec, _), d = _delta(lambda: T.build(
            TG.random_tree(130, seed=2), leaf_size=8,
            reweightable=reweightable, device=CPU))
        assert d["hits"] == 1 and d["stores"] == 0
        assert tspec.digest == rspec.digest
        # the reverse: the port writes, the reference reads
        _, d = _delta(lambda: T.build(TG.random_tree(70, seed=9),
                                      leaf_size=8, device=CPU))
        assert d["stores"] == 1
        _forget()
        before = r_cache.stats()["hits"]
        R.build(RG.random_tree(70, seed=9), leaf_size=8)
        assert r_cache.stats()["hits"] == before + 1
    finally:
        r_cache.reset_to_env()
        _forget()


def test_cache_key_is_the_reference_key():
    key = ("0123abcd", 16, 0, False, True)
    assert plan_cache.key_str(key) == r_cache.key_str(key)


def test_guard_stats_and_warn_quietly():
    plan_guard.reset_stats()
    assert plan_guard.stats() == {"validations": 0, "failures": 0,
                                  "raised": 0, "warned": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec, params = T.build(TG.random_tree(30, seed=1), leaf_size=8,
                               device=CPU)
        assert plan_guard.validate(spec, params) is True
