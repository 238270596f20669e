"""The serving engine of the port (ROADMAP A11) against the reference's
engine, on the CPU.

  * the smoke Qwen2-1.5B in float32, the reference's weights carried by
    `convert.from_reference`: each row of the reference's engine cases
    (tests/test_serve_prefill.py:68-213, tests/test_serving_faults.py:
    314-413) runs the same scenario (prompts, slots, faults) through
    `repro.serve.engine.ServeEngine` and `repro_torch.serve.engine.
    ServeEngine`: every request's tokens, error, retries and truncated
    flag, `stats()` without the `_s` times (the ladder and plan-guard
    counters as the scenario's increments), and the `trace_guard` counts
    equal;
  * port only, one smoke config per other decoder-only family (moe, ssm,
    hybrid, vlm): mid-wave admission through 2 slots equals the
    single-slot outputs (a mid-wave prefill's length-0 rows keep their
    live neighbours' cache), and a prefill that raises part-way through
    the stack leaves the live slots' cache as it was;
  * the smoke SeamlessM4T is forced to replay and gives the reference
    engine's tokens.

Each reference `ServeEngine` jits its own closures, so each scenario
runs the reference once, and the same programs compile engine after
engine: XLA's persistent compilation cache, on a temp dir for this module
only, skips the repeated compiles. The reference still traces every
closure, so its `trace_guard` counts are its own.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import ftfi as R_ftfi  # noqa: E402
from repro.analysis import trace_guard as R_tg  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.core import ladder as R_ladder  # noqa: E402
from repro.core import plan_guard as R_guard  # noqa: E402
from repro.graphs.graph import random_tree as r_random_tree  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.testing import faults as R_faults  # noqa: E402
from repro_torch import ftfi as T_ftfi  # noqa: E402
from repro_torch.analysis import trace_guard as T_tg  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import ladder as T_ladder  # noqa: E402
from repro_torch.core import plan_guard as T_guard  # noqa: E402
from repro_torch.graphs.graph import random_tree as t_random_tree  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.testing import faults as T_faults  # noqa: E402

FAMILIES = ("deepseek_v2_lite_16b", "falcon_mamba_7b", "recurrentgemma_2b",
            "llava_next_34b")
GLOBAL = ("ladder", "plan_guard", "plan_cache")  # process-wide counters


CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def _xla_compile_cache(tmp_path_factory):
    from jax._src import compilation_cache

    old = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    jax.config.update(CACHE_KEYS[0], str(tmp_path_factory.mktemp("xla")))
    jax.config.update(CACHE_KEYS[1], 0)
    jax.config.update(CACHE_KEYS[2], 0)
    compilation_cache.reset_cache()
    yield
    for k, v in old.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True)
def _clean_state():
    """Faults disarmed, ladders unblocked, both guards strict, one torch
    thread, per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = (R_guard.policy(), T_guard.policy())
    for mod in (R_faults, T_faults):
        mod.clear()
    for mod in (R_ladder, T_ladder):
        mod.unblock_backends()
    R_guard.set_policy("strict")
    T_guard.set_policy("strict")
    try:
        yield
    finally:
        for mod in (R_faults, T_faults):
            mod.clear()
        for mod in (R_ladder, T_ladder):
            mod.unblock_backends()
        R_guard.set_policy(old[0])
        T_guard.set_policy(old[1])
        torch.set_num_threads(threads)


class Side:
    """One package's engine, request type, faults and counters, over the
    same weights."""

    def __init__(self, cfg, params, engine, faults, tg, ladder, guard,
                 **engine_kw):
        self.cfg, self.params = cfg, params
        self.Engine, self.Request = engine.ServeEngine, engine.Request
        self.faults, self.tg = faults, tg
        self.ladder, self.guard = ladder, guard
        self.engine_kw = engine_kw

    def engine(self, **kw):
        return self.Engine(self.cfg, self.params, **kw, **self.engine_kw)


@functools.lru_cache(maxsize=None)
def _sides(arch, seed=0):
    """(reference Side, port Side) of `arch`'s smoke config in float32 on
    the reference's weights (init jitted once per process)."""
    rcfg = RB.get_smoke_config(arch).replace(dtype="float32")
    rparams = jax.jit(RA.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(seed))
    tcfg = TB.get_smoke_config(arch).replace(dtype="float32")
    model = convert.from_reference(tcfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return (Side(rcfg, rparams, RE, R_faults, R_tg, R_ladder, R_guard),
            Side(tcfg, model, TE, T_faults, T_tg, T_ladder, T_guard,
                 device="cpu"))


def _prompts(cfg, sizes=(3, 7, 5, 4, 6), seed=0):
    """The reference tests' dense_setup / serve_setup prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
            for n in sizes]


def _counters(side) -> dict:
    return {"ladder": {k: v for k, v in side.ladder.stats().items()
                       if k != "blocked"},
            "plan_guard": side.guard.stats()}


def _run(side, go):
    """go(side) -> (engine, requests) on a clean trace_guard; returns the
    outcome to compare."""
    side.tg.reset()
    before = _counters(side)
    eng, reqs = go(side)
    after = _counters(side)
    st = eng.stats()
    return {
        "requests": [(r.out, r.done, r.error, r.retries, r.truncated)
                     for r in reqs],
        "stats": {k: v for k, v in st.items()
                  if not k.endswith("_s") and k not in GLOBAL},
        "counters": {g: {k: after[g][k] - before[g][k] for k in after[g]}
                     for g in after},
        "blocked": sorted(st["ladder"]["blocked"]),
        "trace_guard": side.tg.stats(),
        # the engine's own counters (the ladder's and guard's are
        # process-wide: compared above as the scenario's increments)
        "banner": eng.health_banner().split(" demotions=")[0],
        "engine": eng,
    }


@functools.lru_cache(maxsize=None)
def _scenario(name):
    """The scenario `name` of SCENARIOS on both packages: (reference
    outcome, port outcome), each computed once per process."""
    ref, port = _sides("qwen2_1_5b")
    go = SCENARIOS[name]
    return _run(ref, go), _run(port, go)


def _assert_same(name):
    r, t = _scenario(name)
    for key in ("requests", "stats", "counters", "blocked", "trace_guard",
                "banner"):
        assert t[key] == r[key], (name, key, t[key], r[key])
    return r, t


def _serve(side, reqs, **kw):
    eng = side.engine(**kw)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


def _reqs(side, specs):
    return [side.Request(rid=i, **s) for i, s in enumerate(specs)]


def _leaves(tree, prefix="") -> dict:
    """{dotted path: tensor} of a nested cache dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


# ----------------------------------------------------------------------------
# the scenarios: each the body of a reference test, on either package
# ----------------------------------------------------------------------------


def _fused(side):
    p = _prompts(side.cfg)
    return _serve(side, _reqs(side, [dict(prompt=x, max_new_tokens=4)
                                     for x in p[:3]]),
                  batch_slots=3, max_len=64, prefill_mode="fused")


def _replay(side):
    p = _prompts(side.cfg)
    return _serve(side, _reqs(side, [dict(prompt=x, max_new_tokens=4)
                                     for x in p[:3]]),
                  batch_slots=3, max_len=64, prefill_mode="replay")


BUDGETS = (4, 8, 4, 6, 3)


def _mid_wave(side):
    p = _prompts(side.cfg)
    return _serve(side, _reqs(side, [dict(prompt=x, max_new_tokens=mn)
                                     for x, mn in zip(p, BUDGETS)]),
                  batch_slots=2, max_len=64)


def _eos(side):
    p = _prompts(side.cfg)
    probe = side.Request(rid=0, prompt=p[0], max_new_tokens=1)
    _serve(side, [probe], batch_slots=1, max_len=64)
    r = side.Request(rid=0, prompt=p[0], max_new_tokens=8)
    eng, _ = _serve(side, [r], batch_slots=1, max_len=64,
                    eos_id=probe.out[0])
    return eng, [probe, r]


def _prefill_crash(side):
    p = _prompts(side.cfg)
    r = side.Request(rid=0, prompt=p[0], max_new_tokens=4)
    eng = side.engine(batch_slots=1, max_len=64)
    eng.submit(r)
    with side.faults.injected("serve.prefill", side.faults.raise_at_tick(1)):
        eng.run()
    return eng, [r]


def _nonfinite_prefill(side):
    p = _prompts(side.cfg)
    reqs = _reqs(side, [dict(prompt=x, max_new_tokens=4) for x in p[:2]])
    eng = side.engine(batch_slots=2, max_len=64)
    for r in reqs:
        eng.submit(r)
    with side.faults.injected("serve.prefill_logits",
                              side.faults.nan_slot_at_tick(slot=1, k=1)):
        eng.run()
    return eng, reqs


def _truncation(side):
    p = _prompts(side.cfg)
    return _serve(side, [side.Request(rid=0, prompt=p[1],
                                      max_new_tokens=32)],
                  batch_slots=1, max_len=16)


def _exhaustion(side):
    p = _prompts(side.cfg)
    inflight = side.Request(rid=0, prompt=p[0], max_new_tokens=32)
    queued = side.Request(rid=1, prompt=p[1], max_new_tokens=32)
    eng = side.engine(batch_slots=1, max_len=64)
    eng.submit(inflight)
    eng.submit(queued)
    eng.run(max_ticks=2)
    stopped = [(r.out, r.done, r.error) for r in (inflight, queued)]
    again = side.Request(rid=2, prompt=p[0], max_new_tokens=4)
    eng.submit(again)
    eng.run()
    eng.stopped = stopped  # the state the reference test reads after run 1
    return eng, [inflight, queued, again]


def _oversized(side):
    p = _prompts(side.cfg)
    big = side.Request(rid=0, prompt=np.random.default_rng(3).integers(
        0, side.cfg.vocab_size, size=16).tolist(), max_new_tokens=4)
    ok = side.Request(rid=1, prompt=p[0], max_new_tokens=4)
    return _serve(side, [big, ok], batch_slots=1, max_len=16)


def _mixed(side):
    p = _prompts(side.cfg, (3, 7, 5))
    return _serve(side, _reqs(side, [dict(prompt=x, max_new_tokens=4)
                                     for x in p]),
                  batch_slots=2, max_len=64)


def _faulted(point, handler):
    def go(side):
        p = _prompts(side.cfg, (3, 7, 5))
        reqs = _reqs(side, [dict(prompt=x, max_new_tokens=4) for x in p[:2]])
        eng = side.engine(batch_slots=2, max_len=64)
        for r in reqs:
            eng.submit(r)
        with side.faults.injected(point, handler(side.faults)):
            eng.run()
        return eng, reqs
    return go


def _retry_exhaustion(side):
    p = _prompts(side.cfg, (3, 7, 5))
    eng = side.engine(batch_slots=1, max_len=64, max_retries=1)
    doomed = side.Request(rid=0, prompt=p[0], max_new_tokens=4)
    eng.submit(doomed)
    with side.faults.injected("serve.logits", side.faults.nan_output()):
        eng.run()
    healthy = side.Request(rid=1, prompt=p[1], max_new_tokens=4)
    eng.submit(healthy)
    eng.run()
    return eng, [doomed, healthy]


def _deadline(side):
    p = _prompts(side.cfg, (3, 7, 5))
    a = side.Request(rid=0, prompt=p[0], max_new_tokens=4)
    b = side.Request(rid=1, prompt=p[1], max_new_tokens=4, deadline_ticks=2)
    return _serve(side, [a, b], batch_slots=1, max_len=64)


SCENARIOS = {
    "fused": _fused, "replay": _replay, "mid_wave": _mid_wave, "eos": _eos,
    "prefill_crash": _prefill_crash, "nonfinite_prefill": _nonfinite_prefill,
    "truncation": _truncation, "exhaustion": _exhaustion,
    "oversized": _oversized, "mixed": _mixed,
    "slot_fault": _faulted("serve.logits",
                           lambda F: F.nan_slot_at_tick(slot=1, k=2)),
    "step_crash": _faulted("serve.step", lambda F: F.raise_at_tick(3)),
    "retry_exhaustion": _retry_exhaustion, "deadline": _deadline,
}


@functools.lru_cache(maxsize=None)
def _port_side(arch):
    """The port's Side of `arch`'s smoke config in float32 on its own
    seeded weights (no reference needed). The MoE's capacity is lifted to
    num_experts / top_k (C = T: no assignment dropped): at its configured
    1.25 the dispatch drops by batch composition, padded positions
    included (`models/moe.py`, as in the reference), so a batch of 2 rows
    routes otherwise than a batch of 1 whatever the engine does."""
    cfg = TB.get_smoke_config(arch).replace(dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    return Side(cfg, TA.init_params(cfg, 0, device="cpu"), TE, T_faults,
                T_tg, T_ladder, T_guard, device="cpu")


@functools.lru_cache(maxsize=None)
def _single_slot(arch, prompt: tuple, max_new: int) -> list:
    """The port's single-slot greedy output of one prompt (qwen2 on the
    reference's weights, the other families on the port's)."""
    port = _sides(arch)[1] if arch == "qwen2_1_5b" else _port_side(arch)
    r = port.Request(rid=0, prompt=list(prompt), max_new_tokens=max_new)
    _serve(port, [r], batch_slots=1, max_len=64)
    assert r.done and r.error is None
    return list(r.out)


# ----------------------------------------------------------------------------
# tests/test_serve_prefill.py:68-213 on both engines
# ----------------------------------------------------------------------------


def test_fused_matches_replay_bit_identical():
    rf, tf = _assert_same("fused")
    rr, tr = _assert_same("replay")
    for f, r in zip(tf["requests"], tr["requests"]):
        assert f[1] and f[2] is None and f[0] == r[0]
    sizes = sum(len(p) for p in _prompts(_sides("qwen2_1_5b")[1].cfg)[:3])
    assert tf["stats"]["prefill_calls"] >= 1
    assert tf["stats"]["prefill_tokens"] == sizes
    assert tr["stats"]["prefill_calls"] == 0
    assert tf["trace_guard"]["sites"] == {"serve.decode": 1,
                                          "serve.prefill": 1}
    assert tr["trace_guard"]["sites"] == {"serve.decode": 1}


def test_mid_wave_admission_matches_single_slot():
    _, t = _assert_same("mid_wave")
    prompts = _prompts(_sides("qwen2_1_5b")[1].cfg)
    for (out, done, err, _, _), p, mn in zip(t["requests"], prompts,
                                             BUDGETS):
        assert done and err is None
        assert out == _single_slot("qwen2_1_5b", tuple(p), mn)
    assert t["stats"]["completed"] == 5 and t["stats"]["failed"] == 0
    assert t["stats"]["prefill_calls"] >= 3


def test_eos_as_first_generated_token():
    _, t = _assert_same("eos")
    (probe, *_), (out, done, err, _, trunc) = t["requests"]
    assert done and err is None and not trunc
    assert out == [probe[0]]
    assert t["stats"]["completed"] == 1 and t["stats"]["decode_tokens"] == 0


def test_prefill_crash_requeues_group_deterministically():
    _, t = _assert_same("prefill_crash")
    (out, done, err, _, _), = t["requests"]
    p = _prompts(_sides("qwen2_1_5b")[1].cfg)[0]
    assert done and err is None
    assert out == _single_slot("qwen2_1_5b", tuple(p), 4)
    assert t["stats"]["prefill_failures"] == 1 and t["stats"]["retries"] == 1
    assert t["stats"]["failed"] == 0


def test_nonfinite_prefill_logits_evict_only_that_slot():
    _, t = _assert_same("nonfinite_prefill")
    assert [r[3] for r in t["requests"]] == [0, 1]
    assert all(r[1] and r[2] is None for r in t["requests"])
    assert t["stats"]["slot_faults"] == 1 and t["stats"]["failed"] == 0


def test_cache_bound_truncation_is_marked():
    _, t = _assert_same("truncation")
    (out, done, err, _, trunc), = t["requests"]
    assert done and err is None and trunc is True
    assert len(out) == 16 - 1 - 7 + 1 < 32
    assert t["stats"]["truncated"] == 1 and t["stats"]["completed"] == 1
    assert "truncated=1" in t["engine"].health_banner()


def test_full_answers_are_not_marked_truncated():
    _, t = _assert_same("prefill_crash")
    assert t["requests"][0][4] is False and t["stats"]["truncated"] == 0


def test_run_exhaustion_fails_inflight_and_queued():
    r, t = _assert_same("exhaustion")
    assert t["engine"].stopped == r["engine"].stopped
    for out, done, err in t["engine"].stopped:
        assert done and "engine stopped" in err and "max_ticks=2" in err
    again = t["requests"][2]
    assert again[1] and again[2] is None
    assert t["stats"]["stopped_inflight"] == 2 and t["stats"]["failed"] == 2
    assert "stopped=2" in t["engine"].health_banner()


def test_oversized_prompt_fails_cleanly():
    _, t = _assert_same("oversized")
    big, ok = t["requests"]
    assert big[1] and "prompt length 16 >= max_len 16" in big[2]
    assert ok[1] and ok[2] is None
    assert t["stats"]["failed"] == 1 and t["stats"]["completed"] == 1


# ----------------------------------------------------------------------------
# tests/test_serving_faults.py:314-413 on both engines
# ----------------------------------------------------------------------------


def test_mixed_length_waves_match_reference():
    _, t = _assert_same("mixed")
    for (out, done, err, _, _), p in zip(
            t["requests"], _prompts(_sides("qwen2_1_5b")[1].cfg, (3, 7, 5))):
        assert done and err is None
        assert out == _single_slot("qwen2_1_5b", tuple(p), 4)
    assert t["stats"]["completed"] == 3


@pytest.mark.parametrize("name", ["slot_fault", "step_crash"])
def test_faulted_wave_recovers_like_the_reference(name):
    _, t = _assert_same(name)
    prompts = _prompts(_sides("qwen2_1_5b")[1].cfg, (3, 7, 5))
    for (out, done, err, _, _), p in zip(t["requests"], prompts):
        assert done and err is None
        assert out == _single_slot("qwen2_1_5b", tuple(p), 4)
    st = t["stats"]
    if name == "slot_fault":
        assert [r[3] for r in t["requests"]] == [0, 1]
        assert st["slot_faults"] == 1 and st["evictions"] == 1
        assert st["retries"] == 1
    else:
        assert st["step_failures"] == 1 and st["evictions"] == 2
    assert st["failed"] == 0


def test_retry_budget_exhaustion_fails_request_not_engine():
    _, t = _assert_same("retry_exhaustion")
    doomed, healthy = t["requests"]
    assert doomed[1] and "retries" in doomed[2]
    assert healthy[1] and healthy[2] is None
    assert t["stats"]["failed"] == 1


def test_deadline_expires_queued_request():
    _, t = _assert_same("deadline")
    a, b = t["requests"]
    assert a[1] and a[2] is None
    assert b[1] and "deadline" in b[2]
    assert t["stats"]["deadline_expired"] == 1


def test_engine_rejects_corrupt_preloaded_plan():
    ref, port = _sides("qwen2_1_5b")
    for side, ftfi, tree, kw in (
            (ref, R_ftfi, r_random_tree, {}),
            (port, T_ftfi, t_random_tree, {"device": "cpu"})):
        spec, pp = ftfi.build(tree(60, seed=7), leaf_size=8, **kw)
        bad = side.faults.flip_index(spec, field="src_gather")
        with pytest.raises(ftfi.PlanValidationError):
            side.engine(batch_slots=1, max_len=32, plan=(bad, pp))
        eng = side.engine(batch_slots=1, max_len=32, plan=(spec, pp))
        assert eng.plan_grid_side is None
        assert f"sha={spec.fingerprint[:12]}" in eng.plan_banner()


def test_health_banner_mentions_counters():
    r, t = _assert_same("deadline")
    line = t["engine"].health_banner()
    assert "done=1" in line and "retries=" in line and "demotions=" in line
    assert line.endswith("devices=1 plan_mesh=unsharded")


# ----------------------------------------------------------------------------
# the port's other families, and the engine's cache discipline
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_mid_wave_admission_per_family(arch):
    """Mixed prompts with staggered budgets through 2 slots: requests 3-4
    admit while a neighbour decodes, so each mid-wave prefill runs a live
    row at length 0, which must keep its cache."""
    port = _port_side(arch)
    prompts = _prompts(port.cfg, (5, 9, 3, 7))
    budgets = (6, 2, 5, 3)
    want = [_single_slot(arch, tuple(p), mn)
            for p, mn in zip(prompts, budgets)]
    reqs = [port.Request(rid=i, prompt=p, max_new_tokens=mn)
            for i, (p, mn) in enumerate(zip(prompts, budgets))]
    T_tg.reset()
    eng, _ = _serve(port, reqs, batch_slots=2, max_len=64)
    for r, w in zip(reqs, want):
        assert r.done and r.error is None, r.error
        assert r.out == w, (arch, r.rid)
    assert eng.stats()["prefill_calls"] >= 3
    # the first group (5 and 9 tokens) prefills at 16, each later one at 8
    assert T_tg.stats() == {
        "sites": {"serve.decode": 1, "serve.prefill": 2},
        "keys": {"serve.prefill [L16]": 1, "serve.prefill [L8]": 1}}


def test_prefill_raising_mid_stack_keeps_live_slots(monkeypatch):
    """A prefill group that raises after its first layer made its new
    cache: the engine keeps the old cache (the same tensors, unchanged),
    the live slot decodes on to its single-slot output, and the failed
    request is retried onto its own."""
    port = _sides("qwen2_1_5b")[1]
    prompts = _prompts(port.cfg, (6, 4))
    eng = port.engine(batch_slots=2, max_len=64)
    a = port.Request(rid=0, prompt=prompts[0], max_new_tokens=6)
    eng.submit(a)
    eng.step()  # a prefilled and decoding
    b = port.Request(rid=1, prompt=prompts[1], max_new_tokens=3)
    eng.submit(b)
    real = TLM._block_prefill
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the second layer of the next prefill
            raise RuntimeError("layer fault")
        return real(*args, **kw)

    monkeypatch.setattr(TLM, "_block_prefill", flaky)
    old = _leaves(eng.cache)
    snap = {k: v.clone() for k, v in old.items()}
    eng.step()  # b's prefill raises part-way; a's decode still runs
    assert eng.stats()["prefill_failures"] == 1 and b.retries == 1
    for k, v in old.items():
        assert torch.equal(v, snap[k]), k
    monkeypatch.setattr(TLM, "_block_prefill", real)
    eng.run()
    assert a.done and a.error is None and b.done and b.error is None
    assert a.out == _single_slot("qwen2_1_5b", tuple(prompts[0]), 6)
    assert b.out == _single_slot("qwen2_1_5b", tuple(prompts[1]), 3)


def test_encdec_is_forced_to_replay_and_matches_the_reference():
    ref, port = _sides("seamless_m4t_medium")

    def go(side):
        p = _prompts(side.cfg, (4, 6))
        return _serve(side, _reqs(side, [dict(prompt=x, max_new_tokens=3)
                                         for x in p]),
                      batch_slots=2, max_len=32, prefill_mode="fused")

    r, t = _run(ref, go), _run(port, go)
    assert t["engine"].prefill_mode == r["engine"].prefill_mode == "replay"
    for key in ("requests", "stats", "trace_guard"):
        assert t[key] == r[key], key
    assert all(x[1] and x[2] is None and len(x[0]) == 3
               for x in t["requests"])
    assert t["stats"]["prefill_calls"] == 0


@pytest.mark.parametrize("argv", [[], ["--variant", "topo"],
                                  ["--prefill-mode", "replay"]],
                         ids=["full", "topo", "replay"])
def test_serve_cli_on_the_cpu(argv, capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu` serves
    every request and prints the banners."""
    from repro_torch.launch import serve

    eng, reqs = serve.main(["--arch", "llama3_2_1b", "--smoke", "--device",
                            "cpu", "--requests", "3", "--slots", "2",
                            "--max-new", "4", "--max-len", "32"] + argv)
    assert all(r.done and r.error is None and len(r.out) == 4
               for r in reqs)
    assert eng.prefill_mode == ("replay" if argv[:1] == ["--prefill-mode"]
                                else "fused")
    out = capsys.readouterr().out
    assert "served 3/3 requests (0 failed" in out
    assert "health: ticks=" in out and " failed=0 " in out
    assert "plan: none" in out

