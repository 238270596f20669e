"""Forest-masked serving of the port (ROADMAP A11) against the reference,
on the CPU: the smoke Qwen2-1.5B with attention_variant="topo" in float32,
the reference's weights carried by `convert.from_reference`, the cases of
tests/test_serve_prefill.py:231-353.

  * one packed two-tree forest prefill against per-request single-tree
    prefills (<= 1e-5 relative), and the port's tree-masked
    `prefill_into_cache` against the reference's (logits <= 1e-4, cache
    <= 1e-5: the served-LM bounds);
  * tree requests through the engine, single-slot and with membership
    churn (an admission repack, incremental evictions), equal to the
    reference engine's tokens, counters and `trace_guard` serve sites;
  * `ForestMaskManager` after the same admits and evictions: the spec's
    fingerprint, the slot offsets, the ghosts and the pack maps equal the
    reference manager's;
  * a `PlanRegistry` directory written by either package resolves in the
    other to the same sha, plan and tree;
  * a tree request on a non-topo engine and a plan_sha without a registry
    fail with the reference's messages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.analysis import trace_guard as R_tg  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.core import masks as R_masks  # noqa: E402
from repro.core import plan_guard as R_guard  # noqa: E402
from repro.graphs.graph import random_tree as r_random_tree  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import forest_masks as RF  # noqa: E402
from repro_torch.analysis import trace_guard as T_tg  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import masks as T_masks  # noqa: E402
from repro_torch.core import plan_guard as T_guard  # noqa: E402
from repro_torch.graphs.graph import random_tree as t_random_tree  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import forest_masks as TF  # noqa: E402

LOGIT_TOL, CACHE_TOL, PACKED_TOL = 1e-4, 1e-5, 1e-5
S, LP = 32, 8
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def _xla_compile_cache(tmp_path_factory):
    """Each reference engine jits anew, compiling programs seen before:
    XLA's persistent cache, for this module only, skips the repeats (the
    reference still traces, so its trace_guard counts are its own)."""
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
def _one_thread_strict_guard():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = (R_guard.policy(), T_guard.policy())
    R_guard.set_policy("strict")
    T_guard.set_policy("strict")
    yield
    R_guard.set_policy(old[0])
    T_guard.set_policy(old[1])
    torch.set_num_threads(threads)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-12)


@functools.lru_cache(maxsize=None)
def _setup(variant="topo"):
    """The reference tests' topo_setup (or dense_setup for "full"): both
    configs, the reference's weights (jitted init) and the port's model on
    them, the prompts and their trees (each package's random_tree)."""
    over = dict(dtype="float32")
    if variant == "topo":
        over["attention_variant"] = "topo"
    seed = 1 if variant == "topo" else 0
    rcfg = RB.get_smoke_config("qwen2_1_5b").replace(**over)
    tcfg = TB.get_smoke_config("qwen2_1_5b").replace(**over)
    rparams = jax.jit(RA.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(seed))
    model = convert.from_reference(tcfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, rcfg.vocab_size, size=int(n)).tolist()
               for n in ((5, 7) if variant == "topo" else (3, 7, 5, 4, 6))]
    rtrees = [r_random_tree(len(p), seed=i) for i, p in enumerate(prompts)]
    ttrees = [t_random_tree(len(p), seed=i) for i, p in enumerate(prompts)]
    return rcfg, rparams, tcfg, model, prompts, rtrees, ttrees


def _ref_prefill(cfg, params, mgr, slots, toks, lens):
    pack, unpack = mgr.pack_maps(LP, slots, toks.shape[0])
    tree_mask = {
        "make_fastmult": lambda c: R_masks.make_tree_fastmult(
            (mgr.spec, mgr.params), cfg.topo_g, c, cfg.topo_dist_scale),
        "pack": jnp.asarray(pack), "unpack": jnp.asarray(unpack)}
    logits, cache = RA.prefill_into_cache(
        cfg, params, RA.init_cache(cfg, toks.shape[0], S), jnp.asarray(toks),
        jnp.asarray(lens), S, tree_mask=tree_mask)
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


def _port_prefill(cfg, model, mgr, slots, toks, lens):
    pack, unpack = mgr.pack_maps(LP, slots, toks.shape[0])
    tree_mask = {
        "make_fastmult": lambda c: T_masks.make_tree_fastmult(
            (mgr.spec, mgr.params), cfg.topo_g, c, cfg.topo_dist_scale,
            device="cpu"),
        "pack": pack, "unpack": unpack}
    logits, cache = TA.prefill_into_cache(
        cfg, model, TA.init_cache(cfg, toks.shape[0], S, device="cpu"), toks,
        lens, S, tree_mask=tree_mask, device="cpu")
    return logits.numpy(), cache


def _batch(prompts):
    toks = np.zeros((len(prompts), LP), np.int32)
    lens = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        lens[i] = len(p)
    return toks, lens


def test_forest_packed_vs_per_request_and_reference():
    """ONE packed two-tree forest prefill matches per-request single-tree
    prefills (block-diagonal: zero cross-tree coupling), and the reference's
    packed prefill on the same weights and trees."""
    rcfg, rparams, tcfg, model, prompts, rtrees, ttrees = _setup()
    rmgr = RF.ForestMaskManager(2, leaf_size=4)
    tmgr = TF.ForestMaskManager(2, leaf_size=4, device="cpu")
    for s in range(2):
        rmgr.admit(s, rtrees[s])
        tmgr.admit(s, ttrees[s])
    toks, lens = _batch(prompts)
    packed, cache = _port_prefill(tcfg, model, tmgr, [0, 1], toks, lens)
    want, want_cache = _ref_prefill(rcfg, rparams, rmgr, [0, 1], toks, lens)
    assert _rel(packed, want) <= LOGIT_TOL
    for k in ("S", "z"):
        assert _rel(cache["blocks0"][k], want_cache["blocks0"][k]) <= CACHE_TOL
    for i, (p, t) in enumerate(zip(prompts, ttrees)):
        solo = TF.ForestMaskManager(1, leaf_size=4, device="cpu")
        solo.admit(0, t)
        st, sl = _batch([p])
        single, _ = _port_prefill(tcfg, model, solo, [0], st, sl)
        assert _rel(packed[i], single[0]) <= PACKED_TOL, i
    assert tmgr.stats == rmgr.stats
    assert tmgr.stats["swaps_validated"] >= 2


def _engine_run(side, cfg, params, reqs, **kw):
    side["tg"].reset()
    eng = side["engine"].ServeEngine(cfg, params, **kw, **side["kw"])
    for r in reqs:
        eng.submit(r)
    eng.run()
    st = eng.stats()
    return eng, {k: v for k, v in st.items() if not k.endswith("_s")
                 and k not in ("ladder", "plan_guard", "plan_cache")}


REF = {"engine": RE, "tg": R_tg, "kw": {}}
PORT = {"engine": TE, "tg": T_tg, "kw": {"device": "cpu"}}


def _serve_sites(tg) -> dict:
    """The engine's own trace_guard sites (the reference's plan and mask
    layers record more of their own)."""
    st = tg.stats()
    return {"sites": {k: v for k, v in st["sites"].items()
                      if k.startswith("serve.")},
            "keys": {k: v for k, v in st["keys"].items()
                     if k.startswith("serve.")}}


def test_tree_masked_serving_matches_the_reference_engine():
    """Tree-masked requests single-slot and batched with membership churn
    (budgets 3 and 4: the first eviction patches the live plan): the same
    greedy tokens in both engines and across batch sizes, the same
    counters (forest-mask stats included) and trace_guard serve sites."""
    rcfg, rparams, tcfg, model, prompts, rtrees, ttrees = _setup()
    for budgets in ((4, 4), (3, 4)):
        got = {}
        for name, side, cfg, params, trees in (
                ("ref", REF, rcfg, rparams, rtrees),
                ("port", PORT, tcfg, model, ttrees)):
            E = side["engine"]
            singles = []
            for p, t in zip(prompts, trees):
                r = E.Request(rid=0, prompt=p, max_new_tokens=4, tree=t)
                _engine_run(side, cfg, params, [r], batch_slots=1,
                            max_len=S)
                singles.append(list(r.out))
            reqs = [E.Request(rid=i, prompt=p, max_new_tokens=mn, tree=t)
                    for i, (p, t, mn) in enumerate(zip(prompts, trees,
                                                       budgets))]
            _, st = _engine_run(side, cfg, params, reqs, batch_slots=2,
                                max_len=S)
            got[name] = (singles, [(r.out, r.done, r.error) for r in reqs],
                         st, _serve_sites(side["tg"]))
        assert got["port"] == got["ref"], budgets
        singles, outs, st, sites = got["port"]
        for (out, done, err), ref, mn in zip(outs, singles, budgets):
            assert done and err is None and out == ref[:mn]
        fm = st["forest_masks"]
        assert fm["builds"] >= 1 and fm["swaps_validated"] >= fm["builds"]
        assert sites["sites"]["serve.prefill_tree"] >= 1
    assert fm["incremental_evictions"] >= 1


def test_mask_manager_matches_the_reference_manager():
    """The same admits and evictions: the spec's fingerprint, the offsets,
    the ghosts and the pack maps equal the reference manager's; survivors
    keep their offsets across an incremental eviction."""
    sizes = (5, 7, 6)
    rm = RF.ForestMaskManager(3, leaf_size=4)
    tm = TF.ForestMaskManager(3, leaf_size=4, device="cpu")

    def same():
        assert (tm.spec is None) == (rm.spec is None)
        np.testing.assert_array_equal(tm.slot_offset, rm.slot_offset)
        assert tm.stats == rm.stats
        if tm.spec is None:
            return
        assert tm.spec.fingerprint == rm.spec.fingerprint
        assert tm.spec.n == rm.spec.n
        g_t, g_r = tm.spec.ghosts, rm.spec.ghosts
        assert (g_t is None) == (g_r is None)
        if g_t is not None:
            np.testing.assert_array_equal(np.sort(g_t), np.sort(g_r))
        live = [s for s in range(3) if tm.slot_tree[s] is not None]
        for got, want in zip(tm.pack_maps(8, live, 3),
                             rm.pack_maps(8, live, 3)):
            np.testing.assert_array_equal(got, want)

    for s, n in enumerate(sizes):
        rm.admit(s, r_random_tree(n, seed=n))
        tm.admit(s, t_random_tree(n, seed=n))
        same()
    before = tm.slot_offset.copy()
    for s in (1, 0, 2):
        rm.evict(s)
        tm.evict(s)
        same()
        if s == 1:
            assert tm.stats["incremental_evictions"] == 1
            assert T_guard.check_spec(tm.spec, tm.params) == []
            assert tm.slot_offset[0] == before[0]
            assert tm.slot_offset[2] == before[2]
            assert len(tm.spec.ghosts) == sizes[1] - 1
            pack, _ = tm.pack_maps(8, [0, 2], 3)
            assert (pack >= 0).sum() == sizes[0] + sizes[2]
    assert tm.spec is None and not tm.any_active()


def test_plan_registry_is_shared_by_both_packages(tmp_path):
    """A registry written by either package resolves in the other: the
    same sha (the plan's fingerprint), the same plan and the same tree;
    the port serves a request named by sha as it serves its tree."""
    rcfg, rparams, tcfg, model, prompts, rtrees, ttrees = _setup()
    rreg = RF.PlanRegistry(tmp_path / "by_ref", leaf_size=4)
    sha = rreg.put(rtrees[0])
    treg = TF.PlanRegistry(tmp_path / "by_ref", leaf_size=4, device="cpu")
    assert treg.put(ttrees[0]) == sha  # idempotent, the same content
    spec, _ = treg.resolve(sha)
    assert spec.fingerprint[:12] == sha
    t2 = treg.resolve_tree(sha)
    np.testing.assert_array_equal(t2.edges_u, rtrees[0].edges_u)
    np.testing.assert_array_equal(t2.weights, rtrees[0].weights)
    treg2 = TF.PlanRegistry(tmp_path / "by_port", leaf_size=4,
                            device="cpu")
    sha2 = treg2.put(ttrees[1])
    rreg2 = RF.PlanRegistry(tmp_path / "by_port", leaf_size=4)
    rspec, _ = rreg2.resolve(sha2)
    assert rspec.fingerprint[:12] == sha2 == rreg2.put(rtrees[1])
    assert rreg2.resolve_tree(sha2).num_vertices == len(prompts[1])
    by_tree = TE.Request(rid=0, prompt=prompts[0], max_new_tokens=4,
                         tree=ttrees[0])
    _engine_run(PORT, tcfg, model, [by_tree], batch_slots=1, max_len=S)
    by_sha = TE.Request(rid=0, prompt=prompts[0], max_new_tokens=4,
                        plan_sha=sha)
    _engine_run(PORT, tcfg, model, [by_sha], batch_slots=1, max_len=S,
                registry=str(tmp_path / "by_ref"))
    assert by_sha.done and by_sha.error is None
    assert by_sha.out == by_tree.out


def test_tree_requests_rejected_with_the_reference_messages():
    """A tree request on a non-topo engine, and a plan_sha with no
    registry, fail at admission with the reference's errors."""
    rd, rpd, td, tmd, dprompts, _, _ = _setup("full")
    rcfg, rparams, tcfg, model, prompts, _, _ = _setup()
    cases = [
        (rd, rpd, td, tmd, dict(prompt=dprompts[0], max_new_tokens=4),
         "tree", "attention_variant='topo'"),
        (rcfg, rparams, tcfg, model,
         dict(prompt=prompts[0], max_new_tokens=4, plan_sha="deadbeef0123"),
         None, "no plan registry"),
    ]
    for rc, rp, tc, tp, kw, tree, says in cases:
        errors = []
        for side, cfg, params, rt in ((REF, rc, rp, r_random_tree),
                                      (PORT, tc, tp, t_random_tree)):
            extra = {"tree": rt(len(kw["prompt"]), seed=0)} if tree else {}
            r = side["engine"].Request(rid=0, **kw, **extra)
            _, st = _engine_run(side, cfg, params, [r], batch_slots=1,
                                max_len=S)
            assert r.done and st["failed"] == 1
            errors.append(r.error)
        assert errors[0] == errors[1] and says in errors[1]


def test_tree_fastmult_chunks_bound_the_executor_tables(monkeypatch):
    """A reweightable forest plan holds ~10 source groups a vertex: the
    folded field runs `field_chunk(spec)` columns at a time (the element
    budget over the largest row table), which gives the one-chunk field."""
    mgr = TF.ForestMaskManager(2, leaf_size=4, device="cpu")
    for s, n in enumerate((30, 21)):
        mgr.admit(s, t_random_tree(n, seed=s))
    spec = mgr.spec
    rows = max(spec.n, spec.n_src_groups, len(spec.tgt_gather))
    assert rows > spec.n
    assert T_masks.field_chunk(spec) == T_masks.FIELD_COL_CHUNK
    X = torch.randn(2, 3, spec.n, 5, generator=torch.Generator().manual_seed(4))
    cs = torch.tensor([0.0, -0.7])
    plan = (spec, mgr.params)
    whole = T_masks.make_tree_fastmult(plan, "exp", cs, 0.05, device="cpu")(X)
    monkeypatch.setattr(T_masks, "FIELD_CHUNK_ELEMS", 4 * rows)
    assert T_masks.field_chunk(spec) == 4  # 30 columns: 8 chunks
    got = T_masks.make_tree_fastmult(plan, "exp", cs, 0.05, device="cpu")(X)
    assert _rel(got, whole) <= 1e-6
