"""Sharded serving on the port (`launch.steps.make_serve_step` on a model
that `launch.sharding.distribute_params` placed, its cache, token and pos
placed by `launch.specs.batch_shardings`) against the port's single-device
step and, for the smoke Llama-3.2-1B (full and topological attention),
the reference's `make_serve_step`.

One module fixture starts ONE 4-rank gloo group of CPU processes on a
(2, 2) mesh (`launch.mesh.run_local`; the per-rank work is
`_torch_serve_shard_worker.rank_main`), while this process computes the
reference's steps jitted from the same weights (the reference's init,
carried over by `models/convert.py`). Each case fills a cache with the
port's single-device prefill (the encoder-decoder family by decode
replay), then takes 3 greedy decode steps on one device and sharded:

  * `tiny_decode` (B = 8, the batch over data; KV heads or channels over
    model where they divide): llama3_2_1b full and topo, the MLA + MoE
    deepseek_v2_lite_16b, falcon_mamba_7b, recurrentgemma_2b,
    seamless_m4t_medium and llava_next_34b;
  * `tiny_long` (B = 1, the cache's sequence over data): llama3_2_1b full
    and deepseek_v2_lite_16b.

Each step: the tokens equal the single-device step's, the logits within
1e-4 and the cache within 1e-5 of their largest magnitude
(tests/test_torch_steps.py's LOGIT_TOL and CACHE_TOL), the token and the
cache in the placements they came in, and no collective moves the cache:
none sends a cache slab, and where the cache grows with the sequence the
largest all_gather sends less than 1/100 of the rank's cache slab."""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import _torch_serve_shard_worker as W  # noqa: E402
from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402

CPU = "cpu"
RANKS = 4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5  # tests/test_torch_steps.py:28
STEPS, PROMPT = 3, 8
SHAPES = {"tiny_decode": (8, 96), "tiny_long": (1, 1024)}  # (B, S)
TOPO = dict(attention_variant="topo", topo_degree=2, topo_g="exp")
# name: (arch, the port's overrides, the reference's, shape)
CASES = {
    "llama_full": ("llama3_2_1b", {}, {}, "tiny_decode"),
    "llama_topo": ("llama3_2_1b", dict(TOPO, topo_attn_impl="torch"),
                   dict(TOPO, topo_attn_impl="pallas"), "tiny_decode"),
    "deepseek": ("deepseek_v2_lite_16b", {}, None, "tiny_decode"),
    "mamba": ("falcon_mamba_7b", {}, None, "tiny_decode"),
    "hybrid": ("recurrentgemma_2b", {}, None, "tiny_decode"),
    "encdec": ("seamless_m4t_medium", {}, None, "tiny_decode"),
    "vlm": ("llava_next_34b", {}, None, "tiny_decode"),
    "llama_long": ("llama3_2_1b", {}, {}, "tiny_long"),
    "deepseek_long": ("deepseek_v2_lite_16b", {}, None, "tiny_long"),
}
# the families whose cache grows with the sequence (the 1/100 census)
GROWING = ("llama_full", "deepseek", "encdec", "vlm", "llama_long",
           "deepseek_long")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _port_cfg(name):
    arch, over, _, shape = CASES[name]
    S = SHAPES[shape][1]
    if over.get("attention_variant") == "topo":
        over = dict(over, topo_dist_scale=1.0 / S)
    return arch, over


def _reference_cfg(name):
    arch, _, rover, shape = CASES[name]
    if rover.get("attention_variant") == "topo":
        rover = dict(rover, topo_dist_scale=1.0 / SHAPES[shape][1])
    return ref_smoke(arch, dtype="float32", **rover)


def _reference_steps(name, tree, prompt):
    """The reference's prefill and 3 make_serve_step calls (jitted): the
    first token and each step's token."""
    B, S = SHAPES[CASES[name][3]]
    rcfg = _reference_cfg(name)
    p = jax.tree.map(jnp.asarray, tree)
    cache = RA.init_cache(rcfg, B, S)
    lengths = jnp.full((B,), prompt.shape[1], jnp.int32)
    logits, cache = jax.jit(lambda p, c, t, n: RA.prefill_into_cache(
        rcfg, p, c, t, n, S))(p, cache, jnp.asarray(prompt), lengths)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    step = jax.jit(RS.make_serve_step(rcfg, S))
    for i in range(STEPS):
        tok, cache = step(p, cache, tok, prompt.shape[1] + i)
        out.append(np.asarray(tok))
    return out


@pytest.fixture(scope="module")
def served():
    """(the reference's tokens by case, the 4 ranks' results)."""
    r = np.random.default_rng(0)
    cases, trees = {}, {}
    for name, (arch, _, rover, shape) in CASES.items():
        B, S = SHAPES[shape]
        arch, over = _port_cfg(name)
        cfg = get_smoke_config(arch, dtype="float32", **over)
        if rover is not None:  # the reference's weights, carried over
            trees[name] = jax.tree.map(np.asarray, RA.init_params(
                _reference_cfg(name), jax.random.PRNGKey(3)))
            model = convert.from_reference(cfg, trees[name], device=CPU)
        else:
            model = TA.init_params(cfg, 3, device=CPU)
        cases[name] = dict(
            arch=arch, over=over, B=B, S=S, steps=STEPS,
            sd={k: v.detach().numpy() for k, v in model.state_dict().items()},
            prompt=r.integers(0, cfg.vocab_size, (B, PROMPT)).astype(
                np.int32))
    pool = ThreadPoolExecutor(1)
    ranks_done = pool.submit(TM.run_local, W.rank_main, RANKS, (cases,),
                             timeout=600)
    try:
        ref = {name: _reference_steps(name, trees[name],
                                      cases[name]["prompt"])
               for name in trees}
    finally:
        results = ranks_done.result()
        pool.shutdown()
    return ref, results


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_one_device(served, name):
    """Tokens equal, logits and cache within their bounds, every step, on
    every rank."""
    _, results = served
    for r in results:
        res = r[name]
        for i, (got, want) in enumerate(zip(res["steps"], res["single"])):
            np.testing.assert_array_equal(got["token"], want["token"])
            assert _rel(got["logits"], want["logits"]) <= LOGIT_TOL, i
            assert got["cache"].keys() == want["cache"].keys()
            for leaf, t in want["cache"].items():
                assert _rel(got["cache"][leaf], t) <= CACHE_TOL, (i, leaf)


@pytest.mark.parametrize("name", sorted(CASES))
def test_token_and_cache_keep_their_placements(served, name):
    """The cache is placed by the reference's rule (batch over data at
    B = 8, the sequence over data at B = 1) and comes back so; the token
    likewise."""
    _, results = served
    shape = CASES[name][3]
    for r in results:
        res = r[name]
        placed = res["placed"]
        for step in res["steps"]:
            assert step["cache_placements"] == placed
            assert step["token_placements"] == res["token_placed"]
        flat = "".join(str(p) for p in placed.values())
        if shape == "tiny_decode":
            assert res["token_placed"][0] == "Shard(dim=0)"
        else:
            assert res["token_placed"] == ["Replicate()", "Replicate()"]
        assert "Shard" in flat, placed


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_collective_moves_the_cache(served, name):
    """A census per step: no collective sends a cache slab (the old or
    the new one's storage, the census holding every tensor sent); where
    the cache grows with the sequence, the largest all_gather sends
    < 1/100 of the rank's slab. (A recurrent state is as large as one
    token's activations, a Mamba step's own (B, d_inner, N) update as
    large as the state: no bound by size tells them apart.)"""
    _, results = served
    for r in results:
        res = r[name]
        total = sum(nbytes for _, nbytes in res["slabs"].values())
        for step in res["steps"]:
            assert step["counts"], "the sharded step ran no collective"
            assert step["sent_cache"] == 0
            if name in GROWING:
                assert step["largest"].get("all_gather", 0) < total / 100


@pytest.mark.parametrize("name", ["llama_full", "llama_topo", "llama_long"])
def test_llama_tokens_match_reference(served, name):
    """The smoke Llama's first token (the port's prefill) and the 3
    sharded steps' tokens equal the reference's make_serve_step's."""
    ref, results = served
    for r in results:
        res = r[name]
        np.testing.assert_array_equal(res["first"], ref[name][0])
        for got, want in zip(res["steps"], ref[name][1:]):
            np.testing.assert_array_equal(got["token"], want)


def test_worker_module_is_jax_free():
    """The ranks import the port only (spawned processes import the worker
    by name)."""
    src = open(os.path.join(os.path.dirname(__file__),
                            "_torch_serve_shard_worker.py")).read()
    assert "jax" not in src.replace("imports neither jax", "")
    assert "from repro " not in src and "import repro." not in src
