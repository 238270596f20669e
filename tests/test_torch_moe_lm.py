"""Port of the DeepSeek family (ROADMAP A10a) against the reference, on the
CPU in float32 with numpy-seeded inputs and the reference's weights carried
by `convert.from_reference`:

  * the MoE dispatch (`moe._dispatch_combine`, `moe.moe_block`): outputs
    and aux within 1e-6 of their largest value, the routing (expert ids,
    positions in each expert, the kept mask) equal, with capacity drops,
    two dispatch groups, and the shared experts on and off;
  * MLA training attention on "naive", "chunked" and "cuda" (the flash
    wrapper's plain version on CPU tensors, at the smoke (24, 16) and the
    published (192, 128) head dims) against the reference's naive and
    chunked, with and without q-LoRA;
  * the smoke DeepSeek-V2-Lite and DeepSeek-V3 (MTP) whole: `loss_fn`'s
    loss (aux and MTP included) and every grad against `jax.grad`, then
    prefill into the cache and 4 absorbed decode steps against the
    reference's `prefill_into_cache` / `decode_fn`;
  * the weights' round trip through `convert`, both segments and the MTP
    head, in float32 and bfloat16, bit for bit.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import attention as TAT  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

MOE_TOL = 1e-6
ATTN_TOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, L = 2, 24  # the training batch
S, LP = 40, 24  # cache length, padded prompt length
ARCHS = ("deepseek_v2_lite_16b", "deepseek_v3_671b")


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than a pool beside the other test processes of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def _ns(tree: dict):
    """A reference param dict as the attribute bag the port's functions
    read (`p.router`, ...)."""
    return types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                    for k, v in tree.items()})


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """The reference's function under jax.jit, compiled once per process
    and static signature: eager, its smoke models take seconds a call."""
    return jax.jit(fn, static_argnums=static)


# --- the MoE dispatch --------------------------------------------------------

def _ref_routing(rcfg, p, xt):
    """The reference's routing as `_dispatch_combine` computes it: top-k
    expert ids, each assignment's position in its expert, the kept mask."""
    T = xt.shape[0]
    E, K = rcfg.num_experts, rcfg.top_k
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, K)
    C = max(8, min(int(rcfg.capacity_factor * K * T / E), T))
    flat = expert_ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    sorted_e = flat[order]
    seg = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_sorted = jnp.arange(T * K) - seg[sorted_e]
    pos = jnp.zeros_like(pos_sorted).at[order].set(pos_sorted)
    return (np.asarray(expert_ids), np.asarray(pos).reshape(T, K),
            np.asarray(pos < C).reshape(T, K), C)


MOE_CASES = {
    "smoke": dict(),
    "capacity_drops": dict(capacity_factor=0.25),
    "two_groups": dict(moe_groups=2, capacity_factor=0.5),
    "no_shared": dict(num_shared_experts=0, top_k=3),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dispatch_matches_reference(case):
    over = MOE_CASES[case]
    rcfg = ref_smoke("deepseek_v2_lite_16b", dtype="float32", **over)
    cfg = get_smoke_config("deepseek_v2_lite_16b", dtype="float32", **over)
    p = jax.tree.map(np.asarray, _jit(JM.moe_init, 1)(jax.random.PRNGKey(3),
                                                      rcfg))
    x = np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    want, want_aux = _jit(JM.moe_block, 0)(rcfg, p, jnp.asarray(x))
    TM.TRACE = []
    try:
        got, aux = TM.moe_block(cfg, _ns(p), torch.from_numpy(x))
        trace = TM.TRACE
    finally:
        TM.TRACE = None
    assert _rel(got, want) <= MOE_TOL
    assert abs(float(aux) - float(want_aux)) <= MOE_TOL * abs(
        float(want_aux))
    G = cfg.moe_groups
    xt = x.reshape(G, -1, cfg.d_model)
    assert len(trace) == G
    dropped = 0
    for g, rec in enumerate(trace):
        ids, pos, keep, C = _ref_routing(rcfg, p, jnp.asarray(xt[g]))
        assert rec["C"] == C
        assert np.array_equal(rec["expert_ids"].numpy(), ids)
        assert np.array_equal(rec["pos"].numpy(), pos)
        assert np.array_equal(rec["keep"].numpy(), keep)
        dropped += int((~keep).sum())
        # the single-group function too, output and aux
        out1, aux1 = TM._dispatch_combine(cfg, _ns(p), torch.from_numpy(
            xt[g]))
        w1, wa1 = _jit(JM._dispatch_combine, 0)(rcfg, p, jnp.asarray(xt[g]))
        assert _rel(out1, w1) <= MOE_TOL
        assert abs(float(aux1) - float(wa1)) <= MOE_TOL * abs(float(wa1))
    if case in ("capacity_drops", "two_groups"):
        assert dropped > 0


def test_moe_top_k_orders_ties_as_the_reference():
    """Equal router probabilities (a zero token: every logit 0) order by
    expert index in both packages, so the routing of such a token is equal
    too."""
    rcfg = ref_smoke("deepseek_v2_lite_16b", dtype="float32")
    cfg = get_smoke_config("deepseek_v2_lite_16b", dtype="float32")
    p = jax.tree.map(np.asarray, _jit(JM.moe_init, 1)(jax.random.PRNGKey(4),
                                                      rcfg))
    x = np.random.default_rng(4).normal(size=(16, cfg.d_model)).astype(
        np.float32)
    x[3] = 0.0
    x[9] = x[2]
    TM.TRACE = []
    try:
        got, _ = TM._dispatch_combine(cfg, _ns(p), torch.from_numpy(x))
        rec, = TM.TRACE
    finally:
        TM.TRACE = None
    ids, pos, keep, _ = _ref_routing(rcfg, p, jnp.asarray(x))
    assert list(rec["expert_ids"][3].numpy()) == list(range(cfg.top_k))
    assert np.array_equal(rec["expert_ids"].numpy(), ids)
    assert np.array_equal(rec["pos"].numpy(), pos)
    want, _ = _jit(JM._dispatch_combine, 0)(rcfg, p, jnp.asarray(x))
    assert _rel(got, want) <= MOE_TOL


# --- MLA -----------------------------------------------------------------------

MLA_DIMS = {"smoke": {},
            # the published head dims, at a smoke width: the kernel's
            # instantiated (192, 128) pair
            "wide": dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                         num_heads=2, num_kv_heads=2)}


@pytest.mark.parametrize("dims", list(MLA_DIMS))
@pytest.mark.parametrize("arch", ARCHS, ids=["no_q_lora", "q_lora"])
def test_mla_train_matches_reference(arch, dims):
    over = MLA_DIMS[dims]
    rcfg = ref_smoke(arch, dtype="float32", **over)
    p = jax.tree.map(np.asarray, _jit(JA.mla_init, 1)(jax.random.PRNGKey(5),
                                                      rcfg))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, rcfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    want = {}
    for impl in ("naive", "chunked"):
        for causal in (True, False):
            want[impl, causal] = np.asarray(_jit(
                JA.mla_attention_train, 0, 4)(
                rcfg.replace(attn_impl=impl), p, jnp.asarray(x),
                jnp.asarray(positions), causal))
    for impl in ("naive", "chunked", "cuda"):
        cfg = get_smoke_config(arch, dtype="float32", attn_impl=impl, **over)
        for causal in (True, False):
            got = TAT.mla_attention_train(cfg, _ns(p), torch.from_numpy(x),
                                          torch.from_numpy(positions.copy()),
                                          causal=causal)
            assert got.shape == (2, 20, cfg.d_model)
            for ref_impl in ("naive", "chunked"):
                assert _rel(got, want[ref_impl, causal]) <= ATTN_TOL, (
                    impl, ref_impl, causal)
    if dims == "smoke":
        # the kernel path takes only the instantiated (hd, vd) pairs, on
        # CPU tensors as on the card: (32, 16) is not one
        cfg = get_smoke_config(arch, dtype="float32", attn_impl="cuda",
                               qk_rope_dim=16)
        p16 = jax.tree.map(np.asarray, _jit(JA.mla_init, 1)(
            jax.random.PRNGKey(5), rcfg.replace(qk_rope_dim=16)))
        with pytest.raises(ValueError, match="head_dim"):
            TAT.mla_attention_train(cfg, _ns(p16), torch.from_numpy(x),
                                    torch.from_numpy(positions.copy()))


# --- the whole smoke models -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's init, a batch, jax.value_and_grad(api.loss_fn), and
    a serving trace (prefill of mixed lengths, one row empty, then 4 greedy
    decode steps), as numpy: computed once per arch."""
    rcfg = ref_smoke(arch, dtype="float32", attn_impl="chunked")
    params = _jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(9))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, rcfg.vocab_size, (B, L)).astype(np.int32)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    prompts = rng.integers(0, rcfg.vocab_size, (3, LP)).astype(np.int32)
    lengths = np.array([24, 0, 9], np.int32)
    cache = RA.init_cache(rcfg, 3, S)
    logits, cache = _jit(RA.prefill_into_cache, 0, 5)(
        rcfg, params, cache,
                                          jnp.asarray(prompts),
                                          jnp.asarray(lengths), S)
    trace = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)),
             "decode": []}
    pos = lengths.copy()
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    for _ in range(4):
        logits, cache = _jit(RA.decode_fn, 0, 5)(
            rcfg, params, cache, jnp.asarray(tok), jnp.asarray(pos), S)
        trace["decode"].append((tok, pos.copy(), np.asarray(logits)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    trace["final_cache"] = jax.tree.map(np.asarray, cache)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (as_np(params), toks, float(loss), float(metrics["aux"]),
            as_np(grads), prompts, lengths, trace)


def _group(name: str) -> str:
    """Grads are held against the largest value of their reference leaf:
    a block parameter stacked over its segment's layers (here the dense
    layer and the MoE layers share a name's group), or a top-level one."""
    parts = name.split(".")
    return ".".join(["blocks"] + parts[2:]) if parts[0] == "blocks" else name


def _grad_errors(cfg, got: dict, want_tree: dict) -> dict:
    want = {k: t.numpy() for k, t in convert._state_dict(
        want_tree, "cpu", convert._stacks(cfg)).items()}
    assert set(want) == set(got)
    top = {}
    for name, g in want.items():
        top[_group(name)] = max(top.get(_group(name), 0.0),
                                float(np.abs(g).max()))
    return {name: float(np.abs(got[name].numpy().astype(np.float64)
                               - want[name]).max()) / max(
        top[_group(name)], 1e-30) for name in want}


def _cache_err(tcache, rcache):
    assert set(tcache) == set(rcache)
    return max(_rel(tcache[seg][k], rcache[seg][k])
               for seg in rcache for k in rcache[seg])


@pytest.mark.parametrize("impl", ["naive", "chunked", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, impl):
    params, toks, want_loss, want_aux, want_grads, *_ = _reference(arch)
    cfg = get_smoke_config(arch, dtype="float32", attn_impl=impl)
    model = convert.from_reference(cfg, params, device="cpu")
    loss, metrics = TA.loss_fn(cfg, model, {"tokens": toks}, device="cpu")
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert abs(float(metrics["aux"].detach()) - want_aux) <= (
        LOSS_TOL * want_aux)
    assert want_aux > 0
    errs = _grad_errors(cfg, {n: p.grad for n, p in model.named_parameters()},
                        want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    if cfg.mtp_depth:
        assert float(model.mtp_proj.kernel.grad.abs().max()) > 0


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(arch, impl):
    params, *_, prompts, lengths, trace = _reference(arch)
    cfg = get_smoke_config(arch, dtype="float32", attn_impl=impl)
    model = convert.from_reference(cfg, params, device="cpu")
    cache = TA.init_cache(cfg, 3, S, device="cpu")
    assert set(cache) == {"blocks0", "blocks1"}
    for seg, leaves in trace["prefill"][1].items():
        for k, a in leaves.items():
            assert tuple(cache[seg][k].shape) == a.shape
    before = {seg: {k: t[:, 1].clone() for k, t in c.items()}
              for seg, c in cache.items()}
    launches = flash_ops.LAUNCHES
    logits, cache = TA.prefill_into_cache(cfg, model, cache, prompts,
                                          lengths, S, device="cpu")
    want, want_cache = trace["prefill"]
    keep = lengths > 0
    assert _rel(logits.numpy()[keep], want[keep]) <= LOGIT_TOL
    assert _cache_err(cache, want_cache) <= CACHE_TOL
    for seg, c in cache.items():  # the empty row kept its state
        for k, t in c.items():
            assert torch.equal(t[:, 1], before[seg][k])
    for tok, pos, want in trace["decode"]:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert _rel(logits, want) <= LOGIT_TOL
    assert _cache_err(cache, trace["final_cache"]) <= CACHE_TOL
    assert flash_ops.LAUNCHES == launches  # CPU tensors reach no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_bitwise(arch, dtype):
    """A tree of the reference's structure, shapes and dtypes (its
    `init_params` under `jax.eval_shape`; the router float32 in a bf16
    model) filled with seeded normals, to the port and back."""
    rcfg = ref_smoke(arch, dtype=dtype)
    shapes = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                   jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32).astype(a.dtype), shapes)
    cfg = get_smoke_config(arch, dtype=dtype)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert model.blocks[1].moe.router.dtype == torch.float32
    assert isinstance(model.blocks[0], TLM.DecoderBlock)
    assert isinstance(model.blocks[-1], TLM.MoEBlock)
    back = convert.to_reference(model)
    flat_want = dict(convert._flatten(tree))
    flat_got = dict(convert._flatten(back))
    assert set(flat_got) == set(flat_want)
    assert ("mtp_block.attn.w_uq" in flat_got) == (arch == ARCHS[1])
    for name, want in flat_want.items():
        got = flat_got[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
