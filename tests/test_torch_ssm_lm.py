"""Port of the ssm family (Falcon-Mamba-7B, Mamba-1 blocks): the smoke
`falcon_mamba_7b` in float32, the reference's `lm.init_params` carried
across by `convert.from_reference`, held against the reference's
`api.prefill_into_cache` / `decode_fn`: prefill logits over mixed prompt
lengths, a row of length 0 that keeps its cache, 4 greedy decode steps at
per-slot positions, and the cache (conv ring and state h), on every
`attn_impl` (naive: the sequential oracle; chunked: the plain chunked
scan; cuda: the kernel path, whose wrapper runs the plain scan on the
CPU). Also the cacheless prefill, decode against the prefill of the
extended prompt, the weight round trip in float32 and bfloat16, seeded
init, the full-width config and its parameter count, and the refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

ARCH = "falcon_mamba_7b"
S, B, LP = 40, 3, 24  # cache length, batch, padded prompt length
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5  # tests/test_torch_dense_lm.py


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _cache_err(tcache, rcache):
    return max(_rel(tcache["blocks0"][k], rcache["blocks0"][k])
               for k in ("conv", "h"))


@pytest.fixture(scope="module")
def served():
    """The reference's weights, prompts and serving trace: a first prefill
    of mixed lengths (one empty row), a second prefill that refills rows 0
    and 2 and leaves row 1's cache alone, then 4 greedy decode steps at
    per-slot positions."""
    rcfg = ref_smoke(ARCH, dtype="float32")
    params = RA.init_params(rcfg, jax.random.PRNGKey(21))
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, rcfg.vocab_size, (B, LP)).astype(np.int32)
               for _ in range(2)]
    lengths = [np.array([24, 0, 9], np.int32), np.array([13, 0, 24],
                                                        np.int32)]
    trace = {"prefill": []}
    cache = RA.init_cache(rcfg, B, S)
    for toks, lens in zip(prompts, lengths):
        logits, cache = RA.prefill_into_cache(rcfg, params, cache,
                                              jnp.asarray(toks),
                                              jnp.asarray(lens), S)
        trace["prefill"].append((np.asarray(logits),
                                 jax.tree.map(np.asarray, cache)))
    pos = lengths[1].copy()
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    steps = []
    for _ in range(4):
        logits, cache = RA.decode_fn(rcfg, params, cache, jnp.asarray(tok),
                                     jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    trace["decode"] = steps
    trace["final_cache"] = jax.tree.map(np.asarray, cache)
    return jax.tree.map(np.asarray, params), prompts, lengths, trace


def _cfg(impl="naive", **kw):
    return get_smoke_config(ARCH, attn_impl=impl, dtype="float32", **kw)


@pytest.mark.parametrize("impl", ["naive", "chunked", "cuda"])
def test_serving_matches_reference(served, impl):
    tree, prompts, lengths, trace = served
    cfg = _cfg(impl)
    model = convert.from_reference(cfg, tree, device="cpu")
    cache = TA.init_cache(cfg, B, S, device="cpu")
    launches = scan_ops.LAUNCHES
    for (toks, lens), (want, want_cache) in zip(zip(prompts, lengths),
                                                trace["prefill"]):
        before = {k: t[:, 1].clone() for k, t in cache["blocks0"].items()}
        logits, cache = TA.prefill_into_cache(cfg, model, cache, toks, lens,
                                              S, device="cpu")
        assert logits.shape == (B, cfg.padded_vocab())
        keep = lens > 0  # row 1 is empty: its logits are not compared
        assert _rel(logits.numpy()[keep], want[keep]) <= LOGIT_TOL
        assert _cache_err(cache, want_cache) <= CACHE_TOL
        for k, t in cache["blocks0"].items():  # the empty row kept its state
            assert torch.equal(t[:, 1], before[k])
    for tok, pos, want in trace["decode"]:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert logits.shape == (B, 1, cfg.padded_vocab())
        assert _rel(logits, want) <= LOGIT_TOL
    assert _cache_err(cache, trace["final_cache"]) <= CACHE_TOL
    assert scan_ops.LAUNCHES == launches  # CPU tensors never reach a kernel


@pytest.mark.parametrize("impl", ["naive", "chunked", "cuda"])
def test_cacheless_prefill_matches_reference(served, impl):
    tree, prompts, _, _ = served
    rcfg = ref_smoke(ARCH, dtype="float32")
    params = jax.tree.map(jnp.asarray, tree)
    want = RA.prefill_fn(rcfg, params, {"tokens": jnp.asarray(prompts[0])})
    cfg = _cfg(impl)
    model = convert.from_reference(cfg, tree, device="cpu")
    got = TA.prefill_fn(cfg, model, {"tokens": prompts[0]}, device="cpu")
    assert got.shape == (B, 1, cfg.padded_vocab())
    assert _rel(got, want) <= LOGIT_TOL
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(prompts[0]).long()), got)


def test_decode_matches_prefill_of_the_extended_prompt(served):
    """Per-slot decode after a prefill gives the logits that a prefill of
    the prompt extended by the decoded tokens gives."""
    tree, prompts, _, _ = served
    cfg = _cfg("chunked")
    model = convert.from_reference(cfg, tree, device="cpu")
    lens = np.array([20, 7, 15], np.int32)
    logits, cache = TA.prefill_into_cache(
        cfg, model, TA.init_cache(cfg, B, S, device="cpu"), prompts[0], lens,
        S, device="cpu")
    ext = prompts[0].copy()
    rows = np.arange(B)
    for t in range(3):
        tok = logits.argmax(-1).numpy().astype(np.int32)
        ext[rows, lens + t] = tok
        step, cache = TA.decode_fn(cfg, model, cache, tok[:, None], lens + t,
                                   S, device="cpu")
        want, want_cache = TA.prefill_into_cache(
            cfg, model, TA.init_cache(cfg, B, S, device="cpu"), ext,
            lens + t + 1, S, device="cpu")
        assert _rel(step[:, 0], want) <= LOGIT_TOL
        assert _cache_err(cache, want_cache) <= CACHE_TOL
        logits = step[:, 0]


def test_weights_round_trip_bitwise(served):
    tree, _, _, _ = served
    cfg = _cfg()
    model = convert.from_reference(cfg, tree, device="cpu")
    back = convert.to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    names = set(model.state_dict())
    assert {"blocks.1.norm.scale", "blocks.1.ssm.A_log",
            "blocks.0.ssm.x_proj"} <= names
    assert not any(".attn." in n or ".mlp." in n for n in names)
    assert TA.param_count(model) == sum(a.size for a in
                                        jax.tree.leaves(tree))


def test_bfloat16_weights_round_trip_bitwise():
    rcfg = ref_smoke(ARCH)
    tree = jax.tree.map(np.asarray, RA.init_params(rcfg,
                                                   jax.random.PRNGKey(6)))
    cfg = get_smoke_config(ARCH)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert model.blocks[0].ssm.A_log.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(convert.to_reference(model))):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16),
                                                     b.view(np.uint16))


def test_init_params_and_cache_are_shaped_like_the_reference():
    cfg = _cfg()
    m1, m2 = (TA.init_params(cfg, 7, device="cpu") for _ in range(2))
    for (n1, t1), (n2, t2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2)
    rcfg = ref_smoke(ARCH, dtype="float32")
    ref_tree = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    back = convert.to_reference(m1)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(back)):
        assert tuple(a.shape) == b.shape
    # the init recipe's deterministic leaves are the reference's
    ref = jax.tree.map(np.asarray, RA.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    for name in ("A_log", "D", "conv_b"):
        assert np.array_equal(back["blocks0"]["ssm"][name],
                              ref["blocks0"]["ssm"][name])
    dt = np.log1p(np.exp(back["blocks0"]["ssm"]["dt_bias"]))  # softplus
    assert dt.min() >= 1e-3 - 1e-6 and dt.max() <= 0.1 + 1e-6
    rcache = jax.eval_shape(lambda: RA.init_cache(rcfg, B, S))
    tcache = TA.init_cache(cfg, B, S, device="cpu")
    assert set(tcache["blocks0"]) == set(rcache["blocks0"]) == {"conv", "h"}
    for k, t in tcache["blocks0"].items():
        assert tuple(t.shape) == rcache["blocks0"][k].shape
        assert str(t.dtype).split(".")[1] == str(rcache["blocks0"][k].dtype)
    bf = get_smoke_config(ARCH)  # bfloat16: conv in the model dtype, h f32
    c = TA.init_cache(bf, B, S, device="cpu")["blocks0"]
    assert c["conv"].dtype == torch.bfloat16 and c["h"].dtype == torch.float32


def test_full_width_config_is_the_reference_one():
    from repro.configs.base import get_config as ref_config
    from repro.configs.base import get_smoke_config as ref_smoke_config

    for port, ref in ((get_config("falcon-mamba-7b"),
                       ref_config("falcon-mamba-7b")),
                      (get_smoke_config(ARCH), ref_smoke_config(ARCH))):
        for field in ("name", "family", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "ssm_state", "ssm_conv", "ssm_expand", "dt_rank",
                      "tie_embeddings", "attn_impl", "dtype", "norm_eps",
                      "scan_layers"):
            assert getattr(port, field) == getattr(ref, field), field
        assert port.d_inner == ref.d_inner
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state) == (
        64, 4096, 8192, 16)
    # parameters without allocating them: tests/test_models.py's 7.3e9
    # within its 15%
    n = TA.param_count(TLM.DecoderLM(cfg, device="meta"))
    assert abs(n - 7.3e9) / 7.3e9 < 0.15
    ref_blocks = sum(np.prod(a.shape) for a in jax.tree.leaves(
        jax.eval_shape(lambda: RA.init_params(ref_smoke(ARCH),
                                              jax.random.PRNGKey(0)))))
    assert TA.param_count(TLM.DecoderLM(get_smoke_config(ARCH),
                                        device="meta")) == ref_blocks


def _grads(cfg, model, toks):
    model.zero_grad(set_to_none=True)
    TLM.forward_prefill(cfg, model, {"tokens": toks}).square().sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_kernel_path_refuses_grad_in_the_model():
    """With grad on, attn_impl "cuda" no longer refuses: it goes through
    the scan wrapper's autograd.Function, whose backward is the plain
    chunked scan's VJP, so every parameter gets the grad "chunked" gives
    it; the serving entry points still run without grad."""
    cfg = _cfg("cuda")
    model = TA.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 12)))
    got = _grads(cfg, model, toks)
    want = _grads(cfg.replace(attn_impl="chunked"), model, toks)
    for name, g in want.items():
        assert float(g.abs().max()) > 0, name
        assert float((got[name] - g).abs().max()) <= 1e-6 * float(
            g.abs().max()), name
    TA.prefill_fn(cfg, model, {"tokens": toks}, device="cpu")


def test_an_unknown_scan_impl_raises():
    cfg = _cfg()
    model = TA.init_params(cfg, 0, device="cpu")
    for bad in ("pallas", "torch"):
        with pytest.raises(ValueError, match="attn_impl"):
            TA.prefill_fn(cfg.replace(attn_impl=bad), model,
                          {"tokens": np.zeros((1, 4), np.int32)},
                          device="cpu")
    with pytest.raises(ValueError, match="family"):
        TA.init_params(cfg.replace(family="mixture"), 0, device="cpu")
