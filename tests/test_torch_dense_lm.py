"""Port of the dense Llama-3.2-1B with full (rope + softmax) and Performer
attention: the smoke `llama3_2_1b` in float32, the reference's
`lm.init_params` carried across by `convert.from_reference`, held against
the reference's `api.prefill_into_cache` / `decode_fn`: prefill logits over
mixed prompt lengths, a row of length 0 that keeps its cache, 6 greedy
decode steps at per-slot positions, and the caches (K/V for full, S/z for
the Performer), on every `attn_impl` (naive: the dense oracle; chunked: the
plain twins; cuda: the kernel path, whose wrappers run the plain versions
on the CPU). Also the cacheless prefill, decode against the prefill of the
extended prompt, the weight round trip in float32 and bfloat16, seeded
init, and the package's independence from jax, triton and `repro` (the
smoke Falcon-Mamba of the ssm family included)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    ops as linear_ops)
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
S, B, LP = 40, 3, 24  # cache length, batch, padded prompt length
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
CACHE_KEYS = {"full": ("k", "v"), "performer": ("S", "z")}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _cache_err(tcache, rcache, variant):
    return max(_rel(tcache["blocks0"][k], rcache["blocks0"][k])
               for k in CACHE_KEYS[variant])


@pytest.fixture(scope="module", params=["full", "performer"])
def served(request):
    """The reference's weights, prompts and serving trace for one variant:
    a first prefill of mixed lengths (one empty row), a second prefill that
    refills rows 0 and 2 and leaves row 1's cache alone, then 6 greedy
    decode steps at per-slot positions."""
    variant = request.param
    rcfg = ref_smoke("llama3_2_1b", attention_variant=variant,
                     dtype="float32")
    seed = 11 if variant == "full" else 12
    params = RA.init_params(rcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
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
    for _ in range(6):
        logits, cache = RA.decode_fn(rcfg, params, cache, jnp.asarray(tok),
                                     jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    trace["decode"] = steps
    trace["final_cache"] = jax.tree.map(np.asarray, cache)
    return variant, jax.tree.map(np.asarray, params), prompts, lengths, trace


def _cfg(variant, impl="naive", **kw):
    return get_smoke_config("llama3_2_1b", attention_variant=variant,
                            attn_impl=impl, dtype="float32", **kw)


@pytest.mark.parametrize("impl", ["naive", "chunked", "cuda"])
def test_serving_matches_reference(served, impl):
    variant, tree, prompts, lengths, trace = served
    cfg = _cfg(variant, impl)
    model = convert.from_reference(cfg, tree, device="cpu")
    cache = TA.init_cache(cfg, B, S, device="cpu")
    launches = flash_ops.LAUNCHES, linear_ops.LAUNCHES
    for (toks, lens), (want, want_cache) in zip(zip(prompts, lengths),
                                                trace["prefill"]):
        before = {k: t[:, 1].clone() for k, t in cache["blocks0"].items()}
        logits, cache = TA.prefill_into_cache(cfg, model, cache, toks, lens,
                                              S, device="cpu")
        assert logits.shape == (B, cfg.padded_vocab())
        keep = lens > 0  # row 1 is empty: its logits are not compared
        assert _rel(logits.numpy()[keep], want[keep]) <= LOGIT_TOL
        assert _cache_err(cache, want_cache, variant) <= CACHE_TOL
        for k, t in cache["blocks0"].items():  # the empty row kept its state
            assert torch.equal(t[:, 1], before[k])
    for tok, pos, want in trace["decode"]:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert logits.shape == (B, 1, cfg.padded_vocab())
        assert _rel(logits, want) <= LOGIT_TOL
    assert _cache_err(cache, trace["final_cache"], variant) <= CACHE_TOL
    # CPU tensors never reach a kernel
    assert (flash_ops.LAUNCHES, linear_ops.LAUNCHES) == launches


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_cacheless_prefill_matches_reference(served, impl):
    variant, tree, prompts, _, _ = served
    rcfg = ref_smoke("llama3_2_1b", attention_variant=variant,
                     dtype="float32")
    params = jax.tree.map(jnp.asarray, tree)
    want = RA.prefill_fn(rcfg, params, {"tokens": jnp.asarray(prompts[0])})
    cfg = _cfg(variant, impl)
    model = convert.from_reference(cfg, tree, device="cpu")
    got = TA.prefill_fn(cfg, model, {"tokens": prompts[0]}, device="cpu")
    assert got.shape == (B, 1, cfg.padded_vocab())
    assert _rel(got, want) <= LOGIT_TOL
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(prompts[0]).long()), got)


def test_decode_matches_prefill_of_the_extended_prompt(served):
    """Per-slot decode after a prefill gives the logits that a prefill of
    the prompt extended by the decoded tokens gives."""
    variant, tree, prompts, _, _ = served
    cfg = _cfg(variant, "chunked")
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
        want, _ = TA.prefill_into_cache(
            cfg, model, TA.init_cache(cfg, B, S, device="cpu"), ext,
            lens + t + 1, S, device="cpu")
        assert _rel(step[:, 0], want) <= LOGIT_TOL
        logits = step[:, 0]


def test_weights_round_trip_bitwise(served):
    variant, tree, _, _, _ = served
    cfg = _cfg(variant)
    model = convert.from_reference(cfg, tree, device="cpu")
    back = convert.to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    names = set(model.state_dict())
    assert "blocks.1.attn.wq" in names
    assert not any(".topo." in n for n in names)  # topo variant only
    assert TA.param_count(model) == sum(a.size for a in
                                        jax.tree.leaves(tree))


@pytest.mark.parametrize("variant", ["full", "performer"])
def test_bfloat16_weights_round_trip_bitwise(variant):
    rcfg = ref_smoke("llama3_2_1b", attention_variant=variant)
    tree = jax.tree.map(np.asarray, RA.init_params(rcfg,
                                                   jax.random.PRNGKey(6)))
    cfg = get_smoke_config("llama3_2_1b", attention_variant=variant)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(convert.to_reference(model))):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16),
                                                     b.view(np.uint16))


@pytest.mark.parametrize("variant", ["full", "performer"])
def test_init_params_and_cache_are_shaped_like_the_reference(variant):
    cfg = _cfg(variant)
    m1, m2 = (TA.init_params(cfg, 7, device="cpu") for _ in range(2))
    for (n1, t1), (n2, t2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2)
    rcfg = ref_smoke("llama3_2_1b", attention_variant=variant,
                     dtype="float32")
    ref_tree = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    back = convert.to_reference(m1)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(back)):
        assert tuple(a.shape) == b.shape
    rcache = jax.eval_shape(lambda: RA.init_cache(rcfg, B, S))
    tcache = TA.init_cache(cfg, B, S, device="cpu")
    assert set(tcache["blocks0"]) == set(rcache["blocks0"])
    for k, t in tcache["blocks0"].items():
        assert tuple(t.shape) == rcache["blocks0"][k].shape
        assert str(t.dtype).split(".")[1] == str(rcache["blocks0"][k].dtype)


def test_full_width_config_is_the_reference_one():
    from repro.configs.base import get_config as ref_config

    cfg = get_config("llama3.2-1b")
    want = ref_config("llama3.2-1b")
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "tie_embeddings",
                  "rope_theta", "attention_variant", "attn_impl",
                  "performer_phi", "attn_logit_softcap", "dtype",
                  "norm_eps", "qkv_bias"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.attention_variant == "full" and cfg.rope_theta == 500000.0


def _grads(cfg, model, toks):
    model.zero_grad(set_to_none=True)
    TLM.forward_prefill(cfg, model, {"tokens": toks}).square().sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("variant", ["full", "performer"])
def test_kernel_path_refuses_grad_in_the_model(variant):
    """With grad on, attn_impl "cuda" no longer refuses: it goes through
    the kernel wrapper's autograd.Function (flash attention, linear
    attention), whose backward is the plain version's VJP, so every
    parameter gets the grad "chunked" gives it; the serving entry points
    still run without grad."""
    cfg = _cfg(variant, "cuda")
    model = TA.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 12)))
    got = _grads(cfg, model, toks)
    want = _grads(cfg.replace(attn_impl="chunked"), model, toks)
    for name, g in want.items():
        assert float(g.abs().max()) > 0, name
        assert float((got[name] - g).abs().max()) <= 1e-6 * float(
            g.abs().max()), name
    TA.prefill_fn(cfg, model, {"tokens": toks}, device="cpu")


def test_what_is_not_ported_raises_naming_the_roadmap():
    """The hybrid, encdec and vlm families are ported (ROADMAP A10b): what
    the reference does not define raises ValueError, a family or an
    attention variant ("local" is a block kind of the hybrid family, not
    a variant), and so does an unknown attn_impl."""
    cfg = _cfg("full")
    for bad in (dict(family="mixture"), dict(attention_variant="local")):
        with pytest.raises(ValueError, match="expected one of"):
            TA.init_params(cfg.replace(**bad), 0, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        TA.prefill_fn(cfg.replace(attn_impl="pallas"),
                      TA.init_params(cfg, 0, device="cpu"),
                      {"tokens": np.zeros((1, 4), np.int32)}, device="cpu")


_NO_JAX = r"""
import sys
for name in ("jax", "repro", "triton"):
    sys.modules[name] = None
import numpy as np
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import api, convert
for variant, impl in (("full", "cuda"), ("full", "chunked"),
                      ("performer", "cuda")):
    cfg = get_smoke_config("llama3_2_1b", attention_variant=variant,
                           attn_impl=impl, dtype="float32")
    model = api.init_params(cfg, 0, device="cpu")
    cache = api.init_cache(cfg, 2, 20, device="cpu")
    logits, cache = api.prefill_into_cache(
        cfg, model, cache, np.ones((2, 8), np.int32), np.array([8, 5]), 20,
        device="cpu")
    logits, cache = api.decode_fn(cfg, model, cache,
                                  np.ones((2, 1), np.int32),
                                  np.array([8, 5]), 20, device="cpu")
    assert bool(logits.isfinite().all()) and logits.shape == (2, 1, 512)
    convert.from_reference(cfg, convert.to_reference(model), device="cpu")
for arch, impl in (("falcon_mamba_7b", "cuda"),
                   ("falcon_mamba_7b", "chunked"),
                   ("deepseek_v2_lite_16b", "chunked"),
                   ("deepseek_v3_671b", "naive")):
    cfg = get_smoke_config(arch, attn_impl=impl, dtype="float32")
    model = api.init_params(cfg, 0, device="cpu")
    cache = api.init_cache(cfg, 2, 20, device="cpu")
    logits, cache = api.prefill_into_cache(
        cfg, model, cache, np.ones((2, 8), np.int32), np.array([8, 5]), 20,
        device="cpu")
    logits, cache = api.decode_fn(cfg, model, cache,
                                  np.ones((2, 1), np.int32),
                                  np.array([8, 5]), 20, device="cpu")
    assert bool(logits.isfinite().all()) and logits.shape == (2, 1, 512)
    convert.from_reference(cfg, convert.to_reference(model), device="cpu")
    if cfg.family == "moe":
        loss, _ = api.loss_fn(cfg, model, {"tokens": np.ones((2, 8), np.int32)},
                              device="cpu")
        loss.backward()
import repro_torch.kernels.flash_attention.kernel
import repro_torch.kernels.linear_attention.kernel
import repro_torch.kernels.selective_scan.kernel
assert not any(k.split(".")[0] in ("jax", "repro", "triton")
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_models_serve_without_jax_triton_or_reference():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "ok"
