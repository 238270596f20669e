"""Port of the topo-LM serving path: the smoke `llama3_2_1b` with
attention_variant="topo" at degree 1 (decay mode) and degree 2 (rank mode),
the reference's `lm.init_params` carried across by `convert.from_reference`,
held against the reference's `api.prefill_into_cache` / `decode_fn` (impl
"pallas"): prefill logits over mixed prompt lengths, a row of length 0
that keeps its cache, 6 greedy decode steps at per-slot positions, and the
caches. Also the weight round trip, the package's independence from jax
and `repro`, and the entry points' refusals."""
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
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
S, B, LP = 40, 3, 24  # cache length, batch, padded prompt length
OVER = dict(attention_variant="topo", dtype="float32", topo_g="exp",
            topo_dist_scale=1.0 / S)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _cache_err(tcache, rcache):
    return max(_rel(tcache["blocks0"][k], rcache["blocks0"][k])
               for k in ("S", "z"))


@pytest.fixture(scope="module", params=[1, 2], ids=["degree1", "degree2"])
def served(request):
    """The reference's weights, prompts and serving trace at one degree:
    a first prefill of mixed lengths (one empty row), a second prefill that
    refills rows 0 and 2 and leaves row 1's cache alone, then 6 greedy
    decode steps at per-slot positions."""
    degree = request.param
    rcfg = ref_smoke("llama3_2_1b", topo_attn_impl="pallas",
                     topo_degree=degree, **OVER)
    params = RA.init_params(rcfg, jax.random.PRNGKey(degree))
    rng = np.random.default_rng(degree)
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
    return degree, jax.tree.map(np.asarray, params), prompts, lengths, trace


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_serving_matches_reference(served, impl):
    degree, tree, prompts, lengths, trace = served
    cfg = get_smoke_config("llama3_2_1b", topo_attn_impl=impl,
                           topo_degree=degree, **OVER)
    model = convert.from_reference(cfg, tree, device="cpu")
    cache = TA.init_cache(cfg, B, S, device="cpu")
    for (toks, lens), (want, want_cache) in zip(zip(prompts, lengths),
                                                trace["prefill"]):
        before = {k: t[:, 1].clone() for k, t in cache["blocks0"].items()}
        logits, cache = TA.prefill_into_cache(cfg, model, cache, toks, lens,
                                              S, device="cpu")
        assert logits.shape == (B, cfg.padded_vocab())
        keep = lens > 0  # row 1 is empty: its logits are not compared
        assert _rel(logits.numpy()[keep], want[keep]) <= 1e-4
        assert _cache_err(cache, want_cache) <= 1e-5
        for k, t in cache["blocks0"].items():  # the empty row kept its state
            assert torch.equal(t[:, 1], before[k])
    for tok, pos, want in trace["decode"]:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert logits.shape == (B, 1, cfg.padded_vocab())
        assert _rel(logits, want) <= 1e-4
    assert _cache_err(cache, trace["final_cache"]) <= 1e-5


def test_cacheless_prefill_matches_reference(served):
    degree, tree, prompts, _, _ = served
    rcfg = ref_smoke("llama3_2_1b", topo_attn_impl="pallas",
                     topo_degree=degree, **OVER)
    params = jax.tree.map(jnp.asarray, tree)
    want = RA.prefill_fn(rcfg, params, {"tokens": jnp.asarray(prompts[0])})
    cfg = get_smoke_config("llama3_2_1b", topo_attn_impl="cuda",
                           topo_degree=degree, **OVER)
    model = convert.from_reference(cfg, tree, device="cpu")
    got = TA.prefill_fn(cfg, model, {"tokens": prompts[0]}, device="cpu")
    assert got.shape == (B, 1, cfg.padded_vocab())
    assert _rel(got, want) <= 1e-4
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(prompts[0]).long()), got)


def test_weights_round_trip_bitwise(served):
    degree, tree, _, _, _ = served
    cfg = get_smoke_config("llama3_2_1b", topo_degree=degree, **OVER)
    model = convert.from_reference(cfg, tree, device="cpu")
    back = convert.to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    names = set(model.state_dict())
    assert "blocks.1.attn.wq" in names and "blocks.0.topo.coeffs" in names
    assert TA.param_count(model) == sum(a.size for a in
                                        jax.tree.leaves(tree))


def test_bfloat16_weights_round_trip_bitwise():
    rcfg = ref_smoke("llama3_2_1b", attention_variant="topo")
    tree = jax.tree.map(np.asarray, RA.init_params(rcfg,
                                                   jax.random.PRNGKey(5)))
    cfg = get_smoke_config("llama3_2_1b", attention_variant="topo")
    model = convert.from_reference(cfg, tree, device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(convert.to_reference(model))):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16),
                                                     b.view(np.uint16))


def test_init_params_is_seeded_and_shaped_like_the_reference():
    cfg = get_smoke_config("llama3_2_1b", topo_degree=2, **OVER)
    m1, m2 = (TA.init_params(cfg, 7, device="cpu") for _ in range(2))
    for (n1, t1), (n2, t2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2)
    rcfg = ref_smoke("llama3_2_1b", topo_degree=2, **OVER)
    ref_tree = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    back = convert.to_reference(m1)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(back)):
        assert tuple(a.shape) == b.shape
    assert torch.equal(m1.blocks[0].topo.coeffs, torch.tensor([0.0, -1.0,
                                                               0.0]))


def test_full_width_config_is_the_reference_one():
    from repro.configs.base import get_config as ref_config

    cfg = get_config("llama3.2-1b", attention_variant="topo")
    want = ref_config("llama3.2-1b", attention_variant="topo")
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "tie_embeddings",
                  "topo_g", "topo_degree", "topo_dist_scale", "dtype",
                  "topo_attn_impl", "norm_eps"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.padded_vocab() == want.padded_vocab() == 128256


def _tree_mask(cfg, package):
    """The one-request forest mask of an 8-token prompt over
    random_tree(8, seed=3), in the reference's or the port's package."""
    if package == "reference":
        from repro.core.masks import make_tree_fastmult
        from repro.graphs.graph import random_tree
        from repro.serve.forest_masks import ForestMaskManager
        mgr, kw = ForestMaskManager(1, leaf_size=4), {}
    else:
        from repro_torch.core.masks import make_tree_fastmult
        from repro_torch.graphs.graph import random_tree
        from repro_torch.serve.forest_masks import ForestMaskManager
        mgr = ForestMaskManager(1, leaf_size=4, device="cpu")
        kw = {"device": "cpu"}
    mgr.admit(0, random_tree(8, seed=3))
    pack, unpack = mgr.pack_maps(8, [0], 1)
    return {"make_fastmult": lambda c: make_tree_fastmult(
        (mgr.spec, mgr.params), cfg.topo_g, c, cfg.topo_dist_scale, **kw),
        "pack": pack, "unpack": unpack}


def test_what_is_not_ported_raises_naming_the_roadmap():
    cfg = get_smoke_config("llama3_2_1b", **OVER)
    model = TA.init_params(cfg, 0, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    # "fft" at degree 2 (the Toeplitz FastMult) is ported: it serves
    deg2 = cfg.replace(topo_degree=2)
    model2 = TA.init_params(deg2, 0, device="cpu")
    got = TA.prefill_fn(deg2, model2, {"tokens": toks}, device="cpu")
    want = TA.prefill_fn(deg2.replace(topo_attn_impl="torch"), model2,
                         {"tokens": toks}, device="cpu")
    assert _rel(got, want) <= 1e-3
    # the forest tree-mask prefill is ported (ROADMAP A11): the same call
    # serves, with the reference's logits and cache on the same weights
    tcfg = cfg.replace(topo_attn_impl="torch")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8))
    with torch.no_grad():
        got, got_cache = TLM.forward_prefill_into_cache(
            tcfg, model, TA.init_cache(cfg, 1, 16, device="cpu"),
            torch.as_tensor(toks).long(), torch.tensor([8]), 16,
            tree_mask=_tree_mask(tcfg, "torch"))
    rcfg = ref_smoke("llama3_2_1b", **OVER)
    want, want_cache = RA.prefill_into_cache(
        rcfg, convert.to_reference(model), RA.init_cache(rcfg, 1, 16),
        jnp.asarray(toks, jnp.int32), jnp.asarray([8], jnp.int32), 16,
        tree_mask=_tree_mask(rcfg, "reference"))
    assert _rel(got, want) <= 1e-4
    assert _cache_err(got_cache, jax.tree.map(np.asarray, want_cache)) <= 1e-5
    # the hybrid, encdec and vlm families are ported (ROADMAP A10b): every
    # reference arch resolves, and an unknown one raises
    assert get_smoke_config("recurrentgemma_2b").family == "hybrid"
    with pytest.raises(ValueError, match="unknown arch"):
        get_smoke_config("not_an_arch")


def _grads(cfg, model, toks):
    model.zero_grad(set_to_none=True)
    TLM.forward_prefill(cfg, model, {"tokens": toks}).square().sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_kernel_path_refuses_grad_in_the_model():
    """With grad on, the "cuda" impl no longer refuses: it goes through
    the fused entry's autograd.Function (the reference's custom VJP),
    whose backward is the plain sweep's VJP, so every parameter, the mask
    scalars included, gets the grad the "torch" impl gives it; the serving
    entry points still run without grad."""
    cfg = get_smoke_config("llama3_2_1b", topo_attn_impl="cuda",
                           topo_degree=2, **OVER)
    model = TA.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 12)))
    got = _grads(cfg, model, toks)
    want = _grads(cfg.replace(topo_attn_impl="torch"), model, toks)
    for name, g in want.items():
        assert float((got[name] - g).abs().max()) <= 1e-6 * float(
            g.abs().max()), name
    assert float(want["blocks.0.topo.coeffs"][1:].abs().min()) > 0
    TA.prefill_fn(cfg, model, {"tokens": toks}, device="cpu")


def test_entry_points_refuse_the_cpu_by_default():
    """device=None means the card: without one every entry point raises
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_smoke_config("llama3_2_1b", topo_attn_impl="cuda", **OVER)
    model = TA.init_params(cfg, 0, device="cpu")
    toks, lens = np.zeros((1, 8), np.int32), np.array([8])
    cache = TA.init_cache(cfg, 1, 16, device="cpu")
    calls = [lambda: TA.init_params(cfg, 0),
             lambda: TA.init_cache(cfg, 1, 16),
             lambda: convert.from_reference(cfg, convert.to_reference(model)),
             lambda: TA.prefill_fn(cfg, model, {"tokens": toks}),
             lambda: TA.prefill_into_cache(cfg, model, cache, toks, lens, 16),
             lambda: TA.decode_fn(cfg, model, cache, toks[:, :1], 8, 16)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch.models
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import api, convert
cfg = get_smoke_config("llama3_2_1b", attention_variant="topo",
                       topo_attn_impl="cuda", topo_degree=2, dtype="float32")
model = api.init_params(cfg, 0, device="cpu")
cache = api.init_cache(cfg, 2, 20, device="cpu")
logits, cache = api.prefill_into_cache(
    cfg, model, cache, np.ones((2, 8), np.int32), np.array([8, 5]), 20,
    device="cpu")
logits, cache = api.decode_fn(cfg, model, cache, np.ones((2, 1), np.int32),
                              np.array([8, 5]), 20, device="cpu")
assert bool(logits.isfinite().all()) and logits.shape == (2, 1, 512)
convert.from_reference(cfg, convert.to_reference(model), device="cpu")
assert not any(k == "jax" or k.startswith("jax.") or k == "repro"
               or k.startswith("repro.")
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_models_import_and_serve_without_jax_or_reference():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "ok"


def test_import_scan_covers_the_new_modules():
    """tests/test_torch_plan_build.py scans every .py of the package for
    imports of jax or repro; this slice's modules are among them."""
    files = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"models/attention.py", "models/lm.py", "models/api.py",
            "models/convert.py", "models/layers.py", "configs/base.py",
            "core/masks.py", "kernels/_nvcc.py", "kernels/_vjp.py",
            "kernels/topo_linear_attention/ops.py",
            "kernels/topo_linear_attention/kernel.py",
            "kernels/topo_linear_attention/ref.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/kernel.py",
            "kernels/flash_attention/ref.py",
            "kernels/linear_attention/ops.py",
            "kernels/linear_attention/kernel.py",
            "kernels/linear_attention/ref.py",
            "optim/adamw.py", "optim/compress.py", "train/loop.py",
            "data/synthetic.py", "checkpoint/manager.py",
            "launch/train.py"} <= files
