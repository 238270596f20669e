"""The configs the port registers with the DeepSeek family (ROADMAP A10a)
against the reference, on the CPU:

  * the smoke Qwen2-1.5B (GQA with qkv bias), Gemma-7B (GeGLU, scaled
    embeddings) and Granite-34B (MQA) in float32, the reference's weights
    carried by `convert.from_reference`: `loss_fn`'s loss and every grad
    against `jax.grad`, on "chunked" and "cuda" (the flash wrapper's plain
    version on CPU tensors), then prefill into the cache and 4 decode steps
    against the reference's `prefill_into_cache` / `decode_fn`;
  * the full-width parameter shapes, dtypes and total count of all five
    new configs against the reference's (`jax.eval_shape` of its
    `init_params`, `roofline.analysis.count_params`), allocating nothing;
  * the registry's names and aliases, and the reference's training case on
    the smoke Qwen2 (microbatches and int8 compression).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import base as RB  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.roofline.analysis import count_params  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402

DENSE = ("qwen2_1_5b", "gemma_7b", "granite_34b")
NEW = DENSE + ("deepseek_v2_lite_16b", "deepseek_v3_671b")
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, L = 2, 24
S, LP = 40, 24


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-30)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """The reference's function under jax.jit, compiled once per process
    and static signature: eager, its smoke models take seconds a call."""
    return jax.jit(fn, static_argnums=static)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's init, a batch, jax.value_and_grad(api.loss_fn) and a
    serving trace (prefill of mixed lengths, one row empty, then 4 greedy
    decode steps), as numpy: computed once per arch."""
    rcfg = RB.get_smoke_config(arch, dtype="float32", attn_impl="chunked")
    params = _jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(21))
    rng = np.random.default_rng(21)
    toks = rng.integers(0, rcfg.vocab_size, (B, L)).astype(np.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    prompts = rng.integers(0, rcfg.vocab_size, (3, LP)).astype(np.int32)
    lengths = np.array([24, 0, 9], np.int32)
    cache = RA.init_cache(rcfg, 3, S)
    logits, cache = _jit(RA.prefill_into_cache, 0, 5)(
        rcfg, params, cache,
                                          jnp.asarray(prompts),
                                          jnp.asarray(lengths), S)
    trace = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    pos = lengths.copy()
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    steps = []
    for _ in range(4):
        logits, cache = _jit(RA.decode_fn, 0, 5)(
            rcfg, params, cache, jnp.asarray(tok), jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (as_np(params), toks, float(loss), as_np(grads), prompts,
            lengths, trace, steps, as_np(cache))


def _cache_err(tcache, rcache):
    assert set(tcache) == set(rcache) == {"blocks0"}
    return max(_rel(tcache["blocks0"][k], rcache["blocks0"][k])
               for k in rcache["blocks0"])


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch, impl):
    params, toks, want_loss, want_grads, *_ = _reference(arch)
    cfg = TB.get_smoke_config(arch, dtype="float32", attn_impl=impl)
    model = convert.from_reference(cfg, params, device="cpu")
    loss, metrics = TA.loss_fn(cfg, model, {"tokens": toks}, device="cpu")
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["aux"]) == 0.0
    want = {k: t.numpy() for k, t in convert._state_dict(
        want_grads, "cpu", convert.STACKED).items()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    # each grad against the largest of its reference leaf (a block
    # parameter stacked over the layers)
    leaf = {n: ".".join(["blocks"] + n.split(".")[2:])
            if n.startswith("blocks.") else n for n in want}
    top = {}
    for name, g in want.items():
        top[leaf[name]] = max(top.get(leaf[name], 0.0),
                              float(np.abs(g).max()))
    errs = {n: float(np.abs(grads[n].astype(np.float64) - g).max())
            / max(top[leaf[n]], 1e-30) for n, g in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", DENSE)
def test_serving_matches_reference(arch):
    params, _, _, _, prompts, lengths, trace, steps, final = _reference(arch)
    cfg = TB.get_smoke_config(arch, dtype="float32", attn_impl="cuda")
    model = convert.from_reference(cfg, params, device="cpu")
    cache = TA.init_cache(cfg, 3, S, device="cpu")
    logits, cache = TA.prefill_into_cache(cfg, model, cache, prompts,
                                          lengths, S, device="cpu")
    want, want_cache = trace[0]
    keep = lengths > 0
    assert _rel(logits.numpy()[keep], want[keep]) <= LOGIT_TOL
    assert _cache_err(cache, want_cache) <= CACHE_TOL
    for tok, pos, want in steps:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert _rel(logits, want) <= LOGIT_TOL
    assert _cache_err(cache, final) <= CACHE_TOL


@pytest.mark.parametrize("arch", NEW)
def test_full_width_shapes_and_count_match_reference(arch):
    """The port's full-width model on the meta device (no memory) has the
    reference's parameters leaf for leaf: each stacked leaf's per-layer
    shape at every layer of its segment, the dtype, and the total count of
    `count_params`."""
    rcfg = RB.get_config(arch)
    cfg = TB.get_config(arch)
    shapes = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    stacks = convert._stacks(cfg)
    want = {}
    for name, leaf in convert._flatten(shapes):
        key, _, rest = name.partition(".")
        if key in stacks:
            for j in range(leaf.shape[0]):
                want[f"blocks.{stacks[key] + j}.{rest}"] = (
                    leaf.shape[1:], leaf.dtype.name)
        else:
            want[name] = (leaf.shape, leaf.dtype.name)
    model = TLM.DecoderLM(cfg, device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == want
    total, _ = count_params(rcfg)
    assert TA.param_count(model) == total
    assert dtype_of(cfg) == torch.bfloat16


def test_registry_names_the_new_archs():
    for arch in NEW:
        alias = RB.get_config(arch).name
        assert TB.get_config(alias) == TB.get_config(arch)
        for field in ("num_layers", "d_model", "num_heads", "head_dim",
                      "vocab_size", "num_experts", "q_lora_rank",
                      "mtp_depth", "capacity_factor", "qkv_bias",
                      "emb_scale", "mlp_act"):
            assert getattr(TB.get_config(arch), field) == getattr(
                RB.get_config(arch), field), (arch, field)
            assert getattr(TB.get_smoke_config(arch), field) == getattr(
                RB.get_smoke_config(arch), field), (arch, field)
    # every reference arch resolves (ROADMAP A10b); an unknown one raises
    assert sorted(TB.ARCHS) == sorted(RB.ARCHS)
    with pytest.raises(ValueError, match="unknown arch"):
        TB.get_config("not_an_arch")


def test_training_with_microbatches_and_compression(tmp_path):
    """The reference's tests/test_training.py case on the smoke Qwen2: 10
    steps, 2 microbatches, int8 error-feedback compression."""
    cfg = TB.get_smoke_config("qwen2_1_5b").replace(dtype="float32")
    loop = TrainLoopConfig(steps=10, batch_size=4, seq_len=32,
                           microbatches=2, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=50, compress_grads=True, log_every=100)
    res = run_training(cfg, loop, verbose=False, device="cpu")
    assert res["losses"].shape == (10,) and np.isfinite(res["losses"]).all()
