"""The vlm family (LLaVA-NeXT's backbone, ROADMAP A10b) against the
reference, on the CPU at the smoke config in float32 (2 layers, GQA 4/2,
16 patch embeddings ahead of 24 tokens), the reference's weights carried
by `convert.from_reference`:

  * `loss_fn`'s loss (the text region only) and every grad, the
    mm_projector's included, against `jax.grad`, on "chunked" and "cuda"
    (the flash wrapper's plain version on CPU tensors);
  * `prefill_fn`'s logits over [patches ; text]; `prefill_into_cache` and
    4 decode steps on the text, as the reference serves them;
  * `convert` both ways bit for bit, in bf16; the full-width parameter
    shapes and count against `jax.eval_shape`; the data stream's
    `patch_embeds` bit for bit; the training loop on the smoke model.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import base as RB  # noqa: E402
from repro.data.synthetic import SyntheticLMStream as RStream  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.roofline.analysis import count_params  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402

ARCH = "llava_next_34b"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, L, P = 2, 24, 16
S, LP = 40, 24


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-30)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _leaves(tree):
    return dict(convert._flatten(tree))


@functools.lru_cache(maxsize=None)
def _reference():
    rcfg = RB.get_smoke_config(ARCH, dtype="float32", attn_impl="chunked")
    params = _jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(51))
    rng = np.random.default_rng(51)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (B, L)).astype(
        np.int32), "patch_embeds": rng.normal(size=(B, P, 1024)).astype(
        np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, jb), has_aux=True))(params)
    prefill = _jit(RA.prefill_fn, 0)(rcfg, params, jb)
    prompts = rng.integers(0, rcfg.vocab_size, (3, LP)).astype(np.int32)
    lengths = np.array([24, 0, 9], np.int32)
    cache = RA.init_cache(rcfg, 3, S)
    logits, cache = _jit(RA.prefill_into_cache, 0, 5)(
        rcfg, params, cache, jnp.asarray(prompts), jnp.asarray(lengths), S)
    trace = (np.asarray(logits), _np_tree(cache))
    pos = lengths.copy()
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    steps = []
    for _ in range(4):
        logits, cache = _jit(RA.decode_fn, 0, 5)(
            rcfg, params, cache, jnp.asarray(tok), jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits), _np_tree(cache)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    return (_np_tree(params), batch, float(loss), _np_tree(grads),
            np.asarray(prefill), prompts, lengths, trace, steps)


def _model(impl):
    cfg = TB.get_smoke_config(ARCH, dtype="float32", attn_impl=impl)
    return cfg, convert.from_reference(cfg, _reference()[0], device="cpu")


def _cache_err(tcache, rcache):
    got, want = _leaves(tcache), _leaves(rcache)
    assert set(got) == set(want)
    return max(_rel(got[k], want[k]) for k in want)


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_loss_and_grads_match_reference(impl):
    _, batch, want_loss, want_grads, *_ = _reference()
    cfg, model = _model(impl)
    loss, metrics = TA.loss_fn(cfg, model, batch, device="cpu")
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["aux"]) == 0.0
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert float(np.abs(grads["mm_projector.w1"]).max()) > 0
    stacks = convert._stacks(cfg)
    errs = {}
    for path, g in _leaves(want_grads).items():
        top = max(float(np.abs(g).max()), 1e-30)
        sub = {}
        TLM._put(sub, tuple(path.split(".")), g)
        for n, w in convert._state_dict(sub, "cpu", stacks).items():
            errs[n] = float(np.abs(grads[n].astype(np.float64)
                                   - w.numpy()).max()) / top
    assert set(errs) == set(grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_prefill_logits_match_reference(impl):
    ref = _reference()
    cfg, model = _model(impl)
    got = TA.prefill_fn(cfg, model, ref[1], device="cpu")
    assert got.shape == (B, 1, cfg.padded_vocab())
    assert _rel(got, ref[4]) <= LOGIT_TOL


def test_serving_the_text_matches_reference():
    *_, prompts, lengths, trace, steps = _reference()
    cfg, model = _model("cuda")
    cache = TA.init_cache(cfg, 3, S, device="cpu")
    logits, cache = TA.prefill_into_cache(cfg, model, cache, prompts,
                                          lengths, S, device="cpu")
    keep = lengths > 0
    assert _rel(logits.numpy()[keep], trace[0][keep]) <= LOGIT_TOL
    assert _cache_err(cache, trace[1]) <= CACHE_TOL
    for tok, pos, want, want_cache in steps:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert _rel(logits, want) <= LOGIT_TOL
        assert _cache_err(cache, want_cache) <= CACHE_TOL


def test_loss_needs_the_patches():
    cfg, model = _model("chunked")
    with pytest.raises(ValueError, match="patch_embeds"):
        TA.loss_fn(cfg, model, {"tokens": np.zeros((1, 4), np.int32)},
                   device="cpu")


def test_convert_round_trips_bit_for_bit():
    rcfg = RB.get_smoke_config(ARCH)
    tree = _np_tree(_jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(5)))
    cfg = TB.get_smoke_config(ARCH)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert dtype_of(cfg) == torch.bfloat16
    back = convert.to_reference(model)
    a, b = _leaves(tree), _leaves(back)
    assert set(a) == set(b)
    assert "mm_projector.w1" in a and "mm_projector.w2" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint16), b[k].view(np.uint16)), k


def test_full_width_shapes_and_count_match_reference():
    rcfg = RB.get_config(ARCH)
    cfg = TB.get_config(ARCH)
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


def test_stream_patch_embeds_match_reference_bit_for_bit():
    for step in (0, 7):
        want = RStream(512, 4, 32, seed=2, vlm_prefix=16).batch_at(step)
        got = SyntheticLMStream(512, 4, 32, seed=2,
                                vlm_prefix=16).batch_at(step)
        assert set(got) == set(want) == {"tokens", "patch_embeds"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


def test_training_loop_feeds_the_patches(tmp_path):
    cfg = TB.get_smoke_config(ARCH).replace(dtype="float32")
    loop = TrainLoopConfig(steps=3, batch_size=4, seq_len=16,
                           microbatches=2, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=50, log_every=100)
    res = run_training(cfg, loop, verbose=False, device="cpu")
    assert res["losses"].shape == (3,) and np.isfinite(res["losses"]).all()
