"""The encoder-decoder family (SeamlessM4T's backbone, ROADMAP A10b)
against the reference, on the CPU at the smoke config in float32 (2 + 2
layers, 24 source frames, a 16-token decoder prompt: cross-attention with
Lq != Lk), the reference's weights carried by `convert.from_reference`:

  * `loss_fn`'s loss and every grad against `jax.grad`, on "chunked" and
    "cuda" (the flash wrapper's plain version on CPU tensors: the encoder
    non-causal, the decoder causal, cross-attention Lq != Lk);
  * `prefill_fn`'s logits; decode replay (`init_cache`, 4 `decode_fn`
    steps over the zero cross memory, as the reference's) with every cache
    leaf; `prefill_into_cache` refused, as the reference refuses it;
  * `convert` both ways bit for bit, in bf16; the full-width parameter
    shapes and count against `jax.eval_shape`; the data stream's
    `src_embeds` bit for bit; the training loop on the smoke model.
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
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402

ARCH = "seamless_m4t_medium"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, L, SRC = 2, 16, 24
S = 24


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
    """The reference's init, a batch, jax.value_and_grad(api.loss_fn), the
    prefill logits and 4 greedy decode steps from an empty cache (decode
    replay), as numpy."""
    rcfg = RB.get_smoke_config(ARCH, dtype="float32", attn_impl="chunked")
    params = _jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(41))
    rng = np.random.default_rng(41)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (B, L)).astype(
        np.int32), "src_embeds": rng.normal(size=(B, SRC, 1024)).astype(
        np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, jb), has_aux=True))(params)
    prefill = _jit(RA.prefill_fn, 0)(rcfg, params, jb)
    cache = RA.init_cache(rcfg, B, S)
    tok = batch["tokens"][:, :1]
    pos = np.array([0, 3], np.int32)
    steps = []
    for _ in range(4):
        logits, cache = _jit(RA.decode_fn, 0, 5)(
            rcfg, params, cache, jnp.asarray(tok), jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits), _np_tree(cache)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    return (_np_tree(params), batch, float(loss), _np_tree(grads),
            np.asarray(prefill), steps)


def _model(impl):
    cfg = TB.get_smoke_config(ARCH, dtype="float32", attn_impl=impl)
    return cfg, convert.from_reference(cfg, _reference()[0], device="cpu")


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_loss_and_grads_match_reference(impl):
    _, batch, want_loss, want_grads, *_ = _reference()
    cfg, model = _model(impl)
    assert isinstance(model, TED.EncDecLM)
    loss, metrics = TA.loss_fn(cfg, model, batch, device="cpu")
    loss.backward()
    assert metrics == {}
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
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


def test_decode_replay_matches_reference():
    """4 decode steps from `init_cache` at per-row positions: logits within
    1e-4, every cache leaf (the self-attention caches, the cross memory
    nothing writes) within 1e-5. The fused prefill is refused."""
    steps = _reference()[5]
    cfg, model = _model("cuda")
    cache = TA.init_cache(cfg, B, S, device="cpu")
    assert set(cache) == {"self", "cross_k", "cross_v"}
    assert cache["cross_k"].shape == (2, B, cfg.max_source_len, 4, 16)
    for tok, pos, want, want_cache in steps:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert _rel(logits, want) <= LOGIT_TOL
        got, ref = _leaves(cache), _leaves(want_cache)
        assert set(got) == set(ref)
        assert max(_rel(got[k], ref[k]) if np.abs(ref[k]).max() else
                   float(np.abs(got[k].numpy()).max()) for k in ref) \
            <= CACHE_TOL
    with pytest.raises(NotImplementedError, match="decode replay"):
        TA.prefill_into_cache(cfg, model, cache, steps[0][0],
                              np.array([1, 1]), S, device="cpu")


def test_loss_needs_the_source_frames():
    cfg, model = _model("chunked")
    with pytest.raises(ValueError, match="src_embeds"):
        TA.loss_fn(cfg, model, {"tokens": np.zeros((1, 4), np.int32)},
                   device="cpu")


def test_convert_round_trips_bit_for_bit():
    rcfg = RB.get_smoke_config(ARCH)
    tree = _np_tree(_jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(4)))
    cfg = TB.get_smoke_config(ARCH)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert dtype_of(cfg) == torch.bfloat16
    back = convert.to_reference(model)
    a, b = _leaves(tree), _leaves(back)
    assert set(a) == set(b)
    assert {k.split(".")[0] for k in a} == {
        "frontend_proj", "embed", "blocks_enc", "blocks_dec",
        "enc_final_norm", "final_norm", "lm_head"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint16), b[k].view(np.uint16)), k


def test_full_width_shapes_and_count_match_reference():
    rcfg = RB.get_config(ARCH)
    cfg = TB.get_config(ARCH)
    shapes = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    want = {}
    for name, leaf in convert._flatten(shapes):
        stack, _, rest = name.partition(".")
        if stack in ("blocks_enc", "blocks_dec"):
            for j in range(leaf.shape[0]):
                want[f"{stack}.{j}.{rest}"] = (leaf.shape[1:],
                                               leaf.dtype.name)
        else:
            want[name] = (leaf.shape, leaf.dtype.name)
    model = TED.EncDecLM(cfg, device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == want
    total, _ = count_params(rcfg)
    assert TA.param_count(model) == total


def test_stream_src_embeds_match_reference_bit_for_bit():
    for step in (0, 5):
        want = RStream(512, 4, 32, seed=3, encdec_src=24).batch_at(step)
        got = SyntheticLMStream(512, 4, 32, seed=3,
                                encdec_src=24).batch_at(step)
        assert set(got) == set(want) == {"tokens", "src_embeds"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


def test_training_loop_feeds_the_source_frames(tmp_path):
    """run_training on the smoke model: the stream's src_embeds reach
    loss_fn (3 steps, 2 microbatches)."""
    cfg = TB.get_smoke_config(ARCH).replace(dtype="float32")
    loop = TrainLoopConfig(steps=3, batch_size=4, seq_len=16,
                           microbatches=2, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=50, log_every=100)
    res = run_training(cfg, loop, verbose=False, device="cpu")
    assert res["losses"].shape == (3,) and np.isfinite(res["losses"]).all()
