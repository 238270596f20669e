"""The hybrid family (RecurrentGemma: RG-LRU blocks and local attention,
ROADMAP A10b) against the reference, on the CPU at the smoke config in
float32 (1 superblock of (rec, rec, attn) and a tail rec, window 8), the
reference's weights carried by `convert.from_reference`:

  * `loss_fn`'s loss and every grad against `jax.grad`, on "chunked" and
    "cuda" (the flash wrapper's plain version under the window on CPU
    tensors);
  * `prefill_fn`'s logits; `prefill_into_cache` (lengths 24, 0 and 9 at
    L = 24: the window binds) and 4 decode steps (the ring wraps) against
    the reference's, logits and every cache leaf;
  * the RG-LRU scan, the block's prefill state and the local ring against
    the reference's functions;
  * `convert` both ways bit for bit, in bf16; the full-width parameter
    shapes and count against `jax.eval_shape` of the reference's init.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import base as RB  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.models import attention as RAT  # noqa: E402
from repro.models import rglru as RRG  # noqa: E402
from repro.roofline.analysis import count_params  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import attention as TAT  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import rglru as TRG  # noqa: E402
from repro_torch.models.layers import Params, dtype_of  # noqa: E402

ARCH = "recurrentgemma_2b"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, L = 2, 24
S, LP = 40, 24
LENGTHS = (24, 0, 9)


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


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's init, a batch, jax.value_and_grad(api.loss_fn), the
    prefill logits and a serving trace (prefill into the cache of mixed
    lengths, one row empty, then 4 greedy decode steps), as numpy."""
    rcfg = RB.get_smoke_config(ARCH, dtype="float32", attn_impl="chunked")
    params = _jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(31))
    rng = np.random.default_rng(31)
    toks = rng.integers(0, rcfg.vocab_size, (B, L)).astype(np.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    prefill = _jit(RA.prefill_fn, 0)(rcfg, params,
                                     {"tokens": jnp.asarray(toks)})
    prompts = rng.integers(0, rcfg.vocab_size, (3, LP)).astype(np.int32)
    lengths = np.array(LENGTHS, np.int32)
    cache = RA.init_cache(rcfg, 3, S)
    logits, cache = _jit(RA.prefill_into_cache, 0, 5)(
        rcfg, params, cache, jnp.asarray(prompts), jnp.asarray(lengths), S)
    trace = [(np.asarray(logits), _np_tree(cache))]
    pos = lengths.copy()
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    steps = []
    for _ in range(4):
        logits, cache = _jit(RA.decode_fn, 0, 5)(
            rcfg, params, cache, jnp.asarray(tok), jnp.asarray(pos), S)
        steps.append((tok, pos.copy(), np.asarray(logits), _np_tree(cache)))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = pos + 1
    return (_np_tree(params), toks, float(loss), _np_tree(grads),
            np.asarray(prefill), prompts, lengths, trace, steps)


def _leaves(tree, prefix=""):
    return dict(convert._flatten(tree, prefix))


def _nest(path, leaf):
    """{"a": {"b": leaf}} of the dotted path "a.b"."""
    tree = {}
    TLM._put(tree, tuple(path.split(".")), leaf)
    return tree


def _cache_err(tcache, rcache):
    """The largest relative error over the cache's leaves; the ring's kpos
    must be equal."""
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in _leaves(tcache).items()}
    want = _leaves(rcache)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("kpos"):
            assert np.array_equal(got[k], want[k]), k
    return max(_rel(got[k], want[k]) for k in want)


def _model(impl):
    params = _reference()[0]
    cfg = TB.get_smoke_config(ARCH, dtype="float32", attn_impl=impl)
    return cfg, convert.from_reference(cfg, params, device="cpu")


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_loss_and_grads_match_reference(impl):
    _, toks, want_loss, want_grads, *_ = _reference()
    cfg, model = _model(impl)
    loss, metrics = TA.loss_fn(cfg, model, {"tokens": toks}, device="cpu")
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["aux"]) == 0.0
    want = {k: t.numpy() for k, t in convert._state_dict(
        want_grads, "cpu", convert._stacks(cfg)).items()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    # each grad against the largest of its reference leaf (stacked over the
    # superblocks, or a tail block's own)
    errs = {}
    for path, g in _leaves(want_grads).items():
        top = max(float(np.abs(g).max()), 1e-30)
        for n, w in convert._state_dict(_nest(path, g), "cpu",
                                        convert._stacks(cfg)).items():
            errs[n] = float(np.abs(grads[n].astype(np.float64)
                                   - w.numpy()).max()) / top
    assert set(errs) == set(want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_prefill_logits_match_reference(impl):
    ref = _reference()
    cfg, model = _model(impl)
    got = TA.prefill_fn(cfg, model, {"tokens": ref[1]}, device="cpu")
    assert got.shape == (B, 1, cfg.padded_vocab())
    assert _rel(got, ref[4]) <= LOGIT_TOL


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_serving_matches_reference(impl):
    """prefill_into_cache with the window binding (24 > W = 8), a row left
    empty, then 4 decode steps in which the ring wraps: logits within 1e-4,
    every cache leaf within 1e-5, kpos equal."""
    *_, prompts, lengths, trace, steps = _reference()
    cfg, model = _model(impl)
    cache = TA.init_cache(cfg, 3, S, device="cpu")
    assert set(cache) == {"blocks0", "tail0"}
    assert set(cache["blocks0"]) == {"b0_rec", "b1_rec", "b2_attn"}
    assert cache["blocks0"]["b2_attn"]["kpos"].shape == (1, 3, 8)
    logits, cache = TA.prefill_into_cache(cfg, model, cache, prompts,
                                          lengths, S, device="cpu")
    want, want_cache = trace[0]
    keep = lengths > 0
    assert _rel(logits.numpy()[keep], want[keep]) <= LOGIT_TOL
    assert _cache_err(cache, want_cache) <= CACHE_TOL
    for tok, pos, want, want_cache in steps:
        logits, cache = TA.decode_fn(cfg, model, cache, tok, pos, S,
                                     device="cpu")
        assert _rel(logits, want) <= LOGIT_TOL
        assert _cache_err(cache, want_cache) <= CACHE_TOL


def _lru_params(rng, cfg):
    shapes = TRG.lru_shapes(cfg)
    raw = {n: rng.normal(size=s).astype(np.float32) * 0.3
           for n, s in shapes.items()}
    raw["a_param"] = np.log(np.expm1(rng.uniform(0.9, 0.999, shapes[
        "a_param"]))).astype(np.float32)
    p = Params(shapes)
    p.load_state_dict({n: torch.from_numpy(a) for n, a in raw.items()})
    return raw, p


def test_rglru_scan_and_block_prefill_match_reference():
    """The doubling scan against the reference's associative scan; the
    block's train output, and its prefill output and state (r = i = 0
    past each row's length, the conv tail from the real tokens only)."""
    cfg = TB.get_smoke_config(ARCH, dtype="float32")
    rng = np.random.default_rng(5)
    raw, p = _lru_params(rng, cfg)
    jp = {n: jnp.asarray(a) for n, a in raw.items()}
    x = rng.normal(size=(3, 37, cfg.d_model)).astype(np.float32)
    r, i = (rng.uniform(size=(3, 37, cfg.lru_width)).astype(np.float32)
            for _ in range(2))
    xs = rng.normal(size=(3, 37, cfg.lru_width)).astype(np.float32)
    want, want_fin = RRG._rglru_scan(jnp.asarray(xs), jnp.asarray(r),
                                     jnp.asarray(i), jp["a_param"])
    got, got_fin = TRG._rglru_scan(p, torch.from_numpy(xs),
                                   torch.from_numpy(r), torch.from_numpy(i))
    assert _rel(got, want) <= 1e-5 and _rel(got_fin, want_fin) <= 1e-5
    assert _rel(TRG.lru_block_train(cfg, p, torch.from_numpy(x)),
                RRG.lru_block_train(cfg, jp, jnp.asarray(x))) <= 1e-5
    lengths = np.array([37, 0, 2], np.int32)
    rc = RRG.lru_decode_init(cfg, 3)
    rc = {"conv": rc["conv"] + 0.5, "h": rc["h"] - 0.25}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in rc.items()}
    y_want, c_want = RRG.lru_block_prefill(cfg, jp, jnp.asarray(x),
                                           jnp.asarray(lengths), rc)
    y_got, c_got = TRG.lru_block_prefill(cfg, p, torch.from_numpy(x),
                                         torch.from_numpy(lengths), tc)
    assert _rel(y_got, y_want) <= 1e-5
    for k in ("conv", "h"):
        assert _rel(c_got[k], c_want[k]) <= 1e-5, k
    # row 1 (length 0) keeps its cache exactly
    assert torch.equal(c_got["conv"][1], tc["conv"][1])
    assert torch.equal(c_got["h"][1], tc["h"][1])
    step_want, cs_want = RRG.lru_block_decode(cfg, jp, jnp.asarray(x[:, :1]),
                                              c_want)
    step_got, cs_got = TRG.lru_block_decode(cfg, p, torch.from_numpy(
        x[:, :1]), c_got)
    assert _rel(step_got, step_want) <= 1e-5
    assert _rel(cs_got["h"], cs_want["h"]) <= 1e-5


def test_local_ring_matches_reference():
    """local_attention_prefill's output and ring (built from the valid
    tokens only, kpos -1 elsewhere) and a decode step past the window,
    against the reference's; the port's prefill attends through `_attend`
    on every impl."""
    cfg = TB.get_smoke_config(ARCH, dtype="float32")
    rcfg = RB.get_smoke_config(ARCH, dtype="float32")
    rng = np.random.default_rng(9)
    shapes = TAT.attn_shapes(cfg)
    raw = {n: rng.normal(size=s).astype(np.float32) * 0.2
           for n, s in shapes.items()}
    p = Params(shapes)
    p.load_state_dict({n: torch.from_numpy(a) for n, a in raw.items()})
    jp = {n: jnp.asarray(a) for n, a in raw.items()}
    x = rng.normal(size=(3, 20, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (3, 1))
    lengths = np.array([20, 5, 0], np.int32)
    rc = RAT.local_attention_decode_init(rcfg, 3, jnp.float32)
    out_w, ring_w = RAT.local_attention_prefill(
        rcfg, jp, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lengths), rc)
    step_w, ring2_w = RAT.local_attention_decode(
        rcfg, jp, jnp.asarray(x[:, :1]), jnp.asarray(lengths), ring_w)
    for impl in ("naive", "chunked", "cuda"):
        c = cfg.replace(attn_impl=impl)
        tc = TAT.local_attention_decode_init(c, 3, torch.float32)
        out, ring = TAT.local_attention_prefill(
            c, p, torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(lengths), tc)
        assert _rel(out, out_w) <= 1e-5, impl
        assert np.array_equal(ring["kpos"].numpy(), np.asarray(ring_w["kpos"]))
        for k in ("k", "v"):
            assert _rel(ring[k], ring_w[k]) <= 1e-5
        step, ring2 = TAT.local_attention_decode(
            c, p, torch.from_numpy(x[:, :1]), torch.from_numpy(lengths), ring)
        assert _rel(step, step_w) <= 1e-5
        assert np.array_equal(ring2["kpos"].numpy(),
                              np.asarray(ring2_w["kpos"]))


def test_convert_round_trips_bit_for_bit():
    """bf16 weights: the reference's tree -> the port -> the tree, equal
    bit for bit, and the stacked superblock leaf j at layer 3 j + bi, the
    tail at layer 3."""
    rcfg = RB.get_smoke_config(ARCH)
    tree = _np_tree(_jit(RA.init_params, 0)(rcfg, jax.random.PRNGKey(3)))
    cfg = TB.get_smoke_config(ARCH)
    model = convert.from_reference(cfg, tree, device="cpu")
    assert dtype_of(cfg) == torch.bfloat16
    assert TLM.layer_kinds(cfg) == ["rec_mlp", "rec_mlp", "attn_local_mlp",
                                    "rec_mlp"]
    back = convert.to_reference(model)
    a, b = _leaves(tree), _leaves(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint16), b[k].view(np.uint16)), k
    sd = model.state_dict()
    assert np.array_equal(convert._to_numpy(sd["blocks.2.attn.wq"]).view(
        np.uint16), tree["blocks0"]["b2_attn"]["attn"]["wq"][0].view(
        np.uint16))
    assert np.array_equal(convert._to_numpy(sd["blocks.3.lru.gates"]).view(
        np.uint16), tree["tail0"]["lru"]["gates"].view(np.uint16))


def test_full_width_shapes_and_count_match_reference():
    """RecurrentGemma-2B on the meta device: the reference's parameters
    leaf for leaf (per layer), the bf16 dtype and the total count."""
    rcfg = RB.get_config(ARCH)
    cfg = TB.get_config(ARCH)
    shapes = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    stacks = convert._stacks(cfg)
    want = {}
    for name, leaf in convert._flatten(shapes):
        place = convert._rule(stacks, name)
        if place is None:
            want[name] = (leaf.shape, leaf.dtype.name)
            continue
        port, layers, stacked = stacks[place]
        rest = name[len(place) + 1:]
        for layer in layers:
            want[f"{port}.{layer}.{rest}"] = (
                leaf.shape[1:] if stacked else leaf.shape, leaf.dtype.name)
    model = TLM.DecoderLM(cfg, device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == want
    total, _ = count_params(rcfg)
    assert TA.param_count(model) == total
    assert len(model.blocks) == 26
