"""Training parity of the port against the reference, at smoke scale in
float32, on the same init (the reference's `init_params` through
`convert.from_reference`) and the same batch:

  * `api.loss_fn`'s loss and every parameter's grad against
    `jax.value_and_grad(api.loss_fn)`: full attention on "naive",
    "chunked" and "cuda" (the flash attention wrapper's autograd.Function),
    Performer on "cuda" (the linear attention wrapper's), the topo LM at
    degree 1 and 2 on "torch" and on "cuda" (the fused sweep's, the
    reference's custom VJP; the reference runs its impl "pallas", whose
    CPU form is its XLA twin), and Falcon-Mamba on "cuda" (the scan
    wrapper's). Loss within 1e-5 relative, each grad within 1e-4 of its
    leaf's largest value (`_group` says which);
  * per-block remat (`cfg.remat`) leaves the grads as they are;
  * the substrate: AdamW over 20 steps, the cosine schedule, the clip, the
    int8 compression, `batch_at`, and 3 steps of `run_training`.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.data.synthetic import SyntheticLMStream as RefStream  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.optim import compress as RC  # noqa: E402
from repro.train import loop as RL  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than a pool does, and a pool spinning beside the other test processes
    of a parallel run slows every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

B, L = 2, 24
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# reference config overrides of each model, and the port impls held to it
MODELS = {
    "full": ("llama3_2_1b", dict(attention_variant="full",
                                 attn_impl="chunked")),
    "performer": ("llama3_2_1b", dict(attention_variant="performer",
                                      attn_impl="chunked")),
    "topo1": ("llama3_2_1b", dict(attention_variant="topo", topo_degree=1,
                                  topo_attn_impl="pallas",
                                  topo_dist_scale=1.0 / L)),
    "topo2": ("llama3_2_1b", dict(attention_variant="topo", topo_degree=2,
                                  topo_attn_impl="pallas",
                                  topo_dist_scale=1.0 / L)),
    "ssm": ("falcon_mamba_7b", dict(attn_impl="chunked")),
}
CASES = [("full", dict(attn_impl="naive")),
         ("full", dict(attn_impl="chunked")),
         ("full", dict(attn_impl="cuda")),
         ("performer", dict(attn_impl="cuda")),
         ("topo1", dict(topo_attn_impl="torch")),
         ("topo2", dict(topo_attn_impl="torch")),
         ("topo1", dict(topo_attn_impl="cuda")),
         ("topo2", dict(topo_attn_impl="cuda")),
         ("ssm", dict(attn_impl="cuda"))]
# the autograd.Function each "cuda" case must have in its graph
FUNCTION = {"full": "_FlashAttentionBackward",
            "performer": "_LinearAttentionBackward",
            "topo1": "_FusedBackward", "topo2": "_FusedBackward",
            "ssm": "_ScanBackward"}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def _port_cfg(model, **over):
    arch, ref_over = MODELS[model]
    kw = {k: v for k, v in ref_over.items()
          if k not in ("attn_impl", "topo_attn_impl")}
    return get_smoke_config(arch, dtype="float32", **kw, **over)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's init, a batch and jax.value_and_grad(api.loss_fn),
    as numpy: computed once per model."""
    arch, over = MODELS[name]
    rcfg = ref_smoke(arch, dtype="float32", **over)
    params = RA.init_params(rcfg, jax.random.PRNGKey(7))
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (B, L)).astype(np.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RA.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return name, as_np(params), toks, float(loss), as_np(grads)


@pytest.fixture
def reference(request):
    return _reference(request.param)


def _functions(t) -> set:
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _port_loss_and_grads(cfg, tree, toks):
    model = convert.from_reference(cfg, tree, device="cpu")
    loss, aux = TA.loss_fn(cfg, model, {"tokens": toks}, device="cpu")
    names = _functions(loss)
    loss.backward()
    return model, float(loss.detach()), {n: p.grad for n, p in
                                model.named_parameters()}, names


def _group(name: str) -> str:
    """Grads are held leaf by leaf as the reference stacks them (one
    (num_layers, ...) tensor per block parameter), against the leaf's
    largest value. The mask scalars (coeffs and logit_scale) form one
    group: a0 and logit_scale cancel in the normalization (e^{a0} factors
    out of the mask, relu is positively homogeneous) but for phi's +1e-6,
    so their grads are rounding, below 1e-4 of a1's and a2's in both
    packages (tests/test_torch_vit.py holds the ViT's mask scalars
    together too)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = ["blocks"] + parts[2:]
        if parts[1] == "topo":
            parts = parts[:2]
    return ".".join(parts)


def _grad_errors(got: dict, want: dict) -> dict:
    top = {}
    for name, g in want.items():
        k = _group(name)
        top[k] = max(top.get(k, 0.0), float(np.abs(g).max()))
    return {name: float(np.abs(got[name].numpy().astype(np.float64)
                               - want[name]).max()) / max(top[_group(name)],
                                                          1e-30)
            for name in want}


@pytest.mark.parametrize("reference,over", CASES, indirect=["reference"],
                         ids=[f"{m}-{list(o.values())[0]}" for m, o in CASES])
def test_loss_and_grads_match_reference(reference, over):
    model, params, toks, want_loss, want_grads = reference
    cfg = _port_cfg(model, **over)
    _, loss, grads, functions = _port_loss_and_grads(cfg, params, toks)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    want = convert._state_dict(want_grads, "cpu", convert.STACKED)
    want = {k: t.numpy() for k, t in want.items()}
    assert set(want) == set(grads)
    errs = _grad_errors(grads, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert all(float(np.abs(g).max()) > 0 for n, g in want.items()
               if ".topo." not in n)
    impl = over.get("attn_impl", over.get("topo_attn_impl"))
    assert (FUNCTION[model] in functions) == (impl == "cuda"), functions


@pytest.mark.parametrize("model", ["topo2", "ssm"])
def test_remat_does_not_change_the_grads(model, monkeypatch):
    """cfg.remat wraps each block in torch.utils.checkpoint: each block
    runs again in the backward, and the grads are the same (within 1e-6
    of each tensor's largest)."""
    over = (dict(topo_attn_impl="cuda") if model == "topo2"
            else dict(attn_impl="cuda"))
    toks = np.random.default_rng(3).integers(0, 512, (B, L))
    calls = []
    block_train = TLM._block_train
    monkeypatch.setattr(TLM, "_block_train",
                        lambda *a: calls.append(1) or block_train(*a))
    grads = {}
    for remat in (True, False):
        cfg = _port_cfg(model, remat=remat, **over)
        model_ = TA.init_params(cfg, 3, device="cpu")
        calls.clear()
        loss, _ = TA.loss_fn(cfg, model_, {"tokens": toks}, device="cpu")
        loss.backward()
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
        grads[remat] = {n: p.grad for n, p in model_.named_parameters()}
    for n, g in grads[False].items():
        assert float((grads[True][n] - g).abs().max()) <= 1e-6 * max(
            float(g.abs().max()), 1e-30), n


def _tree_params(rng):
    return {"blocks": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": rng.normal(size=(4,)).astype(np.float32)},
            "embed": {"table": rng.normal(size=(7, 2)).astype(np.float32)}}


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_adamw_matches_reference_over_20_steps():
    """The same params and grads through 20 updates (clip binding in the
    first steps, weight decay on, the warmup and the cosine): params, mu
    and nu within 1e-6 of the reference's; in bfloat16 the state takes
    the reference's dtypes (mu and nu float32 after the first step)."""
    rng = np.random.default_rng(0)
    tree = _tree_params(rng)
    cfg = RO.AdamWConfig(lr=0.05, warmup_steps=5, total_steps=20,
                         clip_norm=1.0)
    grads = [{k: (rng.normal(size=v.shape) * (4.0 if s < 5 else 0.3))
              .astype(np.float32) for k, v in _flat(tree)} for s in range(20)]
    rp = jax.tree.map(jnp.asarray, tree)
    rs = RO.adamw_init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree)}
    ts = TO.adamw_init(tp)
    tcfg = TO.AdamWConfig(**{f: getattr(cfg, f) for f in
                             cfg.__dataclass_fields__})
    unflat = lambda g: {"blocks": {"w": g["blocks.w"], "b": g["blocks.b"]},  # noqa: E731
                        "embed": {"table": g["embed.table"]}}
    ref_update = jax.jit(RO.adamw_update, static_argnums=3)
    for g in grads:
        rp, rs, rm = ref_update(jax.tree.map(jnp.asarray, unflat(g)), rs, rp,
                                cfg)
        ts, tm = TO.adamw_update({k: torch.from_numpy(v) for k, v in
                                  g.items()}, ts, tp, tcfg)
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= 1e-6 * float(
            rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * \
            float(rm["grad_norm"])
    assert int(ts.step) == int(rs.step) == 20
    for (k, want), mu, nu in zip(_flat(jax.tree.map(np.asarray, rp)),
                                 dict(_flat(jax.tree.map(np.asarray,
                                                         rs.mu))).values(),
                                 dict(_flat(jax.tree.map(np.asarray,
                                                         rs.nu))).values()):
        assert _rel(tp[k], want) <= 1e-6, k
        assert _rel(ts.mu[k], mu) <= 1e-6 and _rel(ts.nu[k], nu) <= 1e-6, k
    # bfloat16 params: the state's dtypes after one step are the reference's
    rp = {"w": jnp.ones((4,), jnp.bfloat16)}
    _, rs1, _ = RO.adamw_update({"w": jnp.full((4,), 0.3, jnp.bfloat16)},
                                RO.adamw_init(rp), rp, cfg)
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    ts1, _ = TO.adamw_update({"w": torch.full((4,), 0.3,
                                              dtype=torch.bfloat16)},
                             TO.adamw_init(tp), tp, tcfg)
    assert tp["w"].dtype == torch.bfloat16
    assert str(ts1.mu["w"].dtype).endswith(str(rs1.mu["w"].dtype))
    assert str(ts1.nu["w"].dtype).endswith(str(rs1.nu["w"].dtype))


def test_schedule_clip_and_compression_match_reference():
    cfg = RO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    tcfg = TO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    want = np.array([float(RO.cosine_schedule(jnp.asarray(s), cfg))
                     for s in range(101)])
    got = np.array([float(TO.cosine_schedule(s, tcfg)) for s in range(101)])
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(want)
    rng = np.random.default_rng(5)
    g = {k: (rng.normal(size=v.shape) * 3).astype(np.float32)
         for k, v in _flat(_tree_params(rng))}
    for max_norm in (1.0, 1e3):  # binding, and not
        rc, rn = RO.clip_by_global_norm(g, max_norm)
        tc, tn = TO.clip_by_global_norm({k: torch.from_numpy(v)
                                         for k, v in g.items()}, max_norm)
        assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
        for k in g:
            assert _rel(tc[k], rc[k]) <= 1e-6, k
    rstate = RC.compressor_init(g)
    tstate = TC.compressor_init({k: torch.from_numpy(v) for k, v in
                                 g.items()})
    for step in range(3):  # the residual carried across steps
        gs = {k: (rng.normal(size=v.shape) * (step + 1)).astype(np.float32)
              for k, v in g.items()}
        rg, rstate = RC.compress_grads(gs, rstate)
        tg, tstate = TC.compress_grads({k: torch.from_numpy(v) for k, v in
                                        gs.items()}, tstate)
        for k in gs:
            assert _rel(tg[k], rg[k]) <= 1e-6, k
            assert float(np.abs(tstate.residual[k].numpy()
                                - np.asarray(rstate.residual[k])).max()) \
                <= 1e-6 * float(np.abs(gs[k]).max()), k


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 8, 64, 0),
                                                  (128256, 4, 96, 3)])
def test_batch_at_is_the_reference_bit_for_bit(vocab, batch, seq, seed):
    ours = SyntheticLMStream(vocab, batch, seq, seed=seed)
    theirs = RefStream(vocab, batch, seq, seed=seed)
    for step in (0, 1, 17):
        got, want = ours.batch_at(step), theirs.batch_at(step)
        assert got.keys() == want.keys()
        assert got["tokens"].dtype == want["tokens"].dtype
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_run_training_loss_trajectory_matches_reference(tmp_path,
                                                        monkeypatch):
    """3 steps of each package's run_training from the same weights (the
    reference's init, put in place of the port's through convert): the
    losses within 1e-4."""
    rcfg = ref_smoke("llama3_2_1b", dtype="float32")
    loop = dict(steps=3, batch_size=4, seq_len=32, ckpt_every=100,
                log_every=100, seed=2)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    want = RL.run_training(rcfg, RL.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "ref"), **loop), RO.AdamWConfig(**opt),
        verbose=False)
    tree = jax.tree.map(np.asarray, RA.init_params(
        rcfg, jax.random.PRNGKey(loop["seed"])))
    cfg = get_smoke_config("llama3_2_1b", dtype="float32")
    monkeypatch.setattr(TL.api, "init_params", lambda c, seed, device: (
        convert.from_reference(c, tree, device=device)))
    got = TL.run_training(
        cfg, TL.TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **loop),
        TO.AdamWConfig(**opt), verbose=False, device="cpu")
    assert got["losses"].shape == want["losses"].shape == (3,)
    assert np.max(np.abs(got["losses"] - want["losses"])) <= 1e-4 * np.max(
        np.abs(want["losses"]))
    assert want["losses"][-1] < want["losses"][0]
