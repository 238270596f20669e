"""`launch/steps.py` on one CPU device against the reference's: a train step
(the loss, AdamW's grad norm and lr, every parameter after it), a prefill
step (the last position's logits) and a serve step (the greedy token and
the decode cache), from the same weights (the reference's init, through
`models/convert.py`) and inputs, by the existing parity bounds
(tests/test_torch_train_parity.py, tests/test_torch_dense_lm.py, and
tests/test_distribution.py:52-55 for the parameters after a step)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402

CPU = "cpu"
LOSS_TOL = 1e-5  # tests/test_torch_train_parity.py, relative
STEP_TOL = 1e-4  # tests/test_distribution.py:52-55
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5  # tests/test_torch_dense_lm.py
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _models(arch):
    rcfg = ref_smoke(arch, dtype="float32")
    tree = jax.tree.map(np.asarray, RA.init_params(rcfg,
                                                   jax.random.PRNGKey(3)))
    cfg = get_smoke_config(arch, dtype="float32")
    return rcfg, tree, cfg, convert.from_reference(cfg, tree, device=CPU)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "falcon_mamba_7b"])
def test_train_step_matches_reference(arch):
    rcfg, tree, cfg, model = _models(arch)
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (4, 24)).astype(np.int32)
    p = jax.tree.map(jnp.asarray, tree)
    p1, _, m1 = jax.jit(RS.make_train_step(rcfg, RO.AdamWConfig(**OPT)))(
        p, RO.adamw_init(p), {"tokens": jnp.asarray(toks)})
    opt = TO.adamw_init(dict(model.named_parameters()))
    _, opt, m = TS.make_train_step(cfg, TO.AdamWConfig(**OPT), device=CPU)(
        model, opt, {"tokens": toks})
    assert abs(float(m["loss"]) - float(m1["loss"])) <= LOSS_TOL * abs(
        float(m1["loss"]))
    for key in ("grad_norm", "lr"):
        assert _rel(float(m[key]), float(m1[key])) <= 1e-5, key
    assert int(opt.step) == 1
    want = convert.from_reference(cfg, jax.tree.map(np.asarray, p1),
                                  device=CPU).state_dict()
    worst = max(float((t - want[n]).abs().max())
                for n, t in model.state_dict().items())
    assert worst < STEP_TOL, worst


def test_prefill_and_serve_steps_match_reference():
    rcfg, tree, cfg, model = _models("llama3_2_1b")
    toks = np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (2, 16)).astype(np.int32)
    p = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(RS.make_prefill_step(rcfg)(
        p, {"tokens": jnp.asarray(toks)}))
    got = TS.make_prefill_step(cfg, device=CPU)(model, {"tokens": toks})
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= LOGIT_TOL

    S = 8
    rcache = RA.init_cache(rcfg, 2, S)
    tcache = TA.init_cache(cfg, 2, S, device=CPU)
    rstep = jax.jit(RS.make_serve_step(rcfg, S))
    tstep = TS.make_serve_step(cfg, S, device=CPU)
    rtok = ttok = toks[:, :1]
    for pos in range(3):
        rtok, rcache = rstep(p, rcache, jnp.asarray(rtok), pos)
        ttok, tcache = tstep(model, tcache, ttok, pos)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))
        assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (2, 1)
    rflat = jax.tree_util.tree_leaves_with_path(rcache)
    for path, leaf in rflat:
        node = tcache
        for key in path:
            node = node[key.key]
        assert _rel(node.numpy(), np.asarray(leaf)) <= CACHE_TOL, path
