"""Fault tolerance of the port, the counterpart of
tests/test_fault_tolerance.py run on `repro_torch`: a crash and restart
resumes bit-identically, checkpoints publish atomically and keep k, the
optimizer state round-trips exactly, bfloat16 tensors round-trip bit for
bit (as 16-bit patterns: numpy has no bfloat16), and a `params.npz` that
the reference's manager wrote restores into the port through `convert`.
Restoring under another sharding (the reference's elastic case) comes
with ROADMAP A12b, the parameter sharding."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than a pool does, and a pool spinning beside the other test processes
    of a parallel run slows every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_crash_restart_bit_identical(tmp_path):
    cfg = get_smoke_config("llama3_2_1b", dtype="float32")
    common = dict(batch_size=4, seq_len=32, ckpt_every=5, log_every=1000)

    # uninterrupted run
    loopA = TrainLoopConfig(steps=14, ckpt_dir=str(tmp_path / "A"), **common)
    resA = run_training(cfg, loopA, verbose=False, device="cpu")

    # interrupted at step 9 (after the step-5 checkpoint), then restarted
    loopB1 = TrainLoopConfig(steps=14, ckpt_dir=str(tmp_path / "B"),
                             fail_at_step=9, **common)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(cfg, loopB1, verbose=False, device="cpu")
    loopB2 = TrainLoopConfig(steps=14, ckpt_dir=str(tmp_path / "B"), **common)
    resB = run_training(cfg, loopB2, verbose=False, device="cpu")

    # identical final params and optimizer state (data keyed by step)
    sdA, sdB = resA["params"].state_dict(), resB["params"].state_dict()
    assert sdA.keys() == sdB.keys()
    for k in sdA:
        assert torch.equal(sdA[k], sdB[k]), k
    for part in ("mu", "nu"):
        for k, t in getattr(resA["opt_state"], part).items():
            assert torch.equal(t, getattr(resB["opt_state"], part)[k]), k
    assert int(resA["opt_state"].step) == int(resB["opt_state"].step) == 14
    # and the post-resume loss trajectory matches the uninterrupted one
    np.testing.assert_allclose(resA["losses"][10:], resB["losses"][-4:],
                               rtol=1e-6)


def test_checkpoint_atomicity_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.arange(5, dtype=torch.float32),
              "b.c": torch.ones((2, 3))}
    for s in (5, 10, 15, 20):
        mgr.save(s, params)
    assert mgr.all_steps() == [15, 20]  # keep=2 collected older ones
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a save that died before its rename leaves a .tmp that is never read
    os.makedirs(tmp_path / "step_0000000025.tmp")
    like = {"a": torch.zeros(5), "b.c": torch.zeros((2, 3))}
    res = mgr.restore(like)
    assert res["step"] == 20 and mgr.latest_step() == 20
    assert torch.equal(like["a"], torch.arange(5, dtype=torch.float32))
    assert CheckpointManager(str(tmp_path / "empty")).restore(like) is None


def test_restore_roundtrip_structure(tmp_path):
    """The AdamW state (a NamedTuple of a step and two dicts) and a model's
    params round-trip exactly, into live tensors, after a real update
    (mu and nu are float32 then, for bfloat16 params as in the
    reference)."""
    cfg = get_smoke_config("llama3_2_1b")  # bfloat16
    model = TA.init_params(cfg, 1, device="cpu")
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(
        i)).to(p.dtype) for i, (k, p) in enumerate(params.items())}
    opt, _ = adamw_update(grads, opt, params, AdamWConfig())
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(3, model, opt, extra={"note": "x"})
    like_model = TA.init_params(cfg, 2, device="cpu")
    like_opt = type(opt)(torch.zeros((), dtype=torch.int32),
                         {k: torch.zeros_like(t) for k, t in opt.mu.items()},
                         {k: torch.zeros_like(t) for k, t in opt.nu.items()})
    res = mgr.restore(like_model, like_opt)
    assert res["step"] == 3 and res["meta"]["extra"] == {"note": "x"}
    assert int(like_opt.step) == 1
    for part in ("mu", "nu"):
        for k, t in getattr(opt, part).items():
            assert t.dtype == torch.float32
            assert torch.equal(getattr(like_opt, part)[k], t), k
    for k, t in model.state_dict().items():
        assert torch.equal(like_model.state_dict()[k], t), k


def test_bfloat16_roundtrip_is_bitwise(tmp_path):
    """bfloat16 travels as its 16-bit pattern with its dtype in meta.json:
    every pattern (subnormals, inf, nan, -0) comes back bit for bit."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16)
    t = bits.view(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, {"t": t, "f": torch.ones(3)})
    meta = json.loads((tmp_path / "step_0000000001" / "meta.json")
                      .read_text())
    assert meta["dtypes"]["params"] == {"t": "bfloat16", "f": "float32"}
    like = {"t": torch.zeros_like(t), "f": torch.zeros(3)}
    mgr.restore(like)
    assert like["t"].dtype == torch.bfloat16
    assert torch.equal(like["t"].view(torch.int16), bits)


def test_reference_params_npz_restores_into_the_port(tmp_path):
    """A checkpoint that the reference's manager wrote (its stacked param
    tree, float32) restores into the port through `convert`: the same
    weights, bit for bit, as converting the live tree."""
    rcfg = ref_smoke("llama3_2_1b", dtype="float32")
    params = RA.init_params(rcfg, jax.random.PRNGKey(4))
    RefManager(str(tmp_path), keep=1).save(7, params)
    tree: dict = {}
    with np.load(tmp_path / "step_0000000007" / "params.npz") as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    cfg = get_smoke_config("llama3_2_1b", dtype="float32")
    model = convert.from_reference(cfg, tree, device="cpu")
    want = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    assert want.state_dict().keys() == model.state_dict().keys()
    for k, t in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k


def test_bfloat16_resume_casts_the_moments_like_the_reference(tmp_path):
    """A bfloat16 run resumed through run_training: the params come back bit
    for bit, but mu and nu (float32 from the first update) are restored
    into adamw_init's state, in the params' dtype, so they come back cast
    to bfloat16, and a bfloat16 resume is not bit-identical to an
    uninterrupted run. The reference's restore casts the same way
    (`arr.astype(ref.dtype)`): the same bits as the port's cast."""
    cfg = get_smoke_config("llama3_2_1b")  # bfloat16
    loop = TrainLoopConfig(steps=2, batch_size=4, seq_len=32, ckpt_every=2,
                           log_every=1000, ckpt_dir=str(tmp_path / "port"))
    live = run_training(cfg, loop, verbose=False, device="cpu")
    back = run_training(cfg, loop, verbose=False, device="cpu")
    assert len(back["losses"]) == 0
    for k, t in live["params"].state_dict().items():
        assert torch.equal(back["params"].state_dict()[k], t), k
    assert int(back["opt_state"].step) == int(live["opt_state"].step) == 2
    for part in ("mu", "nu"):
        for k, t in getattr(live["opt_state"], part).items():
            got = getattr(back["opt_state"], part)[k]
            assert t.dtype == torch.float32 and got.dtype == torch.bfloat16
            assert torch.equal(got, t.to(torch.bfloat16)), k
    # the reference's manager, one live moment saved in float32 and
    # restored into bfloat16 zeros
    name, m = next(iter(live["opt_state"].mu.items()))
    mgr = RefManager(str(tmp_path / "ref"), keep=1)
    mgr.save(2, {"m": m.numpy()})
    got = mgr.restore({"m": jax.numpy.zeros(m.shape, jax.numpy.bfloat16)})
    ref_bits = np.asarray(got["params"]["m"]).view(np.int16)
    assert got["params"]["m"].dtype == jax.numpy.bfloat16
    np.testing.assert_array_equal(
        ref_bits, back["opt_state"].mu[name].view(torch.int16).numpy())
