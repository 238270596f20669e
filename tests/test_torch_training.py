"""The port's training substrate, the counterpart of tests/test_training.py
run on `repro_torch`: AdamW on a quadratic, the cosine schedule's shape,
int8 error-feedback compression, the loop's convergence on the smoke
Llama (full attention: its step is the cheapest on the CPU), microbatches
with compression, the straggler watchdog; and the training CLI, the
loss's reference formula and what the loss refuses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.layers import cross_entropy_loss  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update, cosine_schedule)
from repro_torch.optim.compress import (compress_grads,  # noqa: E402
                                        compressor_init)
from repro_torch.train.loop import (StragglerWatchdog,  # noqa: E402
                                    TrainLoopConfig, run_training)


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than a pool does, and a pool spinning beside the other test processes
    of a parallel run slows every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quadratic(steps, lr, compress):
    params = {"w": torch.tensor(np.linspace(-2, 2, 16) if compress
                                else [3.0, -2.0], dtype=torch.float32)}
    cfg = AdamWConfig(lr=lr, weight_decay=0.0, warmup_steps=1,
                      total_steps=steps, clip_norm=100.0 if compress
                      else 10.0)
    state = adamw_init(params)
    cstate = compressor_init(params) if compress else None
    for _ in range(steps):
        g = {"w": 2.0 * params["w"]}  # d/dw sum(w^2)
        if compress:
            g, cstate = compress_grads(g, cstate)
        state, _ = adamw_update(g, state, params, cfg)
    return float((params["w"] ** 2).sum())


def test_adamw_quadratic_convergence():
    assert _quadratic(300, 0.1, compress=False) < 1e-3


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(s, cfg)) for s in range(101)]
    assert lrs[0] < 0.2 and abs(lrs[10] - 1.0) < 1e-6
    assert abs(lrs[100] - 0.1) < 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # decay


def test_compression_error_feedback_converges():
    """int8 EF compression still drives the quadratic to zero."""
    assert _quadratic(500, 0.05, compress=True) < 1e-2


def test_training_loss_decreases(tmp_path):
    cfg = get_smoke_config("llama3_2_1b", dtype="float32")
    loop = TrainLoopConfig(steps=150, batch_size=8, seq_len=64,
                           ckpt_dir=str(tmp_path / "ck"), ckpt_every=1000,
                           log_every=1000)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=150,
                      weight_decay=0.0)
    res = run_training(cfg, loop, opt, verbose=False, device="cpu")
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert last < first - 0.3, f"{first} -> {last}"


def test_training_with_microbatches_and_compression(tmp_path):
    """The reference's case takes qwen2_1_5b (test_torch_lm_configs.py runs
    it on the port); here the smoke Llama-3.2-1B with the topo mask at degree
    2 on impl "cuda" (the fused sweep's autograd.Function), 2 microbatches
    and int8 compression; the accumulated grads are the microbatches'
    mean."""
    cfg = get_smoke_config("llama3_2_1b", dtype="float32",
                           attention_variant="topo", topo_degree=2,
                           topo_attn_impl="cuda", topo_dist_scale=1.0 / 32)
    loop = TrainLoopConfig(steps=10, batch_size=4, seq_len=32,
                           microbatches=2, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=50, compress_grads=True, log_every=100)
    res = run_training(cfg, loop, verbose=False, device="cpu")
    assert res["losses"].shape == (10,) and np.isfinite(res["losses"]).all()


def test_microbatch_grads_are_the_mean_over_microbatches():
    from repro_torch.train.loop import make_accumulating_step

    cfg = get_smoke_config("llama3_2_1b", dtype="float32")
    toks = torch.tensor(np.random.default_rng(1).integers(0, 512, (4, 16)))
    seen = {}

    def grads_of(microbatches):
        model = api.init_params(cfg, 5, device="cpu")
        opt = AdamWConfig(lr=0.0, weight_decay=0.0)  # lr 0: params stay
        step = make_accumulating_step(cfg, opt, microbatches, False, "cpu")
        batch = toks if microbatches == 1 else toks.reshape(2, 2, 16)
        state, _, metrics = step(model, adamw_init(dict(
            model.named_parameters())), None, {"tokens": batch})
        seen[microbatches] = metrics["loss"]
        return state.mu  # (1 - b1) g after one step

    one, two = grads_of(1), grads_of(2)
    halves = []
    for h in range(2):
        model = api.init_params(cfg, 5, device="cpu")
        loss, _ = api.loss_fn(cfg, model, {"tokens": toks[2 * h:2 * h + 2]},
                              device="cpu")
        halves.append(float(loss.detach()))
    assert abs(float(seen[2]) - np.mean(halves)) <= 1e-6 * abs(float(seen[2]))
    # equal token counts per microbatch: the mean of the microbatch grads is
    # the full batch's grad
    for k in one:
        assert float((one[k] - two[k]).abs().max()) <= 1e-5 * max(
            float(one[k].abs().max()), 1e-30), k


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0, warmup=3)
    for s in range(10):
        wd.observe(s, 0.1)
    assert wd.observe(10, 0.5)  # 5x the EMA -> flagged
    assert wd.events and wd.events[-1][0] == 10
    assert not wd.observe(11, 0.11)


def test_cross_entropy_loss_is_the_reference_formula():
    """Mean over unmasked tokens of logsumexp - gold + 1e-4 logsumexp^2 in
    float32; labels outside [0, V) masked; all masked gives 0."""
    rng = np.random.default_rng(2)
    logits = torch.tensor(rng.normal(size=(2, 5, 7)) * 3, dtype=torch.bfloat16)
    labels = torch.tensor([[0, 6, -1, 3, 7], [2, 2, 5, -5, 1]])
    got = cross_entropy_loss(logits, labels, 7)
    lf = logits.double()
    logz = torch.logsumexp(lf, -1)
    ok = (labels >= 0) & (labels < 7)
    gold = lf.gather(-1, labels.clamp(0, 6)[..., None])[..., 0]
    want = ((logz - gold + 1e-4 * logz ** 2) * ok).sum() / ok.sum()
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert float(cross_entropy_loss(logits, torch.full((2, 5), -1), 7)) == 0


def test_loss_refuses_what_is_not_ported():
    """The vlm family is ported (ROADMAP A10b): its loss refuses a batch
    without the patch embeddings it reads ahead of the tokens."""
    cfg = get_smoke_config("llama3_2_1b", dtype="float32", family="vlm")
    model = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        api.loss_fn(cfg, model, {"tokens": np.zeros((1, 8), np.int32)},
                    device="cpu")


def test_training_cli_runs_on_the_cpu(tmp_path, capsys):
    res = launch_train.main([
        "--arch", "llama3_2_1b", "--smoke", "--variant", "topo",
        "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"])
    assert "final loss" in capsys.readouterr().out
    assert np.isfinite(res["losses"]).all() and res["losses"].shape == (2,)
    cfg = launch_train.config_from_args(type("A", (), dict(
        arch="llama3_2_1b", smoke=False, variant="topo", seq=2048))())
    assert (cfg.attention_variant, cfg.topo_attn_impl, cfg.dtype,
            cfg.num_layers, cfg.topo_dist_scale) == ("topo", "cuda",
                                                     "bfloat16", 16,
                                                     1.0 / 2048)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000001", "step_0000000002"]
