"""The LM's logical-axis parameter sharding on the port (`launch/sharding.py`'s
parameter half over DTensor, `launch/steps.py`, AdamW and the checkpoint
over DTensors, the models' annotations and faces) against the reference.

In process: the port's `tree_param_specs` gives every parameter of every
arch but TopoViT, at full size on a (2, 4) mesh, the reference's spec (the
reference's table from its own rules in a subprocess with 8 host devices,
as tests/test_sharding_rules.py computes it; the port's from shapes alone,
on the meta device); a mesh axis is taken once a spec; `shard_q_heads`
falls back to the query length where the heads do not divide the model
axis; `shard` is a no-op with no rules.

In 4 ranks: one gloo group of 4 CPU processes on a (2, 2) mesh over
("data", "model") (`launch.mesh.run_local`, once for the module; the
per-rank work is `_torch_param_shard_worker.rank_main`) runs every case
on one device and sharded from the same weights (the port's init of seed
0, carried to the reference's layout by `models/convert.py`), while this
process computes the reference's single-device results. Each sharded result is held within the reference
test's own bound of both single-device results
(tests/test_distribution.py): the dense smoke Llama's `make_train_step`
(loss and every parameter after the step, 1e-4), the topo one's (1e-3;
"torch" against the reference's "pallas" in interpret mode, as
tests/test_torch_topo_lm.py holds it, never its "fft": C1), the V2-Lite
(with 1 and 2 dispatch groups, its routing equal per group),
Falcon-Mamba, RecurrentGemma and Seamless losses (1e-3), TopoViT's
forward with `topo_shard_plan` and the batch over data (1e-4; the mask
coefficient grads finite, non-zero and within 1e-4 of the single
device's; its fields traded between heads and rows by all_to_all, never
gathered), and the checkpoint saved on (2, 2) and restored on (1, 4) and
on one process, bitwise, then stepped once more on each."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import _torch_param_shard_worker as W  # noqa: E402
from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.steps import make_train_step as ref_step  # noqa: E402
from repro.models import api as RA  # noqa: E402
from repro.models import vit as RV  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import convert, encdec, lm  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

CPU = "cpu"
RANKS = 4
STEP_TOL = 1e-4  # tests/test_distribution.py:52-55
TOPO_TOL = 1e-3  # tests/test_distribution.py:185-189
ARCH_TOL = 1e-3  # tests/test_distribution.py:86
VIT_TOL = 1e-4  # tests/test_distribution.py:134
B, L = 8, 32  # tests/test_distribution.py's batch
# (arch, the reference's overrides, the port's) of each case
CASES = {
    "dense": ("llama3_2_1b", {}, {}),
    "topo": ("llama3_2_1b",
             dict(attention_variant="topo", topo_degree=2,
                  topo_dist_scale=1.0 / L, topo_attn_impl="pallas"),
             dict(attention_variant="topo", topo_degree=2,
                  topo_dist_scale=1.0 / L, topo_attn_impl="torch")),
    "moe": ("deepseek_v2_lite_16b", {}, {}),
    "moe_groups": ("deepseek_v2_lite_16b", dict(moe_groups=2),
                   dict(moe_groups=2)),
    "ssm": ("falcon_mamba_7b", {}, {}),
    "hybrid": ("recurrentgemma_2b", {}, {}),
    "encdec": ("seamless_m4t_medium", {}, {}),
}
STEPS = ("dense", "topo")


class _Mesh:
    """The shape of a (data, model) mesh, all that `tree_param_specs`
    reads of one (no process group)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self._sizes = (data, model)

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]


def _norm(spec) -> tuple:
    """A spec as a tuple of axis names or None (a 1-tuple as its name)."""
    out = []
    for ax in spec:
        if isinstance(ax, (tuple, list)):
            ax = tuple(ax)
            ax = ax[0] if len(ax) == 1 else (ax or None)
        out.append(ax)
    return tuple(out)


def _reference_specs() -> dict:
    code = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs.base import ARCHS, get_config
from repro.launch import sharding as SH
from repro.launch.specs import params_shapes

mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in ARCHS:
    if arch == "topovit_b16":
        continue
    with SH.use_sharding(mesh):
        shapes = params_shapes(get_config(arch))
        specs = SH.tree_param_specs(shapes)
    flat = jax.tree_util.tree_leaves_with_path(specs,
                                               is_leaf=lambda x: x is None or
                                               isinstance(x, jax.sharding.PartitionSpec))
    out[arch] = {"/".join(p.key if hasattr(p, "key") else str(p)
                          for p in path): [list(a) if isinstance(a, tuple)
                                           else a for a in spec]
                 for path, spec in flat}
print("SPECS" + json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    line = next((s for s in res.stdout.splitlines()
                 if s.startswith("SPECS")), None)
    assert line, res.stderr[-2000:]
    return json.loads(line[len("SPECS"):])


def _reference_path(cfg, name: str):
    """(the reference's '/'-joined path of the port's parameter `name`,
    whether its leaf is stacked over layers)."""
    stacks = convert._stacks(cfg)
    parts = name.split(".")
    owner = (convert._owner(stacks, parts[0], int(parts[1]))
             if len(parts) > 2 and parts[1].isdigit() else None)
    if owner is None:
        return "/".join(parts), False
    place, _, stacked = owner
    return "/".join(place.split(".") + parts[2:]), stacked


def test_param_specs_match_reference():
    """Every parameter of every arch but TopoViT, at full size on a (2, 4)
    mesh: the reference's spec (its stacked leaves' leading None dropped),
    divisibility fallback included."""
    ref = _reference_specs()
    mesh = _Mesh(2, 4)
    n_sharded = 0
    for arch in ARCHS:
        if arch == "topovit_b16":
            continue
        cfg = get_config(arch)
        model = (encdec.EncDecLM if cfg.is_encdec else lm.DecoderLM)(
            cfg, device="meta")
        with SH.use_sharding(mesh):
            specs = SH.tree_param_specs(model)
        assert len(specs) == sum(1 for _ in model.parameters())
        for name, spec in specs.items():
            path, stacked = _reference_path(cfg, name)
            want = _norm(ref[arch][path])
            if stacked:
                assert want[0] is None, (arch, path, want)
                want = want[1:]
            assert _norm(spec) == want, (arch, name, spec, want)
            n_sharded += any(ax is not None for ax in spec)
    assert n_sharded > 0


def test_logical_rules_once_per_spec_and_noop():
    mesh = _Mesh(2, 4)
    x = torch.ones(8, 4, 6, 2)
    assert SH.logical_to_spec(("batch", "heads")) == ()
    assert SH.shard(x, ("batch", None, "heads", None)) is x
    with SH.use_sharding(mesh):
        # heads and ff both map to model: only the first takes it
        assert SH.logical_to_spec(("batch", "heads", "ff")) == (
            ("data",), "model", None)
        assert SH.param_spec_for_path("blocks.3.attn.wq", 2) == (None,
                                                                  "model")
        assert SH.param_spec_for_path("blocks.0.moe.experts_w_out", 3) == (
            "model", None, None)
        # a plain tensor under rules is left as it is
        assert SH.shard(x, ("batch", None, "heads", None)) is x
        assert SH.shard_q_heads(x) is x


class _Probe:
    """Records the logical spec `shard` is asked for, as DTensor x would
    redistribute to it (`shard_q_heads` on a query of H heads)."""

    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


def test_shard_q_heads_falls_back_to_query_length(monkeypatch):
    """Heads over the model axis where they divide it; else (llava 56,
    qwen2 12, recurrentgemma 10 on a 16-way model axis) the query length;
    else the batch only (the reference's `:207-232`)."""
    asked = []
    monkeypatch.setattr(SH, "is_dtensor", lambda x: True)
    monkeypatch.setattr(SH, "shard", lambda x, logical: asked.append(
        logical) or x)
    with SH.use_sharding(_Mesh(16, 16)):
        for H, Lq in ((32, 64), (56, 64), (12, 4096), (10, 1), (10, 30)):
            SH.shard_q_heads(_Probe((8, Lq, H, 64)))
    assert asked == [("batch", None, "heads", None),
                     ("batch", "heads", None, None),
                     ("batch", "heads", None, None),
                     ("batch", None, None, None),
                     ("batch", None, None, None)]


def _ref_cfg(name):
    arch, over, _ = CASES[name]
    return ref_smoke(arch, dtype="float32", **over)


def _port_cfg(name):
    arch, _, over = CASES[name]
    return get_smoke_config(arch, dtype="float32", **over)


def _batch(cfg, r) -> dict:
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, L)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = r.normal(size=(B, 48, 1024)).astype(
            np.float32)
    return batch


def _sd(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _port_sd(cfg, tree) -> dict:
    return _sd(convert.from_reference(cfg, tree, device=CPU))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the reference's single-device results and the 4 ranks'
    results of every case."""
    r = np.random.default_rng(0)
    case, models = {}, {}
    for name in CASES:
        cfg = _port_cfg(name)
        models[name] = TA.init_params(cfg, 0, device=CPU)
        case[name] = dict(arch=CASES[name][0], over=dict(
            dtype="float32", **CASES[name][2]), sd=_sd(models[name]),
            **_batch(cfg, r))
    vmodel = TV.init_params(get_smoke_config(
        "topovit_b16", dtype="float32", topo_attn_impl="torch"), 0,
        num_classes=10, patch_dim=48, device=CPU)
    case["vit"] = dict(sd=_sd(vmodel), patches=r.normal(
        size=(B, vmodel.cfg.num_prefix_embeddings, 48)).astype(np.float32),
        W=r.normal(size=(B, 10)).astype(np.float32))
    case["ckpt_dir"] = str(tmp_path_factory.mktemp("ckpt"))
    # the ranks run while this process computes the reference (jitted)
    pool = ThreadPoolExecutor(1)
    done = pool.submit(TM.run_local, W.rank_main, RANKS, (case,),
                       timeout=600)
    # the same weights carried to the reference's layout
    ref = {}
    ocfg = RO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          weight_decay=0.0)
    for name, model in models.items():
        rcfg = _ref_cfg(name)
        params = jax.tree.map(jnp.asarray, convert.to_reference(model))
        b = {k: jnp.asarray(case[name][k]) for k in ("tokens", "src_embeds")
             if k in case[name]}
        if name in STEPS:
            p1, _, m1 = jax.jit(ref_step(rcfg, ocfg))(
                params, RO.adamw_init(params), b)
            ref[name] = (float(m1["loss"]), _port_sd(
                _port_cfg(name), jax.tree.map(np.asarray, p1)))
        else:
            ref[name] = float(jax.jit(lambda p, bb, c=rcfg: RA.loss_fn(
                c, p, bb)[0])(params, b))
    vcfg = ref_smoke("topovit_b16").replace(dtype="float32",
                                            topo_attn_impl="fft")
    ref["vit"] = np.asarray(RV.forward(
        vcfg, jax.tree.map(jnp.asarray, convert.vit_to_reference(vmodel)),
        jnp.asarray(case["vit"]["patches"]), RV.build_grid_integrator(vcfg)))
    try:
        results = done.result()
    finally:
        pool.shutdown()
    return case, ref, results


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
               for k in a)


@pytest.mark.parametrize("name", STEPS)
def test_sharded_train_step(ranks, name):
    """`make_train_step` on the (2, 2) mesh against one device: the port's
    and the reference's, loss and every parameter after the step."""
    _, ref, results = ranks
    tol = STEP_TOL if name == "dense" else TOPO_TOL
    res = results[0][name]
    ref_loss, ref_params = ref[name]
    d_single = _max_diff(res["params"], res["single_params"])
    d_ref = _max_diff(res["params"], ref_params)
    print(f"{name}: loss {res['loss']:.8f} single {res['single_loss']:.8f} "
          f"reference {ref_loss:.8f}; params vs single {d_single:.3e}, "
          f"vs reference {d_ref:.3e}")
    assert abs(res["loss"] - res["single_loss"]) < tol
    assert abs(res["loss"] - ref_loss) < tol
    assert d_single < tol and d_ref < tol
    for other in results[1:]:  # every rank holds the same state
        assert _max_diff(other[name]["params"], res["params"]) == 0.0


def test_c10d_route_is_the_functional_collectives(ranks):
    """DTensor's functional collectives run through `torch.distributed`'s
    own calls (`collectives.C10dRoute`, what gloo ranks on a card use),
    taken here on CPU tensors: the sharded dense step is the same."""
    _, _, results = ranks
    for rank in results:
        got, want = rank["routed"], rank["dense"]
        assert got["calls"] > 0
        assert got["loss"] == want["loss"]
        assert _max_diff(got["params"], want["params"]) <= 1e-6


@pytest.mark.parametrize("name", ["moe", "moe_groups", "ssm", "hybrid",
                                  "encdec"])
def test_sharded_losses(ranks, name):
    """The smoke archs' losses on the (2, 2) mesh against one device; the
    MoE's routing on each rank equals the single device's on the rank's
    groups (the whole batch where the groups do not divide over data)."""
    _, ref, results = ranks
    res = results[0][name]
    print(f"{name}: loss {res['loss']:.8f} single {res['single_loss']:.8f} "
          f"reference {ref[name]:.8f}")
    assert abs(res["loss"] - res["single_loss"]) < ARCH_TOL
    assert abs(res["loss"] - ref[name]) < ARCH_TOL
    if "routing" not in res:
        return
    single = res["single_routing"]
    for rank in results:
        got = rank[name]["routing"]
        # ranks (d, m): data coordinate d = rank // 2 of the (2, 2) mesh
        groups = len(single) // len(CASES_LAYERS[name])
        per = len(got) // len(CASES_LAYERS[name])
        d = rank["rank"] // 2 if per < groups else 0
        want = [rec for layer in range(len(CASES_LAYERS[name]))
                for rec in single[layer * groups + d * per:
                                  layer * groups + (d + 1) * per]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["C"] == w["C"]
            np.testing.assert_array_equal(g["expert_ids"], w["expert_ids"])
            np.testing.assert_array_equal(g["keep"], w["keep"])


# the MoE layers of the smoke V2-Lite (layer kinds after the dense ones)
CASES_LAYERS = {
    name: [k for k in lm.layer_kinds(_port_cfg(name)) if k == "moe"]
    for name in ("moe", "moe_groups")}


def test_sharded_topovit(ranks):
    """TopoViT with `topo_shard_plan` (the plan over the model axis), the
    batch over data: logits against one device's, the port's and the
    reference's; the mask coefficients' grads finite, non-zero and the
    single device's."""
    _, ref, results = ranks
    res = results[0]["vit"]
    d_single = float(np.max(np.abs(res["logits"] - res["single_logits"])))
    d_ref = float(np.max(np.abs(res["logits"] - ref["vit"])))
    g, g1 = res["coeff_grads"], res["single_coeff_grads"]
    dg = float(np.max(np.abs(g - g1)) / np.max(np.abs(g1)))
    print(f"vit: logits vs single {d_single:.3e}, vs reference "
          f"{d_ref:.3e}; coeff grads {dg:.3e} of their max; "
          f"{res['placements']}")
    assert "Shard(dim=0)" in res["placements"]
    assert d_single < VIT_TOL and d_ref < VIT_TOL
    assert np.all(np.isfinite(g)) and np.sum(np.abs(g)) > 0
    assert dg < VIT_TOL


def test_sharded_topovit_exchanges_heads_for_rows(ranks):
    """ROADMAP C12, repaired: the sharded model's TopoViT with
    `topo_shard_plan` trades each rank's heads of every row (its slab
    (B/D, H/M, L, .)) for every head of its rows by all_to_all over the
    model axis: one exchange of qf, kf and v together and one of the
    attention output back, 2 a layer in the forward and their 2 VJPs in
    the backward. No field (a heads slab or a row block (B/D, H, L/M, hd),
    or any 4-D tensor) is all_gathered either way, and a rank receives at
    most half the bytes a layer that gathering the fields whole would (3
    heads slabs in, the rows out: 4 all_gathers, each receiving (M - 1) /
    M of a field)."""
    _, _, results = ranks
    cfg = get_smoke_config("topovit_b16")
    B = results[0]["vit"]["logits"].shape[0]
    L, H, hd, layers = (cfg.num_prefix_embeddings, cfg.num_heads,
                        cfg.head_dim, cfg.num_layers)
    D = M = 2  # the (2, 2) mesh: data, model
    heads, rows = (B // D, H // M, L, hd), (B // D, H, L // M, hd)
    into = (M * -(-L // M), B // D, H // M, 3 * hd)  # qf, kf, v: m == hd
    out = into[:3] + (hd,)
    field = B // D * H * L * hd * 4  # float32
    gathered = 4 * (M - 1) / M * field
    for r in results:
        for key in ("forward_sent", "backward_sent"):
            sent = r["vit"][key]
            assert not any(kind == "all_gather" and (
                shape in (heads, rows) or len(shape) == 4)
                for kind, shape, _ in sent), key
            fields = [(shape, n) for kind, shape, n in sent
                      if kind == "all_to_all" and len(shape) == 4]
            assert sorted(s for s, _ in fields) == sorted(
                [into] * layers + [out] * layers), key
            received = sum(n for _, n in fields) * (M - 1) / M / layers
            assert received <= gathered / 2, (key, received, gathered)


def test_checkpoint_restores_across_meshes(ranks):
    """Saved on (2, 2), restored on (1, 4) and on one process, bitwise;
    one more step on each agrees within the step's bound."""
    case, _, results = ranks
    res = results[0]["ckpt"]
    assert all(r["ckpt"]["restore14_bitwise"] for r in results)
    assert "Shard" in "".join(res["placements14"].values())
    cfg = _port_cfg("dense")
    one = W.model_of(cfg, case["dense"]["sd"])
    opt = adamw_init(dict(one.named_parameters()))
    mgr = CheckpointManager(case["ckpt_dir"])
    got = mgr.restore(one, opt)
    assert got["step"] == 1
    saved = results[0]["dense"]["params"]  # the (2, 2) state at the save
    for n, p in one.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved[n])
    _, _, m1 = TS.make_train_step(cfg, W.OPT, device=CPU)(
        one, opt, {"tokens": case["dense"]["tokens"]})
    params1 = {n: p.detach().numpy() for n, p in one.named_parameters()}
    d14 = _max_diff(res["params14"], res["params22"])
    d1 = _max_diff(params1, res["params22"])
    print(f"after one more step: (1, 4) vs (2, 2) {d14:.3e}, one process "
          f"vs (2, 2) {d1:.3e}; losses {res['loss22']:.8f} "
          f"{res['loss14']:.8f} {float(m1['loss']):.8f}")
    assert d14 < STEP_TOL and d1 < STEP_TOL
    assert abs(res["loss14"] - res["loss22"]) < STEP_TOL
    assert abs(float(m1["loss"]) - res["loss22"]) < STEP_TOL
