"""Port of TopoViT (models/vit.py, configs/topovit_b16.py) against the
reference's `vit.forward`, on the smoke `topovit_b16` in float32 with the
reference's `vit.init_params` carried across by `convert.vit_from_reference`:
logits on every impl, the impl parity, the mask scalars' gradients of every
layer against `jax.grad`, the converter round trip, a grid plan installed
from the reference's `ftfi.save_plan` artifact, the "performer" variant,
the full config, and the entry points' refusals."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import ftfi as RF  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import vit as RV  # noqa: E402
from repro_torch import ftfi as TF  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import masks as TMK  # noqa: E402
from repro_torch.core.lru import BoundedLRU  # noqa: E402
from repro_torch.graphs.graph import grid_graph  # noqa: E402
from repro_torch.graphs.mst import minimum_spanning_tree  # noqa: E402
from repro_torch.kernels.fdist_matvec import ops as fdist_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402

CLASSES, PATCH_DIM, B = 10, 32, 2
REF_IMPL = {"ref": "ref", "torch": "fft", "fft": "fft", "cuda": "pallas"}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _rcfg(impl, **kw):
    return ref_smoke("topovit_b16").replace(
        **{"dtype": "float32", "topo_attn_impl": impl, **kw})


def _tcfg(impl, **kw):
    return get_smoke_config("topovit_b16",
                            **{"dtype": "float32", "topo_attn_impl": impl,
                               **kw})


def _ref_logits(rcfg, params, patches):
    integ = RV.build_grid_integrator(rcfg)
    return np.asarray(RV.forward(rcfg, params, jnp.asarray(patches), integ))


@pytest.fixture(scope="module")
def ref_vit():
    """The reference's weights (mask scalars away from their init, so every
    coefficient matters), patches and logits on each of its impls."""
    params = RV.init_params(_rcfg("fft"), jax.random.PRNGKey(0),
                            num_classes=CLASSES, patch_dim=PATCH_DIM)
    r = np.random.default_rng(0)
    topo = params["blocks"]["topo"]
    params["blocks"]["topo"] = {
        "coeffs": jnp.asarray(r.uniform(-0.5, 0.5, topo["coeffs"].shape),
                              jnp.float32),
        "logit_scale": jnp.asarray(r.uniform(-0.3, 0.3,
                                             topo["logit_scale"].shape),
                                   jnp.float32)}
    patches = r.normal(size=(B, 16, PATCH_DIM)).astype(np.float32)
    logits = {impl: _ref_logits(_rcfg(impl), params, patches)
              for impl in ("ref", "fft", "pallas")}
    return params, jax.tree.map(np.asarray, params), patches, logits


def _model(impl, tree, **kw):
    cfg = _tcfg(impl, **kw)
    return cfg, convert.vit_from_reference(cfg, tree, device="cpu")


@pytest.mark.parametrize("impl", ["ref", "torch", "fft", "cuda"])
def test_logits_match_reference(ref_vit, impl):
    _, tree, patches, logits = ref_vit
    cfg, model = _model(impl, tree)
    before = fdist_ops.LAUNCHES
    with torch.no_grad():
        got = TV.forward(cfg, model, patches, device="cpu")
    assert fdist_ops.LAUNCHES == before  # the ViT mask takes no kernel
    assert got.shape == (B, CLASSES) and got.dtype == torch.float32
    assert _rel(got, logits[REF_IMPL[impl]]) <= 1e-4
    assert torch.equal(model(torch.from_numpy(patches)).detach(), got)


def test_impl_parity(ref_vit):
    """tests/test_topo_attention.py::test_vit_grid_impl_parity on the port:
    Alg. 1 with the plan FastMult against the dense tree mask."""
    _, tree, patches, _ = ref_vit
    out = {}
    for impl in ("ref", "torch", "fft", "cuda"):
        cfg, model = _model(impl, tree)
        with torch.no_grad():
            out[impl] = TV.forward(cfg, model, patches, device="cpu")
    for impl in ("torch", "fft", "cuda"):
        assert _rel(out[impl], out["ref"]) <= 1e-3, impl


@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_mask_scalar_grads_match_jax(ref_vit, impl):
    """d(loss)/d(coeffs, logit_scale) of every layer, through Alg. 1 with
    the tree FastMult ("torch": the grads flowing through the leaf blocks, the Hankel mask values and the diagonal
    correction) or the dense mask ("ref"), against jax.grad. Held
    relative to the layer's largest: a0 and logit_scale cancel in the
    normalization (e^{a0} factors out of the mask, relu is positively
    homogeneous) but for phi's +1e-6, so their grads are below 1e-3 of
    a1's and a2's in both packages."""
    params, tree, patches, _ = ref_vit
    W = np.random.default_rng(1).normal(size=(B, CLASSES)).astype(np.float32)
    rcfg = _rcfg(REF_IMPL[impl])
    integ = RV.build_grid_integrator(rcfg)

    def jloss(topo):
        p = dict(params, blocks=dict(params["blocks"], topo=topo))
        return jnp.sum(RV.forward(rcfg, p, jnp.asarray(patches), integ)
                       * jnp.asarray(W))

    want = jax.grad(jloss)(params["blocks"]["topo"])
    cfg, model = _model(impl, tree)
    loss = (TV.forward(cfg, model, patches, device="cpu")
            * torch.from_numpy(W)).sum()
    loss.backward()
    for layer, blk in enumerate(model.blocks):
        got = torch.cat([blk.topo.coeffs.grad.reshape(-1),
                         blk.topo.logit_scale.grad.reshape(-1)])
        ref = np.concatenate([np.asarray(want["coeffs"])[layer].reshape(-1),
                              np.asarray(want["logit_scale"])[layer]
                              .reshape(-1)])
        assert float(got[1:3].abs().min()) > 0
        assert _rel(got, ref) <= 1e-4, layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bitwise(dtype):
    rcfg = _rcfg("fft").replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, RV.init_params(
        rcfg, jax.random.PRNGKey(3), num_classes=CLASSES,
        patch_dim=PATCH_DIM))
    model = convert.vit_from_reference(_tcfg("fft", dtype=dtype), tree,
                                       device="cpu")
    assert model.blocks[1].attn.wq.dtype == getattr(torch, dtype)
    back = convert.vit_to_reference(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, a in flat.items():
        b = flat_back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_port_init_params_serve(ref_vit):
    """`vit.init_params`: the reference's recipe (shapes, zero norms and
    biases, the decaying mask init) on a generator; it serves."""
    cfg = _tcfg("torch")
    model = TV.init_params(cfg, seed=0, num_classes=CLASSES,
                           patch_dim=PATCH_DIM, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref_shapes = {k: tuple(v.shape) for k, v in
                  convert.vit_from_reference(cfg, ref_vit[1], device="cpu")
                  .state_dict().items()}
    assert shapes == ref_shapes
    assert torch.equal(model.blocks[0].topo.coeffs,
                       torch.tensor([0.0, -1.0, 0.0]))
    with torch.no_grad():
        out = TV.forward(cfg, model, ref_vit[2], device="cpu")
    assert bool(torch.isfinite(out).all())


def test_install_grid_plan_from_reference_artifact(ref_vit, tmp_path,
                                                   monkeypatch):
    """A plan saved by the reference's `ftfi.save_plan` and installed with
    `install_grid_plan` is the one `build_grid_plan` serves (no IT build),
    with the same logits."""
    _, tree, patches, logits = ref_vit
    monkeypatch.setattr(TV, "_GRID_PLAN_CACHE", BoundedLRU(8))
    spec, params = RV.build_grid_plan(_rcfg("fft"))
    path = tmp_path / "grid4.npz"
    RF.save_plan(str(path), spec, params)
    tspec, tparams = TF.load_plan(str(path), device="cpu")
    assert tspec.digest == TV.build_grid_plan(_tcfg("torch"),
                                              device="cpu")[0].digest
    monkeypatch.setattr(TV, "_GRID_PLAN_CACHE", BoundedLRU(8))
    assert TV.install_grid_plan(tspec, tparams, device="cpu") == 4
    cfg, model = _model("torch", tree)
    built = TV.build_grid_plan(cfg, device="cpu")
    assert built[0] is tspec
    with torch.no_grad():
        got = TV.forward(cfg, model, patches, device="cpu")
        again = TV.forward(cfg, model, patches, built, device="cpu")
    assert torch.equal(got, again)
    assert _rel(got, logits["fft"]) <= 1e-4
    with pytest.raises(ValueError, match="square"):
        TV.install_grid_plan(TF.build(minimum_spanning_tree(
            grid_graph(3, 4)), device="cpu")[0], tparams, device="cpu")


def test_installed_plan_serves_every_impl(ref_vit, monkeypatch):
    """A plan installed once is the one every impl serves, "cuda" (the
    default serving impl) included: no IT build after the install."""
    _, tree, patches, logits = ref_vit
    monkeypatch.setattr(TV, "_GRID_PLAN_CACHE", BoundedLRU(8))
    spec, params = TF.build(minimum_spanning_tree(grid_graph(4, 4)),
                            leaf_size=TV.LEAF_SIZE, device="cpu")
    assert TV.install_grid_plan(spec, params, device="cpu") == 4

    def no_build(*a, **k):
        raise AssertionError("build_grid_plan rebuilt an installed plan")

    monkeypatch.setattr(TV.plan_api, "build", no_build)
    for impl in ("cuda", "torch", "fft"):
        cfg, model = _model(impl, tree)
        assert TV.build_grid_plan(cfg, device="cpu")[0] is spec
        with torch.no_grad():
            got = TV.forward(cfg, model, patches, device="cpu")
        assert _rel(got, logits[REF_IMPL[impl]]) <= 1e-4, impl


def test_performer_variant_matches_reference(ref_vit):
    params, tree, patches, _ = ref_vit
    rcfg = _rcfg("fft", attention_variant="performer")
    want = np.asarray(RV.forward(rcfg, params, jnp.asarray(patches), None))
    cfg, model = _model("fft", tree, attention_variant="performer")
    with torch.no_grad():
        got = TV.forward(cfg, model, patches, device="cpu")
    assert _rel(got, want) <= 1e-4


def test_full_config_matches_reference():
    want = dataclasses.asdict(ref_config("topovit_b16"))
    got = dataclasses.asdict(get_config("topovit-b16"))
    assert got == want
    assert (dataclasses.asdict(get_smoke_config("topovit_b16"))
            == dataclasses.asdict(ref_smoke("topovit_b16")))


def test_grid_plan_takes_the_hankel_engine():
    cfg = get_config("topovit_b16")
    spec, params = TV.build_grid_plan(cfg, device="cpu")
    assert spec.n == 196 and spec.grid_h == 1.0 and spec.leaf_size == 16
    f = TMK.mask_f(cfg.topo_g, [0.0, -1.0, -0.5], cfg.topo_dist_scale)
    for backend in ("torch", "cuda"):
        assert TF.describe(spec, f, backend=backend)["cross_engine"] == (
            "hankel_fft")
    # one plan for every backend: the pair does not depend on it
    assert TV.build_grid_plan(cfg, device="cpu") is TV.build_grid_plan(
        cfg.replace(topo_attn_impl="torch"), device="cpu")


def test_refusals(ref_vit):
    _, tree, patches, _ = ref_vit
    cfg, model = _model("torch", tree)
    with pytest.raises(ValueError, match="attention_variant"):
        TV.forward(cfg.replace(attention_variant="full"), model, patches,
                   device="cpu")
    with pytest.raises(ValueError, match="topo_attn_impl"):
        TV.forward(cfg.replace(topo_attn_impl="pallas"), model, patches,
                   device="cpu")
    # with no process group and no mesh, topo_shard_plan runs the
    # single-device executor (tests/test_torch_plan_shard.py runs it over
    # real ranks)
    with torch.no_grad():
        want = TV.forward(cfg, model, patches, device="cpu")
        assert torch.equal(TV.forward(cfg.replace(topo_shard_plan=True),
                                      model, patches, device="cpu"), want)
    if not torch.cuda.is_available():  # the entry points default to the card
        for call in (lambda: TV.forward(cfg, model, patches),
                     lambda: TV.build_grid_plan(cfg),
                     lambda: TV.init_params(cfg),
                     lambda: TMK.make_tree_fastmult(
                         TV.build_grid_plan(cfg, device="cpu"), "exp",
                         [0.0, -1.0])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
