"""Multi-rank FTFI on the port (`core/plan_shard.py`, `launch/{mesh,
sharding,collectives}.py`, the sharded kernel faces) against the
reference's single-device results.

In process: the port's `partition_plan` tables equal the reference's array
for array (a tree, a forest and two grid plans with Hankel tables, D in
1, 2, 4, 8) and so do `shard_stats`; the plan guard takes a spec stamped
for one device as the reference does (its count of devices was the CUDA
cards', 0 on the CPU) and refuses a larger mesh or a newer layout in the
reference's words; `save_plan(mesh=...)` round trips through both
packages' loaders.

In 4 ranks: one gloo group of 4 CPU processes (`launch.mesh.run_local`,
once for the module; the per-rank work is `_torch_shard_worker.rank_main`)
computes every sharded case, and the tests read its results:
`apply_sharded` on a tree and a forest (exp and a raw callable through the
Chebyshev engine, reweighted params, an `update_plan`-edited plan, tree
weights), its rows gathered, within 1e-6 of the reference's single-device
`apply` (tests/test_sharded_ftfi.py:43's bound), its grads within 1e-5,
the result sharded by rows from a row-sharded and a whole field alike and
a row-sharded field's grads, the collectives of one forward counted by
wrapping `torch.distributed` (the reference's census: no gather), both
kernel faces within 1e-6 of the reference's single-device wrappers (Pallas
in interpret mode, the XLA twin) and their grads in every input within
1e-5, the smoke TopoViT with `topo_shard_plan=True` within 1e-4 of the
reference's `vit.forward` (tests/test_distribution.py:93's bound) and its
mask scalars' grads within 1e-4 of `jax.grad`'s, and a plan axis of one
rank equal to `apply` bit for bit."""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import _torch_shard_worker as W  # noqa: E402
from repro import ftfi as RF  # noqa: E402
from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import cordial as RC  # noqa: E402
from repro.core import plan_shard as RS  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs.mst import minimum_spanning_tree as ref_mst  # noqa: E402
from repro.kernels.fdist_matvec.ops import (  # noqa: E402
    fdist_matvec_batched as ref_fdist)
from repro.kernels.fdist_matvec.ref import (  # noqa: E402
    fdist_matvec_ref as ref_fdist_one)
from repro.kernels.topo_linear_attention.ops import (  # noqa: E402
    topo_linear_attention as ref_topo)
from repro.models import vit as RV  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import plan_shard as TS  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs.mst import minimum_spanning_tree  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import convert  # noqa: E402

CPU = "cpu"
SHARD_TOL = 1e-6  # tests/test_sharded_ftfi.py:43
GRAD_TOL = 1e-5
VIT_TOL = 1e-4  # tests/test_distribution.py:93
RANKS = 4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                   1e-30))


def _forest(pkg):
    return pkg.Forest([pkg.random_tree(40 + 7 * i, seed=i) for i in range(5)])


def _plans(name):
    """(reference spec, port spec) of one plan of the partition test."""
    if name == "tree":
        return (RF.build(RG.random_tree(257, seed=3))[0],
                T.build(TG.random_tree(257, seed=3), device=CPU)[0])
    if name == "forest":
        return RF.build(_forest(RG))[0], T.build(_forest(TG), device=CPU)[0]
    side = int(name.split("grid")[1])  # the ViT's grid plan, leaf 16
    return (RF.build(ref_mst(RG.grid_graph(side, side)), leaf_size=16)[0],
            T.build(minimum_spanning_tree(TG.grid_graph(side, side)),
                    leaf_size=16, device=CPU)[0])


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("plan", ["tree", "forest", "grid4", "grid8"])
def test_partition_plan_matches_reference(plan, D):
    rspec, tspec = _plans(plan)
    assert tspec.digest == rspec.digest
    want, got = RS.partition_plan(rspec, D), TS.partition_plan(tspec, D)
    if plan.startswith("grid"):
        assert got.hankel_it is not None
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert TS.shard_stats(tspec, D) == RS.shard_stats(rspec, D)
    assert TS.partition_plan(tspec, D) is got  # memoized on (digest, D)


def test_plan_guard_counts_one_cpu_device():
    """The fault this slice repaired: a spec stamped for one device passes
    the port's validate on the CPU, as it passes the reference's (the
    port counted the CUDA cards, 0 here). A mesh too large for this
    process and a newer shard layout raise in the reference's words."""
    rs, rp = RF.build(RG.random_tree(40, seed=0))
    ts, tp = T.build(TG.random_tree(40, seed=0), device=CPU)
    for pkg, spec, params in ((RF, rs, rp), (T, ts, tp)):
        ok = dataclasses.replace(spec, shard_layout=pkg.SHARD_LAYOUT_VERSION,
                                 mesh_devices=1, mesh_axes=("data",))
        assert pkg.validate(ok, params, where="test")
    assert T.SHARD_LAYOUT_VERSION == RF.SHARD_LAYOUT_VERSION
    for match, kw in (("mesh_devices", dict(
            shard_layout=1, mesh_devices=64, mesh_axes=("data", "model"))),
            ("shard_layout", dict(shard_layout=2, mesh_devices=1))):
        errs = []
        for pkg, spec, params in ((RF, rs, rp), (T, ts, tp)):
            with pytest.raises(pkg.PlanValidationError, match=match) as e:
                pkg.validate(dataclasses.replace(spec, **kw), params,
                             where="test")
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_save_plan_stamps_mesh(tmp_path):
    """`save_plan(mesh=...)` under a one-rank gloo group stamps the mesh;
    the artifact loads in the port and in the reference with the same
    provenance, and passes both guards."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = TM.make_plan_mesh(CPU)
        spec, params = T.build(TG.random_tree(40, seed=0), device=CPU)
        path = str(tmp_path / "plan.npz")
        T.save_plan(path, spec, params, mesh=mesh)
    finally:
        dist.destroy_process_group()
    ts, _ = T.load_plan(path, device=CPU)
    rs, _ = RF.load_plan(path)
    for s in (ts, rs):
        assert (s.mesh_devices, tuple(s.mesh_axes), s.shard_layout) == (
            1, ("data",), RF.SHARD_LAYOUT_VERSION)
    assert rs.provenance["mesh_devices"] == 1
    assert ts.digest == rs.digest


@pytest.fixture(scope="module")
def ranks():
    """The inputs, the reference's single-device results and the 4 ranks'
    results of every sharded case."""
    r = np.random.default_rng(0)
    rtree = RG.random_tree(257, seed=3)
    nf = sum(40 + 7 * i for i in range(5))
    rcfg = ref_smoke("topovit_b16").replace(dtype="float32",
                                            topo_attn_impl="fft")
    vparams = RV.init_params(rcfg, jax.random.PRNGKey(0), num_classes=10,
                             patch_dim=32)
    # mask scalars away from their init, so every coefficient matters (as
    # tests/test_torch_vit.py sets them)
    topo = vparams["blocks"]["topo"]
    vparams["blocks"]["topo"] = {
        "coeffs": jnp.asarray(r.uniform(-0.5, 0.5, topo["coeffs"].shape),
                              jnp.float32),
        "logit_scale": jnp.asarray(r.uniform(-0.3, 0.3,
                                             topo["logit_scale"].shape),
                                   jnp.float32)}
    cfg = get_smoke_config("topovit_b16", dtype="float32",
                           topo_attn_impl="torch")
    model = convert.vit_from_reference(cfg, jax.tree.map(np.asarray, vparams),
                                       device=CPU)
    case = dict(
        X=r.normal(size=(257, 4)).astype(np.float32),
        edge_w=(np.abs(r.normal(size=256)) + 0.05).astype(np.float32),
        edge_w2=(np.abs(r.normal(size=257)) + 0.05).astype(np.float32),
        X2=r.normal(size=(258, 4)).astype(np.float32),
        tree_w=r.normal(size=5).astype(np.float32),
        Xf=r.normal(size=(nf, 3)).astype(np.float32),
        # ragged B = 5 over 4 and over 2 ranks
        fx=r.normal(size=(5, 16)).astype(np.float32),
        fy=r.normal(size=(5, 24)).astype(np.float32),
        fv=r.normal(size=(5, 24, 3)).astype(np.float32),
        fcoef=np.array([0.3, -0.7], np.float32),
        qf=np.abs(r.normal(size=(4, 8, 64, 8))).astype(np.float32),
        kf=np.abs(r.normal(size=(4, 8, 64, 8))).astype(np.float32),
        vv=r.normal(size=(4, 8, 64, 16)).astype(np.float32),
        co=(r.normal(size=(8, 2)) * 0.1).astype(np.float32),
        vit_sd={k: v.detach().numpy() for k, v in model.state_dict().items()},
        patches=r.normal(size=(2, 16, 32)).astype(np.float32),
        vit_W=r.normal(size=(2, 10)).astype(np.float32))
    # the cotangents of the kernel faces' grads
    case["fW"] = r.normal(size=case["fx"].shape + (3,)).astype(np.float32)
    case["tW"] = r.normal(size=case["vv"].shape).astype(np.float32)
    # the ranks run while this process computes the reference (jitted:
    # eager, an apply on this tree takes ~5 s)
    pool = ThreadPoolExecutor(1)
    ranks_done = pool.submit(TM.run_local, W.rank_main, RANKS, (case,),
                             timeout=600)

    def japply(spec, fn):
        return jax.jit(lambda p, x: RF.apply(spec, p, fn, x))

    fns = {"exp": RC.Exponential(-0.4), "cheb": lambda s: 1.0 / (1.0 + s * s)}
    spec, params = RF.build(rtree, reweightable=True)
    ref = {f"tree_{k}": japply(spec, fn)(params, case["X"])
           for k, fn in fns.items()}
    ref["reweighted"] = japply(spec, fns["exp"])(
        RF.reweight(spec, case["edge_w"]), case["X"])
    s2, p2 = RF.update_plan(spec, params, [("insert_leaf", 5, 0.8)])
    s2, p2 = RF.update_plan(s2, p2, [("reweight", case["edge_w2"])])
    ref["updated"] = japply(s2, fns["exp"])(p2, case["X2"])
    fs, fp = RF.build(_forest(RG))
    fp = dataclasses.replace(fp, tree_w=jnp.asarray(case["tree_w"]))
    for k, fn in fns.items():
        ref[f"forest_{k}"] = japply(fs, fn)(fp, case["Xf"])

    def loss(p, x):
        y = RF.apply(spec, p, fns["exp"], x)
        return jnp.sum(y * y)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                     jnp.asarray(case["X"]))
    ref["grads"] = {"X": gx, "cross_tgt_d": gp.cross_tgt_d,
                    "cross_src_d": gp.cross_src_d,
                    "leaf_dists": gp.leaf_dists}
    ref["fdist"] = ref_fdist(case["fx"], case["fy"], case["fv"],
                             case["fcoef"], mode="exp")
    ref["topo"] = {tag: ref_topo(case["qf"], case["kf"], case["vv"],
                                 case["co"], g="exp", causal=c)
                   for tag, c in (("causal", True), ("bidir", False))}
    ref["topo"]["h3"] = ref_topo(case["qf"][:, :3], case["kf"][:, :3],
                                 case["vv"][:, :3], case["co"][:3], g="exp")
    # the faces' grads: the XLA twin of fdist_matvec (jax.grad does not
    # pass the Pallas kernel), the topo wrapper's own custom VJP
    fgrad = jax.grad(lambda *a: jnp.sum(jax.vmap(
        ref_fdist_one, in_axes=(0, 0, 0, None, None))(*a, "exp")
        * case["fW"]), argnums=(0, 1, 2, 3))
    ref["face_grads"] = {"fdist": fgrad(case["fx"], case["fy"], case["fv"],
                                        case["fcoef"])}

    def tgrad(h, causal):
        return jax.grad(lambda *a: jnp.sum(ref_topo(
            *a, g="exp", causal=causal) * case["tW"][:, :h]),
            argnums=(0, 1, 2, 3))(case["qf"][:, :h], case["kf"][:, :h],
                                  case["vv"][:, :h], case["co"][:h])

    ref["face_grads"]["topo_causal"] = tgrad(8, True)
    ref["face_grads"]["topo_h3"] = tgrad(3, False)
    integ = RV.build_grid_integrator(rcfg)
    ref["vit"] = jax.jit(lambda p, x: RV.forward(rcfg, p, x, integ))(
        vparams, jnp.asarray(case["patches"]))

    def vloss(topo):
        p = dict(vparams, blocks=dict(vparams["blocks"], topo=topo))
        return jnp.sum(RV.forward(rcfg, p, jnp.asarray(case["patches"]),
                                  integ) * case["vit_W"])

    vg = jax.jit(jax.grad(vloss))(vparams["blocks"]["topo"])
    ref["vit_grads"] = [np.concatenate([np.asarray(vg["coeffs"][i]).ravel(),
                                        np.asarray(vg["logit_scale"][i])
                                        .ravel()])
                        for i in range(vg["coeffs"].shape[0])]
    ref = jax.tree.map(np.asarray, ref)
    try:
        results = ranks_done.result()
    finally:
        pool.shutdown()
    return case, ref, results


@pytest.mark.parametrize("key", ["tree_exp", "tree_cheb", "reweighted",
                                 "updated", "forest_exp", "forest_cheb"])
def test_apply_sharded_matches_reference(ranks, key):
    _, ref, results = ranks
    assert [r["rank"] for r in results] == list(range(RANKS))
    for r in results:  # every rank's rows gathered: the same bits
        assert np.array_equal(r[key], results[0][key])
    assert results[0][key].shape == ref[key].shape
    assert _rel(results[0][key], ref[key]) <= SHARD_TOL, key


def test_apply_sharded_grads_match_reference(ranks):
    """Grads of sum(Y^2) in X and every distance tensor: each rank holds
    the whole gradient (the halo's, the reduce_scatter's and the rows'
    gather's
    gather's VJPs, the distances summed over ranks)."""
    _, ref, results = ranks
    for r in results:
        got = r["grads"]
        assert _rel(got["X"], ref["grads"]["X"]) <= GRAD_TOL
        for name in ("cross_tgt_d", "cross_src_d", "leaf_dists"):
            for i, (g, w) in enumerate(zip(got[name], ref["grads"][name])):
                assert _rel(g, w) <= GRAD_TOL, (name, i)


def test_one_forward_collectives(ranks):
    """One forward: exactly one halo all_to_all and one reduce_scatter,
    no gather of the field, nothing else (the reference's census,
    ANALYSIS_BUDGETS.json); a field sharded by rows alike. The smoke
    TopoViT (2 layers, 2 mask fastmults each) four of each, its tokens
    sharded by rows between them, and the pooled head's one all_reduce of
    (B, d)."""
    _, _, results = ranks
    want = {"all_to_all": 1, "reduce_scatter": 1, "all_gather": 0,
            "all_reduce": 0}
    for r in results:
        for name in ("exp", "cheb"):
            assert r[f"census_{name}"] == want
        assert r["rows"]["census"] == want
        assert r["census_vit"] == {"all_to_all": 4, "reduce_scatter": 4,
                                   "all_gather": 0, "all_reduce": 1}


def test_apply_sharded_returns_rows(ranks):
    """The result is a DTensor sharded by rows over the plan axis: each
    rank holds rows [k * ceil(n / D), ...) of the reference's `apply`
    (within 1e-5), the same from a `Shard(0)` field and from the whole
    field; `full_tensor()` is the reference's result."""
    _, ref, results = ranks
    want = ref["tree_exp"]
    block = -(-want.shape[0] // RANKS)
    for r in results:
        rows = r["rows"]
        assert rows["placements"] == ["Shard(dim=0)"]
        k = r["rank"]
        assert rows["local"].shape == want[k * block:(k + 1) * block].shape
        assert np.array_equal(rows["local"], rows["plain_local"])
        assert _rel(rows["local"], want[k * block:(k + 1) * block]) <= 1e-5
        assert _rel(rows["whole"], want) <= 1e-5


def test_row_sharded_field_grads_match_reference(ranks):
    """The grads of sum(Y^2) in a field sharded by rows (each rank's loss
    on its own rows): sharded by rows like X, each rank's block the
    reference's rows of jax.grad, the whole within GRAD_TOL."""
    _, ref, results = ranks
    want = ref["grads"]["X"]
    block = -(-want.shape[0] // RANKS)
    for r in results:
        rows = r["rows"]
        k = r["rank"]
        assert rows["grad_placements"] == ["Shard(dim=0)"]
        assert _rel(rows["grad_local"],
                    want[k * block:(k + 1) * block]) <= GRAD_TOL
        assert _rel(rows["grad_X"], want) <= GRAD_TOL


@pytest.mark.parametrize("face", ["fdist_d4", "fdist_d2m2", "topo_causal",
                                  "topo_bidir", "topo_h3"])
def test_kernel_faces_match_reference(ranks, face):
    """fdist_matvec_batched_sharded (ragged B = 5 over 4 and over 2 ranks)
    and topo_linear_attention_sharded on the (2, 2) mesh (H = 3: the head
    axis dropped) against the reference's single-device wrappers."""
    _, ref, results = ranks
    kind, tag = face.split("_")
    if kind == "fdist":
        got, want = [r["fdist"][tag] for r in results], ref["fdist"]
    else:
        got, want = [r["topo"][tag] for r in results], ref["topo"][tag]
    for g in got:
        assert g.shape == want.shape
        assert np.array_equal(g, got[0])
    assert _rel(got[0], want) <= SHARD_TOL


@pytest.mark.parametrize("face", ["fdist_d4", "fdist_d2m2", "topo_causal",
                                  "topo_h3"])
def test_kernel_face_grads_match_reference(ranks, face):
    """The grads of sum(face * W) in every input of each kernel face
    (x, y, v, coeffs; qf, kf, v, coeffs) within 1e-5 of the reference's
    single-device grads, on every rank: a rank differentiates only its
    slab, and the inputs' grads are summed over the face's axes."""
    _, ref, results = ranks
    want = ref["face_grads"]["fdist" if face.startswith("fdist") else face]
    for r in results:
        got = r["face_grads"][face]
        assert len(got) == len(want) == 4
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (face, i)
            assert _rel(g, w) <= GRAD_TOL, (face, i)


def test_world_size_one_is_apply(ranks):
    """A plan axis of one rank (the (1, 4) mesh) gives `apply` exactly."""
    _, _, results = ranks
    assert all(r["world1_equal"] for r in results)


def test_topovit_sharded_matches_reference(ranks):
    """The smoke TopoViT with topo_shard_plan=True over the ("data",) mesh
    of 4: every rank's logits within 1e-4 of the reference's single-device
    forward on the same weights."""
    _, ref, results = ranks
    for r in results:
        assert r["vit"].shape == ref["vit"].shape
        assert _rel(r["vit"], ref["vit"]) <= VIT_TOL


def test_topovit_sharded_mask_grads_match_reference(ranks):
    """d(sum(logits * W))/d(coeffs, logit_scale) of every layer of the
    sharded smoke TopoViT on every rank, within 1e-4 of the layer's largest
    jax.grad of the reference's single-device forward (the bound of
    tests/test_torch_vit.py's same check). A rank reads only its share of
    the mask coefficients (its leaf blocks and cross jobs), so without
    their sum over the ranks each would hold a part of the gradient."""
    _, ref, results = ranks
    for r in results:
        assert len(r["vit_grads"]) == len(ref["vit_grads"])
        for layer, (g, w) in enumerate(zip(r["vit_grads"],
                                           ref["vit_grads"])):
            assert float(np.abs(g[1:3]).min()) > 0
            assert _rel(g, w) <= VIT_TOL, layer


def test_worker_module_is_jax_free():
    """The ranks import the port only (spawned processes import the worker
    by name)."""
    src = open(os.path.join(os.path.dirname(__file__),
                            "_torch_shard_worker.py")).read()
    assert "jax" not in src.replace("imports neither jax", "")
    assert "from repro " not in src and "import repro." not in src
