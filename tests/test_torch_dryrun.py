"""The port's dry run (`repro_torch.launch.dryrun`) and its cost count
(`repro_torch.roofline.count`), on the CPU.

One step of the smoke Llama-3.2-1B at a `tiny_train` shape (global batch
8 x 64 tokens, as tests/test_distribution.py's reference case) on a fake
(2, 4) group, under FakeTensorMode: flops and collective bytes counted,
the argument bytes equal to the parameters' and AdamW's slabs computed
apart from the reference's `jax.eval_shape` shapes and the port's
`PARAM_RULES`, and the group gone after the context. The count's
independence of the route a kernel takes: each kernel wrapper's forward
records the same work on real and on fake CPU tensors; a fake CUDA tensor
takes the plain version by the wrapper's explicit test and never the CUDA
launch (a CPU-only torch runs few ops on fake CUDA tensors, so the plain
versions are stubbed there); and the dry run's count of a train step and
of a decode step equals the count of the same step run live on CPU
tensors. A decode cell (`tiny_decode`, B = 8, and `tiny_long`, B = 1 with
the cache's sequence over data) is counted: one `make_serve_step` call,
its argument bytes the parameters' and the cache's slabs.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as RB
from repro.models import api as RA
from repro_torch.configs import base as TB
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import convert
from repro_torch.roofline import count as RC
from repro_torch.roofline.count import CostCount

TINY = {"tiny_train": dict(seq_len=64, global_batch=8, kind="train"),
        "tiny_prefill": dict(seq_len=64, global_batch=8, kind="prefill"),
        "tiny_decode": dict(seq_len=64, global_batch=8, kind="decode"),
        "tiny_long": dict(seq_len=64, global_batch=1, kind="decode")}


@pytest.fixture(scope="module")
def shapes():
    TB.SHAPES.update(TINY)
    yield
    for k in TINY:
        TB.SHAPES.pop(k, None)


def _cfg():
    return TB.get_smoke_config("llama3_2_1b", attn_impl="cuda")


@pytest.fixture(scope="module")
def train(shapes):
    """(record, argument bytes computed apart) of the tiny train step on a
    fake (2, 4) group; the group is gone afterwards."""
    with dryrun.fake_group(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        rec = dryrun.lower_cell_cfg(_cfg(), "tiny_train", mesh).record()
        want = _argument_bytes(mesh)
    return rec, want


def _argument_bytes(mesh):
    """Parameters + mu + nu (AdamW's state, in the parameters' dtype) by
    their slabs, AdamW's int32 step, and the tokens' slab (int32 over the
    data axis), from the reference's parameter shapes."""
    tokens = TINY["tiny_train"]["global_batch"] // 2 * 64 * 4
    return 3 * _param_bytes(mesh) + 4 + tokens


def _param_bytes(mesh):
    """The parameters' slabs by the reference's parameter shapes and the
    port's `PARAM_RULES`."""
    rcfg = RB.get_smoke_config("llama3_2_1b")
    shapes = jax.eval_shape(lambda: RA.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    stacks = convert._stacks(_cfg())
    per_param = {}
    for name, leaf in convert._flatten(shapes):
        key, _, rest = name.partition(".")
        if key in stacks:
            for j in range(leaf.shape[0]):
                per_param[f"blocks.{stacks[key] + j}.{rest}"] = (
                    leaf.shape[1:], leaf.dtype.itemsize)
        else:
            per_param[name] = (leaf.shape, leaf.dtype.itemsize)
    with sharding.use_sharding(mesh):
        specs = sharding.tree_param_specs(
            {n: s for n, (s, _) in per_param.items()})
    total = 0
    for name, (shape, itemsize) in per_param.items():
        shards = 1
        for ax in specs[name]:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    shards *= sharding.axis_size(mesh, a)
        total += math.prod(shape) * itemsize // shards
    return total


def test_dry_run_counts_flops_and_collectives(train):
    rec, _ = train
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collective_bytes"] > 0, "expected collectives on a (2,4) mesh"
    assert rec["collectives"]["counts"]
    # B5 forward per layer, and again in the remat recompute
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * 2
    assert rec["peak_bytes_per_device"] == (
        rec["argument_size_bytes"] + rec["output_size_bytes"]
        + rec["temp_size_bytes"])


def test_dry_run_argument_bytes_are_the_slabs(train):
    rec, want = train
    assert rec["argument_size_bytes"] == want


def test_fake_group_is_gone_and_refuses_a_second(shapes):
    assert not dist.is_initialized()
    with dryrun.fake_group(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_group(4):
                pass
    assert not dist.is_initialized()


def test_count_records_the_collective_helpers_calls():
    """Every count's record holds, beside the census's kinds, the calls
    of `launch.collectives`' helpers made while it was open (their
    COUNTS), backward apart; calls made before it are not its."""
    from repro_torch.launch import collectives

    with dryrun.fake_group(4):
        group = dist.group.WORLD
        collectives.all_gather(torch.ones(2, 8), group)
        x = torch.ones(8, 8, requires_grad=True)
        with CostCount() as c:
            collectives.reduce_scatter(x, group).sum().backward()
            collectives.all_gather(torch.ones(2, 8), group)
    got = c.record()["collectives"]
    assert got["calls"] == {"all_gather": 1, "backward_all_gather": 1,
                            "reduce_scatter": 1}
    # the census sees the reduce-scatter's VJP as the all-gather it is
    assert got["counts"] == {"all-gather": 2, "reduce-scatter": 1}


def test_count_hides_dtensor_propagation_or_refuses(monkeypatch):
    """While a count is open DTensor's sharding propagation runs hidden
    from it (the method is wrapped, and put back on exit); a torch
    without that method makes the count refuse to open, not skew."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    real = getattr(ShardingPropagator, RC._PROPAGATE)
    with CostCount():
        assert getattr(ShardingPropagator, RC._PROPAGATE) is not real
    assert getattr(ShardingPropagator, RC._PROPAGATE) is real
    monkeypatch.delattr(ShardingPropagator, RC._PROPAGATE)
    with pytest.raises(RuntimeError, match="cannot hide"):
        CostCount().__enter__()
    from repro_torch.kernels import _count
    assert not _count.ACTIVE


def test_count_reads_a_transfer_between_devices_as_its_cast_only():
    """A `_to_copy` to another device (the meta device standing in for
    the card) moves no bytes in the count unless it casts, and then as
    many as the same cast on one device: the route that holds everything
    on the host runs no op for the transfer, and runs the cast."""
    x = torch.arange(16)
    with CostCount() as moved:
        x.to("meta")
    with CostCount() as cast_across:
        x.to("meta", torch.float32)
    with CostCount() as cast_here:
        x.to(torch.float32)
    assert moved.bytes_accessed == 0
    assert cast_across.bytes_accessed == cast_here.bytes_accessed == 16 * 12


def test_analyze_cell_record_keys(shapes):
    """analyze_cell's record: the reference's keys and roofline terms."""
    with dryrun.fake_group(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        count = dryrun.lower_cell_cfg(_cfg(), "tiny_prefill", mesh)
    rec = count.record()
    for k in ("flops", "bytes_accessed", "collective_bytes",
              "argument_size_bytes", "output_size_bytes", "temp_size_bytes",
              "peak_bytes_per_device"):
        assert rec[k] > 0, k
    assert rec["kernels"]["flash_attention"]["calls"] == 2


def test_analyze_cell_extrapolates_on_request(shapes, monkeypatch):
    """analyze_cell counts at full depth by default; extrapolate=True
    takes the reference's per-layer extrapolation from two reduced depths
    (2 and 4 layers), which on a uniform 6-layer stack reads the full
    depth's flops, bytes and collective bytes."""
    cfg = _cfg().replace(num_layers=6)
    monkeypatch.setattr(dryrun, "cell_config", lambda *a: (cfg, ""))
    with dryrun.fake_group(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        full = dryrun.analyze_cell("llama3_2_1b", "tiny_prefill", mesh, "2x4")
        ext = dryrun.analyze_cell("llama3_2_1b", "tiny_prefill", mesh, "2x4",
                                  extrapolate=True)
    assert (full["cost_mode"], ext["cost_mode"]) == ("full-depth",
                                                     "depth-extrapolated")
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        assert ext[k] == pytest.approx(full[k], rel=1e-12), k
    assert ext["roofline_bound_s"] == pytest.approx(full["roofline_bound_s"],
                                                    rel=1e-12)


def _slab_bytes(shape, itemsize, pls, mesh) -> int:
    shards = 1
    for j, pl in enumerate(pls):
        if pl.is_shard():
            shards *= mesh.size(j)
    return math.prod(shape) * itemsize // shards


@pytest.mark.parametrize("shape", ["tiny_decode", "tiny_long"])
def test_dry_run_counts_a_decode_cell(shapes, shape):
    """One `make_serve_step` call on a (2, 4) fake group: flops and
    collectives counted, the argument bytes the parameters' slabs (as the
    train cell's, without AdamW) plus the cache's slabs by the
    reference's cache shapes (jax.eval_shape of its init_cache) under
    `batch_shardings`' placements, plus the token's and pos's."""
    from repro_torch.launch.specs import batch_shardings

    sh = TINY[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    rcfg = RB.get_smoke_config("llama3_2_1b")
    rcache = jax.eval_shape(lambda: RA.init_cache(rcfg, B, S))
    with dryrun.fake_group(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        rec = dryrun.lower_cell_cfg(_cfg(), shape, mesh).record()
        params = _param_bytes(mesh)
        with sharding.use_sharding(mesh):
            pls = batch_shardings(_cfg(), shape, mesh)
    cache = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(rcache):
        node = pls["cache"]
        for key in path:
            node = node[key.key]
        cache += _slab_bytes(leaf.shape, leaf.dtype.itemsize, node, mesh)
    token = _slab_bytes((B, 1), 4, pls["token"], mesh)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collectives"]["counts"] and rec["collective_bytes"] > 0
    assert rec["argument_size_bytes"] == params + cache + token + 4
    # the cache comes back whole in its slabs: an output as large
    assert rec["output_size_bytes"] >= cache


def test_decode_batch_shardings(shapes):
    """A decode cell's placements by the reference's rule, on a (2, 2)
    mesh: the token and the cache's batch dim over data, the cache's KV
    heads over model where they divide; at batch 1 the cache's sequence
    over data instead and the token replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.specs import batch_shardings, batch_specs

    cfg = _cfg()
    with dryrun.fake_group(4):
        mesh = make_local_mesh(2, 2, device_type="cpu")
        with sharding.use_sharding(mesh):
            got = {s: (batch_specs(cfg, s), batch_shardings(cfg, s, mesh))
                   for s in ("tiny_decode", "tiny_long")}
    for shape, (specs, pls) in got.items():
        assert sorted(specs) == sorted(pls) == ["cache", "pos", "token"]
        assert pls["pos"] == [Replicate(), Replicate()]
        leaves = [(n, specs["cache"][b][n].shape, pls["cache"][b][n])
                  for b in specs["cache"] for n in specs["cache"][b]]
        assert leaves
        for name, shp, pl in leaves:
            # (layers, batch, length, kv heads, head dim)
            assert shp[3] == cfg.num_kv_heads == 2, name
            if shape == "tiny_decode":
                assert pl == [Shard(1), Shard(3)], (name, pl)
            else:
                assert pl == [Shard(2), Shard(3)], (name, pl)
        want = ([Shard(0), Replicate()] if shape == "tiny_decode"
                else [Replicate(), Replicate()])
        assert pls["token"] == want


def _wrapper_calls(dev):
    """{name: (fn, inputs)} of each kernel wrapper at a small shape, the
    inputs drawn from one seed and put on `dev`."""
    from repro_torch.kernels.fdist_matvec import ops as fd
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.linear_attention import ops as la
    from repro_torch.kernels.selective_scan import ops as sc
    from repro_torch.kernels.topo_linear_attention import ops as tp

    r = np.random.default_rng(0)

    def t(*shape, pos=False):
        a = r.standard_normal(shape).astype(np.float32)
        return torch.as_tensor(np.abs(a) if pos else a).to(dev)

    return {
        "fdist_matvec_batched": (
            lambda *a: fd.fdist_matvec_batched(*a, "poly"),
            (t(3, 10), t(3, 12), t(3, 12, 4), t(3))),
        "flash_attention": (
            lambda *a: fl.flash_attention(*a, causal=True),
            (t(2, 4, 32, 16), t(2, 2, 32, 16), t(2, 2, 32, 16))),
        "linear_attention": (
            la.linear_attention,
            (t(2, 4, 32, 8, pos=True), t(2, 4, 32, 8, pos=True),
             t(2, 4, 32, 16), torch.zeros(4).to(dev))),
        "selective_scan": (
            sc.scan,
            (t(2, 32, 8), t(2, 32, 8, pos=True), -t(8, 4, pos=True),
             t(2, 32, 4), t(2, 32, 4), t(8))),
        "topo_attention_sweep": (
            lambda *a: tp.topo_linear_attention(
                *a, g="exp", causal=False, rank=8, use_kernel=True),
            (t(1, 2, 64, 8, pos=True), t(1, 2, 64, 8, pos=True),
             t(1, 2, 64, 4), torch.tensor([1.0, -0.5, 0.25]).to(dev))),
    }


def _launches():
    from repro_torch.kernels.fdist_matvec import ops as fd
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.linear_attention import ops as la
    from repro_torch.kernels.selective_scan import ops as sc
    from repro_torch.kernels.topo_linear_attention import ops as tp

    return [m.LAUNCHES for m in (fd, fl, la, sc, tp)]


ROUTES = ("cpu", "fake-cpu")


@pytest.mark.parametrize("name", ["fdist_matvec_batched", "flash_attention",
                                  "linear_attention", "selective_scan",
                                  "topo_attention_sweep"])
def test_count_reads_the_same_work_on_every_route(name):
    """The wrapper records its formula and hides its plain version's ops
    on real and fake CPU tensors alike (the call's other ops alike too),
    and launches nothing."""
    launches = _launches()
    records = {}
    for route in ROUTES:
        mode = FakeTensorMode() if route.startswith("fake") else None
        with (mode or torch.no_grad()):
            fn, inputs = _wrapper_calls("cpu")[name]
            with CostCount() as c:
                out = fn(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.device.type == "cpu" for o in outs), route
        rec = c.record()
        records[route] = (rec["flops"], rec["kernels"], rec["bytes_accessed"])
    assert name in records["cpu"][1]
    assert records["cpu"] == records["fake-cpu"], records
    assert _launches() == launches


@pytest.mark.parametrize("name", ["flash_attention", "linear_attention",
                                  "selective_scan"])
def test_plain_outputs_take_the_kernels_layout(name):
    """On a transposed (the model's) input layout the plain version's
    outputs have the strides of the buffers the kernel writes, so the ops
    after the wrapper, and what a count reads of them, do not depend on
    the route; the values are the plain version's."""
    from repro_torch.kernels.flash_attention import kernel as flk, ops as fl
    from repro_torch.kernels.linear_attention import kernel as lak, ops as la
    from repro_torch.kernels.selective_scan import kernel as sck, ops as sc

    fn, inputs = _wrapper_calls("cpu")[name]
    if name == "flash_attention":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in inputs)
        got = fl._route(q, k, v, True, 0)
        bufs, plain = flk.out_buffer(q, v.shape[-1]), fl._plain(q, k, v, True)
    elif name == "linear_attention":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in inputs[:3])
        got = la._route(q, k, v, inputs[3])
        bufs, plain = lak.out_buffers(v), la._plain(q, k, v, inputs[3])
    else:
        got = sc._route(*inputs, None)
        bufs = sck.out_buffers(inputs[0], inputs[2].shape[1])
        plain = sc.selective_scan(*inputs)
    for g, b, p in zip(*((x if isinstance(x, tuple) else (x,))
                         for x in (got, bufs, plain))):
        assert g.stride() == b.stride() and g.dtype == b.dtype
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def _stub_routes(monkeypatch):
    """Each wrapper's plain version replaced by a recorder that returns
    empty outputs of the right shapes, the kernels' output buffers (which
    the plain outputs are laid out like) by contiguous empties, and each
    CUDA launch by a failure: (the recorder's calls)."""
    from repro_torch.kernels.fdist_matvec import kernel as fdk, ops as fd
    from repro_torch.kernels.flash_attention import kernel as flk, ops as fl
    from repro_torch.kernels.linear_attention import kernel as lak, ops as la
    from repro_torch.kernels.selective_scan import kernel as sck, ops as sc
    from repro_torch.kernels.topo_linear_attention import (kernel as tpk,
                                                           ops as tp)

    calls = []

    def plain(name, out):
        def fn(*a, **k):
            calls.append(name)
            return out(*a)
        return fn

    def launch(*a, **k):
        raise AssertionError("a kernel launched on a fake tensor")

    e = torch.empty
    monkeypatch.setattr(fd, "fdist_matvec_batched_ref", plain(
        "fdist", lambda x, y, v, *r: e(x.shape + v.shape[-1:],
                                       device=x.device)))
    monkeypatch.setattr(fl, "_plain", plain(
        "flash", lambda q, k, v, *r: e(q.shape, device=q.device)))
    monkeypatch.setattr(la, "_plain", plain(
        "linear", lambda q, k, v, *r: (e(v.shape, device=q.device),
                                       e(v.shape[:3], device=q.device))))
    monkeypatch.setattr(sc, "selective_scan", plain(
        "scan", lambda u, dt, A, *r: (e(u.shape, device=u.device),
                                      e(u.shape[:1] + A.shape,
                                        device=u.device))))
    monkeypatch.setattr(tp, "_sweep", plain(
        "topo", lambda q, k, v, *r: (e(v.shape, device=q.device),
                                     e(v.shape[:3], device=q.device))))
    monkeypatch.setattr(tp, "_emit", lambda num, *r: num)
    monkeypatch.setattr(flk, "out_buffer", lambda q, vd: e(
        q.shape[:3] + (vd,), device=q.device))
    monkeypatch.setattr(lak, "out_buffers", lambda v: (
        e(v.shape, device=v.device), e(v.shape[:3], device=v.device)))
    monkeypatch.setattr(sck, "out_buffers", lambda u, N: (
        e(u.shape, device=u.device), e(u.shape[:1] + (u.shape[2], N),
                                       device=u.device)))
    for mod, fn in ((fdk, "fdist_matvec_batched_cuda"),
                    (flk, "flash_attention_cuda"),
                    (lak, "linear_attention_cuda"),
                    (sck, "selective_scan_cuda"), (tpk, "topo_sweep_cuda")):
        monkeypatch.setattr(mod, fn, launch)
    return calls


def test_fake_cuda_tensors_take_the_plain_version(monkeypatch):
    """A fake CUDA tensor (FakeTensorMode names the card without one) goes
    to each wrapper's plain version by its explicit test, never to the
    CUDA launch, and counts no launch; the count records the kernel's
    formula for it as for a CPU tensor."""
    from repro_torch.kernels.fdist_matvec import ops as fd
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.linear_attention import ops as la
    from repro_torch.kernels.selective_scan import ops as sc
    from repro_torch.kernels.topo_linear_attention import ops as tp

    calls = _stub_routes(monkeypatch)
    launches = _launches()
    records = []
    for dev in ("cuda", "cpu"):
        with FakeTensorMode(), CostCount() as c:
            e = lambda *s: torch.empty(s, device=dev)  # noqa: E731
            fd._forward(e(3, 10), e(3, 12), e(3, 12, 4), e(3), "poly")
            fl._forward(e(2, 4, 32, 16), e(2, 2, 32, 16), e(2, 2, 32, 16),
                        True)
            la._forward(e(2, 4, 32, 8), e(2, 4, 32, 8), e(2, 4, 32, 16),
                        e(4))
            sc._forward(e(2, 32, 8), e(2, 32, 8), e(8, 4), e(2, 32, 4),
                        e(2, 32, 4), e(8), None)
            tp.topo_attention_sweep(e(1, 2, 64, 8), e(1, 2, 64, 8),
                                    e(1, 2, 64, 4), e(2, 64, 64),
                                    log_gamma=e(2))
        records.append(c.record()["kernels"])
    assert calls == ["fdist", "flash", "linear", "scan", "topo"] * 2
    assert _launches() == launches
    assert records[0] == records[1]
    assert sorted(records[0]) == ["fdist_matvec_batched", "flash_attention",
                                  "linear_attention", "selective_scan",
                                  "topo_attention_sweep"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_count_equals_the_live_count(shapes, kind):
    """One train step of the smoke Llama (B5 on its CPU route), or one
    serve step over a cache of 32 positions, counted live on CPU tensors
    and under FakeTensorMode: the same flops and bytes."""
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = _cfg().replace(dtype="float32")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    got = []
    for fake in (False, True):
        with (FakeTensorMode(allow_non_fake_inputs=True) if fake
              else torch.no_grad()):
            model = api.init_params(cfg, 0, device="cpu")
            if kind == "train":
                opt = adamw_init(dict(model.named_parameters()))
                batch = {"tokens": torch.as_tensor(tokens)}
                step = make_train_step(cfg, AdamWConfig(), device="cpu")
                with torch.enable_grad(), CostCount() as c:
                    step(model, opt, batch)
            else:
                cache = api.init_cache(cfg, 2, 32, device="cpu")
                step = make_serve_step(cfg, 32, device="cpu")
                with CostCount() as c:
                    step(model, cache, torch.as_tensor(tokens[:, :1]),
                         torch.tensor(5))
        rec = c.record()
        got.append((rec["flops"], rec["bytes_accessed"], rec["kernels"]))
    assert got[0] == got[1]
    assert got[0][0] > 0
    if kind == "train":
        assert got[0][2]["flash_attention"]["calls"] == 2 * 2
