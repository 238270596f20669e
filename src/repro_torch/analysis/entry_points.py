"""Registered audit entry points: every public surface of the reference's
registry, on the port's counterpart.

Each entry is a zero-arg function returning ``(fn, args)`` — small enough to
trace in seconds on the CPU, shaped like the production path (same code
route, same engines, the same multi-rank executor). ``python -m
repro_torch.analysis --audit`` traces each one (`graph_audit`) and diffs
the census against its entry in ``budgets.json``; tests iterate the same
registry so the budget file and the test suite can never drift apart.

Tensors a surface reads are passed in ``args`` (a plan's params, a model's
parameters), so the trace takes them as inputs: what it bakes in as
constants is what the surface itself captures.

Sections: ``core`` (ftfi functional API + backends: the reference's "plan"
is the port's "torch", its "pallas" the port's "cuda", whose kernel
wrapper takes its plain version on CPU tensors), ``kernels`` (the kernel
wrappers), ``models`` (train steps / forwards), ``serve`` (prefill),
``sharded`` (the multi-rank paths: each builds and runs under a
`launch.dryrun.fake_group` of 8 ranks in this process, on a (2, 4)
("data", "model") mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np

CPU = "cpu"
SHARDED_RANKS = 8  # the fake group the sharded entries run under


class SkipEntry(Exception):
    """Entry point not traceable in this environment."""


@dataclasses.dataclass
class EntryPoint:
    name: str
    section: str
    build: Callable[[], tuple[Callable, tuple]]
    doc: str = ""
    # held open around build() and the trace (the sharded entries' group)
    context: Callable = contextlib.nullcontext


REGISTRY: dict[str, EntryPoint] = {}


def entry(name: str, section: str, doc: str = "", context=None):
    def deco(fn):
        REGISTRY[name] = EntryPoint(name, section, fn, doc,
                                    context or contextlib.nullcontext)
        return fn

    return deco


def by_section(section: str) -> list[EntryPoint]:
    return [e for e in REGISTRY.values() if e.section == section]


@contextlib.contextmanager
def _fake_group8():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_group

    if dist.is_initialized():
        raise SkipEntry("a process group is already initialized")
    with fake_group(SHARDED_RANKS):
        yield


def _rng():
    return np.random.default_rng(0)


def _t(a):
    import torch

    return torch.as_tensor(a)


def _plan_leaves(params) -> list:
    """A plan's params as a list of tensors (the trace's inputs)."""
    return [t for t in (*params.cross_tgt_d, *params.cross_src_d,
                        *params.leaf_dists, params.tree_w) if t is not None]


def _mesh24():
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(2, 4, device_type=CPU)


# ---------------------------------------------------------------------------
# core: ftfi functional API + plan engines
# ---------------------------------------------------------------------------

@entry("ftfi.fastmult.tree", "core",
       "plan executor, structured exp cross engine")
def _ftfi_fastmult_tree():
    import repro_torch.ftfi as ftfi
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import random_tree

    spec, params = ftfi.build(random_tree(96, seed=0), device=CPU)
    X = _t(_rng().standard_normal((96, 4), dtype=np.float32))
    fm = ftfi.fastmult(spec, C.Exponential(-0.5), device=CPU)
    return (lambda leaves, X: fm(params, X)), (_plan_leaves(params), X)


@entry("ftfi.apply.chebyshev", "core",
       "raw-callable f via the batched Chebyshev cross engine")
def _ftfi_apply_cheb():
    import repro_torch.ftfi as ftfi
    from repro_torch.graphs.graph import random_tree

    spec, params = ftfi.build(random_tree(96, seed=1), device=CPU)
    X = _t(_rng().standard_normal((96, 2), dtype=np.float32))

    def fwd(leaves, X):
        return ftfi.apply(spec, params, lambda s: 1.0 / (1.0 + s * s), X,
                          device=CPU)

    return fwd, (_plan_leaves(params), X)


@entry("ftfi.fastmult.forest", "core",
       "many trees packed into one plan dispatch")
def _ftfi_fastmult_forest():
    import repro_torch.ftfi as ftfi
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import Forest, random_tree

    fo = Forest([random_tree(40 + 7 * i, seed=i) for i in range(3)])
    spec, params = ftfi.build(fo, device=CPU)
    X = _t(_rng().standard_normal((spec.n, 3), dtype=np.float32))
    fm = ftfi.fastmult(spec, C.Exponential(-0.3), device=CPU)
    return (lambda leaves, X: fm(params, X)), (_plan_leaves(params), X)


@entry("ftfi.reweight.grad", "core",
       "edge-weight gradient through reweight + apply (learnable metrics)")
def _ftfi_reweight_grad():
    import torch

    import repro_torch.ftfi as ftfi
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import random_tree

    t = random_tree(64, seed=2)
    spec, _ = ftfi.build(t, reweightable=True, device=CPU)
    X = _t(_rng().standard_normal((64, 2), dtype=np.float32))
    w0 = _t(np.asarray(t.weights, np.float32))

    def grad(w, X):
        w = w.detach().requires_grad_(True)
        p = ftfi.reweight(spec, w)
        loss = torch.sum(ftfi.apply(spec, p, C.Exponential(-0.5), X,
                                    device=CPU) ** 2)
        return torch.autograd.grad(loss, w)[0]

    return grad, (w0, X)


def _integrator_entry(backend: str, seed: int):
    from repro_torch.core import cordial as C
    from repro_torch.core.engines.base import Integrator
    from repro_torch.graphs.graph import random_tree

    integ = Integrator(random_tree(80, seed=seed), backend=backend,
                       device=CPU)
    pf = integ.fastmult(C.Exponential(-0.5))
    X = _t(_rng().standard_normal((80, 2), dtype=np.float32))
    return (lambda X: pf(X)), (X,)


@entry("engines.plan.fastmult", "core",
       "Integrator facade over the plain plan backend (\"torch\"; params "
       "ride the closure)")
def _engine_plan():
    return _integrator_entry("torch", 3)


@entry("engines.pallas.fastmult", "core",
       "Integrator facade over the kernel backend (\"cuda\"; its wrapper's "
       "plain version on CPU tensors)")
def _engine_pallas():
    return _integrator_entry("cuda", 4)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@entry("kernels.fdist_matvec_batched", "kernels",
       "bucketed fused distance-matvec kernel wrapper (B1)")
def _fdist():
    from repro_torch.kernels.fdist_matvec.ops import fdist_matvec_batched

    r = _rng()
    x = _t(r.standard_normal((4, 32), dtype=np.float32))
    y = _t(r.standard_normal((4, 48), dtype=np.float32))
    v = _t(r.standard_normal((4, 48, 2), dtype=np.float32))
    coeffs = _t(np.asarray([1.0, -0.5, 0.25], np.float32))

    def fwd(x, y, v, coeffs):
        return fdist_matvec_batched(x, y, v, coeffs, mode="poly")

    return fwd, (x, y, v, coeffs)


def _topo_inputs(n_coeffs):
    r = _rng()
    qf = _t(np.abs(r.standard_normal((1, 2, 64, 8), dtype=np.float32)))
    kf = _t(np.abs(r.standard_normal((1, 2, 64, 8), dtype=np.float32)))
    v = _t(r.standard_normal((1, 2, 64, 4), dtype=np.float32))
    coeffs = _t(np.asarray([1.0, -0.5, 0.25, -0.1][:n_coeffs], np.float32))
    return qf, kf, v, coeffs


@entry("kernels.topo_linear_attention.causal_exp", "kernels",
       "fused Alg.-1 masked linear attention, separable exp decay (B2)")
def _topo_attn_exp():
    from repro_torch.kernels.topo_linear_attention.ops import (
        topo_linear_attention)

    def fwd(qf, kf, v, coeffs):
        return topo_linear_attention(qf, kf, v, coeffs, g="exp", causal=True,
                                     use_kernel=True)

    return fwd, _topo_inputs(2)


@entry("kernels.topo_linear_attention.bidir_rank", "kernels",
       "rank-R Chebyshev mask path, bidirectional (B2)")
def _topo_attn_rank():
    from repro_torch.kernels.topo_linear_attention.ops import (
        topo_linear_attention)

    def fwd(qf, kf, v, coeffs):
        return topo_linear_attention(qf, kf, v, coeffs, g="exp",
                                     causal=False, rank=8, use_kernel=True)

    return fwd, _topo_inputs(4)


# ---------------------------------------------------------------------------
# models + serve
# ---------------------------------------------------------------------------

def _lm_setup(**over):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api

    cfg = get_smoke_config("llama3_2_1b").replace(dtype="float32", **over)
    model = api.init_params(cfg, 0, device=CPU)
    tokens = _t(_rng().integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    return cfg, model, tokens


def _train_entry(**over):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg, model, tokens = _lm_setup(**over)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       weight_decay=0.0)
    step = make_train_step(cfg, ocfg, device=CPU)
    params = dict(model.named_parameters())

    def fwd(params, opt, batch):
        return step(model, opt, batch)[1:]  # (opt_state, metrics)

    return fwd, (params, adamw_init(params), {"tokens": tokens})


@entry("models.lm.train_step", "models", "LM train step (loss+grad+adamw)")
def _lm_train():
    return _train_entry()


@entry("models.topolm.train_step", "models",
       "topo-attention LM train step (fft mask impl)")
def _topolm_train():
    return _train_entry(attention_variant="topo", topo_attn_impl="fft")


def _vit_setup(**over):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import vit

    cfg = get_smoke_config("topovit_b16").replace(dtype="float32", **over)
    integ = vit.build_grid_integrator(cfg, device=CPU)
    model = vit.init_params(cfg, 0, num_classes=10, patch_dim=48, device=CPU)
    patches = _t(_rng().standard_normal(
        (2, cfg.num_prefix_embeddings, 48)).astype(np.float32))
    return cfg, integ, model, patches


@entry("models.topovit.forward", "models",
       "TopoViT forward with the 3-scalar RPE tree mask")
def _vit_forward():
    from repro_torch.models import vit

    cfg, integ, model, patches = _vit_setup()

    def fwd(params, patches):
        return vit.forward(cfg, model, patches, integ, device=CPU)

    return fwd, (dict(model.named_parameters()), patches)


@entry("serve.prefill_into_cache", "serve",
       "fused whole-prompt prefill (one call per pow2 bucket)")
def _prefill():
    from repro_torch.models import api

    cfg, model, tokens = _lm_setup()
    S = 32
    cache = api.init_cache(cfg, 2, S, device=CPU)
    lengths = _t(np.asarray([16, 9], np.int32))

    def fwd(params, cache, tokens, lengths):
        return api.prefill_into_cache(cfg, model, cache, tokens, lengths, S,
                                      device=CPU)

    return fwd, (dict(model.named_parameters()), cache, tokens, lengths)


# ---------------------------------------------------------------------------
# sharded paths (a fake group of 8 ranks, this process rank 0)
# ---------------------------------------------------------------------------

def _sharded_fastmult_entry(tree_or_forest, fn, d):
    import repro_torch.ftfi as ftfi

    mesh = _mesh24()
    spec, params = ftfi.build(tree_or_forest, device=CPU)
    X = _t(_rng().standard_normal((spec.n, d), dtype=np.float32))
    fm = ftfi.sharded_fastmult(spec, fn, mesh=mesh, device=CPU)
    # each rank's rows of the result (a DTensor sharded by rows)
    return ((lambda leaves, X: fm(params, X).to_local()),
            (_plan_leaves(params), X))


@entry("sharded.ftfi.fastmult.tree", "sharded",
       "multi-rank executor over the data axis", context=_fake_group8)
def _sharded_tree():
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import random_tree

    return _sharded_fastmult_entry(random_tree(120, seed=1),
                                   C.Exponential(-0.5), 2)


@entry("sharded.ftfi.fastmult.forest", "sharded",
       "sharded forest plan: the same collectives", context=_fake_group8)
def _sharded_forest():
    from repro_torch.core import cordial as C
    from repro_torch.graphs.graph import Forest, random_tree

    fo = Forest([random_tree(40 + 7 * i, seed=i) for i in range(3)])
    return _sharded_fastmult_entry(fo, C.Exponential(-0.4), 3)


@entry("sharded.models.topovit.forward", "sharded",
       "TopoViT forward with cfg.topo_shard_plan on a (2,4) mesh",
       context=_fake_group8)
def _sharded_vit():
    from repro_torch.launch import sharding as SH
    from repro_torch.models import vit

    mesh = _mesh24()
    cfg, integ, model, patches = _vit_setup(topo_shard_plan=True)

    def fwd(params, patches):
        with SH.use_sharding(mesh):
            return vit.forward(cfg, model, patches, integ, device=CPU)

    return fwd, (dict(model.named_parameters()), patches)
