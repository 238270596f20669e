"""`torch` backend: the bucketed plan executor behind the `Integrator`
facade, over the functional core (`repro_torch.core.plan_api`).

The executor and the batched cross engines (polynomial / exponential /
hankel_fft / chebyshev) live in `plan_api`; this module keeps the legacy
entry points on top of them:

  execute_plan(plan, X, fn_eval, ...)   derives the plan's (spec, params)
                                        pair and runs the executor
  PlanBackend                           derives (spec, params) lazily from
                                        the compiled plan and memoizes the
                                        bound X -> M_f X closures

so every Integrator runs through the same `_execute(spec, params, ...)`
that `ftfi.apply` exposes directly. There is no compile step: the memo
saves the engine selection (`select_cross`) and the closure's binding.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.analysis import trace_guard
from repro_torch.core import plan_api
from repro_torch.core.engines.base import register_backend
from repro_torch.core.engines.spec import FamilySpec, spec_of
from repro_torch.core.integrate import (IntegrationPlan, compile_forest_plan,
                                        compile_plan)
from repro_torch.core.lru import BoundedLRU
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import Forest


# ----------------------------------------------------------------------------
# executor (legacy entry point over the functional core)
# ----------------------------------------------------------------------------


def execute_plan(plan: IntegrationPlan, X, fn_eval: Callable,
                 batched_matvec: Callable | None = None, degree: int = 32,
                 cross_multiply: Callable | None = None, device=None):
    """Integrate field X (n, d) with scalar function `fn_eval` (torch
    evaluable) on `device` (None: the CUDA card).

    Splits the plan into its functional (spec, params) pair and runs
    `plan_api._execute`. `cross_multiply(cb, Xp)` (the CrossBucket form)
    and `batched_matvec(tgt_d, tgt_mask, src_d, src_mask, Xp)` are
    accepted; both default to batched Chebyshev interpolation
    (spectral-exact for smooth fn_eval, differentiable in its
    parameters)."""
    dev = resolve_device(device)
    spec, params = plan_api.specialize(plan, dev)
    if cross_multiply is not None:
        legacy = cross_multiply

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            return legacy(plan.cross_buckets[i], Xp)

    elif batched_matvec is not None:
        bm = batched_matvec

        def cross(i, tgt_d, tgt_mask, src_d, src_mask, Xp):
            return bm(tgt_d, tgt_mask, src_d, src_mask, Xp)

    else:
        _, cross = plan_api.select_cross(
            spec, FamilySpec(None, (), fn_eval, None), degree=degree)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    return plan_api._execute(spec, params, fn_eval, cross, X)


# ----------------------------------------------------------------------------
# backend
# ----------------------------------------------------------------------------


class _PlanFastMult:
    """One memoized X -> M_f X closure per (plan, device, f-family): the
    engine chosen once, the plan's params bound. X (numpy or torch) is
    moved to the device as float32, as `ftfi.apply` moves it. Its first
    call at each field shape records `engines.plan.fastmult` in
    `analysis.trace_guard`, where the reference's jitted closure traces."""

    def __init__(self, spec, params, fspec: FamilySpec, cross: Callable,
                 device: torch.device):
        self.spec, self.params = spec, params
        self._fe, self._cross, self._device = fspec.fn_eval, cross, device
        self._seen: set = set()

    def __call__(self, X):
        X = torch.as_tensor(X, dtype=torch.float32, device=self._device)
        if X.shape not in self._seen:
            self._seen.add(X.shape)
            trace_guard.record("engines.plan.fastmult")
        return plan_api._execute(self.spec, self.params, self._fe,
                                 self._cross, X)


@register_backend("torch")
class PlanBackend:
    """Bucketed static-shape executor; cross engine chosen per f family:
    exact polynomial/exponential LDR engines, the exact Hankel/FFT engine on
    grid-aligned trees, Chebyshev interpolation otherwise.

    The (content-cached) plan splits lazily into the functional
    (spec, params) pair, exposed as `.spec` / `.params` for the `ftfi`
    entry points; params live on `device` (None: the CUDA card) and are
    memoized on the plan per device, so Integrators over one topology
    share them. `fastmult` closures are memoized per family spec, so
    repeated `integrate` calls bind no engine again; `bind_count` counts
    the closures this instance bound."""

    name = "torch"

    def __init__(self, tree, leaf_size: int = 64, seed: int = 0,
                 degree: int = 32, detect_grid_spacing: bool = True,
                 reweightable: bool = False, use_cache: bool = True,
                 plan: IntegrationPlan | None = None, params=None,
                 device=None):
        self.device = resolve_device(device)
        # a Forest compiles into ONE fused plan over the packed vertex space:
        # the executor is oblivious to how many trees it covers
        self.forest = tree if isinstance(tree, Forest) else None
        if plan is not None:  # the facade over an artifact: no IT rebuild
            self.plan = plan
        elif self.forest is not None:
            self.plan = compile_forest_plan(
                self.forest, leaf_size=leaf_size, seed=seed,
                detect_grid_spacing=detect_grid_spacing,
                use_cache=use_cache, reweightable=reweightable)
        else:
            self.plan = compile_plan(tree, leaf_size=leaf_size, seed=seed,
                                     detect_grid_spacing=detect_grid_spacing,
                                     use_cache=use_cache,
                                     reweightable=reweightable)
        self.degree = degree
        self.bind_count = 0
        # params per device, memoized ON the plan: plans are content-hash
        # cached, so repeated Integrator construction over one topology
        # makes one device copy
        on = getattr(self.plan, "_params_on", None)
        if on is None:
            on = {}
            self.plan._params_on = on
        if params is not None:
            on[str(self.device)] = plan_api._params_on(params, self.device)
        self._on = on
        # the semantically keyed fastmult memo lives ON the plan object too,
        # so repeated construction reuses the bound closures. Keys start
        # with the backend name and the device, so backends sharing one
        # plan never serve each other's closures. Opaque
        # id()-keyed fns stay in a per-instance memo: sharing them would
        # pin arbitrary closures for the plan cache's lifetime.
        cache = getattr(self.plan, "_fm_cache", None)
        if cache is None:
            cache = BoundedLRU(64)
            self.plan._fm_cache = cache
        self._fm_cache = cache
        self._fm_cache_local = BoundedLRU(64)

    @property
    def spec(self):
        return plan_api._plan_spec(self.plan)

    @property
    def params(self):
        key = str(self.device)
        p = self._on.get(key)
        if p is None:
            p = plan_api.specialize(self.plan, self.device)[1]
            self._on[key] = p
        return p

    @property
    def grid_h(self):
        return self.spec.grid_h

    def select_cross(self, fspec: FamilySpec):
        """(engine_name, cross_multiply) for this f family."""
        return plan_api.select_cross(self.spec, fspec, backend=self.name,
                                     degree=self.degree)

    def describe(self, fn) -> dict:
        name, _ = self.select_cross(spec_of(fn))
        d = {"backend": self.name, "cross_engine": name,
             "grid_h": self.grid_h}
        # as the host backend: every Forest-built integrator reports its
        # tree count; from_plan facades whenever the spec has more than one
        if self.forest is not None or self.spec.num_trees > 1:
            d["num_trees"] = self.spec.num_trees
        return d

    def integrate(self, fn, X):
        return self.fastmult(fn)(X)

    def fastmult(self, fn) -> Callable:
        """Memoized closure X -> M_f X over this backend's (spec, params).
        Keyed semantically by (mode, coeffs, scale) for the structured
        families, so equal f objects share one closure, and by object
        identity for opaque callables."""
        fspec = spec_of(fn)
        prefix = (self.name, str(self.device))
        if fspec.mode is not None:  # semantic key: shared across instances
            cache = self._fm_cache
            key = prefix + (fspec.mode, fspec.coeffs, fspec.scale,
                            self.degree)
        else:  # id key: per instance, freed with this backend
            cache = self._fm_cache_local
            key = prefix + (None, id(fn), self.degree)
        hit = cache.get(key)
        if hit is not None:
            return hit[0]
        _, cross = self.select_cross(fspec)
        self.bind_count += 1
        fm = _PlanFastMult(self.spec, self.params, fspec, cross, self.device)
        # pin `fn` alongside: id-based keys must not outlive their object
        cache.put(key, (fm, fn))
        return fm
