"""Backend registry + the `Integrator` entry point.

Every integration backend registers itself under a short name and
implements:

    __init__(tree, leaf_size=..., seed=..., device=..., **opts)
    integrate(fn, X) -> out          # fn: CordialFn or torch callable
    fastmult(fn) -> Callable[X, out] # memoized per f family
    describe(fn) -> dict             # chosen cross engine etc.
    grid_h -> float | None           # common distance grid, if any

`Integrator(tree, backend="cuda").integrate(fn, X)` is the one public API;
`Integrator.from_forest(forest, ...)` is the same API over a packed Forest
of trees (one fused plan, block-diagonal multiply), and
`Integrator.from_plan(spec, params)` over a loaded `(spec, params)` pair.

Backends: "host" (the recursive numpy FTFI and ExpMP), "torch" (the plan
executor with the plain PyTorch engines; the reference's "plan") and
"cuda" (the plan executor with the fdist_matvec kernel for the
poly/exp/expq/rational families; the reference's "pallas").
"""
from __future__ import annotations

import warnings
from typing import Callable, Type

_REGISTRY: dict[str, type] = {}


def register_backend(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str) -> Type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


class Integrator:
    """Unified tree-field integrator with swappable structured-multiply
    backends.

    >>> integ = Integrator(tree, backend="cuda")      # plan on the card
    >>> out = integ.integrate(Exponential(-0.5), X)   # == BTFI, fast

    `device=None` means the CUDA card for the plan backends ("torch",
    "cuda"): without one they raise unless `device="cpu"` is given. The
    "host" backend runs on numpy whatever the device: a numpy field comes
    back as numpy, a tensor on its own device and dtype."""

    def __init__(self, tree, backend: str = "torch", *, leaf_size: int = 64,
                 seed: int = 0, device=None, **opts):
        self.backend = backend
        self._impl = get_backend(backend)(tree, leaf_size=leaf_size,
                                          seed=seed, device=device, **opts)

    @classmethod
    def from_forest(cls, forest, backend: str = "torch", *,
                    leaf_size: int = 64, seed: int = 0, device=None, **opts):
        """Integrator over a whole `Forest` of trees with the packed-field
        API: fields are (sum_t n_t, d), vertex v of tree t at row
        `forest.offsets[t] + v` (see `Forest.pack`/`unpack`/`broadcast`).

        On the plan backends the forest compiles into ONE fused plan, so
        `integrate` runs every tree in the same handful of gather /
        segment-sum / scatter launches. The host backend runs a per-tree
        loop, the baseline the fused path is held against.

        >>> forest = Forest([mst(g) for g in graphs])
        >>> integ = Integrator.from_forest(forest, backend="cuda")
        >>> out = integ.integrate(Exponential(-0.5), forest.pack(fields))
        """
        from repro_torch.graphs.graph import Forest

        if not isinstance(forest, Forest):
            raise TypeError(
                f"from_forest expects a Forest, got {type(forest).__name__}; "
                "wrap your trees: Integrator.from_forest(Forest(trees))")
        return cls(forest, backend=backend, leaf_size=leaf_size, seed=seed,
                   device=device, **opts)

    @classmethod
    def from_plan(cls, spec, params=None, backend: str = "torch", *,
                  device=None, **opts):
        """Facade over a functional (spec, params) pair, e.g. an
        `ftfi.load_plan` artifact (this package's or the reference's).
        Never touches the IT/plan builders, so a serving restart pays one
        file read instead of an O(N log N) decomposition. The pair passes
        the plan guard first (FTFI_PLAN_GUARD policy): the fused executor
        does no bounds checking of its own. `params=None` takes the
        spec's build-time distances."""
        if backend not in ("torch", "cuda"):
            raise ValueError(
                f"from_plan supports the torch/cuda backends, not "
                f"{backend!r} (the host backend has no plan to load)")
        from repro_torch.core import plan_api, plan_guard

        plan_guard.validate(spec, params, where="Integrator.from_plan")
        obj = cls.__new__(cls)
        obj.backend = backend
        obj._impl = get_backend(backend)(
            None, plan=plan_api.plan_from_spec(spec), params=params,
            device=device, **opts)
        return obj

    @property
    def spec(self):
        """Static `PlanSpec` of the compiled plan (None on the host
        backend): the functional half `ftfi.apply` consumes."""
        return getattr(self._impl, "spec", None)

    @property
    def params(self):
        """`PlanParams` on the Integrator's device (None on the host
        backend)."""
        return getattr(self._impl, "params", None)

    @property
    def num_trees(self):
        """Number of trees (1 for single-tree integrators)."""
        forest = getattr(self._impl, "forest", None)
        if forest is not None:
            return forest.num_trees
        spec = getattr(self._impl, "spec", None)
        return spec.num_trees if spec is not None else 1

    @property
    def grid_h(self):
        """Common grid spacing of all IT distances (None if not
        grid-aligned). Grid-weight trees (e.g. unit-weight MSTs) select the
        exact Hankel/FFT cross engine for otherwise-unstructured f."""
        return self._impl.grid_h

    def integrate(self, fn, X):
        return self._impl.integrate(fn, X)

    def fastmult(self, fn) -> Callable:
        """Deprecated closure-capturing path: the returned X -> M_f X
        closure captures the plan's state. Use the functional API,
        `ftfi.fastmult(integ.spec, fn)(integ.params, X)`, which passes
        params explicitly (differentiable, serializable)."""
        warnings.warn(
            "Integrator.fastmult returns a plan-capturing closure; use "
            "ftfi.fastmult(spec, fn) with (spec, params) = ftfi.build(tree) "
            "instead", DeprecationWarning, stacklevel=2)
        return self._impl.fastmult(fn)

    def describe(self, fn) -> dict:
        return self._impl.describe(fn)

    def __repr__(self):
        return f"Integrator(backend={self.backend!r}, grid_h={self.grid_h})"
