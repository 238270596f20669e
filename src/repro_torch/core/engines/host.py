"""`host` backend: the recursive numpy FTFI (exact per-node LDR engines).

Per-node structured multiplies come from each CordialFn's own `matvec`
(see core.cordial's engine table). Pure-exponential f dispatches to the
two-pass ExpMP message-passing integrator instead: O(N d), no IT walk.
ITNode is immutable, so one backend instance is thread-safe.

The walk runs on the host because the caller named this backend: it is no
fallback of the plan backends. A numpy field comes back as numpy; a torch
field is read to the host and the result returned on the field's own
device and dtype. The Integrator's `device` is not used here.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import cordial as C
from repro_torch.core.engines.base import register_backend
from repro_torch.core.engines.spec import spec_of
from repro_torch.core.integrate import FTFI, ExpMP
from repro_torch.graphs.graph import Forest
from repro_torch.graphs.traverse import tree_distances_from


@register_backend("host")
class HostBackend:
    name = "host"

    def __init__(self, tree, leaf_size: int = 64, seed: int = 0,
                 use_expmp: bool = True, device=None):
        # a Forest runs as a per-tree Python loop here: the host backend is
        # the reference the fused forest plan is held against
        self.forest = tree if isinstance(tree, Forest) else None
        if self.forest is not None:
            self._ftfis = [FTFI(t, leaf_size=leaf_size, seed=seed)
                           for t in self.forest.trees]
            self._expmps = ([ExpMP(t) for t in self.forest.trees]
                            if use_expmp else None)
            hs = [self._detect_grid_h(t) for t in self.forest.trees]
            if any(h is None for h in hs):
                self._grid_h = None
            else:
                # the forest's common grid is the gcd of per-tree spacings
                self._grid_h = C.detect_grid(np.asarray(hs), np.zeros(1))
            return
        self.ftfi = FTFI(tree, leaf_size=leaf_size, seed=seed)
        self._expmp = ExpMP(tree) if use_expmp else None
        self._grid_h = self._detect_grid_h(tree)

    @staticmethod
    def _detect_grid_h(tree):
        """Same semantics as IntegrationPlan.grid_h: grid-aligned edge
        weights AND an FFT-practical span (detect_grid's cap applied to the
        realized distance scale, bounded here by the tree diameter)."""
        h = C.detect_grid(tree.weights, np.zeros(1))
        if h is None or tree.num_vertices < 2:
            return h
        far = int(np.argmax(tree_distances_from(tree, 0)))
        diameter = float(np.max(tree_distances_from(tree, far)))
        return None if diameter / h > 5e6 else h

    @property
    def grid_h(self):
        return self._grid_h

    def describe(self, fn) -> dict:
        use_expmp = (self._expmps if self.forest is not None
                     else self._expmp) is not None
        engine = ("exp_message_passing"
                  if spec_of(fn).mode == "exp" and use_expmp
                  else "recursive_ftfi")
        d = {"backend": self.name, "cross_engine": engine,
             "grid_h": self.grid_h}
        if self.forest is not None:
            d["num_trees"] = self.forest.num_trees
        return d

    def _integrate_np(self, spec, X: np.ndarray) -> np.ndarray:
        if self.forest is not None:
            off = self.forest.offsets
            outs = []
            for i in range(self.forest.num_trees):
                Xi = X[off[i]:off[i + 1]]
                if spec.mode == "exp" and self._expmps is not None:
                    lam, scale = spec.coeffs
                    outs.append(self._expmps[i].integrate(lam, Xi,
                                                          scale=scale))
                else:
                    outs.append(self._ftfis[i].integrate(spec.cordial, Xi))
            return np.concatenate(outs, axis=0)
        if spec.mode == "exp" and self._expmp is not None:
            lam, scale = spec.coeffs
            return self._expmp.integrate(lam, X, scale=scale)
        return self.ftfi.integrate(spec.cordial, X)

    def integrate(self, fn, X):
        spec = spec_of(fn)
        if isinstance(X, torch.Tensor):
            out = self._integrate_np(spec, X.detach().cpu().numpy())
            return torch.from_numpy(np.ascontiguousarray(out)).to(
                device=X.device, dtype=X.dtype)
        return self._integrate_np(spec, np.asarray(X))

    def fastmult(self, fn) -> Callable:
        return lambda X: self.integrate(fn, X)
