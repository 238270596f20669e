"""FamilySpec: one normalized description of f shared by every backend.

Backends dispatch on `mode` — the structured-multiply family of f:

  mode        f(s)                          exact engines available
  ----------  ----------------------------  --------------------------------
  "poly"      sum_t coeffs[t] s^t           polynomial LDR, CUDA in-kernel
  "exp"       coeffs[1] * exp(coeffs[0] s)  rank-1, CUDA in-kernel
  "expq"      exp(c0 s^2 + c1 s + c2)       CUDA in-kernel, Hankel on grids
  "rational"  scale / (1 + c0 s^2)          CUDA in-kernel, Hankel on grids
  None        anything                      Hankel on grids, else Chebyshev

`coeffs` follows the layout of kernels/fdist_matvec (`f_eval`); `scale` is a
scalar multiplier applied OUTSIDE the kernel families that don't carry one.
`fn_eval` evaluates the full f (scale included) on torch tensors; it serves
leaf blocks, pivot corrections and the Chebyshev/Hankel engines.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import cordial as C


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    mode: str | None
    coeffs: tuple
    fn_eval: Callable  # full f on torch tensors
    cordial: C.CordialFn  # host-side description of f
    scale: float = 1.0


def _horner(coeffs):
    def f(z):
        acc = 0.0
        for c in reversed(coeffs):
            acc = acc * z + c
        return acc

    return f


def spec_of(fn) -> FamilySpec:
    """Classify `fn` (a CordialFn or a plain torch-evaluable callable)."""
    if isinstance(fn, C.Polynomial):
        cs = tuple(float(c) for c in fn.coeffs)
        return FamilySpec("poly", cs, _horner(cs), fn)
    if isinstance(fn, C.Exponential):
        lam, s = float(fn.lam), float(fn.scale)
        return FamilySpec("exp", (lam, s), lambda z: s * torch.exp(lam * z),
                          fn)
    if isinstance(fn, C.ExpQuadratic):
        u, v, w = float(fn.u), float(fn.v), float(fn.w)
        return FamilySpec(
            "expq", (u, v, w), lambda z: torch.exp(u * z * z + v * z + w), fn)
    if isinstance(fn, C.Rational):
        num, den = tuple(map(float, fn.num)), tuple(map(float, fn.den))
        if (len(num) == 1 and len(den) == 3 and den[0] > 0.0 and den[1] == 0.0
                and den[2] >= 0.0):
            # a / (d0 + d2 s^2) = (a/d0) * 1/(1 + (d2/d0) s^2)
            c0 = den[2] / den[0]
            scale = num[0] / den[0]
            return FamilySpec(
                "rational", (c0,),
                lambda z: scale / (1.0 + c0 * z * z), fn, scale=scale)
        pn, pd = _horner(num), _horner(den)
        return FamilySpec(None, (), lambda z: pn(z) / pd(z), fn)
    if isinstance(fn, C.ExpPoly):
        lam, cs = float(fn.lam), tuple(map(float, fn.coeffs))
        p = _horner(cs)
        return FamilySpec(None, (), lambda z: torch.exp(lam * z) * p(z), fn)
    if isinstance(fn, C.Trigonometric):
        om, ph = float(fn.omega), float(fn.phi)
        trig = torch.cos if fn.kind == "cos" else torch.sin
        return FamilySpec(None, (), lambda z: trig(om * z + ph), fn)
    if isinstance(fn, C.ExpRational):
        lam, c = float(fn.lam), float(fn.c)
        return FamilySpec(None, (), lambda z: torch.exp(lam * z) / (z + c),
                          fn)
    if isinstance(fn, C.AnyFn):
        return FamilySpec(None, (), fn.fn, fn)
    if isinstance(fn, C.CordialFn):
        return FamilySpec(None, (), fn, fn)
    if callable(fn):  # plain torch-evaluable callable
        return FamilySpec(None, (), fn, C.AnyFn(fn))
    raise TypeError(f"cannot build a FamilySpec from {type(fn).__name__}")
