"""Cordial functions: the f families of M = [f(x_i + y_j)] (paper Sec 3.2.1).

Each `CordialFn` is a host-side description of f, evaluable on numpy arrays;
`core.engines.spec.spec_of` turns it into the torch-evaluable `FamilySpec`
that the plan executor and the fdist_matvec kernel consume. `detect_grid` finds
the common spacing h of grid-aligned distances, which selects the exact
Hankel/FFT engine.

The host matvecs of the reference (its recursive FTFI walk) are not part of
this package yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


def detect_grid(x, y, tol=1e-9) -> float | None:
    """Find spacing h such that all x,y are (close to) integer multiples of h.

    Uses a float-gcd; returns None if no reasonable grid exists (h too small).
    """
    vals = np.abs(np.concatenate([np.asarray(x).ravel(), np.asarray(y).ravel()]))
    vals = np.unique(vals[vals > tol])  # dedupe: the gcd loop is per-value
    if vals.size == 0:
        return 1.0
    # fast path: the smallest value divides everything (unit/rational-weight
    # trees) — one vectorized residual check instead of the gcd loop. Below
    # the 1e-7 noise floor the residual test is meaningless (tol-scale
    # values pass it spuriously), so such inputs take the gcd loop, which
    # rejects them exactly as before.
    h = float(vals[0])
    mult = vals / h
    if h >= 1e-7 and float(np.max(np.abs(vals - np.round(mult) * h))) <= tol:
        return None if float(vals[-1] / h) > 5e6 else h
    g = h
    for v in vals[1:]:
        g = _fgcd(g, float(v), tol)
        if g < 1e-7:
            return None
    span = float(vals.max() / g)
    if span > 5e6:  # FFT length would be impractical
        return None
    return g


def _fgcd(a, b, tol):
    while b > tol:
        a, b = b, a % b
        if b > tol and b / a > 1 - 1e-12:
            b = 0.0
    return a


@dataclasses.dataclass
class CordialFn:
    """A scalar function f of M = [f(x_i+y_j)], evaluable on numpy arrays.
    The subclass picks the structured-multiply family (`spec_of`)."""

    def __call__(self, z):
        raise NotImplementedError

    @property
    def f0(self):
        """f(0) — used by the integrator's pivot correction."""
        return float(self(np.zeros(1))[0])


@dataclasses.dataclass
class Polynomial(CordialFn):
    coeffs: tuple  # c_0..c_B

    def __call__(self, z):
        out = 0.0
        for c in reversed(self.coeffs):
            out = out * z + c
        return out


@dataclasses.dataclass
class Exponential(CordialFn):
    lam: float
    scale: float = 1.0

    def __call__(self, z):
        return self.scale * np.exp(self.lam * z)


@dataclasses.dataclass
class ExpPoly(CordialFn):
    """f(z) = exp(lam z) * poly(z)."""

    lam: float
    coeffs: tuple

    def __call__(self, z):
        p = 0.0
        for c in reversed(self.coeffs):
            p = p * z + c
        return np.exp(self.lam * z) * p


@dataclasses.dataclass
class Trigonometric(CordialFn):
    omega: float
    phi: float = 0.0
    kind: str = "cos"

    def __call__(self, z):
        fn = np.cos if self.kind == "cos" else np.sin
        return fn(self.omega * z + self.phi)


@dataclasses.dataclass
class Rational(CordialFn):
    """f(z) = poly_num(z) / poly_den(z) (Sec 4.3's learnable family).

    Strategy: the fdist_matvec kernel for the form a / (d0 + d2 z^2); else
    exact Hankel/FFT when distances are grid-aligned (rational tree
    weights), else Chebyshev.
    """

    num: tuple
    den: tuple
    tol: float = 1e-10
    degree: int = 32

    def __call__(self, z):
        n = 0.0
        for c in reversed(self.num):
            n = n * z + c
        d = 0.0
        for c in reversed(self.den):
            d = d * z + c
        return n / d


@dataclasses.dataclass
class ExpQuadratic(CordialFn):
    """f(z) = exp(u z^2 + v z + w) — the paper's best ViT-variant family.

    Exact in the fdist_matvec kernel, or via the rational-weight Hankel
    embedding (== the paper's D1·Vandermonde·D2 route); Chebyshev fallback
    for irrational weights.
    """

    u: float
    v: float
    w: float = 0.0
    tol: float = 1e-10
    degree: int = 48

    def __call__(self, z):
        return np.exp(self.u * z * z + self.v * z + self.w)


@dataclasses.dataclass
class ExpRational(CordialFn):
    """f(z) = exp(lam z) / (z + c), c > 0 — the paper's Cauchy-LDR example."""

    lam: float
    c: float
    tol: float = 1e-11
    degree: int = 32

    def __call__(self, z):
        return np.exp(self.lam * z) / (z + self.c)


@dataclasses.dataclass
class AnyFn(CordialFn):
    """Arbitrary callable f (torch-evaluable for the plan executor);
    Hankel-exact on grids, else Chebyshev."""

    fn: Callable
    tol: float = 1e-9
    degree: int = 48

    def __call__(self, z):
        return self.fn(z)
