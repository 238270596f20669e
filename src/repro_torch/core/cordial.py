"""Cordial functions: fast multiplication with matrices M = [f(x_i + y_j)]
(paper Sec 3.2.1).

Each `CordialFn` is a host-side description of f, evaluable on numpy
arrays, with the structured multiply of its family (`matvec`), which the
recursive host integrator (`integrate.FTFI`) calls at every IT node;
`core.engines.spec.spec_of` turns it into the torch-evaluable `FamilySpec`
that the plan executor and the fdist_matvec kernel consume.

  engine        f class                         exact?   complexity
  ------------  ------------------------------  -------  -----------------
  dense         any                             yes      O(a·b·d)
  polynomial    sum_t c_t x^t                   yes      O((a+b)·B·d)
  exponential   s·exp(λx)                       yes      O((a+b)·d)      (rank 1)
  exp_poly      poly(x)·exp(λx)                 yes      O((a+b)·B·d)
  trigonometric cos/sin(ωx+φ)                   yes      O((a+b)·d)      (rank 2)
  hankel_fft    ANY f, grid-aligned x,y         yes      O(L log L·d), L=grid span
  chebyshev     any f analytic near [lo,hi]     ~eps     O((a+b)·r·d + r²·d)
                (adaptive bisection to `tol`:
                 rational f, Cauchy-LDR)

The host matvecs run on numpy, in float64 unless the field is float32
(the plan executor's torch engines live in `plan_api`). Shapes: x (a,),
y (b,), V (b, d) -> out (a, d). `detect_grid` finds the common spacing h
of grid-aligned distances, which selects the exact Hankel/FFT engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

# ----------------------------------------------------------------------------
# low-level host engines (numpy)
# ----------------------------------------------------------------------------


def dense_matvec(f: Callable, x, y, V):
    M = f(x[:, None] + y[None, :])
    return M @ V


def polynomial_matvec(coeffs, x, y, V):
    """f(z) = sum_t coeffs[t] z^t. Exact low-rank outer-product decomposition.

    M = sum_t c_t sum_l C(t,l) x^l (y^{t-l})  =>  out = Xpow @ W,
      S[u]  = sum_j y_j^u V[j]
      W[l]  = sum_{t>=l} c_t C(t,l) S[t-l]
    """
    coeffs = np.asarray(coeffs)
    B = coeffs.shape[0] - 1
    xp_pows = _powers(x, B)  # (a, B+1)
    yp_pows = _powers(y, B)  # (b, B+1)
    S = yp_pows.T @ V  # (B+1, d)
    binom = _binom_table(B)
    # W[l] = sum_t c_t binom[t, l] S[t-l]  for t in [l, B]
    d = V.shape[1:]
    W = np.zeros((B + 1,) + d, dtype=V.dtype)
    for l in range(B + 1):
        acc = 0.0
        for t in range(l, B + 1):
            acc = acc + coeffs[t] * binom[t, l] * S[t - l]
        W[l] = acc
    return xp_pows @ W.reshape(B + 1, -1) if len(d) > 1 else xp_pows @ W


def _powers(x, B):
    pows = [np.ones_like(x)]
    for _ in range(B):
        pows.append(pows[-1] * x)
    return np.stack(pows, axis=-1)


def _binom_table(B):
    tbl = np.zeros((B + 1, B + 1))
    for t in range(B + 1):
        for l in range(t + 1):
            tbl[t, l] = math.comb(t, l)
    return tbl


def exponential_matvec(lam, x, y, V, scale=1.0):
    """f(z) = scale * exp(lam * z). Rank-1, numerically shifted."""
    ly = lam * y
    m = np.max(ly) if y.shape[0] else 0.0
    t = np.exp(ly - m) @ V  # (d,)
    return scale * np.exp(lam * x + m)[:, None] * t[None, :]


def exp_poly_matvec(lam, coeffs, x, y, V):
    """f(z) = exp(lam z) * poly(z). Hadamard of rank-1 and low-rank (A.2.3)."""
    ly = lam * y
    m = np.max(ly) if y.shape[0] else 0.0
    Vexp = np.exp(ly - m)[:, None] * V
    out = polynomial_matvec(coeffs, x, y, Vexp)
    return np.exp(lam * x + m)[:, None] * out


def trig_matvec(omega, phi, x, y, V, kind="cos"):
    """f(z) = cos(w z + phi) (or sin). Rank-2 via angle addition."""
    cx, sx = np.cos(omega * x + phi), np.sin(omega * x + phi)
    cy, sy = np.cos(omega * y), np.sin(omega * y)
    Sc = cy @ V
    Ss = sy @ V
    if kind == "cos":  # cos(A+B) = cosA cosB - sinA sinB
        return cx[:, None] * Sc[None, :] - sx[:, None] * Ss[None, :]
    # sin(A+B) = sinA cosB + cosA sinB
    return sx[:, None] * Sc[None, :] + cx[:, None] * Ss[None, :]


def snap_to_grid(x, h, tol=1e-6):
    """Integer grid indices of x w.r.t. spacing h; raises if not grid-aligned."""
    ix = x / h
    ri = np.round(ix)
    if np.max(np.abs(ix - ri)) > tol:
        raise ValueError("values are not aligned to the grid")
    return ri.astype(np.int64)


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


def hankel_fft_matvec(f: Callable, x, y, V, h: float):
    """Exact multiply for ANY f when x, y lie on a common grid of spacing h.

    This is the paper's 'trees with positive rational weights' embedding
    (App. A.2.3) and subsumes the Vandermonde case used by its best ViT
    variants: M embeds into a Hankel matrix; multiplication by correlation
    with the sampled kernel F[k] = f(k·h) via FFT, O(L log L).
    """
    ix = snap_to_grid(x, h)  # (a,)
    iy = snap_to_grid(y, h)  # (b,)
    max_ix = int(ix.max()) if ix.size else 0
    max_iy = int(iy.max()) if iy.size else 0
    L = max_ix + max_iy + 1
    F = f(h * np.arange(L, dtype=np.float64))  # (L,)
    # scatter V by iy:  P[m] = sum_{j: iy[j]=m} V[j]
    d = V.shape[1]
    P = np.zeros((max_iy + 1, d), dtype=np.result_type(V.dtype, np.float64))
    np.add.at(P, iy, V)
    out_full = fft_correlate(F, P)  # out_full[k] = sum_m F[k+m] P[m]
    return out_full[ix].astype(V.dtype)


def fft_correlate(F, P):
    """out[k] = sum_m F[k+m] P[m] for k in [0, len(F)-1]; zero-padded FFT."""
    L = F.shape[0]
    m = P.shape[0]
    n = 1 << int(np.ceil(np.log2(L + m)))
    Ff = np.fft.rfft(F, n=n)
    # correlation = conv with reversed P
    Pf = np.fft.rfft(P[::-1], n=n, axis=0)
    full = np.fft.irfft(Ff[:, None] * Pf, n=n, axis=0)
    # index k of correlation sits at position k + m - 1 of the convolution
    return full[m - 1: m - 1 + L]


def chebyshev_points(lo, hi, r):
    k = np.arange(r)
    t = np.cos((2 * k + 1) * np.pi / (2 * r))  # Chebyshev nodes of 1st kind
    return (lo + hi) / 2.0 + (hi - lo) / 2.0 * t


def _barycentric_weights(nodes):
    # for Chebyshev 1st-kind nodes: w_k = (-1)^k sin((2k+1)pi/(2r))
    r = nodes.shape[0]
    k = np.arange(r)
    return (-1.0) ** k * np.sin((2 * k + 1) * np.pi / (2 * r))


def lagrange_matrix(pts, nodes):
    """L[i, k] = k-th Lagrange cardinal function at pts[i] (barycentric)."""
    w = _barycentric_weights(np.asarray(nodes))
    diff = pts[:, None] - nodes[None, :]
    # handle exact hits
    small = np.abs(diff) < 1e-14
    diff = np.where(small, 1.0, diff)
    terms = w[None, :] / diff
    L = terms / np.sum(terms, axis=1, keepdims=True)
    any_small = np.any(small, axis=1, keepdims=True)
    return np.where(any_small, small.astype(L.dtype), L)


def chebyshev_matvec(f: Callable, x, y, V, degree: int = 32,
                     tol: float | None = None, _depth: int = 0):
    """Low-rank multiply via 2D Chebyshev interpolation of f(x+y).

    f(x_i+y_j) ~= sum_{k,l} B[k,l] Lx[i,k] Ly[j,l],  B[k,l] = f(xc_k + yc_l).
    Spectral accuracy for f analytic in a neighbourhood of [x_lo+y_lo,
    x_hi+y_hi]. If `tol` is given, the x/y boxes are bisected adaptively
    (H-matrix style) until the sampled interpolation error is below tol —
    this covers sharply-peaked rational f and Cauchy-like kernels.
    """
    if x.shape[0] == 0 or y.shape[0] == 0:
        return np.zeros((x.shape[0],) + V.shape[1:], dtype=V.dtype)
    x_lo, x_hi = float(np.min(x)), float(np.max(x))
    y_lo, y_hi = float(np.min(y)), float(np.max(y))
    xc = chebyshev_points(x_lo, x_hi + 1e-12, degree)
    yc = chebyshev_points(y_lo, y_hi + 1e-12, degree)
    B = f(xc[:, None] + yc[None, :])  # (r, r)
    Lx = lagrange_matrix(x, xc)  # (a, r)
    Ly = lagrange_matrix(y, yc)  # (b, r)
    out = Lx @ (B @ (Ly.T @ V))
    if tol is not None and _depth < 12:
        # sample a few entries to estimate error; bisect if too large
        rng = np.random.default_rng(0)
        na = min(16, x.shape[0])
        nb = min(16, y.shape[0])
        ii = rng.integers(0, x.shape[0], size=na)
        jj = rng.integers(0, y.shape[0], size=nb)
        approx = (Lx[ii] @ B @ Ly[jj].T)
        exact = f(x[ii][:, None] + y[jj][None, :])
        scale = max(np.max(np.abs(exact)), 1e-30)
        if np.max(np.abs(approx - exact)) / scale > tol:
            if x.shape[0] >= y.shape[0] and x.shape[0] > 2 * degree:
                sel = x <= (x_lo + x_hi) / 2.0
                out = np.empty((x.shape[0],) + V.shape[1:], dtype=out.dtype)
                out[sel] = chebyshev_matvec(f, x[sel], y, V, degree, tol,
                                            _depth + 1)
                out[~sel] = chebyshev_matvec(f, x[~sel], y, V, degree, tol,
                                             _depth + 1)
            elif y.shape[0] > 2 * degree:
                sel = y <= (y_lo + y_hi) / 2.0
                out = chebyshev_matvec(f, x, y[sel], V[sel], degree, tol,
                                       _depth + 1)
                out = out + chebyshev_matvec(f, x, y[~sel], V[~sel], degree,
                                             tol, _depth + 1)
            else:  # small block: dense (exact)
                out = dense_matvec(f, x, y, V)
    return out


def cauchy_matvec(p, q, V, degree: int = 24, tol: float = 1e-10):
    """out_i = sum_j V_j / (p_i + q_j); p_i + q_j > 0 required.

    The Cauchy-like LDR workhorse for f(x) = exp(lam x)/(x+c) (Sec 3.2.1):
    adaptive Chebyshev H-multiply, machine-precision configurable.
    """
    return chebyshev_matvec(lambda s: 1.0 / s, p, q, V, degree=degree,
                            tol=tol)


def _grid_or_chebyshev(f: Callable, x, y, V, degree: int, tol: float):
    """Hankel/FFT (exact) on grid-aligned x, y, else adaptive Chebyshev."""
    h = detect_grid(x, y)
    if h is not None:
        return hankel_fft_matvec(f, x, y, V, h)
    return chebyshev_matvec(f, x, y, V, degree=degree, tol=tol)


# ----------------------------------------------------------------------------
# CordialFn: f + a multiply strategy (the host API the recursive FTFI uses)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class CordialFn:
    """A scalar function f of M = [f(x_i+y_j)], evaluable on numpy arrays,
    with its structured multiply (`matvec`; the base class multiplies
    densely). The subclass picks the family (`spec_of`)."""

    def __call__(self, z):
        raise NotImplementedError

    def matvec(self, x, y, V):
        return dense_matvec(self, x, y, V)

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

    def matvec(self, x, y, V):
        return polynomial_matvec(np.asarray(self.coeffs, dtype=np.float64),
                                 x, y, V)


@dataclasses.dataclass
class Exponential(CordialFn):
    lam: float
    scale: float = 1.0

    def __call__(self, z):
        return self.scale * np.exp(self.lam * z)

    def matvec(self, x, y, V):
        return exponential_matvec(self.lam, x, y, V, scale=self.scale)


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

    def matvec(self, x, y, V):
        return exp_poly_matvec(self.lam, np.asarray(self.coeffs), x, y, V)


@dataclasses.dataclass
class Trigonometric(CordialFn):
    omega: float
    phi: float = 0.0
    kind: str = "cos"

    def __call__(self, z):
        fn = np.cos if self.kind == "cos" else np.sin
        return fn(self.omega * z + self.phi)

    def matvec(self, x, y, V):
        return trig_matvec(self.omega, self.phi, x, y, V, kind=self.kind)


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

    def matvec(self, x, y, V):
        return _grid_or_chebyshev(self, x, y, V, self.degree, self.tol)


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

    def matvec(self, x, y, V):
        return _grid_or_chebyshev(self, x, y, V, self.degree, self.tol)


@dataclasses.dataclass
class ExpRational(CordialFn):
    """f(z) = exp(lam z) / (z + c), c > 0 — the paper's Cauchy-LDR example."""

    lam: float
    c: float
    tol: float = 1e-11
    degree: int = 32

    def __call__(self, z):
        return np.exp(self.lam * z) / (z + self.c)

    def matvec(self, x, y, V):
        # M(i,j) = exp(lam x_i) exp(lam y_j) / ((x_i + c/2) + (y_j + c/2)):
        # diagonal-scaled Cauchy (low displacement rank).
        x, y = np.asarray(x), np.asarray(y)
        dx = np.exp(self.lam * x)
        dy = np.exp(self.lam * y)
        out = cauchy_matvec(x + self.c / 2.0, y + self.c / 2.0,
                            dy[:, None] * V, degree=self.degree, tol=self.tol)
        return dx[:, None] * out


@dataclasses.dataclass
class AnyFn(CordialFn):
    """Arbitrary callable f (torch-evaluable for the plan executor);
    Hankel-exact on grids, else Chebyshev."""

    fn: Callable
    tol: float = 1e-9
    degree: int = 48

    def __call__(self, z):
        return self.fn(z)

    def matvec(self, x, y, V):
        return _grid_or_chebyshev(self.fn, x, y, V, self.degree, self.tol)
