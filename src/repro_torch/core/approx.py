"""Approximate fast integrators (paper App. A.2): RFF and NU-FFT.

These trade exactness for generality: any f with a usable Fourier transform
gets an O((a+b)·m)-style multiply. Host numpy, the reference's arithmetic
step for step.
"""
from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------------
# A.2.1: Random Fourier Features
# ----------------------------------------------------------------------------


def rff_matvec(x, y, V, omegas, tau_over_p):
    """M ~= U W^T with mu(t)_l = sqrt(tau(w_l)/p(w_l)/m) exp(2 pi i w_l t).

    Unbiased: E[mu(x)^T mu(y)] = f(x+y). Returns Re(U (W^T V)), O((a+b) m d).
    """
    m = omegas.shape[0]
    su = np.sqrt(np.abs(tau_over_p) / m)
    U = su[None, :] * np.exp(2j * np.pi * np.outer(x, omegas))  # (a, m)
    W = (np.sign(tau_over_p) * su)[None, :] * np.exp(2j * np.pi * np.outer(y, omegas))
    return np.real(U @ (W.T @ V))


def gaussian_rff_matvec(x, y, V, sigma: float, m: int, seed: int = 0):
    """f(z) = exp(-z^2 / (2 sigma^2)). FT tau is Gaussian; sample p = tau/|tau|_1
    => tau/p = |tau|_1 = 1 (f normalized so f(0)=1 has unit-mass FT ratio)."""
    rng = np.random.default_rng(seed)
    omegas = rng.normal(0.0, 1.0 / (2.0 * np.pi * sigma), size=m)
    return rff_matvec(x, y, V, omegas, np.ones(m))


# ----------------------------------------------------------------------------
# Gaussian-gridding NUFFT (Greengard & Lee 2004), type 1 and 2
# points in [0, 2*pi); modes k = -M/2 .. M/2-1
# ----------------------------------------------------------------------------


def nufft1(points, values, n_modes: int, eps: float = 1e-10):
    """F[k] = sum_j values[j] exp(-i k points[j]), O(N·w + Mr log Mr)."""
    M = n_modes
    Mr = 2 * M
    msp = max(4, int(np.ceil(-np.log(eps) / 2.0)))  # spreading half width
    tau = (np.pi / M**2) * msp / (2.0 * (2.0 - 0.5))
    grid = np.zeros(Mr, dtype=np.complex128)
    xs = np.mod(points, 2 * np.pi)
    h = 2 * np.pi / Mr
    base = np.floor(xs / h).astype(np.int64)
    for dk in range(-msp, msp + 1):
        idx = np.mod(base + dk, Mr)
        z = xs - (base + dk) * h
        np.add.at(grid, idx, values * np.exp(-z * z / (4.0 * tau)))
    Fg = np.fft.fft(grid)  # Fg[k] = sum_m grid[m] e^{-2pi i k m / Mr}
    ks = np.arange(-(M // 2), (M + 1) // 2)
    Fk = Fg[np.mod(ks, Mr)]
    # deconvolve: sum_m g_tau(x - m h) e^{-i k m h} ~ (1/h) sqrt(4 pi tau) e^{-k^2 tau} e^{-i k x}
    corr = h / np.sqrt(4.0 * np.pi * tau) * np.exp(ks.astype(np.float64) ** 2 * tau)
    return Fk * corr, ks


def nufft2(points, Fk, ks, eps: float = 1e-10):
    """g(x_i) = sum_k Fk[k] exp(i k x_i) — type-2 via gridding (adjoint)."""
    M = ks.shape[0]
    Mr = 2 * M
    msp = max(4, int(np.ceil(-np.log(eps) / 2.0)))
    tau = (np.pi / M**2) * msp / (2.0 * (2.0 - 0.5))
    h = 2 * np.pi / Mr
    # pre-deconvolve so that post-spreading reproduces sum_k Fk e^{ikx}
    corr = np.exp(ks.astype(np.float64) ** 2 * tau) * h / np.sqrt(4.0 * np.pi * tau)
    padded = np.zeros(Mr, dtype=np.complex128)
    padded[np.mod(ks, Mr)] = Fk * corr
    grid = np.fft.ifft(padded) * Mr  # grid[m] = sum_k padded_k e^{+i k m h}
    xs = np.mod(points, 2 * np.pi)
    base = np.floor(xs / h).astype(np.int64)
    out = np.zeros(points.shape[0], dtype=np.complex128)
    for dk in range(-msp, msp + 1):
        idx = np.mod(base + dk, Mr)
        z = xs - (base + dk) * h
        out += grid[idx] * np.exp(-z * z / (4.0 * tau))
    return out


def nufft_integrate(f, x, y, V, n_quad: int = 512):
    """A.2.2: out_i = sum_j f(x_i + y_j) V_j via Fourier quadrature + NUFFTs.

    f is sampled on [0, 2*span]; its FT rho(w) is computed by FFT quadrature;
    R(w) = sum_j V_j e^{2 pi i w (-y_j)} via type-1 NUFFT; g(x) via type-2.
    Accuracy is governed by n_quad (band-limit of f).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    span = float((np.max(x) if x.size else 0.0) + (np.max(y) if y.size else 0.0))
    span = max(span, 1e-9)
    # Period 2x the span with an even (mirror) extension: the periodized
    # function is continuous at the wrap point, so the truncated Fourier
    # series converges fast (no Gibbs ringing from f(0) != f(P^-)).
    P = 2.0 * span * 1.10
    nz = 4 * n_quad
    zs = np.arange(nz) * (P / nz)
    zfold = np.minimum(zs, P - zs)
    cz = np.fft.fft(f(zfold)) / nz  # f(z) = sum_k cz[k] e^{+2 pi i k z / P}
    ks = np.arange(-(n_quad // 2), (n_quad + 1) // 2)
    rho = cz[np.mod(ks, nz)]  # truncated band
    out = np.zeros((x.shape[0],) + V.shape[1:], dtype=np.float64)
    theta_y = 2 * np.pi * y / P
    theta_x = 2 * np.pi * x / P
    for c in range(V.shape[1]):
        # R_k = sum_j V_j e^{+i k theta_y}: nufft1 computes sum v e^{-i k p} -> p = -theta_y
        Rk, _ = nufft1(-theta_y, V[:, c].astype(np.complex128), n_quad)
        # g(x_i) = sum_k rho_k R_k e^{+i k theta_x}
        gx = nufft2(theta_x, rho * Rk, ks)
        out[:, c] = np.real(gx)
    return out
