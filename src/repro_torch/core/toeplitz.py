"""FFT fastmult for sequence (path-metric) f-distance masks.

On the token metric dist(i, j) = |i - j| (the path graph is its own MST),
M = [f(|i-j|)] is symmetric Toeplitz and M_causal = [f(i-j)]_{i>=j} is
lower-triangular Toeplitz. Both multiply in O(L log L) exactly for any f by
circulant embedding (paper App. A.2.3).

Every function acts on the -2 axis of V (..., L, d) with mask values F
(..., L) broadcastable against V's batch dims, and is differentiable in F.

The FFTs run in float64: F and V go up once and the product comes back in
V's dtype. A float32 FFT errs by ~1e-7 of the largest output row, and
Alg. 1 divides by the row q_i . (M phi(K))_i, which at a token whose
features are small is far below the largest. At the pinned example of the
reference's `test_impl_parity_sweep` (seed 1, L = 33, causal, degree 2,
synced) token 0's denominator is 2.59e-6 against 6.37 for the largest: a
float32 FFT reads it 5.6e-2 off and the attention 2.4e-2 off the dense
oracle, where float64 reads 1.6e-8 and 1.9e-7
(tests/test_torch_masks.py holds both).
"""
from __future__ import annotations

import numpy as np
import torch

_FFT_DTYPE = torch.float64


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def causal_toeplitz_matvec(F, V):
    """out[..., i, :] = sum_{j<=i} F[..., i-j] V[..., j, :].

    Lower-triangular Toeplitz multiply == causal convolution (FFT, exact)."""
    L = V.shape[-2]
    n = _next_pow2(2 * L)
    Ff = torch.fft.rfft(F.to(_FFT_DTYPE), n=n, dim=-1)  # (..., n//2+1)
    Vf = torch.fft.rfft(V.to(_FFT_DTYPE), n=n, dim=-2)  # (..., n//2+1, d)
    out = torch.fft.irfft(Ff[..., None] * Vf, n=n, dim=-2)
    return out[..., :L, :].to(V.dtype)


def symmetric_toeplitz_matvec(F, V):
    """out[..., i, :] = sum_j F[..., |i-j|] V[..., j, :] (bidirectional)."""
    L = V.shape[-2]
    n = _next_pow2(2 * L)
    F = F.to(_FFT_DTYPE)
    # circulant first column: c[k] = F[k] (k < L), c[n-k] = F[k] (1 <= k < L)
    zeros_mid = F.new_zeros(F.shape[:-1] + (n - 2 * L + 1,))
    c = torch.cat([F, zeros_mid, F[..., 1:].flip(-1)], dim=-1)  # (..., n)
    Cf = torch.fft.rfft(c, dim=-1)
    Vf = torch.fft.rfft(V.to(_FFT_DTYPE), n=n, dim=-2)
    out = torch.fft.irfft(Cf[..., None] * Vf, n=n, dim=-2)
    return out[..., :L, :].to(V.dtype)


def toeplitz_dense(F, L: int, causal: bool):
    """Dense mask materialization: the oracle for tests and tiny L."""
    idx = torch.arange(L, device=F.device)
    dist = idx[:, None] - idx[None, :]
    if causal:
        vals = F[..., dist.clamp(0, F.shape[-1] - 1)]
        return torch.where(dist >= 0, vals, 0.0)
    return F[..., dist.abs()]
