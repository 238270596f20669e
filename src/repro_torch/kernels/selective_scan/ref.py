"""Sequential oracle: the selective scan one step at a time."""
from __future__ import annotations

import torch


def selective_scan_ref(u, dt, A, B, C, D, h0=None):
    """u, dt: (Bt, L, din); A: (din, N); B, C: (Bt, L, N); D: (din,); h0:
    None (zeros) or (Bt, din, N). In float32:

        h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = C_t . h_t + D u_t.

    Returns (y (Bt, L, din), h_final (Bt, din, N)), both float32."""
    Bt, L, din = u.shape
    N = A.shape[1]
    u, dt, B, C = (t.float() for t in (u, dt, B, C))
    A, D = A.float(), D.float()
    h = (torch.zeros((Bt, din, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t, :, None] * A[None])  # (Bt, din, N)
        h = dA * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(dim=-1) + u[:, t] * D[None])
    return torch.stack(ys, dim=1), h
