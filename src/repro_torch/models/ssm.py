"""Mamba-1 selective SSM block (falcon-mamba-7b) of the port.

The reference's `models/ssm.py` with its dtypes: A_log, D and dt_bias
live in the model dtype and A = -exp(A_log) in float32; the causal conv
and the projections run in the model dtype; the selective scan runs in
float32 and y goes back to the model dtype before the gate silu(z).
`cfg.attn_impl` picks who runs the scan: "naive" the sequential oracle,
"chunked" the plain chunked scan, "cuda" the kernel's wrapper (the kernel
on CUDA tensors, the plain scan on CPU tensors). The scan functions upcast
u, dt, B and C themselves (exactly), so the model hands them its tensors
as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch import sharding
from repro_torch.launch.sharding import shard
from repro_torch.models.layers import Params, causal_conv_step, dense_init

SCAN_IMPLS = ("naive", "chunked", "cuda")  # cfg.attn_impl


def _dt_rank(cfg) -> int:
    return cfg.dt_rank or max(1, cfg.d_model // 16)


def ssm_shapes(cfg) -> dict:
    d, din, N, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, _dt_rank(cfg)
    return {"in_proj": (d, 2 * din), "conv_w": (din, cfg.ssm_conv),
            "conv_b": (din,), "x_proj": (din, r + 2 * N),
            "dt_proj": (r, din), "dt_bias": (din,), "A_log": (din, N),
            "D": (din,), "out_proj": (din, d)}


class SSM(Params):
    """The parameters of one Mamba block's mixer, named as the reference's
    `blocks0/ssm/*` leaves."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(ssm_shapes(cfg), dtype, device)


def ssm_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The reference's init recipe, drawn from `gen` on its device."""
    d, din, N, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, _dt_rank(cfg)
    dev = gen.device
    in_proj = dense_init(gen, (d, 2 * din), dtype=dtype)
    conv_w = (torch.randn((din, cfg.ssm_conv), generator=gen, device=dev)
              * 0.1).to(dtype)
    x_proj = dense_init(gen, (din, r + 2 * N), dtype=dtype)
    dt_proj = dense_init(gen, (r, din), dtype=dtype)
    dt0 = torch.empty(din, device=dev).uniform_(1e-3, 0.1, generator=gen)
    dt_bias = torch.log(torch.expm1(dt0.clamp_min(1e-4))).to(dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj, "conv_w": conv_w,
        "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
        "x_proj": x_proj, "dt_proj": dt_proj, "dt_bias": dt_bias,
        "A_log": torch.log(A).repeat(din, 1).to(dtype),
        "D": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (din, d), dtype=dtype),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _causal_conv1d(x, w, b):
    """x: (B, L, C); w: (C, K) depthwise causal conv; w[:, K-1] multiplies
    the current token (matches the decode ring buffer). Summed over k in
    order, as the reference does."""
    if sharding.is_dtensor(x):  # channel by channel: each rank its slab
        return sharding.slab_face(_causal_conv1d, (x, w, b),
                                  ((0, 2), (None, 0), (None, 0)), (0, 2))
    K, L = w.shape[1], x.shape[1]
    xpad = F.pad(x, (0, 0, K - 1, 0))
    out = xpad[:, 0:L] * w[:, 0]
    for k in range(1, K):
        out = out + xpad[:, k:k + L] * w[:, k]
    return out + b


def _scan(cfg, u, dt, A, Bm, Cm, D):
    """(y, h_final) in float32, executed as `cfg.attn_impl` says."""
    impl = cfg.attn_impl
    if impl == "naive":
        return selective_scan_ref(u, dt, A, Bm, Cm, D)
    if impl == "chunked":
        return scan_ops.selective_scan(u, dt, A, Bm, Cm, D)
    if impl == "cuda":  # under a mesh each rank scans its channel slab
        return sharding.slab_face(
            scan_ops.scan, (u, dt, A, Bm, Cm, D),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0)),
            ((0, 2), (0, 1)))
    raise ValueError(f"cfg.attn_impl={impl!r}: expected one of {SCAN_IMPLS} "
                     "for the selective scan")


def _mix(cfg, p, xin, z, lengths=None):
    """conv -> silu -> x_proj -> dt -> scan -> gate -> out_proj over a whole
    sequence. Positions at or past lengths[b] get dt = 0 (the state passes
    through them). Returns (out (B, L, d), h_final)."""
    L = xin.shape[1]
    N = cfg.ssm_state
    xc = F.silu(_causal_conv1d(xin, p.conv_w, p.conv_b))
    r = p.dt_proj.shape[0]
    proj = xc @ p.x_proj  # (B, L, r + 2N)
    dt_low, Bm, Cm = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = _softplus(dt_low @ p.dt_proj + p.dt_bias)
    if lengths is not None:
        vmask = torch.arange(L, device=xin.device)[None, :] < lengths[:, None]
        dt = dt * vmask[..., None].to(dt.dtype)
    A = -torch.exp(p.A_log.float())
    y, h = _scan(cfg, xc, dt, A, Bm, Cm, p.D.float())
    y = y.to(xin.dtype) * F.silu(z)
    return y @ p.out_proj, h


def mamba_block_train(cfg, p, x):
    """x: (B, L, d) -> (B, L, d)."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xin = shard(xin, ("batch", "seq", "inner"))
    return _mix(cfg, p, xin, z)[0]


def mamba_block_prefill(cfg, p, x, lengths, cache):
    """Fused prefill: one selective scan over the (right-padded) prompt that
    also produces the decode state. Padded positions get dt = 0, so h_final
    is the state after the last real token of each row. The conv ring holds
    the last K-1 raw conv inputs (zeros where the prompt is shorter, as
    `mamba_decode_init`). Rows with lengths[b] == 0 keep their cache.
    Returns (y (B, L, d), new_cache)."""
    B, L, _ = x.shape
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xin = shard(xin, ("batch", "seq", "inner"))
    y, h = _mix(cfg, p, xin, z, lengths)
    K = cfg.ssm_conv
    cidx = (lengths[:, None] - (K - 1)
            + torch.arange(K - 1, device=x.device)[None, :])  # (B, K-1)
    rows = torch.arange(B, device=x.device)[:, None]
    conv = torch.where((cidx >= 0)[..., None],
                       xin[rows, cidx.clamp(0, max(L - 1, 0))],
                       0.0).to(cache["conv"].dtype)
    valid = (lengths > 0)[:, None, None]
    return y, {"conv": torch.where(valid, conv, cache["conv"]),
               "h": torch.where(valid, h, cache["h"])}


def mamba_decode_init(cfg, B: int, dtype=torch.float32, device=None):
    din, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((B, K - 1, din), dtype=dtype, device=device),
            "h": torch.zeros((B, din, N), dtype=torch.float32, device=device)}


def _state_slab(seq, c, dA, dBu, Cm, xc, D, gate):
    """The selective state step h <- dA h + dBu, y = (h C + D xc) gate on
    one rank's (batch, channels) slab."""
    h = dA.float() * c["h"] + dBu.float()
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    return ((y + xc.float() * D).to(gate.dtype) * gate,), {"h": h}


def mamba_block_decode(cfg, p, x, cache):
    """x: (B, 1, d); the O(1) state update, in the reference's dtypes (dt
    and (dt u) B in the model dtype, the state in float32). A DTensor
    cache steps on each rank's (batch, channels) slab
    (`sharding.cache_face`)."""
    N = cfg.ssm_state
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)  # (B, 1, din)
    xc, conv = causal_conv_step(cache["conv"], xin, p.conv_w, p.conv_b)
    xc = F.silu(xc)[:, None, :]  # (B, 1, din)
    r = p.dt_proj.shape[0]
    # (B, 1, r + 2N) whole on every channel rank (one token-sized
    # reduction), so that dBu below is formed on each rank's channels
    # instead of summed as a (B, din, N) partial
    proj = shard(xc @ p.x_proj, ("batch", None, None))
    dt_low, Bm, Cm = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = _softplus(dt_low @ p.dt_proj + p.dt_bias)  # (B, 1, din)
    A = -torch.exp(p.A_log.float())
    dA = torch.exp(dt[..., None] * A)[:, 0]  # (B, din, N)
    dBu = ((dt * xc)[..., None] * Bm[:, :, None, :])[:, 0]
    ch = {"batch": 0, "heads": 1}
    (y,), new = sharding.cache_face(
        _state_slab, {"h": cache["h"]}, {"h": ch},
        (dA, dBu, Cm[:, 0], xc[:, 0], p.D, F.silu(z[:, 0])),
        (ch, ch, {"batch": 0}, ch, {"heads": 0}, ch), (ch,))
    return y[:, None, :] @ p.out_proj, {"conv": conv, "h": new["h"]}
