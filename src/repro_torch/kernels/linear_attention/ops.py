"""Causal linear attention with a per-head decay gamma^(i-j), gamma =
exp(log_gamma) <= 1 (log_gamma = 0: the plain Performer; log_gamma < 0:
the separable g = exp, degree-1 topological mask).

  * `causal_linear_attention` is the plain version: the reference's
    `models.attention.causal_linear_attention`, a loop over chunks of L
    with the (m, hd) state S and (m,) state z in float32, in the model's
    (B, L, H, .) layout. Any L (a ragged tail is zero-padded: it adds
    nothing to the causal sums of the real rows). It is the CPU path of
    the wrapper and the model's `attn_impl` "naive" and "chunked".
  * `linear_attention` is the kernel's wrapper, in the reference kernel's
    (B, H, L, .) layout: a CUDA tensor launches the kernel (kernel.py,
    built from linear_attention.cu) or the call raises; a CPU tensor runs
    the plain version. `LAUNCHES` counts kernel launches. The kernel path
    is a `torch.autograd.Function`: its forward is the kernel, its
    backward the VJP of the plain version recomputed from the saved
    inputs (the reference's design: its custom VJPs run the Pallas kernel
    forward and differentiate the XLA twin).

Both return the unnormalized (num, den) in float32; the model normalizes
with `attention.linear_attention_output`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _count
from repro_torch.kernels.linear_attention import kernel
from repro_torch.kernels._vjp import plain_vjp
from repro_torch.roofline import kernels as RK

LAUNCHES = 0


def causal_linear_attention(qf, kf, v, log_gamma=None, chunk: int = 256):
    """qf/kf: (B, L, H, m) nonneg; v: (B, L, H, hd); log_gamma: None, a
    scalar or (H,). Returns (num (B, L, H, hd), den (B, L, H))."""
    B, L, H, m = qf.shape
    hd = v.shape[-1]
    dev = qf.device
    C = min(chunk, L)
    Lp = -(-L // C) * C
    lg = torch.broadcast_to(torch.as_tensor(
        0.0 if log_gamma is None else log_gamma, dtype=torch.float32,
        device=dev), (H,))
    i = torch.arange(C, dtype=torch.float32, device=dev)
    # within-chunk decay factors (H, C, C), causal
    dmat = torch.exp(lg[:, None, None] * (i[:, None] - i[None, :])[None])
    dmat = torch.where((i[:, None] >= i[None, :])[None], dmat, 0.0)
    q_in = torch.exp(lg[:, None] * i[None, :])  # state decay into the chunk
    k_out = torch.exp(lg[:, None] * (C - i[None, :]))  # into the next state
    gC = torch.exp(lg * C)

    def heads_first(t):  # (B, L, H, .) -> (B, H, Lp, .) float32
        return F.pad(t.float(), (0, 0, 0, 0, 0, Lp - L)).permute(0, 2, 1, 3)

    qp, kp, vp = heads_first(qf), heads_first(kf), heads_first(v)
    S = torch.zeros((B, H, m, hd), dtype=torch.float32, device=dev)
    z = torch.zeros((B, H, m), dtype=torch.float32, device=dev)
    nums, dens = [], []
    for c0 in range(0, Lp, C):
        qc, kc, vc = (t[:, :, c0:c0 + C] for t in (qp, kp, vp))
        # intra-chunk masked quadratic
        scores = (qc @ kc.transpose(-1, -2)) * dmat[None]
        num_in = scores @ vc
        den_in = scores.sum(dim=-1)
        # inter-chunk from the carried state
        qd = qc * q_in[None, :, :, None]
        num_x = qd @ S
        den_x = (qd @ z[..., None])[..., 0]
        kd = kc * k_out[None, :, :, None]
        S = S * gC[None, :, None, None] + kd.transpose(-1, -2) @ vc
        z = z * gC[None, :, None] + kd.sum(dim=2)
        nums.append(num_in + num_x)
        dens.append(den_in + den_x)
    num = torch.cat(nums, dim=2)[:, :, :L].permute(0, 2, 1, 3)
    den = torch.cat(dens, dim=2)[:, :, :L].permute(0, 2, 1)
    return num, den


def _check(qf, kf, v, log_gamma, kernel_path: bool) -> None:
    named = {"qf": qf, "kf": kf, "v": v, "log_gamma": log_gamma}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != qf.device:
            raise ValueError(f"{name} is on {t.device}, qf on {qf.device}")
    if qf.ndim != 4 or kf.shape != qf.shape or v.ndim != 4:
        raise ValueError(f"expected qf, kf (B, H, L, m) and v (B, H, L, hd); "
                         f"got {tuple(qf.shape)}, {tuple(kf.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, L, m = qf.shape
    if v.shape[:3] != (B, H, L):
        raise ValueError(f"v {tuple(v.shape)} does not match qf "
                         f"{tuple(qf.shape)}")
    if tuple(log_gamma.shape) != (H,):
        raise ValueError(f"log_gamma must be (H,), got "
                         f"{tuple(log_gamma.shape)}")
    if not kernel_path:
        return
    for name, t in named.items():
        want = ((torch.float32, torch.bfloat16) if name == "v"
                else (torch.float32,))
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(map(str, want))}, "
                            f"got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride")
    if m % 4 or m > kernel.MAX_M:
        raise ValueError(f"the linear attention kernel takes m <= "
                         f"{kernel.MAX_M} with m % 4 == 0, got m={m}")


def _plain(qf, kf, v, log_gamma):
    """The plain version in the kernel's (B, H, L, .) layout."""
    num, den = causal_linear_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                                       v.transpose(1, 2), log_gamma)
    return num.transpose(1, 2), den.transpose(1, 2)


def _forward(qf, kf, v, log_gamma):
    """The kernel on CUDA tensors, the plain version on CPU and fake
    tensors; an open cost count reads B4's work either way."""
    B, H, L, m = qf.shape
    with _count.kernel_call("linear_attention", lambda: RK.linear_work(
            B, H, L, m, v.shape[-1], v.element_size())):
        return _route(qf, kf, v, log_gamma)


def _route(qf, kf, v, log_gamma):
    global LAUNCHES
    if qf.device.type == "cpu" or _count.shapes_only(qf):
        return _count.like_kernel(_plain(qf, kf, v, log_gamma),
                                  kernel.out_buffers(v))
    if qf.device.type != "cuda":
        raise ValueError(f"no linear attention kernel for device {qf.device}")
    got = kernel.linear_attention_cuda(qf, kf, v, log_gamma.contiguous())
    LAUNCHES += 1
    return got


class _LinearAttention(torch.autograd.Function):
    """Kernel forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, qf, kf, v, log_gamma):
        ctx.save_for_backward(qf, kf, v, log_gamma)
        return _forward(qf, kf, v, log_gamma)

    @staticmethod
    def backward(ctx, g_num, g_den):
        return plain_vjp(_plain, ctx.saved_tensors, ctx.needs_input_grad,
                         (g_num, g_den))


def linear_attention(qf, kf, v, log_gamma, use_kernel: bool | None = None):
    """Causal gamma-decayed linear attention (the counterpart of
    `linear_attention_pallas`). qf/kf: (B, H, L, m); v: (B, H, L, hd);
    log_gamma: (H,) <= 0. Returns (num (B, H, L, hd), den (B, H, L)) in
    float32.

    use_kernel=None or True: the kernel path (the kernel on CUDA tensors,
    the plain version on CPU tensors; differentiable through the plain
    version's VJP); False: the plain version."""
    kernel_path = use_kernel is not False
    _check(qf, kf, v, log_gamma, kernel_path)
    if not kernel_path:
        return _plain(qf, kf, v, log_gamma)
    return _LinearAttention.apply(qf, kf, v, log_gamma)
