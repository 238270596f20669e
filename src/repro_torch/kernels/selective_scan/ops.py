"""The Mamba-1 selective scan

    h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = C_t . h_t + D u_t

in float32, from h_0 = h0 (zeros when absent), returning (y, h_final).

  * `selective_scan` is the plain version: the reference's
    `models.ssm.selective_scan`, a loop across chunks of L carrying the
    (Bt, din, N) state, with an associative scan (log2 C doubling steps)
    inside each chunk. Unlike the reference it builds exp(dt A) and
    (dt u) B one chunk at a time, not over the whole of L (at the served
    shape that would be 2 x 8.6 GB a layer), and it takes any L: a ragged
    tail is padded with dt = 0, which passes the state through unchanged.
    It is the CPU path of the wrapper and the model's `attn_impl`
    "chunked".
  * `scan` is the kernel's wrapper (the counterpart of
    `selective_scan_pallas`, plus the final state and h0): a CUDA tensor
    launches the kernel (kernel.py, built from selective_scan.cu) or the
    call raises; a CPU tensor runs the plain version. `LAUNCHES` counts
    kernel launches. The kernel path is a `torch.autograd.Function`: its
    forward is the kernel, its backward the VJP of the plain chunked scan
    recomputed from the saved inputs (the reference's design: its custom
    VJPs run the Pallas kernel forward and differentiate the XLA twin), so
    the forward's values are the kernel's alone.

u, dt, B and C may be float32 or bfloat16 (the upcast to float32 is
exact); A, D and h0 are float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _count
from repro_torch.kernels.selective_scan import kernel
from repro_torch.kernels._vjp import plain_vjp
from repro_torch.roofline import kernels as RK

LAUNCHES = 0


def _assoc_scan(a, b):
    """Inclusive scan over axis 1 of the pairs (a, b) under
    (a1, b1) o (a2, b2) = (a2 a1, a2 b1 + b2), by doubling."""
    C, s = a.shape[1], 1
    while s < C:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1))
        s *= 2
    return a, b


def selective_scan(u, dt, A, Bm, Cm, D, chunk: int = 256, h0=None):
    """u, dt: (Bt, L, din); A: (din, N); Bm, Cm: (Bt, L, N); D: (din,);
    h0: None or (Bt, din, N). Returns (y (Bt, L, din), h_final (Bt, din,
    N)), both float32."""
    Bt, L, din = u.shape
    N = A.shape[1]
    C = min(chunk, L)
    pad = (0, 0, 0, -(-L // C) * C - L)
    u, dt, Bm, Cm = (F.pad(t.float(), pad) for t in (u, dt, Bm, Cm))
    A, D = A.float(), D.float()
    h = (torch.zeros((Bt, din, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, u.shape[1], C):
        dtc = dt[:, c0:c0 + C]
        da = torch.exp(dtc[..., None] * A)  # (Bt, C, din, N)
        dbu = (dtc * u[:, c0:c0 + C])[..., None] * Bm[:, c0:c0 + C, None, :]
        acc_a, acc_b = _assoc_scan(da, dbu)
        hs = acc_a * h[:, None] + acc_b
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, c0:c0 + C]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :L] + u[:, :L] * D, h


def _check(u, dt, A, Bm, Cm, D, h0, kernel_path: bool) -> None:
    named = {"u": u, "dt": dt, "A": A, "B": Bm, "C": Cm, "D": D}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if u.ndim != 3 or dt.shape != u.shape or A.ndim != 2:
        raise ValueError(f"expected u, dt (Bt, L, din) and A (din, N); got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    Bt, L, din = u.shape
    N = A.shape[1]
    want = {"A": (din, N), "B": (Bt, L, N), "C": (Bt, L, N), "D": (din,),
            "h0": (Bt, din, N)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for u "
                             f"{tuple(u.shape)} and A {tuple(A.shape)}, got "
                             f"{tuple(named[name].shape)}")
    if not kernel_path:
        return
    if N not in kernel.N_CHOICES:
        raise ValueError(f"the selective scan kernel takes a state size N in "
                         f"{kernel.N_CHOICES}, got N={N}")
    streamed = (u, dt, Bm, Cm)
    if u.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != u.dtype for t in streamed):
        raise TypeError(f"u, dt, B and C must share one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in streamed]}")
    for name in ("A", "D", "h0"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got "
                            f"{named[name].dtype}")
    for name, t in named.items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride")


def _forward(u, dt, A, Bm, Cm, D, h0):
    """The kernel on CUDA tensors, the plain version on CPU and fake
    tensors; an open cost count reads B6's work either way."""
    Bt, L, din = u.shape
    with _count.kernel_call("selective_scan", lambda: RK.scan_work(
            Bt, L, din, Bm.shape[-1], u.element_size())):
        return _route(u, dt, A, Bm, Cm, D, h0)


def _route(u, dt, A, Bm, Cm, D, h0):
    global LAUNCHES
    if u.device.type == "cpu" or _count.shapes_only(u):
        return _count.like_kernel(selective_scan(u, dt, A, Bm, Cm, D, h0=h0),
                                  kernel.out_buffers(u, A.shape[1]))
    if u.device.type != "cuda":
        raise ValueError(f"no selective scan kernel for device {u.device}")
    got = kernel.selective_scan_cuda(u, dt, A.contiguous(), Bm, Cm,
                                     D.contiguous(),
                                     None if h0 is None else h0.contiguous())
    LAUNCHES += 1
    return got


class _Scan(torch.autograd.Function):
    """Kernel forward, the plain chunked scan's VJP backward."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, h0):
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, h0)
        return _forward(u, dt, A, Bm, Cm, D, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        return plain_vjp(
            lambda u, dt, A, Bm, Cm, D, h0: selective_scan(u, dt, A, Bm, Cm,
                                                           D, h0=h0),
            ctx.saved_tensors, ctx.needs_input_grad, (g_y, g_h))


def scan(u, dt, A, Bm, Cm, D, h0=None, use_kernel: bool | None = None):
    """The selective scan on the kernel path (the counterpart of
    `selective_scan_pallas`, which returns y only and starts from zeros).
    Shapes as `selective_scan`. Returns (y (Bt, L, din), h_final (Bt, din,
    N)) in float32.

    use_kernel=None or True: the kernel path (the kernel on CUDA tensors,
    the plain version on CPU tensors; differentiable through the plain
    version's VJP); False: the plain version."""
    kernel_path = use_kernel is not False
    _check(u, dt, A, Bm, Cm, D, h0, kernel_path)
    if not kernel_path:
        return selective_scan(u, dt, A, Bm, Cm, D, h0=h0)
    return _Scan.apply(u, dt, A, Bm, Cm, D, h0)
