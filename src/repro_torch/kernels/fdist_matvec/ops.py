"""Public wrappers of the fused f-distance matvec.

A CUDA tensor goes to the hand-written kernel (`kernel.py`, built from
`fdist_matvec.cu`); a CPU tensor goes to the plain PyTorch version
(`ref.py`). The choice follows the device of the tensors alone: on a card
the kernel launches or the call raises. `LAUNCHES` counts kernel launches,
so a caller can show that its path went through the kernel, and
`LAUNCHES_BY_TD` counts them by the kernel's d-tile width (4, 16 or 64).

The batched wrapper is a `torch.autograd.Function`. Its forward is the
kernel (the plain version on CPU tensors); its backward is, for v, the
exact transpose product M^T u, which is the same kernel with x and y
swapped since f depends on x_i + y_j alone (one more launch), and, for x,
y and coeffs, the VJP of the plain version recomputed from the saved
inputs, as the reference's custom VJPs differentiate their XLA twins.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _count
from repro_torch.kernels.fdist_matvec import kernel
from repro_torch.kernels._vjp import plain_vjp
from repro_torch.roofline import kernels as RK
from repro_torch.kernels.fdist_matvec.ref import fdist_matvec_batched_ref

MODES = ("poly", "exp", "expq", "rational")
_NUM_COEFFS = {"exp": 2, "expq": 3, "rational": 1}  # poly: any k >= 1
MAX_COEFFS = 4096  # the coefficients are staged in 48 KB of shared memory

LAUNCHES = 0
LAUNCHES_BY_TD = {td: 0 for td in kernel.TD_CHOICES}


def _check(x, y, v, coeffs, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for name, t in (("x", x), ("y", y), ("v", v), ("coeffs", coeffs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("y", y), ("coeffs", coeffs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    if x.ndim != 2 or y.ndim != 2 or v.ndim != 3 or coeffs.ndim != 1:
        raise ValueError(
            f"expected x (B, a), y (B, b), v (B, b, d), coeffs (k,); got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(v.shape)}, "
            f"{tuple(coeffs.shape)}")
    if not (x.shape[0] == y.shape[0] == v.shape[0]
            and y.shape[1] == v.shape[1]):
        raise ValueError(
            f"inconsistent shapes x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"v {tuple(v.shape)}")
    k = coeffs.shape[0]
    want = _NUM_COEFFS.get(mode)
    if (want is not None and k != want) or not 1 <= k <= MAX_COEFFS:
        raise ValueError(f"mode {mode!r} takes {want or '1..4096'} "
                         f"coefficients, got {k}")


def _forward(x, y, v, coeffs, mode: str):
    """The kernel on CUDA tensors, the plain version on CPU and fake
    tensors; an open cost count reads B1's work either way."""
    B, a = x.shape
    b, d = v.shape[1:]
    nb = v.element_size()
    with _count.kernel_call("fdist_matvec_batched", lambda: RK.fdist_work(
            B, a, b, d, mode, coeffs.shape[0], nb, nb)):
        return _route(x, y, v, coeffs, mode)


def _route(x, y, v, coeffs, mode: str):
    global LAUNCHES
    if x.device.type == "cpu" or _count.shapes_only(x):
        return fdist_matvec_batched_ref(x, y, v, coeffs, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no fdist_matvec kernel for device {x.device}")
    B, a = x.shape
    b, d = v.shape[1:]
    if min(B, a, b, d) == 0:  # nothing to launch: an empty sum is zero
        return torch.zeros((B, a, d), dtype=v.dtype, device=x.device)
    out = kernel.fdist_matvec_batched_cuda(x, y, v, coeffs, mode)
    LAUNCHES += 1
    LAUNCHES_BY_TD[kernel.tile_width(d)] += 1
    return out


class _FdistMatvec(torch.autograd.Function):
    """Kernel forward; backward M^T u on the kernel (v) and the plain
    version's VJP (x, y, coeffs)."""

    @staticmethod
    def forward(ctx, x, y, v, coeffs, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, y, v, coeffs)
        return _forward(x, y, v, coeffs, mode)

    @staticmethod
    def backward(ctx, u):
        x, y, v, coeffs = ctx.saved_tensors
        need_x, need_y, need_v, need_c = ctx.needs_input_grad[:4]
        u = u.contiguous()
        gv = (_forward(y, x, u, coeffs, ctx.mode) if need_v else None)
        gx, gy, gc = plain_vjp(
            lambda x, y, c: fdist_matvec_batched_ref(x, y, v.detach(), c,
                                                     ctx.mode),
            (x, y, coeffs), (need_x, need_y, need_c), u)
        return gx, gy, gv, gc, None


def fdist_matvec_batched(x, y, v, coeffs, mode: str = "poly"):
    """Bucketed form used by the plan executor: (B, a) x (B, b) x (B, b, d)
    -> (B, a, d) in v's dtype, out[n, i] = sum_j f(x[n, i] + y[n, j]) v[n, j].
    Differentiable in every input (the module docstring says how)."""
    _check(x, y, v, coeffs, mode)
    return _FdistMatvec.apply(x, y, v, coeffs, mode)


def fdist_matvec(x, y, v, coeffs, mode: str = "poly"):
    """Single job: x (a,), y (b,), v (b, d) -> (a, d); the B = 1 launch of
    the batched kernel."""
    if x.ndim != 1 or y.ndim != 1 or v.ndim != 2:
        raise ValueError(
            f"expected x (a,), y (b,), v (b, d); got {tuple(x.shape)}, "
            f"{tuple(y.shape)}, {tuple(v.shape)}")
    return fdist_matvec_batched(x[None], y[None], v[None], coeffs, mode)[0]


def fdist_matvec_batched_sharded(x, y, v, coeffs, *, mesh, axis=None,
                                 mode: str = "poly"):
    """`fdist_matvec_batched` over the ranks of `mesh`: the bucket (job) dim
    is split over the mesh's plan axis (`data` by default), each rank
    launching the kernel on its B/D slab — buckets are independent, so the
    slabs need no collective — and one all_gather assembles the (B, a, d)
    result on every rank. A ragged bucket count is zero-padded to a
    multiple of the axis size (the pad slabs' rows are sliced off). Each
    job's output is the single-device call's. Every rank passes the same
    inputs and gets the whole gradient of each: a rank differentiates
    only its slab, so the inputs' grads are summed over the axis."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding

    axis = axis or sharding.plan_axis(mesh)
    D = sharding.axis_size(mesh, axis)
    if D == 1:
        return fdist_matvec_batched(x, y, v, coeffs, mode=mode)
    group = sharding.axis_group(mesh, axis)
    x, y, v, coeffs = C.replicated((x, y, v, coeffs), group)
    B = x.shape[0]
    pad = (-B) % D
    if pad:
        x, y, v = (torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
                   for t in (x, y, v))
    k, S = sharding.axis_rank(mesh, axis), x.shape[0] // D
    mine = fdist_matvec_batched(*(t[k * S:(k + 1) * S].contiguous()
                                  for t in (x, y, v)), coeffs, mode=mode)
    return C.all_gather(mine, group)[:B]
