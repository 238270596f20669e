"""Public fused topological masked linear attention (paper Alg. 1).

`topo_linear_attention` computes out = (M ⊙ phi(Q)phi(K)^T) V /
rowsum(M ⊙ phi(Q)phi(K)^T) for the sequence mask M = [f(i-j)] (causal) or
[f(|i-j|)] (bidirectional) in one pass over chunks of L:

  * on a card the CUDA sweep kernel (kernel.py, built from topo_sweep.cu)
    runs: one launch causal, two bidirectional (forward inclusive, then the
    reversed strict sweep combining and normalizing in-kernel);
  * `_plain_forward` is the plain chunked sweep with identical math (the
    reference's XLA twin): the CPU path, and `topo_attn_impl="torch"`.

Mask families: separable (g=exp, deg<=1) rides the gamma^(i-j) decay state;
any other g/degree the rank-R Chebyshev state (core.masks tables), with the
exact within-chunk tile either way. Coefficients are per-head (H, t+1); a
synced (t+1,) vector broadcasts.

`topo_attention_sweep` is the kernel's wrapper: a CUDA tensor launches the
kernel or the call raises; a CPU tensor runs the plain sweep. `LAUNCHES`
counts kernel launches. The raw sweep has no backward and refuses inputs
that require grad. The fused entry `topo_linear_attention` on the kernel
path is a `torch.autograd.Function` over (qf, kf, v, coeffs), the
reference's `_fused` custom VJP: its forward is `_kernel_forward`, its
backward the VJP of `_plain_forward` (the XLA twin's counterpart)
recomputed from the saved inputs, so the mask scalars get their grads
through `_prepare`'s tables.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import masks as MK
from repro_torch.kernels import _count
from repro_torch.kernels.topo_linear_attention import kernel
from repro_torch.kernels._vjp import plain_vjp
from repro_torch.roofline import kernels as RK

LAUNCHES = 0


class TopoSpec(NamedTuple):
    g: str
    dist_scale: float
    causal: bool
    chunk: int
    rank: int
    eps: float


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _is_separable(g: str, coeffs) -> bool:
    return g == "exp" and coeffs.shape[-1] <= 2


def _prepare(spec: TopoSpec, coeffs, Lp: int):
    """Per-head mask ingredients for both sweep directions: (lg, alpha,
    beta, dmat_inc, dmat_strict) with `lg` (H,) in decay mode (alpha/beta
    None) or rank-R tables (H, Lp, R) (lg None), and the exact (H, C, C)
    within-chunk tiles (inclusive diagonal / strict). In decay mode the
    e^{a0} factor is folded into kf by `_pad_inputs`."""
    C = spec.chunk
    if _is_separable(spec.g, coeffs):
        H = coeffs.shape[0]
        lg = (coeffs[:, 1] * spec.dist_scale if coeffs.shape[-1] > 1
              else torch.zeros((H,), dtype=torch.float32,
                               device=coeffs.device))
        # within-chunk tile from gamma^(i-j) alone: a0 cancels in the
        # normalization and the cross-chunk state carries no a0 either
        d = np.arange(C)[:, None] - np.arange(C)[None, :]
        dt = torch.as_tensor(d, dtype=torch.float32, device=coeffs.device)
        vals = torch.exp(lg[:, None, None] * dt)
        dmat_inc = torch.where(torch.as_tensor(d >= 0, device=coeffs.device),
                               vals, 0.0)
        dmat_strict = torch.where(torch.as_tensor(d > 0, device=coeffs.device),
                                  vals, 0.0)
        return lg, None, None, dmat_inc, dmat_strict
    alpha, beta = MK.chebyshev_separable_tables(
        spec.g, coeffs, Lp, spec.dist_scale, spec.rank)
    dmat_inc = MK.sequence_mask_matrix(spec.g, coeffs, C, spec.dist_scale)
    dmat_strict = MK.sequence_mask_matrix(spec.g, coeffs, C, spec.dist_scale,
                                          strict=True)
    return None, alpha, beta, dmat_inc, dmat_strict


def _pad_inputs(spec: TopoSpec, qf, kf, v, coeffs):
    L = qf.shape[2]
    Lp = _round_up(L, spec.chunk)
    pad = (0, 0, 0, Lp - L)
    kf = kf.float()
    if _is_separable(spec.g, coeffs):
        # decay mode carries gamma^(i-j) only; fold the mask's e^{a0} factor
        # into kf so num/den match the other impls even where the eps
        # denominator clamp binds
        kf = kf * torch.exp(coeffs[:, 0])[None, :, None, None]
    return (F.pad(qf.float(), pad).contiguous(), F.pad(kf, pad).contiguous(),
            F.pad(v.float(), pad).contiguous(), Lp)


def _flip(t):
    return torch.flip(t, dims=(2,)) if t is not None else None


# ----------------------------------------------------------------------------
# the plain chunked sweep (the reference's XLA twin)
# ----------------------------------------------------------------------------


def _sweep(qp, kp, vp, dmat, lg=None, alpha=None, beta=None):
    """One causal sweep over chunks; returns (num, den) pre-normalization."""
    B, H, Lp, m = qp.shape
    hd = vp.shape[-1]
    C = dmat.shape[-1]
    dev = qp.device
    nums, dens = [], []
    if lg is not None:
        i = torch.arange(C, dtype=torch.float32, device=dev)
        decq = torch.exp(lg[:, None] * i[None, :])           # (H, C)
        deck = torch.exp(lg[:, None] * (C - i[None, :]))
        gC = torch.exp(lg * C)
        S = torch.zeros((B, H, m, hd), dtype=torch.float32, device=dev)
        z = torch.zeros((B, H, m), dtype=torch.float32, device=dev)
    else:
        R = alpha.shape[-1]
        S = torch.zeros((B, H, R * m, hd), dtype=torch.float32, device=dev)
        z = torch.zeros((B, H, R * m), dtype=torch.float32, device=dev)
    for c0 in range(0, Lp, C):
        q, k, v = (t[:, :, c0:c0 + C] for t in (qp, kp, vp))
        scores = (q @ k.transpose(-1, -2)) * dmat[None]
        num = scores @ v
        den = scores.sum(dim=-1)
        if lg is not None:
            qd = q * decq[None, :, :, None]
            kd = k * deck[None, :, :, None]
            num = num + qd @ S
            den = den + (qd @ z[..., None])[..., 0]
            S = S * gC[None, :, None, None] + kd.transpose(-1, -2) @ v
            z = z * gC[None, :, None] + kd.sum(dim=2)
        else:
            # the R stacked moments as one (R*m)-wide product, as the
            # kernel's concatenated alpha*q / beta*k
            a = alpha[:, c0:c0 + C]  # (H, C, R)
            b = beta[:, c0:c0 + C]
            qa = (a[None, :, :, :, None] * q[:, :, :, None, :]).reshape(
                B, H, C, R * m)
            kb = (b[None, :, :, :, None] * k[:, :, :, None, :]).reshape(
                B, H, C, R * m)
            num = num + qa @ S
            den = den + (qa @ z[..., None])[..., 0]
            S = S + kb.transpose(-1, -2) @ v
            z = z + kb.sum(dim=2)
        nums.append(num)
        dens.append(den)
    return torch.cat(nums, dim=2), torch.cat(dens, dim=2)


def _emit(num, den, res_num, res_den, normalize: bool, eps: float):
    if res_num is not None:
        num = num + res_num
        den = den + res_den
    if not normalize:
        return num, den
    den = torch.where(den.abs() < eps, eps, den)
    return num / den[..., None]


def _plain_forward(spec: TopoSpec, qf, kf, v, coeffs):
    L = qf.shape[2]
    qp, kp, vp, Lp = _pad_inputs(spec, qf, kf, v, coeffs)
    lg, alpha, beta, dmat_inc, dmat_strict = _prepare(spec, coeffs, Lp)
    num, den = _sweep(qp, kp, vp, dmat_inc, lg, alpha, beta)
    if not spec.causal:
        # tables deliberately unflipped: see _kernel_forward
        nb, db = _sweep(_flip(qp), _flip(kp), _flip(vp), dmat_strict, lg,
                        alpha, beta)
        num = num + _flip(nb)
        den = den + torch.flip(db, dims=(2,))
    return _emit(num, den, None, None, True, spec.eps)[:, :, :L]


# ----------------------------------------------------------------------------
# the kernel's wrapper and the fused forward
# ----------------------------------------------------------------------------


def _check(qf, kf, v, dmat, log_gamma, alpha, beta, res_num, res_den):
    named = {"qf": qf, "kf": kf, "v": v, "dmat": dmat,
             "log_gamma": log_gamma, "alpha": alpha, "beta": beta,
             "res_num": res_num, "res_den": res_den}
    for name, t in named.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != qf.device:
            raise ValueError(f"{name} is on {t.device}, qf on {qf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (log_gamma is None) == (alpha is None) or (alpha is None) != (
            beta is None):
        raise ValueError("pass log_gamma (decay mode) XOR alpha and beta "
                         "(rank mode)")
    if (res_num is None) != (res_den is None):
        raise ValueError("pass res_num and res_den together")
    if qf.ndim != 4 or kf.shape != qf.shape or v.ndim != 4:
        raise ValueError(f"expected qf, kf (B, H, L, m) and v (B, H, L, hd); "
                         f"got {tuple(qf.shape)}, {tuple(kf.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, L, m = qf.shape
    hd = v.shape[-1]
    if v.shape[:3] != (B, H, L):
        raise ValueError(f"v {tuple(v.shape)} does not match qf "
                         f"{tuple(qf.shape)}")
    if dmat.ndim != 3 or dmat.shape[0] != H or dmat.shape[1] != dmat.shape[2]:
        raise ValueError(f"dmat must be (H, C, C), got {tuple(dmat.shape)}")
    C = dmat.shape[-1]
    if not 1 <= C <= kernel.MAX_CHUNK or L % C:
        raise ValueError(f"L={L} must be a multiple of the chunk C={C}, and "
                         f"1 <= C <= {kernel.MAX_CHUNK}")
    if log_gamma is not None and tuple(log_gamma.shape) != (H,):
        raise ValueError(f"log_gamma must be (H,), got "
                         f"{tuple(log_gamma.shape)}")
    if alpha is not None and (alpha.ndim != 3 or alpha.shape[:2] != (H, L)
                              or beta.shape != alpha.shape):
        raise ValueError(f"alpha and beta must be (H, L, R), got "
                         f"{tuple(alpha.shape)}, {tuple(beta.shape)}")
    if res_num is not None and (res_num.shape != (B, H, L, hd)
                                or res_den.shape != (B, H, L)):
        raise ValueError(f"res_num must be (B, H, L, hd) and res_den "
                         f"(B, H, L); got {tuple(res_num.shape)}, "
                         f"{tuple(res_den.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in named.values()):
        raise NotImplementedError(
            "the raw topo sweep has no backward: differentiate through the "
            "fused entry topo_linear_attention(..., use_kernel=True), whose "
            "backward is the plain sweep's VJP, or run under "
            "torch.no_grad()")


def topo_attention_sweep(qf, kf, v, dmat, *, log_gamma=None, alpha=None,
                         beta=None, res_num=None, res_den=None,
                         normalize: bool = True, eps: float = 1e-6):
    """One fused causal sweep (the counterpart of
    `topo_attention_sweep_pallas`). qf/kf: (B, H, L, m); v: (B, H, L, hd);
    dmat: (H, C, C) exact within-chunk mask tile, which vanishes above its
    diagonal (the causal tile `_prepare` makes; the kernel reads only the
    tiles on and below it); `log_gamma` (H,) [decay
    mode] XOR `alpha`+`beta` (H, L, R) [rank mode]; optional res_num
    (B, H, L, hd) / res_den (B, H, L) added before normalization. All
    float32 and contiguous; L a multiple of C.

    Returns out (B, H, L, hd) if normalize, else (num, den (B, H, L)).
    On CPU and fake tensors the plain sweep runs; an open cost count
    reads B2's work either way."""
    global LAUNCHES
    _check(qf, kf, v, dmat, log_gamma, alpha, beta, res_num, res_den)
    B, H, L, m = qf.shape
    R = 0 if alpha is None else alpha.shape[-1]
    with _count.kernel_call("topo_attention_sweep", lambda: RK.topo_work(
            B, H, L, m, v.shape[-1], dmat.shape[-1], R)):
        if qf.device.type == "cpu" or _count.shapes_only(qf):
            num, den = _sweep(qf, kf, v, dmat, log_gamma, alpha, beta)
            return _emit(num, den, res_num, res_den, normalize, eps)
        if qf.device.type != "cuda":
            raise ValueError(f"no topo sweep kernel for device {qf.device}")
        got = kernel.topo_sweep_cuda(qf, kf, v, dmat, log_gamma, alpha,
                                     beta, res_num, res_den, normalize, eps)
        LAUNCHES += 1
        return got


def _kernel_forward(spec: TopoSpec, qf, kf, v, coeffs):
    """Fused forward: one sweep (causal) or two fused sweeps
    (bidirectional, the second combining + normalizing in-kernel)."""
    L = qf.shape[2]
    qp, kp, vp, Lp = _pad_inputs(spec, qf, kf, v, coeffs)
    lg, alpha, beta, dmat_inc, dmat_strict = _prepare(spec, coeffs, Lp)
    kw = dict(log_gamma=lg, eps=spec.eps,
              alpha=None if alpha is None else alpha.contiguous(),
              beta=None if beta is None else beta.contiguous())
    if spec.causal:
        out = topo_attention_sweep(qp, kp, vp, dmat_inc.contiguous(),
                                   normalize=True, **kw)
        return out[:, :, :L]
    num, den = topo_attention_sweep(qp, kp, vp, dmat_inc.contiguous(),
                                    normalize=False, **kw)
    # The reversed strict sweep covers j > i; the forward partials ride in
    # as residuals. The rank tables are NOT flipped: the reversed sweep
    # indexes row p' = Lp-1-p, and alpha[Lp-1-i]·beta[Lp-1-j] ~=
    # f((Lp-1-i) - (Lp-1-j)) = f(j - i), the anticausal distance. Flipping
    # them would evaluate f(i - j) and corrupt any odd-coefficient mask.
    out_rev = topo_attention_sweep(
        _flip(qp), _flip(kp), _flip(vp), dmat_strict.contiguous(),
        res_num=_flip(num), res_den=torch.flip(den, dims=(2,)),
        normalize=True, **kw)
    return _flip(out_rev)[:, :, :L]


class _Fused(torch.autograd.Function):
    """`_kernel_forward` forward, `_plain_forward`'s VJP backward (the
    reference's `_fused` / `_fused_bwd`)."""

    @staticmethod
    def forward(ctx, spec, qf, kf, v, coeffs):
        ctx.spec = spec
        ctx.save_for_backward(qf, kf, v, coeffs)
        return _kernel_forward(spec, qf, kf, v, coeffs)

    @staticmethod
    def backward(ctx, ct):
        return (None, *plain_vjp(
            lambda *ins: _plain_forward(ctx.spec, *ins), ctx.saved_tensors,
            ctx.needs_input_grad[1:], ct))


def topo_linear_attention(qf, kf, v, coeffs, *, g: str = "exp",
                          dist_scale: float = 1.0, causal: bool = True,
                          chunk: int = 128, rank: int = 16,
                          eps: float = 1e-6, use_kernel: bool | None = None):
    """Fused Alg.-1 masked linear attention over the sequence mask.

    qf/kf: (B, H, L, m) nonneg phi features; v: (B, H, L, hd);
    coeffs: (H, t+1) or (t+1,) effective mask coefficients (already
    constraint-shaped, e.g. attention.topo_mask_coeffs). Any L (padded to a
    chunk multiple internally). Returns (B, H, L, hd) float32.

    use_kernel=None takes the kernel for CUDA tensors and the plain sweep
    for CPU tensors; use_kernel=True takes the kernel path anywhere (on the
    CPU the wrapper then runs the plain sweep through the kernel path's
    padding, flips and residuals); use_kernel=False the plain sweep. The
    kernel path differentiates through the plain sweep's VJP (`_Fused`)."""
    B, H, L, m = qf.shape
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=qf.device)
    if coeffs.ndim == 1:
        coeffs = coeffs[None].expand(H, coeffs.shape[0])
    if use_kernel is None:
        use_kernel = qf.device.type == "cuda"
    C = min(chunk, _round_up(L, 8))
    spec = TopoSpec(g, float(dist_scale), bool(causal), C, int(rank),
                    float(eps))
    if use_kernel:
        return _Fused.apply(spec, qf, kf, v, coeffs)
    return _plain_forward(spec, qf, kf, v, coeffs)


def topo_linear_attention_sharded(qf, kf, v, coeffs, *, mesh,
                                  batch_axis: str = "data",
                                  head_axis: str = "model", **kw):
    """`topo_linear_attention` over the ranks of `mesh`: batch over its
    `batch_axis` and heads over its `head_axis`. Every (batch, head) pair's
    sweep is independent, so each rank runs the identical fused sweep on
    its (B/b, H/h) slab with no collective, and all_gathers (heads, then
    batch) assemble the (B, H, L, hd) result on every rank, equal to the
    single-device call's. An axis whose extent does not divide its dim is
    dropped (that dim runs replicated), as the reference's
    `launch.sharding.shard` drops it. Every rank passes the same inputs
    and gets the whole gradient of each: a rank differentiates only its
    slab, so the inputs' grads are summed over each kept axis."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding

    B, H = qf.shape[0], qf.shape[1]
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=qf.device)
    if coeffs.ndim == 1:
        coeffs = coeffs[None].expand(H, coeffs.shape[0])

    def keep(axis, n):
        size = sharding.axis_size(mesh, axis)
        return axis if size > 1 and n % size == 0 else None

    ba, ha = keep(batch_axis, B), keep(head_axis, H)
    if ba is None and ha is None:
        return topo_linear_attention(qf, kf, v, coeffs, **kw)

    def part(axis, n):
        if axis is None:
            return slice(0, n)
        s = n // sharding.axis_size(mesh, axis)
        k = sharding.axis_rank(mesh, axis)
        return slice(k * s, (k + 1) * s)

    for axis in (ba, ha):
        if axis is not None:
            qf, kf, v, coeffs = C.replicated(
                (qf, kf, v, coeffs), sharding.axis_group(mesh, axis))
    bs, hs = part(ba, B), part(ha, H)
    out = topo_linear_attention(qf[bs, hs], kf[bs, hs], v[bs, hs],
                                coeffs[hs], **kw)
    if ha is not None:
        out = C.all_gather(out.transpose(0, 1).contiguous(),
                           sharding.axis_group(mesh, ha)).transpose(0, 1)
    if ba is not None:
        out = C.all_gather(out.contiguous(), sharding.axis_group(mesh, ba))
    return out
