"""Softmax attention with online-softmax statistics (flash attention
forward).

  * `sdpa_chunked` is the plain version: the reference's `_sdpa_chunked`
    (models/attention.py), a loop over KV blocks with running (max, sum,
    acc) statistics in float32 that never holds the (Lq, Lk) logits. It
    takes the model's (B, L, H, hd) / (B, L, KV, hd) layout with GQA,
    `causal`, `window` and `softcap`; any Lk (a ragged last block is
    simply shorter). It is the CPU path of the wrapper and the model's
    `attn_impl="chunked"`.
  * `flash_attention` is the kernel's wrapper, in the reference kernel's
    (B, H, L, hd) layout with GQA k (B, KV, Lk, hd) and v (B, KV, Lk, vd),
    vd = hd or MLA's packed (hd, vd) = (192, 128); causal (Lk = L), causal
    under a local window (RecurrentGemma's local attention) or non-causal
    with any Lk (an encoder's self-attention, a decoder's cross-attention
    over the encoder's memory): a CUDA tensor launches the kernel
    (kernel.py, built from flash_attention.cu) or the call raises; a CPU
    tensor runs the plain version. `LAUNCHES` counts kernel launches, and
    `LAUNCHES_BY_MODE` four modes apart: "window" (causal under a window),
    "causal", "cross" (non-causal with Lk != L) and "full" (non-causal,
    Lk = L). The kernel path is a `torch.autograd.Function`:
    its forward is the kernel, its backward the VJP of `sdpa_chunked`
    recomputed from the saved q, k, v (the reference's design: its custom
    VJPs run the Pallas kernel forward and differentiate the XLA twin), so
    it never holds the (L, L) logits at once. Its bf16 path (tensor cores, TMA copies) needs 16-byte-aligned rows: a
    CUDA view without them is refused, never copied.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _count
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels._vjp import plain_vjp
from repro_torch.models.layers import softcap
from repro_torch.roofline import kernels as RK

LAUNCHES = 0
LAUNCHES_BY_MODE = {"causal": 0, "full": 0, "window": 0, "cross": 0}
NEG_INF = -1e30  # the reference's mask value (not -inf)


def sdpa_chunked(q, k, v, causal: bool = True, window: int = 0,
                 cap: float = 0.0, blk: int = 512):
    """q: (B, Lq, H, hd); k: (B, Lk, KV, hd); v: (B, Lk, KV, vd). Returns
    (B, Lq, H, vd) in q's dtype. Positions are aranges (query i at i, key
    j at j), as at every call site of the reference."""
    B, Lq, H, hd = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    vd = v.shape[-1]
    dev = q.device
    qg = (q.reshape(B, Lq, KV, G, hd).float()
          / math.sqrt(hd)).permute(0, 2, 3, 1, 4)  # (B, KV, G, Lq, hd)
    qpos = torch.arange(Lq, device=dev)
    m = torch.full((B, KV, G, Lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Lq, vd), dtype=torch.float32, device=dev)
    for k0 in range(0, Lk, min(blk, Lk)):
        kc = k[:, k0:k0 + blk].float().permute(0, 2, 3, 1)[:, :, None]
        vc = v[:, k0:k0 + blk].float().permute(0, 2, 1, 3)[:, :, None]
        s = softcap(qg @ kc, cap)  # (B, KV, G, Lq, n)
        kpos = k0 + torch.arange(kc.shape[-1], device=dev)
        mask = torch.ones((Lq, kc.shape[-1]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window and window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vc
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)  # (B, Lq, KV, G, vd)
    return out.reshape(B, Lq, H, vd).to(q.dtype)


def mode(q, k, causal: bool, window: int) -> str:
    """The `LAUNCHES_BY_MODE` key of a call on q (B, H, L, hd), k (B, KV,
    Lk, hd)."""
    if window:
        return "window"
    if causal:
        return "causal"
    return "full" if k.shape[2] == q.shape[2] else "cross"


def _check(q, k, v, kernel_path: bool, causal: bool = True,
           window: int = 0) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if (q.ndim, k.ndim, v.ndim) != (4, 4, 4) or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"expected q (B, H, L, hd), k (B, KV, Lk, hd) and v "
                         f"(B, KV, Lk, vd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, hd = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[3]) != (B, hd) or H % KV or k.shape[2] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}: same B, hd and H a multiple "
                         "of KV")
    if causal and k.shape[2] != L:
        raise ValueError(f"causal attention needs k's length equal to q's; "
                         f"got {k.shape[2]} keys for {L} queries")
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a local window is causal and "
                         "positive (0: none)")
    if not kernel_path:
        return
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (hd, v.shape[-1]) not in kernel.HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes (q/k head_dim, v "
                         f"head_dim) in {kernel.HEAD_DIMS}, got "
                         f"({hd}, {v.shape[-1]})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride along head_dim")
    if (q.device.type == "cuda" and not _count.shapes_only(q)
            and q.dtype == torch.bfloat16) and any(
            t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError(
            "the bf16 flash attention kernel reads q, k, v through TMA "
            "tensor maps: each needs a 16-byte-aligned start and strides "
            "that are multiples of 8 elements (16-byte rows)")


def _plain(q, k, v, causal: bool, window: int = 0):
    """The plain version in the kernel's (B, H, L, hd) layout."""
    out = sdpa_chunked(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal, window)
    return out.transpose(1, 2)


def _forward(q, k, v, causal: bool, window: int = 0):
    """The kernel on CUDA tensors, the plain version on CPU and fake
    tensors; an open cost count reads B5's work either way."""
    B, H, L, hd = q.shape
    KV, Lk, vd = k.shape[1], k.shape[2], v.shape[-1]
    with _count.kernel_call("flash_attention", lambda: RK.flash_work(
            B, H, KV, L, hd, causal, q.element_size(), vd, Lk, window)):
        return _route(q, k, v, causal, window)


def _route(q, k, v, causal: bool, window: int):
    global LAUNCHES
    if q.device.type == "cpu" or _count.shapes_only(q):
        return _count.like_kernel(_plain(q, k, v, causal, window),
                                  kernel.out_buffer(q, v.shape[-1]))
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    out = kernel.flash_attention_cuda(q, k, v, causal, window)
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode(q, k, causal, window)] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, `sdpa_chunked`'s VJP backward (with the forward's
    window, over k's and v's length)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(lambda q, k, v: _plain(q, k, v, ctx.causal,
                                                  ctx.window),
                           ctx.saved_tensors, ctx.needs_input_grad[:3], g),
                None, None)


def flash_attention(q, k, v, causal: bool = True,
                    use_kernel: bool | None = None, window: int = 0):
    """Softmax attention (the counterpart of `flash_attention_pallas`). q:
    (B, H, L, hd); k: (B, KV, Lk, hd); v: (B, KV, Lk, vd), with H a
    multiple of KV (GQA: query head h reads k/v head h // (H // KV)); scale
    1/sqrt(hd). Causal needs Lk = L; `window` > 0 (causal only) lets query
    i see key j iff i - j < window. Returns (B, H, L, vd) in q's dtype. The
    kernel path takes the (hd, vd) pairs of `kernel.HEAD_DIMS` and raises
    on any other.

    use_kernel=None or True: the kernel path (the kernel on CUDA tensors,
    the plain version on CPU tensors; differentiable through the plain
    version's VJP); False: the plain version."""
    kernel_path = use_kernel is not False
    _check(q, k, v, kernel_path, causal, window)
    if not kernel_path:
        return _plain(q, k, v, causal, window)
    return _FlashAttention.apply(q, k, v, causal, window)
