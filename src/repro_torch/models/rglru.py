"""RG-LRU recurrent block of the port (RecurrentGemma), the counterpart of
the reference's `models/rglru.py`.

Block: x -> (gate branch z, recurrent branch); the recurrent branch is a
causal conv1d of width 4, then the RG-LRU; out = (lru_out * gelu(z)) @
out_proj. The RG-LRU, in float32:

    r_t = sigmoid(x_t W_r),  i_t = sigmoid(x_t W_i)
    a_t = exp(-c softplus(Lambda) r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The reference runs the recurrence as `jax.lax.associative_scan` in XLA,
not as a Pallas kernel, so the port has no CUDA kernel here: the scan is
plain PyTorch, log2(L) doubling passes over (B, L, w) (the selective
scan's `_assoc_scan`), 12 elementwise passes at L = 4096 where a loop over
L would take 4096. Decode carries {"conv": (B, 3, w)} in the model's dtype
and {"h": (B, w)} in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import _assoc_scan
from repro_torch.launch import sharding
from repro_torch.launch.sharding import shard
from repro_torch.models.layers import Params, causal_conv_step, dense_init

_RGLRU_C = 8.0
CONV_K = 4  # the causal conv's width


def lru_shapes(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {"in_proj": (d, 2 * w), "conv_w": (w, CONV_K), "conv_b": (w,),
            "gates": (w, 2 * w), "a_param": (w,), "out_proj": (w, d)}


def lru_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The reference's init recipe: dense projections, a conv of N(0, 0.1),
    zero bias, and Lambda = softplus^-1(a) for a ~ U(0.9, 0.999)."""
    d, w = cfg.d_model, cfg.lru_width
    dev = gen.device
    u = torch.rand((w,), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    return {
        "in_proj": dense_init(gen, (d, 2 * w), dtype=dtype),
        "conv_w": (torch.randn((w, CONV_K), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "gates": dense_init(gen, (w, 2 * w), dtype=dtype),
        "a_param": torch.log(torch.expm1(u.clamp_min(1e-4))).to(dtype),
        "out_proj": dense_init(gen, (w, d), dtype=dtype),
    }


class LRU(Params):
    """The parameters of one RG-LRU block (`lru_shapes`)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__(lru_shapes(cfg), dtype, device)


def _conv1d(x, w, b):
    """Causal depthwise conv over x (B, L, w) with taps w (w, K), summed in
    the reference's order (tap 0 first), then the bias."""
    if sharding.is_dtensor(x):  # channel by channel: each rank its slab
        return sharding.slab_face(_conv1d, (x, w, b),
                                  ((0, 2), (None, 0), (None, 0)), (0, 2))
    K, L = w.shape[1], x.shape[1]
    xpad = F.pad(x, (0, 0, K - 1, 0))
    out = xpad[:, 0:L] * w.T[0]
    for k in range(1, K):
        out = out + xpad[:, k:k + L] * w.T[k]
    return out + b


def _gates(p, xc):
    """r and i, float32, from the conv output."""
    return torch.sigmoid((xc @ p.gates).float()).chunk(2, dim=-1)


def _decay(p, r):
    """(a, sqrt(1 - a^2)) of the gate r, float32."""
    log_a = -_RGLRU_C * F.softplus(p.a_param.float()) * r
    return (torch.exp(log_a),
            torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)))


def _rglru_scan(p, x, r, i):
    """x, r, i: (B, L, w) float32. Returns (h (B, L, w), h at L - 1)."""
    a, s = _decay(p, r)
    _, h = _assoc_scan(a, s * (i * x))
    return h, h[:, -1]


def _split(p, x):
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    return shard(xin, ("batch", "seq", "inner")), z


def lru_block_train(cfg, p, x):
    xin, z = _split(p, x)
    xc = _conv1d(xin, p.conv_w, p.conv_b)
    r, i = _gates(p, xc)
    h, _ = _rglru_scan(p, xc.float(), r, i)
    y = h.to(x.dtype) * F.gelu(z, approximate="tanh")
    return y @ p.out_proj


def lru_block_prefill(cfg, p, x, lengths, cache):
    """One scan over the (right-padded) prompt that also yields the decode
    state: r = i = 0 at padded positions (a = 1, no input), so the state
    passes through them and the final state is each row's after its last
    real token. Rows with lengths[b] == 0 keep their cache."""
    B, L, _ = x.shape
    xin, z = _split(p, x)
    xc = _conv1d(xin, p.conv_w, p.conv_b)
    r, i = _gates(p, xc)
    dev = x.device
    vmask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]
             ).float()[..., None]
    h, h_fin = _rglru_scan(p, xc.float(), r * vmask, i * vmask)
    y = (h.to(x.dtype) * F.gelu(z, approximate="tanh")) @ p.out_proj
    K = p.conv_w.shape[1]
    cidx = lengths[:, None] - (K - 1) + torch.arange(K - 1, device=dev)[None]
    rows = torch.arange(B, device=dev)[:, None]
    conv = torch.where((cidx >= 0)[..., None],
                       xin[rows, cidx.clamp(0, max(L - 1, 0)).long()],
                       0.0).to(cache["conv"].dtype)
    valid = lengths > 0
    return y, {"conv": torch.where(valid[:, None, None], conv,
                                   cache["conv"]),
               "h": torch.where(valid[:, None], h_fin, cache["h"])}


def lru_decode_init(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    w = cfg.lru_width
    return {"conv": torch.zeros((B, CONV_K - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((B, w), dtype=torch.float32, device=device)}


def _state_slab(seq, c, a, u, gz):
    """h <- a h + u and the gated output h gz on one rank's slab."""
    h = a * c["h"] + u
    return (h.to(gz.dtype) * gz,), {"h": h}


def lru_block_decode(cfg, p, x, cache):
    """x: (B, 1, d). Returns (y (B, 1, d), new cache). A DTensor cache
    steps on each rank's (batch, channels) slab (`sharding.cache_face`)."""
    xin, z = _split(p, x)
    xc, conv = causal_conv_step(cache["conv"], xin, p.conv_w, p.conv_b)
    r, i = _gates(p, xc)
    a, s = _decay(p, r)
    ch = {"batch": 0, "heads": 1}
    (y,), new = sharding.cache_face(
        _state_slab, {"h": cache["h"]}, {"h": ch},
        (a, s * (i * xc.float()), F.gelu(z[:, 0], approximate="tanh")),
        (ch, ch, ch), (ch,))
    return y[:, None, :] @ p.out_proj, {"conv": conv, "h": new["h"]}
