"""Port of flash attention (kernel B5) and the pieces of full attention:
the plain online-softmax version (`ops.sdpa_chunked`) and the kernel
wrapper's CPU path against the reference's Pallas kernel (interpret mode),
its dense oracle `attention_ref` and its XLA twin `_sdpa_chunked` (causal
and not, GQA, ragged L, window, softcap); the port's `_sdpa`, rope and
softcap against the reference's; the wrapper's refusals. The kernel itself
is held against the plain version on a card by test_torch_cuda.py."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as j_attention_ref)
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
TOL = 2e-5  # tests/test_kernels.py::test_flash_attention


def _err(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(ref, np.float64))))


def _qkv(rng, B, H, KV, L, hd):
    """q (B, H, L, hd), k and v (B, KV, L, hd), float32 normals."""
    return (rng.normal(size=(B, H, L, hd)).astype(np.float32),
            rng.normal(size=(B, KV, L, hd)).astype(np.float32),
            rng.normal(size=(B, KV, L, hd)).astype(np.float32))


def _expand(a, G):
    return np.repeat(a, G, axis=1)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,KV,L,hd", [
    (2, 2, 2, 64, 16),     # G = 1
    (1, 4, 1, 96, 32),     # G = 4
    (1, 4, 1, 100, 16),    # G = 4, L not a multiple of the 64-row tile
    (2, 2, 2, 37, 8)])     # ragged, narrow head
def test_plain_version_matches_reference_kernel_and_oracle(causal, B, H, KV,
                                                           L, hd):
    q, k, v = _qkv(np.random.default_rng(L + hd), B, H, KV, L, hd)
    G = H // KV
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, use_kernel=False)
    assert got.shape == (B, H, L, hd) and got.dtype == torch.float32
    kx, vx = _expand(k, G), _expand(v, G)
    want_kernel = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), causal=causal,
        blk_q=L if L % 32 else 32, blk_k=L if L % 32 else 32, interpret=True)
    want_ref = j_attention_ref(jnp.asarray(q), jnp.asarray(kx),
                               jnp.asarray(vx), causal=causal)
    assert _err(got, want_kernel) < TOL
    assert _err(got, want_ref) < TOL
    # the port's own oracle is the reference's
    assert _err(attention_ref(torch.from_numpy(q), torch.from_numpy(kx),
                              torch.from_numpy(vx), causal), want_ref) < TOL


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 5, 0.0), (True, 0, 3.0),
    (False, 7, 2.0)])
@pytest.mark.parametrize("L,blk", [(48, 16), (40, 512)])
def test_sdpa_chunked_matches_reference_twin(causal, window, cap, L, blk):
    """The model-layout twin with GQA, window and softcap, against the
    reference's `_sdpa_chunked` (blocks that tile L: the reference's own
    precondition)."""
    B, H, KV, hd = 2, 4, 2, 16
    rng = np.random.default_rng(L + window)
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(rng, B, H, KV, L, hd))
    rcfg = ref_smoke("llama3_2_1b", attn_logit_softcap=cap)
    want = JA._sdpa_chunked(rcfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal, window, blk=blk)
    got = ops.sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal, window, cap, blk=blk)
    assert got.shape == (B, L, H, hd)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd,vd,KV", [(192, 128, 2), (256, 256, 1)])
def test_wide_head_dims_match_reference(hd, vd, KV, causal):
    """The kernel's new (hd, vd) pairs on the CPU: the plain twin and the
    wrapper's plain path (MLA's v narrower than q/k; Gemma's 256) against
    the reference's `_sdpa_chunked`, and the dense oracle `attention_ref`
    against it too (and against the reference's `_sdpa` where vd = hd,
    which `_sdpa` requires); the output is (..., vd), scale 1/sqrt(hd)."""
    B, H, L = 2, 4, 40
    rng = np.random.default_rng(hd + vd)
    q = rng.normal(size=(B, L, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, KV, vd)).astype(np.float32)
    rcfg = ref_smoke("llama3_2_1b")
    want = JA._sdpa_chunked(rcfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal, 0, blk=20)
    got = ops.sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal)
    assert got.shape == (B, L, H, vd)
    assert _err(got, want) < TOL
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    before = ops.LAUNCHES
    wrapped = ops.flash_attention(tq, tk, tv, causal)
    assert ops.LAUNCHES == before and wrapped.shape == (B, H, L, vd)
    assert _err(wrapped.transpose(1, 2), want) < TOL
    G = H // KV
    oracle = attention_ref(tq, tk.repeat_interleave(G, 1),
                           tv.repeat_interleave(G, 1), causal)
    assert _err(oracle.transpose(1, 2), want) < TOL
    if vd == hd:
        idx = np.arange(L)
        mask = (idx[:, None] >= idx[None, :] if causal
                else np.ones((L, L), bool))[None, None]
        dense = JA._sdpa(rcfg, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v), jnp.asarray(mask))
        assert _err(oracle.transpose(1, 2), dense) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_sdpa_matches_reference(dtype, causal):
    """The port's `_sdpa` (attn_impl "naive"): float32 within 2e-5; bf16,
    where both cast the weights to v's dtype before P v, within bf16's
    rounding."""
    B, H, KV, L, hd = 2, 4, 2, 24, 16
    rng = np.random.default_rng(3)
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(rng, B, H, KV, L, hd))
    idx = np.arange(L)
    mask = (idx[:, None] >= idx[None, :] if causal
            else np.ones((L, L), bool))[None, None]
    rcfg = ref_smoke("llama3_2_1b")
    jd = getattr(jnp, dtype)
    want = JA._sdpa(rcfg, *(jnp.asarray(a, jd) for a in (q, k, v)),
                    jnp.asarray(mask))
    td = getattr(torch, dtype)
    got = TA._sdpa(get_smoke_config("llama3_2_1b"),
                   *(torch.from_numpy(a).to(td) for a in (q, k, v)),
                   torch.from_numpy(mask))
    assert got.dtype == td and got.shape == (B, L, H, hd)
    tol = TOL if dtype == "float32" else 2e-2
    assert _err(got.float(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4200, (2, 9)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)),
                               rtol=1e-6)
    # angles up to 4200 rad: float32 sin/cos of the two libraries differ by
    # a few ulps of the angle
    tol = 2e-3 if dtype == "float32" else 2e-2
    assert _err(got.float(), np.asarray(want, np.float32)) < tol
    small = pos % 64  # where the angle's rounding is small
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(small), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(small), theta)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_softcap_matches_reference(cap):
    x = np.linspace(-30, 30, 61).astype(np.float32)
    assert _err(TL.softcap(torch.from_numpy(x), cap),
                JL.softcap(jnp.asarray(x), cap)) < 1e-5


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(0),
                                                  1, 4, 2, 50, 16))
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, True)
    plain = ops.flash_attention(q, k, v, True, use_kernel=False)
    assert ops.LAUNCHES == before
    assert torch.equal(got, plain)
    # the model's (B, L, H, hd) tensors go in as transposed views
    view = ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, True)
    assert torch.equal(view, got)


@pytest.mark.parametrize("bad", [
    "rank", "heads", "length", "dtype_mix", "dtype_f16", "head_dim",
    "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(0),
                                                  1, 4, 2, 32, 16))
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k, v = k[:, :1].expand(1, 3, 32, 16), v[:, :1].expand(1, 3, 32, 16)
    elif bad == "length":
        k, v = k[:, :, :31], v[:, :, :31]
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "dtype_f16":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (t[..., :12] for t in (q, k, v))
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


def test_kernel_path_refuses_inputs_that_require_grad():
    """The kernel path no longer refuses inputs that require grad: its
    autograd.Function's backward is the plain version's VJP, so q, k and v
    get the plain path's grads (GQA, causal and not); under no_grad it
    runs as before."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 4, 2, 16, 16))
    u = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    for causal in (True, False):
        grads = []
        for use_kernel in (True, False):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (ops.flash_attention(*ins, causal=causal, use_kernel=use_kernel)
             * u).sum().backward()
            grads.append([t.grad for t in ins])
        for got, want in zip(*grads):
            assert float(want.abs().max()) > 0
            assert torch.equal(got, want)
    with torch.no_grad():
        ops.flash_attention(q, k, v)


def test_model_kernel_path_refuses_window_and_softcap():
    """The kernel path refuses a logit softcap (the kernel has none, nor
    has the reference's). A local window it no longer refuses: on CPU
    tensors it runs the plain version under the window."""
    cfg = get_smoke_config("llama3_2_1b", attn_impl="cuda",
                           attn_logit_softcap=5.0)
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="softcap"):
        TA._attend(cfg, q, k, k, True, 0)
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(rng, 1, 4, 2, 8, 16))
    got = TA._attend(cfg.replace(attn_logit_softcap=0.0), q, k, v, True, 4)
    assert torch.equal(got, ops.sdpa_chunked(q, k, v, True, 4))
    with pytest.raises(ValueError, match="attn_impl"):
        TA._attend(cfg.replace(attn_impl="pallas"), q, k, k, True, 0)


def _bf16_roundings(got, want):
    """chip_smoke.py's bf16 gate: max |got - want| over one bf16 rounding of
    the larger magnitude (2^-7 of it) plus the float32 bound; at most 1."""
    got, want = got.float(), want.float()
    room = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + TOL
    return float(((got - want).abs() / room).max())


def _wgmma_bf16_emulation(q, k, v, causal, split_p=True):
    """The bf16 kernel's arithmetic (flash_attention.cu, flash_wgmma_kernel)
    in PyTorch on the CPU: per 64-key tile, S = q k^T summed in fp32 by
    16-deep steps, times scale * log2(e) in fp32; the online softmax in
    fp32 with exp2 (running max, correction, l the fp32 sum of the fp32
    P); P split into bf16 hi + lo (or rounded once, split_p=False), each
    times the bf16 v with fp32 sums; the output rounded to bf16."""
    B, H, L, hd = q.shape
    G = H // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(G, 1).float()
    vf = v.repeat_interleave(G, 1).float()
    scale_log2 = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(np.log2(np.e), dtype=torch.float32)
    m = torch.full((B, H, L), -1e30)
    l = torch.zeros((B, H, L))
    o = torch.zeros((B, H, L, hd))
    rows = torch.arange(L)
    for k0 in range(0, L, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = torch.zeros((B, H, L, kt.shape[2]))
        for d0 in range(0, hd, 16):
            s = s + qf[..., d0:d0 + 16] @ kt[..., d0:d0 + 16].transpose(-1, -2)
        s = s * scale_log2
        if causal:
            keys = k0 + torch.arange(kt.shape[2])
            s = torch.where(keys[None, :] > rows[:, None], -1e30, s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        o = o * corr[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("peak", [1.0, 4.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("B,H,KV,L,hd", [
    (1, 4, 1, 100, 16),    # GQA, L not a multiple of the 64-key tile
    (2, 2, 2, 37, 64),     # ragged, one partial tile
    (1, 2, 2, 128, 32),
    (1, 2, 1, 200, 64)])   # GQA, ragged, four tiles
def test_bf16_tensor_core_arithmetic_keeps_the_bf16_gate(causal, peak, B, H,
                                                         KV, L, hd):
    """The design of the bf16 kernel, emulated on the CPU, stays within one
    bf16 rounding (+ 2e-5) of the plain version, peaked logits (q x 4)
    included: the numerics are settled before the card sees them."""
    q, k, v = _qkv(np.random.default_rng(L + hd), B, H, KV, L, hd)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q * peak, k,
                                                                 v))
    got = _wgmma_bf16_emulation(q, k, v, causal)
    want = ops.flash_attention(q, k, v, causal, use_kernel=False)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _bf16_roundings(got, want) <= 1.0


def test_one_bf16_rounding_of_p_would_break_the_gate():
    """Why the kernel splits P: rounded once to bf16 before P v, the same
    emulation lands many bf16 roundings from the plain version."""
    q, k, v = _qkv(np.random.default_rng(5), 1, 2, 1, 200, 64)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q * 4.0, k,
                                                                 v))
    want = ops.flash_attention(q, k, v, True, use_kernel=False)
    split = _bf16_roundings(_wgmma_bf16_emulation(q, k, v, True), want)
    single = _bf16_roundings(
        _wgmma_bf16_emulation(q, k, v, True, split_p=False), want)
    assert split <= 1.0 < 4.0 < single


def test_flash_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = kernel.SOURCE.read_text()
    assert "flash_attention_pallas" in src
    assert "src/repro/kernels/flash_attention/kernel.py" in src
    assert "Bound on an H100" in src
    assert 'extern "C" int flash_attention_launch' in src
    assert kernel.SOURCE.parent == PKG / "kernels" / "flash_attention"
    # the bf16 path: tensor cores through wgmma, P split in two, a ring of
    # TMA stages on mbarriers; its bound and the fp32 one
    note = src[:src.index("#include")]
    for word in ("wgmma", "P_hi", "P_lo", "mbarrier", "TMA",
                 "0.278 ms", "4.104 ms"):
        assert word in note, word
    assert "later PR" not in note
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src


# ----------------------------------------------------------------------------
# a local window (RecurrentGemma) and cross-attention (SeamlessM4T's
# decoder over the encoder's memory, Lq != Lk)
# ----------------------------------------------------------------------------


def _seq(rng, B, L, n, hd):
    return rng.normal(size=(B, L, n, hd)).astype(np.float32)


@pytest.mark.parametrize("causal,window,Lq,Lk,blk", [
    (True, 8, 40, 40, 8),      # the window binds, blocks tile L
    (True, 8, 40, 40, 40),
    (True, 64, 48, 48, 16),    # window >= L: causal
    (True, 5, 33, 33, 33),     # ragged L, window not a tile's multiple
    (False, 0, 16, 48, 16),    # cross: more keys than queries
    (False, 0, 37, 24, 24),    # cross: fewer keys, ragged queries
    (False, 0, 5, 96, 32)])
def test_sdpa_chunked_window_and_cross_match_reference(causal, window, Lq,
                                                       Lk, blk):
    """The plain version under a local window and with Lq != Lk (G = 5,
    not a power of two) against the reference's `_sdpa_chunked` (blocks
    that tile Lk, its precondition) and its dense `_sdpa` under the same
    mask (the reference's local prefill and cross branch)."""
    B, H, KV, hd = 2, 10, 2, 16
    rng = np.random.default_rng(Lq + Lk + window)
    q, k, v = _seq(rng, B, Lq, H, hd), _seq(rng, B, Lk, KV, hd), \
        _seq(rng, B, Lk, KV, hd)
    rcfg = ref_smoke("llama3_2_1b")
    got = ops.sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal, window, blk=blk)
    assert got.shape == (B, Lq, H, hd)
    twin = JA._sdpa_chunked(rcfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal, window, blk=blk)
    iq, ik = np.arange(Lq)[:, None], np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= iq >= ik
    if window:
        mask &= iq - ik < window
    dense = JA._sdpa(rcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask)[None, None])
    assert _err(got, twin) < TOL
    assert _err(got, dense) < TOL


def test_wrapper_takes_a_window_and_cross_lengths_on_the_cpu():
    """The wrapper's CPU path under a window and with Lq != Lk is the plain
    version; a causal call with Lq != Lk, a window without causal and a
    negative window raise on either device; grads flow through the plain
    VJP with the forward's window and k/v length. `mode` names the
    launch's `LAUNCHES_BY_MODE` key."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 7, 1, 50, 16))
    kc, vc = (torch.from_numpy(rng.normal(size=(1, 1, 80, 16))
                               .astype(np.float32)) for _ in range(2))
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, True, window=9)
    assert torch.equal(got, ops.flash_attention(q, k, v, True, window=9,
                                                use_kernel=False))
    want = ops.sdpa_chunked(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, 9).transpose(1, 2)
    assert torch.equal(got, want)
    cross = ops.flash_attention(q, kc, vc, False)
    assert cross.shape == (1, 7, 50, 16)
    assert torch.equal(cross, ops.sdpa_chunked(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        False).transpose(1, 2))
    assert ops.LAUNCHES == before
    assert set(ops.LAUNCHES_BY_MODE) == {"causal", "full", "window", "cross"}
    assert [ops.mode(q, k, True, 9), ops.mode(q, k, True, 0),
            ops.mode(q, kc, False, 0), ops.mode(q, k, False, 0)] == [
        "window", "causal", "cross", "full"]
    for bad in (dict(k=kc, v=vc, causal=True), dict(k=k, v=v, causal=False,
                                                    window=4),
                dict(k=k, v=v, causal=True, window=-1)):
        with pytest.raises(ValueError):
            ops.flash_attention(q, **bad)
    u = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    for kk, vv, causal, window in ((k, v, True, 9), (kc, vc, False, 0)):
        grads = []
        for use_kernel in (True, False):
            ins = [t.clone().requires_grad_(True) for t in (q, kk, vv)]
            (ops.flash_attention(*ins, causal=causal, use_kernel=use_kernel,
                                 window=window) * u).sum().backward()
            grads.append([t.grad for t in ins])
        for g_kernel, g_plain in zip(*grads):
            assert float(g_plain.abs().max()) > 0
            assert torch.equal(g_kernel, g_plain)


def _kernel_loop_emulation(q, k, v, causal, window):
    """The fp32 kernel's loop (flash_attention.cu, `key_tiles` and
    `masked`) in PyTorch: each 64-row q tile visits key tiles [kt0, nk),
    kt0 the tile of key q0 - W + 1 under a window, nk past the diagonal
    when causal; masked logits are -inf, the running max starts at
    -1e30."""
    B, H, Lq, hd = q.shape
    Lk, G = k.shape[2], H // k.shape[1]
    kf, vf = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    out = torch.zeros((B, H, Lq, v.shape[-1]))
    nk_all = -(-Lk // 64)
    for qt in range(-(-Lq // 64)):
        q0 = qt * 64
        rows = q0 + torch.arange(64)
        nk = min(qt + 1, nk_all) if causal else nk_all
        kt0 = max(0, q0 - window + 1) // 64 if causal and window else 0
        qs = torch.nn.functional.pad(q[:, :, q0:q0 + 64],
                                     (0, 0, 0, 64 - len(q[0, 0, q0:q0 + 64])))
        qs = qs / np.float32(np.sqrt(hd))
        m = torch.full((B, H, 64), -1e30)
        l = torch.zeros((B, H, 64))
        acc = torch.zeros((B, H, 64, v.shape[-1]))
        for kt in range(kt0, nk):
            keys = kt * 64 + torch.arange(64)
            kk = torch.nn.functional.pad(kf[:, :, kt * 64:kt * 64 + 64],
                                         (0, 0, 0, 64 - len(keys[keys < Lk])))
            vv = torch.nn.functional.pad(vf[:, :, kt * 64:kt * 64 + 64],
                                         (0, 0, 0, 64 - len(keys[keys < Lk])))
            s = qs @ kk.transpose(-1, -2)
            bad = keys[None, :] >= Lk
            if causal:
                bad = bad | (keys[None, :] > rows[:, None])
            if window:
                bad = bad | (rows[:, None] - keys[None, :] >= window)
            s = torch.where(bad, -torch.inf, s)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vv
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        n = min(64, Lq - q0)
        out[:, :, q0:q0 + n] = (acc / l[..., None])[:, :, :n]
    return out


@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal,window", [
    (1, 10, 1, 300, 300, True, 128),   # RecurrentGemma's MQA G = 10
    (1, 10, 1, 300, 300, True, 70),    # a window off the 64-key tiles
    (1, 2, 1, 130, 130, True, 64),
    (1, 7, 1, 100, 100, True, 200),    # window >= L; LLaVA's G = 7
    (1, 7, 1, 200, 200, True, 0),
    (1, 4, 4, 37, 301, False, 0),      # cross, ragged both ways
    (1, 4, 4, 128, 64, False, 0)])
def test_kernel_tile_band_matches_plain(B, H, KV, Lq, Lk, causal, window):
    """The kernel's choice of key tiles and its -inf masking, emulated in
    float32: a window's edge tiles hold rows whose keys are all masked
    (they add nothing, where the plain version adds what the next visible
    key's correction wipes out), and the loop's start skips whole tiles;
    within 2e-5 of the plain version."""
    rng = np.random.default_rng(Lq + Lk + window)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, KV, Lk, 16))
                             .astype(np.float32)) for _ in range(2))
    got = _kernel_loop_emulation(q, k, v, causal, window)
    want = ops.flash_attention(q, k, v, causal, use_kernel=False,
                               window=window)
    assert _err(got, want) < TOL
