"""Port of causal gamma-decayed linear attention (kernel B4): the plain
version (`ops.causal_linear_attention`) and the kernel wrapper's CPU path
against the reference's Pallas kernel (interpret mode), its XLA twin
`models.attention.causal_linear_attention` and its dense oracle, with
log_gamma 0 (the Performer), -0.05 and per head, on num and on den; the
topological "fft" impl at degree <= 1 (which runs through it) against the
reference's "fft" and the port's dense "ref", causal and bidirectional;
the wrapper's refusals; the kernel's tensor-core arithmetic (3xTF32, 2xTF32
with a bf16 v, the state in fp32), emulated on the CPU at the served
length. The kernel itself is held against the plain version on a card by
test_torch_cuda.py."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.kernels.linear_attention.kernel import (  # noqa: E402
    linear_attention_pallas)
from repro.kernels.linear_attention.ref import (  # noqa: E402
    linear_attention_ref as j_ref)
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.kernels.linear_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.linear_attention.ref import (  # noqa: E402
    linear_attention_ref as t_ref)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

TOL = 1e-5  # tests/test_kernels.py::test_linear_attention, relative to max


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _features(rng, B, H, L, m, hd):
    return (np.abs(rng.normal(size=(B, H, L, m))).astype(np.float32),
            np.abs(rng.normal(size=(B, H, L, m))).astype(np.float32),
            rng.normal(size=(B, H, L, hd)).astype(np.float32))


def _log_gamma(rng, kind, H):
    if kind == "perhead":
        return -rng.uniform(0.0, 0.05, H).astype(np.float32)
    return np.full((H,), kind, np.float32)


@pytest.mark.parametrize("lg", [0.0, -0.05, "perhead"])
@pytest.mark.parametrize("L,m,hd,chunk", [(128, 16, 32, 32), (64, 8, 8, 16),
                                          (96, 16, 16, 96), (64, 8, 24, 32)])
def test_plain_version_matches_reference(lg, L, m, hd, chunk):
    B, H = 2, 3
    rng = np.random.default_rng(L + m)
    qf, kf, v = _features(rng, B, H, L, m, hd)
    lgv = _log_gamma(rng, lg, H)
    for use_kernel in (False, True):  # plain; the kernel path's CPU branch
        num, den = ops.linear_attention(_t(qf), _t(kf), _t(v), _t(lgv),
                                        use_kernel=use_kernel)
        assert num.shape == (B, H, L, hd) and den.shape == (B, H, L)
        assert num.dtype == den.dtype == torch.float32
        kn, kd = linear_attention_pallas(*map(jnp.asarray, (qf, kf, v, lgv)),
                                         chunk=chunk, interpret=True)
        tn, td = JA.causal_linear_attention(
            *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (qf, kf, v)),
            jnp.asarray(lgv))
        rn, rd = j_ref(*map(jnp.asarray, (qf, kf, v, lgv)))
        for wn, wd in ((kn, kd), (np.asarray(tn).transpose(0, 2, 1, 3),
                                  np.asarray(td).transpose(0, 2, 1)),
                       (rn, rd)):
            assert _rel(num, wn) < TOL
            assert _rel(den, wd) < TOL
    on, od = t_ref(_t(qf), _t(kf), _t(v), _t(lgv))  # the port's oracle
    assert _rel(on, rn) < TOL and _rel(od, rd) < TOL


@pytest.mark.parametrize("L", [1, 70, 129, 300, 1000])
def test_plain_version_takes_any_length(L):
    """A ragged tail is zero-padded to the chunk: the real rows' sums do
    not change (the reference's twin asserts L % chunk == 0)."""
    B, H, m, hd = 1, 2, 8, 8
    rng = np.random.default_rng(L)
    qf, kf, v = _features(rng, B, H, L, m, hd)
    lgv = _log_gamma(rng, "perhead", H)
    num, den = ops.causal_linear_attention(
        *(_t(a.transpose(0, 2, 1, 3)) for a in (qf, kf, v)), _t(lgv),
        chunk=64)
    rn, rd = j_ref(*map(jnp.asarray, (qf, kf, v, lgv)))
    assert num.shape == (B, L, H, hd) and den.shape == (B, L, H)
    assert _rel(num.permute(0, 2, 1, 3), rn) < TOL
    assert _rel(den.permute(0, 2, 1), rd) < TOL


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    qf, kf, v = (_t(a) for a in _features(rng, 2, 2, 40, 8, 16))
    lg = torch.tensor([0.0, -0.1])
    before = ops.LAUNCHES
    got = ops.linear_attention(qf, kf, v, lg)
    plain = ops.linear_attention(qf, kf, v, lg, use_kernel=False)
    assert ops.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # (B, L, H, .) tensors go in as transposed views
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (qf, kf, v)]
    assert all(torch.equal(a, b) for a, b in zip(
        ops.linear_attention(*views, lg), got))


@pytest.mark.parametrize("bad", [
    "rank", "v_length", "lg_shape", "dtype", "v_dtype", "m_odd",
    "m_above_64", "stride", "numpy", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B, H, L, m, hd = 1, 2, 16, 8, 8
    a = dict(qf=torch.ones(B, H, L, m), kf=torch.ones(B, H, L, m),
             v=torch.ones(B, H, L, hd), log_gamma=torch.zeros(H))
    if bad == "rank":
        a["qf"] = a["kf"] = torch.ones(H, L, m)
    elif bad == "v_length":
        a["v"] = torch.ones(B, H, L - 1, hd)
    elif bad == "lg_shape":
        a["log_gamma"] = torch.zeros(H + 1)
    elif bad == "dtype":
        a["qf"] = a["qf"].double()
    elif bad == "v_dtype":
        a["v"] = a["v"].half()
    elif bad == "m_odd":
        a["qf"] = a["kf"] = torch.ones(B, H, L, 6)
    elif bad == "m_above_64":  # more than the kernel's 8 k-steps of q
        a["qf"] = a["kf"] = torch.ones(B, H, L, 68)
    elif bad == "stride":
        a["kf"] = torch.ones(B, H, m, L).transpose(2, 3)
    elif bad == "numpy":
        a["v"] = np.ones((B, H, L, hd), np.float32)
    else:  # neither the CPU nor a card: no kernel
        a = {k: t.to("meta") for k, t in a.items()}
    with pytest.raises((TypeError, ValueError)):
        ops.linear_attention(**a)


def test_kernel_path_refuses_inputs_that_require_grad():
    """The kernel path no longer refuses inputs that require grad: its
    autograd.Function's backward is the plain version's VJP, so qf, kf, v
    and log_gamma get the plain path's grads through num and den; under
    no_grad it runs as before."""
    rng = np.random.default_rng(0)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 20, 4, 8))
    lg = torch.tensor([-0.05, -0.2])
    wn = _t(rng.normal(size=v.shape))
    wd = _t(rng.normal(size=v.shape[:3]))
    grads = []
    for use_kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (qf, kf, v, lg)]
        num, den = ops.linear_attention(*ins, use_kernel=use_kernel)
        ((num * wn).sum() + (den * wd).sum()).backward()
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
    with torch.no_grad():
        ops.linear_attention(qf, kf, v, lg)


def test_linear_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = kernel.SOURCE.read_text()
    assert "linear_attention_pallas" in src
    assert "src/repro/kernels/linear_attention/kernel.py" in src
    assert "Bound on an H100" in src
    assert 'extern "C" int linear_attention_launch' in src
    # one kernel, on the tensor cores as 3xTF32; no SIMT body of fp32 FMAs
    note = src[:src.index("#include")]
    for word in ("3xTF32", "mma.sync", "cp.async", "0.141 ms", "0.054 ms",
                 "0.132 ms"):
        assert word in note, word
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert src.count("__global__") == 1 and "lin_attn_tc_kernel" in src
    assert not re.search(r"\blin_attn_kernel\b", src)


def test_kernel_constants_match_the_source():
    """kernel.py's CHUNK, TD and MAX_M are the .cu file's, and its block
    (the same for every m) fits in an SM's shared memory."""
    src = kernel.SOURCE.read_text()
    for name, value in (("C", kernel.CHUNK), ("TD", kernel.TD),
                        ("MAX_M", kernel.MAX_M)):
        assert f"constexpr int {name} = {value};" in src, name
    assert kernel.smem_bytes() == 189_200 <= 232_448
    assert "sizeof(float) * SM_FLOATS" in src


# ----------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated on the CPU
# ----------------------------------------------------------------------------


def _tf32(x):
    """x rounded to tf32 as the kernel rounds it (linear_attention.cu
    `tf32`): add half a unit of the 13 dropped bits, then drop them, on the
    float32 bits (to nearest, ties away from zero)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(
        torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _tc_split(x):
    """The kernel's split: hi = tf32(x); lo = x - hi, truncated to tf32 by
    the tensor cores."""
    hi = _tf32(x)
    return hi, _tf32_trunc(x - hi)


def _rz(x):
    """float64 -> float32 rounded toward zero."""
    y = x.to(torch.float32)
    away = y.double().abs() > x.abs()
    return torch.where(away, torch.nextafter(y, torch.zeros_like(y)), y)


def _tc_product(a, b, passes, acc=None):
    """acc + a @ b as the kernel's m16n8k8 steps on the tensor cores: each
    mma adds 8 exact products of tf32 values to its fp32 accumulator and
    rounds the sum toward zero; per 8-deep step the passes a_lo b_hi,
    a_hi b_lo, a_hi b_hi (3), without a_hi b_lo where b is exact in tf32
    (2: a bf16 v), or one TF32 pass a_hi b_hi (1)."""
    (ah, al), (bh, bl) = _tc_split(a), _tc_split(b)
    out = (torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float32)
           if acc is None else acc)
    terms = {3: ((al, bh), (ah, bl), (ah, bh)), 2: ((al, bh), (ah, bh)),
             1: ((ah, bh),)}[passes]
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        for x, y in terms:
            out = _rz(out.double() + x[..., s].double() @ y[..., s, :].double())
    return out


def _fma(a, b, c):
    """a b + c in float32 with one rounding, as the kernel's fmaf."""
    return (a.double() * b.double() + c.double()).float()


def _lin_kernel_emulation(qf, kf, v, lg, passes=3, v_passes=3,
                          state_in_mma=False):
    """Causal linear attention with the tensor-core kernel's arithmetic
    (linear_attention.cu, lin_attn_tc_kernel), chunks of C = 64: per chunk
    P = (q k^T) * gamma^(i-j) and num = P v as split products from zero,
    den = rowsum(P); the read of the state, num += gamma^pos (q S) with S
    split, den += gamma^pos (q . z) in fp32; the write dS = (k
    gamma^(C-pos))^T v as split products from zero, then S <- gamma^C S +
    dS (one fp32 rounding) and z <- gamma^C z + dz in fp32. v_passes: the
    passes of P v and dS (2 where v holds bf16 values). state_in_mma=True
    instead accumulates S in the mma accumulators across the sequence.
    (B, H, L, .) in; returns (num, den)."""
    B, H, L, m = qf.shape
    C = kernel.CHUNK
    etab = torch.exp(lg[:, None] * torch.arange(C + 1, dtype=torch.float32))
    i = torch.arange(C)
    delta = i[:, None] - i[None, :]
    dmat = torch.where(delta >= 0, etab[:, delta.clamp(min=0)], 0.0)
    ea = etab[:, :C][None, :, :, None]          # gamma^pos
    beta = etab[:, C - i][None, :, :, None]     # gamma^(C - pos)
    gC = etab[:, C][None, :, None, None]
    S = torch.zeros((B, H, m, v.shape[-1]))
    z = torch.zeros((B, H, m, 1))
    nums, dens = [], []
    for c0 in range(0, L, C):
        q, k, vc = (t[:, :, c0:c0 + C] for t in (qf, kf, v))
        P = _tc_product(q, k.transpose(-1, -2), passes) * dmat[None]
        num = _fma(ea, _tc_product(q, S, passes), _tc_product(P, vc,
                                                              v_passes))
        den = P.sum(-1) + (ea * (q @ z))[..., 0]
        kb = (k * beta).transpose(-1, -2)
        if state_in_mma:
            S = _tc_product(kb, vc, v_passes, S * gC)
        else:
            S = _fma(gC, S, _tc_product(kb, vc, v_passes))
        z = gC * z + kb.sum(-1, keepdim=True)
        nums.append(num)
        dens.append(den)
    return torch.cat(nums, 2), torch.cat(dens, 2)


def _served_length_inputs(lg_kind, vdtype, seed=0):
    """The served Performer layer's m = hd = 64 at its L = 4096 (64
    chunks), two heads; v rounded to bf16 where the model's v is bf16."""
    rng = np.random.default_rng(seed)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 4096, 64, 64))
    lg = _t(-rng.uniform(1e-4, 0.05, 2) if lg_kind == "perhead"
            else np.zeros(2))
    if vdtype == "bfloat16":
        v = v.to(torch.bfloat16).float()
    return qf, kf, v, lg


def _gate(got, want):
    return max(_rel(got[0], want[0]), _rel(got[1], want[1]))


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lg_kind", ["lg0", "perhead"])
def test_kernel_arithmetic_keeps_the_gate(lg_kind, vdtype):
    """The tensor-core kernel's arithmetic, emulated on the CPU over the
    whole served length, stays within the 1e-5 gate of the plain version on
    num and den: 3xTF32 for the fp32 products, 2xTF32 where v is bf16 (the
    dropped pass multiplies v's lo, which is 0), the state in fp32."""
    qf, kf, v, lg = _served_length_inputs(lg_kind, vdtype)
    got = _lin_kernel_emulation(qf, kf, v, lg,
                                v_passes=2 if vdtype == "bfloat16" else 3)
    plain = ops.linear_attention(qf, kf, v, lg, use_kernel=False)
    assert _gate(got, plain) < TOL


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_one_tf32_pass_would_break_the_gate(vdtype):
    """Why the kernel splits each fp32 operand: one TF32 pass of the same
    products lands above the 1e-5 gate of the plain version."""
    qf, kf, v, lg = _served_length_inputs("lg0", vdtype)
    got = _lin_kernel_emulation(qf, kf, v, lg, passes=1, v_passes=1)
    plain = ops.linear_attention(qf, kf, v, lg, use_kernel=False)
    assert _gate(got, plain) > TOL


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_state_accumulated_in_the_tensor_cores_would_drift(vdtype):
    """Why the kernel adds each chunk's dS to the state in fp32: at lg = 0
    (the Performer's state never decays) a state kept in the mma
    accumulators over the 64 chunks takes the tensor cores' rounding toward
    zero of every sum and drifts past the gate."""
    qf, kf, v, lg = _served_length_inputs("lg0", vdtype)
    passes = 2 if vdtype == "bfloat16" else 3
    plain = ops.linear_attention(qf, kf, v, lg, use_kernel=False)
    errs = [_gate(_lin_kernel_emulation(qf, kf, v, lg, v_passes=passes,
                                        state_in_mma=long_lived), plain)
            for long_lived in (False, True)]
    assert errs[0] < TOL < errs[1]


# ----------------------------------------------------------------------------
# the topological "fft" impl at degree <= 1: the separable decay path
# ----------------------------------------------------------------------------


def _cfgs(L, degree, perhead, gqa, attn_impl):
    H, hd = (4, 8) if gqa else (2, 8)
    kw = dict(name="topo-test", family="dense", num_layers=1,
              d_model=H * hd, num_heads=H, num_kv_heads=2 if gqa else H,
              head_dim=hd, d_ff=16, vocab_size=64, attention_variant="topo",
              performer_phi="relu", topo_g="exp", topo_degree=degree,
              topo_synced=not perhead, topo_dist_scale=1.0 / L,
              topo_attn_impl="fft", dtype="float32")
    return JConfig(**kw), TConfig(attn_impl=attn_impl, **kw)


@pytest.mark.parametrize("degree,causal,perhead,gqa", [
    (1, True, False, False), (1, False, True, True), (1, True, True, True),
    (1, False, False, False), (0, True, False, True), (0, False, True, False)])
@pytest.mark.parametrize("attn_impl", ["naive", "cuda"])
def test_topo_fft_separable_matches_reference(degree, causal, perhead, gqa,
                                              attn_impl):
    """topo_attn_impl "fft" at g = exp, degree <= 1 (e^{a0} folded into kf,
    lg = a1 * dist_scale, bidirectional = forward + reversed - diagonal):
    the port against the reference's "fft" (1e-4) and the port's dense
    "ref" (1e-3), at odd L; attn_impl "cuda" is the kernel path (the plain
    version on the CPU). ROADMAP C1: the reference's "fft" misses its "ref"
    only at degree >= 2 (a float32 FFT; tests/test_torch_masks.py)."""
    L = 45
    jcfg, tcfg = _cfgs(L, degree, perhead, gqa, attn_impl)
    seed = 5 * degree + perhead + 3 * gqa
    p = jax.tree.map(np.asarray, JA.attn_init(jax.random.PRNGKey(seed),
                                              jcfg))
    r = np.random.default_rng(seed)
    lead = (jcfg.num_heads,) if perhead else ()
    p_topo = {"coeffs": r.uniform(-0.5, 0.5, lead + (degree + 1,)).astype(
        np.float32), "logit_scale": r.uniform(-0.3, 0.3, lead).astype(
        np.float32)}
    x = (r.normal(size=(2, L, jcfg.d_model)) * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(L), (2, L))
    want = JA.topo_attention_train(
        jcfg, {k: jnp.asarray(a) for k, a in p.items()},
        {k: jnp.asarray(a) for k, a in p_topo.items()}, jnp.asarray(x),
        positions, causal=causal)
    attn = TA.Attention(tcfg)
    topo = Params(TA.topo_shapes(tcfg))
    with torch.no_grad():
        for name, t in p.items():
            getattr(attn, name).copy_(_t(t))
        for name, t in p_topo.items():
            getattr(topo, name).copy_(_t(t))
        pos = torch.from_numpy(np.ascontiguousarray(positions))
        got = TA.topo_attention_train(tcfg, attn, topo, _t(x), pos,
                                      causal=causal)
        dense = TA.topo_attention_train(tcfg.replace(topo_attn_impl="ref"),
                                        attn, topo, _t(x), pos,
                                        causal=causal)
    assert _rel(got, want) < 1e-4
    assert _rel(got, dense) < 1e-3


def test_topo_fft_off_the_separable_masks_raises_naming_the_roadmap():
    """Off the separable masks "fft" was refused, naming ROADMAP A5; it now
    runs Alg. 1 with the float64 Toeplitz FastMult (held against the
    reference in tests/test_torch_masks.py) and meets the dense "ref"."""
    _, tcfg = _cfgs(16, 2, False, False, "naive")
    attn, topo = TA.Attention(tcfg), Params(TA.topo_shapes(tcfg))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in TA.attn_init(gen, tcfg).items():
            getattr(attn, name).copy_(t)
        topo.coeffs.copy_(torch.tensor([0.2, -0.4, -0.3]))
        topo.logit_scale.zero_()
        x = torch.randn(1, 16, 16, generator=gen)
        pos = torch.zeros(1, 16, dtype=torch.int32)
        got = TA.topo_attention_train(tcfg, attn, topo, x, pos)
        dense = TA.topo_attention_train(tcfg.replace(topo_attn_impl="ref"),
                                        attn, topo, x, pos)
    assert got.shape == (1, 16, 16)
    assert _rel(got, dense) < 1e-3
