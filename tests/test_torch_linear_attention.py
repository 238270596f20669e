"""Port of causal gamma-decayed linear attention (kernel B4): the plain
version (`ops.causal_linear_attention`) and the kernel wrapper's CPU path
against the reference's Pallas kernel (interpret mode), its XLA twin
`models.attention.causal_linear_attention` and its dense oracle, with
log_gamma 0 (the Performer), -0.05 and per head, on num and on den; the
topological "fft" impl at degree <= 1 (which runs through it) against the
reference's "fft" and the port's dense "ref", causal and bidirectional;
the wrapper's refusals. The kernel itself is held against the plain
version on a card by test_torch_cuda.py."""
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
    "rank", "v_length", "lg_shape", "dtype", "v_dtype", "m_odd", "stride",
    "numpy", "meta_device"])
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
    elif bad == "stride":
        a["kf"] = torch.ones(B, H, m, L).transpose(2, 3)
    elif bad == "numpy":
        a["v"] = np.ones((B, H, L, hd), np.float32)
    else:  # neither the CPU nor a card: no kernel
        a = {k: t.to("meta") for k, t in a.items()}
    with pytest.raises((TypeError, ValueError)):
        ops.linear_attention(**a)


def test_kernel_path_refuses_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 20, 4, 8))
    lg = torch.zeros(2)
    qf.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A8"):
        ops.linear_attention(qf, kf, v, lg)
    num, den = ops.linear_attention(qf, kf, v, lg, use_kernel=False)
    (num.sum() + den.sum()).backward()
    assert qf.grad is not None
    with torch.no_grad():
        ops.linear_attention(qf, kf, v, lg)


def test_linear_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = kernel.SOURCE.read_text()
    assert "linear_attention_pallas" in src
    assert "src/repro/kernels/linear_attention/kernel.py" in src
    assert "Bound on an H100" in src
    assert 'extern "C" int linear_attention_launch' in src


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
    version on the CPU). ROADMAP C1: the reference's "fft" is wrong only at
    degree >= 2, which the port refuses."""
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
    _, tcfg = _cfgs(16, 2, False, False, "naive")
    attn, topo = TA.Attention(tcfg), Params(TA.topo_shapes(tcfg))
    with pytest.raises(NotImplementedError, match="A5"):
        TA.topo_attention_train(tcfg, attn, topo, torch.zeros(1, 16, 16),
                                torch.zeros(1, 16, dtype=torch.int32))
