"""Port of the fused topological linear attention: the plain sweep and the
kernel wrapper's CPU path against the reference's XLA twin and its Pallas
kernel (interpret mode), `topo_linear_attention` and the model-level
`topo_attention_train` across the parity matrix of
test_topo_attention.py (causal/bidirectional x degree 1-3 x synced/per-head
x odd L x GQA) against the reference's fused path and the dense oracle,
the mask helpers against `repro.core.masks`, and the wrapper's refusals.
The kernel itself is held against the plain sweep on a card by
test_torch_cuda.py."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.core import masks as JMK  # noqa: E402
from repro.kernels.topo_linear_attention import ops as JOPS  # noqa: E402
from repro.kernels.topo_linear_attention.kernel import (  # noqa: E402
    topo_attention_sweep_pallas)
from repro.kernels.topo_linear_attention.ref import (  # noqa: E402
    topo_linear_attention_ref as j_ref)
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.core import masks as TMK  # noqa: E402
from repro_torch.kernels.topo_linear_attention import kernel  # noqa: E402
from repro_torch.kernels.topo_linear_attention import ops  # noqa: E402
from repro_torch.kernels.topo_linear_attention.ref import (  # noqa: E402
    topo_linear_attention_ref as t_ref)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


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


def _coeffs(rng, shape):
    cs = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    cs[..., 0] = rng.uniform(1.5, 2.5, shape[:-1])  # keep f (and den) > 0
    return cs


# ----------------------------------------------------------------------------
# (i) one sweep: the plain version against _sweep_xla and the Pallas kernel
# ----------------------------------------------------------------------------


def _mode_inputs(rng, mode, H, L, C, R=16):
    """The mask pieces of one sweep, from the reference's _prepare on a
    degree-1 (decay) or degree-2 (rank) exp mask."""
    cs = _coeffs(rng, (H, 2 if mode == "decay" else 3))
    spec = JOPS.TopoSpec("exp", 1.0 / L, True, C, R, 1e-6, True)
    lg, alpha, beta, dmat, _ = JOPS._prepare(spec, jnp.asarray(cs), L)
    return {k: (None if v is None else np.asarray(v)) for k, v in
            dict(lg=lg, alpha=alpha, beta=beta, dmat=dmat).items()}


@pytest.mark.parametrize("mode", ["decay", "rank"])
@pytest.mark.parametrize("variant", ["normalize", "unnormalized",
                                     "residual"])
@pytest.mark.parametrize("B,H,L,m,hd,C", [(1, 2, 48, 4, 8, 16),
                                          (2, 3, 40, 8, 16, 40)])
def test_plain_sweep_matches_reference(mode, variant, B, H, L, m, hd, C):
    rng = np.random.default_rng(L * 7 + hd)
    qf, kf, v = _features(rng, B, H, L, m, hd)
    mk = _mode_inputs(rng, mode, H, L, C)
    res = ((rng.normal(size=(B, H, L, hd)).astype(np.float32),
            rng.uniform(1, 2, (B, H, L)).astype(np.float32))
           if variant == "residual" else (None, None))
    normalize = variant != "unnormalized"
    jkw = dict(log_gamma=mk["lg"], alpha=mk["alpha"], beta=mk["beta"])
    want = topo_attention_sweep_pallas(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(v),
        jnp.asarray(mk["dmat"]), res_num=res[0], res_den=res[1],
        normalize=normalize, chunk=C, interpret=True,
        **{k: None if a is None else jnp.asarray(a) for k, a in jkw.items()})
    twin_num, twin_den = JOPS._sweep_xla(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(v),
        jnp.asarray(mk["dmat"]), *(None if a is None else jnp.asarray(a)
                                   for a in jkw.values()))
    tkw = {k: None if a is None else _t(a).contiguous()
           for k, a in (("log_gamma", mk["lg"]), ("alpha", mk["alpha"]),
                        ("beta", mk["beta"]))}
    before = ops.LAUNCHES
    got = ops.topo_attention_sweep(
        _t(qf), _t(kf), _t(v), _t(mk["dmat"]), normalize=normalize,
        res_num=None if res[0] is None else _t(res[0]),
        res_den=None if res[1] is None else _t(res[1]), **tkw)
    assert ops.LAUNCHES == before  # CPU tensors never count as launches
    num, den = ops._sweep(_t(qf), _t(kf), _t(v), _t(mk["dmat"]),
                          tkw["log_gamma"], tkw["alpha"], tkw["beta"])
    assert _rel(num, twin_num) < 1e-4 and _rel(den, twin_den) < 1e-4
    if normalize:
        assert _rel(got, want) < 1e-4
    else:
        assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4


# ----------------------------------------------------------------------------
# (ii) the whole fused forward across the parity matrix
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("g,degree", [("exp", 1), ("exp", 2), ("exp", 3),
                                      ("identity", 2)])
@pytest.mark.parametrize("perhead", [False, True], ids=["synced", "perhead"])
@pytest.mark.parametrize("L", [33, 71])
def test_topo_linear_attention_matches_reference(causal, g, degree, perhead,
                                                 L):
    rng = np.random.default_rng(L + 10 * degree + perhead)
    H = 2
    qf, kf, v = _features(rng, 1, H, L, 4, 8)
    cs = _coeffs(rng, (H, degree + 1) if perhead else (degree + 1,))
    kw = dict(g=g, dist_scale=1.0 / L, causal=causal, chunk=16)
    jargs = (jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(v),
             jnp.asarray(cs))
    want = JOPS.topo_linear_attention(*jargs, use_kernel=True,
                                      interpret=True, **kw)
    cs_h = np.broadcast_to(np.atleast_2d(cs), (H, degree + 1))
    dense = j_ref(*jargs[:3], jnp.asarray(cs_h), g=g, dist_scale=1.0 / L,
                  causal=causal)
    targs = (_t(qf), _t(kf), _t(v), _t(cs))
    for use_kernel in (False, True):  # plain; the kernel path's CPU sweep
        got = ops.topo_linear_attention(*targs, use_kernel=use_kernel, **kw)
        assert got.shape == (1, H, L, 8) and got.dtype == torch.float32
        assert _rel(got, want) < 1e-4
        assert _rel(got, dense) < 1e-3
    oracle = t_ref(*targs[:3], _t(cs_h), g=g, dist_scale=1.0 / L,
                   causal=causal)
    assert _rel(oracle, dense) < 1e-5


def _cfgs(L, degree, perhead, gqa, impl):
    H, hd = (4, 8) if gqa else (2, 8)
    kw = dict(name="topo-test", family="dense", num_layers=1,
              d_model=H * hd, num_heads=H, num_kv_heads=2 if gqa else H,
              head_dim=hd, d_ff=16, vocab_size=64, attention_variant="topo",
              performer_phi="relu", topo_g="exp", topo_degree=degree,
              topo_synced=not perhead, topo_dist_scale=1.0 / L,
              dtype="float32")
    return JConfig(topo_attn_impl="pallas", **kw), TConfig(
        topo_attn_impl=impl, **kw)


def _torch_attn(tcfg, p, p_topo):
    attn = TA.Attention(tcfg)
    topo = Params(TA.topo_shapes(tcfg))
    with torch.no_grad():
        for name, t in p.items():
            getattr(attn, name).copy_(_t(t))
        for name, t in p_topo.items():
            getattr(topo, name).copy_(_t(t))
    return attn, topo


# every degree both ways; synced/per-head x MHA/GQA covered pairwise
@pytest.mark.parametrize("degree,causal,perhead,gqa", [
    (1, True, False, False), (1, False, True, True), (2, True, True, False),
    (2, False, False, True), (3, True, False, True), (3, False, True, False)])
def test_topo_attention_train_matches_reference(degree, causal, perhead,
                                                gqa):
    """Model-level parity (projections, GQA expansion, phi features, mask
    scalars, the fused forward) at odd L: the port's "torch" and "cuda"
    impls against the reference's "pallas" (1e-4) and against the port's
    dense "ref" impl (1e-3), itself the reference's oracle (1e-5, above)."""
    L = 41
    jcfg, tcfg = _cfgs(L, degree, perhead, gqa, "torch")
    seed = 3 * degree + perhead + 7 * gqa
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
    attn, topo = _torch_attn(tcfg, p, p_topo)
    with torch.no_grad():
        got = {impl: TA.topo_attention_train(
            tcfg.replace(topo_attn_impl=impl), attn, topo, _t(x),
            torch.from_numpy(np.ascontiguousarray(positions)), causal=causal)
            for impl in ("torch", "cuda", "ref")}
    for impl in ("torch", "cuda"):
        assert _rel(got[impl], want) < 1e-4, impl
        assert _rel(got[impl], got["ref"]) < 1e-3, impl


# ----------------------------------------------------------------------------
# (iii) the mask helpers
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("g", ["exp", "identity", "recip"])
@pytest.mark.parametrize("shape", [(3,), (4, 2)])
def test_mask_helpers_match_reference(g, shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    cs = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    jc, tc = jnp.asarray(cs), _t(cs)
    pairs = [
        (JMK.sequence_mask_values(g, jc, 37, 1 / 37),
         TMK.sequence_mask_values(g, tc, 37, 1 / 37)),
        (JMK.sequence_mask_matrix(g, jc, 24, 1 / 50),
         TMK.sequence_mask_matrix(g, tc, 24, 1 / 50)),
        (JMK.sequence_mask_matrix(g, jc, 24, 1 / 50, strict=True),
         TMK.sequence_mask_matrix(g, tc, 24, 1 / 50, strict=True)),
        (JMK._poly_mask_eval(g, jc, jnp.full((3, 5), 0.3)),
         TMK._poly_mask_eval(g, tc, torch.full((3, 5), 0.3))),
        (JMK.chebyshev_separable_expansion(g, jc, 80, 1 / 80, 12)[1],
         TMK.chebyshev_separable_expansion(g, tc, 80, 1 / 80, 12)[1]),
    ]
    ja, jb = JMK.chebyshev_separable_tables(g, jc, 80, 1 / 80, 12)
    ta, tb = TMK.chebyshev_separable_tables(g, tc, 80, 1 / 80, 12)
    pairs += [(ja, ta), (jb, tb)]
    for want, got in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got, want) <= 1e-6
    assert np.array_equal(TMK.chebyshev_nodes(80, 12),
                          JMK.chebyshev_nodes(80, 12))
    assert set(TMK.GS) == set(JMK.GS)


# ----------------------------------------------------------------------------
# the wrapper: what it refuses, and where it launches
# ----------------------------------------------------------------------------


def _ok_sweep_args():
    B, H, L, m, hd, C = 1, 2, 16, 4, 8, 8
    return dict(qf=torch.ones(B, H, L, m), kf=torch.ones(B, H, L, m),
                v=torch.ones(B, H, L, hd), dmat=torch.ones(H, C, C),
                log_gamma=torch.zeros(H))


@pytest.mark.parametrize("bad", [
    "dtype", "noncontig", "no_mode", "both_modes", "ragged_L", "big_chunk",
    "dmat_heads", "res_half", "alpha_shape", "numpy", "meta_device"])
def test_sweep_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = _ok_sweep_args()
    if bad == "dtype":
        a["v"] = a["v"].double()
    elif bad == "noncontig":
        a["qf"] = torch.ones(1, 2, 4, 16).transpose(2, 3)
    elif bad == "no_mode":
        a["log_gamma"] = None
    elif bad == "both_modes":
        a["alpha"] = a["beta"] = torch.ones(2, 16, 3)
    elif bad == "ragged_L":
        a["dmat"] = torch.ones(2, 6, 6)
    elif bad == "big_chunk":
        a = dict(a, qf=torch.ones(1, 2, 256, 4), kf=torch.ones(1, 2, 256, 4),
                 v=torch.ones(1, 2, 256, 8), dmat=torch.ones(2, 256, 256))
    elif bad == "dmat_heads":
        a["dmat"] = torch.ones(3, 8, 8)
    elif bad == "res_half":
        a["res_num"] = torch.ones(1, 2, 16, 8)
    elif bad == "alpha_shape":
        a["log_gamma"] = None
        a["alpha"], a["beta"] = torch.ones(2, 16, 3), torch.ones(2, 16, 4)
    elif bad == "numpy":
        a["kf"] = np.ones((1, 2, 16, 4), np.float32)
    elif bad == "meta_device":  # neither the CPU nor a card: no kernel
        a = {k: t.to("meta") for k, t in a.items()}
    with pytest.raises((TypeError, ValueError)):
        ops.topo_attention_sweep(a.pop("qf"), a.pop("kf"), a.pop("v"),
                                 a.pop("dmat"), **a)


def test_kernel_path_refuses_inputs_that_require_grad():
    """A ctypes launch would cut the autograd graph silently: the raw
    sweep refuses inputs that require grad, naming the fused entry; the
    fused entry's kernel path is the reference's custom VJP (kernel
    forward, the plain sweep's VJP backward), so qf, kf, v and the mask
    coefficients get the plain path's grads, causal and bidirectional, in
    decay and rank mode."""
    rng = np.random.default_rng(0)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 20, 4, 8))
    kw = dict(dist_scale=1.0 / 20)
    with pytest.raises(NotImplementedError, match="topo_linear_attention"):
        ops.topo_attention_sweep(qf.clone().requires_grad_(), kf, v,
                                 torch.tril(torch.ones(2, 20, 20)),
                                 log_gamma=torch.zeros(2))
    u = _t(rng.normal(size=v.shape))
    for cs0 in (_t(_coeffs(rng, (2,))), _t(_coeffs(rng, (2, 3)))):
        for causal in (True, False):
            grads = []
            for use_kernel in (True, False):
                ins = [t.clone().requires_grad_(True)
                       for t in (qf, kf, v, cs0)]
                (ops.topo_linear_attention(*ins, use_kernel=use_kernel,
                                           causal=causal, **kw)
                 * u).sum().backward()
                grads.append([t.grad for t in ins])
            for got, want in zip(*grads):
                assert bool(torch.isfinite(want).all())
                assert torch.equal(got, want)
    with torch.no_grad():  # no graph to cut
        ops.topo_linear_attention(qf, kf, v, cs0, use_kernel=True, **kw)


def test_topo_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = (PKG / "kernels" / "topo_linear_attention"
           / "topo_sweep.cu").read_text()
    assert "topo_attention_sweep_pallas" in src
    assert "src/repro/kernels/topo_linear_attention/kernel.py" in src
    assert "Bound on an H100" in src
    assert 'extern "C" int topo_sweep_launch' in src


# ----------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated on the CPU
# ----------------------------------------------------------------------------


def _tf32(x):
    """x rounded to tf32 as the kernel rounds it (topo_sweep.cu `tf32`): add
    half a unit of the 13 dropped bits, then drop them, on the float32 bits
    (to nearest, ties away from zero)."""
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
    a_hi b_lo, a_hi b_hi (passes=3) or one TF32 pass a_hi b_hi (passes=1)."""
    (ah, al), (bh, bl) = _tc_split(a), _tc_split(b)
    out = (torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float32)
           if acc is None else acc)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        for x, y in terms:
            out = _rz(out.double() + x[..., s].double() @ y[..., s, :].double())
    return out


def _tc_sweep_emulation(qp, kp, vp, dmat, lg=None, alpha=None, beta=None,
                        passes=3, state_in_mma=False):
    """One causal sweep with the tensor-core kernel's arithmetic
    (topo_sweep.cu, topo_sweep_tc_kernel): per chunk P = (q k^T) * dmat
    and num = P v as split products, den = rowsum(P); the read of the state
    from its split copy, sum_r alpha_r (q S_r) and sum_r alpha_r (q z)_r;
    the write dS_r = k^T (beta_r v), dz = k^T beta as split products from
    zero, then S_r <- gC S_r + dS_r and z <- gC z + dz in fp32.
    state_in_mma=True instead accumulates the state in the mma accumulators
    across the whole sequence. Returns (num, den)."""
    B, H, Lp, m = qp.shape
    hd = vp.shape[-1]
    C = dmat.shape[-1]
    i = torch.arange(C, dtype=torch.float32)
    if lg is not None:
        R = 1
        al_c = torch.exp(lg[:, None] * i)[:, :, None]           # (H, C, 1)
        be_c = torch.exp(lg[:, None] * (C - i))[:, :, None]
        gC = torch.exp(lg * C)[None, :, None, None]
    else:
        R = alpha.shape[-1]
        gC = torch.ones((1, H, 1, 1))
    S = torch.zeros((B, H, R, m, hd))
    z = torch.zeros((B, H, m, R))
    nums, dens = [], []
    for c0 in range(0, Lp, C):
        q, k, v = (t[:, :, c0:c0 + C] for t in (qp, kp, vp))
        al = al_c if lg is not None else alpha[:, c0:c0 + C]
        be = be_c if lg is not None else beta[:, c0:c0 + C]
        P = _tc_product(q, k.transpose(-1, -2), passes) * dmat[None]
        den = P.sum(-1)
        num = _tc_product(P, v, passes)
        for r in range(R):
            num = num + al[None, :, :, r, None] * _tc_product(
                q, S[:, :, r], passes)
        den = den + (al[None] * _tc_product(q, z, passes)).sum(-1)
        kt = k.transpose(-1, -2)
        bv = [be[None, :, :, r, None] * v for r in range(R)]
        bz = be[None].expand(B, H, C, R)
        if state_in_mma:
            S = torch.stack([_tc_product(kt, bv[r], passes,
                                         S[:, :, r] * gC) for r in range(R)],
                            dim=2)
            z = _tc_product(kt, bz, passes, z * gC)
        else:
            S = S * gC[:, :, None] + torch.stack(
                [_tc_product(kt, bv[r], passes) for r in range(R)], dim=2)
            z = z * gC + _tc_product(kt, bz, passes)
        nums.append(num)
        dens.append(den)
    return torch.cat(nums, 2), torch.cat(dens, 2)


def _served_mode_inputs(mode, seed):
    """The served layer's m = hd = 64 and C = 128 at L = 512 (4 chunks),
    with the mask pieces of the port's _prepare (degree 1: decay; degree 2:
    rank 16, whose Lagrange tables change sign)."""
    rng = np.random.default_rng(seed)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 512, 64, 64))
    cs = _t(_coeffs(rng, (2, 2 if mode == "decay" else 3)))
    spec = ops.TopoSpec("exp", 1.0 / 512, True, 128, 16, 1e-6)
    lg, alpha, beta, dmat, _ = ops._prepare(spec, cs, 512)
    return qf, kf, v, dmat, lg, alpha, beta


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["decay", "rank16"])
def test_tensor_core_split_keeps_the_gate(mode, seed):
    """The tensor-core kernel's 3xTF32 arithmetic, emulated on the CPU,
    stays within the 1e-4 bound of the plain sweep (num, den and the
    normalized output) at the served layer's widths, in both modes: the
    numerics are settled before the card sees them."""
    qf, kf, v, dmat, lg, alpha, beta = _served_mode_inputs(mode, seed)
    num, den = _tc_sweep_emulation(qf, kf, v, dmat, lg, alpha, beta)
    pnum, pden = ops._sweep(qf, kf, v, dmat, lg, alpha, beta)
    assert _rel(num, pnum) < 1e-4 and _rel(den, pden) < 1e-4
    assert _rel(num / den[..., None], pnum / pden[..., None]) < 1e-4


@pytest.mark.parametrize("mode", ["decay", "rank16"])
def test_one_tf32_pass_would_break_the_gate(mode):
    """Why the kernel splits each operand: one TF32 pass of the same
    products lands above the 1e-4 bound of the plain sweep."""
    qf, kf, v, dmat, lg, alpha, beta = _served_mode_inputs(mode, 0)
    num, den = _tc_sweep_emulation(qf, kf, v, dmat, lg, alpha, beta,
                                   passes=1)
    pnum, pden = ops._sweep(qf, kf, v, dmat, lg, alpha, beta)
    assert _rel(num / den[..., None], pnum / pden[..., None]) > 1e-4


def test_state_accumulated_in_the_tensor_cores_would_drift():
    """Why the kernel adds each chunk's dS to the state in fp32: kept in the
    mma accumulators across the whole sequence, the state takes the
    tensor cores' rounding toward zero of every sum, and num and den drift
    from the plain sweep as L grows."""
    rng = np.random.default_rng(0)
    qf, kf, v = (_t(a) for a in _features(rng, 1, 2, 2048, 64, 64))
    cs = _t(_coeffs(rng, (2, 2)))
    spec = ops.TopoSpec("exp", 1.0 / 2048, True, 128, 16, 1e-6)
    lg, _, _, dmat, _ = ops._prepare(spec, cs, 2048)
    pnum, pden = ops._sweep(qf, kf, v, dmat, lg)
    errs = {}
    for long_lived in (False, True):
        num, den = _tc_sweep_emulation(qf, kf, v, dmat, lg,
                                       state_in_mma=long_lived)
        errs[long_lived] = max(_rel(num, pnum), _rel(den, pden))
    assert errs[False] < 5e-6 < 5 * errs[False] < errs[True]


@pytest.mark.parametrize("C,m,hd,R,decay,want", [
    (128, 64, 64, 1, True, (64, 2)),      # served, decay mode
    (128, 64, 64, 16, False, (16, 1)),    # served, rank16 mode
    (40, 4, 8, 1, True, (16, 2)), (40, 4, 8, 16, False, (16, 2)),
    (32, 64, 64, 16, False, (16, 2)), (16, 16, 24, 1, True, (64, 2)),
    (128, 64, 24, 4, False, (16, 2)), (128, 64, 130, 1, True, (64, 2)),
    (128, 60, 62, 16, False, (16, 1)),
    (20, 4, 8, 1, True, (16, 2)),         # C not a multiple of 8
    (20, 8, 10, 16, False, (16, 2)),      # ... and hd not one of 4
    (16, 6, 8, 16, False, (16, 2)),       # m not a multiple of 4
    (128, 64, 10, 1, True, (16, 2))])
def test_tensor_core_path_takes_every_served_shape(C, m, hd, R, decay,
                                                   want):
    """The served shapes (m = hd = 64, C = 128, decay or R = 16) and those
    of the card tests, the ragged C, m and hd (zero-filled in shared memory)
    among them, take the kernel in a block that fits."""
    td, nbuf, smem = kernel.tc_config(C, m, hd, R, decay)
    assert (td, nbuf) == want
    assert smem == kernel.tc_smem_bytes(td, nbuf, C, m, R)
    assert smem <= kernel.SMEM_LIMIT


def _unaligned(*shape):
    """A float32 tensor of this shape whose data lies 4 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 4)[1:n + 1].view(*shape)


@pytest.mark.parametrize("bad", ["m_above_64", "moments_above_16",
                                 "chunk_above_128", "qf_unaligned",
                                 "v_unaligned", "res_num_unaligned"])
def test_tensor_core_path_refuses_what_it_cannot_take(bad):
    """A shape the kernel does not take, or rows it cannot copy 16 bytes at
    a time, raise ValueError before anything is built or launched (these
    CPU tensors would reach the launch otherwise)."""
    B, H, L, m, hd, C = 1, 2, 16, 8, 8, 8
    a = dict(qf=torch.ones(B, H, L, m), kf=torch.ones(B, H, L, m),
             v=torch.ones(B, H, L, hd), dmat=torch.ones(H, C, C),
             log_gamma=torch.zeros(H), alpha=None, beta=None, res_num=None,
             res_den=None)
    if bad == "m_above_64":
        a["qf"] = a["kf"] = torch.ones(B, H, L, 72)
    elif bad == "moments_above_16":
        a["log_gamma"] = None
        a["alpha"] = a["beta"] = torch.ones(H, L, 17)
    elif bad == "chunk_above_128":
        a["dmat"] = torch.ones(H, 136, 136)
    elif bad == "qf_unaligned":
        a["qf"] = _unaligned(B, H, L, m)
    elif bad == "v_unaligned":
        a["v"] = _unaligned(B, H, L, hd)
    else:
        a["res_num"] = _unaligned(B, H, L, hd)
        a["res_den"] = torch.ones(B, H, L)
    match = "aligned" if bad.endswith("unaligned") else "takes C <= 128"
    with pytest.raises(ValueError, match=match):
        kernel.topo_sweep_cuda(**a, normalize=True, eps=1e-6)
    assert kernel._lib is None  # nothing was built


def test_cpu_sweeps_count_no_launch_on_any_path():
    a = _ok_sweep_args()
    before = ops.LAUNCHES
    ops.topo_attention_sweep(a.pop("qf"), a.pop("kf"), a.pop("v"),
                             a.pop("dmat"), **a)
    assert ops.LAUNCHES == before


def test_topo_kernel_source_describes_the_tensor_core_path():
    src = (PKG / "kernels" / "topo_linear_attention"
           / "topo_sweep.cu").read_text()
    note = src[:src.index("#include")]
    for word in ("3xTF32", "mma.sync", "cp.async", "zero-filled",
                 "0.161 ms", "0.899 ms", "0.261 / 2.215 ms"):
        assert word in note, word
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "topo_sweep_tc_kernel" in src and "simt" not in src.lower()
