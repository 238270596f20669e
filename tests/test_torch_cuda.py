"""The port on a CUDA card: the fdist_matvec kernel against its plain
version and `apply(backend="cuda")` against the dense oracle; the topo
sweep kernel against its plain sweep in both state modes, the fused
forward against the plain one and the dense oracle, and the smoke topo-LM
served on impl "cuda" against impl "torch"; the flash attention and
linear attention kernels against their plain versions and dense oracles,
and the smoke Llama with full and Performer attention served on
attn_impl "cuda" against "chunked"; the selective scan kernel against its
plain version and the sequential oracle, and the smoke Falcon-Mamba
served on attn_impl "cuda" against "chunked"; the float64 Toeplitz
products and the topo "fft" impl on the card, and the smoke TopoViT on
impl "cuda" against "ref" and the CPU. These tests need a card (the
kernels have no CPU mode) and skip without one; they import nothing of
jax, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ftfi  # noqa: E402
from repro_torch.core import cordial as C  # noqa: E402
from repro_torch.core.integrate import BTFI  # noqa: E402
from repro_torch.graphs.graph import random_tree  # noqa: E402
from repro_torch.kernels.fdist_matvec import ops  # noqa: E402
from repro_torch.kernels.fdist_matvec.ref import (  # noqa: E402
    f_eval, fdist_matvec_batched_ref)

MODES = [
    ("poly", (0.5, -0.2, 0.1)),
    ("exp", (-0.7, 1.3)),
    ("expq", (-0.05, -0.2, 0.1)),
    ("rational", (0.8,)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-9))


def _exact(x, y, v, cs, mode):
    """The plain version's math in float64: the exact product for these
    float32 inputs, up to float64 rounding."""
    s = x.double()[:, :, None] + y.double()[:, None, :]
    return torch.bmm(f_eval(s, cs.double(), mode), v.double())


# the shapes of tests/test_kernels.py (b <= 257), then long rows like the
# root buckets of an n = 10^4 plan, many short jobs, and d above one tile
REF_SHAPES = [(3, 300, 200, 8), (3, 128, 128, 4), (3, 97, 33, 3),
              (3, 64, 257, 16)]
LONG_SHAPES = [(2, 5000, 4000, 4), (40, 33, 2, 64), (1, 700, 900, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,a,b,d", REF_SHAPES + LONG_SHAPES)
@pytest.mark.parametrize("mode,coeffs", MODES)
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(B, a, b, d, mode, coeffs, vdtype,
                                      cuda_device):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0, 3, (B, a)), dtype=torch.float32,
                     device=cuda_device)
    y = torch.tensor(rng.uniform(0, 3, (B, b)), dtype=torch.float32,
                     device=cuda_device)
    v = torch.tensor(rng.normal(size=(B, b, d)), dtype=getattr(torch, vdtype),
                     device=cuda_device)
    cs = torch.tensor(coeffs, dtype=torch.float32, device=cuda_device)
    before = ops.LAUNCHES
    got = ops.fdist_matvec_batched(x, y, v, cs, mode)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.dtype == v.dtype and got.shape == (B, a, d)
    tol = 3e-6 if vdtype == "float32" else 3e-2
    # against the exact product at every shape; against the float32 plain
    # version (whose own rounding grows with b) at the reference's shapes
    assert _rel(got, _exact(x, y, v, cs, mode)) < tol
    if (B, a, b, d) in REF_SHAPES:
        want = fdist_matvec_batched_ref(x, y, v, cs, mode)
        assert _rel(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [
    C.Exponential(-0.5), C.Polynomial((0.5, -0.2, 0.1)),
    C.ExpQuadratic(-0.05, -0.2, 0.1), C.Rational((1.0,), (1.0, 0.0, 0.8))],
    ids=lambda f: type(f).__name__)
def test_apply_cuda_matches_dense_oracle(fn, cuda_device):
    tree = random_tree(1500, seed=4)
    X = np.random.default_rng(1).normal(size=(1500, 4))
    spec, params = ftfi.build(tree, leaf_size=32)
    before = ops.LAUNCHES
    got = ftfi.apply(spec, params, fn, X, backend="cuda")
    assert ops.LAUNCHES == before + len(spec.cross_tgt_d0)
    want = BTFI(tree).integrate(fn, X)
    assert got.device.type == "cuda"
    assert _rel(got, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,a,b,d", [(3, 97, 600, 17), (2, 130, 700, 32),
                                     (1, 200, 900, 64)])
@pytest.mark.parametrize("mode,coeffs", MODES)
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_tile_kernel_matches_plain_version(B, a, b, d, mode, coeffs, vdtype,
                                           cuda_device):
    """The register-blocked td = 64 tile (every d > 16) with its source axis
    split over several blocks: within 3e-6 (fp32 v; 3e-2 bf16) of the plain
    version and of the exact product, the bounds of test_kernels.py."""
    from repro_torch.kernels.fdist_matvec import kernel as fdist_kernel

    cfg = fdist_kernel.launch_config(B, a, b, d, fdist_kernel._num_sms(
        cuda_device))
    assert cfg["td"] == 64 and cfg["splits"] > 1
    rng = np.random.default_rng(a + d)
    x = torch.tensor(rng.uniform(0, 3, (B, a)), dtype=torch.float32,
                     device=cuda_device)
    y = torch.tensor(rng.uniform(0, 3, (B, b)), dtype=torch.float32,
                     device=cuda_device)
    v = torch.tensor(rng.normal(size=(B, b, d)), dtype=getattr(torch, vdtype),
                     device=cuda_device)
    cs = torch.tensor(coeffs, dtype=torch.float32, device=cuda_device)
    before = ops.LAUNCHES_BY_TD[64]
    got = ops.fdist_matvec_batched(x, y, v, cs, mode)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_TD[64] == before + 1
    assert got.dtype == v.dtype and got.shape == (B, a, d)
    tol = 3e-6 if vdtype == "float32" else 3e-2
    assert _rel(got, _exact(x, y, v, cs, mode)) < tol
    assert _rel(got, fdist_matvec_batched_ref(x, y, v, cs, mode)) < tol


@pytest.mark.cuda
def test_backward_through_apply_cuda_raises(cuda_device):
    """The card's grad check of the fdist wrapper's autograd.Function: d/dX
    of `apply(backend="cuda")` (the v-grad M^T u on the kernel, one launch
    per cross bucket, as many as the forward's) equals that of backend
    "torch" (the exact engines), and the forward still meets the dense
    oracle."""
    tree = random_tree(300, seed=4)
    spec, params = ftfi.build(tree, leaf_size=16)
    rng = np.random.default_rng(1)
    X0 = torch.tensor(rng.normal(size=(300, 4)), dtype=torch.float32,
                      device=cuda_device)
    W = torch.tensor(rng.normal(size=(300, 4)), dtype=torch.float32,
                     device=cuda_device)
    fn = C.Exponential(-0.5)
    grads = {}
    for backend in ("cuda", "torch"):
        X = X0.clone().requires_grad_(True)
        before = ops.LAUNCHES
        out = ftfi.apply(spec, params, fn, X, backend=backend)
        forward = ops.LAUNCHES - before
        (out * W).sum().backward()
        torch.cuda.synchronize()
        if backend == "cuda":
            assert forward > 0 and ops.LAUNCHES - before == 2 * forward
            assert _rel(out.detach(), BTFI(tree).integrate(fn, X0)) < 1e-5
        else:
            assert ops.LAUNCHES == before
        grads[backend] = X.grad
    assert _rel(grads["cuda"], grads["torch"]) < 1e-5


# --- the topological linear-attention sweep kernel ---------------------------

from repro_torch.kernels.topo_linear_attention import ops as topo_ops  # noqa: E402
from repro_torch.kernels.topo_linear_attention.ref import (  # noqa: E402
    topo_linear_attention_ref)


def _sweep_inputs(rng, B, H, L, m, hd, C, R, device):
    """|normal| features, normal values, and the mask pieces of
    topo_ops._prepare for a degree-1 (decay, R = 0) or degree-2 (rank R)
    exp mask drawn as tests/test_topo_attention.py draws them."""
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    qf = t(np.abs(rng.normal(size=(B, H, L, m))))
    kf = t(np.abs(rng.normal(size=(B, H, L, m))))
    v = t(rng.normal(size=(B, H, L, hd)))
    cs = rng.uniform(-0.5, 0.5, (H, 2 if R == 0 else 3))
    cs[:, 0] = rng.uniform(1.5, 2.5, H)
    spec = topo_ops.TopoSpec("exp", 1.0 / L, True, C, R or 16, 1e-6)
    lg, alpha, beta, dmat, _ = topo_ops._prepare(spec, t(cs), L)
    mode = (dict(log_gamma=lg) if R == 0 else
            dict(alpha=alpha.contiguous(), beta=beta.contiguous()))
    return qf, kf, v, dmat.contiguous(), mode


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 16], ids=["decay", "rank16"])
@pytest.mark.parametrize("B,H,L,m,hd,C", [
    (1, 2, 40, 4, 8, 40), (2, 2, 200, 4, 8, 40), (1, 3, 96, 64, 64, 32),
    (2, 2, 256, 64, 64, 128), (1, 2, 64, 16, 24, 16)])
@pytest.mark.parametrize("variant", ["normalize", "unnormalized",
                                     "residual"])
def test_topo_sweep_kernel_matches_plain_version(B, H, L, m, hd, C, R,
                                                 variant, cuda_device):
    rng = np.random.default_rng(B * 1000 + L)
    qf, kf, v, dmat, mode = _sweep_inputs(rng, B, H, L, m, hd, C, R,
                                          cuda_device)
    kw = dict(mode, normalize=variant != "unnormalized")
    if variant == "residual":
        kw["res_num"] = torch.tensor(rng.normal(size=(B, H, L, hd)),
                                     dtype=torch.float32, device=cuda_device)
        kw["res_den"] = torch.tensor(rng.uniform(1, 2, (B, H, L)),
                                     dtype=torch.float32, device=cuda_device)
    before = topo_ops.LAUNCHES
    got = topo_ops.topo_attention_sweep(qf, kf, v, dmat, **kw)
    torch.cuda.synchronize()
    assert topo_ops.LAUNCHES == before + 1
    num, den = topo_ops._sweep(qf, kf, v, dmat, mode.get("log_gamma"),
                               mode.get("alpha"), mode.get("beta"))
    want = topo_ops._emit(num, den, kw.get("res_num"), kw.get("res_den"),
                          kw["normalize"], 1e-6)
    if variant == "unnormalized":
        assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
    else:
        assert got.shape == (B, H, L, hd) and _rel(got, want) < 1e-4


def _sweep_once(B, H, L, m, hd, C, R, variant, device):
    """One sweep launch at this shape and variant (counted once by the
    wrapper), within 1e-4 of the plain sweep."""
    rng = np.random.default_rng(B * 1000 + L + m)
    qf, kf, v, dmat, mode = _sweep_inputs(rng, B, H, L, m, hd, C, R, device)
    kw = dict(mode, normalize=variant != "unnormalized")
    if variant == "residual":
        kw["res_num"] = torch.tensor(rng.normal(size=(B, H, L, hd)),
                                     dtype=torch.float32, device=device)
        kw["res_den"] = torch.tensor(rng.uniform(1, 2, (B, H, L)),
                                     dtype=torch.float32, device=device)
    before = topo_ops.LAUNCHES
    got = topo_ops.topo_attention_sweep(qf, kf, v, dmat, **kw)
    torch.cuda.synchronize()
    assert topo_ops.LAUNCHES == before + 1
    num, den = topo_ops._sweep(qf, kf, v, dmat, mode.get("log_gamma"),
                               mode.get("alpha"), mode.get("beta"))
    want = topo_ops._emit(num, den, kw.get("res_num"), kw.get("res_den"),
                          kw["normalize"], 1e-6)
    if variant == "unnormalized":
        assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
    else:
        assert got.shape == (B, H, L, hd) and _rel(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 16], ids=["decay", "rank16"])
@pytest.mark.parametrize("variant", ["normalize", "unnormalized",
                                     "residual"])
def test_topo_sweep_served_layer_shape_takes_the_tensor_cores(R, variant,
                                                             cuda_device):
    """The served layer's widths (m = hd = 64, C = 128) at a reduced length
    (B = 1, H = 2, L = 512) on the tensor-core kernel."""
    _sweep_once(1, 2, 512, 64, 64, 128, R, variant, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 16], ids=["decay", "rank16"])
@pytest.mark.parametrize("B,H,L,m,hd,C", [(1, 2, 60, 8, 10, 20),
                                          (2, 2, 64, 6, 8, 16)])
def test_topo_sweep_zero_fills_ragged_shapes(B, H, L, m, hd, C, R,
                                             cuda_device):
    """A C not a multiple of 8 and an m or hd not a multiple of 4: the
    kernel zero-fills the staged rows and columns past them."""
    _sweep_once(B, H, L, m, hd, C, R, "residual", cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["m_above_64", "qf_unaligned"])
def test_topo_sweep_refuses_what_the_kernel_cannot_take(bad, cuda_device):
    """An m above 64, or q rows that are not 16-byte aligned, raise
    ValueError on the card; nothing runs the plain sweep in their place."""
    rng = np.random.default_rng(5)
    m = 72 if bad == "m_above_64" else 8
    qf, kf, v, dmat, mode = _sweep_inputs(rng, 1, 2, 64, m, 8, 16, 0,
                                          cuda_device)
    if bad == "qf_unaligned":
        qf = torch.zeros(qf.numel() + 4, device=cuda_device)[1:qf.numel() + 1]
        qf = qf.view(1, 2, 64, m)
    before = topo_ops.LAUNCHES
    with pytest.raises(ValueError):
        topo_ops.topo_attention_sweep(qf, kf, v, dmat, **mode)
    assert topo_ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,degree", [("exp", 1), ("exp", 2),
                                      ("identity", 2), ("exp", 3)])
@pytest.mark.parametrize("L", [33, 200])
def test_topo_linear_attention_kernel_path(causal, g, degree, L,
                                           cuda_device):
    """The whole fused forward on the card (one launch causal, two
    bidirectional) against the plain sweep (1e-4) and the dense oracle
    (1e-3), the bounds of tests/test_topo_attention.py."""
    rng = np.random.default_rng(L + degree)
    H, m, hd = 2, 8, 8
    qf, kf = (torch.tensor(np.abs(rng.normal(size=(1, H, L, m))),
                           dtype=torch.float32, device=cuda_device)
              for _ in range(2))
    v = torch.tensor(rng.normal(size=(1, H, L, hd)), dtype=torch.float32,
                     device=cuda_device)
    cs = rng.uniform(-0.5, 0.5, (H, degree + 1))
    cs[:, 0] = rng.uniform(1.5, 2.5, H)
    cs = torch.tensor(cs, dtype=torch.float32, device=cuda_device)
    kw = dict(g=g, dist_scale=1.0 / L, causal=causal)
    before = topo_ops.LAUNCHES
    got = topo_ops.topo_linear_attention(qf, kf, v, cs, **kw)
    assert topo_ops.LAUNCHES == before + (1 if causal else 2)
    plain = topo_ops.topo_linear_attention(qf, kf, v, cs, use_kernel=False,
                                           **kw)
    ref = topo_linear_attention_ref(qf, kf, v, cs, **kw)
    assert _rel(got, plain) < 1e-4
    assert _rel(got, ref) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 2], ids=["decay", "rank16"])
def test_topo_lm_serving_kernel_matches_plain(degree, cuda_device):
    """The smoke topo Llama served on the card: impl "cuda" (one kernel
    launch per layer per prefill) against impl "torch" on the same weights,
    float32, over mixed prompt lengths and 4 decode steps."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api

    S = 80
    cfg = get_smoke_config("llama3_2_1b", attention_variant="topo",
                           topo_attn_impl="cuda", topo_degree=degree,
                           topo_dist_scale=1.0 / S, dtype="float32")
    model = api.init_params(cfg, 3)
    rng = np.random.default_rng(degree)
    toks = rng.integers(0, cfg.vocab_size, (3, 70)).astype(np.int32)
    lengths = np.array([70, 41, 0], np.int32)
    out = {}
    for impl in ("cuda", "torch"):
        c = cfg.replace(topo_attn_impl=impl)
        before = topo_ops.LAUNCHES
        logits, cache = api.prefill_into_cache(c, model, api.init_cache(
            c, 3, S), toks, lengths, S)
        launched = topo_ops.LAUNCHES - before
        pos = torch.tensor(lengths, device=cuda_device).long()
        # both impls decode the greedy tokens of the "cuda" run
        fed = out["cuda"][4] if impl == "torch" else [logits.argmax(-1)]
        steps = []
        for t in range(4):
            lg, cache = api.decode_fn(c, model, cache, fed[t][:, None], pos,
                                      S)
            steps.append(lg)
            if impl == "cuda":
                fed.append(lg[:, 0].argmax(-1))
            pos = pos + 1
        out[impl] = (logits, steps, cache, launched, fed)
    assert out["cuda"][3] == cfg.num_layers and out["torch"][3] == 0
    assert _rel(out["cuda"][0][:2], out["torch"][0][:2]) < 1e-4
    for a, b in zip(out["cuda"][1], out["torch"][1]):
        assert _rel(a, b) < 1e-4
    for k in ("S", "z"):
        assert _rel(out["cuda"][2]["blocks0"][k],
                    out["torch"][2]["blocks0"][k]) < 1e-5


# --- flash attention (B5) and causal linear attention (B4) -------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.linear_attention import ops as linear_ops  # noqa: E402
from repro_torch.kernels.linear_attention.ref import (  # noqa: E402
    linear_attention_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,L,hd", [
    (2, 2, 2, 128, 32), (1, 4, 1, 1000, 64), (2, 4, 2, 200, 16),
    (1, 2, 2, 333, 128), (1, 8, 2, 64, 64), (1, 2, 1, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernel_matches_plain_version(B, H, KV, L, hd, dtype, causal,
                                            cuda_device):
    """Against the plain version on the same inputs: 2e-5 absolute in
    float32 (tests/test_kernels.py); in bfloat16 each value within one bf16
    rounding (2^-7 of its magnitude) on top of that; against the dense
    oracle as well."""
    rng = np.random.default_rng(L + hd)
    dt = getattr(torch, dtype)
    q = torch.tensor(rng.normal(size=(B, H, L, hd)), dtype=dt,
                     device=cuda_device)
    k, v = (torch.tensor(rng.normal(size=(B, KV, L, hd)), dtype=dt,
                         device=cuda_device) for _ in range(2))
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    assert got.dtype == dt and got.shape == (B, H, L, hd)
    plain = flash_ops.flash_attention(q, k, v, causal, use_kernel=False)
    G = H // KV
    ref = attention_ref(q, k.repeat_interleave(G, 1),
                        v.repeat_interleave(G, 1), causal)
    ulp = 0.0 if dtype == "float32" else 2.0 ** -7
    for want in (plain, ref):
        g, w = got.float(), want.float()
        room = ulp * torch.maximum(g.abs(), w.abs()) + 2e-5
        assert bool(((g - w).abs() <= room).all())


def _bf16_roundings(got, want):
    """chip_smoke.py's bf16 gate: at most 1 when got and want are one bf16
    rounding (2^-7 of the larger magnitude) plus 2e-5 apart."""
    g, w = got.float(), want.float()
    return float(((g - w).abs()
                  / (2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 2e-5))
                 .max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,L,hd,peak", [
    (1, 4, 1, 1000, 64, 4.0), (1, 2, 2, 333, 128, 4.0),
    (1, 2, 1, 4096, 64, 1.0), (1, 2, 1, 4096, 64, 4.0)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_bf16_kernel_long_and_peaked(B, H, KV, L, hd, peak, causal,
                                           cuda_device):
    """The tensor-core path at L = 4096 and with peaked logits (q x 4): each
    value within one bf16 rounding + 2e-5 of the plain version, the gate
    of chip_smoke.py unchanged."""
    rng = np.random.default_rng(L + hd)
    q = torch.tensor(rng.normal(size=(B, H, L, hd)) * peak,
                     dtype=torch.bfloat16, device=cuda_device)
    k, v = (torch.tensor(rng.normal(size=(B, KV, L, hd)),
                         dtype=torch.bfloat16, device=cuda_device)
            for _ in range(2))
    got = flash_ops.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    plain = flash_ops.flash_attention(q, k, v, causal, use_kernel=False)
    assert bool(torch.isfinite(got.float()).all())
    assert _bf16_roundings(got, plain) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["row_stride", "base"])
def test_flash_bf16_kernel_refuses_unaligned_rows(bad, cuda_device):
    """The bf16 kernel copies rows in 16-byte pieces: a view whose rows do
    not start on 16 bytes is refused, not copied; float32 takes it."""
    if bad == "row_stride":  # rows 68 elements apart
        q = torch.zeros(1, 2, 32, 68, dtype=torch.bfloat16,
                        device=cuda_device)[..., :64]
    else:  # a base 2 bytes past an aligned one
        q = torch.zeros(2 * 32 * 64 + 1, dtype=torch.bfloat16,
                        device=cuda_device)[1:].view(1, 2, 32, 64)
    k = v = torch.zeros(1, 1, 32, 64, dtype=torch.bfloat16,
                        device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.flash_attention(q, k, v)
    out = flash_ops.flash_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert bool((out == 0).all())


@pytest.mark.cuda
def test_flash_kernel_reads_the_model_layout_in_place(cuda_device):
    """(B, L, H, hd) tensors passed as transposed views give the same
    result as contiguous (B, H, L, hd) ones, written in q's layout."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.normal(size=(2, 96, n, 32)),
                            dtype=torch.bfloat16, device=cuda_device)
               for n in (4, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = flash_ops.flash_attention(*views)
    want = flash_ops.flash_attention(*(t.contiguous() for t in views))
    assert got.stride() == views[0].stride() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,m,hd", [
    (2, 3, 128, 16, 32), (1, 2, 1000, 64, 64), (2, 2, 200, 8, 8),
    (1, 2, 77, 64, 24), (1, 1, 1, 16, 16), (1, 2, 150, 32, 80),
    (2, 2, 64, 64, 160), (1, 2, 4096, 64, 64), (2, 3, 300, 12, 40)])
@pytest.mark.parametrize("lg", [0.0, -0.05, "perhead"])
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_linear_kernel_matches_plain_version(B, H, L, m, hd, lg, vdtype,
                                             cuda_device):
    """num and den each within 1e-5 relative to max of the plain version
    and of the dense oracle (tests/test_kernels.py); hd = 80 and 160 take
    two and three hd tiles, the last one ragged; L = 4096 is the served
    length (64 chunks of state); m = 12 is a multiple of 4 but not of 8
    (its last k-step zero-filled)."""
    rng = np.random.default_rng(L + m)
    qf, kf = (torch.tensor(np.abs(rng.normal(size=(B, H, L, m))),
                           dtype=torch.float32, device=cuda_device)
              for _ in range(2))
    v = torch.tensor(rng.normal(size=(B, H, L, hd)),
                     dtype=getattr(torch, vdtype), device=cuda_device)
    lgv = (torch.tensor(-rng.uniform(0, 0.05, H), dtype=torch.float32)
           if lg == "perhead" else torch.full((H,), lg)).to(cuda_device)
    before = linear_ops.LAUNCHES
    num, den = linear_ops.linear_attention(qf, kf, v, lgv)
    torch.cuda.synchronize()
    assert linear_ops.LAUNCHES == before + 1
    assert num.shape == (B, H, L, hd) and den.shape == (B, H, L)
    for wn, wd in (linear_ops.linear_attention(qf, kf, v, lgv,
                                               use_kernel=False),
                   linear_attention_ref(qf, kf, v, lgv)):
        assert _rel(num, wn) < 1e-5 and _rel(den, wd) < 1e-5


@pytest.mark.cuda
def test_linear_kernel_refuses_an_m_that_does_not_fit(cuda_device):
    """The kernel takes m <= 64 (8 k-steps of q, 4 m-tiles of the state):
    m = 512 is refused with a ValueError before anything launches; the
    next launch is not affected."""
    v = torch.ones(1, 2, 8, 64, device=cuda_device)
    lg = torch.zeros(2, device=cuda_device)
    big = torch.ones(1, 2, 8, 512, device=cuda_device)
    before = linear_ops.LAUNCHES
    with pytest.raises(ValueError, match="m <= 64"):
        linear_ops.linear_attention(big, big, v, lg)
    assert linear_ops.LAUNCHES == before
    small = torch.ones(1, 2, 8, 64, device=cuda_device)
    num, den = linear_ops.linear_attention(small, small, v, lg)
    torch.cuda.synchronize()
    assert torch.equal(den[0, 0], 64.0 * torch.arange(1, 9, device=cuda_device,
                                                      dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_linear_kernel_reads_strided_and_unaligned_rows(vdtype, cuda_device):
    """The model's (B, L, H, .) tensors as transposed views (staged 16 bytes
    at a time) and rows that are not 16-byte aligned (staged by plain
    loads: q and k 4 bytes past a boundary, hd = 20) give the contiguous
    result bit for bit (the staging does not change the arithmetic),
    written in v's layout."""
    rng = np.random.default_rng(5)
    B, L, H, m = 2, 200, 3, 16
    lg = torch.tensor(-rng.uniform(0, 0.05, H), dtype=torch.float32,
                      device=cuda_device)
    for hd, shift in ((64, 0), (20, 1)):
        qf, kf = (torch.tensor(np.abs(rng.normal(size=(B * L * H * m + 1))),
                               dtype=torch.float32, device=cuda_device)
                  [shift:shift + B * L * H * m].view(B, L, H, m)
                  .transpose(1, 2) for _ in range(2))
        v = torch.tensor(rng.normal(size=(B, L, H, hd)),
                         dtype=getattr(torch, vdtype),
                         device=cuda_device).transpose(1, 2)
        num, den = linear_ops.linear_attention(qf, kf, v, lg)
        want = linear_ops.linear_attention(
            *(t.contiguous() for t in (qf, kf, v)), lg)
        torch.cuda.synchronize()
        assert num.stride() == v.stride()
        assert torch.equal(num, want[0]) and torch.equal(den, want[1])
        pnum, pden = linear_ops.linear_attention(qf, kf, v, lg,
                                                 use_kernel=False)
        assert _rel(num, pnum) < 1e-5 and _rel(den, pden) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "performer"])
def test_dense_lm_serving_kernel_matches_plain(variant, cuda_device):
    """The smoke Llama served on the card: attn_impl "cuda" (one kernel
    launch per layer per prefill, none in decode) against "chunked" on the
    same weights, float32, over mixed prompt lengths and 4 decode steps."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api

    ops_ = flash_ops if variant == "full" else linear_ops
    S = 80
    cfg = get_smoke_config("llama3_2_1b", attention_variant=variant,
                           attn_impl="cuda", dtype="float32")
    model = api.init_params(cfg, 3)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 70)).astype(np.int32)
    lengths = np.array([70, 41, 0], np.int32)
    out = {}
    for impl in ("cuda", "chunked"):
        c = cfg.replace(attn_impl=impl)
        before = ops_.LAUNCHES
        logits, cache = api.prefill_into_cache(c, model, api.init_cache(
            c, 3, S), toks, lengths, S)
        launched = ops_.LAUNCHES - before
        pos = torch.tensor(lengths, device=cuda_device).long()
        fed = out["cuda"][4] if impl == "chunked" else [logits.argmax(-1)]
        steps = []
        before = ops_.LAUNCHES
        for t in range(4):
            lg, cache = api.decode_fn(c, model, cache, fed[t][:, None], pos,
                                      S)
            steps.append(lg)
            if impl == "cuda":
                fed.append(lg[:, 0].argmax(-1))
            pos = pos + 1
        assert ops_.LAUNCHES == before  # decode runs no kernel
        out[impl] = (logits, steps, cache, launched, fed)
    assert out["cuda"][3] == cfg.num_layers and out["chunked"][3] == 0
    assert _rel(out["cuda"][0][:2], out["chunked"][0][:2]) < 1e-4
    for a, b in zip(out["cuda"][1], out["chunked"][1]):
        assert _rel(a, b) < 1e-4
    for k in out["cuda"][2]["blocks0"]:
        assert _rel(out["cuda"][2]["blocks0"][k],
                    out["chunked"][2]["blocks0"][k]) < 1e-5


# --- the selective scan (B6) --------------------------------------------------

from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref)


def _scan_inputs(rng, Bt, L, din, N, dtype, device):
    """Drawn as tests/test_kernels.py::test_selective_scan draws them; u,
    dt, B and C in `dtype`."""
    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=dt, device=device)

    dt_ = getattr(torch, dtype)
    return (t(rng.normal(size=(Bt, L, din)), dt_),
            t(np.abs(rng.normal(size=(Bt, L, din))) * 0.1, dt_),
            t(-np.abs(rng.normal(size=(din, N))) - 0.1),
            t(rng.normal(size=(Bt, L, N)), dt_),
            t(rng.normal(size=(Bt, L, N)), dt_),
            t(rng.normal(size=(din,))))


@pytest.mark.cuda
@pytest.mark.parametrize("Bt,L,din,N", [
    (2, 64, 32, 8), (2, 128, 64, 16), (1, 1000, 200, 4), (1, 1000, 200, 16),
    (3, 33, 130, 16), (1, 1, 8, 8), (2, 300, 256, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_scan_kernel_matches_plain_version(Bt, L, din, N, dtype, with_h0,
                                           cuda_device):
    """y and h_final within 2e-5 absolute of the plain chunked scan and of
    the sequential oracle on the same inputs (tests/test_kernels.py's
    bound; bf16 inputs are upcast exactly by all three); ragged L and din,
    the shapes of tests/test_kernels.py, one step."""
    rng = np.random.default_rng(L + din + N)
    args = _scan_inputs(rng, Bt, L, din, N, dtype, cuda_device)
    h0 = (torch.tensor(rng.normal(size=(Bt, din, N)), dtype=torch.float32,
                       device=cuda_device) if with_h0 else None)
    before = scan_ops.LAUNCHES
    y, h = scan_ops.scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert scan_ops.LAUNCHES == before + 1
    assert y.shape == (Bt, L, din) and h.shape == (Bt, din, N)
    assert y.dtype == h.dtype == torch.float32
    for wy, wh in (scan_ops.scan(*args, h0=h0, use_kernel=False),
                   selective_scan_ref(*args, h0=h0)):
        assert float((y - wy).abs().max()) < 2e-5
        assert float((h - wh).abs().max()) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("Bt,L,din", [(2, 1001, 100), (1, 77, 333)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_scan_kernel_ragged_shapes(Bt, L, din, N, dtype, with_h0,
                                   cuda_device):
    """din not a multiple of a block's 128 channels and L not a multiple of
    its 16-step chunk: y and h_final within 2e-5 of the plain version and
    of the sequential oracle."""
    from repro_torch.kernels.selective_scan import kernel as scan_kernel

    assert din % scan_kernel.THREADS and L % scan_kernel.TL
    rng = np.random.default_rng(L + din + N)
    args = _scan_inputs(rng, Bt, L, din, N, dtype, cuda_device)
    h0 = (torch.tensor(rng.normal(size=(Bt, din, N)), dtype=torch.float32,
                       device=cuda_device) if with_h0 else None)
    y, h = scan_ops.scan(*args, h0=h0)
    torch.cuda.synchronize()
    for wy, wh in (scan_ops.scan(*args, h0=h0, use_kernel=False),
                   selective_scan_ref(*args, h0=h0)):
        assert float((y - wy).abs().max()) < 2e-5
        assert float((h - wh).abs().max()) < 2e-5


@pytest.mark.cuda
def test_scan_kernel_reads_strided_b_and_c_in_place(cuda_device):
    """B and C as column slices of the model's x_proj output (row stride
    dt_rank + 2N) give what contiguous copies give, bit for bit."""
    rng = np.random.default_rng(4)
    u, dt, A, _, _, D = _scan_inputs(rng, 2, 77, 96, 16, "bfloat16",
                                     cuda_device)
    proj = torch.tensor(rng.normal(size=(2, 77, 8 + 32)),
                        dtype=torch.bfloat16, device=cuda_device)
    Bv, Cv = proj[..., 8:24], proj[..., 24:]
    got = scan_ops.scan(u, dt, A, Bv, Cv, D)
    want = scan_ops.scan(u, dt, A, Bv.contiguous(), Cv.contiguous(), D)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_ssm_lm_serving_kernel_matches_plain(cuda_device):
    """The smoke Falcon-Mamba served on the card: attn_impl "cuda" (one
    kernel launch per layer per prefill, none in decode) against "chunked"
    on the same weights, float32, over mixed prompt lengths (one empty
    row) and 4 decode steps."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api

    S = 80
    cfg = get_smoke_config("falcon_mamba_7b", attn_impl="cuda",
                           dtype="float32")
    model = api.init_params(cfg, 3)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (3, 70)).astype(np.int32)
    lengths = np.array([70, 41, 0], np.int32)
    out = {}
    for impl in ("cuda", "chunked"):
        c = cfg.replace(attn_impl=impl)
        before = scan_ops.LAUNCHES
        logits, cache = api.prefill_into_cache(c, model, api.init_cache(
            c, 3, S), toks, lengths, S)
        launched = scan_ops.LAUNCHES - before
        pos = torch.tensor(lengths, device=cuda_device).long()
        fed = out["cuda"][4] if impl == "chunked" else [logits.argmax(-1)]
        steps = []
        before = scan_ops.LAUNCHES
        for t in range(4):
            lg, cache = api.decode_fn(c, model, cache, fed[t][:, None], pos,
                                      S)
            steps.append(lg)
            if impl == "cuda":
                fed.append(lg[:, 0].argmax(-1))
            pos = pos + 1
        assert scan_ops.LAUNCHES == before  # decode runs no kernel
        out[impl] = (logits, steps, cache, launched, fed)
    assert out["cuda"][3] == cfg.num_layers and out["chunked"][3] == 0
    assert _rel(out["cuda"][0][:2], out["chunked"][0][:2]) < 1e-4
    for a, b in zip(out["cuda"][1], out["chunked"][1]):
        assert _rel(a, b) < 1e-4
    for k in ("conv", "h"):
        assert _rel(out["cuda"][2]["blocks0"][k],
                    out["chunked"][2]["blocks0"][k]) < 1e-5


# --- the Toeplitz-FFT topo impl and TopoViT (no port kernel on this path) ---


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "sym"])
def test_toeplitz_float64_on_card_matches_cpu(causal, cuda_device):
    """The Toeplitz products run their FFTs in float64 on the card too
    (cuFFT) and agree with the CPU's (pocketfft) to float32 rounding."""
    from repro_torch.core import toeplitz

    rng = np.random.default_rng(1)
    L = 1000
    F = torch.tensor(np.exp(-np.arange(L) / 300.0)[None].repeat(4, 0),
                     dtype=torch.float32)
    V = torch.tensor(rng.normal(size=(2, 4, L, 24)), dtype=torch.float32)
    fn = (toeplitz.causal_toeplitz_matvec if causal
          else toeplitz.symmetric_toeplitz_matvec)
    got = fn(F.to(cuda_device), V.to(cuda_device))
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert _rel(got, fn(F, V)) < 1e-6
    dense = toeplitz.toeplitz_dense(F.double(), L, causal) @ V.double()
    assert _rel(got, dense) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [2, 3])
def test_topo_fft_impl_on_card_meets_ref(degree, cuda_device):
    """topo_attention_train with impl "fft" (Alg. 1, the float64 Toeplitz
    FastMult) against "ref" (the dense oracle) on the card, float32, with
    one token's features near zero (the case a float32 FFT misses)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models.layers import Params

    L = 97
    cfg = get_smoke_config("llama3_2_1b", attention_variant="topo",
                           topo_attn_impl="fft", topo_degree=degree,
                           topo_dist_scale=1.0 / L, dtype="float32")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(degree)
    attn = A.Attention(cfg, device=cuda_device)
    topo = Params(A.topo_shapes(cfg), device=cuda_device)
    with torch.no_grad():
        for name, t in A.attn_init(gen, cfg).items():
            getattr(attn, name).copy_(t)
        topo.coeffs.copy_(torch.linspace(0.3, -0.4, degree + 1))
        topo.logit_scale.zero_()
    x = torch.randn((2, L, cfg.d_model), generator=gen, device=cuda_device)
    x[:, 0] *= 1e-4
    pos = torch.arange(L, device=cuda_device)[None].expand(2, L)
    with torch.no_grad():
        for causal in (True, False):
            got = A.topo_attention_train(cfg, attn, topo, x, pos, causal)
            ref = A.topo_attention_train(cfg.replace(topo_attn_impl="ref"),
                                         attn, topo, x, pos, causal)
            assert _rel(got, ref) <= 1e-3, causal


@pytest.mark.cuda
def test_topovit_cuda_matches_ref_and_cpu(cuda_device):
    """The smoke TopoViT in float32 on the card: impl "cuda" against "ref"
    (the dense MST mask) and against "torch" on the CPU; the Hankel engine
    launches no port kernel."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.topo_linear_attention import ops as topo_ops
    from repro_torch.models import vit

    cfg = get_smoke_config("topovit_b16", dtype="float32",
                           topo_attn_impl="cuda")
    model = vit.init_params(cfg, 0, num_classes=10, patch_dim=32)
    with torch.no_grad():
        for blk in model.blocks:  # mask scalars away from their init
            blk.topo.coeffs.copy_(torch.tensor([0.2, -0.3, 0.4]))
    patches = np.random.default_rng(0).normal(size=(3, 16, 32)).astype(
        np.float32)
    before = (ops.LAUNCHES, topo_ops.LAUNCHES)
    with torch.no_grad():
        got = vit.forward(cfg, model, patches)
        assert (ops.LAUNCHES, topo_ops.LAUNCHES) == before
        ref = vit.forward(cfg.replace(topo_attn_impl="ref"), model, patches)
        cpu_model = vit.from_state_dict(cfg, {
            k: t.cpu() for k, t in model.state_dict().items()})
        cpu = vit.forward(cfg.replace(topo_attn_impl="torch"), cpu_model,
                          patches, device="cpu")
    assert got.device.type == "cuda" and got.shape == (3, 10)
    assert _rel(got, ref) <= 1e-3
    assert _rel(got, cpu) <= 1e-4


# --- the learnable tree metric (cell (j) of chip_smoke.py, cut to n = 2000) --


@pytest.mark.cuda
def test_learnable_metric_cuda_matches_torch(cuda_device):
    """bench_learnable_f's edge-training flow on the card at n = 2000:
    theta -> softplus -> `ftfi.reweight` -> `fastmult` -> relative error
    against exp(lam D_G) X. Backend "cuda" (B1, one launch per cross
    bucket each forward, none in the backward: X needs no grad) against
    "torch": the error within 1e-5 relative, the theta-gradient within
    1e-4 of its max (chip_smoke.py phase 4g's bounds)."""
    from repro_torch.graphs.graph import synthetic_graph
    from repro_torch.graphs.mst import minimum_spanning_tree
    from repro_torch.graphs.traverse import graph_all_pairs

    g = synthetic_graph(2000, 1000, seed=1)
    tree = minimum_spanning_tree(g)
    spec, _ = ftfi.build(tree, leaf_size=64, reweightable=True,
                         device=cuda_device)
    D_g = graph_all_pairs(g)
    lam = -2.0 / float(np.mean(D_g))
    X = np.random.default_rng(0).normal(size=(2000, 8)).astype(np.float32)
    Yt = torch.tensor(np.exp(lam * D_g).astype(np.float32) @ X,
                      device=cuda_device)
    Xt = torch.tensor(X, device=cuda_device)
    w0 = torch.tensor(tree.weights, dtype=torch.float32, device=cuda_device)
    theta0 = torch.log(torch.expm1(w0))
    out = {}
    for backend in ("cuda", "torch"):
        fm = ftfi.fastmult(spec, C.Exponential(lam), backend=backend,
                           device=cuda_device)
        th = theta0.clone().requires_grad_(True)
        before = ops.LAUNCHES
        err = torch.linalg.norm(
            fm(ftfi.reweight(spec, torch.nn.functional.softplus(th)), Xt)
            - Yt) / torch.linalg.norm(Yt)
        forward = ops.LAUNCHES - before
        (err ** 2).backward()
        torch.cuda.synchronize()
        launches = (forward, ops.LAUNCHES - before - forward)
        assert launches == ((len(spec.cross_tgt_d0), 0)
                            if backend == "cuda" else (0, 0))
        out[backend] = (err.detach(), th.grad)
    assert torch.isfinite(out["cuda"][0]) and torch.isfinite(
        out["cuda"][1]).all()
    assert _rel(out["cuda"][0], out["torch"][0]) <= 1e-5
    assert _rel(out["cuda"][1], out["torch"][1]) <= 1e-4


# --- plan maintenance on the card --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("point", ["ladder.cuda", "ladder.out.cuda"])
def test_ladder_never_demotes_on_the_card(point, cuda_device):
    """On card tensors a fault at the kernel rung (a raise, or a NaN
    output) raises `DeviceRungError`: no demotion, no warning, the closure
    stays on "cuda" and no counter but the fault's own moves."""
    import warnings

    from repro_torch.core import ladder
    from repro_torch.testing import faults

    spec, params = ftfi.build(random_tree(300, seed=2), leaf_size=32,
                              device=cuda_device)
    X = torch.randn(300, 3, device=cuda_device)
    handler = (faults.always_raise() if point == "ladder.cuda"
               else faults.nan_output())
    ladder.reset_stats()
    fm = ftfi.resilient_fastmult(spec, C.Exponential(-0.5),
                                 device=cuda_device)
    with faults.injected(point, handler), \
            warnings.catch_warnings():
        warnings.simplefilter("error", ftfi.BackendDemotionWarning)
        with pytest.raises(ftfi.DeviceRungError, match="on the card"):
            fm(params, X)
    assert fm.level == "cuda" and fm.demotions == []
    st = ladder.stats()
    assert st["demotions"] == 0
    assert st["errors" if point == "ladder.cuda" else "nonfinite"] == 1
    before = ops.LAUNCHES
    y = fm(params, X)
    assert ops.LAUNCHES - before == len(spec.cross_tgt_d0)
    want = ftfi.apply(spec, params, C.Exponential(-0.5), X, backend="cuda",
                      device=cuda_device)
    assert _rel(y, want) <= 1e-5


@pytest.mark.cuda
def test_update_plan_birth_params_land_on_the_card(cuda_device):
    """`update_plan(spec, None, ops)` puts the edited plan's birth params on
    the card by default, equal to those of an update from live params."""
    spec, params = ftfi.build(random_tree(40, seed=1), leaf_size=6,
                              reweightable=True, device=cuda_device)
    ops_ = [("insert_leaf", 3, 0.7), ("delete_leaf", 40)]
    s1, p1 = ftfi.update_plan(spec, None, ops_)
    s2, p2 = ftfi.update_plan(spec, params, ops_)
    assert s1.digest == s2.digest
    for a, b in zip(p1.cross_tgt_d + p1.leaf_dists,
                    p2.cross_tgt_d + p2.leaf_dists):
        assert a.device.type == "cuda" and torch.equal(a, b)
