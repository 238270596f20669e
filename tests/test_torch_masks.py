"""Port of the topological masks (core/masks.py, core/toeplitz.py) against
the reference's: the causal and symmetric Toeplitz products and the dense
mask, `mask_f`, Alg. 1 and its brute-force oracle, the tree FastMult on a
grid MST (Hankel engine) and a random tree (Chebyshev engine), the forest
FastMult with tree weights, the cordial decode states and the mask
coeffs' gradients through the tree FastMult against `jax.grad`.

C1: the reference's `fft` impl misses its own `ref` at the pinned example
of tests/test_topo_attention.py::test_impl_parity_sweep (seed 1, L = 33,
causal, degree 2, synced): a float32 FFT cannot resolve token 0's tiny
denominator. The port's Toeplitz products run their FFTs in float64; the
port's `fft` meets the reference's `ref` there and across the test's
parity matrix, and the same code with a float32 FFT misses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import ftfi as RF  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.core import masks as JMK  # noqa: E402
from repro.core import toeplitz as JTZ  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import mst as RMST  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import ftfi as TF  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.core import masks as TMK  # noqa: E402
from repro_torch.core import toeplitz as TTZ  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import mst as TMST  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ----------------------------------------------------------------------------
# Toeplitz products
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "sym"])
@pytest.mark.parametrize("F_shape,V_shape", [((37,), (37, 3)),
                                             ((2, 64), (3, 2, 64, 5)),
                                             ((1, 4, 50), (2, 4, 50, 8))])
def test_toeplitz_matvec_matches_reference(causal, F_shape, V_shape):
    rng = np.random.default_rng(sum(V_shape))
    L = V_shape[-2]
    # a decaying positive mask: well conditioned
    F = np.exp(-rng.uniform(0.5, 2.0, F_shape[:-1] + (1,))
               * np.arange(L) / L).astype(np.float32)
    V = rng.normal(size=V_shape).astype(np.float32)
    jfn = JTZ.causal_toeplitz_matvec if causal else (
        JTZ.symmetric_toeplitz_matvec)
    tfn = TTZ.causal_toeplitz_matvec if causal else (
        TTZ.symmetric_toeplitz_matvec)
    want = np.asarray(jfn(jnp.asarray(F), jnp.asarray(V)))
    got = tfn(_t(F), _t(V))
    assert got.dtype == torch.float32 and tuple(got.shape) == V_shape
    assert _rel(got, want) <= 1e-5
    dense = TTZ.toeplitz_dense(_t(F), L, causal)
    jdense = np.asarray(JTZ.toeplitz_dense(jnp.asarray(F), L, causal))
    assert np.array_equal(dense.numpy(), jdense)
    assert _rel(got, torch.einsum("...lk,...kd->...ld", dense, _t(V))) <= 1e-6


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "sym"])
def test_toeplitz_matvec_grad_in_F_matches_jax(causal):
    rng = np.random.default_rng(5)
    L, d = 29, 4
    F = np.exp(-np.arange(L) / L).astype(np.float32)
    V = rng.normal(size=(2, L, d)).astype(np.float32)
    W = rng.normal(size=(2, L, d)).astype(np.float32)
    jfn = JTZ.causal_toeplitz_matvec if causal else (
        JTZ.symmetric_toeplitz_matvec)
    want = np.asarray(jax.grad(lambda f: jnp.sum(
        jfn(f, jnp.asarray(V)) * jnp.asarray(W)))(jnp.asarray(F)))
    Ft = _t(F).requires_grad_(True)
    tfn = TTZ.causal_toeplitz_matvec if causal else (
        TTZ.symmetric_toeplitz_matvec)
    (tfn(Ft, _t(V)) * _t(W)).sum().backward()
    assert _rel(Ft.grad, want) <= 1e-5


# ----------------------------------------------------------------------------
# mask_f and Algorithm 1
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("g", ["exp", "recip", "identity"])
@pytest.mark.parametrize("c_shape,x_shape", [((3,), (9, 9)), ((2,), (7,)),
                                             ((4, 3), (11,))])
def test_mask_f_matches_reference(g, c_shape, x_shape):
    rng = np.random.default_rng(len(c_shape) * 10 + len(x_shape))
    cs = rng.uniform(-0.5, 0.5, c_shape).astype(np.float32)
    x = rng.uniform(0, 6, x_shape).astype(np.float32)
    want = np.asarray(JMK.mask_f(g, jnp.asarray(cs), 0.3)(jnp.asarray(x)))
    got = TMK.mask_f(g, _t(cs), 0.3)(_t(x))
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-6
    # numpy coeffs too (the reference takes either)
    assert _rel(TMK.mask_f(g, cs, 0.3)(_t(x)), want) <= 1e-6


ALG1_CASES = [("exp", [0.1, -0.4]), ("exp", [0.0, -0.2, -0.1]),
              ("identity", [1.0, 0.3, 0.05]), ("recip", [0.0, 1.0])]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "sym"])
@pytest.mark.parametrize("g,coeffs", ALG1_CASES)
def test_algorithm1_matches_bruteforce_and_reference(g, coeffs, causal):
    """tests/test_masks.py::test_algorithm1_vs_bruteforce on both
    packages, both ways."""
    rng = np.random.default_rng(0)
    L, d, m = 64, 8, 6
    qf = np.abs(rng.normal(size=(2, L, m))).astype(np.float32)
    kf = np.abs(rng.normal(size=(2, L, m))).astype(np.float32)
    V = rng.normal(size=(2, L, d)).astype(np.float32)
    cs = np.asarray(coeffs, np.float32)
    jfm = JMK.make_sequence_fastmult(g, jnp.asarray(cs), L, causal=causal,
                                     dist_scale=1 / L)
    want = np.asarray(JMK.masked_linear_attention(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(V), jfm))
    jmask = JTZ.toeplitz_dense(JMK.sequence_mask_values(
        g, jnp.asarray(cs), L, 1 / L), L, causal=causal)
    want_bf = np.asarray(JMK.masked_attention_bruteforce(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(V), jmask))
    fm = TMK.make_sequence_fastmult(g, _t(cs), L, causal=causal,
                                    dist_scale=1 / L)
    got = TMK.masked_linear_attention(_t(qf), _t(kf), _t(V), fm)
    mask = TTZ.toeplitz_dense(TMK.sequence_mask_values(g, _t(cs), L, 1 / L),
                              L, causal)
    got_bf = TMK.masked_attention_bruteforce(_t(qf), _t(kf), _t(V), mask)
    assert _rel(got_bf, want_bf) <= 1e-5
    assert _rel(got, want) <= 1e-4
    assert float((got - got_bf).abs().max()) < 1e-4  # the reference's bound


# ----------------------------------------------------------------------------
# tree and forest FastMults
# ----------------------------------------------------------------------------


def _trees(kind):
    if kind == "grid_mst":
        return (RMST.minimum_spanning_tree(RG.grid_graph(6, 6)),
                TMST.minimum_spanning_tree(TG.grid_graph(6, 6)), 8)
    return RG.random_tree(150, seed=4), TG.random_tree(150, seed=4), 16


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("coeffs", [[0.0, -0.3], [0.2, -0.4, -0.1]],
                         ids=["degree1", "degree2"])
@pytest.mark.parametrize("kind", ["grid_mst", "random_tree"])
def test_tree_fastmult_matches_reference(kind, coeffs, backend):
    """tests/test_masks.py::test_grid_mask_fastmult's check (batched field,
    leading axes folded) on the port against the reference's pair path."""
    rtree, ttree, leaf = _trees(kind)
    rspec, rparams = RF.build(rtree, leaf_size=leaf)
    spec, params = TF.build(ttree, leaf_size=leaf, device="cpu")
    rng = np.random.default_rng(len(coeffs))
    X = rng.normal(size=(2, 3, ttree.num_vertices, 5)).astype(np.float32)
    cs = np.asarray(coeffs, np.float32)
    want = np.asarray(JMK.make_tree_fastmult(
        (rspec, rparams), "exp", jnp.asarray(cs), 0.5)(jnp.asarray(X)))
    fm = TMK.make_tree_fastmult((spec, params), "exp", cs, 0.5,
                                backend=backend, device="cpu")
    got = fm(_t(X))
    assert got.dtype == torch.float32 and got.shape == X.shape
    assert _rel(got, want) <= 1e-5
    if kind == "grid_mst":  # Hankel: exact against the dense mask
        from repro_torch.graphs.traverse import tree_all_pairs

        D = _t(tree_all_pairs(ttree))
        M = TMK.mask_f("exp", cs, 0.5)(D)
        assert _rel(got, torch.einsum("lk,...kd->...ld", M, _t(X))) <= 1e-5
        assert TF.describe(spec, TMK.mask_f("exp", cs, 0.5),
                           backend=backend)["cross_engine"] == "hankel_fft"


def test_tree_fastmult_column_chunks_give_the_same_field(monkeypatch):
    """The folded field runs FIELD_COL_CHUNK columns at a time: a ragged
    last chunk and many chunks give the one-chunk result; grads flow."""
    spec, params = TF.build(TMST.minimum_spanning_tree(TG.grid_graph(6, 6)),
                            leaf_size=8, device="cpu")
    X = torch.randn(3, 2, 36, 7, generator=torch.Generator().manual_seed(2))
    cs = torch.tensor([0.1, -0.6, -0.2])
    whole = TMK.make_tree_fastmult((spec, params), "exp", cs, 0.5,
                                   device="cpu")(X)
    monkeypatch.setattr(TMK, "FIELD_COL_CHUNK", 5)  # 42 columns: 9 chunks
    cg = cs.clone().requires_grad_(True)
    got = TMK.make_tree_fastmult((spec, params), "exp", cg, 0.5,
                                 device="cpu")(X)
    assert got.shape == X.shape
    assert _rel(got.detach(), whole) <= 1e-6
    got.sum().backward()
    assert cg.grad is not None and bool(torch.isfinite(cg.grad).all())


def test_forest_fastmult_with_tree_weights_matches_reference():
    rng = np.random.default_rng(2)
    sizes = [12, 30, 7, 21]
    rforest = RG.Forest([RG.random_tree(n, seed=i)
                         for i, n in enumerate(sizes)])
    tforest = TG.Forest([TG.random_tree(n, seed=i)
                         for i, n in enumerate(sizes)])
    rplan = RF.build(rforest, leaf_size=8)
    plan = TF.build(tforest, leaf_size=8, device="cpu")
    X = rng.normal(size=(2, sum(sizes), 4)).astype(np.float32)
    w = np.array([0.5, 2.0, -1.0, 1.5], np.float32)
    cs = np.array([0.1, -0.6], np.float32)
    want = np.asarray(JMK.make_forest_fastmult(
        rplan, rforest, "exp", jnp.asarray(cs), 0.4,
        tree_weights=w)(jnp.asarray(X)))
    got = TMK.make_forest_fastmult(plan, tforest, "exp", cs, 0.4,
                                   tree_weights=w, device="cpu")(_t(X))
    assert _rel(got, want) <= 1e-5
    plain = TMK.make_forest_fastmult(plan, tforest, "exp", cs, 0.4,
                                     device="cpu")(_t(X))
    rows = _t(tforest.broadcast(w))[:, None]
    assert torch.allclose(got, plain * rows, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["grid_mst", "random_tree"])
def test_tree_fastmult_coeff_grads_match_jax(kind):
    """The mask coeffs' gradient through the tree FastMult (family None:
    leaf blocks, the Hankel or Chebyshev mask values and the diagonal
    correction) against jax.grad of the reference's."""
    rtree, ttree, leaf = _trees(kind)
    rplan = RF.build(rtree, leaf_size=leaf)
    plan = TF.build(ttree, leaf_size=leaf, device="cpu")
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2, ttree.num_vertices, 3)).astype(np.float32)
    W = rng.normal(size=X.shape).astype(np.float32)
    cs = np.array([0.1, -0.5, -0.2], np.float32)

    def jloss(c):
        fm = JMK.make_tree_fastmult(rplan, "exp", c, 0.5)
        return jnp.sum(fm(jnp.asarray(X)) * jnp.asarray(W))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(cs)))
    c = _t(cs).requires_grad_(True)
    fm = TMK.make_tree_fastmult(plan, "exp", c, 0.5, device="cpu")
    (fm(_t(X)) * _t(W)).sum().backward()
    assert _rel(c.grad, want) <= 1e-4


def test_tree_fastmult_refusals():
    spec, params = TF.build(TG.random_tree(20, seed=0), leaf_size=8,
                            device="cpu")
    with pytest.raises(TypeError, match="A9"):
        TMK.make_tree_fastmult(object(), "exp", [0.0, -1.0], device="cpu")
    with pytest.raises(TypeError, match="A9"):
        TMK.make_tree_fastmult((spec,), "exp", [0.0, -1.0], device="cpu")
    with pytest.raises(TypeError, match="A9"):
        TMK.make_tree_fastmult([params, spec], "exp", [0.0, -1.0],
                               device="cpu")


# ----------------------------------------------------------------------------
# cordial decode states
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("perhead", [False, True], ids=["synced", "perhead"])
@pytest.mark.parametrize("g,T", [("exp", 0), ("exp", 1), ("identity", 1),
                                 ("identity", 2)])
def test_cordial_decode_matches_reference(g, T, perhead):
    """tests/test_masks.py::test_cordial_decode_property's loop on both
    packages: every token's output and the final states."""
    r = np.random.default_rng(T * 2 + perhead)
    H, m, d, L = 2, 3, 4, 23
    shape = (H, T + 1) if perhead else (T + 1,)
    coeffs = r.uniform(-0.6, 0.6, size=shape).astype(np.float32)
    coeffs[..., 0] = r.uniform(1.5, 2.5, size=shape[:-1])
    qf = np.abs(r.normal(size=(H, L, m))).astype(np.float32)
    kf = np.abs(r.normal(size=(H, L, m))).astype(np.float32)
    V = r.normal(size=(H, L, d)).astype(np.float32)
    jdec = JMK.cordial_decomposition(g, coeffs, dist_scale=1.0 / L)
    tdec = TMK.cordial_decomposition(g, coeffs, dist_scale=1.0 / L)
    assert tdec.num_terms == jdec.num_terms
    jstate = JMK.decode_state_init(jdec, m, d, batch_shape=(H,))
    tstate = TMK.decode_state_init(tdec, m, d, batch_shape=(H,))
    for t in range(L):
        jstate = JMK.decode_state_update(jdec, jstate, t, kf[:, t], V[:, t])
        tstate = TMK.decode_state_update(tdec, tstate, t, _t(kf[:, t]),
                                         _t(V[:, t]))
        want = np.asarray(JMK.decode_state_read(jdec, jstate, t, qf[:, t]))
        got = TMK.decode_state_read(tdec, tstate, t, _t(qf[:, t]))
        assert _rel(got, want) <= 1e-5, t
    for j, tt in zip(jstate, tstate):
        assert _rel(tt, j) <= 1e-5


def test_cordial_decomposition_refuses_non_separable():
    with pytest.raises(ValueError, match="not exactly separable"):
        TMK.cordial_decomposition("exp", [0.0, -1.0, -0.5])
    with pytest.raises(ValueError, match="not exactly separable"):
        TMK.cordial_decomposition("recip", [0.0, 1.0])


# ----------------------------------------------------------------------------
# C1: the topo "fft" impl at degree >= 2 against the reference's "ref"
# ----------------------------------------------------------------------------


def _topo_case(seed, L, causal, degree, perhead, gqa):
    """tests/test_topo_attention.py's `_cfg` / `_topo_params` / inputs of
    one parity-sweep example, on both packages."""
    H, hd = (4 if gqa else 2), 8
    kw = dict(name="topo-test", family="dense", num_layers=1, d_model=H * hd,
              num_heads=H, num_kv_heads=2 if gqa else H, head_dim=hd,
              d_ff=16, vocab_size=64, attention_variant="topo",
              performer_phi="relu", topo_g="exp", topo_degree=degree,
              topo_synced=not perhead, topo_dist_scale=1.0 / L,
              dtype="float32")
    jcfg = JConfig(topo_attn_impl="ref", **kw)
    r = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, JA.attn_init(jax.random.PRNGKey(seed), jcfg))
    lead = (H,) if perhead else ()
    p_topo = {"coeffs": r.uniform(-0.5, 0.5, lead + (degree + 1,)).astype(
        np.float32), "logit_scale": r.uniform(-0.3, 0.3, lead).astype(
        np.float32)}
    x = (np.random.default_rng(seed + 7).normal(size=(2, L, jcfg.d_model))
         * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(L), (2, L))
    want = np.asarray(JA.topo_attention_train(
        jcfg, {k: jnp.asarray(a) for k, a in p.items()},
        {k: jnp.asarray(a) for k, a in p_topo.items()}, jnp.asarray(x),
        jnp.asarray(positions), causal=causal))
    tcfg = TConfig(topo_attn_impl="fft", **kw)
    attn = TA.Attention(tcfg)
    topo = Params(TA.topo_shapes(tcfg))
    with torch.no_grad():
        for name, a in p.items():
            getattr(attn, name).copy_(_t(a))
        for name, a in p_topo.items():
            getattr(topo, name).copy_(_t(a))

    def run(impl):
        with torch.no_grad():
            return TA.topo_attention_train(
                tcfg.replace(topo_attn_impl=impl), attn, topo, _t(x),
                torch.from_numpy(np.ascontiguousarray(positions)),
                causal=causal)

    run.fields = lambda: _fields(tcfg, attn, topo, _t(x))
    return want, run


def _fields(cfg, attn, topo, x):
    """phi(q), phi(k) (B, H, L, m) and the mask values F (1, H, L) that
    the port's fft impl feeds Alg. 1."""
    with torch.no_grad():
        q, k, _ = TA._project_qkv(cfg, attn, x, None, rope=False)
        k, _ = TA._expand_kv(cfg, k, k)
        scale = TA.topo_logit_scale(cfg, topo)
        qf = TA.phi_features(q * scale[None, None, :, None],
                             cfg.performer_phi)
        kf = TA.phi_features(k, cfg.performer_phi)
        F = TMK.sequence_mask_values(cfg.topo_g,
                                     TA.topo_mask_coeffs(cfg, topo),
                                     x.shape[1], cfg.topo_dist_scale)
    return qf.transpose(1, 2), kf.transpose(1, 2), F[None]


def test_fft_meets_ref_at_the_pinned_example(monkeypatch):
    """C1's example: seed 1, L = 33, causal, degree 2, synced, H = 2."""
    want, run = _topo_case(1, 33, True, 2, False, False)
    got = run("fft")
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-3
    assert _rel(run("ref"), want) <= 1e-5
    # the same path with a float32 FFT misses, as the reference's does
    monkeypatch.setattr(TTZ, "_FFT_DTYPE", torch.float32)
    assert _rel(run("fft"), want) > 1e-3


def test_pinned_example_denominator_needs_float64():
    """Why: at token 0 the denominator q_0 . (M phi(K))_0 is ~1e-6 of the
    largest, and a float32 FFT errs by ~1e-7 of the largest row."""
    _, run = _topo_case(1, 33, True, 2, False, False)
    qf, kf, F = (t.double() for t in run.fields())
    L = qf.shape[-2]
    exact = torch.einsum("bhlm,bhlm->bhl", qf,
                         TTZ.toeplitz_dense(F, L, True) @ kf)
    assert float(exact[0, 0, 0]) < 1e-5 * float(exact.abs().max())

    def den0_err(d2):
        den = torch.einsum("bhlm,bhlm->bhl", qf, d2.double())
        return float((den[0, 0, 0] - exact[0, 0, 0]).abs() / exact[0, 0, 0])

    assert den0_err(TTZ.causal_toeplitz_matvec(F, kf.float())) < 1e-6
    n = 128  # the float32 FFT of the same product
    f32 = torch.fft.irfft(
        torch.fft.rfft(F.float(), n=n)[..., None]
        * torch.fft.rfft(kf.float(), n=n, dim=-2), n=n, dim=-2)[..., :L, :]
    assert den0_err(f32) > 1e-3


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
@pytest.mark.parametrize("perhead", [False, True], ids=["synced", "perhead"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_impls_meet_reference_ref_across_the_parity_matrix(degree, causal,
                                                           perhead, gqa):
    """tests/test_topo_attention.py::test_impl_parity_sweep's matrix: the
    port's "ref", "torch" and "fft" against the reference's "ref"."""
    seed = 1 + degree + 3 * causal + 5 * perhead + 7 * gqa
    L = 33 + (seed * 5) % 47
    want, run = _topo_case(seed, L, causal, degree, perhead, gqa)
    assert _rel(run("ref"), want) <= 1e-5
    for impl in ("torch", "fft"):
        assert _rel(run(impl), want) <= 1e-3, impl
