"""Port of the Mamba-1 selective scan (kernel B6): the plain chunked scan
(`ops.selective_scan`), the sequential oracle (`ref.selective_scan_ref`)
and the kernel wrapper's CPU path (`ops.scan`) against the reference's
chunked scan `models.ssm.selective_scan` (y and h_final), its sequential
oracle and its Pallas kernel (interpret mode), on the same numpy inputs:
the shapes of tests/test_kernels.py, a ragged L, an h0, bf16 inputs and
strided B/C views; the wrapper's refusals. The kernel itself is held
against the plain version on a card by test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.selective_scan.kernel import (  # noqa: E402
    selective_scan_pallas)
from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as j_ref)
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.selective_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as t_ref)

TOL = 2e-5  # tests/test_kernels.py::test_selective_scan, absolute


def _inputs(rng, Bt, L, din, N):
    """Drawn as tests/test_kernels.py::test_selective_scan draws them."""
    return (rng.normal(size=(Bt, L, din)).astype(np.float32),
            (np.abs(rng.normal(size=(Bt, L, din))) * 0.1).astype(np.float32),
            (-np.abs(rng.normal(size=(din, N))) - 0.1).astype(np.float32),
            rng.normal(size=(Bt, L, N)).astype(np.float32),
            rng.normal(size=(Bt, L, N)).astype(np.float32),
            rng.normal(size=(din,)).astype(np.float32))


def _port(fn, args, chunk, h0=None):
    """Runs one of the port's three scans on CPU tensors; returns numpy
    (y, h_final)."""
    t = [torch.from_numpy(a) for a in args]
    h0 = None if h0 is None else torch.from_numpy(h0)
    if fn == "plain":
        y, h = ops.selective_scan(*t, chunk=chunk, h0=h0)
    elif fn == "oracle":
        y, h = t_ref(*t, h0=h0)
    else:
        y, h = ops.scan(*t, h0=h0)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    return y.numpy(), h.numpy()


def _abs(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


FNS = ["plain", "oracle", "wrapper"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("L,din,N,chunk,blkd", [(64, 32, 8, 16, 16),
                                                (128, 64, 16, 32, 32)])
def test_scan_matches_reference(fn, L, din, N, chunk, blkd):
    args = _inputs(np.random.default_rng(L + N), 2, L, din, N)
    y, h = _port(fn, args, chunk)
    jargs = [jnp.asarray(a) for a in args]
    want_y, want_h = JS.selective_scan(*jargs, chunk=chunk)
    assert y.shape == (2, L, din) and h.shape == (2, din, N)
    assert _abs(y, want_y) < TOL and _abs(h, want_h) < TOL
    assert _abs(y, j_ref(*jargs)) < TOL
    assert _abs(y, selective_scan_pallas(*jargs, chunk=chunk, blk_d=blkd,
                                         interpret=True)) < TOL


@pytest.mark.parametrize("fn", FNS)
def test_ragged_length_and_width(fn):
    """L = 100 is no multiple of the chunk (the plain scan pads the tail
    with dt = 0) and din = 48 no multiple of a block; against the
    reference's oracle and its chunked scan in one chunk."""
    L, din, N = 100, 48, 4
    args = _inputs(np.random.default_rng(3), 2, L, din, N)
    y, h = _port(fn, args, chunk=32)
    jargs = [jnp.asarray(a) for a in args]
    want_y, want_h = JS.selective_scan(*jargs, chunk=L)
    assert _abs(y, want_y) < TOL and _abs(h, want_h) < TOL
    assert _abs(y, j_ref(*jargs)) < TOL


@pytest.mark.parametrize("fn", FNS)
def test_initial_state(fn):
    L, din, N = 64, 32, 16
    rng = np.random.default_rng(4)
    args = _inputs(rng, 2, L, din, N)
    h0 = rng.normal(size=(2, din, N)).astype(np.float32)
    y, h = _port(fn, args, chunk=16, h0=h0)
    want_y, want_h = JS.selective_scan(*[jnp.asarray(a) for a in args],
                                       chunk=16, h0=jnp.asarray(h0))
    assert _abs(y, want_y) < TOL and _abs(h, want_h) < TOL
    # the state carries over: two halves give the whole
    y1, h1 = _port(fn, [a[:, :32] if a.ndim == 3 else a for a in args], 16,
                   h0=h0)
    y2, h2 = _port(fn, [a[:, 32:] if a.ndim == 3 else a for a in args], 16,
                   h0=h1)
    assert _abs(np.concatenate([y1, y2], 1), y) < TOL and _abs(h2, h) < TOL


@pytest.mark.parametrize("fn", FNS)
def test_padding_with_zero_dt_passes_the_state_through(fn):
    """The model's prefill zeroes dt past each row's length: the state
    stays that of the last real step (to the digit in the sequential
    oracle; the chunked scan sums in another order), and y there is
    C . h + D u."""
    args = _inputs(np.random.default_rng(5), 1, 40, 16, 8)
    u, dt, A, B, C, D = args
    cut = dt.copy()
    cut[:, 25:] = 0.0
    y, h = _port(fn, (u, cut, A, B, C, D), chunk=16)
    y25, h25 = _port(fn, (u[:, :25], dt[:, :25], A, B[:, :25], C[:, :25],
                          D), chunk=16)
    assert _abs(h, h25) < TOL and _abs(y[:, :25], y25) < TOL
    if fn == "oracle":
        assert np.array_equal(h, h25)
    tail = np.einsum("bdn,btn->btd", h25, C[:, 25:]) + u[:, 25:] * D
    assert _abs(y[:, 25:], tail) < TOL


def test_bfloat16_inputs_upcast_exactly():
    """u, dt, B and C in bfloat16 give what their float32 upcast gives."""
    args = _inputs(np.random.default_rng(6), 2, 48, 32, 8)
    t = [torch.from_numpy(a) for a in args]
    low = [x.to(torch.bfloat16) if x.ndim == 3 else x for x in t]
    up = [x.float() for x in low]
    for fn in (ops.scan, ops.selective_scan, t_ref):
        y, h = fn(*low)
        y32, h32 = fn(*up)
        assert y.dtype == torch.float32
        assert torch.equal(y, y32) and torch.equal(h, h32)


def test_strided_b_and_c_are_read_in_place():
    """B and C as column slices of one projection (the model's x_proj
    output) give what contiguous copies give."""
    rng = np.random.default_rng(7)
    u, dt, A, _, _, D = (torch.from_numpy(a)
                         for a in _inputs(rng, 2, 30, 16, 4))
    proj = torch.from_numpy(rng.normal(size=(2, 30, 3 + 8)).astype(
        np.float32))
    Bv, Cv = proj[..., 3:7], proj[..., 7:]
    assert not Bv.is_contiguous()
    got = ops.scan(u, dt, A, Bv, Cv, D)
    want = ops.scan(u, dt, A, Bv.contiguous(), Cv.contiguous(), D)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_refusals():
    args = [torch.from_numpy(a)
            for a in _inputs(np.random.default_rng(8), 1, 8, 4, 5)]
    # N = 5 has no kernel instance: the kernel path refuses it, the plain
    # version takes it
    with pytest.raises(ValueError, match="state size"):
        ops.scan(*args)
    _, h = ops.scan(*args, use_kernel=False)
    assert h.shape == (1, 4, 5)
    args = [torch.from_numpy(a)
            for a in _inputs(np.random.default_rng(8), 1, 8, 4, 4)]
    u, dt, A, B, C, D = args
    with pytest.raises(TypeError, match="one dtype"):
        ops.scan(u.bfloat16(), dt, A, B, C, D)
    with pytest.raises(TypeError, match="float32"):
        ops.scan(u, dt, A.double(), B, C, D)
    with pytest.raises(ValueError, match="unit last stride"):
        ops.scan(u.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C,
                 D)
    with pytest.raises(ValueError, match="must be"):
        ops.scan(u, dt, A, B[:, :4], C, D)
    with pytest.raises(ValueError, match="must be"):
        ops.scan(u, dt, A, B, C, D, h0=torch.zeros(1, 4, 3))
    assert kernel.N_CHOICES == (4, 8, 16)


def test_wrapper_refuses_grad_on_the_kernel_path():
    """The kernel path no longer refuses inputs that require grad: its
    autograd.Function's backward is the plain chunked scan's VJP, so u,
    dt, A, B, C, D and h0 get the plain path's grads through y and
    h_final; under no_grad the wrapper runs, and CPU tensors never reach
    the kernel."""
    rng = np.random.default_rng(9)
    ins = [torch.from_numpy(a) for a in _inputs(rng, 1, 16, 8, 4)]
    ins.append(torch.from_numpy(rng.normal(size=(1, 8, 4)).astype(
        np.float32)))  # h0
    wy = torch.from_numpy(rng.normal(size=(1, 16, 8)).astype(np.float32))
    before = ops.LAUNCHES
    grads = []
    for use_kernel in (True, False):
        args = [t.clone().requires_grad_(True) for t in ins]
        y, h = ops.scan(*args[:6], h0=args[6], use_kernel=use_kernel)
        ((y * wy).sum() + h.sum()).backward()
        grads.append([t.grad for t in args])
    for got, want in zip(*grads):
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
    with torch.no_grad():
        ops.scan(*ins[:6])
    assert ops.LAUNCHES == before  # CPU tensors never reach the kernel


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _fma(a, b, c):
    """fmaf: a b + c with one rounding to float32 (the float64 product of
    two float32 values is exact)."""
    return _f32(np.asarray(a, np.float64) * np.asarray(b, np.float64)
                + np.asarray(c, np.float64))


def _kernel_emulation(u, dt, A, Bm, Cm, D):
    """The kernel's arithmetic (selective_scan.cu) in float32 on the CPU:
    a2 = A log2(e) rounded once, dA = 2^(fma(dt, a2, 1)) / 2, h =
    fma(du, B, dA h), y summed over n in order by fmas, then + D u. The
    card's MUFU.EX2 is not emulated (exp2 here is accurate); its error is
    measured on the card (chip_scan_variants.py)."""
    Bt, L, din = u.shape
    N = A.shape[1]
    a2 = _f32(A * np.float32(np.log2(np.e)))
    h = np.zeros((Bt, din, N), np.float32)
    ys = np.zeros((Bt, L, din), np.float32)
    for t in range(L):
        d = dt[:, t, :, None]
        dA = _f32(np.exp2(_fma(d, a2[None], 1.0)) * np.float32(0.5))
        du = _f32(dt[:, t] * u[:, t])[..., None]
        h = _fma(du, Bm[:, t, None, :], _f32(dA * h))
        acc = np.zeros((Bt, din), np.float32)
        for n in range(N):
            acc = _fma(h[..., n], Cm[:, t, None, n], acc)
        ys[:, t] = _fma(u[:, t], D[None], acc)
    return ys, h


@pytest.mark.parametrize("N", [4, 8, 16])
def test_kernel_arithmetic_keeps_the_bound(N):
    """The kernel's arithmetic, emulated on the CPU (log2(e) folded into A,
    the decay as 2^(dt a2 + 1) / 2, h's fma order), stays within
    tests/test_kernels.py's 2e-5 of the sequential oracle on y and h_final."""
    args = _inputs(np.random.default_rng(N), 2, 300, 40, N)
    y, h = _kernel_emulation(*args)
    wy, wh = t_ref(*[torch.from_numpy(a) for a in args])
    assert _abs(y, wy.numpy()) < TOL and _abs(h, wh.numpy()) < TOL


def test_kernel_block_geometry():
    """The wrapper's THREADS and TL are the .cu file's: one thread a
    channel, 128 channels a block, 16 steps a staged chunk; the served
    Falcon-Mamba prefill (Bt = 4, din = 8192) runs 256 blocks."""
    src = kernel.SOURCE.read_text()
    assert f"constexpr int THREADS = {kernel.THREADS};" in src
    assert f"constexpr int TL = {kernel.TL};" in src
    assert (kernel.THREADS, kernel.TL) == (128, 16)
    assert 4 * (-(-8192 // kernel.THREADS)) == 256


def test_scan_kernel_source_names_the_tpu_kernel_and_its_design():
    src = kernel.SOURCE.read_text()
    note = src[:src.index("#include")]
    for word in ("selective_scan_pallas", "Bound on an H100",
                 "one thread owns one (b, d)", "float4 broadcasts",
                 "2^(dt a2 + 1) / 2", "fma(du, B, dA h)", "phase 4d",
                 "float64"):
        assert word in note, word
    assert "ex2.approx.ftz.f32 %0, %1;" in src
    assert "h[n] = fmaf(du, bv[i], dA * h[n]);" in src
    assert 'extern "C" int selective_scan_launch' in src
