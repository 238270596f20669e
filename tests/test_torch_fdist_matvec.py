"""Port of the fused f-distance matvec: its plain PyTorch version and CPU
wrapper against the reference Pallas kernels (interpret mode) on the
shapes and modes of test_kernels.py, the wrapper's input checks, the launch
grid, and the rule that nothing falls back from the kernel to the plain
version. The kernel itself is held against the plain version on a card by
test_torch_cuda.py."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.fdist_matvec.kernel import (  # noqa: E402
    fdist_matvec_batched_pallas, fdist_matvec_pallas)
from repro_torch.kernels.fdist_matvec import kernel, ops  # noqa: E402
from repro_torch.kernels.fdist_matvec.ref import (  # noqa: E402
    fdist_matvec_batched_ref, fdist_matvec_ref)

SHAPES = [(300, 200, 8), (128, 128, 4), (97, 33, 3), (64, 257, 16)]
MODES = [
    ("poly", (0.5, -0.2, 0.1)),
    ("exp", (-0.7, 1.3)),
    ("expq", (-0.05, -0.2, 0.1)),
    ("rational", (0.8,)),
]
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-9)


def _inputs(rng, B, a, b, d):
    return (rng.uniform(0, 3, (B, a)).astype(np.float32),
            rng.uniform(0, 3, (B, b)).astype(np.float32),
            rng.normal(size=(B, b, d)).astype(np.float32))


@pytest.mark.parametrize("a,b,d", SHAPES)
@pytest.mark.parametrize("mode,coeffs", MODES)
def test_single_job_matches_pallas(a, b, d, mode, coeffs, rng):
    x, y, v = (t[0] for t in _inputs(rng, 1, a, b, d))
    cs = np.asarray(coeffs, np.float32)
    want = fdist_matvec_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                               jnp.asarray(cs), mode=mode, blk_a=64, blk_b=64,
                               interpret=True)
    tx, ty, tv, tc = map(torch.from_numpy, (x, y, v, cs))
    assert _rel(fdist_matvec_ref(tx, ty, tv, tc, mode), want) < 3e-6
    assert _rel(ops.fdist_matvec(tx, ty, tv, tc, mode), want) < 3e-6


@pytest.mark.parametrize("a,b,d", SHAPES)
@pytest.mark.parametrize("mode,coeffs", MODES)
def test_batched_matches_pallas(a, b, d, mode, coeffs, rng):
    x, y, v = _inputs(rng, 2, a, b, d)
    cs = np.asarray(coeffs, np.float32)
    want = fdist_matvec_batched_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), jnp.asarray(cs),
        mode=mode, blk_a=64, blk_b=64, interpret=True)
    args = tuple(map(torch.from_numpy, (x, y, v, cs)))
    before = ops.LAUNCHES
    assert _rel(fdist_matvec_batched_ref(*args, mode), want) < 3e-6
    assert _rel(ops.fdist_matvec_batched(*args, mode), want) < 3e-6
    assert ops.LAUNCHES == before  # CPU tensors never count as launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_pallas(dtype, rng):
    x = rng.uniform(0, 2, 128).astype(np.float32)
    y = rng.uniform(0, 2, 96).astype(np.float32)
    v = rng.normal(size=(96, 8)).astype(np.float32)
    cs = np.asarray([-0.5, 1.0], np.float32)
    jv = jnp.asarray(v, getattr(jnp, dtype))
    want = fdist_matvec_pallas(jnp.asarray(x), jnp.asarray(y), jv,
                               jnp.asarray(cs), mode="exp", blk_a=32,
                               blk_b=32, interpret=True)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    got = ops.fdist_matvec(torch.from_numpy(x), torch.from_numpy(y), tv,
                           torch.from_numpy(cs), "exp")
    assert got.dtype == tv.dtype
    want32 = np.asarray(want.astype(jnp.float32))
    tol = 3e-6 if dtype == "float32" else 3e-2
    err = float(np.max(np.abs(got.float().numpy() - want32)))
    assert err < tol * max(float(np.max(np.abs(want32))), 1)


def _ok_args():
    return (torch.zeros(2, 5), torch.zeros(2, 7), torch.zeros(2, 7, 3),
            torch.tensor([1.0, 0.5]))


@pytest.mark.parametrize("bad", [
    "x_dtype", "v_dtype", "coeff_count", "x_ndim", "batch", "noncontig",
    "mode", "numpy", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, y, v, cs = _ok_args()
    mode = "exp"
    if bad == "x_dtype":
        x = x.double()
    elif bad == "v_dtype":
        v = v.half()
    elif bad == "coeff_count":
        cs = torch.tensor([1.0, 0.5, 0.1])
    elif bad == "x_ndim":
        x = x[0]
    elif bad == "batch":
        y = torch.zeros(3, 7)
    elif bad == "noncontig":
        v = torch.zeros(2, 3, 7).transpose(1, 2)
    elif bad == "mode":
        mode = "cos"
    elif bad == "numpy":
        x = np.zeros((2, 5), np.float32)
    elif bad == "meta_device":  # neither the CPU nor a card: no kernel
        x, y, v, cs = (t.to("meta") for t in (x, y, v, cs))
    with pytest.raises((TypeError, ValueError)):
        ops.fdist_matvec_batched(x, y, v, cs, mode)


@pytest.mark.parametrize("which", ["x", "y", "v", "coeffs"])
def test_wrapper_refuses_inputs_that_require_grad(which):
    """The wrapper never returns a result cut from the graph: an input that
    requires grad gets the plain version's grad, through the wrapper's
    autograd.Function (v: M^T u, the wrapper's own forward with x and y
    swapped; x, y, coeffs: the plain version's VJP), batched and single;
    under no_grad the wrapper runs as before."""
    rng = np.random.default_rng(3)
    x, y = (torch.tensor(rng.uniform(0, 1, s), dtype=torch.float32)
            for s in ((2, 5), (2, 7)))
    v = torch.tensor(rng.normal(size=(2, 7, 3)), dtype=torch.float32)
    cs = torch.tensor([-0.7, 1.3])
    u = torch.tensor(rng.normal(size=(2, 5, 3)), dtype=torch.float32)

    def grad_of(fn, args):
        args = dict(args)
        args[which] = args[which].clone().requires_grad_(True)
        (fn(args["x"], args["y"], args["v"], args["coeffs"], "exp")
         * u[:args["x"].shape[0]]).sum().backward()
        return args[which].grad

    args = {"x": x, "y": y, "v": v, "coeffs": cs}
    want = grad_of(fdist_matvec_batched_ref, args)
    got = grad_of(ops.fdist_matvec_batched, args)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())
    one = {k: (t[0] if k != "coeffs" else t) for k, t in args.items()}
    got1 = grad_of(lambda x, y, v, c, m: ops.fdist_matvec(x, y, v, c, m)[None],
                   one)
    want1 = grad_of(lambda x, y, v, c, m: fdist_matvec_ref(x, y, v, c,
                                                           m)[None], one)
    assert float((got1 - want1).abs().max()) <= 1e-6 * float(
        want1.abs().max())
    with torch.no_grad():
        got = ops.fdist_matvec_batched(x, y, v, cs, "exp")
    assert torch.equal(got, fdist_matvec_batched_ref(x, y, v, cs, "exp"))


def _coverage(B, a, b, d, cfg):
    """How many (block, split) pairs of the grid visit each (job, row,
    source, column), from the kernels' own index arithmetic."""
    count = np.zeros((B, a, b, d), np.int32)
    for x in range(B * cfg["row_tiles"]):
        job, i0 = x // cfg["row_tiles"], (x % cfg["row_tiles"]) * cfg["rows"]
        for y in range(cfg["d_tiles"]):
            c0 = y * cfg["td"]
            for z in range(cfg["splits"]):
                j0 = z * cfg["j_per_split"]
                count[job, i0:min(a, i0 + cfg["rows"]),
                      j0:min(b, j0 + cfg["j_per_split"]),
                      c0:min(d, c0 + cfg["td"])] += 1
    return count


@pytest.mark.parametrize("B,a,b,d", [
    (1, 1, 1, 1), (2, 5000, 5000, 4), (300, 3, 4, 4), (7, 130, 1000, 64),
    (1, 4096, 4096, 65), (5, 31, 129, 16), (1, 100, 64, 8),
    (2, 5000, 5000, 64), (3, 97, 33, 17), (3, 64, 257, 32),
    (1, 700, 900, 130), (40, 33, 2, 64), (1, 100, 2000, 20)])
def test_launch_config_covers_every_index(B, a, b, d):
    cfg = kernel.launch_config(B, a, b, d, num_sms=132)
    assert cfg["threads"] % 32 == 0 and cfg["threads"] <= kernel.MAX_THREADS
    assert cfg["td"] == kernel.tile_width(d)
    if cfg["td"] == 64:  # the register-blocked tile, 8 x 4 outputs a thread
        assert (cfg["rows"], cfg["threads"]) == (kernel.TILE_ROWS,
                                                 kernel.TILE_THREADS)
        assert cfg["rows"] * 64 == 32 * cfg["threads"]
    else:  # one thread a row
        assert cfg["rows"] == cfg["threads"]
    assert cfg["row_tiles"] * cfg["rows"] >= a
    assert (cfg["row_tiles"] - 1) * cfg["rows"] < a
    assert cfg["td"] in kernel.TD_CHOICES and cfg["td"] * cfg["d_tiles"] >= d
    assert (cfg["d_tiles"] - 1) * cfg["td"] < d
    assert cfg["j_per_split"] % kernel.TB == 0
    # every source index in exactly one split, and no split is empty
    assert cfg["splits"] * cfg["j_per_split"] >= b
    assert (cfg["splits"] - 1) * cfg["j_per_split"] < b
    if cfg["splits"] > 1:  # splitting only where the grid leaves SMs idle
        base = B * cfg["row_tiles"] * cfg["d_tiles"]
        assert base < kernel.BLOCKS_PER_SM * 132
    if B * a * b * d <= 5e6:  # every (row, source) pair in one (block, split)
        assert (_coverage(B, a, b, d, cfg) == 1).all()


def _tries(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return [n.lineno for n in ast.walk(tree)
            if isinstance(n, (ast.Try, ast.TryStar))]


@pytest.mark.parametrize("name", [
    "ops.py", "kernel.py", "../_nvcc.py", "../topo_linear_attention/ops.py",
    "../topo_linear_attention/kernel.py", "../flash_attention/ops.py",
    "../flash_attention/kernel.py", "../linear_attention/ops.py",
    "../linear_attention/kernel.py"])
def test_no_fallback_around_build_or_launch(name):
    """A kernel that fails to build or launch raises: neither the wrappers,
    the loaders nor the shared nvcc build step has a try/except that could
    hand the call to the plain version instead."""
    path = PKG / "kernels" / "fdist_matvec" / name
    assert _tries(path) == [], f"{name} has try blocks at {_tries(path)}"


def test_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = (PKG / "kernels" / "fdist_matvec" / "fdist_matvec.cu").read_text()
    assert "fdist_matvec_batched_pallas" in src
    assert "src/repro/kernels/fdist_matvec/kernel.py" in src
    assert "Bound on an H100" in src
    assert 'extern "C" int fdist_matvec_launch' in src
    # the td = 64 redesign: a register-blocked tile with M built once per
    # block; td = 4 and 16 keep one thread a row
    assert "fdist_tile_kernel" in src and "register-blocked" in src
    assert "constexpr int BI = 64;" in src and kernel.TILE_ROWS == 64
