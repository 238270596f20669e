"""The port on a CUDA card: the fdist_matvec kernel against its plain
version, and `apply(backend="cuda")` against the dense oracle. These tests
need a card (the kernel has no CPU mode) and skip without one; they import
nothing of jax, so they run where only the port is installed:

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
