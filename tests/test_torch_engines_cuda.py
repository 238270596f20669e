"""The `Integrator` facade on a CUDA card: backend "cuda" with no device
argument launches B1 once per cross bucket and equals `ftfi.apply` bit for
bit and BTFI within 1e-5; the ViT grid's build probe raises on the card
and never demotes. These tests need a card and skip without one; they
import nothing of jax:

    PYTHONPATH=src python -m pytest tests/test_torch_engines_cuda.py -q
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch import ftfi as TF  # noqa: E402
from repro_torch.core import Integrator  # noqa: E402
from repro_torch.core import cordial as TC  # noqa: E402
from repro_torch.core import ladder  # noqa: E402
from repro_torch.core.engines import spec_of  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.kernels.fdist_matvec import ops  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

TOL = 1e-5  # tests/test_engines.py:51
KERNEL_FNS = {
    "Polynomial": TC.Polynomial((0.5, -0.2, 0.1)),
    "Exponential": TC.Exponential(-0.7, 1.3),
    "ExpQuadratic": TC.ExpQuadratic(-0.05, -0.2, 0.1),
    "Rational": TC.Rational((2.0,), (1.0, 0.0, 0.8)),
}


def _rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fname", list(KERNEL_FNS))
def test_integrator_cuda_on_the_card(fname, cuda_device):
    """`Integrator(tree, backend="cuda")` with no device runs on the card:
    one B1 launch per cross bucket, `ftfi.apply`'s output bit for bit,
    within 1e-5 of BTFI."""
    from repro_torch.core.integrate import BTFI

    tree = TG.random_tree(600, seed=2)
    integ = Integrator(tree, backend="cuda", leaf_size=32)
    fn = KERNEL_FNS[fname]
    X = torch.randn(600, 4, device=cuda_device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            before = ops.LAUNCHES
            y = integ.integrate(fn, X)
            torch.cuda.synchronize()
            launched = ops.LAUNCHES - before
            want = TF.apply(integ.spec, integ.params, fn, X, backend="cuda",
                            device=cuda_device)
        finally:
            torch.use_deterministic_algorithms(False)
    assert y.device.type == "cuda" and launched == len(
        integ.spec.cross_tgt_d0) > 0
    assert torch.equal(y, want)
    assert _rel(y, BTFI(tree, device=cuda_device).integrate(fn, X)) <= TOL
    assert integ.describe(fn)["cross_engine"] == (
        f"fdist_matvec:{spec_of(fn).mode}")


@pytest.mark.cuda
def test_vit_grid_probe_raises_on_the_card(monkeypatch, cuda_device):
    """On the card a failed grid probe raises `DeviceRungError`: no rung
    is blocked and nothing demotes."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.lru import BoundedLRU
    from repro_torch.models import vit as TV

    monkeypatch.setattr(TV, "_GRID_INTEGRATOR_CACHE", BoundedLRU(8))
    cfg = get_smoke_config("topovit_b16").replace(topo_attn_impl="cuda")
    ladder.reset_stats()
    with faults.injected("ladder.cuda", faults.always_raise()), \
            warnings.catch_warnings():
        warnings.simplefilter("error", ladder.BackendDemotionWarning)
        with pytest.raises(ladder.DeviceRungError, match="on the card"):
            TV.build_grid_integrator(cfg, device=cuda_device)
    assert ladder.stats()["blocked"] == {}
    before = ops.LAUNCHES
    assert TV.build_grid_integrator(cfg, device=cuda_device).backend == "cuda"
    assert ops.LAUNCHES == before  # the ViT's mask family: no B1 launch
