"""Public functional plan API of the PyTorch port.

    from repro_torch import ftfi

    spec, params = ftfi.build(tree)                  # host plan, params on the card
    Y = ftfi.apply(spec, params, Exponential(-0.5), X, backend="cuda")
    fm = ftfi.fastmult(spec, fn, backend="cuda")     # (params, X) -> Y
    ftfi.save_plan("plan.npz", spec, params)
    spec, params = ftfi.load_plan("plan.npz")        # also reads the
                                                     # reference's artifacts

Backends: "torch" (plain engines; the reference's "plan") and "cuda" (the
fdist_matvec kernel for poly/exp/expq/rational; the reference's "pallas").
Every entry point takes `device=None`, meaning the CUDA card; pass
`device="cpu"` to run on the CPU, where "cuda" uses the kernel's plain
version.
"""
from repro_torch.core.plan_api import (  # noqa: F401
    BACKENDS, KERNEL_MODES, PlanParams, PlanSpec, PlanValidationError, apply,
    build, describe, fastmult, from_numpy, load_plan, save_plan, specialize)
