"""Pluggable integration backends behind one `Integrator` API.

    graphs -> IntegratorTree -> IntegrationPlan -> engines -> kernels

Backends (see each module's docstring for the engine matrix):
  host    recursive numpy FTFI + ExpMP       exact, thread-safe, on the host
  torch   bucketed plan executor             exact LDR engines, Hankel on
                                             grids, Chebyshev otherwise
  cuda    plan executor on fdist_matvec      the CUDA kernel for poly/exp/
                                             expq/rational, Hankel on grids
"""
from repro_torch.core.engines.base import (  # noqa: F401
    Integrator, available_backends, get_backend, register_backend,
)
from repro_torch.core.engines.spec import FamilySpec, spec_of  # noqa: F401
from repro_torch.core.engines.plan import (  # noqa: F401
    PlanBackend, execute_plan,
)
from repro_torch.core.engines.host import HostBackend  # noqa: F401
from repro_torch.core.engines.cuda import CudaBackend  # noqa: F401
