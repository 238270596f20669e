"""FTFI core of the port: f families, the IntegratorTree and the host
integrators, plan compilation, the functional plan API and the
`Integrator` facade over its backends."""
from repro_torch.core.cordial import (  # noqa: F401
    AnyFn, CordialFn, ExpPoly, ExpQuadratic, ExpRational, Exponential,
    Polynomial, Rational, Trigonometric,
)
from repro_torch.core.integrate import (  # noqa: F401
    BTFI, ExpMP, FTFI, IntegrationPlan, clear_plan_cache,
    compile_forest_plan, compile_plan,
)
from repro_torch.core.engines import (  # noqa: F401
    CudaBackend, HostBackend, Integrator, PlanBackend, available_backends,
    execute_plan, get_backend, register_backend,
)
from repro_torch.core.itree_flat import (  # noqa: F401
    FlatIT, build_flat_forest, build_flat_it, clear_flat_cache, flat_stats,
    tree_fingerprint,
)
from repro_torch.core.integrator_tree import (  # noqa: F401
    build_integrator_tree, it_stats,
)
from repro_torch.core.plan_api import PlanParams, PlanSpec  # noqa: F401
from repro_torch.core.plan_guard import (  # noqa: F401
    PlanGuardWarning, PlanValidationError,
)
from repro_torch.graphs.graph import Forest  # noqa: F401
