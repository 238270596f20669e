"""FTFI core of the port: f families, the flat IT builder, plan compilation
and the functional plan API."""
from repro_torch.core.cordial import (  # noqa: F401
    AnyFn, CordialFn, ExpPoly, ExpQuadratic, ExpRational, Exponential,
    Polynomial, Rational, Trigonometric,
)
from repro_torch.core.integrate import (  # noqa: F401
    BTFI, IntegrationPlan, compile_forest_plan, compile_plan,
)
from repro_torch.core.plan_api import PlanParams, PlanSpec  # noqa: F401
