"""Static analysis of the port: graph auditor, retrace sentinel, AST
lint (the reference's `repro.analysis`). ``python -m
repro_torch.analysis --all`` runs every pass and diffs against
``budgets.json`` beside this module.

``trace_guard`` is imported eagerly (pure stdlib — the serving engine and
the plan layers record into it); the heavier passes load lazily so
``import repro_torch`` never pays for them.
"""
from repro_torch.analysis import trace_guard  # noqa: F401  (light, eager)

_LAZY = ("graph_audit", "lint", "entry_points", "runner")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.analysis.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")


__all__ = ["trace_guard", *_LAZY]
