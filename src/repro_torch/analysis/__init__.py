"""Analysis helpers of the port. `trace_guard` is the serving engine's
compile/recompile counter (the reference's pure-stdlib module, copied);
the graph audit and lint of the reference's `repro.analysis` are ROADMAP
A13."""
from repro_torch.analysis import trace_guard  # noqa: F401

__all__ = ["trace_guard"]
