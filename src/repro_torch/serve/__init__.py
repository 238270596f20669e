"""Serving of the port: the continuous-batching engine (`engine`) and the
per-request forest masks it serves topological prompts with
(`forest_masks`)."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
