"""Engine selection shared by the backends: the f-family classification."""
from repro_torch.core.engines.spec import FamilySpec, spec_of  # noqa: F401
