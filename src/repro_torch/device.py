"""Device resolution shared by every entry point of the port.

`device=None` means the CUDA card. Without one the entry points raise: they
never carry on silently on the CPU. Callers that want the CPU (the tests,
the plain versions) pass `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
