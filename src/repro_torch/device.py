"""Device resolution shared by every entry point of the port.

`device=None` means the CUDA card: under an initialized process group the
rank's own, `cuda:(local_rank % device_count)` (`LOCAL_RANK`, else the
global rank, so ranks of one host share its cards round robin). Without a
card the entry points raise: they never carry on silently on the CPU.
Callers that want the CPU (the tests, the plain versions, CPU ranks) pass
`device="cpu"`.
"""
from __future__ import annotations

import os

import torch


def _rank_card() -> torch.device:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return torch.device("cuda")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def resolve_device(device=None) -> torch.device:
    if device is None and torch.cuda.is_available():
        return _rank_card()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
