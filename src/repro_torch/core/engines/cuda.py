"""`cuda` backend: the plan executor with its cross multiplies on the
hand-written fdist_matvec kernel (`kernels/fdist_matvec/fdist_matvec.cu`).

Per-bucket cross jobs (B, U_t) x (B, U_s) go straight into
`fdist_matvec_batched`, one launch a bucket, for the in-kernel f families
(poly / exp / expq / rational): each tile of M is built in registers and
shared memory, never materialized in memory. Engine selection and the
executor live in the functional core (`plan_api.select_cross` routes these
families to the kernel whenever backend == "cuda"); other families take
the exact Hankel/FFT engine on grid-aligned trees, else batched Chebyshev.
The kernel reads the *params* distance arrays, so it runs on
`ftfi.reweight`ed distances too. The kernel has no tuning options (its
d-tile follows the field's width), so nothing but this backend's name
keys its closures in the shared memo. On CPU tensors (`device="cpu"`)
the kernel's wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from repro_torch.core.engines.base import register_backend
from repro_torch.core.engines.plan import PlanBackend


@register_backend("cuda")
class CudaBackend(PlanBackend):
    name = "cuda"
