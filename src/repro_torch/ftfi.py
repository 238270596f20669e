"""Public functional plan API of the PyTorch port.

    from repro_torch import ftfi

    spec, params = ftfi.build(tree)                  # host plan, params on the card
    Y = ftfi.apply(spec, params, Exponential(-0.5), X, backend="cuda")
    fm = ftfi.fastmult(spec, fn, backend="cuda")     # (params, X) -> Y
    ftfi.save_plan("plan.npz", spec, params)
    spec, params = ftfi.load_plan("plan.npz")        # also reads the
                                                     # reference's artifacts

    # learnable tree metrics
    spec, params = ftfi.build(tree, reweightable=True)
    params = ftfi.reweight(spec, edge_w)             # differentiable in edge_w

    # incremental edits: patch a compiled plan instead of rebuilding
    spec, params = ftfi.update_plan(spec, params, [
        ("insert_leaf", parent, w),   # new leaf under `parent`
        ("delete_leaf", v),           # degree-1 vertex -> zeroed ghost row
        ("reweight", edge_w),         # replace all edge weights
    ])

    # disk-persistent plan cache: set FTFI_PLAN_CACHE=/path (or call
    # ftfi.plan_cache.configure(path)) and every build over a known
    # topology becomes one npz read; LRU-evicted past
    # FTFI_PLAN_CACHE_MAX_MB (default 512). Keys and files are the
    # reference's: one directory serves both packages.

    # robustness: artifacts are validated on load / cache hit / update
    # under the FTFI_PLAN_GUARD policy (strict|warn|off), and the resilient
    # entry points demote cuda -> torch -> host on a kernel failure or a
    # non-finite output on CPU tensors (on the card: DeviceRungError)
    ftfi.validate(spec, params)                      # PlanValidationError
    Y = ftfi.apply_resilient(spec, params, fn, X, backend="cuda")
    fm = ftfi.resilient_fastmult(spec, fn)           # sticky demotions

Backends: "torch" (plain engines; the reference's "plan"), "cuda" (the
fdist_matvec kernel for poly/exp/expq/rational; the reference's "pallas")
and "auto" ("cuda" from `ladder.AUTO_CUDA_MIN_N` vertices up, else
"torch"; env `FTFI_AUTO_CUDA_MIN_N`). Every entry point takes
`device=None`, meaning the CUDA card; pass `device="cpu"` to run on the
CPU, where "cuda" uses the kernel's plain version.

Sharded execution: every rank of a process group (one process a device)
calls the same entry point with the same field and gets the whole result.

    from repro_torch.launch import mesh as M, sharding
    # in each rank (e.g. started by M.run_local(fn, 4)):
    mesh = M.make_plan_mesh()                        # ("data",) over the group
    with sharding.use_sharding(mesh):                # or pass mesh=...
        Y = ftfi.apply_sharded(spec, params, fn, X)  # == apply(...) to round-off
        fm = ftfi.sharded_fastmult(spec, fn)         # (params, X) -> Y
    Y = ftfi.apply(spec, params, fn, X, mesh=mesh)   # the same route
    ftfi.save_plan("plan.npz", spec, params, mesh=mesh)  # stamps the mesh
    ftfi.shard_stats(spec, num_shards)               # block/halo/work stats
"""
from repro_torch.core import ladder, plan_cache, plan_guard  # noqa: F401
from repro_torch.core.ladder import (  # noqa: F401
    BackendDemotionWarning, DeviceRungError, apply_resilient,
    resilient_fastmult)
from repro_torch.core.plan_api import (  # noqa: F401
    BACKENDS, KERNEL_MODES, PlanParams, PlanSpec, apply, build, describe,
    fastmult, from_numpy, load_plan, plan_from_spec, reweight, save_plan,
    specialize, update_plan)
from repro_torch.core.plan_guard import (  # noqa: F401
    PlanValidationError, validate)
from repro_torch.core.plan_shard import (  # noqa: F401
    SHARD_LAYOUT_VERSION, apply_sharded, partition_plan, shard_stats,
    sharded_fastmult)
