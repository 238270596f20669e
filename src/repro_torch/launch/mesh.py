"""Device meshes over `torch.distributed` process groups, and a launcher of
local rank processes.

A mesh is a `DeviceMesh` with the reference's axis names over the process
group that is already initialized: each rank is one process. Building one
never initializes a group; `run_local` does that for its workers. A mesh
on the card over a gloo group also routes DTensor's collectives through
`torch.distributed`'s own calls (`collectives.route_dtensor_collectives`).

`run_local(fn, nprocs, args)` runs the module-level function
`fn(*args)` in `nprocs` fresh processes (spawn) that form one group on
`backend` ("gloo" on the CPU or on shared cards, "nccl" on cards). The
group meets through a `FileStore` in a temporary directory, so no TCP port
is taken and parallel launches cannot collide. It returns the per-rank
return values in rank order, or raises with the failing rank's traceback.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch

LOCAL_AXES = ("data", "model")


def _mesh(device_type: str | None, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    dev = resolve_device(device_type)
    if dev.type == "cuda":
        import torch.distributed as dist

        from repro_torch.launch import collectives

        # this rank's card, set before the mesh reads LOCAL_RANK as a
        # device index (ranks of one host may share a card)
        torch.cuda.set_device(resolve_device(None))
        if dist.get_backend() == "gloo":
            collectives.route_dtensor_collectives()
    return DeviceMesh(dev.type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"); the group must have that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else LOCAL_AXES
    return _mesh(device_type, shape, axes)


def make_local_mesh(data: int = 2, model: int = 4,
                    device_type: str | None = None):
    """A (data, model) mesh over the initialized group, whose world size
    must be data * model. `device_type` None means the CUDA card; pass
    "cpu" for CPU ranks."""
    return _mesh(device_type, (int(data), int(model)), LOCAL_AXES)


def make_plan_mesh(device_type: str | None = None):
    """A one-axis ("data",) mesh over every rank of the group: the plan's
    leaf blocks over all of them."""
    import torch.distributed as dist

    return _mesh(device_type, (dist.get_world_size(),), ("data",))


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------


def _entry(fn, rank, nprocs, tmp, backend, timeout, args):
    import faulthandler

    import torch.distributed as dist

    # a rank killed by a signal leaves its Python stack on stderr
    faulthandler.enable()

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    out = os.path.join(tmp, f"result{rank}.pt")
    try:
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device(
                "cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(kw["device_id"])
        store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=nprocs,
                                timeout=timedelta(seconds=timeout), **kw)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(("ok", value), out)
    except BaseException:
        torch.save(("error", traceback.format_exc()), out)
        raise


def run_local(fn, nprocs: int, args: tuple = (), *, backend: str = "gloo",
              timeout: float = 900.0) -> list:
    """Run `fn(*args)` on `nprocs` local ranks of one process group and
    return their results in rank order. `fn` must be a module-level
    function (it is pickled by name) and its results picklable by
    `torch.save`. A rank that fails ends the others; the error names it.
    Every process started here is ended before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_entry, args=(fn, r, nprocs, tmp, backend,
                                                  timeout, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 60.0
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(nprocs):
            path = os.path.join(tmp, f"result{r}.pt")
            if not os.path.exists(path):
                results.append(("error", f"rank {r} ended with exit code "
                                f"{procs[r].exitcode} and no result"))
                continue
            results.append(torch.load(path, map_location="cpu",
                                      weights_only=False))
    errors = {r: msg for r, (kind, msg) in enumerate(results)
              if kind == "error"}
    if errors:
        # the rank that failed first, with its traceback where it left one
        r = next((r for r in errors if "no result" not in errors[r]),
                 failed if failed in errors else min(errors))
        raise RuntimeError(f"rank {r} of {nprocs} failed:\n{errors[r]}")
    return [value for _, value in results]
