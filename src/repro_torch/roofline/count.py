"""One step's cost on one device, counted from the ops it runs: the port's
counterpart of XLA's `cost_analysis()` and `memory_analysis()` of the
reference's per-device SPMD program.

`CostCount` is a `TorchDispatchMode`. Open it around one step (eager, on
real tensors, or under `FakeTensorMode` where nothing is allocated) and
read `record()`:

  * `flops`: each aten op's flops by `torch.utils.flop_counter`'s
    registry (what `FlopCounterMode` counts: the matmuls, convolutions and
    attention ops), plus each kernel wrapper's formula
    (`roofline/kernels.py`);
  * `bytes_accessed`: each aten op's tensor inputs and outputs, in bytes,
    plus each kernel wrapper's formula. Eager ops are not fused, so this
    is what eager moves. Views (`_unsafe_view` too), `empty`, `detach`,
    ops outside aten (collectives, prims) and transfers between two
    devices that keep the dtype (a host table sent to the card crosses
    PCIe, and on the CPU route needs no op; one that casts counts as the
    cast the CPU route makes) move nothing here;
  * `collective_bytes`: the bytes this rank sends, from the
    `launch.sharding.CollectiveCensus` the count opens (all_gather its
    operand, reduce_scatter its operand = result x group: the reference's
    convention); `collectives` breaks them down by kind beside the calls
    of `launch.collectives`' helpers (their `COUNTS`) while it was open;
  * `argument_size_bytes`, `output_size_bytes`, `temp_size_bytes`,
    `peak_bytes_per_device`: the storages alive. The arguments are those
    passed to `track_arguments`, the outputs those passed to
    `track_outputs` that are not arguments; the peak is the most bytes
    alive at once (arguments included), and temp is what the peak holds
    beyond them, so the three sum to the peak as the reference's do.

A kernel launched through ctypes is no aten op, and the plain version that
stands in for it on CPU or fake tensors is other work. Each wrapper
in `kernels/*/ops.py` runs its forward inside `kernels._count.kernel_call`:
an open count records the kernel's formula once and sees none of the ops
inside, whichever route runs, and its plain version's outputs take the
kernel's layout (`kernels._count.like_kernel`), so the ops after it are
the same ops. So `flops` and `bytes_accessed` read the same work on the
card and in a dry run. Backward: the plain VJPs run on
both routes and are counted as they run; B1's v-grad is B1 itself (its
formula on both routes). Memory is counted as it happens on the route that
runs (the plain version's temporaries are real on the CPU).

The count sees each rank's local tensors: DTensor ops are left to desugar
into them (the mode returns NotImplemented for DTensor arguments), and
DTensor's sharding propagation, which runs an op on global-shape fake
tensors to learn its output's shape, is hidden from it, so all figures are
per device, as the reference's SPMD program's are.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _count

_aten = torch.ops.aten
# ops that move no bytes (allocation without writes, metadata; views the
# schema does not mark as views)
_NO_TRAFFIC = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.detach,
    _aten.alias, _aten.lift_fresh, _aten.lift_fresh_copy,
    _aten._local_scalar_dense, _aten.resize_, _aten.set_,
    _aten._unsafe_view,
})


def _moves_bytes(packet, args, out) -> bool:
    """False for a `_to_copy` between two devices that keeps the dtype: a
    transfer (a host table sent to the card crosses PCIe, and where the
    step holds everything on one device the same line makes no op). One
    that casts moves its bytes as the cast on one device does."""
    if packet is not _aten._to_copy or out.device == args[0].device:
        return True
    return out.dtype != args[0].dtype


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


# DTensor's sharding propagation runs an op once on global-shape fake
# tensors to learn its output's metadata (on a cache miss, so the first
# step of a process): scratch, not this rank's work. While a count is open
# that method runs hidden from it.
_PROPAGATE = "_propagate_tensor_meta_non_cached"
_patched: list = []


def _hide_propagation() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if _patched:
        return
    real = getattr(ShardingPropagator, _PROPAGATE, None)
    if real is None:
        # without it DTensor's global-shape scratch would be counted as
        # this rank's work: refuse rather than skew every record
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"{_PROPAGATE}, so the cost count cannot hide DTensor's "
            "sharding propagation")

    def hidden(*args, **kwargs):
        for c in _count.ACTIVE:
            c.hidden += 1
            c.scratch += 1
        try:
            return real(*args, **kwargs)
        finally:
            for c in _count.ACTIVE:
                c.hidden -= 1
                c.scratch -= 1

    _patched.append(real)
    setattr(ShardingPropagator, _PROPAGATE, hidden)


def _restore_propagation() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if _patched and not _count.ACTIVE:
        setattr(ShardingPropagator, _PROPAGATE, _patched.pop())


class CostCount(TorchDispatchMode):
    """Counts flops, bytes, collectives and live storages of the ops run
    inside it (module docstring). Kernel wrappers record their formulas
    into every open count (`kernels`: name -> calls, flops, bytes)."""

    def __init__(self):
        super().__init__()
        from repro_torch.launch.sharding import CollectiveCensus

        self.census = CollectiveCensus()
        self.flops = 0
        self.bytes_accessed = 0
        self.kernels: dict = {}
        self.hidden = self.scratch = 0
        self.calls: dict = {}  # launch.collectives' calls while open
        self._live: dict = {}  # id(storage) -> bytes
        self.live_bytes = self.peak_bytes = 0
        self._args: set = set()
        self.argument_size_bytes = self.output_size_bytes = 0

    # -- memory ---------------------------------------------------------

    def _track(self, t) -> int:
        """Start tracking t's storage; returns its id."""
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track_arguments(self, *trees) -> None:
        """The step's arguments (parameters, optimizer state, batch; a
        DTensor counts its local shard): alive from the start."""
        for t in _tensors(trees):
            key = self._track(_local(t))
            if key not in self._args:
                self._args.add(key)
                self.argument_size_bytes += self._live[key]

    def track_outputs(self, *trees) -> None:
        """The step's outputs: the storages among them that are not
        arguments (an in-place update is no output)."""
        seen = set()
        for t in _tensors(trees):
            t = _local(t)
            key = id(t.untyped_storage())
            if key in self._args or key in seen:
                continue
            seen.add(key)
            self.output_size_bytes += t.untyped_storage().nbytes()

    # -- kernels --------------------------------------------------------

    def record_kernel(self, name: str, flops: int, nbytes: int) -> None:
        if self.hidden:  # a kernel inside another's forward is its work
            return
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes_accessed += int(nbytes)

    # -- the mode -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if not self.hidden:
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not (func.is_view or func.namespace != "aten"
                    or packet in _NO_TRAFFIC) and _moves_bytes(packet, args,
                                                                out):
                self.bytes_accessed += sum(
                    _nbytes(t) for t in _tensors((args, kwargs, out)))
        if not self.scratch:
            for t in _tensors(out):
                self._track(t)
        return out

    def __enter__(self):
        from repro_torch.launch import collectives

        _hide_propagation()
        self._calls0 = dict(collectives.COUNTS)
        self.census.__enter__()
        super().__enter__()
        _count.ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import collectives

        _count.ACTIVE.remove(self)
        _restore_propagation()
        super().__exit__(*exc)
        self.census.__exit__(*exc)
        self.calls = {k: n - self._calls0.get(k, 0)
                      for k, n in sorted(collectives.COUNTS.items())
                      if n > self._calls0.get(k, 0)}
        return False

    # -- the record -----------------------------------------------------

    def record(self) -> dict:
        """The reference's cost and memory keys, per device, plus the
        kernels' part (`kernels`) and the collectives (`collectives`: the
        census's bytes and counts by kind, and under "calls" the calls of
        `launch.collectives`' helpers while the count was open, forward
        and backward apart)."""
        from repro_torch.roofline.analysis import (collective_breakdown,
                                                   collective_bytes)

        args, outs = self.argument_size_bytes, self.output_size_bytes
        temp = max(self.peak_bytes - args - outs, 0)
        return {
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes_accessed),
            "collective_bytes": collective_bytes(self.census),
            "argument_size_bytes": args,
            "output_size_bytes": outs,
            "temp_size_bytes": temp,
            "peak_bytes_per_device": args + outs + temp,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collectives": dict(collective_breakdown(self.census),
                                calls=dict(self.calls)),
        }
