"""What a kernel wrapper tells an open cost count, and how it tells a
tensor that holds data from one that holds only shapes.

`roofline.count.CostCount` counts one step's flops and bytes from the aten
ops it sees. A kernel launched through ctypes is no aten op, and the plain
version that stands in for it on the CPU is many ops of other work. So each
wrapper puts its forward inside `kernel_call(name, work)`: while a count
is open, the count records `work()` = (bytes, operations, ...), one of
`roofline/kernels.py`'s formulas, under `name`, and sees none of the ops
inside. The count then reads the same work whether the CUDA kernel ran
or its plain version did.

`shapes_only(t)` is the wrapper's test for a FakeTensor (`FakeTensorMode`:
the dry run, the plain route of a count): such a tensor takes the plain
version, for its shapes, and never reaches ctypes, whatever device it
names. A real CUDA tensor still launches the kernel, and a plain tensor on
the meta device is refused as before (no kernel runs there).

`like_kernel(outs, bufs)` gives the plain version's outputs the layout of
the buffers the kernel writes (each kernel module's `out_buffer(s)`), so
the ops after a wrapper read the same strides on every route: a copy that
a transposed plain output forces on one route only would be counted on
that route only.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import is_fake

# the open counts (roofline.count.CostCount), innermost last
ACTIVE: list = []


def shapes_only(t) -> bool:
    """True for a FakeTensor: shapes with no data behind them."""
    return is_fake(t)


def like_kernel(outs, bufs):
    """The plain version's output(s) `outs`, each in its kernel buffer of
    `bufs` (same shapes and dtypes) where their strides differ."""
    if isinstance(outs, tuple):
        return tuple(like_kernel(o, b) for o, b in zip(outs, bufs))
    return outs if outs.stride() == bufs.stride() else bufs.copy_(outs)


class kernel_call:
    """Context around a kernel wrapper's forward: each open count records
    the (bytes, operations) that `work()` leads with under `name` once,
    and counts no op inside. `work` is called only while a count is
    open."""

    __slots__ = ("name", "work", "counts")

    def __init__(self, name: str, work):
        self.name, self.work, self.counts = name, work, ()

    def __enter__(self):
        if ACTIVE:
            nbytes, flops = self.work()[:2]
            self.counts = tuple(ACTIVE)
            for c in self.counts:
                c.record_kernel(self.name, flops, nbytes)
                c.hidden += 1
        return self

    def __exit__(self, *exc):
        for c in self.counts:
            c.hidden -= 1
        return False
