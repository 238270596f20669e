"""Structural graph auditor for the port's entry points: the counterpart of
the reference's `analysis/jaxpr_audit.py`.

The reference walks the ClosedJaxpr of an entry point. The port has no
jaxpr: `audit` traces the entry with
`torch.fx.experimental.proxy_tensor.make_fx` on CPU tensors (real mode:
the function runs once while every aten op it dispatches is recorded, the
backward and the optimizer's in-place updates included) and walks the
flat aten graph for the reference's four checks, against a declared
budget:

* **collective census** — exact counts per collective kind
  (``all_to_all``, ``reduce_scatter`` (alias ``psum_scatter``),
  ``all_gather``, ``all_reduce`` (alias ``psum``), ``broadcast``): the
  graph's `_c10d_functional` nodes (DTensor's) and `c10d` nodes
  (`torch.distributed`'s in-place calls, `launch/collectives.py`), and a
  `launch.sharding.CollectiveCensus` open around the trace, which sees
  every collective that ran; a kind's count is the larger of the two.
  Any kind not named in the budget must appear zero times, so a hidden
  ``all_gather`` on a sharded path is a finding.
* **dtype discipline** — no float64 or complex128 on any node's output
  (per entry ``allow_dtypes``: the Toeplitz FFTs run in float64 on
  purpose), and low-precision accumulation flagged: an `index_add`,
  `scatter_add`, `scatter_reduce` or accumulating `index_put` whose
  operands and output are bf16/fp16 (torch's matmuls and reductions
  accumulate bf16 in fp32 by themselves, as XLA's do with an f32
  preferred_element_type). int64 is not banned: torch's index operands
  (gather, scatter_add, index_add_, embedding) take int64 only, so every
  index array of the port is int64 where the reference's are int32.
* **baked-in-constant audit** — the `_tensor_constant*` attributes of the
  traced module: tensors the function captured instead of taking as
  inputs. Float constants are gated tightly (weights traced as
  constants), the total loosely (plan index arrays are intended
  trace-time constants).
* **host reads and callbacks** — `aten._local_scalar_dense` (`.item()`,
  `bool()`, `int()` of a tensor: a sync with the card), and Python calls
  that leave the graph while it is traced (`print`, `Tensor.numpy`,
  `Tensor.tolist`).

The report is the reference's dataclass and JSON; ``audit(...)`` raises
nothing — gating is the caller's choice.
"""
from __future__ import annotations

import builtins
import contextlib
import dataclasses
from typing import Any

import torch

_aten = torch.ops.aten

_ALIASES = {"psum_scatter": "reduce_scatter", "psum": "all_reduce"}

# low-precision accumulation: these add into a tensor in its own dtype
ACCUM_OPS = frozenset({_aten.index_add, _aten.scatter_add,
                       _aten.scatter_reduce, _aten.index_put})

WIDE_DTYPES = frozenset({"float64", "complex128"})
_LOW_PRECISION = frozenset({"bfloat16", "float16"})
_HOST_READ = _aten._local_scalar_dense

DEFAULT_BUDGET: dict[str, Any] = {
    "collectives": {},              # kind -> exact count; unlisted -> 0
    "allow_dtypes": [],             # wide dtypes to tolerate
    "max_float_const_bytes": 1 << 20,   # 1 MiB of float consts
    "max_const_bytes": 64 << 20,        # 64 MiB total (index arrays OK)
    "require_f32_accum": True,
    "allow_callbacks": False,
}


@dataclasses.dataclass
class Finding:
    kind: str      # collective | wide_dtype | bf16_accum | big_const | callback
    where: str     # the graph node, e.g. "mul_3", or a kind
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.where}: {self.detail}"


@dataclasses.dataclass
class AuditReport:
    name: str
    collectives: dict[str, int]
    prim_counts: dict[str, int]
    const_bytes: int
    float_const_bytes: int
    biggest_const: dict | None
    findings: list[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def summary(self) -> str:
        status = "ok" if self.ok else f"{len(self.findings)} finding(s)"
        cols = ", ".join(f"{k}={v}" for k, v in sorted(self.collectives.items())) or "none"
        lines = [f"{self.name}: {status}  collectives: {cols}  "
                 f"consts: {self.const_bytes}B ({self.float_const_bytes}B float)"]
        lines += [f"  - {f}" for f in self.findings]
        return "\n".join(lines)


@dataclasses.dataclass
class Traced:
    """A traced entry point: the aten graph, the collectives that ran
    (a CollectiveCensus's counts) and the Python calls that left the
    graph while it was traced."""
    gm: torch.fx.GraphModule
    census: dict
    escapes: list


@contextlib.contextmanager
def _escapes():
    """Records print / Tensor.numpy / Tensor.tolist calls made inside."""
    seen: list[str] = []
    patched = [(builtins, "print"), (torch.Tensor, "numpy"),
               (torch.Tensor, "tolist")]
    saved = [getattr(owner, name) for owner, name in patched]

    def spy(label, real):
        def call(*a, **k):
            seen.append(label)
            return real(*a, **k)
        return call

    for (owner, name), real in zip(patched, saved):
        setattr(owner, name, spy(name, real))
    try:
        yield seen
    finally:
        for (owner, name), real in zip(patched, saved):
            setattr(owner, name, real)


def trace(fn, *args) -> Traced:
    """make_fx of fn(*args) (real mode) inside a CollectiveCensus. Tensors
    fn reads must be among args (or reachable from them) to be inputs:
    any other tensor it touches is baked in as a constant."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.launch.sharding import CollectiveCensus

    with CollectiveCensus() as cen, _escapes() as esc:
        # a host read is recorded (`_local_scalar_dense`) and the trace
        # goes on with the real value, so the audit can report it
        gm = make_fx(fn, _error_on_data_dependent_ops=False)(*args)
    return Traced(gm, dict(cen.counts), list(esc))


def _collective_kinds() -> dict:
    from repro_torch.launch.sharding import _collective_kinds

    return {packet: kind for packet, (kind, _) in _collective_kinds().items()}


def _calls(gm):
    for node in gm.graph.nodes:
        if node.op == "call_function" and isinstance(
                node.target, torch._ops.OpOverload):
            yield node, node.target._overloadpacket


def _op_name(node) -> str:
    """The node's op without its overload: "aten.mul"."""
    return ".".join(str(node.target).split(".")[:2])


def _dtypes(val) -> set[str]:
    from torch.utils._pytree import tree_flatten

    return {str(t.dtype).removeprefix("torch.")
            for t in tree_flatten(val)[0] if isinstance(t, torch.Tensor)}


def collective_census(traced: Traced) -> dict[str, int]:
    kinds = _collective_kinds()
    graph: dict[str, int] = {}
    for _node, packet in _calls(traced.gm):
        kind = kinds.get(packet)
        if kind is not None:
            graph[kind] = graph.get(kind, 0) + 1
    return {k: max(graph.get(k, 0), traced.census.get(k, 0))
            for k in sorted(set(graph) | set(traced.census))}


def _constants(gm):
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            val = getattr(gm, node.target, None)
            if isinstance(val, torch.Tensor):
                yield node.target, val


def audit(fn, *args, name: str = "entry",
          budget: dict | None = None) -> AuditReport:
    """Trace ``fn`` on ``args`` and audit it against ``budget`` (missing
    keys fall back to :data:`DEFAULT_BUDGET`)."""
    b = dict(DEFAULT_BUDGET)
    b.update(budget or {})
    traced = trace(fn, *args)
    gm = traced.gm

    findings: list[Finding] = []
    prim_counts: dict[str, int] = {}
    forbidden = WIDE_DTYPES - set(b.get("allow_dtypes") or ())

    # --- pass 1: per-node census + dtype + host reads ---
    for node, packet in _calls(gm):
        pname = _op_name(node)
        prim_counts[pname] = prim_counts.get(pname, 0) + 1
        where = node.name

        if not b["allow_callbacks"] and packet is _HOST_READ:
            findings.append(Finding(
                "callback", where,
                "host read of a tensor value (.item()/bool()/int()) in the "
                "traced program"))

        dts = _dtypes(node.meta.get("val"))
        bad = sorted(dts & forbidden)
        if bad:
            findings.append(Finding(
                "wide_dtype", where, f"{pname} output has dtype {bad[0]}"))

        if b["require_f32_accum"] and packet in ACCUM_OPS:
            accumulate = (packet is not _aten.index_put
                          or (len(node.args) > 3 and node.args[3]))
            in_dts = set().union(*(_dtypes(a.meta.get("val"))
                                   for a in node.args
                                   if isinstance(a, torch.fx.Node)))
            if accumulate and in_dts & _LOW_PRECISION and dts & _LOW_PRECISION:
                findings.append(Finding(
                    "bf16_accum", where,
                    f"{pname} accumulates in {sorted(dts & _LOW_PRECISION)} "
                    f"under low-precision inputs (want an fp32 "
                    f"accumulator)"))

    if not b["allow_callbacks"]:
        for label in sorted(set(traced.escapes)):
            findings.append(Finding(
                "callback", label,
                f"{traced.escapes.count(label)} call(s) of {label} while "
                f"the program was traced (host callback / debug output)"))

    # --- pass 2: collective budget diff ---
    census = collective_census(traced)
    declared = {_ALIASES.get(k, k): int(v)
                for k, v in (b.get("collectives") or {}).items()}
    for kind in sorted(set(census) | set(declared)):
        want, got = declared.get(kind, 0), census.get(kind, 0)
        if got != want:
            findings.append(Finding(
                "collective", kind,
                f"{got} occurrence(s) of '{kind}' (budget {want})"))

    # --- pass 3: constants: dtypes + baked-in-constant audit ---
    total = fl_total = 0
    biggest: dict | None = None
    max_fl = int(b["max_float_const_bytes"])
    for cname, c in _constants(gm):
        dt = str(c.dtype).removeprefix("torch.")
        if dt in forbidden:
            findings.append(Finding(
                "wide_dtype", cname, f"captured constant traced as {dt}"))
        nb = c.numel() * c.element_size()
        total += nb
        is_float = c.is_floating_point() or c.is_complex()
        if is_float:
            fl_total += nb
        if biggest is None or nb > biggest["bytes"]:
            biggest = {"bytes": nb, "dtype": dt, "where": cname,
                       "shape": list(c.shape)}
        if is_float and nb > max_fl:
            findings.append(Finding(
                "big_const", cname,
                f"{nb} B {dt} array baked into the trace as a constant "
                f"(budget {max_fl} B) — weights traced as constants?"))
    if total > int(b["max_const_bytes"]):
        findings.append(Finding(
            "big_const", "const",
            f"total captured constants {total} B exceed budget "
            f"{int(b['max_const_bytes'])} B"))

    return AuditReport(name=name, collectives=census,
                       prim_counts=dict(sorted(prim_counts.items())),
                       const_bytes=total, float_const_bytes=fl_total,
                       biggest_const=biggest, findings=findings)

