"""AST lint for repo invariants the type system can't see: the reference's
`analysis/lint.py` over the port (`src/repro_torch` by default).

Rules (suppress a line with a ``# noqa: repro-lint`` comment):

* **frozen-mutation** — no attribute assignment to the frozen ``ITNode`` /
  ``PlanSpec`` dataclasses: ``node.left = ...``, ``spec.pivots = ...`` or
  ``object.__setattr__(...)`` anywhere outside ``plan_api.py`` /
  ``integrator_tree.py`` (the dataclasses' own ``__post_init__`` /
  digest-memo sites).
* **legacy-np-random** — no ``np.random.<fn>()`` module-level legacy API;
  randomness must flow through seeded ``np.random.default_rng`` /
  ``Generator`` objects (or torch Generators).
* **traced-host-read** — inside the ``core``, ``kernels`` and ``models``
  subpackages, no ``.item()`` and no ``float()/int()/bool()`` wrapped
  around a ``torch.`` call: reading a device value into a python
  scalar forces a sync with the card (and breaks a traced graph).
* **x64-flip** — no ``torch.set_default_dtype(torch.float64)`` (or
  ``torch.double``) and no ``torch.set_default_tensor_type(...)`` inside
  ``src/``: the precision policy is the caller's, tests only.

Pure ``ast`` — no third-party dependencies, so the lint runs anywhere the
repo imports.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

# Frozen dataclass field names (ITNode + PlanSpec).  Attribute *writes* to
# these names on a non-self object are flagged; the name sets are disjoint
# enough from mutable-object vocabulary that false positives are rare, and
# noqa covers the rest.
FROZEN_FIELDS = frozenset({
    # ITNode
    "vertex_ids", "depth", "leaf_dists", "pivot", "left", "right",
    "left_ids", "right_ids", "left_d", "right_d", "left_id_d", "right_id_d",
    "left_sorted_ids", "left_seg_starts", "right_sorted_ids",
    "right_seg_starts",
    # PlanSpec
    "pivots", "src_gather", "src_seg", "tgt_gather", "tgt_scatter",
    "children", "root_refs", "job_bucket", "job_row", "leaf_bucket",
    "leaf_row", "path_rows", "path_edges", "cross_piv", "reps", "lcas",
})

LEGACY_NP_RANDOM = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "seed",
    "uniform", "normal", "choice", "permutation", "shuffle", "standard_normal",
    "beta", "binomial", "exponential", "poisson",
})

# files allowed to call object.__setattr__ (frozen-dataclass internals)
SETATTR_ALLOWED = ("plan_api.py", "integrator_tree.py")

# subpackages where host reads of traced values are forbidden
TRACED_SUBPKGS = ("core", "kernels", "models")

NOQA = "noqa: repro-lint"


@dataclasses.dataclass
class LintError:
    path: str
    line: int
    rule: str
    detail: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.detail}"


def _has_torch(node: ast.AST) -> bool:
    """True if the expression tree calls a ``torch.`` function (a tensor
    op; ``v.dtype == torch.bfloat16`` is a host comparison and calls
    none)."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call)
                and _attr_chain(sub.func)[:1] == ["torch"]):
            return True
    return False


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def check_source(src: str, path: str = "<string>") -> list[LintError]:
    """Lint one python source string; ``path`` controls the per-directory
    rule scoping and appears in the errors."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintError(path, e.lineno or 0, "syntax", str(e.msg))]

    lines = src.splitlines()

    def suppressed(lineno: int) -> bool:
        return 0 < lineno <= len(lines) and NOQA in lines[lineno - 1]

    p = Path(path)
    fname = p.name
    in_src = "src" in p.parts and "tests" not in p.parts
    in_traced = in_src and any(sp in p.parts for sp in TRACED_SUBPKGS)
    errors: list[LintError] = []

    def err(node: ast.AST, rule: str, detail: str) -> None:
        if not suppressed(node.lineno):
            errors.append(LintError(path, node.lineno, rule, detail))

    for node in ast.walk(tree):
        # --- frozen-mutation: obj.field = ... on frozen field names ---
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and t.attr in FROZEN_FIELDS
                        and isinstance(t.value, ast.Name)
                        and t.value.id != "self"):
                    err(t, "frozen-mutation",
                        f"assignment to frozen field '{t.value.id}.{t.attr}' "
                        f"(ITNode/PlanSpec are immutable; use dataclasses.replace)")

        # --- calls ---
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)

            # object.__setattr__(spec, "field", ...) outside allowed files
            if chain[-2:] == ["object", "__setattr__"] or chain == ["object", "__setattr__"]:
                if fname not in SETATTR_ALLOWED:
                    err(node, "frozen-mutation",
                        "object.__setattr__ bypasses frozen dataclasses "
                        f"(only {SETATTR_ALLOWED} may)")

            # np.random.<legacy>() — any file
            if (len(chain) >= 3 and chain[0] in ("np", "numpy")
                    and chain[1] == "random" and chain[2] in LEGACY_NP_RANDOM):
                err(node, "legacy-np-random",
                    f"legacy global-state API np.random.{chain[2]}; use a "
                    f"seeded np.random.default_rng(...) Generator")

            if in_traced:
                # .item() anywhere in the traced subpackages
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "item"):
                    err(node, "traced-host-read",
                        ".item() forces a host sync / breaks a traced graph")
                # float(/int(/bool( around a torch expression
                if (isinstance(node.func, ast.Name)
                        and node.func.id in ("float", "int", "bool")
                        and node.args and _has_torch(node.args[0])):
                    err(node, "traced-host-read",
                        f"{node.func.id}() on a torch expression reads the "
                        f"device into a python scalar (a sync); keep it a "
                        f"tensor")

            # torch.set_default_dtype(torch.float64) /
            # torch.set_default_tensor_type(...) inside src/
            if in_src and chain and chain[0] == "torch":
                if chain[-1] == "set_default_tensor_type":
                    err(node, "x64-flip",
                        "set_default_tensor_type inside src/ changes the "
                        "default precision for every caller; tests only")
                elif (chain[-1] == "set_default_dtype" and node.args
                      and _attr_chain(node.args[0])[-1:] in (["float64"],
                                                             ["double"])):
                    err(node, "x64-flip",
                        "set_default_dtype(float64) inside src/ changes "
                        "global precision for every caller; tests only")

    return errors


def check_paths(paths: list[str | Path]) -> list[LintError]:
    """Lint every ``.py`` under the given files/directories."""
    errors: list[LintError] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                src = f.read_text()
            except OSError as e:
                errors.append(LintError(str(f), 0, "io", str(e)))
                continue
            errors.extend(check_source(src, str(f)))
    return errors
