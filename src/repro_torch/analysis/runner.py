"""Assemble the full static-analysis run: audits + lint + trace guard,
diffed against the port's budgets file (`budgets.json` beside this
module): the reference's `analysis/runner.py`.

Used by the CLI (``python -m repro_torch.analysis``) and by tests — both
consume the same ``run_*`` functions so the CI gate and the test suite
can't drift.
"""
from __future__ import annotations

import json
from pathlib import Path

BUDGETS_FILENAME = "budgets.json"


def find_budgets_path(explicit: str | None = None) -> Path:
    if explicit:
        return Path(explicit)
    return Path(__file__).resolve().with_name(BUDGETS_FILENAME)


def load_budgets(path: str | None = None) -> dict:
    with open(find_budgets_path(path)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------


def run_audits(budgets: dict, names: list[str] | None = None,
               sections: list[str] | None = None,
               devices: int = 8) -> dict:
    """Trace + audit every registered entry point (or the named subset).

    Returns ``{"reports": [...], "skipped": [...], "issues": [...]}`` where
    each report is an ``AuditReport.to_dict()``.  An entry name present in
    the registry but missing from the budgets file is itself an issue —
    budgets must cover every registered surface. The sharded entries run
    on a fake group of `entry_points.SHARDED_RANKS` ranks: with another
    `devices` count they are skipped, as the reference skips them without
    8 devices.
    """
    from repro_torch.analysis import entry_points, graph_audit

    entry_budgets = budgets.get("entry_points", {})
    todo = list(entry_points.REGISTRY.values())
    if sections:
        todo = [e for e in todo if e.section in sections]
    if names:
        todo = [e for e in todo if e.name in names]
        missing = set(names) - {e.name for e in todo}
        if missing:
            raise KeyError(f"unknown entry point(s): {sorted(missing)}; "
                           f"known: {sorted(entry_points.REGISTRY)}")

    reports, skipped, issues = [], [], []
    for ep in todo:
        if ep.name not in entry_budgets:
            issues.append(f"audit: no budget declared for registered entry "
                          f"point '{ep.name}' in {BUDGETS_FILENAME}")
            continue
        if ep.section == "sharded" and devices != entry_points.SHARDED_RANKS:
            skipped.append({"name": ep.name, "reason": (
                f"needs a fake group of {entry_points.SHARDED_RANKS} ranks, "
                f"asked for {devices} (--devices)")})
            continue
        try:
            with ep.context():
                fn, args = ep.build()
                rep = graph_audit.audit(fn, *args, name=ep.name,
                                        budget=entry_budgets[ep.name])
        except entry_points.SkipEntry as e:
            skipped.append({"name": ep.name, "reason": str(e)})
            continue
        reports.append(rep.to_dict())
        issues.extend(f"audit[{ep.name}]: {f['kind']} at {f['where']}: "
                      f"{f['detail']}" for f in rep.to_dict()["findings"])
    return {"reports": reports, "skipped": skipped, "issues": issues}


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------


def run_lint(paths: list[str] | None = None) -> dict:
    from repro_torch.analysis import lint

    if not paths:
        paths = [str(Path(__file__).resolve().parents[1])]  # src/repro_torch
    errors = lint.check_paths(paths)
    return {"paths": [str(p) for p in paths],
            "issues": [str(e) for e in errors]}


# ---------------------------------------------------------------------------
# trace guard workload
# ---------------------------------------------------------------------------


def run_trace_guard(budgets: dict) -> dict:
    """Exercise every memoized closure layer twice and assert the second
    pass records nothing new, then diff total counts against the
    ``trace_guard`` budget section. The port compiles nothing: a site
    records on the first call of each (closure or engine, field shape or
    bucket), where the reference's jit traces (`analysis.trace_guard`)."""
    import numpy as np
    import torch

    import repro_torch.ftfi as ftfi
    from repro_torch.analysis import trace_guard as tg
    from repro_torch.core import cordial as C
    from repro_torch.core import masks
    from repro_torch.core.engines.base import Integrator
    from repro_torch.graphs.graph import random_tree

    cpu = "cpu"
    tg.reset()
    issues: list[str] = []
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((64, 2)), dtype=torch.float32)

    def stable(*sites, max_compiles=0):
        return tg.expect_stable(*sites, max_compiles=max_compiles)

    # 1. backend fastmult memo (Integrator facade)
    tree = random_tree(64, seed=0)
    integ = Integrator(tree, backend="torch", device=cpu)
    pf = integ.fastmult(C.Exponential(-0.5))
    pf(X)  # first call records
    try:
        with stable("engines.plan.fastmult"):
            pf(X)
            pf(X)
            integ.fastmult(C.Exponential(-0.5))(X)  # memo: same closure
    except tg.RetraceError as e:
        issues.append(f"trace_guard[backend-memo]: {e}")

    # 2. functional fastmult
    spec, params = ftfi.build(tree, device=cpu)
    fm = ftfi.fastmult(spec, C.Exponential(-0.5), device=cpu)
    fm(params, X)
    try:
        with stable("ftfi.fastmult"):
            fm(params, X)
    except tg.RetraceError as e:
        issues.append(f"trace_guard[ftfi-fastmult]: {e}")

    # 3. mask closure (serving / eval rebuild path): the port builds it on
    # every call (it binds no device data, so it has no memo): the closure
    # records once through `plan_api.fastmult`, then is stable
    coeffs = np.asarray([1.0, -0.5], np.float32)
    F = torch.as_tensor(rng.standard_normal((2, 64, 3)), dtype=torch.float32)
    mfm = masks.make_tree_fastmult(integ, "exp", coeffs, 1.0, device=cpu)
    mfm(F)
    try:
        with stable("engines.plan.fastmult", "ftfi.fastmult"):
            mfm(F)
            mfm(F)
    except tg.RetraceError as e:
        issues.append(f"trace_guard[mask-closure]: {e}")

    # 4. serve decode / prefill buckets
    try:
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.models import api
        from repro_torch.serve.engine import ServeEngine

        cfg = get_smoke_config("llama3_2_1b").replace(dtype="float32")
        model = api.init_params(cfg, 0, device=cpu)
        eng = ServeEngine(cfg, model, batch_slots=2, max_len=32, device=cpu)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        pos = torch.zeros((2,), dtype=torch.int32)
        eng._decode(tok, pos)
        toks = torch.zeros((2, 8), dtype=torch.int32)
        lengths = torch.as_tensor([8, 5], dtype=torch.int32)
        eng._prefill(toks, lengths)
        with stable("serve.decode", "serve.prefill"):
            eng._decode(tok, pos)
            eng._prefill(toks, lengths)
        with stable("serve.prefill", max_compiles=1):
            # a new pow2 bucket is ONE new record, then stable
            big = torch.zeros((2, 16), dtype=torch.int32)
            eng._prefill(big, lengths)
            eng._prefill(big, lengths)
    except tg.RetraceError as e:
        issues.append(f"trace_guard[serve-buckets]: {e}")

    issues.extend(tg.check(budgets.get("trace_guard")))
    return {"stats": tg.stats(), "issues": issues}


# ---------------------------------------------------------------------------
# the full run
# ---------------------------------------------------------------------------


def run_all(budgets_path: str | None = None,
            lint_paths: list[str] | None = None,
            names: list[str] | None = None,
            sections: list[str] | None = None,
            do_audit: bool = True, do_lint: bool = True,
            do_trace: bool = True, devices: int = 8) -> dict:
    budgets = load_budgets(budgets_path)
    out: dict = {"budgets_file": str(find_budgets_path(budgets_path)),
                 "issues": []}
    if do_audit:
        out["audit"] = run_audits(budgets, names=names, sections=sections,
                                  devices=devices)
        out["issues"] += out["audit"]["issues"]
    if do_lint:
        out["lint"] = run_lint(lint_paths)
        out["issues"] += out["lint"]["issues"]
    if do_trace:
        out["trace_guard"] = run_trace_guard(budgets)
        out["issues"] += out["trace_guard"]["issues"]
    out["ok"] = not out["issues"]
    return out
