"""The port's static analysis (`repro_torch.analysis`): the lint against
the reference's lint on the reference's own cases (tests/test_analysis.py,
the sources rewritten for torch where the rule is torch's), the lint clean
on `src/repro_torch`, the budgets covering every registered entry point,
the core, kernels and serve sections auditing clean, the auditor's
findings on a hidden all_gather, a float64 leak, a host read and a bf16
accumulation, the sharded executor's census equal to the reference's
budget, and the trace-guard workload within its budget."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as RL
from repro_torch.analysis import entry_points, graph_audit, lint, runner

ROOT = Path(__file__).resolve().parents[1]

# (reference source, the port's source, the path's tail): the reference's
# lint cases, each rewritten for torch where its rule is torch's
FROZEN = ("def patch(spec, x):\n"
          "    spec.pivots = x\n"
          "    object.__setattr__(spec, 'src_gather', x)\n")
NP_RANDOM = ("import numpy as np\n"
             "a = np.random.randn(4)\n"
             "rng = np.random.default_rng(0)\n"
             "b = rng.standard_normal(4)\n")
LINT_CASES = {
    "frozen-mutation": (FROZEN, FROZEN, "core/patcher.py"),
    "frozen-mutation-noqa": (
        FROZEN.replace("spec.pivots = x", "spec.pivots = x  # noqa: repro-lint"),
        FROZEN.replace("spec.pivots = x", "spec.pivots = x  # noqa: repro-lint"),
        "core/plan_api.py"),
    "legacy-np-random": (NP_RANDOM, NP_RANDOM, "models/foo.py"),
    "traced-host-read": (
        "import jax.numpy as jnp\ndef f(x):\n    s = float(jnp.sum(x))\n"
        "    t = x.item()\n    return s + t\n",
        "import torch\ndef f(x):\n    s = float(torch.sum(x))\n"
        "    t = x.item()\n    return s + t\n", "core/bad.py"),
    "traced-host-read-outside": (
        "import jax.numpy as jnp\ndef f(x):\n    s = float(jnp.sum(x))\n"
        "    t = x.item()\n    return s + t\n",
        "import torch\ndef f(x):\n    s = float(torch.sum(x))\n"
        "    t = x.item()\n    return s + t\n", "launch/ok.py"),
    "x64-flip": ("import jax\njax.config.update('jax_enable_x64', True)\n",
                 "import torch\ntorch.set_default_dtype(torch.float64)\n",
                 "core/bad64.py"),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_gives_the_references_findings(case):
    ref_src, port_src, tail = LINT_CASES[case]
    want = [(e.rule, e.line) for e in
            RL.check_source(ref_src, f"src/repro/{tail}")]
    got = [(e.rule, e.line) for e in
           lint.check_source(port_src, f"src/repro_torch/{tail}")]
    assert got == want, (got, want)
    assert case.endswith(("noqa", "outside")) or got


def test_lint_x64_flip_forms_and_tests_are_free():
    src = ("import torch\ntorch.set_default_dtype(torch.double)\n"
           "torch.set_default_tensor_type(torch.DoubleTensor)\n"
           "torch.set_default_dtype(torch.float32)\n")
    errs = lint.check_source(src, "src/repro_torch/core/a.py")
    assert [(e.rule, e.line) for e in errs] == [("x64-flip", 2),
                                                ("x64-flip", 3)]
    assert lint.check_source(src, "tests/test_something.py") == []
    # a host comparison of dtypes is no device read
    assert lint.check_source("import torch\nn = int(x.dtype == torch.bfloat16)\n",
                             "src/repro_torch/kernels/k.py") == []


def test_lint_clean_on_the_port():
    out = runner.run_lint()
    assert out["paths"] == [str(ROOT / "src" / "repro_torch")]
    assert out["issues"] == [], out["issues"][:10]


def test_budgets_cover_every_registered_entry_point():
    budgets = runner.load_budgets()
    declared = set(budgets["entry_points"])
    registered = set(entry_points.REGISTRY)
    assert declared == registered
    ref = json.loads((ROOT / "ANALYSIS_BUDGETS.json").read_text())
    assert registered == set(ref["entry_points"])
    assert set(budgets["trace_guard"]) == set(ref["trace_guard"])
    for section in ("core", "kernels", "models", "serve", "sharded"):
        assert entry_points.by_section(section), section


@pytest.mark.parametrize("section", ["core", "kernels", "serve", "sharded"])
def test_clean_entry_points_pass(section):
    out = runner.run_audits(runner.load_budgets(), sections=[section])
    assert out["issues"] == [] and out["skipped"] == [], out
    assert len(out["reports"]) == len(entry_points.by_section(section))


def test_hidden_all_gather_flagged():
    """An all_gather on a sharded path the budget does not declare is a
    finding; declared, the same program is clean."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch.dryrun import fake_group

    def fwd(x):
        return C.all_gather(x * 2, None) + 1

    with fake_group(4):
        rep = graph_audit.audit(fwd, torch.ones(2, 3), name="hidden")
        ok = graph_audit.audit(fwd, torch.ones(2, 3), name="declared",
                               budget={"collectives": {"all_gather": 1}})
    assert [(f.kind, f.where) for f in rep.findings] == [
        ("collective", "all_gather")]
    assert rep.collectives == {"all_gather": 1}
    assert ok.ok, ok.summary()


@pytest.mark.parametrize("name", ["sharded.ftfi.fastmult.tree",
                                  "sharded.ftfi.fastmult.forest"])
def test_sharded_census_against_the_references_budget(name):
    """Against the reference's budget for the sharded executor (1
    all_to_all + 1 psum_scatter, zero all_gather) the auditor finds
    nothing: the field enters and leaves sharded by rows (fault C11,
    repaired)."""
    ref = json.loads((ROOT / "ANALYSIS_BUDGETS.json").read_text())
    ep = entry_points.REGISTRY[name]
    with ep.context():
        fn, args = ep.build()
        rep = graph_audit.audit(fn, *args, name=ep.name,
                                budget=ref["entry_points"][ep.name])
    assert rep.findings == [], rep.summary()
    assert rep.collectives == {"all_to_all": 1, "reduce_scatter": 1}


def test_float64_leak_flagged_and_allowed():
    def fwd(x):
        return (x.double() * 2).sum().float()

    rep = graph_audit.audit(fwd, torch.ones(4), name="leak")
    assert {f.kind for f in rep.findings} == {"wide_dtype"}
    ok = graph_audit.audit(fwd, torch.ones(4), name="fft",
                           budget={"allow_dtypes": ["float64"]})
    assert ok.ok, ok.summary()


def test_host_read_and_callback_flagged():
    def fwd(x):
        if bool((x > 0).all()):
            print("positive")
        return x * 2

    rep = graph_audit.audit(fwd, torch.ones(4), name="host")
    assert sorted(f.kind for f in rep.findings) == ["callback", "callback"]
    assert graph_audit.audit(fwd, torch.ones(4), name="host",
                             budget={"allow_callbacks": True}).ok


def test_bf16_accumulation_and_big_constants_flagged():
    w = torch.ones(1 << 19)  # 2 MiB of float32 captured, not an input

    def fwd(x, idx):
        acc = torch.zeros(8, dtype=torch.bfloat16).index_add(0, idx, x)
        return acc.float().sum() + (w * 2).sum()

    rep = graph_audit.audit(fwd, torch.ones(4, dtype=torch.bfloat16),
                            torch.tensor([0, 1, 2, 3]), name="acc")
    assert sorted(f.kind for f in rep.findings) == ["bf16_accum",
                                                    "big_const"]
    assert rep.float_const_bytes == 1 << 21


def test_trace_guard_workload_within_budget():
    out = runner.run_trace_guard(runner.load_budgets())
    assert out["issues"] == [], out["issues"]
    assert out["stats"]["sites"] == {"engines.plan.fastmult": 1,
                                     "ftfi.fastmult": 2, "serve.decode": 1,
                                     "serve.prefill": 2}
