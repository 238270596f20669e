"""CLI: ``python -m repro_torch.analysis [--all | --audit | --lint |
--trace-guard]``: the reference's ``python -m repro.analysis`` over the
port.

Exit status 0 iff every requested pass is clean against the port's
``budgets.json`` (beside this module).  ``--json PATH`` writes the full
structured report (the CI artifact).  ``--write-budgets`` re-derives the
observed collective census into the budgets file — the
intentional-change flow: run it, eyeball the diff, commit.

``--devices`` is the rank count of the fake process group the sharded
entries run under (`launch.dryrun.fake_group`, in this process): they
need 8, and any other count skips them, as the reference's skip without
8 devices. No environment variable is set first: the port has no
``XLA_FLAGS`` to force.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="FTFI static analysis of the port: graph audits, "
                    "retrace guard, AST lint, diffed against budgets.json")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (audit + lint + trace-guard)")
    ap.add_argument("--audit", action="store_true", help="graph audits")
    ap.add_argument("--lint", action="store_true", help="AST lint")
    ap.add_argument("--trace-guard", action="store_true",
                    help="retrace-sentinel workload")
    ap.add_argument("--entry", action="append", default=None,
                    metavar="NAME", help="audit only this entry point "
                    "(repeatable); implies --audit")
    ap.add_argument("--section", action="append", default=None,
                    help="audit only these sections (core/kernels/models/"
                         "serve/sharded)")
    ap.add_argument("--budgets", default=None,
                    help="path to the budgets file (default: "
                         "src/repro_torch/analysis/budgets.json)")
    ap.add_argument("--lint-paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--json", dest="json_out", default=None,
                    metavar="PATH", help="write the structured report here")
    ap.add_argument("--write-budgets", action="store_true",
                    help="update the budgets file's collective counts to "
                         "the observed census (intentional-change flow)")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the fake process group for sharded "
                         "audits (default 8; any other count skips them)")
    args = ap.parse_args(argv)
    if args.entry:
        args.audit = True
    if args.all or not (args.audit or args.lint or args.trace_guard):
        args.audit = args.lint = args.trace_guard = True
    return args


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)

    from repro_torch.analysis import runner

    report = runner.run_all(
        budgets_path=args.budgets, lint_paths=args.lint_paths,
        names=args.entry, sections=args.section, do_audit=args.audit,
        do_lint=args.lint, do_trace=args.trace_guard,
        devices=args.devices)

    if args.write_budgets and args.audit:
        path = runner.find_budgets_path(args.budgets)
        budgets = runner.load_budgets(args.budgets)
        for rep in report["audit"]["reports"]:
            ent = budgets.setdefault("entry_points", {}).setdefault(
                rep["name"], {})
            ent["collectives"] = rep["collectives"]
        with open(path, "w") as f:
            json.dump(budgets, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"budgets updated: {path}")
        # collective-count findings are now intentional; re-diff
        report = runner.run_all(
            budgets_path=args.budgets, lint_paths=args.lint_paths,
            names=args.entry, sections=args.section, do_audit=args.audit,
            do_lint=args.lint, do_trace=args.trace_guard,
            devices=args.devices)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)

    # human summary
    if args.audit:
        a = report["audit"]
        print(f"audit: {len(a['reports'])} entry point(s), "
              f"{len(a['skipped'])} skipped")
        for rep in a["reports"]:
            cols = ", ".join(f"{k}={v}" for k, v in
                             sorted(rep["collectives"].items())) or "-"
            status = "ok" if rep["ok"] else "FAIL"
            print(f"  [{status}] {rep['name']}  collectives: {cols}  "
                  f"consts: {rep['const_bytes']}B")
        for sk in a["skipped"]:
            print(f"  [skip] {sk['name']}: {sk['reason']}")
    if args.lint:
        print(f"lint: {len(report['lint']['issues'])} issue(s) in "
              f"{', '.join(report['lint']['paths'])}")
    if args.trace_guard:
        sites = report["trace_guard"]["stats"]["sites"]
        print(f"trace-guard: {len(report['trace_guard']['issues'])} "
              f"issue(s); compiles: "
              + (", ".join(f"{k}={v}" for k, v in sites.items()) or "-"))

    if report["issues"]:
        print(f"\n{len(report['issues'])} issue(s):", file=sys.stderr)
        for issue in report["issues"]:
            print(f"  - {issue}", file=sys.stderr)
        return 1
    print("\nstatic analysis clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
