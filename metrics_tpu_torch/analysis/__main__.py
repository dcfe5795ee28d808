"""``python -m metrics_tpu_torch.analysis`` — the port's tmlint/tmsan/tmrace/tmown CLI.

Usage:
    python -m metrics_tpu_torch.analysis metrics_tpu_torch/            # lint on the card
    python -m metrics_tpu_torch.analysis metrics_tpu_torch/ --device cpu
    python -m metrics_tpu_torch.analysis --san --device cpu            # + abstract traces on fake tensors
    python -m metrics_tpu_torch.analysis --san --write-costs           # on the card: refresh san_costs.json
    python -m metrics_tpu_torch.analysis --race                        # thread-safety tier
    python -m metrics_tpu_torch.analysis --own                         # buffer-ownership tier
    python -m metrics_tpu_torch.analysis --own --write-drift           # refresh tmown_engine_drift.json
    python -m metrics_tpu_torch.analysis --card                        # + the card's crosscheck
    python -m metrics_tpu_torch.analysis --explain TM-HOSTSYNC         # rule rationale
    python -m metrics_tpu_torch.analysis metrics_tpu_torch/ --json     # machine-readable
    python -m metrics_tpu_torch.analysis metrics_tpu_torch/ --write-baseline

Exit codes: 0 = clean (or fully baselined), 1 = new findings, 2 = usage error.
"""
import argparse
import json
import os
import sys

from metrics_tpu_torch.analysis import baseline as baseline_mod
from metrics_tpu_torch.analysis.findings import RULES, explain
from metrics_tpu_torch.analysis.runner import PACKAGE, _find_repo_root, analyze


def _default_target() -> str:
    """The package beside this file's parent: the checkout's ``metrics_tpu_torch/``."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.analysis",
        description=(
            "tmlint for metrics_tpu_torch: static analysis for trace safety (TM-HOSTSYNC, "
            "TM-PYBRANCH, TM-DYNSHAPE), the Metric state contract (TM-STATE-UNREG, "
            "TM-REDUCE-MISMATCH, TM-PERSIST), and recapture hazards (TM-RETRACE); "
            "tmsan's abstract traces and cost budget (--san); tmrace (--race); tmown "
            "(--own); the card's crosscheck (--card). Findings are "
            "cross-linked to metrics_tpu_torch.obs counter names."
        ),
    )
    parser.add_argument("paths", nargs="*", help=f"package dir or file to lint (default: {PACKAGE}/)")
    parser.add_argument("--explain", metavar="RULE", help="print a rule's rationale and obs cross-link, then exit")
    parser.add_argument(
        "--baseline", metavar="FILE",
        help=f"waiver file (default: {PACKAGE}/analysis/{baseline_mod.BASELINE_FILENAME})",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write/overwrite the baseline waiving every current finding (edit a reason into each afterwards)",
    )
    parser.add_argument("--select", metavar="RULES", help="comma-separated rule ids to report (default: all)")
    parser.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    parser.add_argument("--no-introspect", action="store_true", help="AST rules only (build no metric)")
    parser.add_argument(
        "--device", default="cuda",
        help="device the introspection tier builds every metric on (default: cuda; without a card it "
        "raises unless given cpu)",
    )
    parser.add_argument(
        "--race",
        action="store_true",
        help="run tmrace, the concurrency tier: build the thread-role model "
        "(spawns, handler installs, @thread_role/@locked_by annotations), "
        "check lock discipline (TMR-UNLOCKED), the lock-order deadlock graph "
        "(TMR-ORDER), host work under hot locks (TMR-HOLD-HOST), "
        "signal/atexit/excepthook safety (TMR-HANDLER), and thread leaks (TMR-LEAK)",
    )
    parser.add_argument(
        "--card",
        action="store_true",
        help="also run the card tier: every budgeted class's update traced on the card under "
        "torch.cuda.set_sync_debug_mode, its synchronising lines held against tmlint's "
        "TM-HOSTSYNC findings and waivers (TMS-LINTGAP, TMS-STALE-WAIVER); needs a card",
    )
    parser.add_argument(
        "--san",
        action="store_true",
        help="also run tmsan's abstract tier: trace every budgeted class's update and compute on fake "
        "tensors of --device (FakeTensorMode: nothing executes), read the traces for host reads "
        "(TMS-CALLBACK), float64 (TMS-F64), bf16 states widened (TMS-UPCAST), big host constants "
        "(TMS-BIGCONST), collectives (TMS-COLLECTIVE) and data-dependent shapes (TMS-DYNSHAPE), hold the "
        "traced costs against san_costs.json (TMS-BUDGET), and crosscheck tmlint (TMS-LINTGAP, "
        "TMS-STALE-WAIVER)",
    )
    parser.add_argument(
        "--own",
        action="store_true",
        help="run tmown, the buffer-ownership tier: model the lifetime of tensors written in place by "
        "captured steps and in-place accumulations (TMO-DONATE-ALIAS, TMO-USE-AFTER-DONATE, "
        "TMO-DOUBLE-DONATE), the snapshot guard (TMO-SNAPSHOT-GAP), step-cache keys (TMO-KEY-GAP), and "
        "the launch engines' contract drift (TMO-ENGINE-DRIFT)",
    )
    parser.add_argument(
        "--write-drift",
        action="store_true",
        help="with --own: write/refresh the engine worksheet tmown_engine_drift.json",
    )
    parser.add_argument(
        "--write-costs",
        action="store_true",
        help="with --san: write/refresh san_costs.json from the traced costs (run it on the card, on "
        "fake cuda tensors; commit the diff with its explanation)",
    )
    parser.add_argument("--costs", metavar="FILE",
                        help="cost-budget file (default: metrics_tpu_torch/analysis/san_costs.json)")
    parser.add_argument("--no-costs", action="store_true", help="with --san: skip the cost budget (trace rules only)")
    parser.add_argument("-v", "--verbose", action="store_true", help="also list waived findings and skipped classes")
    args = parser.parse_args(argv)

    if args.explain:
        rule = args.explain.upper()
        if rule not in RULES:
            print(f"unknown rule {args.explain!r}; known: {', '.join(sorted(RULES))}", file=sys.stderr)
            return 2
        print(explain(rule))
        return 0

    paths = args.paths or [_default_target()]
    if len(paths) != 1:
        # one tree per run keeps repo-relative baseline keys unambiguous
        print("lint exactly one root per run (got: %s)" % ", ".join(paths), file=sys.stderr)
        return 2
    if sum(map(bool, (args.race, args.card, args.san, args.own))) > 1:
        print("--race, --card, --san and --own are separate runs", file=sys.stderr)
        return 2
    if (args.write_costs or args.costs or args.no_costs) and not args.san:
        print("--write-costs, --costs and --no-costs go with --san", file=sys.stderr)
        return 2
    if args.write_drift and not args.own:
        print("--write-drift goes with --own", file=sys.stderr)
        return 2

    selected = None
    if args.select:
        selected = {r.strip().upper() for r in args.select.split(",")}
        unknown = selected - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    def keep(f):
        return selected is None or f.rule in selected

    if args.race:
        return _main_race(args, paths[0], keep)
    if args.card:
        return _main_card(args, paths[0], keep)
    if args.san:
        return _main_san(args, paths[0], keep)
    if args.own:
        return _main_own(args, paths[0], keep)

    try:
        report = analyze(paths[0], baseline_path=args.baseline, introspect=not args.no_introspect,
                         device=args.device)
    except FileNotFoundError as err:
        print(f"tmlint: {err}", file=sys.stderr)
        return 2

    if args.write_baseline:
        return _write_baseline("tmlint", args, paths[0], [f for f in report.findings if keep(f)])

    new = [f for f in report.new_findings if keep(f)]
    if args.json:
        print(
            json.dumps(
                {
                    "stats": report.stats,
                    "new": [vars(f) for f in new],
                    "waived": [vars(f) for f in report.waived if keep(f)],
                    "unused_waivers": [list(k) for k in report.unused_waivers],
                    "skipped_classes": report.skipped_classes,
                    "parse_errors": report.parse_errors,
                },
                indent=2,
            )
        )
        return 1 if new else 0

    for f in new:
        print(f.format())
    if args.verbose:
        for f in report.waived:
            if keep(f):
                print(f.format() + f"  # reason: {f.waive_reason}")
        for name, reason in sorted(report.skipped_classes.items()):
            print(f"# not introspected: {name}: {reason}")
    _print_tail(report.unused_waivers, report.parse_errors)
    s = report.stats
    print(
        f"tmlint: {s['files']} files, {s['functions']} functions "
        f"({s['trace_reachable']} trace-reachable), {s['findings']} findings "
        f"({s['waived']} waived, {len(new)} new) in {s['seconds']}s"
    )
    return 1 if new else 0


def _print_tail(unused, parse_errors) -> None:
    for key in unused:
        print(f"# stale waiver (no matching finding): {':'.join(key)}")
    for path, err in sorted(parse_errors.items()):
        print(f"# parse error: {path}: {err}")


def _write_baseline(tier: str, args, target: str, findings) -> int:
    out = args.baseline or os.path.join(_find_repo_root(target), PACKAGE, "analysis", baseline_mod.BASELINE_FILENAME)
    n = baseline_mod.write_baseline(out, findings, reason="")
    print(f"{tier}: wrote {n} waivers to {out}; give each one its reason")
    return 0


def _main_race(args, target: str, keep) -> int:
    """The --race path: the tmrace concurrency tier on its own."""
    from metrics_tpu_torch.analysis.race.runner import run_race

    try:
        report = run_race(target, baseline_path=args.baseline)
    except FileNotFoundError as err:
        print(f"tmrace: {err}", file=sys.stderr)
        return 2

    if args.write_baseline:
        return _write_baseline("tmrace", args, target, [f for f in report.findings if keep(f)])

    new = [f for f in report.new_findings if keep(f)]
    if args.json:
        print(
            json.dumps(
                {
                    "stats": report.stats,
                    "roles": report.roles,
                    "new": [vars(f) for f in new],
                    "waived": [vars(f) for f in report.waived if keep(f)],
                    "unused_waivers": [list(k) for k in report.unused_waivers],
                    "parse_errors": report.parse_errors,
                },
                indent=2,
            )
        )
        return 1 if new else 0

    for f in new:
        print(f.format())
    if args.verbose:
        for f in report.waived:
            if keep(f):
                print(f.format() + f"  # reason: {f.waive_reason}")
        for role, n in sorted(report.roles.items()):
            print(f"# role {role}: {n} functions")
    _print_tail(report.unused_waivers, report.parse_errors)
    s = report.stats
    print(
        f"tmrace: {s['files']} files, {s['functions']} functions, "
        f"{s['locks']} locks, {s['roles']} roles, {s['threads']} thread spawns, "
        f"{s['findings']} findings ({s['waived']} waived, {len(new)} new) "
        f"in {s['seconds']}s"
    )
    return 1 if new else 0


def _main_card(args, target: str, keep) -> int:
    """The --card path: tmlint, then the card's evidence and the crosscheck."""
    from metrics_tpu_torch.analysis.san.runner import run_card

    report = run_card(target, baseline_path=args.baseline, device=args.device)
    lint = report.lint
    lint_new = [f for f in lint.new_findings if keep(f)]
    card_new = [f for f in report.new_findings if keep(f)]
    unused = sorted(set(lint.unused_waivers) | set(report.unused_waivers))
    if args.write_baseline:
        return _write_baseline("tmlint", args, target, [f for f in lint.findings + report.findings if keep(f)])

    if args.json:
        print(
            json.dumps(
                {
                    "stats": {**lint.stats, **{f"card_{k}": v for k, v in report.stats.items()}},
                    "new": [vars(f) for f in lint_new + card_new],
                    "waived": [vars(f) for f in lint.waived + report.waived if keep(f)],
                    "unused_waivers": [list(k) for k in unused],
                    "skipped": report.evidence.skipped,
                    "synced": sorted({(p, ln) for _, p, ln, _ in report.evidence.synced if p}),
                    "waiver_status": report.waiver_status,
                },
                indent=2,
            )
        )
        return 1 if (lint_new or card_new) else 0

    for f in lint_new + card_new:
        print(f.format())
    if args.verbose:
        for f in lint.waived + report.waived:
            if keep(f):
                print(f.format() + f"  # reason: {f.waive_reason}")
        for key, reason in sorted(report.evidence.skipped.items()):
            print(f"# no evidence: {key}: {reason}")
    for key_str, status in sorted(report.waiver_status.items()):
        print(f"# waiver {key_str}: {status}")
    _print_tail(unused, lint.parse_errors)
    s, ls = report.stats, lint.stats
    print(
        f"tmlint --card: {s['cases']} cases traced on the card ({s['skipped']} skipped), "
        f"{s['synced_lines']} synced lines, {s['footprint_lines']} traced lines, "
        f"{s['findings']} card findings ({s['waived']} waived, {len(card_new)} new) "
        f"+ {ls.get('new', 0):.0f} lint new, in {s['seconds']}s (card {s['card_seconds']}s)"
    )
    return 1 if (lint_new or card_new) else 0



def _main_san(args, target: str, keep) -> int:
    """The --san path: tmlint, then the abstract tier on fake tensors of --device."""
    from metrics_tpu_torch.analysis.san import costs as costs_mod
    from metrics_tpu_torch.analysis.san.runner import run_san

    try:
        report = run_san(target, baseline_path=args.baseline, costs_path=args.costs, with_costs=not args.no_costs,
                         device=args.device, introspect=not args.no_introspect)
    except FileNotFoundError as err:
        print(f"tmsan: {err}", file=sys.stderr)
        return 2

    if args.write_costs:
        out = args.costs or os.path.join(_find_repo_root(target), PACKAGE, "analysis", costs_mod.COSTS_FILENAME)
        n = costs_mod.write_costs(out, report.costs, device=args.device)
        print(f"tmsan: wrote {n} cost-budget entries to {out}")
    lint = report.lint
    if args.write_baseline:
        return _write_baseline("tmsan", args, target, [f for f in lint.findings + report.findings
                                                        if keep(f) and f.rule != "TMS-BUDGET"])

    lint_new = [f for f in lint.new_findings if keep(f)]
    san_new = [f for f in report.new_findings if keep(f)]
    unused = sorted(set(lint.unused_waivers) | set(report.unused_waivers))
    if args.json:
        print(
            json.dumps(
                {
                    "stats": {**lint.stats, **{f"san_{k}": v for k, v in report.stats.items()}},
                    "new": [vars(f) for f in lint_new + san_new],
                    "waived": [vars(f) for f in lint.waived + report.waived if keep(f)],
                    "unused_waivers": [list(k) for k in unused],
                    "skipped": report.skipped,
                    "costs": report.costs,
                    "budget_notes": report.budget_notes,
                    "waiver_status": report.waiver_status,
                },
                indent=2,
            )
        )
        return 1 if (lint_new or san_new) else 0

    for f in lint_new + san_new:
        print(f.format())
    if args.verbose:
        for f in lint.waived + report.waived:
            if keep(f):
                print(f.format() + f"  # reason: {f.waive_reason}")
        for name, reason in sorted(report.skipped.items()):
            print(f"# not traced: {name}: {reason}")
    for key_str, status in sorted(report.waiver_status.items()):
        print(f"# waiver {key_str}: {status}")
    for note in report.budget_notes:
        print(f"# budget: {note}")
    _print_tail(unused, lint.parse_errors)
    s, ls = report.stats, lint.stats
    print(
        f"tmsan: {s['classes_traced']} classes traced ({s['entries_traced']} abstract traces, "
        f"{s['canon_cases']} canonical update cases, {s['skipped']} skipped), {s['cost_entries']} cost entries, "
        f"{s['findings']} san findings ({s['waived']} waived, {len(san_new)} new) "
        f"+ {ls.get('new', 0):.0f} lint new, in {s['seconds']}s (traces {s['trace_seconds']}s)"
    )
    return 1 if (lint_new or san_new) else 0


def _main_own(args, target: str, keep) -> int:
    """The --own path: the tmown buffer-ownership tier on its own."""
    from metrics_tpu_torch.analysis.own import engine_contract
    from metrics_tpu_torch.analysis.own.runner import run_own

    try:
        report = run_own(target, baseline_path=args.baseline)
    except FileNotFoundError as err:
        print(f"tmown: {err}", file=sys.stderr)
        return 2

    if args.write_drift:
        out = os.path.join(_find_repo_root(target), PACKAGE, "analysis", engine_contract.DRIFT_FILENAME)
        engine_contract.write_worksheet(out, report.drift_worksheet())
        print(f"tmown: wrote {len(report.contract)} engine contracts to {out}")
    if args.write_baseline:
        return _write_baseline("tmown", args, target, [f for f in report.findings if keep(f)])

    new = [f for f in report.new_findings if keep(f)]
    if args.json:
        print(
            json.dumps(
                {
                    "stats": report.stats,
                    "contract": report.contract,
                    "new": [vars(f) for f in new],
                    "waived": [vars(f) for f in report.waived if keep(f)],
                    "unused_waivers": [list(k) for k in report.unused_waivers],
                    "parse_errors": report.parse_errors,
                },
                indent=2,
            )
        )
        return 1 if new else 0

    for f in new:
        print(f.format())
    if args.verbose:
        for f in report.waived:
            if keep(f):
                print(f.format() + f"  # reason: {f.waive_reason}")
        for engine, facts in sorted(report.contract.items()):
            have = [c for c, ev in facts["components"].items() if ev]
            print(f"# engine {engine}: {len(have)}/{len(facts['components'])} components")
    _print_tail(report.unused_waivers, report.parse_errors)
    s = report.stats
    print(
        f"tmown: {s['files']} files, {s['functions']} functions, "
        f"{s['donating']} donating, {s['exec_sites']} exec sites, "
        f"{s['engines']} engines, {s['findings']} findings "
        f"({s['waived']} waived, {len(new)} new) in {s['seconds']}s"
    )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
