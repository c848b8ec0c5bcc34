"""``python -m repro_torch.analysis.hlolint`` — check every declared
contract. Counterpart of ``repro/analysis/hlolint/cli.py``.

Exit codes, as the reference's (and tracelint's):

* 0 — every contract holds and every in-place hot site is covered
* 1 — contract violations (inplace / collective / dtype / host-read /
      launches) or coverage findings
* 2 — the contracts themselves are broken (an unknown entry point, a
      builder that crashes, a malformed dim expression): a run whose
      checks did not run never passes

The run is on the card unless ``--device`` asks for ``cpu`` or ``meta``
(``repro_torch.resolve_device``: without a card the default raises).
Nothing is skipped: the sharded contracts run on a grid that repeats the
one device. ``--fixtures FILE`` swaps in a corpus module (its
``HLOLINT_CONTRACTS`` / ``BUILDERS``) and scans that file, as a hot
module, instead of ``src/repro_torch``: the self-test that every rule
family fires.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.analysis.hlolint import coverage, entrypoints
from repro_torch.analysis.hlolint.checks import (Finding, Report,
                                                 run_contract)

DEFAULT_ROOT = "src/repro_torch"


def _load_fixture_module(path: str):
    spec = importlib.util.spec_from_file_location("torch_hlolint_fixtures",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_suite(fixtures: Optional[str] = None
               ) -> Tuple[List, Dict, List[str], List[Finding]]:
    """-> (contracts, builders, coverage_files, load_errors)."""
    errors: List[Finding] = []
    if fixtures:
        mod = _load_fixture_module(fixtures)
        contracts = list(getattr(mod, "HLOLINT_CONTRACTS", ()))
        builders = dict(getattr(mod, "BUILDERS", {}))
        files = [fixtures]
    else:
        contracts = entrypoints.collect_contracts()
        builders = entrypoints.BUILDERS
        files = []
    seen = set()
    for c in contracts:
        if c.name in seen:
            errors.append(Finding(c.name, "contract-error",
                                  f"duplicate contract name in {c.module}"))
        seen.add(c.name)
        if c.name not in builders:
            errors.append(Finding(c.name, "contract-error",
                                  "no builder registered for this contract"))
    return contracts, builders, files, errors


def run(root: str = DEFAULT_ROOT, fixtures: Optional[str] = None,
        only: Optional[Sequence[str]] = None, quiet: bool = False,
        device="cuda") -> Tuple[List[Finding], List[Report]]:
    """-> (findings, the checked contracts' reports)."""
    dev = resolve_device(device)
    contracts, builders, files, findings = load_suite(fixtures)
    known = [c.name for c in contracts]
    findings += coverage.scan_tree(root, known, files=files,
                                   hot=True if fixtures else None)
    reports: List[Report] = []
    for c in contracts:
        if only and c.name not in only:
            continue
        if c.name not in builders:
            continue                      # already a contract-error above
        if not quiet:
            print(f"[hlolint] checking {c.site()} on {dev} ...", flush=True)
        found, report = run_contract(c, builders[c.name], dev)
        findings.extend(found)
        if report is not None:
            reports.append(report)
    return sorted(set(findings)), reports


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.hlolint",
        description="contract checker of the port's hot entry points "
                    "(inplace, collective, dtype, host-read, launches)")
    ap.add_argument("--device", default="cuda",
                    help="where the entry points run: cuda (default), cpu "
                         "or meta")
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help=f"tree to scan for uncovered in-place sites "
                         f"(default: {DEFAULT_ROOT})")
    ap.add_argument("--fixtures", default=None,
                    help="path to a fixture corpus module providing "
                         "HLOLINT_CONTRACTS + BUILDERS (self-test mode)")
    ap.add_argument("--only", action="append", default=None,
                    help="check only this contract (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list declared contracts and exit")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        contracts, builders, _files, errors = load_suite(args.fixtures)
        for c in contracts:
            extra = "" if c.name in builders else "  [NO BUILDER]"
            print(f"{c.site()}{extra}")
        for e in errors:
            print(e.format())
        return 2 if errors else 0

    findings, reports = run(root=args.root, fixtures=args.fixtures,
                            only=args.only, quiet=args.quiet,
                            device=args.device)
    if not args.quiet:
        for r in reports:
            print(f"[hlolint] {r.name}: ops/dispatch {r.ops}, kernel calls "
                  f"{r.meta_calls} (meta) vs {r.expected} (contract)"
                  + ("" if r.card_launches is None
                     else f", {r.card_launches} (LAUNCH_COUNTS)"))
    for f in findings:
        print(f.format())
    broken = [f for f in findings if f.rule == "contract-error"]
    if broken:
        print(f"[hlolint] {len(broken)} broken contract(s) — fix the "
              f"contract/builder, the checks did not run")
        return 2
    if findings:
        print(f"[hlolint] {len(findings)} finding(s)")
        return 1
    print(f"[hlolint] clean ({len(reports)} contracts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
