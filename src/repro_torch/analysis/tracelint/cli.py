"""``python -m repro_torch.analysis.tracelint [paths...]``

Exit codes, as the reference's: 0 clean; 1 findings neither suppressed
nor baselined; 2 stale baseline entries or a malformed baseline (stale
wins: a baseline that no longer pins real lines must be regenerated
before its findings can be trusted).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis.tracelint import engine
from repro_torch.analysis.tracelint.config import LintConfig

DEFAULT_PATH = "src/repro_torch"
DEFAULT_BASELINE = "tracelint-torch-baseline.txt"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracelint",
        description="the port's syntactic linter (host reads, generators, "
                    "in-place state, mesh axes, kernel launches, settings)")
    p.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                   help=f"files/directories to scan (default: "
                        f"{DEFAULT_PATH})")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help=f"baseline file (default: {DEFAULT_BASELINE}; "
                        f"'' to disable)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to --baseline instead "
                        "of failing on them")
    p.add_argument("--reason", default="pre-existing; triaged at baseline "
                                       "creation",
                   help="reason recorded with --write-baseline")
    p.add_argument("--no-contract", action="store_true",
                   help="skip the distributed/sharding.py contract "
                        "requirement (fixture corpora)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    paths = args.paths or [DEFAULT_PATH]
    cfg = LintConfig(require_contract=not args.no_contract)
    baseline = args.baseline or None
    try:
        # write mode regenerates from the FULL finding list: filtering
        # through the old baseline first would drop every still-valid
        # entry (and its reason) from the rewritten file
        findings, stale, modules = engine.run(
            paths, cfg=cfg,
            baseline_path=None if args.write_baseline else baseline)
    except (SyntaxError, ValueError) as e:
        print(f"tracelint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if not baseline:
            print("tracelint: --write-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        try:
            existing = engine.load_baseline(baseline)
        except ValueError as e:
            print(f"tracelint: rewriting malformed baseline ({e})",
                  file=sys.stderr)
            existing = []
        engine.write_baseline(baseline, findings, modules, args.reason,
                              existing=existing)
        print(f"tracelint: wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to {baseline}")
        return 0

    for s in stale:
        print(f"tracelint: {s}", file=sys.stderr)
    for f in findings:
        print(f.format())
    n_files = len(modules)
    if stale:
        print(f"tracelint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} — regenerate with "
              f"--write-baseline after triage", file=sys.stderr)
        return 2
    if findings:
        print(f"tracelint: {len(findings)} finding"
              f"{'' if len(findings) == 1 else 's'} in {n_files} files")
        return 1
    print(f"tracelint: clean ({n_files} files)")
    return 0
