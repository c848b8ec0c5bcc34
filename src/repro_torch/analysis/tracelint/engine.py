"""tracelint engine: file walking, findings, suppressions, baseline.
Counterpart of ``repro/analysis/tracelint/engine.py``, with the same
suppression syntax, baseline format and staleness rule, so one comment
in a port file is read alike by both linters.

A *finding* is (rule, path, line, message). Three ways to silence one:

* fix the code (preferred);
* an inline suppression on the offending line or the comment line
  directly above it::

      losses = torch.stack(losses).tolist()  # tracelint: allow[host-transfer] -- after the timed loop

  the reason after ``--`` is mandatory: a bare ``allow[...]`` is itself
  reported (rule ``suppression``). In a CUDA source (``.cu``, ``.cuh``,
  scanned for the shared-memory budget) the comment starts with ``//``;
* a baseline entry (``tracelint-torch-baseline.txt``)::

      host-transfer | src/repro_torch/x.py:12 | why | the line's source text

  Baseline entries pin the line's source text: if the line moves or
  changes, the entry is *stale* and the run fails (exit 2) until the
  baseline is regenerated.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.tracelint.config import LintConfig

RULES = (
    "host-transfer",      # a read of a device value in a hot module
    "generator",          # a draw from the global RNG, a seed reused
    "inplace-alias",      # in-place state handed to a thread uncloned
    "sharding-axes",      # literal axis names vs the declared mesh axes
    "kernel-launch",      # counted launches, no fallback, lazy builds
    "config-mutation",    # process-wide settings outside __init__.py
    "suppression",        # malformed / bare inline suppressions
)

#: sources the scan reads: Python modules, and the CUDA sources for the
#: shared-memory budget
PY_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclass(frozen=True, order=True)
class Finding:
    path: str            # posix relpath from the invocation cwd
    line: int
    rule: str
    msg: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


@dataclass
class LintModule:
    path: str                     # relpath (posix)
    tree: ast.AST                 # an empty module for a CUDA source
    lines: List[str]              # raw source lines

    @property
    def is_cuda(self) -> bool:
        return self.path.endswith(CUDA_SUFFIXES)

    def src(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


# --------------------------------------------------------------------------- #
# inline suppressions
# --------------------------------------------------------------------------- #

_SUPPRESS_RE = re.compile(
    r"#\s*tracelint:\s*allow\[([a-z*\-, ]+)\]\s*(?:--\s*(\S.*))?")
_SUPPRESS_CUDA_RE = re.compile(
    r"//\s*tracelint:\s*allow\[([a-z*\-, ]+)\]\s*(?:--\s*(\S.*))?")


def _suppress_re(mod: LintModule):
    return _SUPPRESS_CUDA_RE if mod.is_cuda else _SUPPRESS_RE


def parse_suppressions(mod: LintModule):
    """-> {line: (rules frozenset, reason|None)}. A suppression on a
    comment-only line also covers the next source line."""
    out: Dict[int, Tuple[frozenset, Optional[str]]] = {}
    pattern = _suppress_re(mod)
    lead = "//" if mod.is_cuda else "#"

    def add(line: int, rules: frozenset, reason: Optional[str]) -> None:
        # a comment-line suppression and the next line's own suppression
        # both target that line: union the rule sets, never overwrite
        if line in out:
            prev_rules, prev_reason = out[line]
            rules, reason = prev_rules | rules, prev_reason or reason
        out[line] = (rules, reason)

    for i, text in enumerate(mod.lines, start=1):
        m = pattern.search(text)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        reason = m.group(2).strip() if m.group(2) else None
        add(i, rules, reason)
        if text.strip().startswith(lead):     # comment-only: covers next line
            add(i + 1, rules, reason)
    return out


def apply_suppressions(findings: List[Finding], mod: LintModule
                       ) -> List[Finding]:
    sup = parse_suppressions(mod)
    if not sup:
        return findings
    kept = []
    for f in findings:
        hit = sup.get(f.line)
        if hit and (f.rule in hit[0] or "*" in hit[0]):
            continue
        kept.append(f)
    # bare suppressions (no reason) are findings themselves, reported at
    # the comment line only (not the derived next-line entry)
    pattern = _suppress_re(mod)
    for i, text in enumerate(mod.lines, start=1):
        m = pattern.search(text)
        if m and not (m.group(2) and m.group(2).strip()):
            kept.append(Finding(mod.path, i, "suppression",
                                "suppression without a reason — append "
                                "'-- <why this is allowed>'"))
    return kept


# --------------------------------------------------------------------------- #
# baseline
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    line: int
    reason: str
    src: str                      # stripped source text pinned at entry time

    def format(self) -> str:
        return (f"{self.rule} | {self.path}:{self.line} | {self.reason} | "
                f"{self.src}")


def load_baseline(path: str) -> List[BaselineEntry]:
    entries: List[BaselineEntry] = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for ln, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split("|", 3)]
            if len(parts) != 4 or not all(parts):
                raise ValueError(
                    f"{path}:{ln}: malformed baseline entry (want "
                    f"'rule | path:line | reason | source'): {line!r}")
            loc = parts[1].rsplit(":", 1)
            if len(loc) != 2 or not loc[1].isdigit():
                raise ValueError(
                    f"{path}:{ln}: bad location {parts[1]!r} (want "
                    f"path:line)")
            entries.append(BaselineEntry(rule=parts[0], path=loc[0],
                                         line=int(loc[1]), reason=parts[2],
                                         src=parts[3]))
    return entries


def write_baseline(path: str, findings: Sequence[Finding],
                   modules: Dict[str, LintModule], reason: str,
                   existing: Sequence[BaselineEntry] = ()) -> None:
    """``findings`` must come from an un-baselined run (``run`` with
    ``baseline_path=None``): writing a baseline-filtered list would drop
    every still-valid entry. ``existing`` entries whose pinned line is
    unchanged keep their reason; every other entry gets ``reason``."""
    reasons = {(e.rule, e.path, e.line, e.src): e.reason for e in existing}
    with open(path, "w") as f:
        f.write("# tracelint baseline — each entry excuses ONE finding "
                "at a pinned source line.\n"
                "# Format: rule | path:line | reason | source text\n"
                "# Entries go stale (CI fails) when the pinned line "
                "moves or changes.\n")
        for fd in sorted(findings):
            mod = modules.get(fd.path)
            src = mod.src(fd.line) if mod else ""
            f.write(BaselineEntry(
                fd.rule, fd.path, fd.line,
                reasons.get((fd.rule, fd.path, fd.line, src), reason),
                src).format() + "\n")


def check_baseline(entries: Sequence[BaselineEntry],
                   modules: Dict[str, LintModule]) -> List[str]:
    """-> the stale entries' error strings (an entry whose line no longer
    exists or whose source text changed)."""
    stale = []
    for e in entries:
        mod = modules.get(e.path)
        if mod is None:
            if os.path.exists(e.path):
                with open(e.path) as f:
                    lines = f.read().splitlines()
                src = (lines[e.line - 1].strip()
                       if 1 <= e.line <= len(lines) else None)
            else:
                src = None
        else:
            src = mod.src(e.line) or None
        if src is None:
            stale.append(f"stale baseline entry (no such line): "
                         f"{e.format()}")
        elif src != e.src:
            stale.append(f"stale baseline entry (source changed to "
                         f"{src!r}): {e.format()}")
    return stale


def apply_baseline(findings: List[Finding],
                   entries: Sequence[BaselineEntry]) -> List[Finding]:
    index = {(e.rule, e.path, e.line) for e in entries}
    return [f for f in findings if (f.rule, f.path, f.line) not in index]


# --------------------------------------------------------------------------- #
# runner
# --------------------------------------------------------------------------- #

def collect_modules(paths: Sequence[str]) -> Dict[str, LintModule]:
    """Read every Python module and CUDA source under ``paths`` ->
    {relpath: LintModule}."""
    suffixes = PY_SUFFIXES + CUDA_SUFFIXES
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(suffixes))
        elif p.endswith(suffixes):
            files.append(p)
    out: Dict[str, LintModule] = {}
    for fp in sorted(set(files)):
        rel = os.path.relpath(fp).replace(os.sep, "/")
        with open(fp) as f:
            src = f.read()
        if fp.endswith(CUDA_SUFFIXES):
            tree: ast.AST = ast.Module(body=[], type_ignores=[])
        else:
            try:
                tree = ast.parse(src, filename=fp)
            except SyntaxError as e:
                raise SyntaxError(
                    f"tracelint cannot parse {rel}: {e}") from e
        out[rel] = LintModule(path=rel, tree=tree, lines=src.splitlines())
    return out


def run(paths: Sequence[str], cfg: Optional[LintConfig] = None,
        baseline_path: Optional[str] = None):
    """Run every rule over ``paths``.

    -> (findings, stale, modules): the findings neither suppressed nor
    baselined (sorted); the stale baseline entries' error strings; the
    parsed modules (for --write-baseline).
    """
    from repro_torch.analysis.tracelint import rules as R
    cfg = cfg or LintConfig()
    modules = collect_modules(paths)
    ctx = R.build_context(modules, cfg)
    findings: List[Finding] = []
    for mod in modules.values():
        per_file: List[Finding] = []
        for rule_fn in R.ALL_RULES:
            per_file.extend(rule_fn(mod, ctx))
        findings.extend(apply_suppressions(per_file, mod))
    stale: List[str] = []
    if baseline_path:
        entries = load_baseline(baseline_path)
        stale = check_baseline(entries, modules)
        findings = apply_baseline(findings, entries)
    return sorted(findings), stale, modules
