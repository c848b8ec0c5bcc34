"""Coverage rule: every in-place hot site of the port carries a contract.
Counterpart of ``repro/analysis/hlolint/coverage.py``.

The reference's coverage scan finds every ``jax.jit(...,
donate_argnums=...)`` and requires a contract there. The port has no jit
sites; its counterpart of a donated jit site is a **function in a hot
module (``tracelint.config.HOT_MODULES``, less ``HOST_ALLOW``) that calls
an in-place primitive directly**:

- a ring write or a priority scatter through the kernel ops module:
  ``ops.ring_write*`` / ``kops.ring_write*`` and ``ops.priority_scatter*``
  / ``kops.priority_scatter*`` (the ring and the priorities are the
  paper's shared pool, written in place);
- the optimizer's in-place update: a call ``<opt>.update(grads, state,
  params)``, a method ``update`` with exactly three positional
  arguments and no keywords (``train.optimizer.Optimizer.update``; a
  dict's ``update`` takes one).

Such a site is covered when the function that makes the call, or a
function around it, carries on its ``def`` line or the line above it
(above its decorators)::

    # hlolint: entrypoint[name, ...]     (names must be declared contracts)
    # hlolint: exempt -- <why no contract is needed>

Beyond the reference's scan, every ``entrypoint[...]`` annotation must sit
at a ``def``, and every declared contract must be annotated at exactly one
``def`` of the scan (a contract nothing points at guards nothing).
"""
from __future__ import annotations

import ast
import collections
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.hlolint.checks import Finding
from repro_torch.analysis.tracelint.config import LintConfig, is_hot

_ANNOT_RE = re.compile(
    r"#\s*hlolint:\s*(?:entrypoint\[([\w,\s\-]+)\]|(exempt))"
    r"\s*(?:--\s*(\S.*))?")

_OPS_MODULES = ("ops", "kops")
_INPLACE_PRIMS = ("ring_write", "priority_scatter")


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def is_inplace_call(call: ast.Call) -> bool:
    """An in-place primitive called directly (see the module docstring)."""
    fn = _dotted(call.func)
    parts = fn.split(".")
    if (len(parts) >= 2 and parts[-2] in _OPS_MODULES
            and parts[-1].startswith(_INPLACE_PRIMS)):
        return True
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "update" and len(call.args) == 3
            and not call.keywords)


def _def_start(fn: ast.AST) -> int:
    decos = getattr(fn, "decorator_list", [])
    return min([fn.lineno] + [d.lineno for d in decos])


def _comments(src: str) -> List[Tuple[int, str]]:
    """(line, text) of every comment (not a docstring's mention)."""
    return [(tok.start[0], tok.string) for tok in
            tokenize.generate_tokens(io.StringIO(src).readline)
            if tok.type == tokenize.COMMENT]


def _annotation(comments: Dict[int, str], fn: ast.AST):
    """The annotation on a def's line or the line above its decorators."""
    for ln in (fn.lineno, _def_start(fn) - 1):
        m = _ANNOT_RE.search(comments.get(ln, ""))
        if m:
            return m, ln
    return None, None


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parent: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parent[child] = node
    return parent


def _enclosing_defs(node, parent) -> List[ast.AST]:
    out = []
    n = parent.get(node)
    while n is not None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n)
        n = parent.get(n)
    return out


def scan_file(path: str, rel: str, known_names: Sequence[str],
              hot: Optional[bool] = None,
              annotated: Optional[collections.Counter] = None
              ) -> List[Finding]:
    """Findings of one file: uncovered in-place sites (in a hot module;
    ``hot=None`` asks ``tracelint.config``), annotations away from a def
    or naming an undeclared contract. ``annotated`` counts each name's
    annotations (for ``scan_tree``'s exactly-once rule)."""
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rel, "contract-error", f"cannot parse: {e}")]
    comments = dict(_comments(src))
    hot = is_hot(rel, LintConfig()) if hot is None else hot
    out: List[Finding] = []
    defs = [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    at_def = {}
    for fn in defs:
        m, ln = _annotation(comments, fn)
        if m is not None:
            at_def[ln] = (fn, m)

    # every annotation sits at a def and names declared contracts
    for i, text in sorted(comments.items()):
        m = _ANNOT_RE.search(text)
        if m is None:
            continue
        loc = f"{rel}:{i}"
        if i not in at_def:
            out.append(Finding(loc, "coverage",
                               "hlolint annotation not at a def — put it on "
                               "the entry point's def line or the line "
                               "above it"))
            continue
        if m.group(2):                                  # exempt
            if not m.group(3):
                out.append(Finding(
                    loc, "coverage",
                    "hlolint exempt without a reason — append "
                    "'-- <why this site needs no contract>'"))
            continue
        names = [n.strip() for n in m.group(1).split(",") if n.strip()]
        if not names:
            out.append(Finding(loc, "coverage",
                               "empty hlolint entrypoint[] annotation"))
        for name in names:
            if annotated is not None:
                annotated[name] += 1
            if name not in known_names:
                out.append(Finding(
                    loc, "contract-error",
                    f"annotation names entrypoint '{name}' but no such "
                    f"contract is declared in any CONTRACT_MODULES "
                    f"module"))

    if not hot:
        return out
    covered = {id(fn) for fn, _ in at_def.values()}
    parent = _parents(tree)
    for call in ast.walk(tree):
        if not (isinstance(call, ast.Call) and is_inplace_call(call)):
            continue
        around = _enclosing_defs(call, parent)
        if around and any(id(fn) in covered for fn in around):
            continue
        where = around[0].name if around else "<module>"
        out.append(Finding(
            f"{rel}:{call.lineno}", "coverage",
            f"in-place site `{_dotted(call.func)}` in `{where}` without an "
            f"hlolint contract — annotate its def '# hlolint: "
            f"entrypoint[<name>]' (and declare the contract) or '# "
            f"hlolint: exempt -- <reason>'"))
    return out


def scan_tree(root: str, known_names: Sequence[str],
              files: Iterable[str] = (), hot: Optional[bool] = None
              ) -> List[Finding]:
    """Scan every .py under ``root`` (or just ``files``) for uncovered
    in-place sites and stray annotations, and require each of
    ``known_names`` to be annotated at exactly one def."""
    targets: List[Tuple[str, str]] = []
    if files:
        targets = [(f, os.path.relpath(f).replace(os.sep, "/"))
                   for f in files]
    else:
        for dirpath, _dirs, names in os.walk(root):
            for n in sorted(names):
                if n.endswith(".py"):
                    fp = os.path.join(dirpath, n)
                    targets.append(
                        (fp, os.path.relpath(fp).replace(os.sep, "/")))
    annotated: collections.Counter = collections.Counter()
    out: List[Finding] = []
    for fp, rel in targets:
        out.extend(scan_file(fp, rel, known_names, hot=hot,
                             annotated=annotated))
    for name in known_names:
        if annotated[name] != 1:
            out.append(Finding(
                name, "coverage",
                f"contract annotated at {annotated[name]} defs (want "
                f"exactly one '# hlolint: entrypoint[{name}]')"))
    return sorted(out)
