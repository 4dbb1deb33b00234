"""Core of the port's contract lint: path-scoped AST rules over its tree.

The port's correctness rests on invariants its types cannot show: integer
GEMMs on every path but the §4.5 epilogue, timers that stop after the
card does, kernel launches only through ``repro_torch.api``, faults only
through the chaos harness, valid policy grids. Each rule in
``repro_torch.analysis.rules`` is a small AST visitor scoped to the layer
whose contract it guards; this module owns what they share:

  * file discovery and parsing (one ``ast.parse`` per file for all the
    rules that apply),
  * inline waivers: a ``# lint: allow[rule-id]`` comment suppresses that
    rule on its line; a STANDALONE waiver comment covers the next code
    line; when the covered line is a ``def``/``class`` header the waiver
    covers the whole body (the §4.5 fused epilogue, float by design in an
    integer kernel module). A waiver carries its reason after it,
  * baseline files: a JSON list of findings to suppress while a rule is
    adopted. A baseline entry is ``(rule, path, message)``, not the line:
    edits elsewhere move lines, and a baseline that rots on every reflow
    gets regenerated blindly.

Rules match repo-relative POSIX paths (``src/repro_torch/kernels/...``),
so a tree that mirrors the layout under any root (``rel_root``) lints the
same: that is how the tests lint known-bad code without planting it in the
package.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re

__all__ = ["REPO_ROOT", "DEFAULT_SCAN_ROOTS", "Finding", "LintResult",
           "Rule", "run_lint", "lint_file", "iter_py_files", "rel_path",
           "waived_lines", "callee_name", "load_baseline", "baseline_payload",
           "split_by_baseline"]

# src/repro_torch/analysis/engine.py -> analysis -> repro_torch -> src -> root
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# The port's package only. tests/ is absent (tests build invalid policies
# and tiles on purpose), and so are the JAX package's roots, which its own
# lint scans.
DEFAULT_SCAN_ROOTS = ("src/repro_torch",)

_WAIVER_RE = re.compile(r"lint:\s*allow\[([^\]]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # repo-relative POSIX path
    line: int
    col: int
    message: str

    def key(self) -> tuple:
        """Baseline identity, free of the line number (see the module doc)."""
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Rule:
    """A named contract check. Subclasses set ``name``/``description`` and
    implement ``applies_to`` (path scoping) and ``check`` (the AST walk)."""

    name: str = ""
    description: str = ""

    def applies_to(self, path: str) -> bool:
        raise NotImplementedError

    def check(self, path: str, tree: ast.AST, lines: list) -> list:
        raise NotImplementedError

    def finding(self, path: str, node, message: str) -> Finding:
        return Finding(self.name, path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message)


def callee_name(call: ast.Call) -> str | None:
    """``f`` of ``f(...)`` or ``x.f(...)``; None for other callees."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return fn.id if isinstance(fn, ast.Name) else None


@dataclasses.dataclass
class LintResult:
    findings: list
    files: int

    def to_dict(self) -> dict:
        return {"files": self.files,
                "findings": [f.to_dict() for f in self.findings]}


def waived_lines(tree: ast.AST, lines: list) -> dict:
    """Rule name (or ``*``) -> the set of line numbers a waiver covers.

    A trailing waiver covers its own line; a standalone comment waiver
    covers the next code line. When the covered line is a ``def``/``class``
    header the waiver covers the whole body."""
    span_end = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            span_end[node.lineno] = node.end_lineno or node.lineno
    waived: dict = {}
    for i, text in enumerate(lines, 1):
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        target = i
        if text.lstrip().startswith("#"):
            # standalone: skip the rest of its comment block and blank lines
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].lstrip().startswith("#")):
                target += 1
        end = span_end.get(target, target)
        for rule in m.group(1).split(","):
            waived.setdefault(rule.strip(), set()).update(range(target,
                                                                end + 1))
    return waived


def iter_py_files(paths):
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def rel_path(path, rel_root=None) -> str:
    """Repo-relative POSIX path; an explicit ``rel_root`` (a mirrored
    tree) takes precedence, so its files scope as the package's do."""
    p = pathlib.Path(path).resolve()
    for base in (rel_root, REPO_ROOT):
        if base is None:
            continue
        try:
            return p.relative_to(pathlib.Path(base).resolve()).as_posix()
        except ValueError:
            continue
    return p.as_posix()


def lint_file(path, rules, rel_root=None) -> list:
    rel = rel_path(path, rel_root)
    applicable = [r for r in rules if r.applies_to(rel)]
    if not applicable:
        return []
    src = pathlib.Path(path).read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding("syntax-error", rel, e.lineno or 0, e.offset or 0,
                        f"file does not parse: {e.msg}")]
    lines = src.splitlines()
    waived = waived_lines(tree, lines)
    out = []
    for rule in applicable:
        skip = waived.get(rule.name, set()) | waived.get("*", set())
        out.extend(f for f in rule.check(rel, tree, lines)
                   if f.line not in skip)
    return out


def run_lint(paths=None, rules=None, rel_root=None) -> LintResult:
    """Lint ``paths`` (default: the port's scan roots) under ``rules``
    (default: the whole registry)."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = ALL_RULES
    if paths is None:
        paths = [REPO_ROOT / p for p in DEFAULT_SCAN_ROOTS]
    findings, files = [], 0
    for f in iter_py_files(paths):
        files += 1
        findings.extend(lint_file(f, rules, rel_root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=findings, files=files)


# ------------------------------------------------------------------ baseline

def baseline_payload(findings) -> dict:
    """A baseline of the given findings, deduplicated and sorted."""
    keys = sorted({f.key() for f in findings})
    return {"version": 1,
            "findings": [{"rule": r, "path": p, "message": m}
                         for r, p, m in keys]}


def load_baseline(path) -> list:
    data = json.loads(pathlib.Path(path).read_text())
    if data.get("version") != 1:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r} (expected 1)")
    out = []
    for e in data.get("findings", ()):
        missing = {"rule", "path", "message"} - set(e)
        if missing:
            raise ValueError(f"baseline entry missing {sorted(missing)}: {e}")
        out.append((e["rule"], e["path"], e["message"]))
    return out


def split_by_baseline(findings, baseline):
    """``(new, suppressed, stale)``: findings the baseline does not cover,
    findings it suppresses, and its entries that matched nothing (fixed:
    delete them; ``--strict`` fails on them so that a baseline only
    shrinks)."""
    pinned = set(baseline)
    new = [f for f in findings if f.key() not in pinned]
    suppressed = [f for f in findings if f.key() in pinned]
    live = {f.key() for f in findings}
    stale = [k for k in baseline if k not in live]
    return new, suppressed, stale
