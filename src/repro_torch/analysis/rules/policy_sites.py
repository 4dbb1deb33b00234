"""policy-grid: ExecutionPolicy construction sites must build valid grids.

``ExecutionPolicy.__post_init__`` checks the tile grid (positive blocks,
block_m % 8, block_n % 128, a known jump and mode) only at run time, on
whatever path constructs the policy. A bad literal in a branch rarely run
(an example, a benchmark arm, a sweep candidate) ships broken and fails in
front of a user. This rule finds every ``ExecutionPolicy(...)`` and every
``DEFAULT_POLICY.replace(...)`` whose arguments are all literal keywords,
constructs the policy at lint time from ``repro_torch.api.policy``, and
reports the ValueError at its file:line.

Sites with computed arguments cannot be evaluated statically;
``collect_sites`` still records them, so that the trace checker
(``repro_torch.analysis.trace.check_policy_sites``) reports how many sites
it validated and how many are dynamic.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import (DEFAULT_SCAN_ROOTS, REPO_ROOT, Rule,
                                         iter_py_files, rel_path)

_EXEMPT = re.compile(r"(^|/)tests/")


def literal_kwargs(call):
    """The call's keywords as a dict if every argument is a literal
    keyword, else None."""
    if call.args:
        return None
    kwargs = {}
    for kw in call.keywords:
        if kw.arg is None or not isinstance(kw.value, ast.Constant):
            return None
        kwargs[kw.arg] = kw.value.value
    return kwargs


def policy_calls(tree):
    """Yield ``(node, kind)`` for ``ExecutionPolicy(...)`` ('construct') and
    ``DEFAULT_POLICY.replace(...)`` ('replace') calls."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name == "ExecutionPolicy":
            yield node, "construct"
        elif (name == "replace" and isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name)
              and fn.value.id == "DEFAULT_POLICY"):
            yield node, "replace"


def build(kind: str, kwargs: dict):
    """Construct the site's policy; raises its TypeError or ValueError."""
    from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy
    if kind == "construct":
        return ExecutionPolicy(**kwargs)
    return DEFAULT_POLICY.replace(**kwargs)


def collect_sites(paths=None, rel_root=None) -> list:
    """Every policy construction site under ``paths`` (default: the scan
    roots): ``[{path, line, kind, kwargs}]``, ``kwargs`` None where the
    site is dynamic."""
    if paths is None:
        paths = [REPO_ROOT / p for p in DEFAULT_SCAN_ROOTS]
    sites = []
    for f in iter_py_files(paths):
        rel = rel_path(f, rel_root)
        if _EXEMPT.search(rel):
            continue
        try:
            tree = ast.parse(f.read_text(), filename=str(f))
        except SyntaxError:
            continue
        for node, kind in policy_calls(tree):
            sites.append({"path": rel, "line": node.lineno, "kind": kind,
                          "kwargs": literal_kwargs(node)})
    return sites


class PolicyGridValidity(Rule):
    name = "policy-grid"
    description = ("every ExecutionPolicy(...) / DEFAULT_POLICY.replace(...)"
                   " with literal keywords must construct a valid tile "
                   "grid; the ValueError surfaces at lint time with "
                   "file:line")

    def applies_to(self, path: str) -> bool:
        return path.endswith(".py") and not _EXEMPT.search(path)

    def check(self, path, tree, lines):
        out = []
        for node, kind in policy_calls(tree):
            kwargs = literal_kwargs(node)
            if kwargs is None:
                continue  # dynamic: the sweep and the trace cover it
            try:
                build(kind, kwargs)
            except (TypeError, ValueError) as e:
                out.append(self.finding(
                    path, node,
                    f"invalid ExecutionPolicy at construction site: {e}"))
        return out
