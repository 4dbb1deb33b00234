"""Sharding rules: placements stay in dist/, axis names stay declared (the
reference's ``analysis/rules/sharding_layers.py``).

Two contracts:

``sharding-spec-layering``: models (and everything else outside
``repro_torch/dist/`` and ``repro_torch/launch/``) must not import or build
DTensor placements and meshes directly: ``DeviceMesh``,
``init_device_mesh``, ``Shard``, ``Replicate``, ``Partial``,
``distribute_tensor`` or ``DTensor``. The logical-axis layer keeps a model
file mesh-agnostic: it annotates with logical names and the launcher's rule
table decides placement, where an ad-hoc ``Shard(0)`` hard-wires a layout
the mesh may not have. Code that needs a raw spec gets it from
``repro_torch.dist.sharding`` (``pspec``, ``placements``, ``shard_map``),
so the dependency stays visible to this rule.

``sharding-axis-declared``: every logical axis name a model passes to
``constrain(...)`` or looks up with ``rules.get("...")`` must appear in
``repro_torch.dist.sharding.LOGICAL_AXES``. The shared collectors below
(``constrain_axis_names`` / ``rules_get_names``) serve the tests too.
"""
from __future__ import annotations

import ast
import os
import pathlib
import re

from repro_torch.analysis.engine import Rule

_EXEMPT = re.compile(r"(^|/)(repro_torch/(dist|launch)/|tests/)")
_MODELS = re.compile(r"(^|/)repro_torch/models/[^/]+\.py$")
_PLACEMENT_NAMES = {"DeviceMesh", "init_device_mesh", "Shard", "Replicate",
                    "Partial", "distribute_tensor", "DTensor"}


# ---------------------------------------------------------- shared collectors

def _parse_dir(models_dir):
    for fname in sorted(os.listdir(models_dir)):
        if fname.endswith(".py"):
            src = pathlib.Path(models_dir, fname).read_text()
            yield ast.parse(src, filename=fname)


def _callee(node) -> str | None:
    fn = node.func
    return fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)


def constrain_names_in(tree) -> set:
    """String literals passed to a ``constrain(...)`` call in one tree."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _callee(node) == "constrain":
            for arg in node.args[1:]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value)
    return names


def _is_rules_get(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "rules"
            and bool(node.args)
            and isinstance(node.args[0], ast.Constant))


def rules_get_names_in(tree) -> set:
    """Logical names looked up directly via ``rules.get("...")``."""
    return {node.args[0].value for node in ast.walk(tree)
            if _is_rules_get(node)}


def constrain_axis_names(models_dir) -> set:
    """Every logical axis name constrain()ed anywhere under models_dir."""
    names = set()
    for tree in _parse_dir(models_dir):
        names |= constrain_names_in(tree)
    return names


def rules_get_names(models_dir) -> set:
    names = set()
    for tree in _parse_dir(models_dir):
        names |= rules_get_names_in(tree)
    return names


# ----------------------------------------------------------------- the rules

def _distributed_module(mod: str | None) -> bool:
    return bool(mod) and mod.startswith("torch.distributed")


class ShardingSpecLayering(Rule):
    name = "sharding-spec-layering"
    description = ("no DeviceMesh / init_device_mesh / Shard / Replicate / "
                   "Partial / distribute_tensor / DTensor outside "
                   "repro_torch/dist/ and repro_torch/launch/; use "
                   "repro_torch.dist.sharding (constrain, pspec, placements)")

    def applies_to(self, path: str) -> bool:
        return path.endswith(".py") and not _EXEMPT.search(path)

    def _bad(self, path, node, what):
        return self.finding(
            path, node,
            f"ad-hoc {what}: build placements and meshes through "
            f"repro_torch.dist.sharding (pspec/placements/shard_map) so the "
            f"logical-axis rule tables stay in charge")

    def check(self, path, tree, lines):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    _distributed_module(node.module):
                bad = [a.name for a in node.names
                       if a.name in _PLACEMENT_NAMES]
                if bad:
                    out.append(self._bad(
                        path, node, f"import of {', '.join(bad)} from "
                        f"{node.module}"))
            elif (isinstance(node, ast.Attribute)
                  and node.attr in _PLACEMENT_NAMES
                  and "distributed" in ast.unparse(node.value)):
                out.append(self._bad(path, node,
                                     f"use of {ast.unparse(node)}"))
        return out


class ShardingAxisDeclared(Rule):
    name = "sharding-axis-declared"
    description = ("every logical axis name used by models/ (constrain "
                   "string args, rules.get keys) must be declared in "
                   "repro_torch.dist.sharding.LOGICAL_AXES")

    def applies_to(self, path: str) -> bool:
        return bool(_MODELS.search(path))

    def check(self, path, tree, lines):
        from repro_torch.dist.sharding import LOGICAL_AXES

        declared = set(LOGICAL_AXES)
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee(node) == "constrain":
                for arg in node.args[1:]:
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and arg.value not in declared):
                        out.append(self.finding(
                            path, arg,
                            f"logical axis {arg.value!r} is not declared "
                            f"in repro_torch.dist.sharding.LOGICAL_AXES: "
                            f"undeclared names silently resolve to "
                            f"'replicated' in every mode"))
            elif (_is_rules_get(node) and isinstance(node.args[0].value, str)
                  and node.args[0].value not in declared):
                out.append(self.finding(
                    path, node.args[0],
                    f"logical axis {node.args[0].value!r} (rules.get) is "
                    f"not declared in repro_torch.dist.sharding.LOGICAL_AXES"))
        return out
