"""api-dispatch-bypass: kernels run only through repro_torch.api.

The dispatch layer owns what a direct kernel call skips: the engine's
capability probe, ``tiles=`` stripped for engines without zero-tile
jumping, the explicit policy > ``use()`` > tuning table > DEFAULT_POLICY
chain, the fallback to an engine that has the op, and the host-scalar
checks. Importing ``repro_torch.kernels.ops`` (or a kernel module, or the
library loader ``_build``) outside ``kernels/`` and ``api/`` reaches
around all of that: it pins one engine and ignores the tuning table.

Exempt: ``repro_torch.kernels.sgt``. It launches nothing; it builds the
word-column remap that callers pass through ``tiles=`` (the serving
engine, the sweep and kernel_bench precompute it).
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Rule

_EXEMPT = re.compile(r"(^|/)(repro_torch/(kernels|api)/|tests/)")
_EXEC_MODULES = {"ops", "bgemm", "bitserial", "bitpack", "wqmm", "_build"}
_PACKAGE = "repro_torch.kernels"


class DispatchBypass(Rule):
    name = "api-dispatch-bypass"
    description = ("no import of the kernel execution modules "
                   "(repro_torch.kernels.{ops,bgemm,bitserial,bitpack,wqmm,"
                   "_build}) outside kernels/ and api/: dispatch through "
                   "repro_torch.api; kernels.sgt (artifacts) is exempt")

    def applies_to(self, path: str) -> bool:
        return path.endswith(".py") and not _EXEMPT.search(path)

    def _bad(self, path, node, mod):
        return self.finding(
            path, node,
            f"direct import of {_PACKAGE}.{mod} bypasses repro_torch.api "
            f"dispatch (capability probe, tiles= stripping, policy and "
            f"tuning-table resolution); call the repro_torch.api "
            f"dispatcher with an explicit backend/policy instead")

    def check(self, path, tree, lines):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and not node.level:
                if node.module == _PACKAGE:
                    out.extend(self._bad(path, node, a.name)
                               for a in node.names
                               if a.name in _EXEC_MODULES)
                elif node.module and node.module.startswith(_PACKAGE + "."):
                    mod = node.module.split(".")[2]
                    if mod in _EXEC_MODULES:
                        out.append(self._bad(path, node, mod))
            elif isinstance(node, ast.Import):
                for a in node.names:
                    parts = a.name.split(".")
                    if (parts[:2] == _PACKAGE.split(".") and len(parts) > 2
                            and parts[2] in _EXEC_MODULES):
                        out.append(self._bad(path, node, parts[2]))
        return out
