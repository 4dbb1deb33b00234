"""kernel-int-purity: no float math in the port's integer kernel modules.

QGTC's claim is a BIT-EXACT integer path: bit-plane popcount GEMMs whose
accumulators, tiles and outputs are int32 end to end. A float dtype in
``kernels/bitserial.py``, ``bgemm.py``, ``sgt.py`` or ``ops.py`` breaks
exactness (rounding), and a torch matmul there runs on the card's float
units: CUDA has no integer matmul of these shapes. The one sanctioned
exception is the §4.5 fused requantize epilogue (alpha/beta rescale and
clip), float by design: its functions carry a
``# lint: allow[kernel-int-purity]`` waiver on their ``def`` line, and the
trace checker (``repro_torch.analysis.trace``) shows separately that no
float GEMM runs on the fused path.

Flagged: ``torch``/numpy float dtypes, ``.float()``/``.double()``/
``.half()``/``.bfloat16()``, ``float(...)``, float literals, float
elementwise functions, and ``matmul``/``mm``/``bmm``/``einsum``/``@``.
``bitpack.py`` (float -> int quantization) and ``wqmm.py`` (a float
product over 4-bit weights) are float by contract and out of scope.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Rule

_SCOPE = re.compile(r"(^|/)repro_torch/kernels/(bitserial|bgemm|sgt|ops)\.py$")

_FLOAT_DTYPES = {"float32", "float64", "float16", "bfloat16", "float",
                 "double", "half", "float_"}
_FLOAT_METHODS = {"float", "double", "half", "bfloat16"}
_FLOAT_FNS = {"floor", "ceil", "exp", "log", "log2", "sqrt", "rsqrt",
              "tanh", "sigmoid", "softmax", "sin", "cos", "true_divide"}
_GEMM_FNS = {"matmul", "mm", "bmm", "addmm", "einsum", "linear"}
_ARRAY_NS = {"torch", "np", "numpy", "F"}


def _ns_of(node):
    """Leftmost Name id of an attribute chain (``torch`` of ``torch.floor``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class KernelIntPurity(Rule):
    name = "kernel-int-purity"
    description = ("no float dtypes, float casts, float literals, float "
                   "elementwise ops or matmuls in the integer kernel "
                   "modules (kernels/{bitserial,bgemm,sgt,ops}.py); the "
                   "fused §4.5 epilogue is waived explicitly")

    def applies_to(self, path: str) -> bool:
        return bool(_SCOPE.search(path))

    def _why(self, node) -> str | None:
        if (isinstance(node, ast.Attribute) and node.attr in _FLOAT_DTYPES
                and _ns_of(node) in _ARRAY_NS
                and not isinstance(node.ctx, ast.Store)):
            return (f"float dtype {_ns_of(node)}.{node.attr} in an integer "
                    f"kernel module (bit-exact int32 path required)")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            return ("'@' in an integer kernel module: torch's matmul runs "
                    "in float on the card (use the kernel or the popcount "
                    "plain version)")
        if isinstance(node, ast.Constant) and type(node.value) is float:
            return f"float literal {node.value!r} in an integer kernel module"
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "float":
            return "builtin float(...) in an integer kernel module"
        if not isinstance(fn, ast.Attribute):
            return None
        if fn.attr in _FLOAT_METHODS and _ns_of(fn) not in _ARRAY_NS:
            return f".{fn.attr}() cast in an integer kernel module"
        if fn.attr in _FLOAT_FNS and _ns_of(fn) in _ARRAY_NS:
            return (f"float elementwise op {_ns_of(fn)}.{fn.attr} in an "
                    f"integer kernel module")
        if fn.attr in _GEMM_FNS and _ns_of(fn) in _ARRAY_NS:
            return (f"{_ns_of(fn)}.{fn.attr} in an integer kernel module: "
                    f"torch's matmul runs in float on the card (use the "
                    f"kernel or the popcount plain version)")
        return None

    def check(self, path, tree, lines):
        out = []
        for node in ast.walk(tree):
            why = self._why(node)
            if why is not None:
                out.append(self.finding(path, node, why))
        return out
