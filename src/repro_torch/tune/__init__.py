"""repro_torch.tune — measured policy selection (the reference's ``repro.tune``).

``table.py`` is ported: the persisted, versioned tuning table mapping
(op, bits, sparsity_band, shape_bucket) -> ExecutionPolicy with
nearest-bucket lookup and provenance metadata, and the active-table state
dispatch (``api.resolve``) and the serving engine consult when they are
given no policy (``use_table`` > ``install`` > the packaged artifact,
``tables/h100_kernels.json``, measured on an H100).

``sweep.py`` is the declarative sweep harness: a config names a grid over
(op, bits, sparsity band, shape, backend, policy candidates); each cell
is timed with every candidate held equal to the plain ``torch_dot``
product as it is timed, and the winners become table entries
(``python -m repro_torch.launch.sweep``). ``sweep`` is imported lazily:
it pulls in the serving stack, while ``table`` stays light so dispatch
can consult it cheaply.
"""
from __future__ import annotations

from repro_torch.tune.table import (AUTO, SCHEMA_VERSION, TableEntry,
                                    TuningTable, active_table, default_table,
                                    dispatch_policy, install, policy_from_dict,
                                    policy_to_dict, provenance, use_table)

__all__ = [
    "AUTO", "SCHEMA_VERSION", "TableEntry", "TuningTable",
    "active_table", "default_table", "dispatch_policy", "install",
    "policy_from_dict", "policy_to_dict", "provenance", "use_table",
    "sweep",
]


def __getattr__(name):
    if name == "sweep":
        import repro_torch.tune.sweep as sweep
        return sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
