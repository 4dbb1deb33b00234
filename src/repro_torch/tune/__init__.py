"""repro_torch.tune — measured policy selection (the reference's ``repro.tune``).

``table.py`` is ported: the persisted, versioned tuning table mapping
(op, bits, sparsity_band, shape_bucket) -> ExecutionPolicy with
nearest-bucket lookup and provenance metadata, and the active-table state
the serving engine consults when it is given no policy
(``use_table`` > ``install`` > the packaged artifact). No artifact is
packaged: only a sweep run on an H100 may write one, and the sweep
harness is not ported yet.
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
]
