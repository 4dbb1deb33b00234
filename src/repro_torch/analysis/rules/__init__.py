"""Rule registry of the port's contract lint.

One instance per rule, ordered by the layer each guards (kernels -> dist
-> perf and serving timers -> dispatch -> serve -> policy). ``python -m
repro_torch.launch.lint --list-rules`` prints this catalog.

The reference's ``serve-jit-static`` (``jit_static``) checks the arguments
a jitted function takes as static; the port has no jit, so it has nothing
to check.
"""
from __future__ import annotations

from repro_torch.analysis.rules.chaos import ChaosHarnessOnly
from repro_torch.analysis.rules.dispatch import DispatchBypass
from repro_torch.analysis.rules.kernel_purity import KernelIntPurity
from repro_torch.analysis.rules.policy_sites import PolicyGridValidity
from repro_torch.analysis.rules.sharding_layers import (ShardingAxisDeclared,
                                                        ShardingSpecLayering)
from repro_torch.analysis.rules.timers import TimerSync

__all__ = ["ALL_RULES", "get_rule"]

ALL_RULES = (
    KernelIntPurity(),
    ShardingSpecLayering(),
    ShardingAxisDeclared(),
    TimerSync(),
    DispatchBypass(),
    ChaosHarnessOnly(),
    PolicyGridValidity(),
)


def get_rule(name: str):
    for rule in ALL_RULES:
        if rule.name == name:
            return rule
    raise KeyError(f"unknown lint rule {name!r}; "
                   f"known: {[r.name for r in ALL_RULES]}")
