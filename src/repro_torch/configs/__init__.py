"""Architecture config registry.

``get("minitron-8b")`` -> ModelConfig; ``ARCHS`` lists the ten LM
architectures. Dash-separated public ids map to underscore module files;
``qgtc-gcn`` and ``qgtc-gin`` resolve to the paper's GNN configs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      smoke_config, supports)

ARCHS = [
    "moonshot-v1-16b-a3b",
    "olmoe-1b-7b",
    "minitron-8b",
    "codeqwen1.5-7b",
    "h2o-danube-3-4b",
    "stablelm-12b",
    "rwkv6-1.6b",
    "internvl2-2b",
    "whisper-large-v3",
    "zamba2-7b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}
_MODULES["qgtc-gcn"] = "qgtc_gnn"
_MODULES["qgtc-gin"] = "qgtc_gnn"


def get(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if name.startswith("qgtc-"):
        return mod.GNN_CONFIGS[name]
    return mod.CONFIG


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "supports", "smoke_config",
           "ARCHS", "get"]
