"""Quantized GEMM entry point: a thin front over the ``repro_torch.api``
registry, as the reference's ``repro.core.qgemm.qgemm``.

The engine (torch_dot / popcount / cuda) and its tuning come from the
active ``repro_torch.api.use(...)`` context or an explicit ``backend=`` /
``policy=``. The reference's weight-only quantization (``WeightQ``,
``weight_quantize``, ``wq_matmul``) comes with its kernel and the LM stack.
"""
from __future__ import annotations

import torch

__all__ = ["qgemm"]


def qgemm(aq: torch.Tensor, bq: torch.Tensor, s: int, t: int, *,
          backend=None, policy=None) -> torch.Tensor:
    """Exact int32 (M,K)@(K,N) over unsigned s-bit x t-bit quantized operands."""
    from repro_torch import api

    return api.bitserial_mm(aq, bq, s, t, backend=backend, policy=policy)
