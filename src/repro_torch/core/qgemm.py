"""Quantized GEMM entry points and weight-only quantization, as the
reference's ``repro.core.qgemm``.

``qgemm`` and ``wq_matmul`` are thin fronts over the ``repro_torch.api``
registry: the engine (torch_dot / popcount / cuda) and its tuning come
from the active ``repro_torch.api.use(...)`` context or an explicit
``backend=`` / ``policy=``.

Weight-only quantization (``WeightQ``) is the QGTC bit-packing applied to
static weights with per-channel scales: the same 3D-stacked compression
shrinks the weight traffic of memory-bound LM decode.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitops
from repro_torch.core.quantize import calibrate, quantize

__all__ = ["qgemm", "WeightQ", "weight_quantize", "weight_dequantize",
           "wq_matmul"]


def qgemm(aq: torch.Tensor, bq: torch.Tensor, s: int, t: int, *,
          backend=None, policy=None) -> torch.Tensor:
    """Exact int32 (M,K)@(K,N) over unsigned s-bit x t-bit quantized operands."""
    from repro_torch import api

    return api.bitserial_mm(aq, bq, s, t, backend=backend, policy=policy)


@dataclasses.dataclass(frozen=True)
class WeightQ:
    """Weight-only quantized matrix: sub-byte values + per-out-channel scale.

    ``data`` holds the values one per int8, signed-centred (q - 2^(nbits-1));
    ``packed``, when kept, holds the unsigned values as bit planes, int32
    bit patterns like every packed word of the port.
    """

    data: torch.Tensor  # int8 (K, N)
    scale: torch.Tensor  # (1, N) float32 per-out-channel
    zero: torch.Tensor  # (1, N) float32
    nbits: int
    packed: torch.Tensor | None = None  # (nbits, ceil(K/32), N) int32


def weight_quantize(w: torch.Tensor, nbits: int,
                    keep_packed: bool = False) -> WeightQ:
    """Per-out-channel affine quantization of a (K, N) weight matrix.

    The unsigned q in [0, 2^nbits) is stored as q - 2^(nbits-1), so 8 bits
    fit int8; the offset folds into ``zero``. The bit planes pack the
    unsigned values.
    """
    if nbits > 8:
        raise ValueError("weight-only quantization supports nbits <= 8")
    qp = calibrate(w, nbits, dim=0)
    q = quantize(w, qp)
    packed = bitops.pack_b(q, nbits) if keep_packed else None
    offset = 1 << (nbits - 1)
    zero = qp.zero + offset * qp.scale
    return WeightQ((q - offset).to(torch.int8), qp.scale, zero, nbits, packed)


def weight_dequantize(wq: WeightQ) -> torch.Tensor:
    return wq.data.to(torch.float32) * wq.scale + wq.zero


def wq_matmul(x: torch.Tensor, wq: WeightQ, out_dtype=torch.bfloat16, *,
              backend=None, policy=None) -> torch.Tensor:
    """x (..., K) float @ quantized W (K, N) with affine correction.

    y = (x @ q) * scale + rowsum(x) * zero. Routed through the
    ``repro_torch.api`` registry: a context engine without ``wq_mm`` falls
    back to one with it, an explicit ``backend=`` without it raises.
    """
    from repro_torch import api

    return api.wq_mm(x, wq, out_dtype=out_dtype, backend=backend,
                     policy=policy)
