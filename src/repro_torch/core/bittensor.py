"""BitTensor: QGTC's bit-Tensor API (§5) in PyTorch.

A BitTensor carries packed bit planes in an int32 tensor (the paper's
"vehicle" int32 Tensor; each word is the int32 with the uint32's bit
pattern, as everywhere in the port), its bitwidth, its logical shape and
its affine quantization parameters. It is a frozen dataclass of tensors,
placed on whatever device its data lies on.

The functions follow the reference's ``repro.core.bittensor`` step for
step, and mirror the paper's API:

  to_bit(x, nbits [, qp])  ~  Tensor.to_bit(nbits)
  to_val(bt)               ~  Tensor.to_val(nbits)   (decode to int32)
  to_float(bt)             ~  decode + dequantize
  bitmm2int(a, b)          ~  bitMM2Int(C, A, B, bit_A, bit_B)
  bitmm2bit(a, b, out_bits)~  bitMM2Bit(..., bit_C)  (requantized output)

The matmuls dispatch through the ``repro_torch.api`` registry: select the
engine with ``with repro_torch.api.use("cuda", policy=...)`` or per call
with ``backend=`` / ``policy=``. The reference's deprecated ``impl=``
keyword is left out: nothing in the port calls it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bitops
from repro_torch.core.quantize import QuantParams, calibrate, dequantize, quantize

__all__ = ["BitTensor", "to_bit", "to_val", "to_float", "bitmm2int", "bitmm2bit"]


@dataclasses.dataclass(frozen=True)
class BitTensor:
    """Packed bit-plane tensor.

    data: int32 words, shape (nbits, *outer, ceil(shape[pack_axis]/32), *rest)
          — the logical ``pack_axis`` is replaced by a word axis.
    shape: the logical int shape.
    pack_axis: which logical axis is packed (normalized, >= 0).
    qp: affine params mapping the unsigned quantized domain back to floats
        (None for inherently binary data such as adjacency matrices).
    """

    data: torch.Tensor
    nbits: int
    shape: tuple
    pack_axis: int
    qp: QuantParams | None = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.data.shape) * 4

    @property
    def logical_nbytes_fp32(self) -> int:
        return math.prod(self.shape) * 4


def to_bit(
    x: torch.Tensor,
    nbits: int,
    qp: QuantParams | None = None,
    pack_axis: int = -1,
    prequantized: bool = False,
) -> BitTensor:
    """Quantize (unless already int in [0, 2^nbits)) and pack to a BitTensor."""
    if prequantized or not x.is_floating_point():
        q = x.to(torch.int32)
    else:
        if qp is None:
            qp = calibrate(x, nbits)
        q = quantize(x, qp)
    pack_axis = pack_axis % q.ndim
    planes = bitops.bit_decompose(q, nbits)  # (nbits, *shape)
    packed = bitops.pack_along_axis(planes, dim=pack_axis + 1)
    return BitTensor(packed, nbits, tuple(q.shape), pack_axis, qp)


def to_val(bt: BitTensor) -> torch.Tensor:
    """Decode a BitTensor to its unsigned int32 values (paper's to_val)."""
    planes = bitops.unpack_along_axis(
        bt.data, dim=bt.pack_axis + 1, size=bt.shape[bt.pack_axis])
    return bitops.bit_compose(planes)


def to_float(bt: BitTensor) -> torch.Tensor:
    v = to_val(bt)
    if bt.qp is None:
        return v.to(torch.float32)
    return dequantize(v, bt.qp)


def _check_mm(a: BitTensor, b: BitTensor):
    if len(a.shape) != 2 or len(b.shape) != 2:
        raise ValueError("bitmm expects rank-2 BitTensors")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.pack_axis != 1 or b.pack_axis != 0:
        raise ValueError(
            "bitmm requires A packed along K (axis 1, 'column-wise') and "
            "B packed along K (axis 0, 'row-wise') per Fig. 4")


def bitmm2int(a: BitTensor, b: BitTensor, *, backend=None,
              policy=None) -> torch.Tensor:
    """Any-bitwidth MM with exact int32 output (paper bitMM2Int)."""
    from repro_torch import api

    _check_mm(a, b)
    out = api.bitserial_mm_packed(a.data, b.data, backend=backend,
                                  policy=policy)
    return out[: a.shape[0], : b.shape[1]]


def bitmm2bit(
    a: BitTensor,
    b: BitTensor,
    out_bits: int,
    out_qp: QuantParams | None = None,
    *,
    backend=None,
    policy=None,
) -> BitTensor:
    """Any-bitwidth MM with requantized low-bit output (paper bitMM2Bit).

    The int32 accumulator is requantized to ``out_bits`` (dynamic min/max
    calibration when ``out_qp`` is None) and re-packed along the last axis,
    ready to serve as the next layer's A operand — the §4.5 inter-layer
    fusion contract.

    With ``policy.fused_requantize`` and a precomputed scalar ``out_qp``,
    the requantize runs inside the GEMM epilogue (api.bitserial_fused) and
    the float accumulator never reaches device memory; the fused floor can
    differ from the unfused path by at most one quantization level (the
    epilogue multiplies by 1/scale instead of dividing by scale).
    """
    from repro_torch import api

    _check_mm(a, b)
    pol = policy if policy is not None else api.current()[1]
    if pol.fused_requantize and out_qp is not None and out_qp.scale.ndim == 0:
        m, n = a.shape[0], b.shape[1]
        alpha = (1.0 / out_qp.scale).broadcast_to((m, 1))
        beta = (-out_qp.zero / out_qp.scale).broadcast_to((1, n))
        q = api.bitserial_fused(a.data, b.data, alpha, beta,
                                out_bits=out_bits, relu=False,
                                backend=backend, policy=pol)
        q = q[:m, :n]
        return to_bit(q, out_bits, qp=out_qp, pack_axis=-1, prequantized=True)
    acc = bitmm2int(a, b, backend=backend, policy=policy)
    accf = acc.to(torch.float32)
    if out_qp is None:
        out_qp = calibrate(accf, out_bits)
    q = quantize(accf, out_qp)
    return to_bit(q, out_bits, qp=out_qp, pack_axis=-1, prequantized=True)
