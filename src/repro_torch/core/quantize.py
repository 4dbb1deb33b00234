"""Quantization primitives (paper Eq. 2) and QAT fake-quant with STE.

A float ``a`` maps to an UNSIGNED q-bit integer

    a_q = floor((a - a_min) / scale),   scale = (a_max - a_min) / 2**q

clipped to [0, 2**q - 1]; ``a ≈ a_q * scale + a_min`` inverts it. The
integer GEMMs run on the unsigned a_q values and
``affine_matmul_correction`` recovers the float product.

The arithmetic is written step for step as in the JAX reference
(``repro.core.quantize``) so that the quantized integers match it bit
for bit: the subtraction and the division stay two rounded steps, never a
fused or reciprocal form.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantParams", "calibrate", "quantize", "quantize_stochastic",
           "dequantize", "fake_quant", "affine_matmul_correction"]


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization parameters of one tensor.

    ``scale`` and ``zero`` (= a_min) are 0-d tensors, or tensors that
    broadcast against the quantized tensor (per-row scales of shape (M, 1)).
    """

    nbits: int
    scale: torch.Tensor
    zero: torch.Tensor  # the a_min offset; quantized 0 maps to this float

    @property
    def qmax(self) -> int:
        return (1 << self.nbits) - 1


def calibrate(x: torch.Tensor, nbits: int, dim: int | None = None,
              eps: float = 1e-8) -> QuantParams:
    """Min/max calibration (the paper's empirical a_min/a_max)."""
    if dim is None:
        a_min, a_max = torch.amin(x), torch.amax(x)
    else:
        a_min = torch.amin(x, dim=dim, keepdim=True)
        a_max = torch.amax(x, dim=dim, keepdim=True)
    scale = (a_max - a_min) / (1 << nbits)
    scale = torch.clamp(scale, min=eps)
    return QuantParams(nbits=nbits, scale=scale, zero=a_min)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Eq. 2: floor((x - a_min) / scale), clipped to the q-bit range, int32."""
    q = torch.floor((x - qp.zero) / qp.scale)
    return torch.clamp(q, 0, qp.qmax).to(torch.int32)


def quantize_stochastic(x: torch.Tensor, qp: QuantParams,
                        u: torch.Tensor | None = None, *,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Eq. 2 with stochastic rounding: floor((x - a_min)/scale + u), u~U[0,1).

    E[dequantize(q)] == clip(x): the rounding error is zero-mean, so it does
    not pile up across training steps as floor-rounding's bias does. ``u``
    is the uniform draw itself, of x's shape; without it one is drawn from
    ``generator`` on x's device. With ``u == 0`` this is :func:`quantize`.
    """
    v = (x - qp.zero) / qp.scale
    if u is None:
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
    return torch.clamp(torch.floor(v + u), 0, qp.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return q.to(torch.float32) * qp.scale + qp.zero


def in_range(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """The STE gate: True where quantize() does not clip, i.e. x in
    [zero, zero + scale * 2**nbits). The upper bound is strict: there floor
    gives 2**nbits, which is clipped to qmax."""
    return (x >= qp.zero) & (x < qp.zero + qp.scale * (qp.qmax + 1))


class _FakeQuant(torch.autograd.Function):
    """dequantize(quantize(x)) forward; the gradient passes where x is in
    range and is zero where quantize() clipped it."""

    @staticmethod
    def forward(ctx, x, nbits, qp):
        if qp is None:
            qp = calibrate(x, nbits)
        ctx.save_for_backward(in_range(x, qp))
        return dequantize(quantize(x, qp), qp)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, 0.0), None, None


def fake_quant(x: torch.Tensor, nbits: int,
               qp: QuantParams | None = None) -> torch.Tensor:
    """QAT fake-quantization with a straight-through estimator.

    Forward: dequantize(quantize(x)), calibrated on x unless ``qp`` is
    given; backward: identity within the clip range, zero outside.
    """
    return _FakeQuant.apply(x, nbits, qp)


def affine_matmul_correction(aq: torch.Tensor, bq: torch.Tensor,
                             qa: QuantParams, qb: QuantParams,
                             int_prod: torch.Tensor) -> torch.Tensor:
    """Recover the float matmul A@B from the exact integer product Aq@Bq.

    sum_k (aq*s_a + m_a)(bq*s_b + m_b)
      = s_a s_b * int_prod + s_a m_b * rowsum(aq) + s_b m_a * colsum(bq)
        + K * m_a m_b
    """
    k = aq.shape[-1]
    row = torch.sum(aq, dim=-1, keepdim=True).to(torch.float32)
    col = torch.sum(bq, dim=-2, keepdim=True).to(torch.float32)
    return (
        qa.scale * qb.scale * int_prod.to(torch.float32)
        + qa.scale * qb.zero * row
        + qb.scale * qa.zero * col
        + k * qa.zero * qb.zero
    )
