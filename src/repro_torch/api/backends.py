"""Built-in execution backends: torch_dot, popcount, cuda.

  torch_dot — masked integer matmuls (the reference's xla_dot): int64 on
              the CPU (an int8 matmul there wraps), float64 on the card,
              which has no integer matmul for these shapes and is exact
              while every sum stays below 2**53.
  popcount  — packed AND+popcount in plain torch: the bit-exact oracle.
  cuda      — the hand-written kernels (kernels/ops.py) with zero-tile
              jumping; the default engine. On a CPU tensor each takes its
              plain version.

torch_dot and cuda provide ``wq_mm`` with the same float matmul over the
int8 ``WeightQ`` (the reference's xla_dot einsum), so the default engine
serves it without a fallback. popcount lacks it: under ``use("popcount")``
dispatch falls back to torch_dot, and an explicit ``backend="popcount"``
raises, as in the reference.

All three return IDENTICAL int32 results for any (s, t) in 1..8; torch_dot
and popcount take operands of up to 32 bits, as the reference's xla_dot
and popcount do. The cuda engine supports at most 8 (its kernel shifts by
p + q < 32): wider operands fall back to torch_dot unless ``backend="cuda"``
was asked for, which raises.
"""
from __future__ import annotations

import torch

from repro_torch.api.backend import Backend
from repro_torch.api.registry import register
from repro_torch.core import bitops
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bitpack import quantize_pack
from repro_torch.kernels.bitserial import fused_epilogue

__all__ = ["TorchDotBackend", "PopcountBackend", "CudaBackend"]

_CORE_OPS = frozenset({"bitserial_mm", "bgemm", "bitpack", "bitserial_fused"})


def _wq_mm(x, wq, out_dtype):
    """x (..., K) @ WeightQ (K, N): y = (x @ q) * scale + rowsum(x) * zero,
    float32 throughout, cast to ``out_dtype``."""
    xf = x.to(torch.float32)
    core = torch.matmul(xf, wq.data.to(torch.float32))
    rowsum = torch.sum(xf, dim=-1, keepdim=True)
    return (core * wq.scale + rowsum * wq.zero).to(out_dtype)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b in int64."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


class _PlainTorchBackend(Backend):
    """What torch_dot and popcount share: bitpack and the fused epilogue
    in plain torch over the engine's own bitserial_mm. The plane loops are
    bitwidth-agnostic; exactness is bounded only by the int32 result, as
    in the reference."""
    capabilities = _CORE_OPS
    max_bits = 32

    def bitpack(self, x, scale, zero, *, nbits, policy):
        return quantize_pack(x, scale, zero, nbits)

    def bitserial_fused(self, a_packed, b_packed, alpha, beta, *,
                        out_bits, relu, policy):
        acc = self.bitserial_mm(a_packed, b_packed, policy=policy)
        return fused_epilogue(acc, alpha, beta, out_bits, relu)


class TorchDotBackend(_PlainTorchBackend):
    name = "torch_dot"
    capabilities = _CORE_OPS | {"wq_mm"}

    def bitserial_mm_vals(self, aq, bq, s, t, *, policy):
        # One wide product over the bit-masked values: plane i of
        # bit_decompose reads exactly bit i, so masking to s (t) bits is
        # the plane sum.
        mask_a = (1 << s) - 1 if s < 32 else -1
        mask_b = (1 << t) - 1 if t < 32 else -1
        return bitops.wrap_int32(_int_matmul(aq & mask_a, bq & mask_b))

    def bitserial_mm(self, a_packed, b_packed, *, policy):
        a_planes = bitops.unpack_along_axis(a_packed, dim=2)
        b_planes = bitops.unpack_along_axis(b_packed, dim=1)
        acc = torch.zeros((a_planes.shape[1], b_planes.shape[2]),
                          dtype=torch.int64, device=a_packed.device)
        for i in range(a_planes.shape[0]):
            for j in range(b_planes.shape[0]):
                acc += _int_matmul(a_planes[i], b_planes[j]) << (i + j)
        return bitops.wrap_int32(acc)

    def bgemm(self, a_packed, b_packed, *, policy):
        return self.bitserial_mm(a_packed[None], b_packed[None], policy=policy)

    def wq_mm(self, x, wq, *, policy, out_dtype):
        return _wq_mm(x, wq, out_dtype)


class PopcountBackend(_PlainTorchBackend):
    name = "popcount"

    def bitserial_mm(self, a_packed, b_packed, *, policy):
        return bitops.bitserial_matmul_packed(a_packed, b_packed)

    def bgemm(self, a_packed, b_packed, *, policy):
        return bitops.popcount_matmul_packed(a_packed, b_packed)


class CudaBackend(Backend):
    name = "cuda"
    capabilities = _CORE_OPS | {"wq_mm", "bitserial_jump", "bitserial_sgt"}

    def bitserial_mm(self, a_packed, b_packed, *, policy, tiles=None):
        if policy.reuse:
            return kops.bitserial_gemm(a_packed, b_packed, policy=policy,
                                       tiles=tiles)
        # §4.4 ablation (paper Fig. 9a): one 1-bit bgemm pass per plane
        # pair, so A's words are loaded s*t times instead of once. The
        # tiles are the plane-OR artifacts, valid for every single plane.
        acc = torch.zeros((a_packed.shape[1], b_packed.shape[2]),
                          dtype=torch.int64, device=a_packed.device)
        for i in range(a_packed.shape[0]):
            for j in range(b_packed.shape[0]):
                acc += kops.bgemm(a_packed[i], b_packed[j], policy=policy,
                                  tiles=tiles).to(torch.int64) << (i + j)
        return bitops.wrap_int32(acc)

    def bgemm(self, a_packed, b_packed, *, policy, tiles=None):
        return kops.bgemm(a_packed, b_packed, policy=policy, tiles=tiles)

    def bitpack(self, x, scale, zero, *, nbits, policy):
        out = kops.bitpack(x, scale, zero, nbits=nbits, policy=policy)
        words = -(-x.shape[1] // bitops.WORD)
        return out[:, :, :words]  # crop the block padding words

    def bitserial_fused(self, a_packed, b_packed, alpha, beta, *,
                        out_bits, relu, policy, tiles=None):
        return kops.bitserial_fused(a_packed, b_packed, alpha, beta,
                                    out_bits=out_bits, relu=relu,
                                    policy=policy, tiles=tiles)

    def wq_mm(self, x, wq, *, policy, out_dtype):
        # a plain float product, as on torch_dot: no kernel serves the
        # int8 WeightQ format (kernels/ops.wq_gemm takes pack_w4's nibbles)
        return _wq_mm(x, wq, out_dtype)


register(TorchDotBackend())
register(PopcountBackend())
register(CudaBackend())
