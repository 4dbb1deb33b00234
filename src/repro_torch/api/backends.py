"""Built-in execution backends: torch_dot, popcount, cuda.

  torch_dot — masked integer matmuls (the reference's xla_dot): int64 on
              the CPU (an int8 matmul there wraps), float64 on the card,
              which has no integer matmul for these shapes and is exact
              while every sum stays below 2**53.
  popcount  — packed AND+popcount in plain torch: the bit-exact oracle.
  cuda      — the hand-written bit-serial kernel (kernels/ops.py) with
              zero-tile jumping; the default engine. On a CPU tensor it
              takes the kernel's plain version.

All three return IDENTICAL int32 results for any (s, t) in 1..8.
"""
from __future__ import annotations

import torch

from repro_torch.api.backend import Backend
from repro_torch.api.registry import register
from repro_torch.core import bitops
from repro_torch.kernels import ops as kops

__all__ = ["TorchDotBackend", "PopcountBackend", "CudaBackend"]


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b in int64."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


class TorchDotBackend(Backend):
    name = "torch_dot"
    capabilities = frozenset({"bitserial_mm"})

    def bitserial_mm_vals(self, aq, bq, s, t, *, policy):
        # One wide product over the bit-masked values: plane i of
        # bit_decompose reads exactly bit i, so masking to s (t) bits is
        # the plane sum.
        prod = _int_matmul(aq & ((1 << s) - 1), bq & ((1 << t) - 1))
        return bitops.wrap_int32(prod)

    def bitserial_mm(self, a_packed, b_packed, *, policy):
        a_planes = bitops.unpack_along_axis(a_packed, dim=2)
        b_planes = bitops.unpack_along_axis(b_packed, dim=1)
        acc = torch.zeros((a_planes.shape[1], b_planes.shape[2]),
                          dtype=torch.int64, device=a_packed.device)
        for i in range(a_planes.shape[0]):
            for j in range(b_planes.shape[0]):
                acc += _int_matmul(a_planes[i], b_planes[j]) << (i + j)
        return bitops.wrap_int32(acc)


class PopcountBackend(Backend):
    name = "popcount"
    capabilities = frozenset({"bitserial_mm"})

    def bitserial_mm(self, a_packed, b_packed, *, policy):
        return bitops.bitserial_matmul_packed(a_packed, b_packed)


class CudaBackend(Backend):
    name = "cuda"
    capabilities = frozenset({"bitserial_mm", "bitserial_jump", "bitserial_sgt"})

    def bitserial_mm(self, a_packed, b_packed, *, policy, tiles=None):
        if not policy.reuse:
            raise NotImplementedError(
                "reuse=False runs one 1-bit bgemm pass per plane pair; "
                "the bgemm kernel is not ported yet")
        return kops.bitserial_gemm(a_packed, b_packed, policy=policy,
                                   tiles=tiles)


register(TorchDotBackend())
register(PopcountBackend())
register(CudaBackend())
