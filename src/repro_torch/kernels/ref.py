"""The reference's oracle names (``repro.kernels.ref``), bound to the port's
plain versions.

Each hand-written kernel of the port has a plain PyTorch version beside its
wrapper, which computes what the kernel computes on a CPU tensor (its
padding included); the tests hold the kernels and the reference's Pallas
kernels to them. This module only names them as the reference does, so a
reader looking for an oracle finds its counterpart:

  bgemm_ref           kernels.bgemm.bgemm_plain
  bitserial_gemm_ref  kernels.bitserial.bitserial_gemm_plain
  bitserial_fused_ref kernels.bitserial.bitserial_fused_plain
  bitpack_ref         kernels.bitpack.bitpack_plain
  wq_gemm_ref         kernels.wqmm.wq_gemm_plain

Their signatures are the plain versions' (packed int32 words and the tile
keywords the wrappers take), not the reference's.
"""
from __future__ import annotations

from repro_torch.kernels.bgemm import bgemm_plain as bgemm_ref
from repro_torch.kernels.bitpack import bitpack_plain as bitpack_ref
from repro_torch.kernels.bitserial import \
    bitserial_fused_plain as bitserial_fused_ref
from repro_torch.kernels.bitserial import \
    bitserial_gemm_plain as bitserial_gemm_ref
from repro_torch.kernels.wqmm import wq_gemm_plain as wq_gemm_ref

__all__ = ["bgemm_ref", "bitserial_gemm_ref", "bitserial_fused_ref",
           "bitpack_ref", "wq_gemm_ref"]
