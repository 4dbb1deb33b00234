"""Built-in execution backends: torch_dot, popcount, cuda.

  torch_dot — masked integer matmuls (the reference's xla_dot): int64 on
              the CPU; on the card, which has no int64 matmul, 7-bit limbs
              of the operands through int8 x int8 -> int32 products
              (``int_matmul_mod32``), exact modulo 2**32 for every int32
              input, as the reference's int32 dot is. No float GEMM runs.
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
import torch.nn.functional as F

from repro_torch.api.backend import Backend
from repro_torch.api.registry import register
from repro_torch.core import bitops
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bitpack import quantize_pack
from repro_torch.kernels.bitserial import fused_epilogue

__all__ = ["TorchDotBackend", "PopcountBackend", "CudaBackend",
           "int_matmul_mod32"]

_CORE_OPS = frozenset({"bitserial_mm", "bgemm", "bitpack", "bitserial_fused"})


def _wq_mm(x, wq, out_dtype):
    """x (..., K) @ WeightQ (K, N): y = (x @ q) * scale + rowsum(x) * zero,
    float32 throughout, cast to ``out_dtype``."""
    xf = x.to(torch.float32)
    core = torch.matmul(xf, wq.data.to(torch.float32))
    rowsum = torch.sum(xf, dim=-1, keepdim=True)
    return (core * wq.scale + rowsum * wq.zero).to(out_dtype)


_LIMB = 7              # a limb's values, 0..127, fit int8
_K_CHUNK = 1 << 17     # 127 * 127 * 2**17 < 2**31: a chunk's int32 sum is exact


def _int8_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) @ (K, N) of int8 tensors as int64, through
    ``torch._int_mm`` (int8 x int8 -> int32 on the card's integer tensor
    cores). K is split so that no int32 sum can overflow; the operands
    are zero-padded to its CUDA shape rules (more than 16 rows, K and N
    multiples of 8) and the result cropped."""
    (m, k), n = a8.shape, b8.shape[1]
    pad_k = -k % 8
    a8 = F.pad(a8, (0, pad_k, 0, max(m + -m % 8, 24) - m))
    b8 = F.pad(b8, (0, -n % 8, 0, pad_k))
    acc = 0
    for k0 in range(0, k + pad_k, _K_CHUNK):
        acc = acc + torch._int_mm(a8[:, k0:k0 + _K_CHUNK].contiguous(),
                                  b8[k0:k0 + _K_CHUNK].contiguous()
                                  ).to(torch.int64)
    return acc[:m, :n]


def int_matmul_mod32(a: torch.Tensor, b: torch.Tensor, s: int = 32,
                     t: int = 32) -> torch.Tensor:
    """The low s bits of ``a`` (M, K) times the low t bits of ``b`` (K, N),
    as int64 equal to the exact product modulo 2**32, with no float GEMM.

    Each operand, taken as unsigned words, splits into 7-bit limbs
    (``a = sum_i a_i 2^(7i)``); the limb products are exact int8 GEMMs,
    and ``sum_ij (a_i @ b_j) << 7(i + j)`` is the product. Pairs shifted
    by 32 or more vanish modulo 2**32 and are skipped: at s = t = 8 four
    products, at 32 fifteen. Runs on any device; it is torch_dot's route
    on the card.
    """
    a = a.to(torch.int64) & ((1 << s) - 1)
    b = b.to(torch.int64) & ((1 << t) - 1)
    limbs_b = [((b >> (_LIMB * j)) & 0x7F).to(torch.int8)
               for j in range(-(-t // _LIMB))]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for i in range(-(-s // _LIMB)):
        a_i = ((a >> (_LIMB * i)) & 0x7F).to(torch.int8)
        for j, b_j in enumerate(limbs_b):
            if _LIMB * (i + j) < 32:
                acc += _int8_matmul(a_i, b_j) << (_LIMB * (i + j))
    return acc


def _int_matmul(a: torch.Tensor, b: torch.Tensor, s: int,
                t: int) -> torch.Tensor:
    """The low s bits of a times the low t bits of b, equal to the exact
    integer product modulo 2**32: int64 on the CPU, the limb route on the
    card."""
    mask_a = (1 << s) - 1 if s < 32 else -1
    mask_b = (1 << t) - 1 if t < 32 else -1
    if a.device.type == "cpu":
        return (a & mask_a).to(torch.int64) @ (b & mask_b).to(torch.int64)
    return int_matmul_mod32(a, b, s, t)


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
        return bitops.wrap_int32(_int_matmul(aq, bq, s, t))

    def bitserial_mm(self, a_packed, b_packed, *, policy):
        a_planes = bitops.unpack_along_axis(a_packed, dim=2)
        b_planes = bitops.unpack_along_axis(b_packed, dim=1)
        acc = torch.zeros((a_planes.shape[1], b_planes.shape[2]),
                          dtype=torch.int64, device=a_packed.device)
        for i in range(a_planes.shape[0]):
            for j in range(b_planes.shape[0]):
                acc += _int_matmul(a_planes[i], b_planes[j], 1, 1) << (i + j)
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
