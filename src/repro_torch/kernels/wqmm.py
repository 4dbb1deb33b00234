"""4-bit weight-only quantized matmul (decode GEMV/GEMM): the CUDA kernel
and its plain version.

    x (M, K) float32 or bfloat16  @  W4 packed (K, N/2) uint8
      (+ per-group scales (K/G, N) float32)  ->  (M, N) float32
    W[k, n] = (nibble - 8) * scales[k // G, n]

The reference's ``repro.kernels.wqmm``: the weight streams from device
memory at 4 bits plus its group scales and is dequantized on chip; it never
exists in device memory at full precision. Nibble i of byte j holds column
2j+i, stored as q + 8 with q in [-7, 7].

``wq_gemm`` takes K padded to ``block_k`` (``ops.wq_gemm`` pads) and masks
the ragged M and N edges itself. A CUDA tensor launches the kernel in
``csrc/wqmm.cu``; a CPU tensor takes ``wq_gemm_plain``.
``LAUNCHES["wq_gemm"]`` counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import LAUNCHES, check_cuda, kernel_device, launch

__all__ = ["pack_w4", "wq_gemm", "wq_gemm_plain", "unpack_w4", "LAUNCHES"]

# the kernel keeps block_m rows of sums in registers: one instance per height
_BLOCK_M_CHOICES = (1, 2, 4, 8, 16, 32)
_X_DTYPES = (torch.float32, torch.bfloat16)
_SHARED_BYTES = 227 * 1024  # shared memory one block of an H100 may have
_SLICES = 4  # thread groups that split each K step (kSlices in csrc/wqmm.cu)
_MAX_BLOCK_N = 256  # block_n / 2 * _SLICES threads, at most 512


def _shared_bytes(group: int, block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory of one block: two stages of the packed weight tile
    (block_k x block_n/2 bytes) and its scales, each rounded up to 16 bytes
    as the kernel lays them out (or, if larger, the final reduction of the
    K slices' sums, 8 rows at a time), and x's float32 tile."""
    def pad(nbytes):
        return -(-nbytes // 16) * 16
    stage = pad(block_k * block_n // 2) + pad(4 * (block_k // group) * block_n)
    reduction = (_SLICES - 1) * 8 * block_n * 4  # reuses the stages
    return max(2 * stage, reduction) + 4 * block_m * block_k


def pack_w4(w: torch.Tensor, group: int = 32):
    """(K, N) float -> (packed (K, N/2) uint8, scales (K/G, N) float32).

    Symmetric per-(K-group, column) quantization to [-7, 7], rounded half to
    even, with the reference's float32 steps in its order. The divisor 7 is
    a tensor on ``w``'s device, so the division is never a multiplication
    by a reciprocal.
    """
    k, n = w.shape
    if n % 2 or k % group:
        raise ValueError(f"pack_w4 needs N even and K a multiple of "
                         f"group={group}, got {tuple(w.shape)}")
    wg = w.reshape(k // group, group, n).to(torch.float32)
    seven = torch.tensor(7.0, device=w.device)
    s = torch.amax(torch.abs(wg), dim=1) / seven + 1e-8            # (K/G, N)
    q = torch.clamp(torch.round(wg / s[:, None, :]), -7, 7).to(torch.int32) + 8
    q = q.reshape(k, n)
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8)
    return packed, s


def unpack_w4(w_packed: torch.Tensor, scales: torch.Tensor,
              group: int) -> torch.Tensor:
    """(K, N/2) uint8 + (K/G, N) float32 -> the dequantized (K, N) float32."""
    k, n = w_packed.shape[0], w_packed.shape[1] * 2
    q = w_packed.to(torch.int32)
    lo = (q & 0xF) - 8
    hi = ((q >> 4) & 0xF) - 8
    w = torch.stack([lo, hi], dim=-1).reshape(k, n).to(torch.float32)
    return w * torch.repeat_interleave(scales, group, dim=0)


def _check(x, w_packed, scales, group, block_m, block_n, block_k):
    if x.ndim != 2 or w_packed.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"expected x (M, K), w_packed (K, N/2) and scales "
                         f"(K/G, N), got {tuple(x.shape)}, "
                         f"{tuple(w_packed.shape)} and {tuple(scales.shape)}")
    m, k = x.shape
    n = w_packed.shape[1] * 2
    if w_packed.shape[0] != k:
        raise ValueError(f"x has K={k}, w_packed {w_packed.shape[0]} rows")
    if block_k % group or k % block_k:
        raise ValueError(f"block_k={block_k} must be a multiple of "
                         f"group={group}, and K={k} of block_k")
    if tuple(scales.shape) != (k // group, n):
        raise ValueError(f"scales must be {(k // group, n)}, got "
                         f"{tuple(scales.shape)}")
    if block_n % 2 or not 2 <= block_n <= _MAX_BLOCK_N:
        raise ValueError(f"block_n must be even and in 2..{_MAX_BLOCK_N}, "
                         f"got {block_n}")
    if block_m < 1:
        raise ValueError(f"block_m must be positive, got {block_m}")


def wq_gemm(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor, *,
            group: int, block_m: int, block_n: int,
            block_k: int) -> torch.Tensor:
    """x (M, K) @ the 4-bit W (K, N) -> (M, N) float32; K a multiple of
    ``block_k``, which is a multiple of ``group``.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation): one block per (block_m, block_n) output tile, K walked
    inside it ``block_k`` at a time, each step split over four groups of
    threads. CPU tensors take ``wq_gemm_plain``.
    """
    _check(x, w_packed, scales, group, block_m, block_n, block_k)
    device = kernel_device(x, w_packed, scales)
    if device is None:
        return wq_gemm_plain(x, w_packed, scales, group=group)
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda("x", x, device, x.dtype)
    check_cuda("w_packed", w_packed, device, torch.uint8)
    check_cuda("scales", scales, device, torch.float32)
    if block_m not in _BLOCK_M_CHOICES:
        raise ValueError(f"block_m must be one of {_BLOCK_M_CHOICES}, got {block_m}")
    if _shared_bytes(group, block_m, block_n, block_k) > _SHARED_BYTES:
        raise ValueError(f"tiles ({block_m}, {block_n}, {block_k}) at group "
                         f"{group} exceed {_SHARED_BYTES} bytes of shared memory")
    m, k = x.shape
    n = w_packed.shape[1] * 2
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    args = (x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, n, k, group, block_m, block_n, block_k,
            int(x.dtype == torch.bfloat16))
    return launch("wq_gemm", out, args, device)


def wq_gemm_plain(x: torch.Tensor, w_packed: torch.Tensor,
                  scales: torch.Tensor, *, group: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device, as the
    reference's oracle computes it: unpack, subtract 8, multiply by the
    repeated scales, then ``x.float() @ w``."""
    return x.to(torch.float32) @ unpack_w4(w_packed, scales, group)
