"""Quantize (Eq. 2) and 3D-stacked bit compression (§4.2): the CUDA kernel
and its plain version.

    x (M, K) float32, scalar scale and zero  ->  (nbits, M, words) int32
    q = clip(floor((x - zero) / scale), 0, 2^nbits - 1), columns >= K zero,
    packed 32 per word along K, little-endian, one plane per bit

The reference's ``repro.kernels.bitpack.bitpack``. ``words`` is the word
count of the output, at least ceil(K / 32); the words past the last column
are zero, as the reference's block padding is. Words are int32 bit
patterns, as everywhere in the port. A CUDA tensor launches the kernel in
``csrc/bitpack.cu``; a CPU tensor takes ``bitpack_plain``.
``LAUNCHES["bitpack"]`` counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels._build import LAUNCHES, check_cuda, kernel_device, launch

__all__ = ["bitpack", "bitpack_plain", "quantize_pack", "LAUNCHES"]


def _scalar(name, v, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``; raises unless ``v`` is one value.

    On the card the kernel reads it from device memory, and the plain
    version divides by a device tensor: a host scalar would make torch
    multiply by its reciprocal instead, which rounds differently."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.numel() != 1:
        raise ValueError(f"{name} must be a scalar, got shape {tuple(v.shape)}")
    return v.reshape(())


def _check(x, nbits, words):
    if x.ndim != 2:
        raise ValueError(f"expected x (M, K), got {tuple(x.shape)}")
    if words < -(-x.shape[1] // bitops.WORD):
        raise ValueError(f"{words} words cannot hold K={x.shape[1]} columns")
    if not 1 <= nbits <= _bitserial.MAX_BITS:
        raise ValueError(f"nbits must be in 1..{_bitserial.MAX_BITS}, got {nbits}")


def bitpack(x: torch.Tensor, scale, zero, *, nbits: int,
            words: int) -> torch.Tensor:
    """(M, K) float32 -> (nbits, M, words) int32 packed planes.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors take ``bitpack_plain``.
    """
    _check(x, nbits, words)
    device = kernel_device(x)
    if device is None:
        return bitpack_plain(x, scale, zero, nbits=nbits, words=words)
    scale_t, zero_t = _scalar("scale", scale, device), _scalar("zero", zero, device)
    check_cuda("x", x, device, torch.float32)
    m, k = x.shape
    out = torch.empty((nbits, m, words), dtype=torch.int32, device=x.device)
    args = (x.data_ptr(), scale_t.data_ptr(), zero_t.data_ptr(),
            out.data_ptr(), m, k, words, nbits, float((1 << nbits) - 1))
    return launch("bitpack", out, args, device)


def quantize_pack(x: torch.Tensor, scale, zero, nbits: int) -> torch.Tensor:
    """(M, K) -> (nbits, M, ceil(K/32)): the reference's two rounded steps,
    floor and clip, then ``bitops.pack_a``. Any nbits ``pack_a`` takes."""
    scale_t, zero_t = _scalar("scale", scale, x.device), _scalar("zero", zero, x.device)
    q = torch.clamp(torch.floor((x.to(torch.float32) - zero_t) / scale_t), 0,
                    (1 << nbits) - 1)
    return bitops.pack_a(q.to(torch.int32), nbits)


def bitpack_plain(x: torch.Tensor, scale, zero, *, nbits: int,
                  words: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    _check(x, nbits, words)
    packed = quantize_pack(x, scale, zero, nbits)
    return torch.nn.functional.pad(packed, (0, words - packed.shape[2]))
