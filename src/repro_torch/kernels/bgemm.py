"""1-bit GEMM by AND + popcount: the CUDA kernel and its plain version.

    A (M, W) x B (W, N) 32-bit words  ->  C (M, N) int32
    C[m, n] = sum_w popcount(A[m, w] & B[w, n])

The reference's ``repro.kernels.bgemm.bgemm`` in both compute modes. It
takes the same padded operands and jump artifacts as
``bitserial.bitserial_gemm`` (M padded to ``block_m``, W to ``block_w``, N
masked by the kernel). A CUDA tensor launches a kernel in ``csrc/bgemm.cu``,
the CUDA-core one at ``mode="vpu"`` and the b1 tensor-core one at 'mxu'; a
CPU tensor takes ``bgemm_plain`` in either mode. ``LAUNCHES["bgemm"]`` and
``LAUNCHES["bgemm_mxu"]`` count the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels._build import LAUNCHES, kernel_device, launch

__all__ = ["bgemm", "bgemm_plain", "LAUNCHES"]


def _check_2d(a, b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected A (M, W) and B (W, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def bgemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int, block_n: int,
          block_w: int, occupancy: torch.Tensor | None = None,
          compact: tuple | None = None,
          sgt: tuple | None = None, mode: str = "vpu") -> torch.Tensor:
    """(M, W) x (W, N) -> (M, N) int32 on the padded grid.

    CUDA tensors launch the ``mode``'s kernel on the current stream (no
    synchronisation); CPU tensors take ``bgemm_plain``.
    """
    _check_2d(a, b)
    name = _bitserial.kernel_name("bgemm", mode)
    device = kernel_device(a, b)
    if device is None:
        return bgemm_plain(a, b, block_m=block_m, block_w=block_w,
                           occupancy=occupancy, compact=compact, sgt=sgt)
    out, args = _bitserial.tile_launch_args(name, a[None], b[None], block_m,
                                            block_n, block_w, occupancy,
                                            compact, sgt)
    # the 1-bit launch takes no plane counts (s, t)
    return launch(name, out, args[:3] + args[5:], device)


def bgemm_plain(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                block_w: int, occupancy: torch.Tensor | None = None,
                compact: tuple | None = None,
                sgt: tuple | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the bit-serial
    plain version at one plane each, honouring the same artifacts."""
    _check_2d(a, b)
    return _bitserial.bitserial_gemm_plain(
        a[None], b[None], block_m=block_m, block_w=block_w,
        occupancy=occupancy, compact=compact, sgt=sgt)
