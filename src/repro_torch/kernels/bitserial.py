"""Any-bitwidth bit-serial GEMM, plain and fused: the CUDA kernel and its
plain version.

    A (s, M, W) x B (t, W, N) 32-bit words  ->  C (M, N) int32
    C = sum_{i<s, j<t} 2^(i+j) * popcount_gemm(A_i, B_j)

``bitserial_fused`` adds the §4.5 epilogue on the way out:
y = f32(C) * alpha[row] + beta[col], ReLU if asked, floor, clip to
[0, 2^out_bits - 1], int32.

Both take operands already padded to the tile grid (M to ``block_m``, W to
``block_w``; N is not padded, the kernel masks it) and at most one jump
artifact, as the reference's ``repro.kernels.bitserial`` does:

  occupancy (MT, KT)        mask: skip the k-tiles marked 0
  compact (idx, cnt, S)     visit only idx[i, :min(cnt[i], S)], k-tiles
  sgt (idx, cnt, S_w)       the same over single words

A CUDA tensor goes to a kernel in ``csrc/bitserial.cu``, a CPU tensor to
the ``*_plain`` version, which honours the same artifacts: it sums only
the tiles or words they list, so a wrong artifact shows on the CPU as it
would on the card. There is no fallback from one to the other.

``mode`` picks the kernel, as it picks the compute unit in the reference:
'vpu' the popcount kernel on the CUDA cores (``bitserial_tile.cuh``),
'mxu' the b1 tensor-core kernel (``bitserial_mma.cuh``). Both return the
same int32, and so does the plain version, which does not depend on the
mode. ``LAUNCHES["bitserial_gemm"]``, ``["bitserial_fused"]`` and their
``*_mxu`` twins count the launches (``kernels/_build.py`` builds and loads
the library).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitops import popcount32, wrap_int32
from repro_torch.kernels._build import (LAUNCHES, check_cuda, kernel_device,
                                       launch, reset_launches)

__all__ = ["bitserial_gemm", "bitserial_gemm_plain", "bitserial_fused",
           "bitserial_fused_plain", "fused_epilogue", "kernel_name",
           "LAUNCHES", "reset_launches", "MAX_THREADS", "MAX_BITS",
           "MAX_OUT_BITS"]

# block_m * block_n must be whole warps and at most this: the bound of the
# first kernels, which ran a block of block_m * block_n threads. Neither
# kernel's launch follows the tile now ('vpu' a warp a row, 'mxu' a warp a
# 16-row strip); the bound stays so that the policies accepted before are
# accepted still, and no others, in either mode.
MAX_THREADS = 1024
MAX_BITS = 8            # p + q < 32 keeps the kernel's shift defined
MAX_OUT_BITS = 30       # 2^out_bits - 1 stays an int32 after float rounding

_DENSE, _MASK, _LIST = 0, 1, 2


def _schedule(a, b, block_m, block_w, occupancy, compact, sgt):
    """Check shapes and pick (schedule, kw, steps, occ, idx, cnt)."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"expected A (s, M, W) and B (t, W, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    _, m, w = a.shape
    if b.shape[1] != w:
        raise ValueError(f"word counts differ: A {tuple(a.shape)}, "
                         f"B {tuple(b.shape)}")
    if m % block_m or w % block_w:
        raise ValueError(f"A {tuple(a.shape)} is not padded to the "
                         f"(block_m={block_m}, block_w={block_w}) grid")
    mt, kt = m // block_m, w // block_w
    if sum(x is not None for x in (occupancy, compact, sgt)) > 1:
        raise ValueError("pass at most one of occupancy, compact, sgt")
    if occupancy is not None:
        if tuple(occupancy.shape) != (mt, kt):
            raise ValueError(f"occupancy {tuple(occupancy.shape)} != "
                             f"({mt}, {kt})")
        return _MASK, block_w, kt, occupancy, None, None
    if compact is None and sgt is None:
        return _DENSE, block_w, kt, None, None, None
    idx, cnt, steps = compact if compact is not None else sgt
    kw, bound = (block_w, kt) if compact is not None else (1, w)
    steps = max(int(steps), 1)  # all-zero A: one guarded (no-op) step
    if steps > bound:
        raise ValueError(f"step count {steps} exceeds the {bound} K tiles")
    if idx.ndim != 2 or idx.shape[0] != mt or idx.shape[1] < steps or \
            tuple(cnt.shape) != (mt,):
        raise ValueError(f"jump artifacts idx {tuple(idx.shape)}, cnt "
                         f"{tuple(cnt.shape)} do not fit {mt} row tiles "
                         f"and {steps} steps")
    return _LIST, kw, steps, None, idx, cnt


def kernel_name(base: str, mode: str) -> str:
    """The kernel that serves ``base`` in compute ``mode``: ``base`` for
    'vpu', ``base + "_mxu"`` for 'mxu'."""
    if mode not in ("vpu", "mxu"):
        raise ValueError(f"mode must be 'vpu' or 'mxu', got {mode!r}")
    return base if mode == "vpu" else f"{base}_mxu"


def tile_launch_args(name, a, b, block_m, block_n, block_w, occupancy, compact, sgt):
    """Check a launch of a tile kernel (bit-serial, fused or 1-bit, in
    either mode); returns (out, the launch's arguments from A to steps)."""
    schedule, kw, steps, occ, idx, cnt = _schedule(
        a, b, block_m, block_w, occupancy, compact, sgt)
    s, m, w = a.shape
    t, _, n = b.shape
    if not (1 <= s <= MAX_BITS and 1 <= t <= MAX_BITS):
        raise ValueError(f"{name} takes 1..{MAX_BITS} bit planes, got "
                         f"s={s}, t={t}")
    if block_m * block_n > MAX_THREADS or (block_m * block_n) % 32:
        raise ValueError(f"block_m * block_n = {block_m * block_n} must be a "
                         f"multiple of 32 and at most {MAX_THREADS}")
    for nm, x in (("A", a), ("B", b), ("occupancy", occ), ("idx", idx),
                  ("counts", cnt)):
        if x is not None:
            check_cuda(nm, x, a.device, torch.int32)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), s, t, m, w, n,
            block_m, block_n, kw, schedule, ptr(occ), ptr(idx),
            idx.shape[1] if idx is not None else 0, ptr(cnt), steps)
    return out, args


def bitserial_gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                   block_n: int, block_w: int,
                   occupancy: torch.Tensor | None = None,
                   compact: tuple | None = None,
                   sgt: tuple | None = None,
                   mode: str = "vpu") -> torch.Tensor:
    """(s, M, W) x (t, W, N) -> (M, N) int32 on the padded grid.

    CUDA tensors launch the ``mode``'s kernel on the current stream (no
    synchronisation); CPU tensors take ``bitserial_gemm_plain``.
    """
    name = kernel_name("bitserial_gemm", mode)
    device = kernel_device(a, b)
    if device is None:
        return bitserial_gemm_plain(a, b, block_m=block_m, block_w=block_w,
                                    occupancy=occupancy, compact=compact,
                                    sgt=sgt)
    out, args = tile_launch_args(name, a, b, block_m, block_n, block_w,
                                 occupancy, compact, sgt)
    return launch(name, out, args, device)


def _check_epilogue(alpha, beta, m, n, out_bits):
    if tuple(alpha.shape) != (m, 1) or tuple(beta.shape) != (1, n):
        raise ValueError(f"alpha {tuple(alpha.shape)} and beta "
                         f"{tuple(beta.shape)} must be ({m}, 1) and (1, {n})")
    if not 1 <= out_bits <= MAX_OUT_BITS:
        raise ValueError(f"out_bits must be in 1..{MAX_OUT_BITS}, got {out_bits}")


# lint: allow[kernel-int-purity] — the §4.5 epilogue's float32 alpha, beta
# and clip bound go to the kernel; its GEMM accumulator stays int32
def bitserial_fused(a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor, *, out_bits: int, relu: bool,
                    block_m: int, block_n: int, block_w: int,
                    occupancy: torch.Tensor | None = None,
                    compact: tuple | None = None,
                    sgt: tuple | None = None,
                    mode: str = "vpu") -> torch.Tensor:
    """``bitserial_gemm`` with the fused epilogue: (M, N) int32 in
    [0, 2^out_bits - 1]. ``alpha`` is (M, 1) float32 on the padded rows,
    ``beta`` (1, N) float32. CPU tensors take ``bitserial_fused_plain``."""
    name = kernel_name("bitserial_fused", mode)
    device = kernel_device(a, b)
    _check_epilogue(alpha, beta, a.shape[1], b.shape[2], out_bits)
    if device is None:
        return bitserial_fused_plain(a, b, alpha, beta, out_bits=out_bits,
                                     relu=relu, block_m=block_m,
                                     block_w=block_w, occupancy=occupancy,
                                     compact=compact, sgt=sgt)
    out, args = tile_launch_args(name, a, b, block_m, block_n, block_w,
                                 occupancy, compact, sgt)
    check_cuda("alpha", alpha, device, torch.float32)
    check_cuda("beta", beta, device, torch.float32)
    args += (alpha.data_ptr(), beta.data_ptr(), float((1 << out_bits) - 1),
             int(relu))
    return launch(name, out, args, device)


def _visit_counts(schedule, kw, steps, occ, idx, cnt, mt, w, device):
    """(MT, W) int64: how often row tile i's K loop visits word w."""
    kt = w // kw
    if schedule == _DENSE:
        tiles = torch.ones((mt, kt), dtype=torch.int64, device=device)
    elif schedule == _MASK:
        tiles = (occ != 0).to(torch.int64)
    else:
        ids = idx[:, :steps].to(torch.int64)
        live = (torch.arange(steps, device=device)[None, :]
                < cnt.to(torch.int64)[:, None])
        live &= (ids >= 0) & (ids < kt)  # the kernel skips ids off the grid
        tiles = torch.zeros((mt, kt), dtype=torch.int64, device=device)
        tiles.scatter_add_(1, ids.clamp(0, max(kt - 1, 0)), live.to(torch.int64))
    return tiles.repeat_interleave(kw, dim=1)


def bitserial_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                         block_w: int, occupancy: torch.Tensor | None = None,
                         compact: tuple | None = None,
                         sgt: tuple | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    Each word's popcount is weighted by how often the schedule visits it,
    so the result is the sum over exactly the tiles or words the artifacts
    list (a tile listed twice counts twice, as in the kernel). Sums in
    int64 and wraps to int32 at the end.
    """
    schedule, kw, steps, occ, idx, cnt = _schedule(
        a, b, block_m, block_w, occupancy, compact, sgt)
    s, m, w = a.shape
    t, _, n = b.shape
    visits = _visit_counts(schedule, kw, steps, occ, idx, cnt, m // block_m,
                           w, a.device).repeat_interleave(block_m, dim=0)
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    for i in range(s):
        for j in range(t):
            terms = popcount32(a[i][:, :, None] & b[j][None, :, :])
            acc += (terms * visits[:, :, None]).sum(dim=1) << (i + j)
    return wrap_int32(acc)


# lint: allow[kernel-int-purity] — the §4.5 requantize epilogue is float
# by design, after the integer GEMM
def fused_epilogue(acc: torch.Tensor, alpha, beta, out_bits: int,
                   relu: bool) -> torch.Tensor:
    """alpha*acc+beta -> (relu) -> floor+clip to unsigned out_bits (§4.5).

    Two IEEE float32 steps, the product then the sum, as in the reference's
    ``_store`` and ``_fused_epilogue``; int32 out.
    """
    y = acc.to(torch.float32) * alpha + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.floor(y), 0, (1 << out_bits) - 1).to(torch.int32)


def bitserial_fused_plain(a: torch.Tensor, b: torch.Tensor,
                          alpha: torch.Tensor, beta: torch.Tensor, *,
                          out_bits: int, relu: bool, block_m: int,
                          block_w: int, occupancy: torch.Tensor | None = None,
                          compact: tuple | None = None,
                          sgt: tuple | None = None) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch, on any device."""
    acc = bitserial_gemm_plain(a, b, block_m=block_m, block_w=block_w,
                               occupancy=occupancy, compact=compact, sgt=sgt)
    return fused_epilogue(acc, alpha, beta, out_bits, relu)
