"""Any-bitwidth bit-serial GEMM: the CUDA kernel and its plain version.

    A (s, M, W) x B (t, W, N) 32-bit words  ->  C (M, N) int32
    C = sum_{i<s, j<t} 2^(i+j) * popcount_gemm(A_i, B_j)

``bitserial_gemm`` takes operands already padded to the tile grid (M to
``block_m``, W to ``block_w``; N is not padded, the kernel masks it) and
at most one jump artifact, as the reference's
``repro.kernels.bitserial.bitserial_gemm`` does:

  occupancy (MT, KT)        mask: skip the k-tiles marked 0
  compact (idx, cnt, S)     visit only idx[i, :min(cnt[i], S)], k-tiles
  sgt (idx, cnt, S_w)       the same over single words

A CUDA tensor goes to the kernel in ``csrc/bitserial.cu``, a CPU tensor
to ``bitserial_gemm_plain``, which honours the same artifacts: it sums
only the tiles or words they list, so a wrong artifact shows on the CPU
as it would on the card. There is no fallback from one to the other.

The kernel is built at first use with ``nvcc`` from the sources in this
package into ``build/repro_torch/`` at the repository root, and loaded
with ctypes. ``LAUNCHES["bitserial_gemm"]`` counts its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from repro_torch.core.bitops import popcount32, wrap_int32

__all__ = ["bitserial_gemm", "bitserial_gemm_plain", "build", "LAUNCHES",
           "reset_launches", "MAX_THREADS", "MAX_BITS"]

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "bitserial.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_THREADS = 1024      # one thread per output element of a (block_m, block_n) tile
MAX_BITS = 8            # p + q < 32 keeps the kernel's shift defined

_DENSE, _MASK, _LIST = 0, 1, 2

LAUNCHES = {"bitserial_gemm": 0}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build() -> pathlib.Path:
    """Compile ``csrc/bitserial.cu`` unless a library of this exact source
    exists; returns the shared library's path. The library's name carries
    a hash of the source and flags, and is renamed into place whole, so
    concurrent builds never load a half-written file."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libbitserial-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.bitserial_gemm_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p, p, i, p, i, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _check_cuda(name, x, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bitserial_gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                   block_n: int, block_w: int,
                   occupancy: torch.Tensor | None = None,
                   compact: tuple | None = None,
                   sgt: tuple | None = None) -> torch.Tensor:
    """(s, M, W) x (t, W, N) -> (M, N) int32 on the padded grid.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors take ``bitserial_gemm_plain``.
    """
    if a.device != b.device:
        raise ValueError(f"A is on {a.device}, B on {b.device}")
    if a.device.type == "cpu":
        return bitserial_gemm_plain(a, b, block_m=block_m, block_w=block_w,
                                    occupancy=occupancy, compact=compact,
                                    sgt=sgt)
    if a.device.type != "cuda":
        raise ValueError(f"bitserial_gemm runs on cuda or cpu tensors, "
                         f"got {a.device}")
    schedule, kw, steps, occ, idx, cnt = _schedule(
        a, b, block_m, block_w, occupancy, compact, sgt)
    s, m, w = a.shape
    t, _, n = b.shape
    if not (1 <= s <= MAX_BITS and 1 <= t <= MAX_BITS):
        raise ValueError(f"the kernel takes 1..{MAX_BITS} bit planes, got "
                         f"s={s}, t={t}")
    if block_m * block_n > MAX_THREADS or (block_m * block_n) % 32:
        raise ValueError(f"block_m * block_n = {block_m * block_n} must be a "
                         f"multiple of 32 and at most {MAX_THREADS}")
    for name, x in (("A", a), ("B", b), ("occupancy", occ), ("idx", idx),
                    ("counts", cnt)):
        if x is not None:
            _check_cuda(name, x, a.device)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    def ptr(x):
        return x.data_ptr() if x is not None else None

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().bitserial_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), s, t, m, w, n,
            block_m, block_n, kw, schedule, ptr(occ), ptr(idx),
            idx.shape[1] if idx is not None else 0, ptr(cnt), steps, stream)
    if err != 0:
        raise RuntimeError(f"bitserial_gemm launch failed: CUDA error {err}")
    LAUNCHES["bitserial_gemm"] += 1
    return out


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
