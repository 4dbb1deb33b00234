"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` compiles to an object with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes. The library's name carries a hash of every
source and header in ``csrc/`` and of the flags, and it is renamed into
place whole, so concurrent builds never load a half-written file. The
output goes to ``build/repro_torch/`` at the repository root. Nothing is
built at import: ``library()`` builds at the first launch.

The flags never include ``--use_fast_math``: the fused epilogue, the
bitpack quantizer and the 4-bit dequantization do float arithmetic that
must round as IEEE float32 does.

``LAUNCHES`` holds one count per kernel, the library's ``{name}_launch``;
each wrapper adds one where it launches its kernel, and nowhere else. The
tensor-core kernels of ``mode="mxu"`` count apart from their 'vpu'
counterparts (``bitserial_gemm_mxu`` beside ``bitserial_gemm``), so that a
run shows which kernel served it.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "LAUNCHES", "reset_launches",
           "sources", "build", "load", "library", "launch", "kernel_device",
           "check_cuda"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"bitserial_gemm": 0, "bitserial_fused": 0, "bgemm": 0,
            "bitpack": 0, "wq_gemm": 0, "bitserial_gemm_mxu": 0,
            "bitserial_fused_mxu": 0, "bgemm_mxu": 0}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources(csrc: pathlib.Path = CSRC) -> list[pathlib.Path]:
    return sorted(csrc.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the stderr of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{err}")


def build(csrc: pathlib.Path = CSRC,
          build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile every ``*.cu`` of ``csrc`` into one shared library in
    ``build_dir`` unless a library of exactly these sources and flags
    exists; returns its path."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    out = build_dir / f"librepro_torch-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sources(csrc)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(srcs, objs)])
        lib = pathlib.Path(tmp) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library with every launch function's argument types set."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def load(path: pathlib.Path) -> ctypes.CDLL:
    """Load a library that ``build`` made and set the argument types of
    every launch function."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (A, B, C, [s, t,] m, w, n, block_m, block_n, kw, schedule,
    #  occ, idx, idx_stride, cnt, steps, ...)
    # the mode="mxu" launchers take the same arguments
    gemm = [p, p, p, i, i, i, i, i, i, i, i, i, p, p, i, p, i]
    for mode in ("", "_mxu"):
        getattr(lib, f"bitserial_gemm{mode}_launch").argtypes = gemm + [p]
        getattr(lib, f"bitserial_fused{mode}_launch").argtypes = \
            gemm + [p, p, f, i, p]
        getattr(lib, f"bgemm{mode}_launch").argtypes = gemm[:3] + gemm[5:] + [p]
    # (x, scale, zero, out, m, k, words, nbits, qmax, stream)
    lib.bitpack_launch.argtypes = [p, p, p, p, i, i, i, i, f, p]
    # (x, w_packed, scales, out, m, n, k, group, block_m, block_n,
    #  block_k, x_bf16, stream)
    lib.wq_gemm_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    for name in LAUNCHES:
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
    return lib


def launch(name: str, out, args: tuple, device):
    """Launch kernel ``name`` (the library's ``{name}_launch``) on the
    current stream, without synchronising, and count it. Returns ``out``."""
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def kernel_device(*tensors) -> torch.device | None:
    """Where a wrapper's operands send it: None for CPU tensors (the plain
    version runs), their CUDA device for CUDA tensors (the kernel runs).
    Raises for operands on different devices or on any other device, and
    for a DTensor: a sharded caller passes its local shards, so no DTensor
    reaches a launch."""
    for x in tensors:
        cls = type(x)
        if cls.__name__ == "DTensor" and cls.__module__.startswith(
                "torch.distributed"):
            raise TypeError("a DTensor reached a kernel wrapper: pass its "
                            "local shard (to_local())")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands are on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu tensors, got {device}")
    return device


def check_cuda(name, x, device, dtype) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
