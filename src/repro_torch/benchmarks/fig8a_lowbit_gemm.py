"""Fig. 8a: any-bitwidth GEMM vs the int8 dense GEMM (the paper's cuBLAS
comparison).

The int8 baseline is PyTorch's ``torch._int_mm``, a library call the port
itself never makes; the low-bit GEMM is ``core.qgemm.qgemm`` on the
``cuda`` engine, which packs both operands and runs the bit-serial kernel,
and must equal the exact product. ``derived``: the bit-op count ratio
(8 * 8) / (s * t) of s * t one-bit plane passes against an 8-bit one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, timeit
from repro_torch.core.qgemm import qgemm
from repro_torch.device import resolve_device


def main(ns=(1024, 2048, 4096), d: int = 64, bits_list=(2, 3, 4, 7),
         device=None):
    dev = resolve_device(device)
    for n in ns:
        rng = np.random.default_rng(n)
        a8 = torch.as_tensor(rng.integers(0, 255, (n, n)).astype(np.int8),
                             device=dev)
        b8 = torch.as_tensor(rng.integers(0, 127, (n, d)).astype(np.int8),
                             device=dev)
        t8 = timeit(torch._int_mm, a8, b8)
        emit(f"fig8a_int8_n{n}", t8 * 1e6, "us", gops=2 * n * n * d / t8 / 1e9)
        for bits in bits_list:
            aq = torch.as_tensor(rng.integers(0, 1 << bits, (n, n)),
                                 dtype=torch.int32, device=dev)
            bq = torch.as_tensor(rng.integers(0, 1 << bits, (n, d)),
                                 dtype=torch.int32, device=dev)
            exact = qgemm(aq, bq, bits, bits, backend="torch_dot")
            if not torch.equal(qgemm(aq, bq, bits, bits, backend="cuda"), exact):
                raise AssertionError(f"fig8a {bits}b n={n}: qgemm != a @ b")
            tq = timeit(qgemm, aq, bq, bits, bits, backend="cuda")
            # tensor-core work model: s*t 1-bit passes vs 8x8 dense int8 passes
            work_ratio = (8 * 8) / (bits * bits)
            emit(f"fig8a_qgtc{bits}_n{n}", tq * 1e6, "us",
                 measured_speedup=t8 / tq)
            emit(f"fig8a_qgtc{bits}_n{n}_bitwork", round(work_ratio, 2),
                 "x_vs_int8", derived=True)


if __name__ == "__main__":
    main()
