"""Fig. 8c: 1-bit GEMM throughput vs adjacency size N (A X, D in {16,32,64}).

The scaling shape: throughput grows with N, then saturates, and a larger D
uses the device better. ``api.bgemm`` on the ``cuda`` engine, held to the
exact product (a float32 matmul of the 0/1 values: every sum stays below
2**24).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.benchmarks.common import emit, timeit
from repro_torch.core import bitops
from repro_torch.device import resolve_device


def main(ds=(16, 32, 64), ns=(128, 512, 2048, 8192), device=None):
    dev = resolve_device(device)
    for d in ds:
        for n in ns:
            rng = np.random.default_rng(n + d)
            a = torch.as_tensor((rng.random((n, n)) < 0.1).astype(np.int32),
                                device=dev)
            x = torch.as_tensor(rng.integers(0, 2, (n, d)), dtype=torch.int32,
                                device=dev)
            ap = bitops.pack_a(a, 1)[0]
            xp = bitops.pack_b(x, 1)[0]
            exact = (a.to(torch.float32) @ x.to(torch.float32)).to(torch.int32)
            if not torch.equal(api.bgemm(ap, xp, backend="cuda"), exact):
                raise AssertionError(f"fig8c N={n} D={d}: bgemm != A @ X")
            t = timeit(api.bgemm, ap, xp, backend="cuda")
            gops = 2 * n * n * d / t / 1e9
            emit(f"fig8c_N{n}_D{d}", gops, "gops", us=t * 1e6)


if __name__ == "__main__":
    main()
