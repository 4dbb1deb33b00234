"""Fig. 9a: non-zero tile reuse (cross-tile reduction) — A-tile loads drop
O(bits) -> O(1).

  measured — the two schedules on the ``cuda`` engine: reuse=True, one
             bitserial_gemm with the planes in its inner loop; reuse=False,
             one bgemm pass per plane pair; they must be equal
  derived  — A-tile loads per output tile for each schedule
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.benchmarks.common import emit, timeit
from repro_torch.core import bitops
from repro_torch.device import resolve_device


def main(n: int = 256, d: int = 128, bits_list=(4, 8, 16), device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = torch.ones((n, n), dtype=torch.int32, device=dev)  # all non-zero (paper setup)
    pol_reuse = api.ExecutionPolicy(reuse=True)
    pol_no_reuse = api.ExecutionPolicy(reuse=False)
    for bits in bits_list:
        xb = min(bits, 8)
        x = torch.as_tensor(rng.integers(0, 1 << xb, (n, d)), dtype=torch.int32,
                            device=dev)
        ap = bitops.pack_a(a, 1)
        xp = bitops.pack_b(x, xb)

        def reuse(ap=ap, xp=xp):          # cross-tile: planes inner loop
            return api.bitserial_mm_packed(ap, xp, backend="cuda",
                                           policy=pol_reuse)

        def no_reuse(ap=ap, xp=xp):       # cross-bit: one pass per plane
            return api.bitserial_mm_packed(ap, xp, backend="cuda",
                                           policy=pol_no_reuse)

        if not torch.equal(reuse(), no_reuse()):  # same math
            raise AssertionError(f"fig9a {bits}b: reuse != no_reuse")
        t_r = timeit(reuse, iters=3)
        t_nr = timeit(no_reuse, iters=3)
        emit(f"fig9a_reuse_{bits}b", t_r * 1e3, "ms")
        emit(f"fig9a_noreuse_{bits}b", t_nr * 1e3, "ms")
        # derived: A-tile loads per output tile
        emit(f"fig9a_atile_loads_reuse_{bits}b", 1, "loads", derived=True)
        emit(f"fig9a_atile_loads_noreuse_{bits}b", xb, "loads", derived=True)


if __name__ == "__main__":
    main()
