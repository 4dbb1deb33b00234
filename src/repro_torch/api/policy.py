"""ExecutionPolicy: every tunable of quantized-GEMM execution in one object.

The field set is the reference's (``repro.api.policy``):

  block_m/block_n/block_w — tile shape: block_m rows of A, block_n output
                            columns, block_w 32-bit words of K. The zero-
                            tile artifacts are built on (block_m, block_w).
  mode                    — 'vpu' (popcount on the CUDA cores) | 'mxu'
                            (the b1 tensor cores, mma.sync .and.popc); the
                            same int32 either way, and the same checks
  jump                    — zero-tile jumping (§4.3): none | mask | compact
                            | sgt (single-word columns, kernels/sgt.py)
  reuse                   — §4.4 tile reuse: the s*t plane loop inside one
                            kernel. False is the Fig. 9a ablation: the
                            cuda engine runs one 1-bit bgemm pass per plane
                            pair instead
  fused_requantize        — core.bittensor.bitmm2bit with a scalar out_qp
                            runs the §4.5 requantize inside the GEMM's
                            epilogue (api.bitserial_fused)
  interpret               — kept for parity with the reference. The port
                            has no interpret mode: a CPU tensor takes a
                            kernel's plain version, a CUDA tensor the kernel.

The checks keep the set of tiles the port has accepted since its first
kernel, in both modes; neither kernel's launch follows the tile any more.
The 'vpu' kernel launches a warp per output row (csrc/bitserial_tile.cuh),
the 'mxu' kernel a warp per 16-row strip of up to 8 columns, 32 at one bit
(csrc/bitserial_mma.cuh); in both, block_m only names the row tile whose
artifacts a row reads, and block_n shapes nothing. The bounds on
block_m * block_n (whole warps, at most 1024: the first kernels' thread
count) and on 4 * 8 * block_w * (block_m + block_n) bytes (8-bit operand
tiles the first 'vpu' design staged in shared memory) stay so that a
policy accepted before is accepted still, and no other.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.bitserial import MAX_BITS, MAX_THREADS

__all__ = ["ExecutionPolicy", "DEFAULT_POLICY", "JUMP_MODES", "COMPUTE_MODES"]

JUMP_MODES = ("none", "mask", "compact", "sgt")
COMPUTE_MODES = ("vpu", "mxu")
_MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    block_m: int = 8
    block_n: int = 32
    block_w: int = 4
    mode: str = "vpu"
    jump: str = "none"
    reuse: bool = True
    fused_requantize: bool = False
    interpret: bool | None = None

    def __post_init__(self):
        if self.jump not in JUMP_MODES:
            raise ValueError(f"jump must be one of {JUMP_MODES}, got {self.jump!r}")
        if self.mode not in COMPUTE_MODES:
            raise ValueError(f"mode must be one of {COMPUTE_MODES}, got {self.mode!r}")
        for f in ("block_m", "block_n", "block_w"):
            v = getattr(self, f)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"{f} must be a positive int, got {v!r}")
        threads = self.block_m * self.block_n
        if threads % 32 or threads > MAX_THREADS:
            raise ValueError(
                f"block_m * block_n must be a multiple of 32 (whole warps) "
                f"and at most {MAX_THREADS}, got "
                f"{self.block_m} * {self.block_n} = {threads}")
        smem = 4 * MAX_BITS * self.block_w * (self.block_m + self.block_n)
        if smem > _MAX_SMEM_BYTES:
            raise ValueError(
                f"a ({self.block_m}, {self.block_n}, {self.block_w}) tile "
                f"would stage {smem} bytes of 8-bit operands, more than "
                f"the {_MAX_SMEM_BYTES} a block may use")

    def replace(self, **kw) -> "ExecutionPolicy":
        """Functional update (alias for dataclasses.replace)."""
        return dataclasses.replace(self, **kw)


DEFAULT_POLICY = ExecutionPolicy()
